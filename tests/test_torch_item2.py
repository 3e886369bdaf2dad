"""Item 2's package pieces against the JAX package: `quantized_scores`
(MIPS and cosine, INT8 and INT4, with and without stored doc norms) and
`dequantize` bit-equal, `merge_topk` bit-equal (ties, +-0.0: the
reference sorts with `jnp.argsort`, where +0.0 and -0.0 tie), and
`expected_bit_error_rate`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy
from repro.core import error_model as jax_error_model
from repro.core import quantization as jax_q
from repro.core import topk as jax_topk
from repro_torch.core import error_model, quantization, topk


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("metric", ["mips", "cosine"])
@pytest.mark.parametrize("norms", [False, True])
def test_quantized_scores_bit_equal(bits, metric, norms):
    rng = np.random.default_rng(bits)
    docs = rng.normal(size=(300, 96)).astype(np.float32)
    docs[7] = 0.0                                   # a zero-norm doc
    queries = rng.normal(size=(5, 96)).astype(np.float32)
    jd, jq = jax_q.quantize(jnp.asarray(docs), bits), jax_q.quantize_query(
        jnp.asarray(queries), bits)
    td, tq = quantization.quantize(torch.from_numpy(docs), bits), quantization.quantize_query(
        torch.from_numpy(queries), bits)
    np.testing.assert_array_equal(to_numpy(td.values), np.asarray(jd.values))
    jn = jax_q.doc_int_norms(jd) if norms else None
    tn = quantization.doc_int_norms(td) if norms else None
    want = jax_q.quantized_scores(jq, jd, jn, metric)
    got = quantization.quantized_scores(tq, td, tn, metric)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    np.testing.assert_array_equal(to_numpy(quantization.dequantize(td)),
                                  np.asarray(jax_q.dequantize(jd)))
    with pytest.raises(ValueError, match="unknown metric"):
        quantization.quantized_scores(tq, td, metric="l2")


def _lists(seed):
    rng = np.random.default_rng(seed)
    vals = rng.choice(np.array([2.0, 1.0, 0.0, -0.0, -1.0, -np.inf], np.float32),
                      size=(3, 12))
    ids = rng.permutation(48).astype(np.int32)[:24].reshape(2, 12)
    return vals, ids


@pytest.mark.parametrize("k", [1, 5, 24])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_topk_bit_equal(k, seed):
    vals, ids = _lists(seed)
    a = (vals[:2], ids[:1].repeat(2, 0))
    b = (vals[1:], ids[1:].repeat(2, 0))
    want = jax_topk.merge_topk(jax_topk.TopK(jnp.asarray(a[0]), jnp.asarray(a[1])),
                               jax_topk.TopK(jnp.asarray(b[0]), jnp.asarray(b[1])), k)
    got = topk.merge_topk(topk.TopK(torch.from_numpy(a[0]), torch.from_numpy(a[1])),
                          topk.TopK(torch.from_numpy(b[0]), torch.from_numpy(b[1])), k)
    np.testing.assert_array_equal(to_numpy(got.indices), np.asarray(want.indices))
    np.testing.assert_array_equal(to_numpy(got.scores).view(np.int32),
                                  np.asarray(want.scores).view(np.int32))   # sign of 0


def test_merge_topk_signed_zero_ties():
    """+0.0 and -0.0 tie in the merge (lower id first), as in the
    reference."""
    a = topk.TopK(torch.tensor([[-0.0, 0.0, 2.0]]), torch.tensor([[3, 5, 1]], dtype=torch.int32))
    b = topk.TopK(torch.tensor([[0.0, -0.0, 2.0]]), torch.tensor([[4, 2, 0]], dtype=torch.int32))
    got = topk.merge_topk(a, b, 6)
    assert got.indices.tolist() == [[0, 1, 2, 3, 4, 5]]
    want = jax_topk.merge_topk(jax_topk.TopK(jnp.asarray(a.scores), jnp.asarray(a.indices)),
                               jax_topk.TopK(jnp.asarray(b.scores), jnp.asarray(b.indices)), 6)
    assert np.asarray(want.indices).tolist() == got.indices.tolist()


def test_expected_bit_error_rate():
    cfg = error_model.ErrorModelConfig(enabled=True, p_min=1e-3, p_max=4e-2)
    jcfg = jax_error_model.ErrorModelConfig(enabled=True, p_min=1e-3, p_max=4e-2)
    mapping = np.arange(64 * 4) % 128
    probs = error_model.flip_probs_for_mapping(mapping, cfg)
    np.testing.assert_array_equal(probs, jax_error_model.flip_probs_for_mapping(mapping, jcfg))
    assert error_model.expected_bit_error_rate(probs) == \
        jax_error_model.expected_bit_error_rate(probs)
    assert isinstance(error_model.expected_bit_error_rate(probs), float)
