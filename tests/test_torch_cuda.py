"""The port on a CUDA card: each CUDA kernel against its plain PyTorch
version, and one RAG query batch through both kernel paths against the
exact integer path. No JAX here, so the file runs on a machine with a
card and PyTorch only:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test skips."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import bitplane  # noqa: E402
from repro_torch.core.retrieval import DircRagIndex, RetrievalConfig  # noqa: E402
from repro_torch.kernels import dirc_mac, ops, score_matmul  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import HashEmbedder, RagPipeline  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _codes(g, shape, bits, dev):
    lo = -(1 << (bits - 1))
    return torch.randint(lo, -lo, shape, generator=g, device=dev, dtype=torch.int8)


@pytest.mark.parametrize("b,n,dim,bits", [(1, 8192, 512, 8), (16, 8229, 1024, 4),
                                          (3, 300, 128, 8), (17, 129, 256, 8)])
def test_kernels_match_plain(dev, b, n, dim, bits):
    """Bit-equal int32 outputs; one launch counted per kernel call."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, d = _codes(g, (b, dim), bits, dev), _codes(g, (n, dim), bits, dev)
    before = (dirc_mac.LAUNCHES, score_matmul.LAUNCHES)
    got2 = score_matmul.score_matmul_int(q, d)
    qp = bitplane.pack_words(bitplane.to_bitplanes(q, bits))
    dp = bitplane.pack_words(bitplane.to_bitplanes(d, bits)).permute(1, 2, 0).contiguous()
    got1 = dirc_mac.dirc_mac_packed(qp, dp, bits)
    torch.cuda.synchronize()
    assert torch.equal(got2, score_matmul.score_matmul_int_ref(q, d))
    assert torch.equal(got1, dirc_mac.dirc_mac_packed_ref(qp, dp, bits))
    assert torch.equal(got1, got2)
    assert (dirc_mac.LAUNCHES, score_matmul.LAUNCHES) == (before[0] + 1, before[1] + 1)
    packed = bitplane.pack_words(bitplane.to_bitplanes(d, bits))
    assert torch.equal(ops.dirc_mac(q[0], packed, bits), got2[0])


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros((2, 40), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="dim % 16"):
        score_matmul.score_matmul_int(q, torch.zeros((5, 40), dtype=torch.int8, device=dev))
    with pytest.raises(ValueError, match="CUDA device"):
        score_matmul.score_matmul_int(q[:, :32].contiguous(),
                                      torch.zeros((5, 32), dtype=torch.int8))
    qp = torch.zeros((1, 8, 100), dtype=torch.int32, device=dev)    # nw > 96
    with pytest.raises(RuntimeError, match="CUDA error"):
        dirc_mac.dirc_mac_packed(qp, torch.zeros((8, 100, 5), dtype=torch.int32,
                                                 device=dev), 8)


@pytest.mark.parametrize("path", ["kernel_bitserial", "kernel_mxu"])
def test_rag_query_on_the_card(dev, path):
    """Smoke model, 512 docs: both kernel paths return the ids and scores of
    the exact integer path and launch their kernel."""
    rng = np.random.default_rng(0)
    corpus = [f"document {i}: " + " ".join(f"w{rng.integers(0, 997)}" for _ in range(12))
              for i in range(512)]
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    model = build_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    base = RetrievalConfig(bits=8, metric="cosine", n_cores=16)
    pipe = RagPipeline(corpus, dataclasses.replace(base, path=path), model=model,
                       embedder=HashEmbedder(dim=128), dim=128, device=dev)
    exact = DircRagIndex.build(pipe.embedder.embed(corpus),
                               dataclasses.replace(base, path="int_exact"), device=dev)
    queries = corpus[:4]
    want = exact.search(pipe.embedder.embed(queries), 3)
    dirc_mac.LAUNCHES = score_matmul.LAUNCHES = 0
    res = pipe.query_many(queries, k=3, max_new_tokens=4)
    kmod = dirc_mac if path == "kernel_bitserial" else score_matmul
    assert kmod.LAUNCHES == 1
    np.testing.assert_array_equal(np.stack([r.doc_ids for r in res]),
                                  want.indices.cpu().numpy())
    np.testing.assert_array_equal(np.stack([r.doc_scores for r in res]),
                                  want.scores.cpu().numpy())
    assert [int(r.doc_ids[0]) for r in res] == [0, 1, 2, 3]
    assert all(r.answer_tokens.shape == (1, 4) for r in res)
