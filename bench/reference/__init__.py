"""The plain reference of what a cell's timed path computes: retrieval
(quantisation, integer cosine scores, top-k) in NumPy, the augmented
prompt, and the language model's forward pass in plain PyTorch at fp32
with TF32 off. It imports nothing of the port (`repro_torch`), of the
JAX package or of JAX, and takes nothing the port made: it works the
codes, the embeddings of the queries and the weights out again from
what the benchmark made."""
