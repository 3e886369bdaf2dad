"""repro_torch.launch — command-line drivers of the port (counterpart of
`repro.launch`): `serve` stands up the sharded retrieval front end
(`python -m repro_torch.launch.serve --rag`)."""
