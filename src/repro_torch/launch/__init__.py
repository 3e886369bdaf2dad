"""repro_torch.launch — command-line drivers of the port (counterpart of
`repro.launch`): `serve` stands up the sharded retrieval front end
(`python -m repro_torch.launch.serve --rag`), `train` trains, `steps`
builds the production steps and `mesh` the device meshes."""
from .mesh import make_local_mesh, make_production_mesh  # noqa: F401
