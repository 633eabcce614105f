"""parallel of the PyTorch port: meshes over torch.distributed ranks and
their collectives (mesh), initialization (distributed), the corpus
runners (corpus), frame-sharded analysis and synthesis (seqparallel),
pipeline- and expert-parallel training (pipeline, expert)."""
from . import corpus, mesh, seqparallel  # noqa: F401
from .corpus import batched_pipeline, run_corpus  # noqa: F401
from .mesh import make_mesh, shard_batch  # noqa: F401
