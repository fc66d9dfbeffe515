"""Multi-process parallelism of the port (the JAX package's `parallel/`):
one process per device under `torch.distributed`, a `DeviceMesh` with the
dims 'data' and 'model', and explicit collectives."""
from .mesh import make_mesh, local_rows, gather_rows, replicate  # noqa: F401
from .lobpcg import lobpcg_laplacian_eigs  # noqa: F401
from .sharded import (  # noqa: F401
    sharded_spectral_decompose,
    sharded_patch_features,
    row_sharded_laplacian_eigs,
)
from .ring_attention import ring_attention, ring_attention_sharded  # noqa: F401
from .sp_vit import sp_patch_features  # noqa: F401
from . import distributed  # noqa: F401
