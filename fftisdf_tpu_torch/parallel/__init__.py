from fftisdf_tpu_torch.parallel.mesh import make_device_mesh  # noqa: F401
from fftisdf_tpu_torch.parallel.build import (  # noqa: F401
    build_sharded, get_jk_sharded)
