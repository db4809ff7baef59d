"""NanoAOD → npz slices (the JAX package's ``etl/``): the host-side numpy
ETL whose slices ``--data`` reads."""

from deepmetv2_tpu_torch.etl.common import delta_phi, delta_r, pad_particle_list  # noqa: F401
from deepmetv2_tpu_torch.etl.dytt import process_chunk_dytt  # noqa: F401
from deepmetv2_tpu_torch.etl.znunu import process_chunk_znunu  # noqa: F401
