"""The hand-written kernels' wrappers (mirrors `cfgan/ops`); the CUDA
library is built at the first launch (`_build`), not here."""
from cfgan_torch.ops.epilogue import cf_epilogue, epilogue_terms  # noqa: F401
