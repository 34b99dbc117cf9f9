from cfgan_torch.serve.client import CFApiError, CFClient  # noqa: F401
from cfgan_torch.serve.engine import CounterfactualEngine  # noqa: F401
