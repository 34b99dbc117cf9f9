from cfgan_torch.serve.apps import (  # noqa: F401
    HouseBackend,
    MnistChatBackend,
    MoonsBackend,
    Table,
    build_house_app,
    build_mnist_app,
    build_moons_app,
)
from cfgan_torch.serve.client import CFApiError, CFClient  # noqa: F401
from cfgan_torch.serve.engine import CounterfactualEngine  # noqa: F401
from cfgan_torch.serve.intent import (  # noqa: F401
    extract_action,
    llm_client,
    parse_feature_instruction,
    parse_feature_instruction_llm,
    strip_action,
)


def __getattr__(name: str):
    # the launchers on first use: importing them here would put
    # `cfgan_torch.serve.launch` in sys.modules before `python -m` runs it
    if name in ("launch_mnist", "launch_house", "launch_moons"):
        from cfgan_torch.serve import launch

        return getattr(launch, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
