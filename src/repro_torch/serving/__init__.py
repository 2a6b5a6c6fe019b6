from repro_torch.serving.api import (  # noqa: F401
    BlockEvent,
    GenerationOutput,
    GenerationRequest,
    Request,
    Response,
    SamplingParams,
)
from repro_torch.serving.engine import (  # noqa: F401
    ContinuousEngine,
    Engine,
    efficiency_report,
    make_engine,
)
