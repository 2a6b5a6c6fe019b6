"""The analytic arithmetic-intensity model of the paper's §5.4 (Fig. 4,
App. B.4), the jax-free counterpart of the JAX package's
``roofline/ai_model.py``; a kernel's roofline bound on the card
(``bound.py``); and the dry-run's three-term roofline, the counterpart of
the JAX package's HLO-based one: ``analysis.py`` counts a step's FLOPs and
bytes on the meta device where the reference reads XLA's cost analysis,
``collectives.py`` lists its collectives from the sharding specs where the
reference parses the partitioned HLO (``roofline/hlo.py``), and
``report.py`` renders the same tables."""
from repro_torch.roofline.ai_model import (  # noqa: F401
    LLADA_8B,
    LLAMA31_8B,
    PAPER_TARGETS,
    AIModelConfig,
    ar_ai,
    attainable_tflops,
    blockwise_dlm_ai,
    paper_table,
    param_bytes,
    step_cost,
    vanilla_dlm_ai,
)
from repro_torch.roofline.bound import bound_ms  # noqa: F401
from repro_torch.roofline.analysis import (  # noqa: F401
    RooflineReport,
    analyze,
    model_flops,
)
from repro_torch.roofline.collectives import collective_bytes  # noqa: F401
