"""The analytic arithmetic-intensity model of the paper's §5.4 (Fig. 4,
App. B.4), the jax-free counterpart of the JAX package's
``roofline/ai_model.py``, and a kernel's roofline bound on the card
(``bound.py``). The JAX package's HLO-based roofline
(``roofline/analysis.py``, ``roofline/hlo.py``) has no counterpart here."""
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
