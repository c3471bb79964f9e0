from gogp_torch.infer import adapt, diagnostics, mle  # noqa: F401
from gogp_torch.infer.chees import (  # noqa: F401
    ChEESState,
    chees_init,
    chees_sample_chunk,
    chees_transition,
    chees_warm_chunk,
    finalize_chees_warmup,
    run_chees,
)
from gogp_torch.infer.diagnostics import ess, split_rhat  # noqa: F401
