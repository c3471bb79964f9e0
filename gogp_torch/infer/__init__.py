from gogp_torch.infer import adapt, diagnostics, mle  # noqa: F401
from gogp_torch.infer.advi import (  # noqa: F401
    ADVIResult,
    FullRankADVIResult,
    elbo,
    elbo_fullrank,
    run_advi,
    run_advi_fullrank,
    sample_posterior,
    sample_posterior_fullrank,
)
from gogp_torch.infer.chees import (  # noqa: F401
    ChEESState,
    chees_init,
    chees_sample_chunk,
    chees_transition,
    chees_warm_chunk,
    finalize_chees_warmup,
    run_chees,
    run_chees_pops,
)
from gogp_torch.infer.diagnostics import ess, split_rhat  # noqa: F401
from gogp_torch.infer.elliptical import (  # noqa: F401
    ESSDraws,
    ESSResult,
    ess_predict,
    ess_predict_prob,
    ess_update,
    run_ess,
    run_ess_gp,
)
from gogp_torch.infer.ghmc import (  # noqa: F401
    GHMCState,
    ghmc_init,
    ghmc_sample_chunk,
    ghmc_warm_chunk,
    run_ghmc,
)
from gogp_torch.infer.hmc import (  # noqa: F401
    HMCState,
    IntegratorState,
    Samples,
    hmc_transition,
    init_state,
    leapfrog,
    run_hmc,
)
from gogp_torch.infer.mle import OptResult, adam, lbfgs  # noqa: F401
from gogp_torch.infer.nuts import nuts_transition, run_nuts  # noqa: F401
from gogp_torch.infer.pt_chees import (  # noqa: F401
    PTChEESResult,
    pt_chees_init,
    pt_chees_sample_chunk,
    pt_chees_warm_chunk,
    run_pt_chees,
)
from gogp_torch.infer.smc import SMCResult, run_smc  # noqa: F401
from gogp_torch.infer.tempering import (  # noqa: F401
    PTFlow,
    PTResult,
    geometric_ladder,
    place_rungs,
    run_pt_nuts,
    tune_ladder,
)
