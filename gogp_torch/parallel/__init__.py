"""Multi-device parallelism: process meshes, sharded MCMC chains, sharded
SMC, the row-sharded large-N GP and sharded serving.

PyTorch twin of ``gogp_tpu/parallel``: ``torch.distributed`` process groups
in the place of ``jax.sharding`` meshes, SPMD functions with explicit
psum / all_gather collectives in the place of ``shard_map`` bodies.
"""

from gogp_torch.parallel.mesh import (
    CHAIN_AXIS,
    DATA_AXIS,
    chain_sharding,
    data_sharding,
    gather_leading,
    init_multihost,
    make_mesh,
    replicated,
    shard_leading,
)
from gogp_torch.parallel.sample import (
    run_chees_pops_sharded,
    run_chees_sharded,
    run_ess_sharded,
    run_ghmc_sharded,
    run_hmc_sharded,
    run_mcmc_sharded,
    run_nuts_sharded,
    run_pt_chees_distributed,
    run_pt_chees_sharded,
    run_pt_distributed,
    run_pt_sharded,
)
from gogp_torch.parallel.large_n import (
    make_rowsharded_logp,
    run_chees_large_n,
    run_smc_large_n,
)
from gogp_torch.parallel.serving import (
    compile_mixture_sharded,
    serve_predict_mixture_sharded,
    serve_predict_sharded,
    shard_mixture,
)
from gogp_torch.parallel.smc_sharded import run_smc_sharded

__all__ = [
    "CHAIN_AXIS",
    "DATA_AXIS",
    "chain_sharding",
    "compile_mixture_sharded",
    "data_sharding",
    "gather_leading",
    "init_multihost",
    "make_mesh",
    "make_rowsharded_logp",
    "replicated",
    "run_chees_large_n",
    "run_smc_large_n",
    "run_hmc_sharded",
    "run_mcmc_sharded",
    "run_chees_pops_sharded",
    "run_ess_sharded",
    "run_chees_sharded",
    "run_ghmc_sharded",
    "run_nuts_sharded",
    "run_pt_chees_distributed",
    "run_pt_chees_sharded",
    "run_pt_distributed",
    "run_pt_sharded",
    "run_smc_sharded",
    "serve_predict_mixture_sharded",
    "serve_predict_sharded",
    "shard_leading",
    "shard_mixture",
]
