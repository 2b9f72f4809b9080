"""Inference library: GenSP targets/algorithms, SMC, MCMC edit requests,
and variational inference."""

from genjax_xla.inference.sp import (
    Algorithm,
    Marginal,
    SampleDistribution,
    Target,
    marginal,
)
from genjax_xla.inference import vi
from genjax_xla.inference.enumerative import (
    EnumerationResult,
    enumerate_posterior,
)
from genjax_xla.inference.exact_testbed import (
    DiscreteHMMInferenceProblem,
    build_test_against_exact_inference,
)
from genjax_xla.inference.adaptation import run_nuts, warmup_chains
from genjax_xla.inference.predictive import posterior_predictive
from genjax_xla.inference.svgd import run_svgd, svgd_step
from genjax_xla.inference.diagnostics import ess_autocorr, split_rhat, summarize
from genjax_xla.inference.data_smc import DataSMCResult, data_annealed_smc
from genjax_xla.inference.mcmc import chain, mh, multi_chain
from genjax_xla.inference.pf import (
    ParticleFilter,
    bootstrap_filter,
    particle_filter,
)
from genjax_xla.inference.requests import (
    EllipticalSlice,
    HMC,
    MALA,
    Rejuvenate,
    SafeHMC,
    elliptical_slice_kernel,
    selection_gradient,
)
from genjax_xla.inference.requests.nuts import NUTS, nuts_kernel
from genjax_xla.inference.pt import (
    ParallelTemperingResult,
    parallel_tempering,
)
from genjax_xla.inference.pmmh import (
    PMMHResult,
    gaussian_walk_proposal,
    pmmh,
)
from genjax_xla.inference.smc2 import SMC2Result, smc2
from genjax_xla.inference.pgibbs import (
    ParticleGibbsResult,
    TraceParticleGibbsResult,
    conditional_bootstrap_filter,
    particle_gibbs,
    trace_csmc,
    trace_particle_gibbs,
)
from genjax_xla.inference.map_laplace import (
    LaplaceResult,
    MAPResult,
    laplace_approximation,
    map_optimize,
)
from genjax_xla.inference.smc_sampler import (
    TemperedSMCResult,
    annealed_importance_sampling,
    tempered_smc,
    waste_free_tempered_smc,
)
from genjax_xla.inference.trace_pf import TracePFResult, trace_particle_filter
from genjax_xla.inference.transforms import (
    Bijector,
    constrain_choices,
    interval,
    positive,
    unconstrain_choices,
)
from genjax_xla.inference.smc import (
    ChangeTarget,
    Importance,
    ImportanceK,
    ParticleCollection,
    SMCAlgorithm,
    effective_sample_size,
    resample_indices,
)

__all__ = [
    "Algorithm",
    "ChangeTarget",
    "DiscreteHMMInferenceProblem",
    "EllipticalSlice",
    "EnumerationResult",
    "enumerate_posterior",
    "HMC",
    "MALA",
    "elliptical_slice_kernel",
    "MAPResult",
    "ParallelTemperingResult",
    "PMMHResult",
    "SMC2Result",
    "gaussian_walk_proposal",
    "pmmh",
    "smc2",
    "ParticleGibbsResult",
    "TraceParticleGibbsResult",
    "conditional_bootstrap_filter",
    "particle_gibbs",
    "trace_csmc",
    "trace_particle_gibbs",
    "LaplaceResult",
    "NUTS",
    "ParticleFilter",
    "TemperedSMCResult",
    "TracePFResult",
    "Bijector",
    "DataSMCResult",
    "data_annealed_smc",
    "constrain_choices",
    "interval",
    "positive",
    "unconstrain_choices",
    "trace_particle_filter",
    "annealed_importance_sampling",
    "tempered_smc",
    "waste_free_tempered_smc",
    "bootstrap_filter",
    "particle_filter",
    "build_test_against_exact_inference",
    "ess_autocorr",
    "nuts_kernel",
    "posterior_predictive",
    "run_nuts",
    "run_svgd",
    "svgd_step",
    "split_rhat",
    "summarize",
    "warmup_chains",
    "vi",
    "Rejuvenate",
    "SafeHMC",
    "laplace_approximation",
    "map_optimize",
    "parallel_tempering",
    "chain",
    "mh",
    "multi_chain",
    "selection_gradient",
    "Importance",
    "ImportanceK",
    "Marginal",
    "ParticleCollection",
    "SMCAlgorithm",
    "SampleDistribution",
    "Target",
    "effective_sample_size",
    "marginal",
    "resample_indices",
]
