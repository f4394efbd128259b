"""The runner's step configurations that the port's tests hold, one per
row of the table of the JAX kernel's branches (``acme_tpu/ops/fused.py``,
the knobs of ``FusedRunner.__init__``): each knob value over the bench's
production configuration, the JAX defaults and the ``FAST`` configuration
of tests/test_fused.py.  Shared by the plain version's tests against the
JAX package (tests/test_torch_configs.py), the host builds of the kernel
(tests/test_torch_kernel_host.py) and the builds on the card
(tests/test_torch_cuda.py); imports neither jax nor the JAX package.
"""

from acme_tpu_torch.sweeps import PRODUCTION as PROD

CONFIGS = {
    "jax_defaults": {},
    # tests/test_fused.py:17-18
    "FAST": dict(newton_iters=12, tol=1e-9, compensated=False,
                 extrapolate=False),
    "compensated_false": dict(PROD, compensated=False),
    "extrapolate_false": dict(PROD, extrapolate=False),
    "df_polish_true": dict(PROD, df_polish=True),
    "df_polish_plain_final": dict(PROD, df_polish="plain_final"),
    "df_polish_false": dict(PROD, df_polish=False),
    "df_solve_true": dict(PROD, df_polish="plain_final", df_solve=True),
    "verdict_jac_plain": dict(PROD, df_polish="plain_final",
                              verdict_jac="plain"),
    "polish_only": dict(PROD, polish_only=True, fast_iters=0),
    "fast_verify_always": dict(PROD, fast_verify="always"),
    "fast_keep_tol": dict(PROD, fast_keep="tol"),
    "pivot_false": dict(PROD, pivot=False),
    "rel_tolerances": dict(PROD, rel_tol=1e-6, rel_gate=1e-5,
                           rel_tol_polish=1e-7),
    "df_state_false": dict(PROD, df_state=False),
}

# the ones held on the level Super Over too: the branches that differ
# where a subsystem has n >= 2 (the df polish loop, the df elimination
# everywhere, unpivoted solves) and the df residual verdict
LEVEL_CONFIGS = ("jax_defaults", "df_solve_true", "pivot_false",
                 "verdict_jac_plain")
