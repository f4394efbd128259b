"""``_ablate.py``'s configurations on the CPU: the port's plain version
against the JAX package.

``acme_tpu_torch.ablate`` runs the JAX package's cost anatomy on the card:
every configuration of ``_ablate.py`` (its base: one unguarded step, the
plain polish loop and the full-df verdict, ``df_polish="plain_final"``)
under the same name, and beside them the knob values it does not
ablate (``ablate.EXTRA``, each over cf2).  Each row here, ``tc512`` (a
Mosaic time chunk) and ``defaults`` (tests/test_torch_configs.py holds
the JAX defaults) left out, on the diode clipper: 128 input levels (0.1
to 2.0) of a 1.5-amplitude sine from cold, 128 samples, against
``acme_tpu.ops.fused.FusedRunner(..., interpret=True)`` with the same
keywords.  Bound, as in tests/test_torch_configs.py: y within -90 dB of
each lane's peak, fails and floored equal, and the effort held by
``hold_effort``.
"""

import pytest

from acme_tpu_torch import ablate
from test_torch_configs import against_jax

ROWS = [n for n in ablate.ROWS
        if n not in ablate.SKIPPED and n != ablate.DEFAULTS]


@pytest.mark.parametrize("name", ROWS)
def test_ablation_row_matches_jax_interpret(name):
    against_jax(ablate.row_kwargs(name))


def test_ablation_rows():
    """The rows are ``_ablate.py``'s, under its names, with its base."""
    import _ablate
    assert list(ablate.CONFIGS) == list(_ablate.CONFIGS)
    assert ablate.CONFIGS == _ablate.CONFIGS
    assert set(ablate.SKIPPED) == {"tc512"}
    kw = ablate.row_kwargs("cf2")
    assert (kw["fast_iters"], kw["polish_fixed"], kw["df_polish"],
            kw["fast_verify"], kw["powerup"]) == (1, 2, "comp_final",
                                                  "merge", None)
    assert ablate.row_kwargs(ablate.DEFAULTS) == {}
    with pytest.raises(ValueError, match="Mosaic"):
        ablate.row_kwargs("tc512")
    assert ablate.order(["cf2", "tc512", "base"]) == (["base", "cf2"],
                                                      ["tc512"])
    assert ablate.row_kwargs("always")["fast_verify"] == "always"
    with pytest.raises(ValueError, match="unknown configuration"):
        ablate.order(["cf3"])
