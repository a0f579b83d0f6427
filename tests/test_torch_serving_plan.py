"""The port's batch planner (``renderloom_torch/utils/serving.py``, a copy
of ``renderloom/utils/serving.py``) against the JAX package's: the same
plans and planned ms for n = 0…24 on tests/test_serving_plan.py's table
and on seeded random tables (some with a valley, some with sizes the
other tables lack), and the same refusal of an empty profile."""

import numpy as np
import pytest

from renderloom.utils import serving as J
from renderloom_torch.utils import serving as T

R3 = {1: 335.0, 2: 703.0, 4: 1089.0, 8: 1452.0}


def _table(seed):
    if seed is None:
        return R3
    rng = np.random.default_rng(seed)
    sizes = sorted(rng.choice(np.arange(1, 13), size=rng.integers(1, 6),
                              replace=False).tolist())
    return {int(s): float(rng.uniform(100, 400) * s ** rng.uniform(0.3, 1.1))
            for s in sizes}


@pytest.mark.parametrize("seed", [None, 0, 1, 2, 3], ids=lambda s:
                         "r3" if s is None else f"seed{s}")
def test_plans_match_jax(seed):
    table = _table(seed)
    for n in range(25):
        assert T.plan_chunks(n, table) == J.plan_chunks(n, table), n
        assert T.planned_ms(n, table) == J.planned_ms(n, table), n
    with pytest.raises(ValueError):
        T.plan_chunks(3, {})
