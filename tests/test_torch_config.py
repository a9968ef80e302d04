"""The port's config loader gives the JAX package's specs and data for every
published config (exact equality: the same numpy parsing on both sides)."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from sampling_gpmpc_tpu.config import load_problem as jload
from sampling_gpmpc_torch.config import load_problem as tload

PARAMS = sorted(glob.glob(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "params", "*.yaml")))


@pytest.mark.parametrize("path", PARAMS, ids=os.path.basename)
def test_specs_and_data_field_equal(path):
    try:
        jp, js, jd = jload(path)
    except KeyError as e:
        # a config of a family neither loader serves (the drone approx
        # configs are read by approx/ directly): both must refuse it
        with pytest.raises(KeyError, match=str(e)):
            tload(path)
        return
    tp, ts, td = tload(path)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    # the fields the QP exit and the GP overrides read, spelled out
    for f in ("qp_tol", "g_idx_inputs", "pad_g", "Ty", "max_sqp_iter"):
        assert getattr(ts, f) == getattr(js, f)
    for f in ("variance_is_zero", "min_data_dist", "jitter", "beta"):
        assert getattr(ts.gp, f) == getattr(js.gp, f)
    assert tp == jp
    for f in dataclasses.fields(jd):
        a, b = getattr(td, f.name), getattr(jd, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
