"""Large-N cross-check: set-A-scale hmult (N=2^15) through the exact host
oracle (refimpl + native C++ core when built) vs the device graph running
the piecewise pipeline (XLA NTT leaf on CPU) — bit-exact.

Small-N tests (n <= 1024, conftest engines) cover the algebra; this covers
the full-size tile shapes (n1 x n2 = 2^15), the real set-A limb counts and
the fused bconv/tail tables at scale. Run with `pytest -m slow`.
"""

import numpy as np
import pytest

from homulator_tpu.api import CkksEngine
from homulator_tpu.params import get_params


@pytest.mark.slow
def test_set_a_scale_hmult_bit_exact_vs_oracle():
    n, max_level, alpha = 1 << 15, 28, 28  # parameter set A (dnum = 1)
    level = 12
    params = get_params(n=n, max_level=max_level, alpha=alpha)
    eng = CkksEngine(params, seed=3, ntt_mode="xla")
    eng.keygen()

    rng = np.random.default_rng(9)
    scale = 2.0**29
    m1 = np.zeros(n, dtype=np.int64)
    m2 = np.zeros(n, dtype=np.int64)
    m1[: n // 4] = rng.integers(-1000, 1000, size=n // 4)
    m2[: n // 4] = rng.integers(-1000, 1000, size=n // 4)
    pt1 = eng.ref.encode_ints(m1, level, scale)
    pt2 = eng.ref.encode_ints(m2, level, scale)
    rc1 = eng.ref.encrypt(pt1)
    rc2 = eng.ref.encrypt(pt2)

    # device path (piecewise pipeline incl. the bf16 conversion and the
    # fused moddown_rescale tail)
    ct1 = eng.dc.upload_ct(rc1.data, level, scale)
    ct2 = eng.dc.upload_ct(rc2.data, level, scale)
    dev = eng.hmult(ct1, ct2)
    dev_flat = eng.dc.download(dev.data)

    # exact host oracle
    ref = eng.ref.hmult(rc1, rc2)

    assert dev.level == ref.level == level - 1
    assert np.array_equal(dev_flat, ref.data), "device hmult != exact oracle"
