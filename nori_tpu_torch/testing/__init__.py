"""Statistical verification harness.

Port of `nori_tpu/testing`: the reference enforces correctness with
chi^2 tests on sampling routines (src/chi2test.cpp, src/warptest.cpp)
and Student's t-tests on estimator means (src/ttest.cpp), built on
wjakob's `hypothesis` helpers.

  * hypothesis: chi2_test / students_t_test / cell integration
  * the chi2 plugin ("<test type=chi2test>") and the ttest plugin
    ("<test type=ttest>"), which importing this package registers
"""

from nori_tpu_torch.testing import chi2 as _chi2  # noqa: F401
from nori_tpu_torch.testing import ttest as _ttest  # noqa: F401
