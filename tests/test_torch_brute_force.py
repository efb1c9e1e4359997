"""P6 settled: the port's DTW brute-force oracle
(`repro_torch.core.search.brute_force_knn`) is the reference's float32
closed form (ROADMAP F4), so at a band that covers the row it answers as
the reference's `brute_force_knn`: the same (series, offset) in the same
order, distances within rtol 1e-2 (both cumsums cancel on near matches,
each in its own order; measured up to 6.4e-3 relative at l = 128, 9e-5
at l = 64).  Its own file: the reference compiles its DP for each band,
which would lengthen the DTW slice's file."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Collection as JCollection  # noqa: E402
from repro.core.search import brute_force_knn as j_brute  # noqa: E402
from repro_torch.core import Collection  # noqa: E402
from repro_torch.core.search import brute_force_knn  # noqa: E402


@pytest.mark.parametrize("znorm", [True, False], ids=["znorm", "raw"])
def test_port_dtw_brute_force_at_full_band_matches_reference(znorm):
    rng = np.random.default_rng(12345)
    data = np.cumsum(rng.normal(size=(16, 192)), -1).astype(np.float32)
    q = data[2, 5:69] + rng.normal(size=64).astype(np.float32) * 0.05
    r = len(q) - 1                       # the band covers the row
    got = brute_force_knn(Collection.from_array(data, device="cpu"), q, k=6,
                          znorm=znorm, measure="dtw", r=r)
    want = j_brute(JCollection.from_array(data), q, k=6, znorm=znorm,
                   measure="dtw", r=r)
    np.testing.assert_array_equal(got.series, want.series)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-2)
