"""Port parity, the training collectives (`repro_torch.distributed.
collectives`): `ef_int8_allreduce`, `make_compressed_grad_transform` and
`ring_allgather_matmul` in gloo worlds of 2 and 4 against the JAX
package's (`repro/distributed/collectives.py:112-186`, under shard_map
on as many of 4 forced host devices, a subprocess), and against a plain
computation.  The reference's own tests are
tests/test_distributed.py:152 and :176.

Tolerances: the int8 codes and the error feedback bit for bit (both are
local float32 arithmetic); the reduced means and the transformed
gradients within rtol 1e-6 (the sums over ranks run in another order)
and atol 1e-7; the ring's product within rtol 1e-6 and atol 1e-6 of the
product's largest entry (each entry is a float32 dot of 16 terms that
torch and XLA sum in other orders, and some cancel to near 0).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_worlds  # noqa: E402

WORLDS = (2, 4)


def _inputs(world):
    rng = np.random.default_rng(world)
    x = rng.normal(size=(world, 64)).astype(np.float32)
    err = (rng.normal(size=(world, 64)) * 0.01).astype(np.float32)
    grads = {"w": rng.normal(size=(8, 5)).astype(np.float32),
             "b": rng.normal(size=(5,)).astype(np.float32) * 3}
    xm = rng.normal(size=(world * 6, 16)).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    return x, err, grads, xm, w


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: (inputs, the ranks' results)} and the reference's arrays."""
    job = [(world,) + _inputs(world) for world in WORLDS]
    proc, out = torch_worlds.start_reference(
        job, str(tmp_path_factory.mktemp("ref")),
        script=torch_worlds.REFERENCE_TRAIN)
    try:
        ports = {world: (_inputs(world), torch_worlds.run_world(
            world, torch_worlds.train_job, *_inputs(world)))
                 for world in WORLDS}
    finally:
        ref = torch_worlds.reference_results(proc, out)
    return ports, ref


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_ef_int8_allreduce_equals_reference(runs, world):
    """Each rank's error feedback equals the reference's bit for bit, its
    int8 codes are the ones that error implies, and every rank holds the
    reference's mean of the dequantized values; the mean is within the
    int8 step of the exact mean of x + err."""
    ports, ref = runs
    (x, err, _, _, _), ranks = ports[world]
    for r, out in enumerate(ranks):
        assert out["err"].dtype == np.float32
        np.testing.assert_array_equal(out["err"], ref[f"{world}/err"][r])
        y = x[r] + err[r]
        implied = np.rint((y - ref[f"{world}/err"][r]) / out["scale"])
        np.testing.assert_array_equal(out["codes"].astype(np.float64),
                                      implied)
        assert out["codes"].dtype == np.int8
        assert np.abs(out["codes"]).max() == 127
        _close(out["ef"], ref[f"{world}/ef"][r])
    exact = (x + err).mean(axis=0)
    step = np.abs(x + err).max(axis=1).mean() / 127
    assert np.abs(ranks[0]["ef"] - exact).max() <= step


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_grad_transform_equals_reference(runs, world):
    """The transform over a DeviceMesh dim maps every leaf of the pytree
    as the reference's does; over the default group it keeps nested
    lists, tuples and dicts and gives the same leaves."""
    ports, ref = runs
    (_, _, grads, _, _), ranks = ports[world]
    for out in ranks:
        assert set(out["grad"]) == set(grads)
        for k, v in out["grad"].items():
            _close(v, ref[f"{world}/grad/{k}"])
            assert v.shape == grads[k].shape
        kind, inner, as_tuple, as_dict = out["nested"]
        assert (kind, inner) == ("list", "tuple")
        for k, v in zip(grads, as_tuple):
            np.testing.assert_array_equal(v, out["grad"][k])
        for k, v in as_dict.items():
            np.testing.assert_array_equal(v, out["grad"][k])


@pytest.mark.parametrize("world", WORLDS)
def test_ring_allgather_matmul_equals_reference(runs, world):
    """Every rank holds the full (m P, n) product, as the reference's
    ring leaves it and as x @ w gives it."""
    ports, ref = runs
    (_, _, _, xm, w), ranks = ports[world]
    for r, out in enumerate(ranks):
        assert out["ring"].shape == (xm.shape[0], w.shape[1])
        for want in (ref[f"{world}/ring"][r], xm @ w):
            np.testing.assert_allclose(out["ring"], want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
