"""The port's paper applications (``repro_torch.apps``) against the
reference's ``benchmarks/workloads.py``, on the CPU at small sizes.

The same numpy inputs go through both packages.  Integer results are
equal (N-queens, sudoku, the virus scan, knucleotide, sieve, hash, hash2,
mandelbrot's escape counts, the image combiner); float results are
within rtol 1e-5 (the work-loop programs, nbody, spectralnorm: float32
sums in another order) and the face detector's heat map within 1e-5 on
the reference's own filters, its counts equal except at pixels whose
reference heat is within 1e-5 of the 0.7 threshold.  Results keep the
reference's dtypes, and every registry's names, ``size_fn``, ``mem_fn``
and the bytes a call sends and returns (``pytree_bytes``) equal the
reference's.  Split-and-merge at k = 2 and 4 gives k = 1's value
exactly; the one speedup check runs ``Parallelizer.run`` with venue
seconds fixed per shard, so no host clock is compared.  Also the
experiment drivers' escalation rows against the reference's, and the
§5.3 section on the CPU.
"""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import applications as japps  # noqa: E402
from benchmarks import workloads as J  # noqa: E402
from repro.core import ExecutionController as JEC  # noqa: E402
from repro.core import venues as jvenues  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.apps import applications as tapps  # noqa: E402
from repro_torch.apps import parallel_clones as tpar  # noqa: E402
from repro_torch.apps import workloads as W  # noqa: E402
from repro_torch.core.clones import CloneState  # noqa: E402
from repro_torch.core.venues import pytree_bytes  # noqa: E402

CPU = "cpu"
RTOL = 1e-5
HEAT_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Eager torch on the CPU pays more for its thread pool than for these
    small ops; one thread keeps the loops to milliseconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_dtype(got, want):
    assert _np(got).dtype == np.asarray(want).dtype, (got, want)


# --------------------------------------------------------------------------- #
# Tables 3 and 4: every registered program, value, dtype and bytes
# --------------------------------------------------------------------------- #
INTEGER = {"hash": 50, "hash2": 3, "sieve": 4, "knucleotide": 2,
           "mandelbrot": 64}
FLOAT = {"fibonacci": 10, "matrix": 16, "methcall": 64, "nestedloop": 3,
         "objinst": 64, "binarytrees": 6, "nbody": 64, "spectralnorm": 64}


def _registries(device=None):
    return ({**J.micro_methods(), **J.realistic_methods()},
            {**W.micro_methods(device), **W.realistic_methods(device)})


def test_registry_names_and_complexity():
    micro, real = J.micro_methods(), J.realistic_methods()
    assert list(W.micro_methods(CPU)) == list(micro)
    assert list(W.realistic_methods(CPU)) == list(real)
    assert W.MICRO_COMPLEXITY == J.MICRO_COMPLEXITY
    for name, rm in {**W.micro_methods(CPU),
                     **W.realistic_methods(CPU)}.items():
        assert rm.name == name and rm.size_fn(7) == 7
        assert not rm.parallelizable and rm.mem_fn is None


@pytest.mark.parametrize("name", sorted({**INTEGER, **FLOAT}))
def test_program_matches_reference(name):
    n = {**INTEGER, **FLOAT}[name]
    jrm, trm = (r[name] for r in _registries(CPU))
    want, got = jrm.callable()(n), trm.callable()(n)
    _same_dtype(got, want)
    if name in INTEGER:
        assert int(got) == int(want), (name, got, want)
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL)
    # the bytes a remote call sends and returns
    assert pytree_bytes(((n,), {})) == jvenues.pytree_bytes(((n,), {}))
    assert pytree_bytes(got) == jvenues.pytree_bytes(want)
    assert trm.size_key(n) == jrm.size_key(n)


def test_fibonacci_iterations_match_reference():
    """The float32 power truncated to int32: equal at every n but 26,
    where XLA's CPU power rounds 4 ulps high (the docstring's note)."""
    for n in range(-2, 34):
        want = int(jnp.asarray(1.618 ** jnp.clip(n, 0, 30), jnp.int32))
        got = W.fib_iters(n)
        if n == 26:
            assert (got, want) == (271294, 271295)
        else:
            assert got == want, n


def test_remote_call_bytes_through_both_controllers():
    """Tx / Rx of a forced-remote call, as Tables 3 and 4 print them."""
    jmicro, tmicro = J.micro_methods(), W.micro_methods(CPU)
    jr = JEC().execute(jmicro["sieve"], 1, force="remote")
    tr = T.ExecutionController(device=CPU).execute(tmicro["sieve"], 1,
                                                   force="remote")
    assert (tr.tx_bytes, tr.rx_bytes) == (jr.tx_bytes, jr.rx_bytes)
    assert int(tr.value) == int(jr.value) and tr.venue == jr.venue


# --------------------------------------------------------------------------- #
# §7.3 applications
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [4, 5, 6])
def test_nqueens_matches_reference(n):
    want = J.nqueens(n, 0, n ** n)
    got = W.nqueens(n, 0, n ** n, device=CPU)
    _same_dtype(got, want)
    assert int(got) == int(want) == {4: 2, 5: 10, 6: 4}[n]
    # ragged and empty sub-ranges (6**6 spans three chunks of 2**14)
    for lo, hi in [(7, 3000), (100, 100), (0, 1), (20000, 46000)]:
        lo, hi = min(lo, n ** n), min(hi, n ** n)
        assert int(W.nqueens(n, lo, hi, device=CPU)) == \
            int(J.nqueens(n, lo, hi))


def test_sudoku_matches_reference():
    puz = np.asarray(tapps.PUZZLE)
    want, wok = J.sudoku(jnp.asarray(puz))
    got, ok = W.sudoku(puz, device=CPU)
    _same_dtype(got, want)
    _same_dtype(ok, wok)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert bool(ok) == bool(wok) is True
    # a puzzle that singles elimination cannot finish stays partial
    hard = puz.copy()
    hard[0] = 0
    hard[:, 0] = 0
    want, wok = J.sudoku(jnp.asarray(hard))
    got, ok = W.sudoku(hard, device=CPU)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert bool(ok) == bool(wok)


def _reference_face():
    """The reference detector's filters (``make_face_detector``'s key) and
    its heat map, written out as in ``benchmarks/workloads.py``."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    w1 = jax.random.normal(k1, (3, 3, 1, 8)) * 0.3
    w2 = jax.random.normal(k2, (3, 3, 8, 1)) * 0.3

    def heat(images):
        dn = ("NHWC", "HWIO", "NHWC")
        x = jax.lax.conv_general_dilated(images[..., None], w1, (1, 1),
                                         "SAME", dimension_numbers=dn)
        x = jax.lax.conv_general_dilated(jax.nn.relu(x), w2, (2, 2), "SAME",
                                         dimension_numbers=dn)
        return jax.nn.sigmoid(x[..., 0])

    return (np.asarray(w1), np.asarray(w2)), heat


def test_face_detector_matches_reference():
    (w1, w2), heat = _reference_face()
    imgs = np.random.default_rng(0).normal(size=(16, 64, 64)).astype(
        np.float32)
    det = W.make_face_detector(CPU, (w1, w2))
    want_heat = np.asarray(heat(jnp.asarray(imgs)))
    got_heat = _np(det.heat(torch.from_numpy(imgs)))
    np.testing.assert_allclose(got_heat, want_heat, rtol=0, atol=HEAT_ATOL)
    want = J.make_face_detector()(jnp.asarray(imgs))
    got = det(torch.from_numpy(imgs))
    _same_dtype(got, want)
    near = (np.abs(want_heat - 0.7) < HEAT_ATOL).sum(axis=(1, 2))
    assert (np.abs(_np(got) - np.asarray(want)) <= near).all()
    assert _np(got).sum() > 0                       # the threshold is hit
    # the port's own filters: the same law, another draw; the same counts
    # whatever the batch split
    own = W.make_face_detector(CPU)
    whole = _np(own(torch.from_numpy(imgs)))
    parts = np.concatenate([_np(own(torch.from_numpy(p)))
                            for p in np.array_split(imgs, 3)])
    np.testing.assert_array_equal(whole, parts)


def test_virus_scanner_matches_reference():
    rng = np.random.default_rng(3)
    files = rng.integers(0, 256, (6, 300)).astype(np.int32)
    sigs = np.random.default_rng(0).integers(0, 256, (64, 8))
    files[1, 10:18] = sigs[5]                       # plant hits
    files[4, 292:300] = sigs[63]
    files[4, 0:8] = sigs[5]
    want = J.make_virus_scanner()(jnp.asarray(files))
    got = W.make_virus_scanner(device=CPU)(torch.from_numpy(files))
    _same_dtype(got, want)
    assert int(got) == int(want) == 3


@pytest.mark.parametrize("shapes", [((30, 20), (25, 10)), ((8, 8), (12, 3))])
def test_image_combiner_matches_reference(shapes):
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=s).astype(np.float32) for s in shapes)
    want = J.image_combiner(jnp.asarray(a), jnp.asarray(b))
    got = W.image_combiner(torch.from_numpy(a), torch.from_numpy(b),
                           device=CPU)
    _same_dtype(got, want)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_application_registries_match_reference():
    imgs = np.zeros((10, 64, 64), np.float32)
    files = np.zeros((6, 128), np.int32)
    a, b = np.zeros((30, 20), np.float32), np.zeros((25, 10), np.float32)
    pairs = [
        (J.nqueens_method(6), W.nqueens_method(6, CPU), (3, 500), (3, 500)),
        (J.face_detection_method(), W.face_detection_method(CPU),
         (jnp.asarray(imgs),), (torch.from_numpy(imgs),)),
        (J.virus_scan_method(), W.virus_scan_method(CPU),
         (jnp.asarray(files),), (torch.from_numpy(files),)),
        (J.image_combiner_method(), W.image_combiner_method(CPU),
         (jnp.asarray(a), jnp.asarray(b)),
         (torch.from_numpy(a), torch.from_numpy(b))),
    ]
    for jrm, trm, jargs, targs in pairs:
        assert trm.name == jrm.name
        assert trm.parallelizable == jrm.parallelizable
        assert trm.size_key(*targs) == jrm.size_key(*jargs)
        assert pytree_bytes((targs, {})) == \
            jvenues.pytree_bytes((jargs, {}))
        if jrm.mem_fn is not None:
            assert trm.mem_fn(*targs) == jrm.mem_fn(*jargs)
        else:
            assert trm.mem_fn is None
        if jrm.parallelizable:
            for k in (2, 4):
                js, ts = jrm.split_fn(jargs, k), trm.split_fn(targs, k)
                assert [pytree_bytes(s) for s in ts] == \
                    [jvenues.pytree_bytes(s) for s in js]


# --------------------------------------------------------------------------- #
# split and merge through the controller; a speedup on fixed venue seconds
# --------------------------------------------------------------------------- #
def _small_apps():
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.normal(size=(12, 64, 64)).astype(np.float32))
    files = torch.from_numpy(rng.integers(0, 256, (6, 256)).astype(np.int32))
    files[2, :8] = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (64, 8))[9])
    return [("nqueens", W.nqueens_method(6, CPU), (0, 6 ** 6)),
            ("face", W.face_detection_method(CPU), (imgs,)),
            ("virus", W.virus_scan_method(CPU), (files,))]


@pytest.mark.parametrize("app", ["nqueens", "face", "virus"])
def test_split_and_merge_equal_one_clone(app):
    _, rm, args = [a for a in _small_apps() if a[0] == app][0]
    ec = T.ExecutionController(link="wifi-local", device=CPU)
    ec.pool.provision("main", 8, state=CloneState.RUNNING)
    one = ec.execute(rm, *args, force="remote").value
    for k in (2, 4):
        res = ec.execute(rm, *args, force="remote", n_clones=k)
        assert res.n_clones == k and res.venue == f"main x{k}"
        if app == "face":
            assert res.value.dtype == one.dtype
            assert torch.equal(res.value, one)
        else:                  # the merge sums the shards' int32 counts
            assert res.value == int(one)
    if app == "nqueens":
        assert int(one) == 4


def test_parallel_speedup_on_fixed_venue_seconds():
    """Figure 13's shape on a fixed clock: each shard costs 0.1 venue-s per
    image, so four RUNNING clones finish 32 faces in 0.8 s plus 3 x 0.05
    s of sync, against 3.2 s on one."""
    det = W.face_detection_method(CPU)
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(32, 64, 64)).astype(np.float32))

    def fixed(clone, fn, shard):
        return fn(*shard), 0.1 * shard[0].shape[0]

    out = {}
    for k in (1, 4):
        clock = T.VirtualClock()
        pool = T.ClonePool(clock=clock)
        pool.provision("main", 8, state=CloneState.RUNNING)
        par = T.Parallelizer(pool, clock=clock, device=CPU)
        out[k] = par.run(det.fn, det.split_fn((imgs,), k),
                         merge=det.merge_fn, venue_executor=fixed)
    assert out[1].makespan_s == pytest.approx(3.2)
    assert out[4].makespan_s == pytest.approx(0.8 + 3 * 0.05)
    assert torch.equal(out[4].value, out[1].value)


# --------------------------------------------------------------------------- #
# the experiment drivers
# --------------------------------------------------------------------------- #
def test_escalation_rows_match_reference():
    _, want = japps.run_escalation()
    _, got = tapps.run_escalation(CPU)
    assert [(n, d) for n, _, d in got] == [(n, d) for n, _, d in want]
    # the canvas holds both images exactly (the first side only: the
    # generator runs one side per step)
    side, a, b, res = next(tapps.escalations(CPU))
    assert side == 256 and res.venue == "main"
    assert torch.equal(res.value[:, :side], a)
    assert torch.equal(res.value[:, side:], b)


def test_vm_states_on_the_cpu():
    lines, csv = tpar.run_vm_states(CPU)
    assert lines[0].startswith("VM state transitions")
    assert "not measured, no card" in lines[-1]
    assert csv[0][0] == "vm_states/first_call"


def test_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from repro_torch.apps import run
    for make in (W.micro_methods, W.face_detection_method,
                 lambda: W.fibonacci(3), lambda: tapps._apps()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main([])
