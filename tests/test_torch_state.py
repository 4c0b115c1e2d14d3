"""The state layer: symmer_torch.kernels.torch_state and the six device
dispatch entries against symmer_tpu.

The same seeded numpy inputs go through each plain-torch function (CPU
device) and its jx_state counterpart (JAX on the CPU, x64), and through the
port's dispatch and symmer_tpu's, both under backend="device".  Basis-row
and term sets must be equal; amplitudes, coefficients and scalars agree
within 1e-12 relative (the sums run in another order).  Bits and booleans
must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symmer_tpu
import symmer_torch
from symmer_tpu.config import config as jconfig
from symmer_tpu.kernels import dispatch as jdispatch
from symmer_tpu.kernels import jx_state, np_core, pack, state_core
from symmer_torch import config as tconfig
from symmer_torch.kernels import cuda, torch_state
from symmer_torch.kernels import dispatch as tdispatch
from symmer_torch.profiling import kernel_stats

RTOL = 1e-12
QUBITS = [5, 64, 130]


@pytest.fixture(autouse=True)
def device_backends(monkeypatch):
    old = (tconfig.backend, tconfig.device, jconfig.backend)
    tconfig.backend, tconfig.device, jconfig.backend = "device", "cpu", "device"
    # the small inputs here take the device path of every entry
    monkeypatch.setattr(tdispatch, "DEVICE_FLOOR", 0)
    yield
    tconfig.backend, tconfig.device, jconfig.backend = old


def planes(rng, rows, n_qubits, density=0.5):
    return pack.pack_bits(rng.random((rows, n_qubits)) < density, n_qubits)


def cplx(rng, n):
    return rng.normal(size=n) + 1j * rng.normal(size=n)


def tt(a):
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a.copy())


def jj(a):
    return jnp.asarray(pack.to_u32(np.ascontiguousarray(a, np.uint64)))


def state_with_duplicates(rng, n_rows, n_qubits, n_dup):
    """Basis rows where the last n_dup repeat earlier ones (amplitudes differ)."""
    s = planes(rng, n_rows, n_qubits)
    if n_dup:
        s = np.vstack([s, s[rng.integers(0, n_rows, n_dup)]])
    return s, cplx(rng, s.shape[0])


def operator(rng, n_terms, n_qubits, hermitian):
    """Random terms; hermitian=False gives complex coefficients (so the
    expectation value has an imaginary part)."""
    x, z = planes(rng, n_terms, n_qubits, 0.3), planes(rng, n_terms, n_qubits, 0.3)
    c = rng.normal(size=n_terms) if hermitian else cplx(rng, n_terms)
    # a share of I/Z-only terms, whose targets always match
    x[: n_terms // 3] = 0
    return x, z, np.asarray(c, complex)


def as_set(bits, amps):
    """{row bytes: amplitude} of a deduplicated state."""
    bits = np.ascontiguousarray(bits, np.uint64)
    assert len({r.tobytes() for r in bits}) == bits.shape[0]
    return {r.tobytes(): a for r, a in zip(bits, amps)}


def assert_same_state(a, b, rtol=RTOL):
    da, db = as_set(*a), as_set(*b)
    assert da.keys() == db.keys()
    for k in da:
        assert abs(da[k] - db[k]) <= rtol * max(abs(da[k]), abs(db[k]), 1e-300)


def assert_close(a, b, rtol=RTOL):
    assert abs(a - b) <= rtol * max(abs(a), abs(b), 1e-300), (a, b)


def scalar(re, im):
    return complex(float(re), float(im))


@pytest.mark.parametrize("n_qubits", QUBITS)
def test_apply_to_ket_and_bra_match_jx_state(n_qubits):
    """Pre-cleanup rows in each side's own order: t*B + b for the ket,
    b*T + t for the bra; amplitudes within 1e-12."""
    rng = np.random.default_rng(n_qubits)
    x, z, c = operator(rng, 9, n_qubits, hermitian=False)
    s, a = state_with_duplicates(rng, 6, n_qubits, 2)
    t_args = (tt(x), tt(z), tt(c.real), tt(c.imag))
    t_state = (tt(s), tt(a.real), tt(a.imag))
    j_args = (jj(x), jj(z), jnp.asarray(c.real), jnp.asarray(c.imag))
    j_state = (jj(s), jnp.asarray(a.real), jnp.asarray(a.imag))
    for got, want in (
        (torch_state.apply_to_ket(*t_args, *t_state), jx_state.apply_to_ket(*j_args, *j_state)),
        (torch_state.apply_to_bra(*t_state, *t_args), jx_state.apply_to_bra(*j_state, *j_args)),
    ):
        assert np.array_equal(got[0].numpy().view(np.uint64), pack.from_u32(np.asarray(want[0])))
        g = got[1].numpy() + 1j * got[2].numpy()
        w = np.asarray(want[1]) + 1j * np.asarray(want[2])
        assert np.all(np.abs(g - w) <= RTOL * np.maximum(np.abs(w), 1e-300))


@pytest.mark.parametrize("n_qubits", QUBITS)
@pytest.mark.parametrize("threshold", [None, 1e-12])
def test_cleanup_state_matches_jx_state(n_qubits, threshold):
    rng = np.random.default_rng(2 * n_qubits)
    s, a = state_with_duplicates(rng, 40, n_qubits, 25)
    a[-1] = 1e-14  # a basis row of its own below the threshold
    s[-1] = ~s[:-1].max(axis=0) & pack.qubit_mask(n_qubits)
    if (s[:-1] == s[-1]).all(axis=1).any():
        s, a = s[:-1], a[:-1]
    b, r, i = torch_state.cleanup_state(tt(s), tt(a.real), tt(a.imag), threshold)
    jb, jr, ji, n = jx_state.cleanup_state(
        jj(s), jnp.asarray(a.real), jnp.asarray(a.imag), s.shape[0], threshold
    )
    n = int(n)
    want = (pack.from_u32(np.asarray(jb[:n])), np.asarray(jr[:n]) + 1j * np.asarray(ji[:n]))
    assert_same_state((b.numpy().view(np.uint64), r.numpy() + 1j * i.numpy()), want)


@pytest.mark.parametrize("n_qubits", QUBITS)
def test_inner_product_sorted_matches_jx_state(n_qubits):
    rng = np.random.default_rng(3 * n_qubits)
    s1 = np.unique(planes(rng, 30, n_qubits, 0.1), axis=0)
    s2 = np.unique(np.vstack([s1[::2], planes(rng, 20, n_qubits, 0.1)]), axis=0)
    a1, a2 = cplx(rng, s1.shape[0]), cplx(rng, s2.shape[0])
    got = torch_state.inner_product_sorted(
        tt(s1), tt(a1.real), tt(a1.imag), tt(s2), tt(a2.real), tt(a2.imag)
    )
    want = jx_state.inner_product_sorted(
        jj(s1), jnp.asarray(a1.real), jnp.asarray(a1.imag), s1.shape[0],
        jj(s2), jnp.asarray(a2.real), jnp.asarray(a2.imag), s2.shape[0],
    )
    assert_close(scalar(*got), scalar(*want))
    assert_close(scalar(*got), state_core.inner_product(s1, a1, s2, a2))


@pytest.mark.parametrize("n_qubits", QUBITS)
@pytest.mark.parametrize("hermitian", [True, False])
@pytest.mark.parametrize("n_rows", [1, 7, 50])
def test_expval_matches_jx_state(n_qubits, hermitian, n_rows):
    """The plain K10 (binary search, exact row match) against the host
    oracle and, at a few shapes, jx_state's hash-matched expval, on
    deduplicated states whose rows differ by the operator's X parts (so many
    pairs match)."""
    rng = np.random.default_rng(n_qubits + n_rows + hermitian)
    x, z, c = operator(rng, 12, n_qubits, hermitian)
    s = planes(rng, 1, n_qubits)
    for t in rng.integers(0, 12, n_rows - 1):
        s = np.vstack([s, s[-1] ^ x[t]])
    s = np.unique(s, axis=0)
    a = cplx(rng, s.shape[0])
    got = torch_state.expval(
        tt(x), tt(z), tt(c.real), tt(c.imag), tt(s), tt(a.real), tt(a.imag)
    )
    host = state_core.expval(x, z, c, s, a)
    assert_close(scalar(*got), host)
    if n_rows == 7 and n_qubits != 64:  # jx_state compiles per shape: a few
        want = jx_state.expval(
            jj(x), jj(z), jnp.asarray(c.real), jnp.asarray(c.imag),
            jj(s), jnp.asarray(a.real), jnp.asarray(a.imag), s.shape[0],
        )
        assert_close(scalar(*got), scalar(*want))
    if not hermitian and n_rows > 1:
        assert abs(host.imag) > 1e-3  # the imaginary part is exercised


def test_expval_empty_operands():
    x = np.zeros((0, 1), np.uint64)
    s = np.zeros((3, 1), np.uint64)
    z0 = torch.zeros(0, dtype=torch.float64)
    z3 = torch.zeros(3, dtype=torch.float64)
    assert scalar(*torch_state.expval(tt(x), tt(x), z0, z0, tt(s), z3, z3)) == 0
    assert scalar(*cuda.expval(tt(s), tt(s), z3, z3, tt(x), z0, z0)) == 0


def test_row_order_and_lower_bound():
    """sort_rows orders whole rows word 0 first; lower_bound finds every row
    and the insertion point of rows not present."""
    rng = np.random.default_rng(5)
    s = rng.integers(-4, 4, size=(60, 3)).astype(np.int64)
    s = np.unique(s, axis=0)
    shuffled = torch.from_numpy(s[rng.permutation(s.shape[0])])
    srt = shuffled[torch_state.sort_rows(shuffled)]
    assert np.array_equal(srt.numpy(), s)  # numpy's unique sorts the same way
    assert np.array_equal(torch_state.lower_bound(srt, srt).numpy(), np.arange(s.shape[0]))
    probe = rng.integers(-5, 5, size=(80, 3)).astype(np.int64)
    got = torch_state.lower_bound(srt, torch.from_numpy(probe)).numpy()
    keys = [tuple(r) for r in s]
    want = [sum(k < tuple(p) for k in keys) for p in probe]
    assert np.array_equal(got, want)


# -- the six dispatch entries, port vs symmer_tpu, backend="device" --------------

def dispatch_pair(name):
    return getattr(tdispatch, name), getattr(jdispatch, name)


@pytest.mark.parametrize("n_qubits", QUBITS)
def test_dispatch_qubitwise_commutes(n_qubits):
    rng = np.random.default_rng(n_qubits + 11)
    x1, z1 = planes(rng, 40, n_qubits, 0.1), planes(rng, 40, n_qubits, 0.1)
    x2, z2 = planes(rng, 17, n_qubits, 0.1), planes(rng, 17, n_qubits, 0.1)
    kernel_stats.reset()
    t, j = dispatch_pair("qubitwise_commutes")
    got = t(x1, z1, x2, z2)
    assert kernel_stats.device_calls["qubitwise_commutes"] == 1
    assert np.array_equal(got, np.asarray(j(x1, z1, x2, z2)))
    assert np.array_equal(got, np_core.qubitwise_commutes(x1, z1, x2, z2))
    assert got.any() and not got.all()


@pytest.mark.parametrize("n_qubits", QUBITS)
@pytest.mark.parametrize("hermitian", [True, False])
def test_dispatch_expval_with_duplicate_rows(n_qubits, hermitian):
    rng = np.random.default_rng(n_qubits + 21 + hermitian)
    x, z, c = operator(rng, 15, n_qubits, hermitian)
    s, a = state_with_duplicates(rng, 9, n_qubits, 6)
    s = np.vstack([s, s[:4] ^ x[5], s[:3] ^ x[6]])
    a = np.concatenate([a, cplx(rng, 7)])
    kernel_stats.reset()
    t, j = dispatch_pair("expval")
    got = t(x, z, c, s, a)
    assert kernel_stats.device_calls["expval"] == 1
    assert_close(got, j(x, z, c, s, a))
    assert_close(got, state_core.expval(x, z, c, s, a))


@pytest.mark.parametrize("n_qubits", QUBITS)
@pytest.mark.parametrize("entry", ["apply_state", "apply_bra"])
def test_dispatch_apply(n_qubits, entry):
    rng = np.random.default_rng(n_qubits + 31)
    x, z, c = operator(rng, 11, n_qubits, hermitian=False)
    s, a = state_with_duplicates(rng, 8, n_qubits, 3)
    t, j = dispatch_pair(entry)
    args = (x, z, c, s, a) if entry == "apply_state" else (s, a, x, z, c)
    kernel_stats.reset()
    got = t(*args, 1e-15)
    assert kernel_stats.device_calls[entry] == 1
    assert_same_state(got, j(*args, 1e-15))


@pytest.mark.parametrize("n_qubits", QUBITS)
def test_dispatch_inner_product_with_duplicate_rows(n_qubits):
    rng = np.random.default_rng(n_qubits + 41)
    s1, a1 = state_with_duplicates(rng, 12, n_qubits, 5)
    s2, a2 = state_with_duplicates(rng, 6, n_qubits, 4)
    s2 = np.vstack([s2, s1[:7]])
    a2 = np.concatenate([a2, cplx(rng, 7)])
    kernel_stats.reset()
    t, j = dispatch_pair("inner_product")
    got = t(s1, a1, s2, a2)
    assert kernel_stats.device_calls["inner_product"] == 1
    assert_close(got, j(s1, a1, s2, a2))
    assert_close(got, state_core.inner_product(s1, a1, s2, a2))


@pytest.mark.parametrize("entry", ["apply_state", "apply_bra", "anticommutes"])
def test_dispatch_floor_keeps_small_calls_on_host(entry, monkeypatch):
    """Under backend="device", these entries run on the host below
    dispatch.DEVICE_FLOOR term-words and on the device at or above it, with
    the same result either way; multiply_cleanup has no floor."""
    rng = np.random.default_rng(51)
    n_qubits = 130  # 3 words per row
    x, z, c = operator(rng, 16, n_qubits, hermitian=False)
    s, a = state_with_duplicates(rng, 40, n_qubits, 5)
    work = 16 * 45 * x.shape[1]  # terms x state rows x words
    args = {
        "apply_state": (x, z, c, s, a, 1e-15),
        "apply_bra": (s, a, x, z, c, 1e-15),
        "anticommutes": (x, z, s, s),
    }[entry]
    out = {}
    for floor, side in ((work + 1, "host"), (work, "device")):
        monkeypatch.setattr(tdispatch, "DEVICE_FLOOR", floor)
        kernel_stats.reset()
        out[side] = getattr(tdispatch, entry)(*args)
        calls = kernel_stats.device_calls if side == "device" else kernel_stats.host_calls
        assert calls[entry] == 1, (side, floor)
    if entry == "anticommutes":
        assert np.array_equal(out["host"], out["device"])
    else:
        assert_same_state(out["device"], out["host"])
    kernel_stats.reset()
    tdispatch.multiply_cleanup(x, z, c, s, s, a, 1e-15)
    assert kernel_stats.device_calls["multiply"] == 1
    if not torch.cuda.is_available():
        # a call below the floor does not hide a missing card
        monkeypatch.setattr(tdispatch, "DEVICE_FLOOR", work + 1)
        tconfig.device = "cuda"
        with pytest.raises(RuntimeError, match="is_available"):
            getattr(tdispatch, entry)(*args)


@pytest.fixture(scope="module")
def noncontextual_1024():
    """A 1024-term noncontextual operator (symmer_tpu's generator, global
    numpy RNG seeded) and the same operator plus one term that makes it
    contextual, as host planes."""
    np.random.seed(3)
    nc = symmer_tpu.operators.NoncontextualOp.random(n_qubits=10, n_cliques=3)
    x, z = nc.x_pack.copy(), nc.z_pack.copy()
    extra = symmer_tpu.PauliwordOp.random(10, 40)
    for k in range(extra.n_terms):
        op = symmer_tpu.PauliwordOp.from_planes(
            np.vstack([x, extra.x_pack[k:k + 1]]), np.vstack([z, extra.z_pack[k:k + 1]]),
            np.ones(x.shape[0] + 1), 10,
        )
        if not op.is_noncontextual:
            return (x, z), (op.x_pack, op.z_pack)
    raise AssertionError("no contextual extension found")


@pytest.mark.parametrize("which", [0, 1])
def test_dispatch_is_noncontextual(noncontextual_1024, which):
    x, z = noncontextual_1024[which]
    assert x.shape[0] >= 1024
    kernel_stats.reset()
    t, j = dispatch_pair("is_noncontextual")
    got = t(x, z)
    assert kernel_stats.device_calls["is_noncontextual"] == 1
    assert got is (which == 0)
    assert got == j(x, z)
    # below the device row threshold the caller runs the host path
    assert t(x[:1000], z[:1000]) is None


def test_pauliwordop_state_paths_on_device(h2_fixture):
    """PauliwordOp.expval / * state / bra algebra go through the device
    entries and agree with symmer_tpu's host path."""
    H_t = symmer_torch.PauliwordOp.from_dictionary(h2_fixture["H_dict"])
    H_j = symmer_tpu.PauliwordOp.from_dictionary(h2_fixture["H_dict"])
    rng = np.random.default_rng(7)
    amps = cplx(rng, 3)
    rows = np.array([[1, 1, 0, 0], [0, 1, 1, 0], [1, 0, 0, 1]])
    psi_j = symmer_tpu.QuantumState(rows, amps).normalize
    psi_t = symmer_torch.operators.from_numpy_state(psi_j._s_pack, psi_j._amps, 4)
    jconfig.backend = "host"
    kernel_stats.reset()
    assert_close(H_t.expval(psi_t), H_j.expval(psi_j))
    assert_same_state(
        ((H_t * psi_t)._s_pack, (H_t * psi_t)._amps), ((H_j * psi_j)._s_pack, (H_j * psi_j)._amps)
    )
    assert_close(psi_t.dagger * (H_t * psi_t), psi_j.dagger * (H_j * psi_j))
    for name in ("expval", "apply_state", "inner_product"):
        assert kernel_stats.device_calls[name] >= 1, name


def test_from_numpy_state_checks_shapes():
    with pytest.raises(ValueError, match="words per row"):
        symmer_torch.operators.from_numpy_state(np.zeros((2, 2), np.uint64), [1, 1], 5)
    with pytest.raises(ValueError, match="amplitudes"):
        symmer_torch.operators.from_numpy_state(np.zeros((2, 1), np.uint64), [1], 5)
