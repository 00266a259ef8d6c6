"""The port's four-step transform (ops/ntt_mxu.py) on the CPU, where its base
DFT runs the plain version of csrc/ntt_mxu.cu (the digit product as a float64
matrix product, the carry and reduction in int64): every flavour equal, as
residues, to the JAX package's ops/ntt_mxu.py and to the port's radix-2
transform; the constant matrices' values equal to the JAX package's
`_dft_consts`; the toy proof with every transform on the four-step equal to
the JAX proof's bytes."""
import ctypes
import json
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_zkcert_tpu.ops import ntt_mxu as jmxu
from halo2_zkcert_tpu.ops.field import Fr as JFr
from halo2_zkcert_tpu_torch.ops import field, ntt, ntt_mxu
from halo2_zkcert_tpu_torch.ops.field import FR
from halo2_zkcert_tpu_torch.utils import refcrypto as rc

torch.set_num_threads(2)

G = rc.FR_GENERATOR
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "halo2_zkcert_tpu_torch", "csrc")


def _rand(seed, count):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % rc.FR
            for _ in range(count)]
    vals[:3] = [0, 1, rc.FR - 1][:count]
    return vals


def _cols(seed, k, cols=2):
    """(cols, 2^k, 8) port words and the JAX package's (2^k, cols, 33)."""
    n = 1 << k
    vals = [_rand(seed + c, n) for c in range(cols)]
    t = field.from_ints(FR, sum(vals, []), "cpu").reshape(cols, n, 8)
    j = jnp.stack([JFr.from_ints(v) for v in vals], axis=1)
    return t, j


def _jints(arr, c):
    return [int(v) % rc.FR for v in JFr.to_ints(arr[:, c])]


@pytest.mark.parametrize("k", [5, 8, 10])
def test_four_flavours_equal_jax_four_step(k):
    t, j = _cols(100 + k, k)
    for mine, ref in ((ntt_mxu.ntt(t, k), jmxu.ntt(j, k)),
                      (ntt_mxu.intt(t, k), jmxu.intt(j, k)),
                      (ntt_mxu.coset_ntt(t, k, G), jmxu.coset_ntt(j, k, G)),
                      (ntt_mxu.coset_intt(t, k, G), jmxu.coset_intt(j, k, G))):
        for c in range(2):
            assert field.to_ints(mine[c]) == _jints(ref, c)


@pytest.mark.parametrize("k", [1, 5, 8, 9])
def test_montgomery_forms_and_padding_equal_radix2(k):
    """`out_mont` / `in_mont` and a short input against ops/ntt.py's
    radix-2 transforms, word for word."""
    t, _ = _cols(200 + k, k)
    short = t[:, :max(1, (1 << k) // 2 - 1)]
    pairs = ((ntt_mxu.ntt(t, k), ntt.ntt(t, k)),
             (ntt_mxu.intt(t, k), ntt.intt(t, k)),
             (ntt_mxu.coset_ntt(short, k, G, out_mont=True),
              ntt.coset_ntt(short, k, G, out_mont=True)),
             (ntt_mxu.coset_ntt(short, k, G), ntt.coset_ntt(short, k, G)),
             (ntt_mxu.coset_intt(t, k, G, in_mont=True),
              ntt.coset_intt(t, k, G, in_mont=True)),
             (ntt_mxu.coset_intt(t, k, G), ntt.coset_intt(t, k, G)))
    for mine, ref in pairs:
        assert torch.equal(mine, ref)


@pytest.mark.parametrize("r_log,w,in_scale,out_scale,const", [
    (3, rc.fr_root_of_unity(3), 1, 1, 1),
    (5, rc.fr_root_of_unity(5), G, 1, 7),
    (4, pow(rc.fr_root_of_unity(4), rc.FR - 2, rc.FR), 1, 5, 1 << 250)])
def test_constant_matrix_equals_jax_dft_consts(r_log, w, in_scale, out_scale,
                                               const):
    """W[k, j] decoded from the port's rows (k, l) x columns (j, l2) equals
    W decoded from the JAX package's rows (l, k) x columns (l2, j): the same
    balanced digits, the limb convolution folded in the same way."""
    r = 1 << r_log
    lhs, corr = ntt_mxu.dft_consts(r_log, w, in_scale, out_scale, const)
    jlhs, _ = jmxu._dft_consts(r_log, w, in_scale, out_scale, const)
    mine = lhs.reshape(r, ntt_mxu.LOUT, r, ntt_mxu.NB)
    theirs = jlhs.reshape(jmxu.LOUT, r, jmxu.L2, r)
    want = ntt_mxu.dft_matrix(r_log, w, in_scale, out_scale, const)
    for k in range(r):
        for j in range(r):
            for l2 in (0, 17, ntt_mxu.NB - 1):
                d = mine[k, l2:l2 + ntt_mxu.L1, j, l2]
                assert ntt_mxu.digits_value(d) == want[k][j]
                assert not mine[k, :l2, j, l2].any()
                assert not mine[k, l2 + ntt_mxu.L1:, j, l2].any()
            jd = theirs[:jmxu.L1, k, 0, j]
            assert (jd == mine[k, :ntt_mxu.L1, j, 0]).all()
    row_sums = lhs.astype(np.int64).sum(axis=1).reshape(r, ntt_mxu.LOUT)
    assert (corr == ntt_mxu.offset_digits()[None] + 128 * row_sums).all()
    assert corr.min() >= 0


def test_offset_and_levels():
    """The offset is a multiple of p with every digit inside its band; the
    levels of a transform are balanced and sum to k."""
    off = ntt_mxu.offset_digits()
    assert len(off) == ntt_mxu.LOUT
    assert ntt_mxu.digits_value(off) % rc.FR == 0
    assert off.min() >= ntt_mxu.OFFSET_LO and off.max() <= ntt_mxu.OFFSET_HI
    assert ntt_mxu.levels(17) == [5, 6, 6]
    assert ntt_mxu.levels(19) == [6, 6, 7]
    assert ntt_mxu.levels(7) == [7]
    for k in range(1, 24):
        lv = ntt_mxu.levels(k)
        assert sum(lv) == k and max(lv) <= ntt_mxu.MAX_RADIX_LOG
        assert max(lv) - min(lv) <= 1


@pytest.mark.parametrize("r_log,G_,C,cout_mul", [(1, 1, 1, 1), (3, 2, 4, 2),
                                                 (5, 3, 2, 1), (4, 4, 2, 4)])
def test_base_dft_layouts_equal_definition(r_log, G_, C, cout_mul):
    """dft_s8_plain over m columns read at column stride cin and written at
    cout: Y[k, col] = sum_j W[k, j] X[j, col], checked with Python ints."""
    r = 1 << r_log
    vals = _rand(r_log * 10 + C, G_ * r * C)
    x = field.from_ints(FR, vals, "cpu")
    w = rc.fr_root_of_unity(r_log)
    consts = ntt_mxu._consts(r_log, w, 5, 7, 11, "cpu")
    m, cin, cout = G_ * C, C, C * cout_mul
    got = field.to_ints(ntt_mxu.dft_s8(x, r_log, consts, cin, cout))
    W = ntt_mxu.dft_matrix(r_log, w, 5, 7, 11)
    X = np.array(vals, dtype=object).reshape(m // cin, r, cin)
    for col in range(m):
        g, c = divmod(col, cin)
        go, co = divmod(col, cout)
        for k in range(r):
            want = sum(W[k][j] * X[g, j, c] for j in range(r)) % rc.FR
            assert got[(go * r + k) * cout + co] == want


def test_kernel_epilogue_on_the_host(tmp_path):
    """csrc/ntt_mxu.cu's addressing, digit mapping and epilogue
    (bn254.cuh dft_addr, dft_limbs_to_fe) built with g++ through
    csrc/host_check.cpp (the product as loops) equal the plain version."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    out = tmp_path / "libhc.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(out), os.path.join(CSRC, "host_check.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.hc_dft_s8.argtypes = [P, P, P, P, P, L, I, L, L]
    for r_log, C, cout in ((1, 1, 1), (3, 4, 12), (7, 3, 3), (5, 2, 6)):
        r = 1 << r_log
        x = field.from_ints(FR, _rand(r_log + C, 3 * r * C), "cpu")
        consts = ntt_mxu._consts(r_log, rc.fr_root_of_unity(r_log), G, 3,
                                 FR.r, "cpu")
        m = 3 * C
        want = ntt_mxu.dft_s8_plain(x, r_log, consts, C, cout)
        got = torch.empty_like(x)
        lhs, corr, fold = consts
        lib.hc_dft_s8(lhs.data_ptr(), corr.data_ptr(), fold.data_ptr(),
                      x.data_ptr(), got.data_ptr(), m, r_log, C, cout)
        assert torch.equal(got, want), (r_log, C, cout)


def test_dispatch_reads_the_switch_at_each_call(monkeypatch):
    """H2T_NTT_MXU=1 sends ops/ntt.py's transforms to the four-step; unset
    or under a mesh of several ranks they stay radix-2."""
    from halo2_zkcert_tpu_torch.parallel import prover_mesh
    from halo2_zkcert_tpu_torch.parallel.mesh import Mesh
    t, _ = _cols(7, 5)
    calls = []
    real = ntt_mxu.dft_s8
    monkeypatch.setattr(ntt_mxu, "dft_s8",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.delenv("H2T_NTT_MXU", raising=False)
    want = ntt.ntt(t, 5)
    assert not calls
    monkeypatch.setenv("H2T_NTT_MXU", "1")
    assert torch.equal(ntt.ntt(t, 5), want) and len(calls) == 1
    with prover_mesh(Mesh(0, 2, torch.device("cpu"), "gloo")):
        assert torch.equal(ntt.ntt(t, 5), want) and len(calls) == 1


@pytest.mark.slow
def test_nested_recursion_k15():
    """k=15 splits as 5 + 5 + 5: every flavour against the radix-2."""
    k = 15
    t, _ = _cols(15, k, cols=1)
    assert ntt_mxu.levels(k) == [5, 5, 5]
    assert torch.equal(ntt_mxu.ntt(t, k), ntt.ntt(t, k))
    assert torch.equal(ntt_mxu.intt(t, k), ntt.intt(t, k))
    assert torch.equal(ntt_mxu.coset_ntt(t, k, G, True),
                       ntt.coset_ntt(t, k, G, True))
    assert torch.equal(ntt_mxu.coset_intt(t, k, G, True),
                       ntt.coset_intt(t, k, G, True))


def test_toy_proof_on_the_four_step(monkeypatch, tmp_path):
    """The toy k=6 proof with every transform on the four-step
    (H2T_NTT_MXU=1; the fixed-base MSM forced, 8-bit windows) equals the JAX
    proof's bytes (tests/data/toy_reference.npz)."""
    from halo2_zkcert_tpu_torch.plonk import (create_proof, from_reference_pk,
                                              kzg, setup, verify_proof)
    from halo2_zkcert_tpu_torch.transcript import PoseidonTranscript
    ref = np.load(os.path.join(ROOT, "tests", "data", "toy_reference.npz"))
    pk = from_reference_pk(
        {k: ref[k] for k in ("fixed_lagrange", "fixed_coeff",
                             "sigma_lagrange", "sigma_coeff")},
        json.loads(ref["vk_json"].tobytes()), "cpu")
    instances = json.loads(ref["instances_json"].tobytes())
    advice = field.from_resident(FR, torch.from_numpy(ref["advice"]))
    monkeypatch.setenv("H2T_NTT_MXU", "1")
    monkeypatch.setenv("H2T_FB_MSM", "1")
    monkeypatch.setenv("PARAMS_DIR", str(tmp_path))
    monkeypatch.setattr(kzg, "FB_WBITS", 8)
    used, radix2 = [], []
    real = ntt_mxu.dft_s8
    monkeypatch.setattr(ntt_mxu, "dft_s8",
                        lambda *a, **k: used.append(a[1]) or real(*a, **k))
    real_plain = ntt._transform_plain
    monkeypatch.setattr(ntt, "_transform_plain",
                        lambda *a, **k: radix2.append(1) or real_plain(*a, **k))
    params = setup(pk.vk.k, device="cpu")
    radix2.clear()
    proof = create_proof(params, pk, advice, instances, PoseidonTranscript())
    assert used and not radix2
    assert proof == ref["proof_poseidon"].tobytes()
    assert verify_proof(params, pk.vk, instances, proof, PoseidonTranscript)
