"""The port's key files (`sdk.write_pk`, `sdk.read_pk` over
halo2_zkcert_tpu_torch/utils/npzstream.py) against numpy and the JAX
package.

`write_pk` streams the four column arrays a group of columns at a time,
deflated in threads, into the entries `np.savez_compressed` writes.  Its
file of the toy key (tests/data/toy_reference.npz) and of a k=9 key
(random canonical columns and the edge values 0, 1, r - 1, under the toy's
vk) is read by `np.load` (four (m, n, 33) int32 entries, exactly) and by
the JAX package's `read_pk` (equal columns), and is at most 1.1 times the
size of `np.savez_compressed`'s.  ZIP64 is forced, and reached through a
lowered size threshold, on small files.  `read_pk` of build/rsa_1.pk (the
JAX package's file, read as one stream) equals `from_reference_pk` of the
same arrays; its blocks stay within `GROUP_BYTES`; a corrupted entry is
refused on its CRC-32.  Tolerance: exact.
"""
import json
import os
import struct
import zipfile
import zlib

import numpy as np
import pytest
import torch

from halo2_zkcert_tpu_torch import sdk
from halo2_zkcert_tpu_torch.ops import field
from halo2_zkcert_tpu_torch.ops.field import FR
from halo2_zkcert_tpu_torch.plonk import from_reference_pk
from halo2_zkcert_tpu_torch.plonk.keygen import ProvingKey, vk_to_dict
from halo2_zkcert_tpu_torch.utils import npzstream

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "toy_reference.npz")
RSA_PK = os.path.join(ROOT, "build", "rsa_1.pk")
PK_ARRAYS = sdk.PK_ARRAYS


@pytest.fixture(scope="module")
def keys():
    z = np.load(FIXTURE)
    vk_dict = json.loads(z["vk_json"].tobytes())
    toy = from_reference_pk({k: z[k] for k in PK_ARRAYS}, vk_dict, "cpu")
    rng = np.random.default_rng(9)
    n = 1 << 9
    edges = [0, 1, FR.modulus - 1]

    def cols(m):
        vals = [int.from_bytes(rng.bytes(32), "little") % FR.modulus
                for _ in range(m * n)]
        vals[:len(edges)] = edges
        return field.from_ints(FR, vals, "cpu").reshape(m, n, 8)

    k9 = ProvingKey(toy.vk, *(cols(getattr(toy, k).shape[0])
                              for k in PK_ARRAYS))
    return {"toy": toy, "k9": k9}


def _jax_columns(path):
    from halo2_zkcert_tpu.sdk import read_pk as jread_pk
    jpk = jread_pk(path)
    return {k: field.from_resident(FR, torch.from_numpy(
        np.array(getattr(jpk, k)))) for k in PK_ARRAYS}, jpk


def _held(pk, path):
    """np.load's four entries, the JAX package's read_pk and the port's."""
    z = np.load(path + ".npz", allow_pickle=False)
    assert sorted(z.files) == sorted(PK_ARRAYS)
    for k in PK_ARRAYS:
        cols = getattr(pk, k)
        assert z[k].dtype == np.dtype("<i4")
        assert z[k].shape == tuple(cols.shape[:2]) + (33,)
        assert np.array_equal(z[k], sdk._limbs(cols)), k
    jcols, jpk = _jax_columns(path)
    for k in PK_ARRAYS:
        assert torch.equal(jcols[k], getattr(pk, k)), k
    assert jpk.vk.transcript_repr() == pk.vk.transcript_repr()
    back = sdk.read_pk(path, "cpu")
    for k in PK_ARRAYS:
        assert torch.equal(getattr(back, k), getattr(pk, k)), k
    assert vk_to_dict(back.vk) == vk_to_dict(pk.vk)


@pytest.mark.parametrize("name", ["toy", "k9"])
def test_write_pk_is_read_by_numpy_and_the_jax_package(keys, name,
                                                       tmp_path):
    path = str(tmp_path / f"{name}.pk")
    sdk.write_pk(keys[name], path, cache_digest=b"\x02" * 32)
    infos = zipfile.ZipFile(path + ".npz").infolist()
    assert all(npzstream.NpzReader.chunk_index(i) for i in infos)
    assert zipfile.ZipFile(path + ".npz").testzip() is None
    _held(keys[name], path)
    with open(path + ".vk") as f:
        assert json.load(f)["cache_digest"] == "02" * 32


@pytest.mark.parametrize("name", ["toy", "k9"])
def test_file_size_against_savez_compressed(keys, name, tmp_path):
    path = str(tmp_path / f"{name}.pk")
    sdk.write_pk(keys[name], path)
    np.savez_compressed(str(tmp_path / "savez.npz"),
                        **{k: sdk._limbs(getattr(keys[name], k))
                           for k in PK_ARRAYS})
    ours = os.path.getsize(path + ".npz")
    theirs = os.path.getsize(str(tmp_path / "savez.npz"))
    assert ours <= 1.1 * theirs, (ours, theirs)


@pytest.mark.parametrize("limit", [0, 150000])
def test_zip64(keys, limit, tmp_path, monkeypatch):
    """ZIP64 sizes, offsets and end records, on a small file, through a
    lowered threshold: everywhere (0), or where a size or an offset
    reaches it (the first entries below it, the last ones past it)."""
    monkeypatch.setattr(npzstream, "ZIP64_LIMIT", limit)
    path = str(tmp_path / "k9.pk")
    sdk.write_pk(keys["k9"], path)
    monkeypatch.setattr(npzstream, "ZIP64_LIMIT", 0xFFFFFFFF)
    with open(path + ".npz", "rb") as f:
        raw = f.read()
    assert b"PK\x06\x06" in raw and b"PK\x06\x07" in raw   # ZIP64 EOCD
    infos = zipfile.ZipFile(path + ".npz").infolist()
    with_z64 = [any(struct.unpack("<H", i.extra[j:j + 2])[0] == 1
                    for j in _fields(i.extra)) for i in infos]
    if not limit:
        assert all(with_z64)
    else:
        assert not with_z64[0] and with_z64[-1]
        assert infos[0].file_size < limit <= infos[-1].file_size
        assert infos[-1].header_offset >= limit
    _held(keys["k9"], path)


def _fields(extra):
    """Offsets of the fields of a zip extra block."""
    j = 0
    while j + 4 <= len(extra):
        yield j
        j += 4 + struct.unpack("<H", extra[j + 2:j + 4])[0]


def test_read_pk_of_the_jax_packages_rsa_key():
    """build/rsa_1.pk (written by the JAX package: limbs up to 256, a 33rd
    limb set, a fifth entry) read as one stream, against np.load."""
    for info in zipfile.ZipFile(RSA_PK + ".npz").infolist():
        assert npzstream.NpzReader.chunk_index(info) is None
    pk = sdk.read_pk(RSA_PK, "cpu")
    z = np.load(RSA_PK + ".npz", allow_pickle=False)
    with open(RSA_PK + ".vk") as f:
        ref = from_reference_pk({k: z[k] for k in PK_ARRAYS}, json.load(f),
                                "cpu")
    for k in PK_ARRAYS:
        assert torch.equal(getattr(pk, k), getattr(ref, k)), k
    assert vk_to_dict(pk.vk) == vk_to_dict(ref.vk)


def test_read_pk_holds_a_group_of_columns_at_a_time(keys, tmp_path,
                                                    monkeypatch):
    path = str(tmp_path / "k9.pk")
    sdk.write_pk(keys["k9"], path)
    n = keys["k9"].fixed_lagrange.shape[1]
    monkeypatch.setattr(sdk, "GROUP_BYTES", n * 33 * 4)
    seen = []
    real = sdk.resident_columns
    monkeypatch.setattr(sdk, "resident_columns",
                        lambda b, d: seen.append(b.shape) or real(b, d))
    back = sdk.read_pk(path, "cpu")
    assert seen and all(s == (1, n, 33) for s in seen)
    for k in PK_ARRAYS:
        assert torch.equal(getattr(back, k), getattr(keys["k9"], k))


def test_read_pk_of_a_savez_file(keys, tmp_path):
    """A file numpy wrote (no chunk index) goes through zipfile's stream."""
    path = str(tmp_path / "k9.pk")
    sdk.write_vk(keys["k9"].vk, path + ".vk")
    np.savez_compressed(path, **{k: sdk._limbs(getattr(keys["k9"], k))
                                 for k in PK_ARRAYS})
    back = sdk.read_pk(path, "cpu")
    for k in PK_ARRAYS:
        assert torch.equal(getattr(back, k), getattr(keys["k9"], k))


def test_a_corrupted_entry_is_refused(keys, tmp_path):
    path = str(tmp_path / "k9.pk")
    sdk.write_pk(keys["k9"], path)
    info = zipfile.ZipFile(path + ".npz").getinfo("fixed_coeff.npy")
    with open(path + ".npz", "r+b") as f:
        f.seek(info.header_offset + 30 + len("fixed_coeff.npy")
               + info.compress_size // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x10]))
    with pytest.raises((zipfile.BadZipFile, zlib.error)):
        sdk.read_pk(path, "cpu")


@pytest.mark.parametrize("lengths", [(0, 5), (1, 1), (4096, 100000),
                                     (1 << 20, 3)])
def test_crc32_combine(lengths):
    rng = np.random.default_rng(lengths[0])
    a, b = rng.bytes(lengths[0]), rng.bytes(lengths[1])
    assert npzstream.crc32_combine(zlib.crc32(a), zlib.crc32(b),
                                   len(b)) == zlib.crc32(a + b)
