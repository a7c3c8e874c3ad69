"""The port's ``tpu`` plugin (device=cpu) against the JAX package's.

The JAX plugin runs as its own tests run it on the CPU: backend ``jax``
(the kernels' XLA graph) and, for the exhaustive erasure sweep, its
numpy oracle backend.  The port's codecs are built around the JAX
codecs' coding matrices (ec.convert.codec_from_reference).  Everything
is integer: tolerance 0 (byte-exact).
"""

import itertools
import os

import numpy as np
import pytest
import torch

from ceph_tpu import ec as ref_ec
from ceph_tpu_torch import ec
from ceph_tpu_torch.ec.convert import codec_from_reference
from ceph_tpu_torch.ops import ec_kernels, gf256

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

RNG = np.random.default_rng(77)
CPU = torch.device("cpu")
CORPUS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "corpus",
    "tpu_k=8_m=3_technique=reed_sol_van")
TECHNIQUES = ["reed_sol_van", "cauchy_good", "cauchy_orig"]


def _pair(technique="reed_sol_van", k=8, m=3, backend="jax"):
    prof = {"k": str(k), "m": str(m), "technique": technique}
    ref = ref_ec.factory("tpu", dict(prof, backend=backend))
    port = codec_from_reference("tpu", prof, ref.matrix, device=CPU)
    return ref, port


@pytest.mark.parametrize("technique", TECHNIQUES)
def test_encode_and_encode_batch_equal(technique):
    ref, port = _pair(technique)
    assert np.array_equal(port.matrix, ref.matrix)
    assert port.get_flags() == ref.get_flags()
    obj = RNG.integers(0, 256, 8 * 1000 + 13, dtype=np.uint8).tobytes()
    got, want = port.encode(obj), ref.encode(obj)
    assert sorted(got) == sorted(want) == list(range(11))
    for i in want:
        assert np.array_equal(got[i], want[i]), i
    stripes = RNG.integers(0, 256, (5, 8, 512), dtype=np.uint8)
    assert np.array_equal(port.encode_batch(stripes),
                          ref.encode_batch(stripes))


def test_decode_every_pattern_up_to_three():
    """decode and decode_batch for every erasure pattern of 1-3 of the
    11 chunks, against the JAX plugin's outputs and the original
    chunks (exact)."""
    ref, port = _pair(backend="numpy")
    L = 64
    stripes = RNG.integers(0, 256, (3, 8, L), dtype=np.uint8)
    parity = ref.encode_batch(stripes)
    full = np.concatenate([stripes, parity], axis=1)
    n = 0
    for size in (1, 2, 3):
        for erased in itertools.combinations(range(11), size):
            avail = {i: full[:, i, :] for i in range(11) if i not in erased}
            got = port.decode_batch(list(erased), avail)
            want = ref.decode_batch(list(erased), avail)
            flat = {i: v[0] for i, v in avail.items()}
            one = port.decode(list(erased), flat)
            for i in erased:
                assert np.array_equal(got[i], want[i]), (erased, i)
                assert np.array_equal(got[i], full[:, i, :]), (erased, i)
                assert np.array_equal(one[i], full[0, i, :]), (erased, i)
            n += 1
    assert n == 11 + 55 + 165


@pytest.mark.parametrize("technique", TECHNIQUES)
@pytest.mark.parametrize("erased", [(1, 4, 9), (0, 1, 2), (8, 9, 10), (7,),
                                    (3, 10)])
def test_decode_equal_to_jax_backend(technique, erased):
    """The port against the JAX plugin on its jax backend."""
    ref, port = _pair(technique)
    obj = RNG.integers(0, 256, 8 * 640, dtype=np.uint8).tobytes()
    chunks = ref.encode(obj)
    avail = {i: c for i, c in chunks.items() if i not in erased}
    got = port.decode(list(erased), avail)
    want = ref.decode(list(erased), avail)
    for i in erased:
        assert np.array_equal(got[i], want[i]), i
        assert np.array_equal(got[i], chunks[i]), i


@pytest.mark.parametrize("want,avail", [
    ([1, 4, 9], [0, 2, 3, 5, 6, 7, 8, 10]),
    ([2], [0, 1, 3, 4, 5, 6, 7, 8, 9]),
    ([8, 10], list(range(8))),
    ([0, 9], [1, 2, 3, 4, 5, 6, 7, 8, 10]),
])
def test_decode_folded_device_equal(want, avail):
    """decode_folded_device: the stacked survivors in, the wanted rows
    out, equal to the JAX codec's folded decode (exact)."""
    ref, port = _pair()
    data = RNG.integers(0, 256, (8, 2048), dtype=np.uint8)
    full = np.concatenate([data, gf256.encode_region(port.matrix, data)])
    stacked = full[avail]
    got = port.decode_folded_device(want, avail, torch.from_numpy(stacked))
    assert isinstance(got, torch.Tensor) and got.device == CPU
    expect = np.asarray(ref.decode_folded_device(want, avail, stacked))
    assert np.array_equal(got.numpy(), expect)
    assert np.array_equal(got.numpy(), full[want])


def test_apply_delta_equal():
    ref, port = _pair()
    data = RNG.integers(0, 256, (8, 256), dtype=np.uint8)
    parity = ref.encode_chunks(data)
    new = data.copy()
    new[3] = RNG.integers(0, 256, 256, dtype=np.uint8)
    delta = port.encode_delta(data[3], new[3])
    assert np.array_equal(delta, ref.encode_delta(data[3], new[3]))
    got = {8 + i: parity[i].copy() for i in range(3)}
    want = {8 + i: parity[i].copy() for i in range(3)}
    port.apply_delta(delta, 3, got)
    ref.apply_delta(delta, 3, want)
    fresh = port.encode_chunks(new)
    for i in range(3):
        assert np.array_equal(got[8 + i], want[8 + i])
        assert np.array_equal(got[8 + i], fresh[i])


def test_kernel_picks_pinned_to_xla_on_cpu():
    """On the CPU the pick is the plain version, pinned, never raced;
    every launch runs the plain version."""
    port = ec.factory("tpu", {"k": "8", "m": "3", "device": "cpu"})
    assert port._backend == "torch" and port.device == CPU
    before = ec_kernels.launch_counts()
    obj = RNG.integers(0, 256, 8 * 4096, dtype=np.uint8).tobytes()
    chunks = port.encode(obj)
    port.decode([0, 9], {i: c for i, c in chunks.items() if i not in (0, 9)})
    picks = port.kernel_picks()
    assert picks and set(picks.values()) == {"xla"}
    after = ec_kernels.launch_counts()
    assert after["plain"] > before["plain"]
    assert after["gf_bitterm"] == before["gf_bitterm"]


@pytest.mark.parametrize("kernel", ["pallas", "bitxor"])
def test_pinned_and_raced_kernels_on_cpu(kernel):
    """A ``kernel`` pin, and a forced race over the hand-written
    candidates' plain versions, give the same bytes."""
    obj = RNG.integers(0, 256, 8 * 512, dtype=np.uint8).tobytes()
    want = ref_ec.factory("tpu", {"k": "8", "m": "3",
                                  "backend": "numpy"}).encode(obj)
    pinned = ec.factory("tpu", {"k": "8", "m": "3", "device": "cpu",
                                "kernel": kernel})
    raced = ec.factory("tpu", {"k": "8", "m": "3", "device": "cpu",
                               "kernel_race": "on"})
    for codec in (pinned, raced):
        got = codec.encode(obj)
        for i in want:
            assert np.array_equal(got[i], want[i])
    assert set(pinned.kernel_picks().values()) == {kernel}
    assert set(raced.kernel_picks().values()) <= {"pallas", "bitxor"}


@pytest.mark.parametrize("times, winner", [
    # the lower median picks pallas (5 < 6) where the mean would not
    ({"pallas": [1e-3, 30e-3, 5e-3], "bitxor": [6e-3, 6e-3, 6e-3]},
     "pallas"),
    # and bitxor (7 < 8) where the least time would not
    ({"pallas": [1e-3, 8e-3, 9e-3], "bitxor": [7e-3, 7e-3, 7e-3]},
     "bitxor"),
])
def test_race_pins_the_lower_median(monkeypatch, times, winner):
    """A forced race on the CPU, with the launch timer stubbed to give
    fixed per-kernel times: each candidate launches once untimed and
    RACE_TIMED_LAUNCHES = 3 times timed, the lower median of the three
    decides the pin, 4 launches a candidate are booked, and the output
    is the JAX ``tpu`` plugin's bytes."""
    from ceph_tpu_torch.utils.perf import kernel_profiler

    codec = ec.factory("tpu", {"k": "8", "m": "3", "device": "cpu",
                               "kernel_race": "on"})
    assert codec.RACE_TIMED_LAUNCHES == 3
    fed = {k: iter(v) for k, v in times.items()}
    real_timed = codec._timed_launch

    def timed(op, rows, sig):
        out, _dt = real_timed(op, rows, sig)
        return out, next(fed[op.kernel])

    monkeypatch.setattr(codec, "_timed_launch", timed)
    booked = []
    prof = kernel_profiler()
    real_note = prof.note_pick

    def note_pick(sig, kernel, **kw):
        booked.append((kernel, kw.get("race_launches")))
        return real_note(sig, kernel, **kw)

    monkeypatch.setattr(prof, "note_pick", note_pick)
    obj = RNG.integers(0, 256, 8 * 512, dtype=np.uint8).tobytes()
    before = ec_kernels.launch_counts()["plain"]
    got = codec.encode(obj)
    assert ec_kernels.launch_counts()["plain"] - before == 8
    assert booked == [(winner, 8)]
    assert all(next(it, None) is None for it in fed.values())
    assert set(codec.kernel_picks().values()) == {winner}
    want = ref_ec.factory("tpu", {"k": "8", "m": "3",
                                  "backend": "jax"}).encode(obj)
    for i in want:
        assert np.array_equal(got[i], want[i]), i


def test_unsupported_pin_books_a_skip():
    codec = ec.factory("tpu", {"k": "8", "m": "3", "device": "cpu",
                               "kernel": "mxu"})
    obj = RNG.integers(0, 256, 8 * 512, dtype=np.uint8).tobytes()
    codec.encode(obj)
    assert set(codec.kernel_picks().values()) == {"xla"}


def test_corpus_chunks_reproduced():
    """The port's codec reproduces the JAX package's archived chunk
    files byte for byte, and decodes the archive."""
    with open(os.path.join(CORPUS, "content"), "rb") as f:
        content = f.read()
    codec = ec.factory("tpu", {"k": "8", "m": "3",
                               "technique": "reed_sol_van",
                               "device": "cpu"})
    chunks = codec.encode(content)
    for i in range(11):
        with open(os.path.join(CORPUS, f"chunk.{i}"), "rb") as f:
            assert chunks[i].tobytes() == f.read(), i
    out = codec.decode([0, 1, 2], {i: c for i, c in chunks.items()
                                   if i > 2})
    for i in range(3):
        assert np.array_equal(out[i], chunks[i])


def test_device_cuda_without_card_raises():
    """The default device is cuda; with no card, construction raises
    instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(ec.ErasureCodeError):
        ec.factory("tpu", {"k": "8", "m": "3"})
    with pytest.raises(ec.ErasureCodeError):
        ec.factory("tpu", {"k": "8", "m": "3", "device": "cuda"})
    with pytest.raises(ec.ErasureCodeError):
        ec.factory("tpu", {"k": "8", "m": "3", "device": "tpu"})


def test_registry_and_profile_errors():
    assert "tpu" in ec.registered()
    with pytest.raises(ec.ErasureCodeError):
        ec.factory("nope", {"device": "cpu"})  # no such plugin
    assert ec.factory("clay", {"device": "cpu"}).alpha == 64  # ported
    with pytest.raises(ec.ErasureCodeError):
        ec.factory("tpu", {"technique": "nope", "device": "cpu"})
    with pytest.raises(ec.ErasureCodeError):
        ec.factory("tpu", {"backend": "jax", "device": "cpu"})
