"""The traffic generators: inputs from the seed alone."""

import shutil
import struct
import zlib

import numpy as np
import pytest

from portbench.lib import cells
from portbench.lib import traffic as gen

PAIR_MIXES = ("blob_pairs32", "blob_pairs8")
SEQUENCE_MIXES = ("snoopy_png", "snoopy_memory")


def _mix(name):
    import json

    with open(cells.HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("name", PAIR_MIXES + SEQUENCE_MIXES)
def test_same_seed_same_inputs(name):
    a, b = gen.generate(_mix(name), 2**31 + 17), gen.generate(_mix(name), 2**31 + 17)
    for x, y in zip(a, b):
        for u, v in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,)):
            assert np.array_equal(u, v)


@pytest.mark.parametrize("name", PAIR_MIXES + SEQUENCE_MIXES)
def test_other_seed_other_inputs(name):
    a, b = gen.generate(_mix(name), 5), gen.generate(_mix(name), 6)
    first = [x.live if hasattr(x, "live") else x for x in a]
    second = [x.live if hasattr(x, "live") else x for x in b]
    assert any(not np.array_equal(u, v) for u, v in zip(first, second))


@pytest.mark.parametrize("name", PAIR_MIXES)
def test_pairs_every_seed_the_same_work(name):
    """Seeds change the order of the pairs, not the pairs."""
    def work(seed):
        return sorted((p.shift_px, p.angle, p.height_scale) for p in gen.generate(_mix(name), seed))

    mix = _mix(name)
    assert work(1) == work(2**33 + 5)
    shifts = sorted(s for s, _, _ in work(1))
    assert shifts[0] == mix["shift_px"][0] and shifts[-1] == mix["shift_px"][1]
    assert len(set(work(1))) == mix["pool"]


@pytest.mark.parametrize("reshuffle", [False, True])
def test_rounds_send_each_entry_once_a_round(reshuffle):
    order = gen.Rounds(8, 2**31 + 3, reshuffle)
    rounds = [[order(8 * r + k) for k in range(8)] for r in range(6)]
    assert all(sorted(r) == list(range(8)) for r in rounds)
    assert (len({tuple(r) for r in rounds}) > 1) == reshuffle
    again = gen.Rounds(8, 2**31 + 3, reshuffle)
    assert [again(i) for i in range(48)] == sum(rounds, [])


@pytest.mark.parametrize("name", PAIR_MIXES)
def test_pair_mixes_reshuffle_each_round(name):
    mix = _mix(name)
    order = gen.rounds(mix, 5, mix["pool"])
    first = [order(k) for k in range(mix["pool"])]
    second = [order(mix["pool"] + k) for k in range(mix["pool"])]
    assert sorted(first) == sorted(second) and first != second


def test_sequence_period_and_travel():
    mix = _mix("snoopy_png")
    offset = gen.generator(mix["generator"]).offset
    offsets = [offset(t, mix) for t in range(2 * mix["period"])]
    assert offsets[:mix["period"]] == offsets[mix["period"]:]
    assert min(offsets) == -mix["travel_px"] / 2 and max(offsets) == mix["travel_px"] / 2
    steps = np.abs(np.diff(offsets))
    assert np.allclose(steps, mix["step_px"])
    frames = gen.generate(mix, 3)
    assert len(frames) == mix["period"] and frames[0].dtype == np.uint16
    assert frames[0].shape == (mix["camera"]["height"], mix["camera"]["width"])


def test_every_mix_names_a_generator_file():
    for path in sorted((cells.HERE / "traffic").glob("*.json")):
        mix = _mix(path.stem)
        assert (cells.HERE / "traffic" / f"{mix['generator']}.py").exists(), path.name
        assert hasattr(gen.generator(mix["generator"]), "generate")


def test_a_new_generator_needs_only_its_file(tmp_path, monkeypatch):
    """A generator file beside the mixes is found by the name in a mix,
    with nothing else edited."""
    shutil.copytree(cells.HERE, tmp_path / cells.HERE.name)
    (tmp_path / cells.HERE.name / "traffic" / "constant_pairs.py").write_text(
        "import numpy as np\n\n\n"
        "def generate(mix, seed):\n"
        "    return [np.full((2, 2), mix['depth'], np.float32)] * mix['pool']\n")
    monkeypatch.setattr(cells, "HERE", tmp_path / cells.HERE.name)
    out = gen.generate({"generator": "constant_pairs", "depth": 0.5, "pool": 3}, 1)
    assert len(out) == 3 and float(out[0][0, 0]) == 0.5


def _decode_png16(data: bytes) -> np.ndarray:
    pos, idat, shape = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        assert zlib.crc32(kind + body) & 0xFFFFFFFF == struct.unpack(
            ">I", data[pos + 8 + n:pos + 12 + n])[0]
        if kind == b"IHDR":
            w, h, depth, colour = struct.unpack(">IIBB", body[:10])
            assert (depth, colour) == (16, 0)
            shape = (h, w)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(shape[0], -1)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].copy().view(">u2").astype(np.uint16)


def test_png_round_trip(tmp_path):
    mix = _mix("snoopy_png")
    frames = gen.generate(mix, 9)[:3]
    paths = gen.write_sequence(str(tmp_path), frames, gen.camera(mix["camera"]))
    for raw, path in zip(frames, paths):
        with open(path, "rb") as f:
            assert np.array_equal(_decode_png16(f.read()), raw)
    assert (tmp_path / "intrinsics.json").exists()


def test_metres_match_the_depth_reader():
    raw = np.array([[0, 1, 400, 65535]], np.uint16)
    got = gen.metres(raw, 0.001)
    assert got.dtype == np.float32
    assert np.array_equal(got, raw.astype(np.float32) * np.float32(0.001))
