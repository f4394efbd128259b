"""The traffic generator: deterministic per seed, different between
seeds, the same work for every seed."""

import numpy as np

import bench_cells as bc
import gen

STREAM = bc.load("full_level")[3]["stream"]
BIG = 2 ** 31 + 12345          # seeds above 32 signed bits


def test_lane_values_per_seed():
    spec = {"axes": [[0.05, 0.95, 8], [0.05, 0.95, 4]], "jitter": True}
    a, b = gen.lane_values(spec, BIG), gen.lane_values(spec, BIG)
    c = gen.lane_values(spec, BIG + 1)
    assert a.shape == (32, 2)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-3
    # each lane inside its own cell: drive varies slowest
    w = 0.9 / np.array([8, 4])
    cell = np.floor((a - 0.05) / w)
    np.testing.assert_array_equal(cell[:, 0], np.repeat(np.arange(8), 4))
    np.testing.assert_array_equal(cell[:, 1], np.tile(np.arange(4), 8))


def test_lane_values_without_jitter_are_cell_centres():
    spec = {"axes": [[0.1, 2.0, 4]], "jitter": False}
    np.testing.assert_allclose(gen.lane_values(spec, 1)[:, 0],
                               0.1 + (np.arange(4) + 0.5) * 1.9 / 4)


def test_check_lanes_per_seed():
    a, b = gen.check_lanes(8192, 32, 7), gen.check_lanes(8192, 32, 7)
    np.testing.assert_array_equal(a, b)
    assert len(set(a.tolist())) == 32 and a.max() < 8192
    assert set(gen.check_lanes(8192, 32, 8).tolist()) != set(a.tolist())


def test_stream_per_seed_and_block_boundaries():
    s1 = gen.Stream(STREAM, BIG, 44100)
    s2 = gen.Stream(STREAM, BIG, 44100)
    s3 = gen.Stream(STREAM, BIG + 1, 44100)
    whole = s1.block(40000, 9000)
    parts = np.concatenate([s2.block(40000, 4096), s2.block(44096, 4904)])
    np.testing.assert_array_equal(whole, parts)
    assert np.abs(whole - s3.block(40000, 9000)).max() > 1e-3
    assert np.all(np.isfinite(whole)) and np.abs(whole).max() <= 0.5


def test_every_seed_gets_the_same_notes():
    """Each second holds the same onsets, pitches, decays and peaks for
    every seed, and other harmonics' phases."""
    a = gen.Stream(STREAM, 3, 44100)._second(5)
    b = gen.Stream(STREAM, 4, 44100)._second(5)
    for x, y in zip(a[:4], b[:4]):
        np.testing.assert_array_equal(x, y)
    assert np.abs(a[4] - b[4]).max() > 1e-3
    assert a[0][0] == 5.0 and np.all(np.diff(a[0]) > 0)
    # another second, another set
    assert not np.array_equal(np.sort(a[3]),
                              np.sort(gen.Stream(STREAM, 3, 44100)._second(6)[3]))
