"""The fixed work count against hand counts."""

import bench_cells as bc
import work


def test_diode_clipper_by_hand():
    # the diode clipper: nx 1, nu 1, ny 1, one subsystem nn 2, np 1, nq 4,
    # two diodes.  State and output rows: (1 + 1) x (1 + 1 + 2) = 8
    # multiply-adds; p map 1 x (1 + 1) = 2; q map 4 x (1 + 2) = 12:
    # 22 multiply-adds, 44 FLOPs; LU of 2x2: 2/3 8 + 2 4 = 13 1/3;
    # two diodes 2 x 6 = 12.
    dims = {"nx": 1, "nu": 1, "ny": 1, "nn": [2], "np": [1], "nq": [4]}
    assert abs(work.flops_per_lane_sample(dims, {"diode": 2})
               - (44 + 40 / 3 + 12)) < 1e-12


def test_superover_counts():
    # chain: (11 + 1) x 25 = 300; p maps 2 x 14, 2 x 16, 2 x 21, 2 x 23 =
    # 148; q maps 4 x 4, 11 x 7, 5 x 4, 4 x 4 = 129: 577 multiply-adds;
    # LU 2x2 (x3) 40 + 5x5 400/3; 2 bjt + 3 diodes + 2 pots = 74
    cfg = bc.load("pots_sweep")[2]
    got = work.flops_per_lane_sample(cfg["dims"], cfg["nonlinear_elements"])
    assert abs(got - (2 * 577 + 40 + 400 / 3 + 74)) < 1e-9
    # full: 12 x 19 = 228; p 5 x 12 = 60; q 14 x 12 = 168; LU 7x7
    # 686/3 + 98; 2 bjt + 3 diodes = 58
    cfg = bc.load("full_level")[2]
    got = work.flops_per_lane_sample(cfg["dims"], cfg["nonlinear_elements"])
    assert abs(got - (2 * 456 + 686 / 3 + 98 + 58)) < 1e-9


def test_block_bytes():
    dims = {"nx": 11, "nu": 3, "ny": 1, "nn": [2, 5, 2, 2]}
    # input 4096 x 1, lanes 8 x 2, state 2 x 8 x 22, y 8 x 4096
    assert work.block_bytes(dims, 8, 4096, 2, 1) == \
        4 * (4096 + 16 + 352 + 8 * 4096)


def test_peaks_table():
    p = work.peaks("NVIDIA H100 80GB HBM3")
    assert p["float32_flops"] == 67e12 and p["hbm_bytes_per_s"] == 3.35e12
    assert work.peaks("no such card") is None
