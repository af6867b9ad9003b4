"""The plain reference against grids worked out by hand."""

import torch

from portbench.reference import heat5


def test_inidat_by_hand():
    # u[ix][iy] = ix*(nx-ix-1)*iy*(ny-iy-1) on a 4x5 grid
    want = torch.tensor([[0, 0, 0, 0, 0],
                         [0, 6, 8, 6, 0],
                         [0, 6, 8, 6, 0],
                         [0, 0, 0, 0, 0]], dtype=torch.float64)
    assert torch.equal(heat5.inidat(4, 5), want)
    u = heat5.inidat(4, 5, torch.float32)
    assert u.dtype == torch.float32 and torch.equal(u.double(), want)


def test_one_step_by_hand():
    # 4x4: the interior is 4 everywhere, the edges 0. One update of
    # (1,1): 4 + 0.1*(4 + 0 - 8) + 0.1*(4 + 0 - 8) = 3.2, the same at the
    # other three interior cells; with cx=0.2, cy=0: 4 + 0.2*(-4) = 3.2
    # too, and with cx=0.25, cy=0.125: 4 - 1 - 0.5 = 2.5.
    grids, done = heat5.solve(4, 4, 1, [0.1, 0.2, 0.25], [0.1, 0.0, 0.125])
    assert done == [1, 1, 1]
    for g, v in zip(grids, (3.2, 3.2, 2.5)):
        want = torch.zeros(4, 4, dtype=torch.float64)
        want[1:3, 1:3] = v
        # the coefficients are the configuration's float32 values
        assert torch.allclose(g, want, rtol=0, atol=1e-6)


def test_two_steps_by_hand():
    # 5x5, cx=cy=0.1: the interior of inidat is [[9,12,9],[12,16,12],
    # [9,12,9]]. The centre after one step: 16 + 0.1*(12+12-32)*2 = 14.4;
    # a corner (1,1): 9 + 0.1*(12+0-18)*2 = 7.8; an edge middle (1,2):
    # 12 + 0.1*(16+0-24) + 0.1*(9+9-24) = 12 - 0.8 - 0.6 = 10.6.
    # The centre after two: 14.4 + 0.1*(10.6+10.6-28.8)*2 = 12.88.
    g1, _ = heat5.solve(5, 5, 1, [0.1], [0.1])
    assert abs(float(g1[0, 2, 2]) - 14.4) < 1e-5
    assert abs(float(g1[0, 1, 1]) - 7.8) < 1e-5
    assert abs(float(g1[0, 1, 2]) - 10.6) < 1e-5
    g2, _ = heat5.solve(5, 5, 2, [0.1], [0.1])
    assert abs(float(g2[0, 2, 2]) - 12.88) < 1e-5
    assert torch.equal(g2[0, 0], torch.zeros(5))


def test_convergence_stops_at_the_first_check_below_sensitivity():
    # a sensitivity above any residual stops every member at the first
    # check; one below every residual runs them to the end
    _, done = heat5.solve(8, 8, 100, [0.1, 0.2], [0.1, 0.05],
                          interval=20, sensitivity=1e30)
    assert done == [20, 20]
    _, done = heat5.solve(8, 8, 100, [0.1, 0.2], [0.1, 0.05],
                          interval=20, sensitivity=0.0)
    assert done == [100, 100]


def test_members_are_independent():
    both, _ = heat5.solve(16, 12, 50, [0.1, 0.2], [0.15, 0.05])
    one, _ = heat5.solve(16, 12, 50, [0.2], [0.05])
    assert torch.equal(both[1], one[0])


def test_grid_gaps_are_shares_of_the_change():
    init = torch.tensor([[0.0, 4.0], [8.0, 0.0]])
    ref = torch.tensor([[0.0, 2.0], [4.0, 0.0]])
    # the change is (0, -2, -4, 0): widest 4, norm sqrt(20)
    got = torch.tensor([[0.0, 2.0], [3.0, 0.0]])
    g = heat5.grid_gaps(got, ref, init)
    assert g["grid_gap"] == 0.25
    assert abs(g["grid_rms_gap"] - 1 / 20 ** 0.5) < 1e-15
    assert heat5.grid_gaps(ref, ref, init) == {"grid_gap": 0.0,
                                               "grid_rms_gap": 0.0}
    # a grid left as it started reads 1 on both
    assert heat5.grid_gaps(init, ref, init) == {"grid_gap": 1.0,
                                                "grid_rms_gap": 1.0}


def test_check_answers_takes_the_widest():
    grids, done = heat5.solve(12, 10, 40, [0.1, 0.2], [0.15, 0.05])
    init = heat5.inidat(12, 10, torch.float32)
    answers = [(0.1, 0.15, grids[0].float(), 40),
               (0.2, 0.05, init, 38)]
    got = heat5.check_answers(answers, 12, 10, 40, block=2)
    assert got["grid_gap"] == 1.0 and got["grid_rms_gap"] == 1.0
    assert got["steps_gap"] == 2.0
