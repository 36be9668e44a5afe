"""The inputs of each kind of traffic are determined by --seed: the same seed, the same
rays, target, uniforms and checked calls; another seed, others."""

from __future__ import annotations

import torch

from portbench.harness import mix_seed
from portbench.traffic.common import Streams, grid_rays, sampled

from conftest import SMALL_RAYS


def test_mix_seed_is_stable_and_spreads():
    assert mix_seed(3, 1, 2) == mix_seed(3, 1, 2)
    assert mix_seed(3, 1, 2) != mix_seed(3, 2, 1)
    big = 2 ** 31 + 12345
    assert 0 <= mix_seed(big, -1) < 2 ** 63


def test_streams_repeat_by_key():
    a, b = Streams(2 ** 31 + 7, "cpu"), Streams(2 ** 31 + 7, "cpu")
    ua = a.bounce_u(4)(0, 3, 8)
    assert torch.equal(ua, b.bounce_u(4)(0, 3, 8))
    assert ua.shape == (3, 8, 10)
    assert not torch.equal(ua, a.bounce_u(5)(0, 3, 8))
    assert not torch.equal(ua, Streams(8, "cpu").bounce_u(4)(0, 3, 8))
    assert torch.equal(a.rand((2, 5), 1, 2), b.rand((2, 5), 1, 2))


def test_grid_rays_and_sampled_indices():
    o1, d1 = grid_rays(SMALL_RAYS, "cpu")
    o2, d2 = grid_rays(SMALL_RAYS, "cpu")
    assert torch.equal(o1, o2) and torch.equal(d1, d2)
    assert torch.allclose(d1.norm(dim=1), torch.ones(256))
    s = sampled(99, 2, 40, 17)
    assert s == sampled(99, 2, 40, 17) and s[0] == 0 and len(s) == 3
    assert all(1 <= k < 40 for k in s[1:])


def test_fit_target_and_observe_streams_follow_the_seed():
    from portbench.run import Context, make_traffic
    from conftest import SMALL
    t = []
    for seed in (11, 11, 12):
        ctx = Context("cornell_box.fit", seed, device="cpu",
                      overrides=SMALL["cornell_box.fit"])
        drv = make_traffic(ctx)
        g = torch.Generator().manual_seed(drv.streams.seed)
        t.append(torch.rand((4, 15), generator=g))
        assert drv.streams.seed == seed
    assert torch.equal(t[0], t[1]) and not torch.equal(t[0], t[2])
    ctx = Context("cornell_box.observe", 11, device="cpu",
                  overrides=SMALL["cornell_box.observe"])
    obs = make_traffic(ctx)
    assert obs.pass_seed(3) == make_traffic(ctx).pass_seed(3)
    assert obs.pass_seed(3) != obs.pass_seed(4)
