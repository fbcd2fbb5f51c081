"""Port host-side core vs the reference (clock, clones, dispatch, scheduler,
policy, venues, energy).

The scheduling modules are copies of the reference's, so the same sequence
of operations must give the same observable state in both packages; the
device-specific pieces (venues, energy, the GPU clone ladder) are checked
for their own contracts.
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.core import clones as jclones
from repro.core import scheduler as jsched
from repro.core import venues as jvenues
from repro.core.clock import VirtualClock as JClock
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.core import clones, energy, policy, scheduler, venues
from repro_torch.core.clock import VirtualClock
from repro_torch.core.dispatch import Dispatcher


def test_virtual_clock_orders_and_cancels_events():
    clock = VirtualClock()
    fired = []
    clock.schedule(2.0, lambda: fired.append("b"))
    ev = clock.schedule(1.5, lambda: fired.append("x"))
    clock.schedule(1.0, lambda: fired.append("a"))
    ev.cancel()
    clock.advance_to(3.0)
    assert fired == ["a", "b"] and clock.now() == 3.0
    with pytest.raises(ValueError):
        clock.advance_to(1.0)


def test_dispatcher_overlap_is_max_not_sum():
    clock = VirtualClock()
    pool = clones.ClonePool(clock=clock)
    disp = Dispatcher(pool, clock)
    times = iter([1.0, 2.0, 3.0])
    tasks = [disp.submit(pool.primary, lambda v=i: v, (),
                         executor=lambda c, f, a: (f(*a), next(times)))
             for i in range(3)]
    disp.wait(tasks)
    assert clock.now() == pytest.approx(3.0)
    assert [t.value for t in tasks] == [0, 1, 2]


def _drive_pool(mod, clock):
    pool = mod.ClonePool(clock=clock)
    pool.provision("main", 3)
    got, cost = pool.acquire("main", n=2, exclude_primary=True)
    pool.release(got)
    clock.advance_to(40.0)
    pool.reap_idle()
    fresh, costs = pool.ensure_secondaries("large", 2)
    return (cost, dict(pool.stats), [c.state.value for c in pool.clones],
            costs, pool.clone_seconds_by_type(50.0))


def test_clone_pool_lifecycle_matches_reference():
    assert _drive_pool(clones, VirtualClock()) == _drive_pool(jclones,
                                                              JClock())


def _drive_scheduler(mod, clones_mod, clock):
    pool = clones_mod.ClonePool(clock=clock)
    pe = mod.PlacementEngine(pool, fleet=["basic", "main", "large"])
    auto = mod.FleetAutoscaler(pool, pe, max_secondaries=4)
    out = [pe.choose_type("main"), pe.choose_type("basic", urgent=True),
           pe.required_type("basic", 5, lambda t: {"basic": 2, "main": 4,
                                                    "large": 8}[t])]
    out.append(auto.step(0.0, [("main", False, 3), ("large", True, 1)]))
    q = mod.AdmissionQueue(2)
    reqs = mod.poisson_arrivals(4.0, 3, seed=3, vocab=64)
    out.append([q.offer(r, 0.0) for r in reqs])
    led = mod.SlotLedger()
    led.update("a", 2)
    led.update("b", 1)
    out.append([(k, r.rid) for k, r in led.assign(q)])
    out.append(mod.SlotLedger.pick_victim([(0, 0, 5), (1, 0, 2), (2, 1, 0)]))
    out.append([r.arrival_t for r in reqs])
    return out


def test_scheduler_matches_reference():
    assert _drive_scheduler(scheduler, clones, VirtualClock()) == \
        _drive_scheduler(jsched, jclones, JClock())


def test_placement_key_orders_by_policy():
    fast = policy.Prediction(time_s=0.1, energy_j=50.0, cost_usd=2.0)
    cheap = policy.Prediction(time_s=5.0, energy_j=10.0, cost_usd=0.1)
    key = policy.placement_key
    assert key(policy.Policy.EXEC_TIME, fast) < key(policy.Policy.EXEC_TIME,
                                                    cheap)
    assert key(policy.Policy.NONE, cheap) < key(policy.Policy.NONE, fast)


def test_gpu_clone_ladder_and_energy():
    assert set(clones.GPU_BY_CLONE_TYPE) == set(clones.CLONE_TYPES)
    assert [clones.chips_for(t, gpu=True) for t in
            ("basic", "main", "large", "x2large", "x4large", "x8large")] == \
        [1, 4, 16, 64, 256, 512]
    assert clones.KV_SCALE_BY_CLONE_TYPE == jclones.KV_SCALE_BY_CLONE_TYPE
    pool = clones.ClonePool(gpu=True)
    spec = pool.primary.spec
    assert spec.name == "gpu-4" and spec.chips == 4
    assert spec.eff_flops == pytest.approx(4 * 0.4 * venues.PEAK_FLOPS_BF16)
    m = energy.GpuEnergyModel()
    assert m.busy_j(chips=8, seconds=1.0) - m.busy_j(chips=1, seconds=1.0) \
        == pytest.approx(7 * m.c.chip_peak_w)


def test_venue_times_on_device_and_scales():
    spec = venues.make_cloud_vm("main", 1, 512, 100,
                                venues.LINKS["wifi-local"])
    v = venues.Venue(spec, "cpu")
    calls = []
    out, secs = v.execute(lambda x: calls.append(x) or x + 1, 1)
    assert out == 2 and secs > 0 and len(calls) in (2, 3)
    assert venues.host_eff_flops("cpu") > 0
    assert venues.transfer_time(6.75e6, venues.LINKS["wifi-local"]) == \
        pytest.approx(1.005)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2.5-3b"])
def test_kv_and_tree_bytes_match_reference(arch):
    cfg, tcfg = reduced_config(get_config(arch)), t_reduced_config(
        t_get_config(arch))
    for q in (False, True):
        assert venues.kv_block_bytes(tcfg, 8, quantized=q) == \
            jvenues.kv_block_bytes(cfg, 8, quantized=q)
    tree = {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
            "b": [np.zeros((2,), np.int8), torch.zeros(5)]}
    assert venues.pytree_bytes(tree) == 24 + 2 + 20 + 3 * 64
