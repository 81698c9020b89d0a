"""The port's simulated platforms (``serverless://aws-sim``, ``hpc://*-sim``)
and the pilot API's hooks against the reference's: the same seeded
workload through both packages must give the same unit traces — service
times, cold starts, the concurrency cap, walltime kills, OOMs, crashes,
preemptions and batch-queue waits — bit for bit."""

import numpy as np
import pytest

from repro.pilot import api as ref_api
from repro.pilot.backends import hpcsim as ref_hpc
from repro.pilot.backends import serverless as ref_sls
from repro_torch.pilot import api as port_api
from repro_torch.pilot.backends import hpcsim as port_hpc
from repro_torch.pilot.backends import serverless as port_sls

PKGS = {"ref": (ref_api, ref_sls, ref_hpc), "port": (port_api, port_sls, port_hpc)}


def _both(scenario, *args):
    return {name: scenario(*mods, *args) for name, mods in PKGS.items()}


def _unit_trace(pilot) -> list:
    return [(cu.uid, cu.state.value, cu.submit_ts, cu.start_ts, cu.end_ts,
             dict(cu.attrs), type(cu.exception).__name__ if cu.exception else None,
             str(cu.exception) if cu.exception else None)
            for cu in pilot.compute_units]


def _profiles(api, seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [api.TaskProfile(flops=float(rng.uniform(1e8, 5e10)),
                            serial_flops=float(rng.uniform(0, 1e9)),
                            read_bytes=float(rng.uniform(0, 4e5)),
                            write_bytes=float(rng.uniform(0, 4e5)),
                            msg_bytes=float(rng.uniform(1e4, 6e5)),
                            coherence_peers=int(rng.integers(0, 8)),
                            memory_mb=float(rng.uniform(64, 600)))
            for _ in range(n)]


@pytest.mark.parametrize("memory_mb", [512, 1792, 3008, 10240])
def test_serverless_service_time_model_matches(memory_mb):
    def scenario(api, sls, _hpc):
        cfg = dict(sls.DEFAULTS)
        return [sls.service_time_mean(cfg, memory_mb, p, cold)
                for p in _profiles(api, 1, 16) for cold in (False, True)]

    got = _both(scenario)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("partitions,concurrency", [(4, None), (40, None), (8, 3)])
def test_serverless_units_cold_starts_and_cap_match(partitions, concurrency):
    def scenario(api, _sls, _hpc):
        pcs = api.PilotComputeService(seed=5)
        pilot = pcs.submit_pilot(api.PilotDescription(
            resource="serverless://aws-sim", partitions=partitions,
            concurrency=concurrency, memory_mb=1024))
        sim = pilot.backend.sim
        for i, prof in enumerate(_profiles(api, 2, 60)):
            sim.schedule_fast(0.05 * (i % 7), lambda p=prof, i=i: pilot.submit_compute_unit(
                profile=p, partition=i % partitions))
        sim.run()
        busy = max(sum(1 for cu in pilot.compute_units
                       if cu.start_ts <= t < cu.end_ts)
                   for t in [cu.start_ts for cu in pilot.compute_units])
        containers = {cu.attrs["container"] for cu in pilot.compute_units}
        cold = sum(cu.attrs["cold"] for cu in pilot.compute_units)
        out = _unit_trace(pilot), sim.now, sim.events_processed, busy, len(containers), cold
        pcs.close()
        return out

    got = _both(scenario)
    assert got["port"] == got["ref"]
    _, _, _, busy, n_containers, cold = got["port"]
    cap = min(concurrency or partitions, 30)
    assert busy <= cap and n_containers == cap == cold


def test_serverless_walltime_kill_and_oom_match():
    def scenario(api, _sls, _hpc):
        pcs = api.PilotComputeService(seed=0)
        pilot = pcs.submit_pilot(api.PilotDescription(
            resource="serverless://aws-sim", partitions=2, memory_mb=512,
            walltime_s=30.0))
        pilot.submit_compute_unit(profile=api.TaskProfile(flops=1e12))       # > walltime
        pilot.submit_compute_unit(profile=api.TaskProfile(memory_mb=4096))   # > container
        pilot.submit_compute_unit(profile=api.TaskProfile(flops=1e9),
                                  func=lambda: "ran")
        pilot.submit_compute_unit(profile=api.TaskProfile(flops=1e9),
                                  func=lambda: 1 / 0)
        pilot.wait_all()
        out = _unit_trace(pilot), [cu.result_value for cu in pilot.compute_units]
        pcs.close()
        return out

    got = _both(scenario)
    assert got["port"] == got["ref"]
    errors = [row[6] for row in got["port"][0]]
    assert errors == ["TimeoutError", "MemoryError", None, "ZeroDivisionError"]
    assert got["port"][1][2] == "ran"


def test_serverless_crash_preempt_and_elasticity_match():
    def scenario(api, _sls, _hpc):
        pcs = api.PilotComputeService(seed=4)
        pilot = pcs.submit_pilot(api.PilotDescription(
            resource="serverless://aws-sim", partitions=6))
        backend, sim = pilot.backend, pilot.backend.sim
        for prof in _profiles(api, 3, 30):
            pilot.submit_compute_unit(profile=prof)
        log = []
        sim.schedule_fast(2.0, lambda: log.append(("crash", backend.inject_crash(pilot, 2))))
        sim.schedule_fast(3.0, lambda: log.append(("preempt", backend.preempt(pilot, 3),
                                                   backend.effective_allocation(pilot))))
        sim.schedule_fast(4.0, lambda: log.append(("scale", backend.scale_to(pilot, 40),
                                                   backend.allocation(pilot))))
        sim.schedule_fast(9.0, lambda: log.append(("shrink", backend.scale_to(pilot, 2),
                                                   backend.effective_allocation(pilot))))
        pilot.wait_all()
        sim.run()
        log.append(("end", backend.allocation(pilot), backend.effective_allocation(pilot)))
        out = _unit_trace(pilot), log, sim.now
        pcs.close()
        return out

    got = _both(scenario)
    assert got["port"] == got["ref"]
    assert ("scale", 30, 30) in got["port"][1]


@pytest.mark.parametrize("machine", ["wrangler", "stampede2"])
@pytest.mark.parametrize("workers", [1, 4])
def test_hpc_units_shared_fs_and_model_lock_match(machine, workers):
    def scenario(api, _sls, _hpc):
        pcs = api.PilotComputeService(seed=8)
        pilot = pcs.submit_pilot(api.PilotDescription(
            resource=f"hpc://{machine}-sim", partitions=workers))
        sim = pilot.backend.sim
        for i, prof in enumerate(_profiles(api, 6, 40)):
            pilot.submit_compute_unit(profile=prof,
                                      partition=None if i % 5 == 0 else i % workers)
        pilot.wait_all()
        fs = pilot.backend.shared_resource(pilot, "fs")
        lock = pilot.backend.shared_resource(pilot, "model_lock")
        out = (_unit_trace(pilot), sim.now, sim.events_processed, fs.capacity,
               fs.active_flows, lock.queue_len)
        pcs.close()
        return out

    got = _both(scenario)
    assert got["port"] == got["ref"]
    assert all(row[1] == "done" for row in got["port"][0])


def test_hpc_kill_worker_crash_preempt_and_grants_match():
    def scenario(api, _sls, _hpc):
        pcs = api.PilotComputeService(seed=2)
        pilot = pcs.submit_pilot(api.PilotDescription(
            resource="hpc://wrangler-sim", partitions=4,
            attrs=dict(queue_wait_p50_s=5.0, queue_wait_p95_s=40.0)))
        backend, sim = pilot.backend, pilot.backend.sim
        for i, prof in enumerate(_profiles(api, 9, 36)):
            pilot.submit_compute_unit(profile=prof, partition=i % 4 if i % 3 else None)
        log = []
        sim.schedule_fast(1.0, lambda: log.append(
            ("kill", [cu.uid for cu in backend.kill_worker(pilot, 1)])))
        sim.schedule_fast(2.0, lambda: log.append(("crash", backend.inject_crash(pilot, 1))))
        sim.schedule_fast(3.0, lambda: log.append(("preempt", backend.preempt(pilot, 1),
                                                   backend.effective_allocation(pilot))))
        sim.schedule_fast(4.0, lambda: log.append(("grow", backend.scale_to(pilot, 7),
                                                   backend.effective_allocation(pilot))))
        sim.schedule_fast(30.0, lambda: log.append(("shrink", backend.scale_to(pilot, 3),
                                                    backend.effective_allocation(pilot))))
        pilot.wait_all()
        sim.run()
        log.append(("end", backend.allocation(pilot), backend.effective_allocation(pilot)))
        out = _unit_trace(pilot), log, sim.now
        pcs.close()
        return out

    got = _both(scenario)
    assert got["port"] == got["ref"]
    errors = {row[6] for row in got["port"][0]}
    assert "ConnectionError" in errors


@pytest.mark.parametrize("attrs", [{}, dict(queue_wait_p50_s=5.0, queue_wait_p95_s=40.0),
                                   dict(queue_wait_p50_s=5.0, queue_wait_p95_s=5.0),
                                   dict(grant_delay_s=3.0)])
def test_hpc_queue_wait_samples_match(attrs):
    def scenario(_api, _sls, hpc):
        cfg = dict(hpc.DEFAULTS, **hpc.MACHINES["wrangler"], **attrs)
        rng = np.random.default_rng([7, 0])
        samples = [hpc.queue_wait_sample(cfg, rng) for _ in range(200)]
        terms = hpc.coupling_terms(cfg, _api.TaskProfile(
            flops=3e9, serial_flops=2e9, read_bytes=1e5, write_bytes=2e5,
            msg_bytes=6e5, coherence_peers=5))
        return samples, terms

    got = {name: scenario(*mods) for name, mods in PKGS.items()}
    assert got["port"] == got["ref"]


def test_pilot_hooks_and_callbacks():
    """Callbacks fire once, at once on a final unit; cancel marks pending
    units; static backends refuse elasticity; unknown machines raise."""
    api = port_api
    pcs = api.PilotComputeService(seed=1)
    pilot = pcs.submit_pilot(api.PilotDescription(resource="serverless://aws-sim",
                                                  partitions=1))
    fired = []
    first = pilot.submit_compute_unit(profile=api.TaskProfile(flops=1e9))
    second = pilot.submit_compute_unit(profile=api.TaskProfile(flops=1e9))
    first.add_done_callback(lambda cu: fired.append(("first", cu.state)))
    first.wait()
    first.add_done_callback(lambda cu: fired.append(("late", cu.state)))
    pilot.cancel()
    second.add_done_callback(lambda cu: fired.append(("second", cu.state)))
    assert fired == [("first", api.State.DONE), ("late", api.State.DONE),
                     ("second", api.State.CANCELED)]
    assert pilot.state is api.State.CANCELED and second.end_ts == first.end_ts
    with pytest.raises(RuntimeError, match="canceled"):
        second.result()
    with pytest.raises(LookupError):
        pilot.backend.shared_resource(pilot, "fs")
    base = api.Backend()
    with pytest.raises(NotImplementedError):
        base.scale_to(pilot, 2)
    assert base.inject_crash(pilot) == 0 and base.preempt(pilot) == 0
    with pytest.raises(ValueError, match="unknown HPC machine"):
        pcs.submit_pilot(api.PilotDescription(resource="hpc://frontier-sim"))
    pcs.close()
