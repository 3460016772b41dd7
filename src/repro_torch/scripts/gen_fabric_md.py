#!/usr/bin/env python
"""Generate docs/torch/FABRIC.md from a live multi-kernel fabric run.

Usage (``tests/test_torch_docs.py`` checks the output is current):
    PYTHONPATH=src python -m repro_torch.scripts.gen_fabric_md > docs/torch/FABRIC.md

The scheduler transcript, contention table, pricing-symmetry check and
fleet-DSE frontier below come from real runs, so the document can never
drift from the code without the test noticing.
"""

import dataclasses
import sys

from repro_torch.core import fabric
from repro_torch.core.fabric import TrafficMix, explore_fleet, fabric_stream, \
    make_fleet, saturating_cycles_per_unit, transaction_cost
from repro_torch.core.host_bridge import AXI4, AXI4_LITE, Crossbar

#: deliberately starved interconnect so the contention table has a
#: genuinely DMA-bound row (device cycles no longer hide the wire)
NARROW8 = Crossbar("narrow8", data_width_bits=8, latency_cycles=8)
from repro_torch.core.machine_model import TPU_V5E
from repro_torch.core.pipeline import compile_gemm


def _fab_and_stream(ck, copies=2, requests=8, crossbar=AXI4,
                    policy="round_robin", name="gemm8"):
    fab = make_fleet({name: (ck.hw_module, ck.kernel)},
                     copies={name: copies}, crossbar=crossbar,
                     policy=policy)
    mix = TrafficMix("steady", ((name, 1.0),), num_requests=requests,
                     process="poisson", rate=1.0, seed=0)
    service = transaction_cost(ck.hw_module, crossbar,
                               ck.cycles.total).total
    mix = dataclasses.replace(mix, cycles_per_unit=saturating_cycles_per_unit(
        mix, service, load_factor=2.0 * copies))
    return fab, fabric_stream(mix), mix


def transcript_section(ck):
    fab, stream, _ = _fab_and_stream(ck, copies=2, requests=5)
    rep = fab.model(stream, overlap=True, transcript=True)
    lines = rep.transcript
    shown = lines[:48]
    out = ["```"]
    out += shown
    if len(lines) > len(shown):
        out.append(f"... ({len(lines) - len(shown)} more events)")
    out += ["```", "", "```", rep.summary(), "```"]
    return out


def contention_table(ck, ck_mxu):
    rows = ["| schedule | crossbar | dispatch | policy | makespan (cyc) | "
            "req/s | xbar util | speedup |",
            "|----------|----------|----------|--------|----------------|"
            "-------|-----------|---------|"]
    cases = [("nested", ck, AXI4), ("nested", ck, AXI4_LITE),
             ("tpu_mxu", ck_mxu, NARROW8)]
    for sched, k, xbar in cases:
        fab, stream, _ = _fab_and_stream(k, copies=3, requests=24,
                                         crossbar=xbar)
        ser = fab.model(stream, overlap=False)
        for label, rep in (
                ("serialized", ser),
                ("overlap", fab.model(stream, overlap=True)),
                ("overlap", dataclasses.replace(fab, policy="priority")
                 .model(stream, overlap=True))):
            rows.append(
                f"| {sched} | {xbar.name} | {label} | {rep.policy} | "
                f"{rep.total_cycles:,} | {rep.requests_per_s:,.0f} | "
                f"{rep.crossbar_utilization:.1%} | "
                f"{rep.requests_per_s / ser.requests_per_s:.2f}x |")
    return rows


def symmetry_section(ck):
    fab, stream, _ = _fab_and_stream(ck, copies=2, requests=8)
    ovl = fab.model(stream, overlap=True)
    sim = fab.simulate(stream, overlap=True)
    dev = (100.0 * abs(sim.requests_per_s - ovl.requests_per_s)
           / ovl.requests_per_s)
    return [
        f"* machine model:    **{ovl.requests_per_s:,.1f} req/s** "
        f"({ovl.total_cycles:,} cycles makespan)",
        f"* event simulator:  **{sim.requests_per_s:,.1f} req/s** "
        f"({sim.total_cycles:,} cycles, outputs checked against the "
        f"numpy oracle, max|err|={sim.max_abs_err:.1e})",
        f"* deviation: **{dev:.2f}%** (gate: ±10%)",
    ]


def fleet_section(ck):
    _, _, mix = _fab_and_stream(ck, copies=2, requests=8)
    res = explore_fleet({"gemm8": ck.graph}, mix, per_kernel=3,
                        max_copies=2, validate_top=2)
    rows = ["| fleet | area | req/s (model) | speedup vs serialized |",
            "|-------|------|---------------|-----------------------|"]
    for c in res.frontier:
        rows.append(f"| `{c.spec()}` | {c.area:,} | {c.model_rps:,.0f} | "
                    f"{c.speedup:.2f}x |")
    rows.append("")
    for v in res.validations:
        rows.append(f"* `{v.candidate.spec()}`: simulated "
                    f"{v.sim_rps:,.0f} req/s vs modeled "
                    f"{v.model_rps:,.0f} — deviation "
                    f"{v.deviation_pct:.2f}% "
                    f"({'ok' if v.ok else 'FAIL'})")
    return rows


def main(out=None) -> int:
    out = out or sys.stdout
    w = lambda s="": print(s, file=out)
    ck = compile_gemm(8, 8, 8, schedule="nested",
                      want_torch=False, want_cuda=False)
    ck_mxu = compile_gemm(8, 8, 8, schedule="tpu_mxu",
                          want_torch=False, want_cuda=False)
    w("# Multi-kernel fabric — contention-aware crossbar scheduling")
    w()
    w("<!-- GENERATED FILE — do not edit by hand. -->")
    w("<!-- Regenerate with:")
    w("       PYTHONPATH=src python -m repro_torch.scripts.gen_fabric_md "
      "> docs/torch/FABRIC.md")
    w("     tests/test_torch_docs.py fails if this file is out of sync. -->")
    w()
    w("`src/repro_torch/core/fabric.py` schedules a *fleet* of generated "
      "accelerators — N")
    w("`HwModule`s, each with its own CSR block and DMA queue — behind "
      "one shared")
    w("vendor crossbar.  A request stream (the `serve/loadgen.py` "
      "arrival processes,")
    w("scaled to device cycles by a `TrafficMix`) is dispatched across "
      "slots; each")
    w("request runs the full host transaction — CSR setup, DMA in, "
      "start, device")
    w("compute, done-polling, DMA out — priced term-for-term like "
      "`host_bridge.run_transaction`.")
    w()
    w("The win is **overlap**: DMA phases contend on the crossbar "
      "(round-robin is")
    w("modeled as processor sharing — n active bursts each progress "
      "1/n beats per")
    w("cycle, the per-beat arbitration limit; `priority` strictly "
      "preempts, lowest")
    w("value first), but one kernel's DMA proceeds while another "
      "computes.  The")
    w("serialized baseline is the same engine with a global "
      "one-transaction lock and")
    w("FIFO admission — exactly back-to-back `run_transaction` calls "
      "(pinned by test:")
    w("a one-slot, one-request fabric prices *identically* to "
      "`run_transaction`).")
    w()
    w("## A scheduled run, live")
    w()
    w("Two copies of the nested-schedule 8×8×8 GEMM behind AXI4, fed a "
      "saturating")
    w("Poisson stream (5 requests shown):")
    w()
    for line in transcript_section(ck):
        w(line)
    w()
    w("## Contention, honestly")
    w()
    w("Three copies, 24 requests, offered load ~2× fleet capacity.  The "
      "nested-schedule")
    w("GEMM is device-bound (≈10k device cycles vs ≈800 DMA beats), so "
      "overlap recovers")
    w("nearly the full slot count on any crossbar.  Swap in the "
      "`tpu_mxu` schedule —")
    w("same bytes, two-orders-of-magnitude fewer device cycles — on a "
      "deliberately")
    w("starved 8-bit crossbar and the fabric becomes DMA-bound: the "
      "crossbar saturates,")
    w("no arbitration policy can beat the shared-wire limit, and the "
      "speedup honestly")
    w("collapses toward 1×:")
    w()
    for row in contention_table(ck, ck_mxu):
        w(row)
    w()
    w("## Pricing symmetry (the PR-9 pattern, one level up)")
    w()
    w("`Fabric.model` and `Fabric.simulate` share ONE scheduling core "
      "(`Fabric._schedule`)")
    w("fed by two device-cycle sources: the analytic "
      "`machine_model.cycles` total, or")
    w("the *observed* cycle count from `hw_sim.simulate` (which also "
      "checks outputs")
    w("against the LoopIR numpy oracle).  Same stream, same fleet:")
    w()
    for line in symmetry_section(ck):
        w(line)
    w()
    w("## Fleet-level DSE")
    w()
    w("`explore_fleet` (also `CompiledKernel.explore_fleet` and "
      "`dse.explore_fleet`)")
    w("crosses each kernel's single-kernel DSE frontier with a copy "
      "count, prices")
    w("every feasible fleet against the traffic mix under a shared "
      "`ResourceBudget`,")
    w("and keeps the requests/s × total-area Pareto frontier; the top "
      "points are")
    w("re-validated by the event simulator (gate: ±10%):")
    w()
    for row in fleet_section(ck):
        w(row)
    w()
    w("`benchmarks/fabric_bench.py` records the full trajectory "
      "(`BENCH_fabric.json`,")
    w("schema `fabric_bench/v1`): ≥2 traffic mixes × ≥2 fleet configs, "
      "each overlap")
    w("schedule ≥1.3× its serialized baseline, every frontier point "
      "sim-validated.")
    w("`scripts/check_bench.py` (`make bench-check`) gates all "
      "committed BENCH files;")
    w("CI's `fabric-smoke` job byte-diffs two smoke runs and asserts "
      "the speedup floor.")

    return 0


if __name__ == "__main__":
    sys.exit(main())
