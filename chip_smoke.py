#!/usr/bin/env python3
"""Chip smoke test of consul_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits
non-zero before the result line):

1. env      — the card, the device count, its name and power limit from
              nvidia-smi; builds the CUDA kernels from
              consul_tpu_torch/csrc (round_kernels.cu, prng_kernels.cu,
              sum_kernels.cu, lane_kernels.cu, coord_kernels.cu: one
              nvcc each, in parallel) and prints, per kernel
              instantiation, ptxas's registers, stack frame and spills
              (a spill, or a stack frame in a draw, sum, lane or
              coordinate kernel or a live stage, fails the run), its
              static SASS instruction count
              (cuobjdump -sass on the built library) and, for the round
              kernels, the nodes each thread takes.
2. check    — at 1,048,576 nodes, on a state warmed by the plain path:
              one round_kernel launch in the stable and the full
              variant, one churn-config launch, one full-variant launch
              with corroboration_k=1, one fault-variant launch on a
              frame of an all-primitive honest plan, one byz-variant
              launch on a frame of the four byzantine primitives with
              corroboration_k=2 (both on the chaos suite's config, and
              again on the full one), the byz-variant launch once more
              on that round read in place (the plan's phase rows at the
              device phase, as the kernel runner hands it over on the
              card), and one R=8 and one R=4
              mega_kernel launch per honest variant, each held against
              its plain PyTorch version on the same inputs (int lanes
              exact — at most 2 nodes may differ, each only where a
              decision's margin is under 4 ulp; informed within 4 ulp;
              partial sums, on every block that holds no such node:
              counter lanes exact, scalar lanes within 1e-5 relative +
              1e-4).
3. lanes    — the lane kernel (lane_round, sim/lane_kernel.py): ATen's
              rule for a CUDA tensor divided by a Python number (a
              product with the f32 reciprocal; the kernel packs those
              reciprocals), then, on the check's warmed state at
              1,048,576 nodes, one lane_round launch per case of
              ``lane_cases`` (stable, full, churn, an honest and a
              byzantine frame on the chaos and the full configs,
              corroboration_k=1, a shard offset, window rounds j >= 1
              with and without stats, mid-window and last) through the
              lane engine's call, and a 2-round window on each grid of
              ``lane_grids`` at 65,536 nodes a point (the lan autotune
              grid's 64 points; two 16-point grids that sweep every
              kind of constant, on the check plans' frames), each bit
              for bit the plain body on the same state, scalars, keys
              and frames inside ``fused.plain()``: the 8 lanes and the
              32 stack rows, one launch a round.
4. headline — the main path through the user entry points
              (consul_tpu_torch.bench.run_headline: per-round and R=8
              runners on the stable and full configs, best of 3), its
              launch counters zeroed just before and read just after
              (the round kernels, and the threefry kernel's seeds mode:
              the runners' round seeds, one launch a call);
              then a 262,144-node, 60-round crash-detection check,
              counted on its own (exactly 60 stable round launches).
              The full-model diagnostic must show no false positive
              and suspicions and refutes per node-round within
              0.85-1.15x of the port's first measurement (``FD_REF``).
5. chaos    — the fault-plan path through its entry point
              (consul_tpu_torch.bench.run_chaos_suite: the nine chaos
              classes of sim/scenarios.py at 1,048,576 nodes, each run
              twice: an untimed warm-up, then the timed run), counted
              on its own: every round of an honest class is a fault
              launch, of a byzantine class a byz launch. Each class's
              detection signature is asserted (see ``class_failures``).
6. observe  — the recorders through the kernel runner, each run counted
              on its own: at 1,048,576 nodes on the full-model config,
              200 per-round rounds with the flight recorder at stride 10
              and the black box (64 agents, ring 256), then 240 R=8
              rounds at stride 40 (column sums equal the stats delta
              exactly, the last row's gauges are ``flight_row`` of the
              final state; exactly 200 full round launches and 30 full
              megakernel launches); every node of 65,536 tracked at
              stride 1 through ``run_chaos`` on the flapping and eclipse
              classes (1% loss: the ring totals must equal the flight
              counters); and 120 rounds at 1,048,576 nodes with Vivaldi
              coordinates (stride 10; the last median RTT error under
              the reference's 0.3 and below the first; exactly a
              coord_probe and a vivaldi_relax launch a round and a
              coord_quality launch a recorded round); 16 periods of the
              coordinates cell's path at 1,048,576 agents
              (run_rounds_flight on scenarios.coords_setup, deadlines
              and the partition plan on, stride 4) with the same exact
              coordinate launches, against its plain route on the card
              (coordinate columns within 1e-6, the rest and the state
              equal); each run's launches counted from zero; the device
              µs of a coordinate round's parts: draws, ``vivaldi_step``,
              ``coord_metrics``; and the host µs and launches of one
              flight row and one black-box record.
7. sweep    — the lane engine and the sweep engine, each run counted on
              its own: (a) the lane engine (make_run_rounds_lanes) at
              1,048,576 nodes on the full-model config, stale_k 1 and 4:
              a 64-round warm-up, then 96 rounds with the flight
              recorder at stride 4, resumed from the warm-up's carry;
              the FD band holds over the 96 rounds, the column sums
              equal the stats delta, one lane_round launch a round;
              wall µs per round of the run timed alone, device µs per
              round from torch.profiler's busy time of the same run
              traced. (b) The bench's lan grid at
              full size through consul_tpu_torch.bench.run_sweep_class:
              64 points x 65,536 nodes x 300 rounds, xla engine and
              lanes engine; two points re-run alone (make_run_point)
              and compared with their grid rows, bit for bit; the Pareto
              winner, steady_s, scenario-rounds/s and peak device
              memory. (c) The cuda engine at 1,048,576 nodes: a
              4-point gossip_nodes grid of the lan autotune config, 96
              rounds, R=8 (mega_kernel full) and R=1 (round_kernel
              full), each point bit for bit make_run_rounds_cuda on its
              concrete SimParams and key, launches counted exactly.
              (d) run_byzantine_defense at 4,096 nodes, 200 rounds:
              best_k >= 1 with an induced missed rate below k=0's.
8. resume   — checkpoints through the entry points, each run counted on
              its own, every comparison exact: (a) the lane engine at
              1,048,576 nodes (full-model config, stale_k 4, flight
              stride 4, 96 rounds) straight, then through
              checkpoint.run_resumable(engine="lanes", chunk=32) cut by
              a guard after the first chunk and resumed from its files:
              state, stats and trace bit for bit; (b) the kernel runner
              as engine "cuda" at 1,048,576 nodes, the stable config at
              R=1 and the full config at R=8 (flight stride 8), 96
              rounds each, cut the same way: bit for bit, exactly 96
              round_kernel and 12 mega_kernel launches over both
              segments; (c) run_chaos(ckpt_dir=...) at 1,048,576 nodes
              on churn_burst (fault variant, black box on) and
              forged_acks (byz variant), cut at round 32 (inside the
              fault phase) and resumed: the report equals the plain
              run's, state, trace and rings bit for bit, launches
              exactly the rounds; (d) the newest file of (a) torn to
              2/3 of its size: ``latest`` falls back to the one before
              and the finished run is still bit for bit; (e)
              partition_heal at BASELINE config 5's sizes (3 DCs x 3
              servers, 10,000 LAN nodes per DC, 120 partition rounds)
              with the reference test's signature. Prints wall seconds
              per part, file bytes, and snapshot, save and load ms.
9. mesh     — the sharded lane engine and the per-viewer tier on
              torch.distributed (no kernel; every part plain PyTorch,
              each timed on its own): (a) a world of 1 on NCCL at
              1,048,576 nodes on the full-model config, 96 rounds at
              stale_k 1, 4 and 4 with overlap, bit for bit the single-
              device lane engine on the same card with exactly 2 + one
              collective per window (+ the drain); (b) a gloo world of 2
              with both ranks on the card at 1,048,576 nodes, dc 1 and
              2 at stale_k 4, the gathered state bit for bit the
              single-device run, and the per-DC pools (524,288 a DC,
              stats off, 64 crashes in DC 0): DC 0 bit for bit the
              single-device engine on its pool, DC 1 untouched; the
              device type each collective's tensors were on; (c) the
              stale_k 4 run cut at round 48 on that world, saved by
              checkpoint.snapshot_mesh, loaded and finished on one
              device: bit for bit the straight run; (d) the dense views
              at 4,096 on the card: 120 quiet rounds (no false positive,
              no divergence), 8 crashes and 70 rounds (all detected, no
              false positive), a 2,048/2,048 partition for 60 rounds
              then healed in 30-round chunks until the views converge
              (at most 300), with wall and profiler-busy µs per round
              and peak memory; (e) the sharded views at 4,096 on the
              gloo world: the all_to_all and pmax exchanges bit for bit
              over 35 rounds; (f) graft_entry.dryrun_multichip(2) on the
              card.
10. tune     — the cost model and the autotuner through their entry
              points at 1,048,576 nodes, each run counted on its own:
              (a) measure_bandwidth (copy, triad; no peak above 1.05 x
              3,350 GB/s); (b) roofline_table on the full-model config,
              24 rounds, best of 3: all 9 rows measured, the kernel
              runner's at R=1/4/8 launching exactly round_kernel/full
              and mega_kernel/full (a warm-up and 3 timed calls) and
              counting kernel_bound's bytes a round; (c) autotune on the
              headline config, 48 rounds, best of 3: all 15 points, the
              kernel runner's launching exactly round_kernel/stable and
              mega_kernel/stable; the winner saved, read back by
              cached_winner, built by tuned_runner and run from a fresh
              state bit for bit equal to its engine's runner built
              directly; (d) the TUNE and PROFILE payloads validated,
              written by the bench's _record_next and read back by
              load_ledger, one history row each. Records and the cache
              go to a temporary directory under build/.
11. seams   — the entry points and seams (cli.py, sim/twin.py,
              graft_entry.py), each part counted on its own: (a) the
              CLI's default mode in this process (``cli.main(["agent",
              "-dev", "-gossip-sim", "gpu", "-gossip-sim-nodes",
              "1048576"])``): exactly 100 full round launches, no false
              positive, suspicions and refutes per node-round under
              ``CLI_FD_CEILING`` of FD_REF (see there), the telemetry
              registry's sim.<counter> totals and sim.fd.* gauges equal
              to the report; (b) its chaos mode on churn_burst at
              1,048,576 nodes: the class's signature, one fault launch a
              round; (c) the twin's sim half (twin.SimHalf) on
              twin_plan(1,048,576), 88 rounds in chunks of 8 with the
              per-chunk host copy of status, incarnation and down_age,
              checkpointed into a temporary directory, then
              resume_digest_proof from the mid cut: true, exactly 88 +
              (rounds after the cut) fault launches; prints the sim
              wall, the host-copy ms and transitions per chunk and the
              file bytes (no agent is built on the card);
              (d) graft_entry.entry(): one round at 65,536 nodes,
              round_idx 1; (e) cli.capture_flight_trace(64, 20): its
              columns and one row a round.
12. graphs  — the compiled-run contract: every captured runner beside
              its explicit eager run (``graphs.eager()``) on the same
              inputs at 1,048,576 nodes, failing on any bit of
              difference in state, stats, trace, rings or scalars and
              on any difference in launch counts: the per-round and R=8
              kernel runners in 48- and 512-round calls, the per-round
              runner with the flight recorder and black box, the CLI's
              default mode (``cli.default_run``), a chunk of the twin's
              sim half (fault plan, carried scalars), the live engine
              (``round.make_run_rounds``), the lane engine (stale_k 4,
              flight) and two grid rounds of the lan grid (64 x 65,536)
              on the xla and lanes engines. A key's first call runs
              eagerly and its second is the capture: the second call
              and a replay-only call are both compared. Each prints
              wall ms a call (the first two apart), µs a round, the
              device's busy share and busy µs from torch.profiler,
              capture ms and the
              bytes the capture added to the graph pool; and a
              torch.profiler trace of one eager 48-round call (host ms
              by op). The earlier phases run the captured paths.
              Launches count the round kernels and the draw and sum
              kernels.
13. draws   — the threefry draw kernel and the tree_sum kernel
              (consul_tpu_torch/sim/fused.py): (a) every draw mode at
              1, 2, 3, 255, 65,536, 1,048,576 and 16,777,216 words, key
              stacks of 1, 5 and 4,096 keys, offsets past 2^32 (as an
              int and as a device value), fold_in on a data tensor,
              uniform's bounds (the views', normal's, a width that is no
              power of two), normal, exponential and randint; the keys
              derived in the launch: round_seeds, a round's slots as the
              rows of one draw (threefry_u01, global_u01; every slot set
              the engines draw, the replay slot among them), draws from a
              prng.SubKey and a SubKey stack, on rows that start off a
              vector boundary; a 2^31 + 5-word u01_global (64-bit
              indices) held by slices against its plain version; every sum
              at lengths 1, 2, 3, 7, 1,000,003 and 1,048,576, the grid
              rows [2048, 65,536], the lane tables [32, 64], the lane
              engine's block partials and row_sums, on inputs with
              signed zeros and magnitudes 1e-30 to 1e30, the sum plan's
              edges ([5, 1M]; a last CTA that owns the carrying last
              position alone or one float4 group; both sides of a row's
              cut and of the rows that fill the card; odd steps; 2^24,
              whose CTAs take 64 KB of shared memory; short rows packed
              several to a CTA) and a contiguous
              view whose base is not 16-byte aligned — each bit for bit
              its plain version (fused.plain()), which launches no
              kernel; (b) a body holding every mode and both sums
              through graphs.GraphCache, four calls with new keys,
              offsets and inputs, each equal to its eager run with equal
              launches; (c) the engines on the kernels against
              fused.plain(), bit for bit with equal round-kernel
              launches: the lane engine at 1M (16 rounds, stale_k 4,
              flight; one lane_round launch a round, kernels a round and
              device µs a round both ways), the live engine at 1M (8
              rounds; each live_round stage once a round), both on the
              byzantine check plan (12 rounds: the churn and replay
              slots), a lan grid round (64 x 65,536) on the xla and
              lanes engines (the lanes grid one lane_round launch a
              round too), the views at 4,096 (40 rounds), the
              kernel
              runner's R=1 x48, R=1 x512 and R=8 x48 calls, a coordinate
              round at 1M — wall and device µs a round both ways, the
              sum kernel's device µs a round, every draw and sum kernel
              launched by them, and the threefry launches of one call
              (a round and a call) beside PR 13's (``PR13_THREEFRY``);
              (d) each kernel's device ms at its paths' shapes and
              torch.sum's (both by CUDA-graph replay), its plain
              version's ms, its bound (costmodel.draw_bound /
              sum_bound).
14. timing  — each round kernel's time per launch (device time: CUDA
              events around replays of a CUDA graph of launches), its
              plain version's time, and its bound (``kernel_bound``)
              from the bytes it must move and the operations it must
              do; the six variants of the paths and the gated full
              variant (corroboration_k=1), which no path runs yet; and
              lane_round's (full, stable, fault, byz, a mid-window
              round, the lan autotune grid 64 x 65,536) beside
              ``costmodel.lane_bound`` and the plain body's time on the
              same slot rows; and each live_round stage's (the full
              model and the live cell's WAN with churn, on the check's
              state) beside ``costmodel.live_bound`` and the plain body's
              live period on the same draws; and each coordinate launch
              (coord_probe with the deadlines, vivaldi_relax,
              coord_quality; sim/coord_kernel.py) on the coordinates
              cell's period at 1,048,576 agents, 30 periods from a cold
              start, beside ``costmodel.coord_bound`` and its plain
              version (the ATen route it replaces: eager, and its device
              time by graph replay), every output bit for bit the plain
              version's (the relaxation's moved distances and their mean
              against the plain drift too).

Then the ``kernels`` line (the round kernels' variants, each
``threefry/<mode>``, ``tree_sum``, ``lane_round`` and the live stages
``live_round/<a|b|c>``, the coordinate launches: launches over the
script's paths (the coordinate launches over phase observe's two runs),
times at the main path's shapes), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Exits non-zero without a card.
"""

from __future__ import annotations

import collections
import contextlib
import inspect
import io
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

N = 1_048_576
MEGA_R = 8
#: the megakernel's other depth, which the roofline ladder and the
#: autotuner run
TUNE_R = 4
MAX_INT_MISMATCH = 2
MARGIN_ULPS = 4.0
INFORMED_ULPS = 4
#: the full-model diagnostic's suspicions and refutes per node-round at
#: 1% loss on the port's first chip runs (PERF.md); a new random
#: stream must stay within FD_BAND of them, with no false positive
FD_REF = {"suspicions_per_node_round": 0.01107,
          "refutes_per_node_round": 0.01105}
FD_BAND = (0.85, 1.15)


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check_plans(n: int) -> dict:
    """The plans the fault variants are checked on: every honest
    primitive (partitions that overlap, one of them one-way, loss,
    forced slow, a flap that the phase flip releases, duplication, a
    churn burst), and the four byzantine primitives beside a crash
    burst among the forged-ack victims."""
    from consul_tpu_torch import faults as F

    m = max(1, n // 16)
    adv = (n - 2 * m, n)
    honest = F.FaultPlan(phases=(
        F.Phase(rounds=2, name="warm"),
        F.Phase(rounds=8, name="fault", faults=(
            F.Partition(a=(0, m), b=(m, n), drop=0.8),
            F.Partition(a=(m // 2, 2 * m), b=(4 * m, n), symmetric=False),
            F.NodeLoss(nodes=(2 * m, 4 * m), ingress=0.3, egress=0.4),
            F.SlowNodes(nodes=(4 * m, 5 * m)),
            F.Flap(nodes=(5 * m, 6 * m), half_period=2),
            F.Duplicate(nodes=(0, 3 * m), copies=3),
            F.ChurnBurst(nodes=(6 * m, 8 * m), crash=0.05, rejoin=0.3,
                         leave=0.01))),
        F.Phase(rounds=4, name="recover")))
    byz = F.FaultPlan(phases=(
        F.Phase(rounds=2, name="warm"),
        F.Phase(rounds=8, name="attack", faults=(
            F.ForgedAcks(adversaries=adv, victims=(0, 2 * m),
                         coverage=0.9),
            F.SpuriousSuspicion(adversaries=adv, victims=(2 * m, 4 * m),
                                rate=2.0),
            F.Eclipse(adversaries=adv, victims=(4 * m, 5 * m),
                      coverage=0.95),
            F.StaleReplay(adversaries=adv, victims=(5 * m, 7 * m),
                          rate=0.4),
            F.ChurnBurst(nodes=(0, 2 * m), crash=0.05)))))
    return {"fault": honest, "byz": byz}


#: the round of each check plan whose frame the check feeds the kernel:
#: the honest plan's flappers are down there, the byzantine one attacks
CHECK_ROUNDS = {"fault": 4, "byz": 5}


def kernel_label(symbol: str):
    """The variant whose instantiation a mangled kernel symbol names
    (round_kernel<FAULT, BYZ, STABLE, ...>, mega_kernel<STABLE, ...>,
    draw_kernel<MODE, index type, ROW, words a thread>, the sum
    kernels, lane_round<FRAME, BYZ>, live_round<STAGE>, flight_row, the
    coordinate kernels), or None."""
    m = re.search(r"draw_kernelILi([0-4])E([il])Lb([01])ELi([14])E", symbol)
    if m:
        return "threefry/" + ("words", "xor", "seeds", "uniform",
                              "u01_global")[int(m.group(1))] + \
            ("/i32" if m.group(2) == "i" else "/i64") + \
            ("/row" if m.group(3) == "1" else "") + f"/v{m.group(4)}"
    m = re.search(r"sum_kernelILi([0-4])ELi([14])E", symbol)
    if m:
        return f"tree_sum/t{m.group(1)}v{m.group(2)}"
    m = re.search(r"lane_roundILb([01])ELb([01])E", symbol)
    if m:
        return {"00": "lane_round/none", "10": "lane_round/fault",
                "11": "lane_round/byz"}.get("".join(m.groups()))
    m = re.search(r"live_roundILi([0-2])E", symbol)
    if m:
        return "live_round/" + "abc"[int(m.group(1))]
    m = re.search(r"\d+(coord_probe|vivaldi_relax|coord_quality)E", symbol)
    if m:
        return m.group(1)
    if re.search(r"\d+flight_rowE", symbol):
        return "flight_row"
    m = re.search(r"mega_kernelILb([01])E", symbol)
    if m:
        return "mega_kernel/" + ("stable" if m.group(1) == "1" else "full")
    m = re.search(r"round_kernelILb([01])ELb([01])ELb([01])E", symbol)
    if m is None:
        return None
    return {"001": "round_kernel/stable", "000": "round_kernel/full",
            "100": "round_kernel/fault",
            "110": "round_kernel/byz"}.get("".join(m.groups()))


def ptxas_report(text: str) -> dict:
    """Registers, stack frame and spill bytes per kernel from nvcc
    -Xptxas -v."""
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", ln)
        if m:
            cur = kernel_label(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", ln)
        if m:
            out.setdefault(cur, {})["stack_bytes"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out.setdefault(cur, {})["spill_bytes"] = int(m.group(1)) + \
                int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def sass_listing(build, name) -> str:
    """cuobjdump -sass (beside nvcc) of the built library."""
    tool = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass",
                           str(build.library_path(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout


def sass_counts(build, name) -> dict:
    """Static SASS instructions per kernel of the built library (NOPs
    left out), from cuobjdump -sass beside nvcc."""
    text = sass_listing(build, name)
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = kernel_label(m.group(1))
            if cur is not None:
                out[cur] = 0
        elif cur is not None and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", ln) \
                and not re.match(r"\s+/\*[0-9a-f]+\*/\s+NOP\b", ln):
            out[cur] += 1
    return out


def _sass_functions(text: str) -> dict:
    """{label: [(address, opcode, operands)]} of every kernel of a
    cuobjdump -sass listing (NOPs left out)."""
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = kernel_label(m.group(1))
            if cur is not None:
                out[cur] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)"
                     r"\s*([^;]*);", ln)
        if cur is not None and m and m.group(3) != "NOP":
            out[cur].append((int(m.group(1), 16), m.group(3), m.group(4)))
    return out


def word_loop_sass(text: str) -> dict:
    """Per draw-kernel instantiation: the SASS instructions a word of its
    word loop (the shortest backward branch's body that holds 19 funnel
    shifts a word, ``SHF.L.W``: the unrolled threefry, whose last
    rotation the ``u01_global`` mode drops), in all and by opcode, from
    cuobjdump -sass."""
    out = {}
    for label, ins in _sass_functions(text).items():
        if not label.startswith("threefry/"):
            continue
        words = int(label.rsplit("/v", 1)[1])
        best = None
        for addr, op, args in ins:
            m = re.match(r"0x([0-9a-f]+)", args.strip())
            if op != "BRA" or m is None or int(m.group(1), 16) >= addr:
                continue
            lo = int(m.group(1), 16)
            body = [o for a, o, _ in ins if lo <= a <= addr]
            shf = sum(o.startswith("SHF.L.W") for o in body)
            if shf >= 19 * words and (best is None or len(body) < len(best)):
                best = body
        if best is None:
            continue
        ops = collections.Counter(o.split(".")[0] for o in best)
        out[label] = {"per_word": len(best) / words,
                      "by_op_per_word": {k: v / words for k, v in
                                         sorted(ops.items())}}
    return out


def phase_env(torch, build, cuda_round, fused, lane_kernel, coord_kernel):
    t0 = time.perf_counter()
    reports = build.build([cuda_round.SOURCE, *fused.SOURCES,
                           lane_kernel.SOURCE, coord_kernel.SOURCE])
    build_s = time.perf_counter() - t0
    regs = ptxas_report(reports[cuda_round.SOURCE])
    sass = sass_counts(build, cuda_round.SOURCE)
    layout = cuda_round.kernel_layout()
    kernels = {k: {**regs.get(k, {}), "sass_instructions": sass.get(k),
                   **layout.get(k, {}),
                   "grid_blocks": cuda_round.FLIGHT_BLOCKS
                   if k == "flight_row" else cuda_round.GRID_BLOCKS}
               for k in sorted(set(regs) | set(sass))}
    # the four round_kernel variants, the two mega_kernel ones, flight_row
    if len(kernels) != 7 or any(v.get("spill_bytes") != 0 or
                                not v.get("registers") or
                                not v["sass_instructions"]
                                for v in kernels.values()):
        raise SmokeFailure(f"kernel report incomplete or spilling: "
                           f"{kernels}")
    loops = {}
    for src in fused.SOURCES:
        regs = ptxas_report(reports[src])
        sass = sass_counts(build, src)
        kernels.update({k: {**regs.get(k, {}), "sass_instructions":
                            sass.get(k)} for k in set(regs) | set(sass)})
        if src == fused.DRAW_SOURCE:
            loops = word_loop_sass(sass_listing(build, src))
    # the draw bound may count no more instructions a word than the
    # kernel's word loop issues
    from consul_tpu_torch.sim import costmodel

    for label, loop in loops.items():
        loop["bound_per_word"] = costmodel.draw_instructions_per_word(
            label.split("/")[1])
    short = sorted(k for k, v in loops.items() if "/row/" in k
                   and v["per_word"] < v["bound_per_word"])
    if short or not any("/row/" in k for k in loops):
        raise SmokeFailure(f"the draw bound counts more instructions a word "
                           f"than the word loops of {short} issue: {loops}")
    new = {k: v for k, v in kernels.items() if k.split("/")[0]
           in ("threefry", "tree_sum")}
    sums = [v for k, v in new.items() if k.startswith("tree_sum/")]
    # sum_kernel<T, 1> for T of 0 .. THREAD_LEVELS, sum_kernel<4, 4>;
    # draw_kernel<MODE, I, ROW or not, V> of each mode: int32 at one and
    # 4 words a thread, int64 at 4
    n_sums = fused.THREAD_LEVELS + 2
    n_draws = len(fused.MODES) * 6
    if len(new) != n_draws + n_sums or len(sums) != n_sums or any(
            v.get("spill_bytes") != 0 or v.get("stack_bytes") != 0 or
            not v.get("registers") or not v["sass_instructions"]
            for v in new.values()):
        raise SmokeFailure(f"draw and sum kernel report incomplete, "
                           f"spilling or with a stack frame: {kernels}")
    regs = ptxas_report(reports[lane_kernel.SOURCE])
    sass = sass_counts(build, lane_kernel.SOURCE)
    lane = {k: {**regs.get(k, {}), "sass_instructions": sass.get(k)}
            for k in set(regs) | set(sass)}
    # lane_round<FRAME, BYZ>: no frame, an honest one, a byzantine one;
    # live_round<STAGE>: the live period's stages a, b, c
    if len(lane) != 6 or any(
            v.get("spill_bytes") != 0 or v.get("stack_bytes") != 0 or
            not v.get("registers") or not v["sass_instructions"]
            for v in lane.values()):
        raise SmokeFailure(f"lane kernel report incomplete, spilling or "
                           f"with a stack frame: {lane}")
    kernels.update(lane)
    regs = ptxas_report(reports[coord_kernel.SOURCE])
    sass = sass_counts(build, coord_kernel.SOURCE)
    coord = {k: {**regs.get(k, {}), "sass_instructions": sass.get(k)}
             for k in set(regs) | set(sass)}
    if set(coord) != set(coord_kernel.NAMES) or any(
            v.get("spill_bytes") != 0 or v.get("stack_bytes") != 0 or
            not v.get("registers") or not v["sass_instructions"]
            for v in coord.values()):
        raise SmokeFailure(f"coordinate kernel report incomplete, spilling "
                           f"or with a stack frame: {coord}")
    kernels.update(coord)
    emit({"phase": "env", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": nvidia_smi(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "kernels": kernels,
          "draw_word_loop_sass": loops})


def warmed_state(torch, m, p, dev, rounds=12):
    """A 1M-node state with dead, left, slow and suspect rows, evolved by
    the plain version (so the kernels are not their own input)."""
    s = m.state.init_state(N, device=dev)
    s = m.state.with_crashed(s, torch.arange(0, N, 4099, device=dev), age=3)
    s = m.state.with_slow(s, torch.arange(1, N, 5003, device=dev))
    arrays = s.node_arrays()
    scal = m.round.init_scalars(s, p)
    seeds = m.prng.round_seeds(m.prng.key(7, device=dev), 0, rounds)
    for r in range(rounds):
        arrays, part = m.cuda_round.block_round_ref(arrays, scal, seeds[r],
                                                    p)
        scal = m.round.clamp_scalars(part.sum(0)[:8])
    return arrays, scal


def plain_margins(m, arrays, scal, seeds, p, fx=None):
    """Per-node smallest decision margin (ulps) over the call's rounds."""
    vals, worst = arrays, None
    for r in range(seeds.shape[0]):
        mg = []
        vals, _ = m.cuda_round.block_round_ref(vals, scal, seeds[r], p,
                                               margin=mg, fx=fx)
        worst = mg[0] if worst is None else worst.clamp_max(mg[0])
    return worst


def compare(torch, m, name, arrays, scal, seeds, p, mega, fx=None):
    cr = m.cuda_round
    k_arrays = tuple(a.clone() for a in arrays)
    if mega:
        ref_out, ref_part = cr.mega_round_ref(arrays, scal, seeds, p)
        k_part = cr.mega_kernel(k_arrays, scal, seeds, p)
    else:
        ref_out, ref_part = cr.block_round_ref(arrays, scal, seeds[0], p,
                                               fx=plain_frame(m, fx))
        k_part = cr.round_kernel(k_arrays, scal, seeds, 0, p, fx=fx)
    torch.cuda.synchronize()
    fields = m.state.NODE_FIELDS
    bad = torch.zeros(arrays[0].shape[0], dtype=torch.bool,
                      device=arrays[0].device)
    max_err = 0.0
    for f, k, r in zip(fields, k_arrays, ref_out):
        if f == "informed":
            continue
        diff = k != r
        bad |= diff
        if diff.any():
            max_err = max(max_err, float((k.int() - r.int()).abs().max()))
    n_bad = int(bad.sum())
    margin_max = None
    if n_bad:
        margins = plain_margins(m, arrays, scal,
                                seeds if mega else seeds[:1], p,
                                plain_frame(m, fx))
        margin_max = float(margins[bad].max())
        if n_bad > MAX_INT_MISMATCH or margin_max >= MARGIN_ULPS:
            raise SmokeFailure(
                f"{name}: {n_bad} nodes differ in int lanes (largest "
                f"decision margin {margin_max} ulp)")
    ki, ri = k_arrays[fields.index("informed")], \
        ref_out[fields.index("informed")]
    inf_err = (ki - ri).abs()
    ulp = torch.clamp_min(ri.abs() * 2.0 ** -23, 2.0 ** -149)
    ok_inf = (inf_err <= INFORMED_ULPS * ulp) | bad
    if not bool(ok_inf.all()):
        raise SmokeFailure(f"{name}: informed differs by more than "
                           f"{INFORMED_ULPS} ulp")
    max_err = max(max_err, float(inf_err[~bad].max()) if (~bad).any()
                  else 0.0)
    # partial sums row by row; only the rows that hold a node allowed
    # to differ above are exempt
    blocks = k_part.shape[0]
    held = torch.ones(blocks, dtype=torch.bool, device=bad.device)
    held[cr.partials_row_of(bad.shape[0], bad.device)[bad]] = False
    pdiff = (k_part - ref_part).abs()[held]
    counters = list(range(8, 18))
    counters.remove(8 + m.round.LAT)
    if float(pdiff[:, counters].max()) != 0.0:
        raise SmokeFailure(f"{name}: counter partial sums differ")
    tol = 1e-5 * ref_part[held].abs() + 1e-4
    if not bool((pdiff <= tol).all()):
        raise SmokeFailure(f"{name}: partial sums differ by "
                           f"{float(pdiff.max())}")
    max_err = max(max_err, float(pdiff.max()))
    return {"name": name, "int_mismatch_nodes": n_bad,
            "mismatch_margin_ulps": margin_max,
            "informed_max_abs_err": float(inf_err.max()),
            "partials_max_abs_err": float(pdiff.max()),
            "partials_exempt_blocks": blocks - int(held.sum()),
            "max_abs_err": max_err}


def check_frames(m, dev) -> dict:
    """The fault views the check and the timing feed the fault
    variants, with each plan's host seconds in compile_plan; and, as
    "byz in place", the byzantine round as the kernel runner hands it
    to the kernel on the card (``faults.frames_in_place``)."""
    out = {}
    for name, plan in check_plans(N).items():
        t0 = time.perf_counter()
        cp = m.faults.compile_plan(plan, N, dev)
        out[name] = (m.faults.fault_frame(cp, CHECK_ROUNDS[name]),
                     time.perf_counter() - t0)
        if name == "byz":
            out["byz in place"] = (next(m.faults.frames_in_place(
                cp, cp.starts.new_tensor(CHECK_ROUNDS[name]), 1)), None)
    return out


def plain_frame(m, fx):
    """The frame the plain version takes for the kernel's ``fx``: an
    in-place frame resolved to its round's lanes."""
    if isinstance(fx, m.faults.InPlaceFrame):
        return fx.resolve()
    return fx


def check_inputs(torch, m, dev):
    """The state, scalars, seeds and frames the checks and timings run
    on, and each plan's host seconds in compile_plan."""
    p_churn = m.bench.diag_params(N).with_(
        fail_per_round=0.002, rejoin_per_round=0.02, leave_per_round=0.0005)
    arrays, scal = warmed_state(torch, m, p_churn, dev)
    seeds = m.prng.round_seeds(m.prng.key(11, device=dev), 100, MEGA_R)
    frames = check_frames(m, dev)
    return ((arrays, scal, seeds, {k: v[0] for k, v in frames.items()}),
            {k: v[1] for k, v in frames.items() if v[1] is not None})


def phase_check(torch, m, dev):
    """Every kernel variant against its plain version (``compare``)."""
    inputs, compile_s = check_inputs(torch, m, dev)
    b = m.bench
    arrays, scal, seeds, frames = inputs
    p_stable, p_full = b.headline_params(N), b.diag_params(N)
    p_churn = p_full.with_(fail_per_round=0.002, rejoin_per_round=0.02,
                           leave_per_round=0.0005)
    fx_fault, fx_byz = frames["fault"], frames["byz"]
    # the fault variants on the chaos suite's configuration, which their
    # path runs, and on the full one (slow-node model, TCP fallback)
    p_chaos = m.scenarios.chaos_params(N)
    results = {}
    for name, p, mega, fx in (
            ("round_kernel/stable", p_stable, False, None),
            ("round_kernel/full", p_full, False, None),
            ("round_kernel/churn", p_churn, False, None),
            ("round_kernel/full corroboration_k=1",
             p_full.with_(corroboration_k=1), False, None),
            ("round_kernel/fault", p_chaos, False, fx_fault),
            ("round_kernel/byz", p_chaos.with_(corroboration_k=2), False,
             fx_byz),
            ("round_kernel/fault slow+tcp", p_full, False, fx_fault),
            ("round_kernel/byz slow+tcp", p_full.with_(corroboration_k=2),
             False, fx_byz),
            ("round_kernel/byz in place", p_chaos.with_(corroboration_k=2),
             False, frames["byz in place"]),
            ("mega_kernel/stable", p_stable, True, None),
            ("mega_kernel/full", p_full, True, None),
            (f"mega_kernel/stable R={TUNE_R}", p_stable, True, None),
            (f"mega_kernel/full R={TUNE_R}", p_full, True, None)):
        r_seeds = seeds[:TUNE_R] if name.endswith(f"R={TUNE_R}") else seeds
        results[name] = compare(torch, m, name, arrays, scal, r_seeds, p,
                                mega, fx)
    emit({"phase": "check", "n": N, "ok": True,
          "compile_plan_s": compile_s, "kernels": list(results.values())})
    return results, inputs


#: the lane kernel's check: a shard's offset past the first nodes
LANE_OFFSET = 12_345


def division_rule(torch, dev) -> str:
    """How ATen divides a CUDA tensor by a Python number: "reciprocal"
    (a product with the f32 reciprocal) or "divide", read from 2^20
    quotients by 3 against the true division of two tensors."""
    x = torch.arange(1, 2**20 + 1, dtype=torch.float32, device=dev)
    by_number = x / 3
    if torch.equal(by_number, x / torch.full_like(x, 3.0)):
        return "divide"
    recip = torch.tensor(1.0, dtype=torch.float32) / 3.0
    if torch.equal(by_number, x * recip.item()):
        return "reciprocal"
    raise SmokeFailure("a CUDA tensor divided by a Python number is "
                       "neither a division nor a product with the f32 "
                       "reciprocal")


def lane_cases(m, inputs, offset=LANE_OFFSET) -> list:
    """(label, params, frame, shard offset, stats, inst, window) of every
    ``lane_round`` launch the lanes phase holds against the plain body:
    the stable, full and churn configs, an honest frame and a byzantine
    one with corroboration_k=2 (the chaos suite's config, and again on
    the full one), corroboration_k=1, a shard's offset, and window
    rounds j >= 1 (``window``: onto the stack of the round before)."""
    b, sc = m.bench, m.scenarios
    n = inputs[0][0].shape[0]
    frames = inputs[3]
    p_stable, p_full = b.headline_params(n), b.diag_params(n)
    p_churn = p_full.with_(fail_per_round=0.002, rejoin_per_round=0.02,
                           leave_per_round=0.0005)
    p_chaos = sc.chaos_params(n)
    return [
        ("stable", p_stable, None, 0, "write", True, False),
        ("full", p_full, None, 0, "write", True, False),
        ("churn", p_churn, None, 0, "write", True, False),
        ("fault", p_chaos, frames["fault"], 0, "write", True, False),
        ("byz corroboration_k=2", p_chaos.with_(corroboration_k=2),
         frames["byz"], 0, "write", True, False),
        ("fault slow+tcp", p_full, frames["fault"], 0, "write", True, False),
        ("byz slow+tcp", p_full.with_(corroboration_k=2), frames["byz"], 0,
         "write", True, False),
        ("full corroboration_k=1", p_full.with_(corroboration_k=1), None, 0,
         "write", True, False),
        (f"full shard offset {offset}", p_full, None, offset, "write", True,
         False),
        ("window j>=1 stats, last round", p_full, None, 0, "add", True,
         True),
        ("window j>=1 stats, mid-window", p_full, None, 0, "add", False,
         True),
        ("window j>=1 no stats, mid-window", p_stable, None, 0, "skip",
         False, True),
        ("window j>=1 byz stats, last round",
         p_chaos.with_(corroboration_k=2), frames["byz"], 0, "add", True,
         True)]


def lane_state(torch, m, inputs):
    """The checks' warmed state as a SimState at round 0."""
    arrays = inputs[0]
    dev = arrays[0].device
    return m.state.SimState(*arrays, t=torch.zeros((), device=dev),
                            round_idx=torch.zeros((), dtype=torch.int32,
                                                  device=dev),
                            stats=m.state.SimStats.zeros(dev))


def lane_check(torch, m, inputs, case, key) -> dict:
    """One ``lane_round`` launch (through ``round._lane_contributions``,
    the lane engine's call) against the plain body on the same state,
    scalars, key and frame, inside ``fused.plain()``: the 8 lanes and
    the 32 stack rows bit for bit. A window round's stack starts as the
    plain body's stack of another round; the plain side adds its
    counter rows onto it (the plain window's ``pend + rows``) and keeps
    its other rows where the round skips them."""
    label, p, fx, offset, stats, inst, window = case
    L, R = m.lanes, m.round
    s = lane_state(torch, m, inputs)
    scal = inputs[1]
    prev = None
    if window:
        with m.fused.plain():
            _, prev = R._lane_contributions(s, scal, m.prng.fold_in(key, 1),
                                            p, fx, offset)
    before = m.fused.LAUNCHES["lane_round"]
    got, stack = R._lane_contributions(
        s, scal, key, p, fx, offset,
        stack=None if prev is None else prev.clone(), stats=stats, inst=inst)
    launched = m.fused.LAUNCHES["lane_round"] - before
    with m.fused.plain():
        want, rows = R._lane_contributions(s, scal, key, p, fx, offset)
    if window:
        plain_rows = rows
        rows = prev.clone()
        if stats == "add":
            rows[L.STATS_SLICE] = prev[L.STATS_SLICE] \
                + plain_rows[L.STATS_SLICE]
        if inst:
            keep = torch.ones(rows.shape[0], dtype=torch.bool,
                              device=rows.device)
            keep[L.STATS_SLICE] = False
            rows[keep] = plain_rows[keep]
    lanes_bad = {f: int((a != b).sum()) for f, a, b in zip(
        m.state.NODE_FIELDS, got.node_arrays(), want.node_arrays())
        if not _same_bits(torch, a, b)}
    rows_bad = [i for i in range(rows.shape[0])
                if not _same_bits(torch, stack[i], rows[i])]
    return {"label": label, "launches": launched, "stats": stats,
            "inst": inst, "lanes_differ": lanes_bad, "rows_differ": rows_bad,
            "bitwise": not lanes_bad and not rows_bad and
            _same_bits(torch, got.t, want.t)}


def lane_checks(torch, m, inputs, cases) -> tuple:
    """Every case of ``cases`` (``lane_cases``): (report, failures)."""
    key = m.prng.key(41, device=inputs[0][0].device)
    out, bad = [], []
    for case in cases:
        r = lane_check(torch, m, inputs, case, key)
        out.append(r)
        if not r["bitwise"]:
            bad.append(f"lane_round {r['label']}: lanes "
                       f"{r['lanes_differ']} rows {r['rows_differ']} "
                       "differ from the plain body")
        want = 1 if inputs[0][0].device.type == "cuda" else 0
        if r["launches"] != want:
            bad.append(f"lane_round {r['label']}: {r['launches']} launches")
    return out, bad


#: the grids of points the lanes phase holds against the plain body: the
#: bench's lan autotune grid (the sweep's cell), and two grids that
#: sweep every kind of constant the table holds — a divided probe
#: interval, a per-point k, a blended frame with a row a point, the
#: Lifeguard, churn and loss constants — on the check plans' frames
LANE_GRID_N = 65_536


def lane_grids(m, n=LANE_GRID_N) -> list:
    """(label, params, axes, frame kind) of each grid ``lane_grid_check``
    runs at ``n`` nodes a point."""
    b, sc = m.bench, m.scenarios
    return [
        ("lan autotune grid", sc.autotune_params("lan", n),
         dict(sc.AUTOTUNE_GRID), None),
        ("probe_interval, k, fault_gain, slow_factor; byz frame",
         sc.chaos_params(n), dict(probe_interval=(1.0, 2.0),
                                  corroboration_k=(0.0, 2.0),
                                  fault_gain=(0.5, 1.0),
                                  slow_factor=(0.1, 0.3)), "byz"),
        ("suspicion_mult, awareness_max, churn, loss; honest frame",
         b.diag_params(n), dict(suspicion_mult=(4.0, 5.0),
                                awareness_max=(4.0, 8.0),
                                fail_per_round=(0.0, 0.01),
                                loss=(0.01, 0.05)), "fault")]


def lane_grid_state(torch, m, p, axes, kind, dev, warm=3):
    """A grid of ``p`` over ``axes`` (TracedParams, its [G, N] state with
    dead rows, warmed ``warm`` rounds by the plain body, its lane vector)
    and the frame of the check plan ``kind`` (or None)."""
    n = p.n
    tp, pts = m.params.grid_params(p, m.params.SweepAxes.of(**axes), dev)
    s = m.sweep._broadcast_state(p, len(pts), dev)
    dead = torch.arange(n, device=dev) % 97 == 0
    s = s._replace(down_age=torch.where(
        dead, torch.tensor(3, dtype=torch.int16, device=dev), s.down_age))
    fx = None
    if kind is not None:
        cp = m.faults.compile_plan(check_plans(n)[kind], n, dev)
        fx = m.faults.fault_frame(cp, CHECK_ROUNDS[kind])
    red = m.lanes.reduce_lanes_single
    with m.fused.plain():
        lv = m.round.init_lanes(s, tp, red)
        keys = m.prng.round_keys(m.prng.key(5, device=dev), 0, warm)
        s, stack = m.round._lane_window(s, lv, keys, [fx] * warm, tp, warm)
        lv = red(stack)
    return tp, s, lv, fx


def lane_grid_check(torch, m, dev, grid, rounds=2) -> dict:
    """A window of ``rounds`` on a warmed grid through the kernel and
    inside ``fused.plain()``: every point's lanes, clock and stack rows
    bit for bit, one launch a round."""
    label, p, axes, kind = grid
    tp, s, lv, fx = lane_grid_state(torch, m, p, axes, kind, dev)
    keys = m.prng.round_keys(m.prng.key(6, device=dev), 3, rounds)
    outs, launches = [], []
    for ctx in (contextlib.nullcontext, m.fused.plain):
        before = m.fused.LAUNCHES["lane_round"]
        with ctx():
            s2, stack = m.round._lane_window(s, lv, keys, [fx] * rounds,
                                             tp, rounds)
        launches.append(m.fused.LAUNCHES["lane_round"] - before)
        outs.append((*s2.node_arrays(), s2.t, stack))
    differ = [i for i, (a, b) in enumerate(zip(*outs))
              if not _same_bits(torch, a, b)]
    return {"label": label, "points": tp.grid_shape[0], "n": p.n,
            "launches": launches[0], "plain_launches": launches[1],
            "differ": differ, "bitwise": not differ}


def phase_lanes(torch, m, dev, inputs):
    """The lane kernel: ATen's division rule on the card (the kernel's
    packed reciprocals follow it), then one ``lane_round`` launch of
    each ``lane_cases`` case at 1,048,576 nodes on the checks' warmed
    state, and a window on each grid of ``lane_grids``, held bit for bit
    against the plain body."""
    t0 = time.perf_counter()
    rule = division_rule(torch, dev)
    bad = [] if rule == m.lane_kernel.CARD_RULE else [
        f"ATen's rule is {rule}; the kernel packs "
        f"{m.lane_kernel.CARD_RULE}"]
    cases, b = lane_checks(torch, m, inputs, lane_cases(m, inputs))
    bad += b
    grids = [lane_grid_check(torch, m, dev, g) for g in lane_grids(m)]
    bad += [f"lane_round grid {g['label']}: rows {g['differ']} differ, "
            f"{g['launches']} launches, {g['plain_launches']} plain"
            for g in grids if not g["bitwise"] or g["launches"] != 2
            or g["plain_launches"]]
    if bad:
        raise SmokeFailure("lanes: " + "; ".join(bad))
    emit({"phase": "lanes", "n": N, "division_rule": rule, "cases": cases,
          "grids": grids, "phase_s": time.perf_counter() - t0})


def crash_detection(torch, m, dev):
    n = 262_144
    p = m.params.SimParams(n=n, loss=0.01, collect_stats=False)
    s = m.state.with_crashed(m.state.init_state(n, device=dev), 7)
    out = m.cuda_round.make_run_rounds_cuda(p, 60)(
        s, m.prng.key(2, device=dev))
    dead = int((out.status == m.state.DEAD).sum())
    res = {"n": n, "rounds": 60, "node7_dead":
           int(out.status[7]) == m.state.DEAD, "dead_total": dead,
           "informed7": float(out.informed[7])}
    if not (res["node7_dead"] and dead == 1 and res["informed7"] > 0.99):
        raise SmokeFailure(f"crash detection failed: {res}")
    return res


def phase_headline(torch, m, dev):
    cr = m.cuda_round
    cr.reset_launches()
    m.fused.reset_launches()
    res = m.bench.run_headline(dev)
    launches = dict(cr.LAUNCHES)
    draws = _fused_counts(m)
    for k in ("round_kernel/stable", "round_kernel/full",
              "mega_kernel/stable", "mega_kernel/full"):
        if launches.get(k, 0) <= 0:
            raise SmokeFailure(f"{k} was not launched on the main path")
    # the runners' round seeds: one seeds launch a call derives each
    # round's key and draws its seed
    if draws.get("threefry/seeds", 0) <= 0:
        raise SmokeFailure("threefry/seeds was not launched on the main "
                           "path")
    cr.reset_launches()
    crash = crash_detection(torch, m, dev)
    crash["launches"] = dict(cr.LAUNCHES)
    if crash["launches"] != {"round_kernel/stable": crash["rounds"]}:
        raise SmokeFailure(f"crash detection launched {crash['launches']}"
                           f", expected {crash['rounds']} stable rounds")
    fd = res["fd"]
    if fd["fp_per_node_round"] != 0 or not all(
            FD_BAND[0] <= fd[k] / v <= FD_BAND[1]
            for k, v in FD_REF.items()):
        raise SmokeFailure(f"full-model diagnostic outside its band "
                           f"({FD_BAND} of {FD_REF}, no false positive): "
                           f"{fd}")
    emit({"phase": "headline", **res, "crash_detection": crash,
          "launches": launches, "draw_launches": draws})
    return res, launches


def class_failures(name: str, rep: dict) -> list:
    """The detection signature of one chaos class that ``rep``
    (``run_chaos``'s report) breaks: the chaos-suite and byzantine tests
    of the JAX package (tests/test_faults.py:285-298,
    tests/test_byzantine.py:284-315). The reference's live-scalar engine
    also declares no gc_pause node; the stale-scalar engines, its own
    fast path included, do declare some, so that one is not asserted."""
    bad = []

    def want(ok, what):
        if not ok:
            bad.append(what)

    ph = rep["phases"]
    want([x["phase"] for x in ph] == ["warmup", name, "recover"],
         f"{name}: phases {[x['phase'] for x in ph]}")
    want(ph[0]["suspicions"] == 0 and ph[0]["false_positives"] == 0
         and ph[0]["attack_suspicions"] == 0,
         f"{name}: the warm-up is not quiet")
    want(rep["final_wrongly_dead"] == 0,
         f"{name}: {rep['final_wrongly_dead']} wrongly dead at the end")
    want(rep["final_live_fraction"] > 0.95,
         f"{name}: live fraction {rep['final_live_fraction']}")
    f = ph[1]
    if name == "asym_partition":
        want(f["suspicions"] > 0, "asym_partition: no suspicions")
    elif name == "per_node_loss":
        want(f["refutes"] > 0, "per_node_loss: no refutes")
    elif name == "gc_pause":
        want(f["suspicions"] > 0, "gc_pause: no suspicions")
    elif name in ("flapping", "churn_burst"):
        want(f["crashes"] > 0, f"{name}: no crashes")
    elif name == "forged_acks":
        want(f["crashes"] > 0 and f["true_deaths_declared"]
             <= 0.1 * f["crashes"],
             f"forged_acks: detection not suppressed ({f['crashes']} "
             f"crashes, {f['true_deaths_declared']} declared)")
    elif name == "spurious_suspicion":
        want(100 < f["attack_suspicions"] <= f["suspicions"]
             and f["refutes"] >= 0.9 * f["suspicions"]
             and f["false_positives"] == f["attack_false_positives"] == 0,
             f"spurious_suspicion: {f}")
    elif name == "eclipse":
        want(f["false_positives"] > 0
             and f["attack_false_positives"] == f["false_positives"],
             f"eclipse: {f}")
    elif name == "stale_replay":
        want(f["crashes"] > 0
             and f["true_deaths_declared"] >= 0.5 * f["crashes"],
             f"stale_replay: detection blocked ({f})")
    return bad


def chaos_failures(suite: dict) -> list:
    """The detection signatures (``class_failures``) that ``suite``
    (bench's ``run_chaos_suite`` classes) breaks."""
    return [b for name, rep in suite.items()
            for b in class_failures(name, rep)]


def phase_chaos(torch, m, dev):
    """The fault-plan path through its entry point, counted on its own:
    the nine chaos classes at N nodes."""
    cr = m.cuda_round
    cr.reset_launches()
    res = m.bench.run_chaos_suite(dev)
    launches = dict(cr.LAUNCHES)
    honest = [k for k in res["classes"]
              if k not in m.scenarios.BYZANTINE_CHAOS]
    # each class runs twice (an untimed warm-up, then the timed run),
    # recording a flight row a round
    rounds = {k: 2 * sum(res["classes"][c]["rounds"] for c in cls)
              for k, cls in (("round_kernel/fault", honest),
                             ("round_kernel/byz",
                              m.scenarios.BYZANTINE_CHAOS))}
    rounds["flight_row"] = rounds["frame/in_place"] = sum(rounds.values())
    if launches != rounds:
        raise SmokeFailure(f"chaos launched {launches}, expected one "
                           f"launch per round of both runs, its frame "
                           f"read in place, and one row a round: {rounds}")
    bad = chaos_failures(res["classes"])
    if bad:
        raise SmokeFailure("chaos signatures: " + "; ".join(bad))
    emit({"phase": "chaos", **res, "launches": launches})
    return res, launches


OBSERVE_ROUNDS, OBSERVE_STRIDE = 200, 10
OBSERVE_MEGA_ROUNDS, OBSERVE_MEGA_STRIDE = 240, 40
TRACK_N = 65_536
TRACK_CLASSES = ("flapping", "eclipse")
#: the reference's bound on the kernel runner's last median relative RTT
#: error (tests/test_coords.py:301, after 60 rounds there). On jax 0.9's
#: threefry stream the reference's own live engine sits on a plateau
#: near 0.33-0.36 until round ~60 at 65,536 nodes (the port's engine
#: reproduces it bit for bit) and leaves it between rounds 60 and 90, so
#: the run here is 120 rounds long
COORD_ROUNDS, COORD_STRIDE = 120, 10
COORD_MED_BOUND = 0.3


def recorder_failures(m, s0, out, trace, label, last_row=True) -> list:
    """What a recorded run breaks: column sums against the run's stats
    delta (counters exact, the latency lane within 1e-5 relative, the
    sum of f32 window deltas), and (``last_row``) the last row's gauges
    against ``flight_row`` of the final state (the informed mean, which
    the card's ``flight_row`` kernel sums in its own order, within 1e-6
    relative; every other gauge exact)."""
    fl, st = m.flight, m.state
    bad = []
    cols = fl.trace_columns(trace)
    for f in st.STATS_FIELDS:
        total = float(getattr(out.stats, f)) - float(getattr(s0.stats, f))
        got = float(cols[f].astype("float64").sum())
        ok = abs(got - total) <= 1e-5 * abs(total) \
            if f == "detect_latency_sum" else got == total
        if not ok:
            bad.append(f"{label}: column {f} sums to {got}, stats moved "
                       f"{total}")
    if not last_row:
        return bad
    last = fl.flight_row(up=out.up, status=out.status,
                         informed=out.informed,
                         local_health=out.local_health,
                         incarnation=out.incarnation, t=out.t,
                         stats_delta=out.stats, phase=-1)
    g = len(fl.GAUGE_COLUMNS)
    inf = fl.COL["mean_informed"]
    exact = [i for i in range(g) if i != inf]
    if not (bool((trace[-1, exact] == last[exact]).all())
            and abs(float(trace[-1, inf]) - float(last[inf]))
            <= 1e-6 * abs(float(last[inf]))):
        bad.append(f"{label}: last row {trace[-1, :g].tolist()} is not the "
                   f"final state's {last[:g].tolist()}")
    return bad


def observe_recorders(torch, m, dev, n=N, rounds=OBSERVE_ROUNDS,
                      stride=OBSERVE_STRIDE, mega_rounds=OBSERVE_MEGA_ROUNDS,
                      mega_stride=OBSERVE_MEGA_STRIDE):
    """The per-round and R=8 full-model runners with the flight recorder
    and the black box; returns (report, failures, launches per run)."""
    cr, p = m.cuda_round, m.bench.diag_params(n)
    tracked = m.blackbox.default_tracked(n, p.blackbox_k, dev)
    out, bad, launches = {}, [], {}
    for label, rpc, r, k in (("per_round", 1, rounds, stride),
                             ("mega", MEGA_R, mega_rounds, mega_stride)):
        s0 = m.state.init_state(n, device=dev)
        run = cr.make_run_rounds_cuda(p, r, rounds_per_call=rpc,
                                      flight_every=k, blackbox=True)
        cr.reset_launches()
        fin, trace, bb = run(m.bench.clone_state(s0),
                             m.prng.key(21, device=dev), tracked=tracked)
        launches[label] = dict(cr.LAUNCHES)
        bad += recorder_failures(m, s0, fin, trace, label)
        rep = m.metrics.blackbox_report(bb, p)
        out[label] = {"rounds": r, "rounds_per_call": rpc,
                      "record_every": k, "rows": int(trace.shape[0]),
                      "suspicions": float(trace[:, m.flight.COL[
                          "suspicions"]].sum()),
                      "blackbox": {x: rep[x] for x in
                                   ("tracked", "ring_len", "events",
                                    "dropped_events")}}
    return out, bad, launches


def observe_tracking(m, dev, n=TRACK_N, classes=TRACK_CLASSES):
    """Every node tracked at stride 1 through ``run_chaos``, at 1% loss
    (in a loss-free cluster the stale scalars' zero Lifeguard scale
    declares some crashed nodes in the round they are first suspected,
    which a state diff cannot see); returns (report, failures,
    launches)."""
    cr, sc = m.cuda_round, m.scenarios
    p = sc.chaos_params(n).with_(loss=0.01, blackbox_k=n)
    out, bad, launches = {}, [], {}
    for name in classes:
        cr.reset_launches()
        rep = sc.run_chaos(name, n=n, device=dev, p=p, blackbox=True)
        launches[name] = dict(cr.LAUNCHES)
        bb = rep["blackbox"]
        out[name] = {"rounds": rep["rounds"], "tracked": bb["tracked"],
                     "dropped_events": bb["dropped_events"],
                     "events": bb["events"],
                     "crosscheck_agree": bb.get("crosscheck_agree")}
        if bb.get("crosscheck_agree") is not True:
            bad.append(f"{name}: ring totals disagree with the flight "
                       f"counters: {bb.get('crosscheck')}")
    return out, bad, launches


def observe_coords(torch, m, dev, n=N, rounds=COORD_ROUNDS,
                   stride=COORD_STRIDE):
    """The kernel runner with Vivaldi coordinates on the reference
    test's config (LAN, 1% loss, TCP fallback off); returns (report,
    failures, launches, the run's final coordinates and topology)."""
    cr, fl = m.cuda_round, m.flight
    p = m.params.SimParams.from_gossip_config(
        m.config.GossipConfig.lan(), n=n, loss=0.01, tcp_fallback=False)
    topo = m.topology.make_topology(m.topology.TopologyParams(n=n), dev)
    run = cr.make_run_rounds_cuda(p, rounds, coords=True,
                                  flight_every=stride)
    cr.reset_launches()
    m.coord_kernel.reset_launches()
    t0 = time.perf_counter()
    _, coo, trace = run(m.state.init_state(n, device=dev),
                        m.prng.key(0, device=dev),
                        coo=m.coords.init_coords(n, device=dev), topo=topo)
    med = trace[:, fl.COL["rtt_err_med"]].tolist()
    wall = time.perf_counter() - t0
    launches = dict(cr.LAUNCHES)
    coord_launches = dict(m.coord_kernel.LAUNCHES)
    bad = []
    want = {"coord_probe": rounds, "vivaldi_relax": rounds,
            "coord_quality": rounds // stride}
    if torch.device(dev).type == "cuda" and coord_launches != want:
        bad.append(f"coords: coordinate kernels launched {coord_launches}, "
                   f"expected {want}")
    if not (med[-1] < COORD_MED_BOUND and med[-1] < med[0]):
        bad.append(f"coords: median RTT error {med} does not fall under "
                   f"{COORD_MED_BOUND}")
    return ({"n": n, "rounds": rounds, "record_every": stride,
             "rtt_err_med": med,
             "rtt_err_p99": trace[:, fl.COL["rtt_err_p99"]].tolist(),
             "wall_us_per_round": wall / rounds * 1e6,
             "coord_launches": coord_launches},
            bad, {**launches, **coord_launches}, coo, topo)


#: periods and flight stride of the coordinates cell's path in phase
#: observe
COORD_FLIGHT_ROUNDS, COORD_FLIGHT_STRIDE = 16, 4


@contextlib.contextmanager
def _plain_coords(m):
    """Route the coordinate round to its plain versions on the card."""
    on_card = m.coords._on_card
    m.coords._on_card = lambda x: False
    try:
        yield
    finally:
        m.coords._on_card = on_card


def observe_coords_flight(torch, m, dev, n=N, rounds=COORD_FLIGHT_ROUNDS,
                          stride=COORD_FLIGHT_STRIDE):
    """The coordinates cell's path: the live engine's flight runner with
    coordinates, RTT-aware deadlines and the partition plan
    (``scenarios.coords_setup``), ``rounds`` periods at ``n`` agents and
    a flight row every ``stride``. Its coordinate launches are counted
    from zero (one ``coord_probe`` and one ``vivaldi_relax`` a period,
    one ``coord_quality`` a recorded period) and its trace is held
    against the plain route's on the card: the coordinate columns within
    1e-6, every other column and the final state equal. Returns (report,
    failures, launches)."""
    fl = m.flight
    su = m.scenarios.coords_setup(n, device=dev)
    on_card = torch.device(dev).type == "cuda"

    def trial():
        out = m.round.run_rounds_flight(
            m.state.init_state(n, device=dev), m.prng.key(3, device=dev),
            su.p, rounds, record_every=stride, plan=su.cp,
            coords=m.coords.init_coords(n, device=dev), topo=su.topo)
        if on_card:
            torch.cuda.synchronize()
        return out

    m.coord_kernel.reset_launches()
    t0 = time.perf_counter()
    s1, c1, tr1 = trial()
    wall = time.perf_counter() - t0
    launches = dict(m.coord_kernel.LAUNCHES)
    # eager: the runner's cache would replay the kernels' bodies
    with _plain_coords(m), m.graphs.eager():
        s2, c2, tr2 = trial()
    cols = [fl.COL[f] for f in fl.COORD_COLUMNS]
    rest = [i for i in range(fl.N_COLS) if i not in cols]
    gap = float((tr1[:, cols] - tr2[:, cols]).abs().max())
    bad = []
    want = {"coord_probe": rounds, "vivaldi_relax": rounds,
            "coord_quality": fl.n_trace_rows(rounds, stride)}
    if on_card and launches != want:
        bad.append(f"coords flight: coordinate kernels launched "
                   f"{launches}, expected {want}")
    if not gap <= 1e-6 or not torch.equal(tr1[:, rest], tr2[:, rest]) \
            or _bit_diffs(torch, s1.node_arrays(), s2.node_arrays()):
        bad.append(f"coords flight: the kernels' run is not the plain "
                   f"route's (coordinate columns {gap} apart)")
    return ({"n": n, "rounds": rounds, "record_every": stride,
             "deadlines": su.p.coords_timeout,
             "wall_us_per_round": wall / rounds * 1e6,
             "trace_gap": gap,
             "coords_max_abs_err": max(
                 float((a.double() - b.double()).abs().max())
                 for a, b in zip(c1, c2)),
             "coord_launches": launches}, bad, launches)


def coord_round_split(torch, m, coo, topo, n=N) -> dict:
    """Device µs of one coordinate round's parts at ``n`` nodes, each
    part timed alone by ``_graph_ms`` (CUDA-graph replay): the draws
    (probe pairs, their jittered RTTs, the population ack gate),
    ``vivaldi_step`` (its [N, 8] direction draw included),
    ``coord_metrics`` (one sort, two percentiles) and the whole
    ``coord_round``."""
    cr, co, topo_m, prng = m.cuda_round, m.coords, m.topology, m.prng
    dev = coo.vec.device
    key = prng.fold_in(prng.key(5, device=dev), prng.COORD_FOLD)
    up = torch.ones(n, dtype=torch.bool, device=dev)
    sc = torch.tensor([float(n), float(n), float(n), 0.0, 0.01 * n,
                       0.01 * n, 0.0, 1e-9], device=dev)
    k_pair, k_jit, k_dir, k_ack = prng.split(key, 4)
    i_all = torch.arange(n, device=dev)
    pair_j = topo_m.sample_pairs(n, k_pair)
    rtt = topo_m.sample_rtt(topo, i_all, pair_j, k_jit)
    upd = up & (prng.uniform(k_ack, n) < cr.coord_ack_rate(sc))
    aux = co.CoordRoundAux(pair_j=pair_j,
                           drift=torch.zeros((), device=dev))

    def draws():
        j = topo_m.sample_pairs(n, k_pair)
        topo_m.sample_rtt(topo, i_all, j, k_jit)
        up & (prng.uniform(k_ack, n) < cr.coord_ack_rate(sc))

    parts = {"draws": draws,
             "vivaldi_step": lambda: co.vivaldi_step(coo, None, pair_j, rtt,
                                                     k_dir, upd),
             "coord_metrics": lambda: co.coord_metrics(coo, topo, aux),
             "coord_round": lambda: cr.coord_round(coo, topo, key, up, sc)}
    return {name: _graph_ms(torch, fn, 40, per_graph=5) * 1e3
            for name, fn in parts.items()}


def recorder_host_costs(torch, m, dev, n=N, calls=200) -> dict:
    """Host µs per call of a flight row and of a black-box record (K=64
    agents) at ``n`` nodes, over ``calls`` calls after a warm-up, and
    the kernel launches per call (``cudaLaunchKernel`` in a
    ``torch.profiler`` trace of 20 calls): what a recorded round costs
    the per-round runner's host."""
    from torch.profiler import ProfilerActivity, profile

    s = m.state.init_state(n, device=dev)
    p = m.bench.diag_params(n)
    bb = m.blackbox.init_blackbox(
        s, m.blackbox.default_tracked(n, p.blackbox_k, dev), p.blackbox_ring)
    delta = torch.zeros(len(m.state.STATS_FIELDS), device=dev)
    fns = {"flight_row": lambda i: m.flight.flight_row(
               up=s.up, status=s.status, informed=s.informed,
               local_health=s.local_health, incarnation=s.incarnation,
               t=s.t, stats_delta=delta, phase=-1),
           "record": lambda i: m.blackbox.record(
               bb, round_idx=i, phase=-1, status=s.status,
               incarnation=s.incarnation, susp_conf=s.susp_conf, up=s.up)}
    out = {}
    for name, fn in fns.items():
        for i in range(20):
            fn(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        host = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(20):
                fn(i)
            torch.cuda.synchronize()
        launches = sum(e.count for e in prof.key_averages()
                       if e.key == "cudaLaunchKernel")
        out[name] = {"host_us_per_call": host,
                     "launches_per_call": launches / 20}
    return out


def phase_observe(torch, m, dev):
    """The recorders and the coordinates through the kernel runner, each
    run's launches counted on its own and checked."""
    bad = []
    rec, rbad, rl = observe_recorders(torch, m, dev)
    bad += rbad
    want = {"per_round": {"round_kernel/full": OBSERVE_ROUNDS,
                          "flight_row": OBSERVE_ROUNDS // OBSERVE_STRIDE},
            "mega": {"mega_kernel/full": OBSERVE_MEGA_ROUNDS // MEGA_R,
                     "flight_row":
                         OBSERVE_MEGA_ROUNDS // OBSERVE_MEGA_STRIDE}}
    for k, v in want.items():
        if rl[k] != v:
            bad.append(f"{k}: launched {rl[k]}, expected {v}")
    track, tbad, tl = observe_tracking(m, dev)
    bad += tbad
    for name, got in tl.items():
        kind = "byz" if name in m.scenarios.BYZANTINE_CHAOS else "fault"
        want_t = {f"round_kernel/{kind}": track[name]["rounds"],
                  "frame/in_place": track[name]["rounds"],
                  "flight_row": track[name]["rounds"]}
        if got != want_t:
            bad.append(f"tracking {name}: launched {got}, expected {want_t}")
    coords, cbad, cl, coo, topo = observe_coords(torch, m, dev)
    bad += cbad
    got = {k: v for k, v in cl.items() if k not in m.coord_kernel.NAMES}
    if got != {"round_kernel/full": COORD_ROUNDS,
               "flight_row": COORD_ROUNDS // COORD_STRIDE}:
        bad.append(f"coords: launched {got}, expected {COORD_ROUNDS} full "
                   f"rounds and {COORD_ROUNDS // COORD_STRIDE} rows")
    live_coords, lbad, ll = observe_coords_flight(torch, m, dev)
    bad += lbad
    if bad:
        raise SmokeFailure("observe: " + "; ".join(bad))
    coords["device_us"] = coord_round_split(torch, m, coo, topo)
    host = recorder_host_costs(torch, m, dev)
    launches: dict = {}
    for part in (rl, tl, {"coords": cl, "coords_flight": ll}):
        for counts in part.values():
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    emit({"phase": "observe", "recorders": rec, "host_us": host,
          "tracking": track, "coords": coords,
          "coords_flight": live_coords, "launches": launches})
    return launches


LANE_KS, LANE_WARM, LANE_ROUNDS, LANE_STRIDE = (1, 4), 64, 96, 4
SWEEP_SOLO_POINTS = (0, 37)
CUDA_SWEEP_GRID = {"gossip_nodes": (2.0, 3.0, 4.0, 5.0)}
CUDA_SWEEP_ROUNDS = 96


def sweep_lanes(torch, m, dev, n=N, warm_rounds=LANE_WARM,
                rounds=LANE_ROUNDS, stride=LANE_STRIDE):
    """(a) the lane engine at ``n`` nodes; returns (report, failures)."""
    out, bad = {}, []
    key = m.prng.key(31, device=dev)
    for k in LANE_KS:
        p = m.bench.diag_params(n).with_(stale_k=k)
        warm = m.round.make_run_rounds_lanes(p, warm_rounds, carry=True)
        run = m.round.make_run_rounds_lanes(p, rounds, flight_every=stride,
                                            carry=True)
        s, lv = warm(m.state.init_state(n, device=dev), key)
        s0 = m.bench.clone_state(s)
        # the same run twice from the warm state: timed alone, then
        # traced (the profiler's own host cost inflates its wall time)
        lr0 = m.fused.LAUNCHES["lane_round"]
        t0 = time.perf_counter()
        run(m.bench.clone_state(s0), m.prng.fold_in(key, 1),
            lanes0=lv.clone())
        m.bench._sync(torch.device(dev))
        wall_us = (time.perf_counter() - t0) / rounds * 1e6
        lane_launches = (m.fused.LAUNCHES["lane_round"] - lr0) / rounds
        (fin, trace, _), prof = m.bench.profile_call(
            lambda: run(s, m.prng.fold_in(key, 1), lanes0=lv), rounds,
            torch.device(dev))
        top = list(prof.get("device_us_per_round_by_kernel", {}).items())
        label = f"lanes stale_k={k}"
        if torch.device(dev).type == "cuda" and lane_launches != 1:
            bad.append(f"{label}: {lane_launches} lane_round launches a "
                       "round")
        bad += recorder_failures(m, s0, fin, trace, label, last_row=False)
        d = {f: float(getattr(fin.stats, f)) - float(getattr(s0.stats, f))
             for f in m.state.STATS_FIELDS}
        nr = float(n) * rounds
        fd = {"fp_per_node_round": d["false_positives"] / nr,
              "suspicions_per_node_round": d["suspicions"] / nr,
              "refutes_per_node_round": d["refutes"] / nr}
        if fd["fp_per_node_round"] != 0 or not all(
                FD_BAND[0] <= fd[x] / v <= FD_BAND[1]
                for x, v in FD_REF.items()):
            bad.append(f"{label}: outside the FD band ({FD_BAND} of "
                       f"{FD_REF}, no false positive): {fd}")
        out[f"stale_k={k}"] = {"rounds": rounds, "record_every": stride,
                               "rows": int(trace.shape[0]), "fd": fd,
                               "wall_us_per_round": wall_us,
                               "lane_round_launches_per_round":
                                   lane_launches,
                               "profiled_wall_us_per_round":
                                   prof["wall_us_per_round"],
                               "device_us_per_round":
                                   prof.get("device_busy_us", 0.0) / rounds,
                               "device_us_per_round_top": dict(top[:5])}
    return out, bad


def _state_diffs(torch, a, b) -> dict:
    """Per-field count of elements that differ between two states (-1
    where the dtypes or shapes differ)."""
    pairs = [(f, getattr(a, f), getattr(b, f)) for f in a._fields
             if f != "stats"]
    pairs += [(f, x, y) for f, x, y in zip(a.stats._fields, a.stats,
                                           b.stats)]
    out = {}
    for f, x, y in pairs:
        if x.dtype != y.dtype or x.shape != y.shape:
            out[f] = -1
        elif bool((x != y).any()):
            out[f] = int((x != y).sum())
    return out


def sweep_grid(torch, m, dev, n=None, rounds=None):
    """(b) the bench's lan grid on the xla and lanes engines (at the
    bench's size unless given); returns (report, failures)."""
    out, bad = {}, []
    n0, rounds0 = m.bench.SWEEP_SIZE
    n, rounds = n or n0, rounds or rounds0
    for engine in ("xla", "lanes"):
        rep, result, key = m.bench.run_sweep_class("lan", n, rounds, dev,
                                                   engine)
        p = m.scenarios.autotune_params("lan", n)
        solos = {}
        for i in SWEEP_SOLO_POINTS:
            st, _ = m.sweep.solo_reference(result, i, p, key, engine=engine,
                                           device=dev)
            row = m.sweep.take_point(result.states, i)
            diffs = _state_diffs(torch, row, st)
            solos[i] = {"bitwise": not diffs, "diffs": diffs}
            if diffs:
                bad.append(f"{engine} grid point {i} differs from its "
                           f"one-point run: {diffs}")
        rep["solo"] = solos
        out[engine] = rep
    return out, bad


def sweep_cuda(torch, m, dev, n=N, rounds=CUDA_SWEEP_ROUNDS):
    """(c) the cuda engine at ``n`` nodes; returns (report, failures,
    launches). On the CPU the wrappers take the plain versions and
    count nothing."""
    cr = m.cuda_round
    p = m.scenarios.autotune_params("lan", n)
    axes = m.params.SweepAxes.of(**CUDA_SWEEP_GRID)
    key = m.prng.key(9, device=dev)
    out, bad, launches = {}, [], {}
    on_card = torch.device(dev).type == "cuda"
    for rpc, kname in ((MEGA_R, "mega_kernel/full"),
                       (1, "round_kernel/full")):
        cr.reset_launches()
        t0 = time.perf_counter()
        res = m.sweep.run_sweep(p, axes, rounds, key=key, engine="cuda",
                                rounds_per_call=rpc, device=dev)
        m.bench._sync(torch.device(dev))
        wall = time.perf_counter() - t0
        got = dict(cr.LAUNCHES)
        want = {kname: axes.size * rounds // rpc} if on_card else {}
        if got != want:
            bad.append(f"cuda sweep R={rpc}: launched {got}, expected "
                       f"{want}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        diffs = {}
        for i, pp in enumerate(res.points):
            solo = cr.make_run_rounds_cuda(pp, rounds, rounds_per_call=rpc)(
                m.state.init_state(n, device=dev), key)
            d = _state_diffs(torch, m.sweep.take_point(res.states, i), solo)
            if d:
                diffs[i] = d
        if diffs:
            bad.append(f"cuda sweep R={rpc}: points differ from "
                       f"make_run_rounds_cuda: {diffs}")
        out[f"R={rpc}"] = {
            "gossip_nodes": [pp.gossip_nodes for pp in res.points],
            "rounds": rounds, "launches": got,
            "bitwise": not diffs, "wall_s": wall,
            "suspicions": res.states.stats.suspicions.tolist()}
    return out, bad, launches


def phase_sweep(torch, m, dev):
    """The lane engine, the sweep engines and the defense sweep; only
    the cuda engine launches kernels, each run counted on its own."""
    cr = m.cuda_round
    bad, counts = [], {}
    cr.reset_launches()
    lanes, lbad = sweep_lanes(torch, m, dev)
    counts["lanes"] = dict(cr.LAUNCHES)
    bad += lbad
    cr.reset_launches()
    grid, gbad = sweep_grid(torch, m, dev)
    counts["grid"] = dict(cr.LAUNCHES)
    bad += gbad
    cuda, cbad, launches = sweep_cuda(torch, m, dev)
    bad += cbad
    cr.reset_launches()
    defense = m.bench.run_defense_bench(dev)
    counts["defense"] = dict(cr.LAUNCHES)
    ind = defense["attack_induced_missed_rate"]
    best = defense["ks"].index(defense["best_k"])
    if not (defense["best_k"] >= 1 and ind[best] < ind[0]):
        bad.append(f"defense: best_k {defense['best_k']}, induced missed "
                   f"rates {ind}")
    for k, v in counts.items():
        if v:
            bad.append(f"{k}: launched {v} kernels on a plain-PyTorch path")
    if bad:
        raise SmokeFailure("sweep: " + "; ".join(bad))
    emit({"phase": "sweep", "lanes": lanes, "grid": grid, "cuda": cuda,
          "defense": defense, "launches": launches})
    return launches


RESUME_ROUNDS, RESUME_CHUNK, RESUME_STRIDE = 96, 32, 4
RESUME_CUDA_STRIDE = 8
#: (class, black box) of the checkpointed chaos runs: the fault and the
#: byz variant
RESUME_CHAOS = (("churn_burst", True), ("forged_acks", False))


class TripAfter:
    """A preemption guard that reads as tripped from its (k+1)-th poll
    on (``run_resumable`` polls once before each chunk)."""

    def __init__(self, k: int):
        self.k, self.polls = k, 0

    @property
    def preempted(self) -> bool:
        self.polls += 1
        return self.polls > self.k


def _trace_diffs(want, got) -> int:
    """Elements of two traces (tensors or host arrays) that differ; -1
    for another shape or dtype."""
    a, b = (x.detach().cpu().numpy() if hasattr(x, "detach") else x
            for x in (want, got))
    if a.shape != b.shape or a.dtype != b.dtype:
        return -1
    return int((a != b).sum())


def _ring_diffs(a, b) -> dict:
    """Per-field count of differing elements of two BlackboxStates."""
    out = {}
    for f, x, y in zip(a._fields, a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            out[f] = -1
        elif bool((x != y).any()):
            out[f] = int((x != y).sum())
    return out


def _sync_ms(torch, dev, t0) -> float:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def resume_lanes(torch, m, dev, root, n=N, rounds=RESUME_ROUNDS,
                 chunk=RESUME_CHUNK, stride=RESUME_STRIDE):
    """(a) the lane engine cut after one chunk, saved, resumed from its
    files; snapshot, save and load timed on its last file; (d) that
    file torn, the resume falling back. Returns (report, failures)."""
    ck = m.checkpoint
    p = m.bench.diag_params(n).with_(stale_k=4)
    key = m.prng.key(41, device=dev)
    bad = []
    t0 = time.perf_counter()
    s_want, tr_want = m.round.make_run_rounds_lanes(
        p, rounds, flight_every=stride)(m.state.init_state(n, device=dev),
                                        key)
    straight_ms = _sync_ms(torch, dev, t0)
    d = os.path.join(root, "lanes")
    kw = dict(engine="lanes", flight_every=stride, chunk=chunk, ckpt_dir=d,
              device=dev)
    t0 = time.perf_counter()
    cut = ck.run_resumable(p, rounds, key, guard=TripAfter(1), **kw)
    cut_ms = _sync_ms(torch, dev, t0)
    t0 = time.perf_counter()
    done = ck.run_resumable(p, rounds, key, resume=True, **kw)
    resume_ms = _sync_ms(torch, dev, t0)
    if not (cut.preempted and cut.rounds_done == chunk
            and done.resumed_from == chunk and done.rounds_done == rounds):
        bad.append(f"lanes: cut at {cut.rounds_done}, resumed from "
                   f"{done.resumed_from} to {done.rounds_done}")
    diffs = _state_diffs(torch, s_want, done.state)
    tdiff = _trace_diffs(tr_want, done.trace)
    if diffs or tdiff:
        bad.append(f"lanes: resumed run differs: {diffs}, trace {tdiff}")
    files = sorted(f for f in os.listdir(d) if f.endswith(ck.SUFFIX))
    newest = os.path.join(d, files[-1])
    size = os.path.getsize(newest)
    t0 = time.perf_counter()
    snap = ck.load(newest, p=p)
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ck.save(os.path.join(root, "lanes_copy"), snap)
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ck.snapshot(p, key, done.state, engine="lanes", total_rounds=rounds,
                lanes=snap.lanes(dev), flight=done.trace,
                record_every=stride)
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    out = {"n": n, "rounds": rounds, "chunk": chunk, "record_every": stride,
           "stale_k": p.stale_k, "bitwise": not (diffs or tdiff),
           "files": files, "file_bytes": size,
           "state_bytes": m.state.state_bytes(done.state),
           "snapshot_ms": snapshot_ms, "save_ms": save_ms,
           "load_ms": load_ms, "straight_s": straight_ms / 1e3,
           "cut_s": cut_ms / 1e3, "resume_s": resume_ms / 1e3}

    # (d) the newest file torn: the resume falls back past it
    if len(files) < 2:
        return out, {}, bad + [f"torn: one file ({files}) has nothing to "
                               "fall back to: run three chunks or more"]
    with open(newest, "r+b") as f:
        f.truncate(size * 2 // 3)
    t0 = time.perf_counter()
    torn = ck.run_resumable(p, rounds, key, resume=True, **kw)
    torn_ms = _sync_ms(torch, dev, t0)
    diffs = _state_diffs(torch, s_want, torn.state)
    tdiff = _trace_diffs(tr_want, torn.trace)
    prev = int(files[-2][6:16])
    if torn.fallbacks != [newest] or torn.resumed_from != prev:
        bad.append(f"torn: fell back past {torn.fallbacks} to "
                   f"{torn.resumed_from}, expected [{newest}] and {prev}")
    if diffs or tdiff:
        bad.append(f"torn: resumed run differs: {diffs}, trace {tdiff}")
    torn_out = {"torn_file": files[-1], "torn_to_bytes": size * 2 // 3,
                "fallbacks": [os.path.basename(x) for x in torn.fallbacks],
                "resumed_from": torn.resumed_from,
                "bitwise": not (diffs or tdiff), "wall_s": torn_ms / 1e3}
    return out, torn_out, bad


def resume_cuda(torch, m, dev, root, n=N, rounds=RESUME_ROUNDS,
                chunk=RESUME_CHUNK):
    """(b) the kernel runner as a resumable engine: the stable config at
    R=1, the full config at R=8 with flight rows. Returns (report,
    failures, launches); on the CPU the wrappers launch nothing."""
    ck, cr, b = m.checkpoint, m.cuda_round, m.bench
    on_card = torch.device(dev).type == "cuda"
    key = m.prng.key(43, device=dev)
    out, bad, launches = {}, [], {}
    for label, p, rpc, stride, kname in (
            ("stable R=1", b.headline_params(n), 1, None,
             "round_kernel/stable"),
            ("full R=8", b.diag_params(n), MEGA_R, RESUME_CUDA_STRIDE,
             "mega_kernel/full")):
        res = cr.make_run_rounds_cuda(p, rounds, rounds_per_call=rpc,
                                      flight_every=stride)(
            m.state.init_state(n, device=dev), key)
        s_want, tr_want = (res, None) if stride is None else res
        d = os.path.join(root, f"cuda_R{rpc}")
        kw = dict(engine="cuda", rounds_per_call=rpc, flight_every=stride,
                  chunk=chunk, ckpt_dir=d, device=dev)
        cr.reset_launches()
        t0 = time.perf_counter()
        cut = ck.run_resumable(p, rounds, key, guard=TripAfter(1), **kw)
        done = ck.run_resumable(p, rounds, key, resume=True, **kw)
        wall_ms = _sync_ms(torch, dev, t0)
        got = dict(cr.LAUNCHES)
        want = {kname: rounds // rpc} if on_card else {}
        if on_card and stride is not None:
            want["flight_row"] = m.flight.n_trace_rows(rounds, stride)
        if got != want:
            bad.append(f"cuda {label}: launched {got}, expected {want}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        diffs = _state_diffs(torch, s_want, done.state)
        tdiff = 0 if stride is None else _trace_diffs(tr_want, done.trace)
        if not (cut.preempted and cut.rounds_done == chunk
                and done.resumed_from == chunk):
            bad.append(f"cuda {label}: cut at {cut.rounds_done}, resumed "
                       f"from {done.resumed_from}")
        if diffs or tdiff:
            bad.append(f"cuda {label}: resumed run differs: {diffs}, "
                       f"trace {tdiff}")
        out[label] = {"rounds": rounds, "chunk": chunk,
                      "record_every": stride, "launches": got,
                      "bitwise": not (diffs or tdiff),
                      "file_bytes": os.path.getsize(cut.checkpoint_path),
                      "wall_s": wall_ms / 1e3}
    return out, bad, launches


def resume_chaos(torch, m, dev, root, n=N, chunk=RESUME_CHUNK):
    """(c) run_chaos cut inside the fault phase and resumed against the
    plain run: the report equal, state, trace and rings bit for bit,
    one fault or byz launch and one flight row per round over both
    segments. Returns
    (report, failures, launches)."""
    sc, cr = m.scenarios, m.cuda_round
    on_card = torch.device(dev).type == "cuda"
    out, bad, launches = {}, [], {}
    for name, bb in RESUME_CHAOS:
        plan = sc.chaos_plans(n)[name]
        cp = m.faults.compile_plan(plan, n, dev)
        want = sc.chaos_outputs(name, n, device=dev, cp=cp, blackbox=bb)
        rep_want = sc.chaos_report(name, n, want)
        d = os.path.join(root, f"chaos_{name}")
        cr.reset_launches()
        t0 = time.perf_counter()
        stub = sc.run_chaos(name, n, device=dev, cp=cp, blackbox=bb,
                            ckpt_dir=d, guard=TripAfter(1), chunk=chunk)
        got = sc.chaos_outputs(name, n, device=dev, cp=cp, blackbox=bb,
                               ckpt_dir=d, resume=True, chunk=chunk)
        wall_ms = _sync_ms(torch, dev, t0)
        n_launch = dict(cr.LAUNCHES)
        kname = "round_kernel/" + ("byz" if name in sc.BYZANTINE_CHAOS
                                   else "fault")
        expect = {kname: plan.total_rounds,
                  "frame/in_place": plan.total_rounds,
                  "flight_row": plan.total_rounds} if on_card else {}
        if n_launch != expect:
            bad.append(f"chaos {name}: launched {n_launch}, expected "
                       f"{expect}")
        for k, v in n_launch.items():
            launches[k] = launches.get(k, 0) + v
        fault_start = plan.starts[1]
        if not (stub.get("preempted") and stub["rounds_done"] == chunk
                and fault_start < chunk < plan.starts[2]):
            bad.append(f"chaos {name}: not cut inside the fault phase: "
                       f"{stub}")
        rep = sc.chaos_report(name, n, got)
        same_report = json.dumps(rep, sort_keys=True) == json.dumps(
            rep_want, sort_keys=True)
        diffs = _state_diffs(torch, want[0], got[0])
        tdiff = _trace_diffs(want[1], got[1])
        rings = _ring_diffs(want[2], got[2]) if bb else {}
        if not same_report or diffs or tdiff or rings:
            bad.append(f"chaos {name}: resumed run differs: report "
                       f"equal {same_report}, state {diffs}, trace "
                       f"{tdiff}, rings {rings}")
        out[name] = {"n": n, "rounds": plan.total_rounds,
                     "cut_at": stub.get("rounds_done"), "blackbox": bb,
                     "launches": n_launch, "report_equal": same_report,
                     "bitwise": not (diffs or tdiff or rings),
                     "file_bytes": os.path.getsize(stub["checkpoint"]),
                     "wall_s": wall_ms / 1e3}
    return out, bad, launches


def resume_partition(torch, m, dev, **kw):
    """(e) partition_heal (BASELINE config 5's sizes unless given) and
    the reference test's signature. Returns (report, failures)."""
    t0 = time.perf_counter()
    rep = m.scenarios.partition_heal(device=dev, **kw).to_dict()
    rep["wall_s"] = _sync_ms(torch, dev, t0) / 1e3
    ok = (rep["detected_cross_dc_failures"] == rep["servers_per_dc"]
          and rep["false_positives_during_partition"] == 0
          and rep["healed_recovery_rounds"] > 0
          and rep["lan_false_positives"] == 0)
    return rep, [] if ok else [f"partition_heal signature: {rep}"]


def phase_resume(torch, m, dev, root):
    """Checkpoints at full size, each run counted on its own; files
    under ``root``. Returns the kernels' launches."""
    cr = m.cuda_round
    bad, plain_launches = [], {}
    cr.reset_launches()
    lanes, torn, b = resume_lanes(torch, m, dev, root)
    bad += b
    plain_launches["lanes"] = dict(cr.LAUNCHES)
    cuda, b, launches = resume_cuda(torch, m, dev, root)
    bad += b
    chaos, b, chaos_launches = resume_chaos(torch, m, dev, root)
    bad += b
    for k, v in chaos_launches.items():
        launches[k] = launches.get(k, 0) + v
    cr.reset_launches()
    heal, b = resume_partition(torch, m, dev)
    bad += b
    plain_launches["partition_heal"] = dict(cr.LAUNCHES)
    for k, v in plain_launches.items():
        if v:
            bad.append(f"{k}: launched {v} kernels on a plain-PyTorch path")
    if bad:
        raise SmokeFailure("resume: " + "; ".join(bad))
    emit({"phase": "resume", "nvidia_smi": nvidia_smi(), "lanes": lanes,
          "cuda": cuda, "chaos": chaos, "torn": torn,
          "partition_heal": heal, "launches": launches})
    return launches


#: no H100 SXM streams above its 3,350 GB/s; a copy or triad reading
#: more than 5% above it timed something other than HBM
PEAK_GBPS_CEILING = 1.05 * 3350
#: the kernel runner's rows, which a CPU rehearsal records as skipped
CUDA_CONFIGS = ("cuda", "cuda-x4", "cuda-x8")


def tune_launches(rows, rounds, reps, variant) -> dict:
    """The launches ``measure_config``'s kernel-runner rows make: two
    warm-up calls and ``reps`` timed calls of ``rounds`` rounds each,
    ``rounds / R`` launches a call (R=1 ``round_kernel``, else
    ``mega_kernel``)."""
    want = {}
    for row in rows:
        if row["engine"] != "cuda" or "skipped" in row:
            continue
        r = row["rounds_per_call"]
        name = f"{'round' if r == 1 else 'mega'}_kernel/{variant}"
        want[name] = want.get(name, 0) + (2 + reps) * rounds // r
    return want


def _skip_failures(rows, on_card, label) -> list:
    """On the card no row may be skipped; off it exactly the kernel
    runner's rows are."""
    skipped = {r["config"] for r in rows if "skipped" in r}
    want = set() if on_card else set(CUDA_CONFIGS)
    if skipped != want:
        return [f"{label}: skipped {sorted(skipped)}, expected "
                f"{sorted(want)}: "
                + "; ".join(r["skipped"] for r in rows if "skipped" in r)]
    return []


def tune_roofline(torch, m, dev, n=N, rounds=None, reps=None):
    """(a) ``measure_bandwidth`` and (b) ``roofline_table`` on the
    full-model configuration; the kernel runner's rows launch exactly
    ``tune_launches`` and count ``kernel_bound``'s bytes per round.
    Returns (report, failures, launches, the table)."""
    cm, cr = m.costmodel, m.cuda_round
    d_rounds, d_reps = m.bench.ROOFLINE_DEPTH
    rounds, reps = rounds or d_rounds, reps or d_reps
    on_card = torch.device(dev).type == "cuda"
    bad = []
    bw = cm.measure_bandwidth(device=dev)
    if on_card and bw["peak_gbps"] > PEAK_GBPS_CEILING:
        bad.append(f"bandwidth: {bw['peak_gbps']} GB/s is above "
                   f"{PEAK_GBPS_CEILING:.0f}")
    p = m.bench.diag_params(n)
    cr.reset_launches()
    t0 = time.perf_counter()
    table = cm.roofline_table(p, rounds=rounds, reps=reps, bandwidth=bw,
                              device=dev)
    wall = time.perf_counter() - t0
    got = dict(cr.LAUNCHES)
    want = tune_launches(table["rows"], rounds, reps, "full")
    if got != want:
        bad.append(f"roofline launched {got}, expected {want}")
    bad += _skip_failures(table["rows"], on_card, "roofline")
    arrays = m.state.init_state(n, device=dev).node_arrays()
    for row in table["rows"]:
        if row["engine"] != "cuda" or "skipped" in row:
            continue
        r = row["rounds_per_call"]
        count = cm.kernel_bound(p, arrays, r)["bytes"] / r
        if abs(row["bytes_measured"] - count) > 0.1:
            bad.append(f"{row['config']}: counted {row['bytes_measured']}"
                       f" B a round, kernel_bound gives {count}")
    keys = ("config", "ms_per_round", "rounds_per_sec", "bytes_model",
            "bytes_measured", "model_vs_measured", "flagged",
            "flops_measured", "temp_bytes_measured", "achieved_gbps",
            "util", "skipped")
    rows = [{k: r[k] for k in keys if k in r} for r in table["rows"]]
    return ({"n": n, "rounds": rounds, "reps": reps, "bandwidth": bw,
             "rows": rows, "flags": table["flags"], "wall_s": wall,
             "launches": got}, bad, got, table)


def direct_runner(m, p, winner, rounds):
    """The runner of a winner's engine and cadence, built from its
    factory without the autotuner."""
    e, k = winner["engine"], winner["stale_k"]
    if e == "cuda":
        return m.cuda_round.make_run_rounds_cuda(
            p, rounds, rounds_per_call=winner["rounds_per_call"])
    if e == "fast":
        return m.round.make_run_rounds_fast(p, rounds)
    if e == "xla":
        return m.round.make_run_rounds(p, rounds)
    return m.round.make_run_rounds_lanes(
        p.with_(stale_k=k), rounds, overlap=e == "overlap",
        lane_blocks=winner["lane_blocks"] if e == "lanes" else None)


def tune_autotune(torch, m, dev, root, n=N, rounds=None, reps=None):
    """(c) ``autotune`` on the headline configuration: 15 rows, the
    kernel runner's launching exactly ``tune_launches``; the winner
    saved, read back by ``cached_winner`` and built by ``tuned_runner``,
    whose run from a copy of a fresh state equals the directly built
    runner's bit for bit. Returns (record, report, failures,
    launches)."""
    cr, at = m.cuda_round, m.autotune
    d_rounds, d_reps = m.bench.AUTOTUNE_DEPTH
    rounds, reps = rounds or d_rounds, reps or d_reps
    on_card = torch.device(dev).type == "cuda"
    bad = []
    p = m.bench.headline_params(n)
    cr.reset_launches()
    t0 = time.perf_counter()
    rec = at.autotune(p, rounds=rounds, reps=reps, device=dev,
                      metric="autotune_rounds_per_sec_1M_nodes"
                      if n == N else "autotune_rounds_per_sec_smoke")
    wall = time.perf_counter() - t0
    got = dict(cr.LAUNCHES)
    want = tune_launches(rec["rows"], rounds, reps, "stable")
    if got != want:
        bad.append(f"autotune launched {got}, expected {want}")
    if len(rec["rows"]) != 15:
        bad.append(f"autotune swept {len(rec['rows'])} points, not 15")
    bad += _skip_failures(rec["rows"], on_card, "autotune")
    winner = rec["winner"]
    at.save_winner(root, rec["platform"], n, winner)
    back = at.cached_winner(root, torch.device(dev).type, n)
    if back != winner:
        bad.append(f"cached winner {back} is not the tuned {winner}")
    s0 = m.state.init_state(n, device=dev)
    key = m.prng.key(51, device=dev)
    cr.reset_launches()
    tuned = at.tuned_runner(p, back, rounds)(m.bench.clone_state(s0), key)
    direct = direct_runner(m, p, winner, rounds)(
        m.bench.clone_state(s0), key)
    check_launches = dict(cr.LAUNCHES)
    diffs = _state_diffs(torch, tuned, direct)
    if diffs:
        bad.append(f"tuned runner differs from the direct one: {diffs}")
    r = winner["rounds_per_call"]
    want_t = {f"{'round' if r == 1 else 'mega'}_kernel/stable":
              2 * rounds // r} if winner["engine"] == "cuda" and on_card         else {}
    if check_launches != want_t:
        bad.append(f"tuned check launched {check_launches}, expected "
                   f"{want_t}")
    for k, v in check_launches.items():
        got[k] = got.get(k, 0) + v
    rows = [{k: row[k] for k in ("config", "rounds_per_sec",
                                 "ms_per_round", "skipped") if k in row}
            for row in rec["rows"]]
    return rec, {"n": n, "rounds": rounds, "reps": reps, "rows": rows,
                 "winner": winner, "tuned_bitwise": not diffs,
                 "wall_s": wall}, bad, got


def tune_records(m, root, rec, profile_env) -> tuple:
    """(d) The TUNE and PROFILE payloads validated, written by the
    bench's ``_record_next``, read back by ``load_ledger``: one history
    row each. Returns (history rows, failures)."""
    cm = m.costmodel
    bad = []
    for family, payload in (("TUNE", rec), ("PROFILE", profile_env)):
        try:
            cm.validate_record(f"{family}_r01.json", payload)
        except cm.LedgerError as e:
            bad.append(f"{family} payload refused: {e}")
        if m.bench._record_next(family, payload, root) is None:
            bad.append(f"{family} was not recorded")
    rows = cm.history_rows(cm.load_ledger(root))
    if sorted(r["family"] for r in rows) != ["PROFILE", "TUNE"]:
        bad.append(f"history rows {rows}, expected one PROFILE and one "
                   "TUNE")
    return rows, bad


def phase_tune(torch, m, dev, root, headline):
    """The cost model, the roofline ladder, the autotuner and the
    records at full size, each run counted on its own; records and the
    winner cache under ``root``. Returns the kernels' launches."""
    t0 = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    roof, bad, rl, table = tune_roofline(torch, m, dev)
    rec, tune, b, tl = tune_autotune(torch, m, dev, root)
    bad += b
    tune["launches"] = tl
    launches = {k: rl.get(k, 0) + tl.get(k, 0) for k in {**rl, **tl}}
    history, b = tune_records(m, root, rec,
                              m.bench.profile_record(headline, table))
    bad += b
    if bad:
        raise SmokeFailure("tune: " + "; ".join(bad))
    emit({"phase": "tune", "nvidia_smi": nvidia_smi(), "roofline": roof,
          "autotune": tune, "history": history,
          "wall_s": time.perf_counter() - t0, "launches": launches})
    return launches


# ------------------------------------------------------------- mesh

MESH_ROUNDS = 96
MESH_CUT = 48
MESH_KS = ((1, False), (4, False), (4, True))
MESH_CRASHED = 64
VIEWS_N = 4096
VIEWS_CRASHED = 8
#: rounds of the views runs: quiet, after the crashes, partitioned; the
#: heal runs in chunks until the views converge, at most VIEWS_HEAL_MAX
VIEWS_ROUNDS = (120, 70, 60)
VIEWS_HEAL_CHUNK, VIEWS_HEAL_MAX = 30, 300
VIEWS_SHARDED_ROUNDS = 35
VIEWS_PROFILE_ROUNDS = 5


def _wall_ms(torch, fn):
    """``fn()`` and its wall ms, closed by a device sync (a CPU
    rehearsal has none)."""
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _coll_report(M) -> dict:
    return {"counts": dict(M.COLLECTIVES),
            "tensor_devices": {k: sorted(v)
                               for k, v in M.COLLECTIVE_DEVICES.items()}}


def _mesh_nccl_rank(mesh, n, rounds):
    """(a) one NCCL rank: the sharded runner beside the single-device
    lane engine on the same card, per schedule; compared on the card."""
    import torch

    from consul_tpu_torch import bench
    from consul_tpu_torch.sim import mesh as M
    from consul_tpu_torch.sim import prng, round as R, state as S

    key = prng.key(51, mesh.device)
    out = {}
    for k, overlap in MESH_KS:
        p = bench.diag_params(n).with_(stale_k=k)
        single = R.make_run_rounds_lanes(p, rounds, overlap=overlap)
        sharded = M.make_sharded_run(p, rounds, mesh, overlap=overlap)
        want, lane_ms = _wall_ms(torch, lambda: single(
            S.init_state(n, device=mesh.device), key))
        M.reset_collectives()
        got, mesh_ms = _wall_ms(torch, lambda: sharded(
            M.init_sharded_state(n, mesh), key))
        out[f"stale_k={k}" + ("+overlap" if overlap else "")] = {
            "diffs": _state_diffs(torch, want, got),
            "windows_plus_init": bench.mesh_windows(rounds, k, overlap),
            **_coll_report(M),
            "mesh_ms_per_round": mesh_ms / rounds,
            "lanes_ms_per_round": lane_ms / rounds}
    return out


def _mesh_gloo_rank(mesh, n, rounds, cut, root, views_n):
    """(b), (c), (e) on one of two gloo ranks on the card: the gathered
    sharded runs at dc 1 and 2, the per-DC pools, the cut, and the
    sharded views' two exchanges."""
    import torch

    from consul_tpu_torch import bench
    from consul_tpu_torch.sim import checkpoint as ck
    from consul_tpu_torch.sim import mesh as M
    from consul_tpu_torch.sim import prng, views as V
    from consul_tpu_torch.sim.params import SimParams

    dev = mesh.device
    key = prng.key(51, dev)
    p = bench.diag_params(n).with_(stale_k=4)
    out = {}
    meshes = {1: mesh, 2: M.make_mesh(dc=2, device=dev)}
    for dc, mm in meshes.items():
        M.reset_collectives()
        s, ms = _wall_ms(torch, lambda: M.make_sharded_run(p, rounds, mm)(
            M.init_sharded_state(n, mm), key))
        out[f"dc={dc}"] = {"ms_per_round": ms / rounds, **_coll_report(M),
                           "state": M.gather_state(s, mm)}
        del s
    # per-DC pools of n/2, stats off; DC 0 (rank 0) loses its first nodes
    pm = bench.headline_params(n // 2)
    mm = meshes[2]
    s = M.init_sharded_state(n, mm)
    if mm.rank == 0:
        s = s._replace(down_age=s.down_age.clone())
        s.down_age[:MESH_CRASHED] = 0
    M.reset_collectives()
    s, ms = _wall_ms(torch, lambda: M.make_multidc_run(pm, rounds, mm)(
        s, prng.key(52, dev)))
    out["multidc"] = {"ms_per_round": ms / rounds, **_coll_report(M),
                      "state": M.gather_state(s, mm)}
    del s
    # (c) the cut: rounds 0..cut of the stale_k 4 run, saved by rank 0
    lead, lv = M.make_sharded_run(p, cut, mesh, carry=True)(
        M.init_sharded_state(n, mesh), key)
    snap = ck.snapshot_mesh(p, key, lead, mesh, total_rounds=rounds,
                            lanes=lv)
    out["ckpt"] = None if snap is None else ck.save(root, snap)
    del lead
    # (e) the views' exchanges, from the same keys
    pv = SimParams(n=views_n, loss=0.10, fail_per_round=0.005)
    runs = {}
    for ex in ("all_to_all", "pmax"):
        rnd, init = V.make_sharded_views_round(pv, mesh, exchange=ex)
        st, k = init(), prng.key(61, dev)
        M.reset_collectives()
        t0 = time.perf_counter()
        for _ in range(VIEWS_SHARDED_ROUNDS):
            k, kk = prng.split(k, 2)
            st = rnd(st, kk)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        runs[ex] = (st, (time.perf_counter() - t0) * 1e3
                    / VIEWS_SHARDED_ROUNDS, _coll_report(M))
    (a, a_ms, a_coll), (b, b_ms, b_coll) = runs.values()
    out["views"] = {
        "diffs": {f: int((x != y).sum()) for f, x, y in zip(
            V.ViewState._fields, a, b) if f != "stats"
            and bool((x != y).any())},
        "stats_equal": all(bool(x == y) for x, y in zip(a.stats, b.stats)),
        "round": int(a.round), "refutes": int(a.stats.refutes),
        "susp_incidents": int(a.stats.susp_incidents),
        "all_to_all_ms_per_round": a_ms, "pmax_ms_per_round": b_ms,
        "all_to_all": a_coll, "pmax": b_coll}
    return out


def mesh_nccl(torch, m, n=N, rounds=MESH_ROUNDS, backend="nccl",
              device="cuda"):
    """(a) a world of 1 on NCCL at n nodes."""
    (res,), ms = _wall_ms(torch, lambda: m.mesh.launch(
        1, _mesh_nccl_rank, backend=backend, device=device,
        args=(n, rounds)))
    bad = []
    for name, r in res.items():
        want = {"all_reduce_sum": r["windows_plus_init"]}
        if r["diffs"] or r["counts"] != want:
            bad.append(f"nccl {name}: diffs {r['diffs']}, collectives "
                       f"{r['counts']} (want {want})")
    return {"n": n, "rounds": rounds, "launch_wall_s": ms / 1e3,
            "runs": res}, bad


def mesh_gloo(torch, m, dev, root, n=N, rounds=MESH_ROUNDS, cut=MESH_CUT,
              views_n=VIEWS_N):
    """(b) gloo world 2 on the one card at n nodes, dc 1 and 2 and the
    per-DC pools; (c) the mesh -> one-device restore; (e) the sharded
    views' exchanges."""
    ranks, ms = _wall_ms(torch, lambda: m.mesh.launch(
        2, _mesh_gloo_rank, backend="gloo", device=torch.device(dev).type,
        args=(n, rounds, cut, root, views_n)))
    r0, bad = ranks[0], []
    key = m.prng.key(51, dev)
    p = m.bench.diag_params(n).with_(stale_k=4)
    want, lane_ms = _wall_ms(torch, lambda: m.round.make_run_rounds_lanes(
        p, rounds)(m.state.init_state(n, device=dev), key))
    host = m.state.to_numpy(want)
    out = {"n": n, "rounds": rounds, "launch_wall_s": ms / 1e3,
           "lanes_ms_per_round": lane_ms / rounds}
    for dc in (1, 2):
        r = r0[f"dc={dc}"]
        diffs = _np_diffs(host, r["state"])
        windows = m.bench.mesh_windows(rounds, 4, False)
        if diffs or r["counts"] != {"all_reduce_sum": windows}:
            bad.append(f"gloo dc={dc}: diffs {diffs}, collectives "
                       f"{r['counts']}")
        out[f"dc={dc}"] = {k: v for k, v in r.items() if k != "state"}
    # per-DC pools: DC 0 alone is the single-device engine on n/2 nodes
    pm = m.bench.headline_params(n // 2)
    s0 = m.state.init_state(n // 2, device=dev)
    s0.down_age[:MESH_CRASHED] = 0
    dc0 = m.state.to_numpy(m.round.make_run_rounds_lanes(pm, rounds)(
        s0, m.prng.key(52, dev)))
    whole = r0["multidc"]["state"]
    half = n // 2
    dc0_diffs = _np_diffs(dc0, whole, rows=slice(0, half))
    dead0 = int((whole.status[:half] == m.state.DEAD).sum())
    dead1 = int((whole.status[half:] == m.state.DEAD).sum())
    down1 = int((whole.down_age[half:] >= 0).sum())
    mcounts = r0["multidc"]["counts"]
    if mcounts != {"all_reduce_sum": 2 + rounds}:
        bad.append(f"multidc: collectives {mcounts}")
    if dc0_diffs or dead0 != MESH_CRASHED or dead1 or down1:
        bad.append(f"multidc: DC 0 vs one device {dc0_diffs}, DC 0 dead "
                   f"{dead0} (want {MESH_CRASHED}), DC 1 dead {dead1}, "
                   f"down {down1}")
    out["multidc"] = {"per_dc": half, "dc0_bitwise_single_device":
                      not dc0_diffs, "dc0_dead": dead0, "dc1_dead": dead1,
                      **{k: v for k, v in r0["multidc"].items()
                         if k != "state"}}
    # (c) restore the mesh cut on one device and finish
    snap = m.checkpoint.load(r0["ckpt"], p=p)
    fin, _ = m.round.make_run_rounds_lanes(p, rounds - cut, carry=True)(
        snap.state(dev), snap.key(dev), lanes0=snap.lanes(dev))
    cdiffs = _state_diffs(torch, want, fin)
    if snap.round_cursor != cut or cdiffs:
        bad.append(f"mesh cut at {snap.round_cursor}: resumed on one "
                   f"device differs {cdiffs}")
    out["restore"] = {"cut": snap.round_cursor, "world": 2,
                      "bitwise": not cdiffs,
                      "file_bytes": os.path.getsize(r0["ckpt"])}
    v = r0["views"]
    if v["diffs"] or not v["stats_equal"] or \
            v["round"] != VIEWS_SHARDED_ROUNDS:
        bad.append(f"sharded views: all_to_all and pmax differ {v}")
    out["views"] = v
    return out, bad


def _np_diffs(want, got, rows=slice(None)) -> dict:
    """Per-field count of differing elements of numpy states (``rows``
    of ``got``'s node arrays); stats compared unless rows are cut."""
    out = {}
    for f in want._fields:
        if f == "stats":
            if rows == slice(None):
                out.update({g: 1 for g, x, y in zip(
                    want.stats._fields, want.stats, got.stats) if x != y})
            continue
        y = getattr(got, f)
        y = y[rows] if y.ndim else y
        x = getattr(want, f)
        if x.dtype != y.dtype or x.shape != y.shape:
            out[f] = -1
        elif (x != y).any():
            out[f] = int((x != y).sum())
    return out


def views_single(torch, m, dev, n=VIEWS_N, rounds=VIEWS_ROUNDS):
    """(d) the dense tier on the card: quiet, crashes, partition and
    heal, with wall and profiler-busy time per round and peak memory."""
    V = m.views
    p = m.params.SimParams(n=n, loss=0.01)
    quiet, crash_r, part_r = rounds
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    st, wall = _wall_ms(torch, lambda: V.run_views(
        V.init_views(n, device=dev), m.prng.key(71, dev), p, quiet))
    out, bad = {"n": n, "quiet": V.view_metrics(st)}, []
    if out["quiet"]["fp_rate"] or out["quiet"]["view_divergence"]:
        bad.append(f"views quiet: {out['quiet']}")
    up = st.up.clone()
    up[:VIEWS_CRASHED] = False
    down = st.down_round.clone()
    down[:VIEWS_CRASHED] = st.round
    st, ms = _wall_ms(torch, lambda: V.run_views(
        st._replace(up=up, down_round=down), m.prng.key(72, dev), p,
        crash_r))
    wall += ms
    out["crashed"] = V.view_metrics(st)
    if out["crashed"]["detected_frac"] != 1.0 or out["crashed"]["fp_rate"]:
        bad.append(f"views crash: {out['crashed']}")
    st = V.init_views(n, device=dev)._replace(
        reach=V.partition_reach(n, n // 2, dev))
    st, ms = _wall_ms(torch, lambda: V.run_views(st, m.prng.key(73, dev),
                                                 p, part_r))
    wall += ms
    out["partitioned"] = V.view_metrics(st)
    st = st._replace(reach=torch.ones_like(st.reach))
    heal, key = 0, m.prng.key(74, dev)
    while heal < VIEWS_HEAL_MAX:
        st, ms = _wall_ms(torch, lambda: V.run_views(
            st, m.prng.fold_in(key, heal), p, VIEWS_HEAL_CHUNK))
        wall += ms
        heal += VIEWS_HEAL_CHUNK
        if V.view_metrics(st)["view_divergence"] == 0.0:
            break
    out["healed"] = V.view_metrics(st)
    out["heal_rounds"] = heal
    if out["healed"]["view_divergence"] or out["healed"]["fp_rate"]:
        bad.append(f"views heal after {heal} rounds: {out['healed']}")
    rounds = quiet + crash_r + part_r + heal
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated() \
        if on_card else None
    out["wall_ms_per_round"] = wall / rounds
    _, prof = m.bench.profile_call(lambda: V.run_views(
        st, m.prng.key(75, dev), p, VIEWS_PROFILE_ROUNDS),
        VIEWS_PROFILE_ROUNDS, torch.device(dev))
    out["profiled"] = {
        "rounds": VIEWS_PROFILE_ROUNDS,
        "wall_us_per_round": prof["wall_us_per_round"],
        "device_busy_us_per_round": prof.get("device_busy_us", 0.0)
        / VIEWS_PROFILE_ROUNDS,
        "kernels_per_round": prof["kernels_per_round"],
        "device_us_per_round_top": dict(list(prof.get(
            "device_us_per_round_by_kernel", {}).items())[:6])}
    return out, bad


def phase_mesh(torch, m, dev, root):
    """The sharded lane engine, the mesh restore and the views tier,
    each part timed on its own; files under ``root``. Launches no
    kernel: every part is plain PyTorch."""
    cr = m.cuda_round
    cr.reset_launches()
    out, bad = {}, []
    for name, fn in (("nccl", lambda: mesh_nccl(torch, m)),
                     ("gloo", lambda: mesh_gloo(torch, m, dev, root)),
                     ("views", lambda: views_single(torch, m, dev))):
        (res, b), ms = _wall_ms(torch, fn)
        res["wall_s"] = ms / 1e3
        out[name], bad = res, bad + b
        print(f"mesh: {name} {ms / 1e3:.1f} s", file=sys.stderr, flush=True)
    rows, ms = _wall_ms(torch, lambda: m.graft_entry.dryrun_multichip(2))
    out["dryrun"] = {"ranks": rows, "wall_s": ms / 1e3}
    if [r["views_rounds"] for r in rows] != [2, 2]:
        bad.append(f"dryrun_multichip(2): {rows}")
    if any(cr.LAUNCHES.values()):
        bad.append(f"mesh: launched kernels {dict(cr.LAUNCHES)} on a "
                   "plain-PyTorch path")
    if bad:
        raise SmokeFailure("mesh: " + "; ".join(bad))
    emit({"phase": "mesh", "nvidia_smi": nvidia_smi(), **out})


#: the CLI's default mode runs the agent's dev gossip timing with TCP
#: fallback on and no slow-node model, where the reference reports no
#: suspicion at all (0 at 4,096 and 65,536 nodes, CPU); FD_REF is the
#: diagnostic configuration's (TCP fallback off, slow nodes on). Its
#: suspicions and refutes per node-round must stay under this share of
#: FD_REF's, with no false positive
CLI_FD_CEILING = 0.01
SEAMS_CHAOS = "churn_burst"
SEAMS_TWIN_CHUNK = 8
SEAMS_TRACE = (64, 20)
#: the counters the flight publisher sums into sim.<counter>
REPORT_COUNTERS = ("false_positives", "refutes", "suspicions",
                   "true_deaths_declared", "crashes", "rejoins", "leaves")


def cli_report(m, argv) -> tuple:
    """``cli.main(argv)`` in this process: (exit code, its JSON report)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = m.cli.main(argv)
    text = buf.getvalue()
    if text.startswith("==>"):
        text = text.split("\n", 1)[1]
    return rc, json.loads(text)


def _platform(torch, dev) -> str:
    return "gpu" if torch.device(dev).type == "cuda" else "cpu"


def seams_cli(torch, m, dev, n=N):
    """(a) the CLI's default mode through ``cli.main`` at n nodes: 100
    full round launches and 100 ``flight_row`` launches, no false
    positive, suspicions and refutes under
    ``CLI_FD_CEILING`` of FD_REF, and the registry's ``sim.<counter>``
    totals and ``sim.fd.*`` gauges equal to the report. Returns (report,
    failures, launches); on the CPU the wrappers launch nothing."""
    cr, reg = m.cuda_round, m.telemetry.default
    reg.reset()
    cr.reset_launches()
    t0 = time.perf_counter()
    rc, rep = cli_report(m, ["agent", "-dev", "-gossip-sim",
                             _platform(torch, dev), "-gossip-sim-nodes",
                             str(n)])
    wall_s = time.perf_counter() - t0
    launches = dict(cr.LAUNCHES)
    if rc != 0 or "gossip_sim_error" in rep:
        return {"rc": rc, **rep}, [f"cli default mode: rc {rc}, {rep}"], \
            launches
    bad = []
    on_card = torch.device(dev).type == "cuda"
    want = {"round_kernel/full": m.cli.SIM_ROUNDS,
            "flight_row": m.cli.SIM_ROUNDS} if on_card else {}
    if launches != want:
        bad.append(f"cli default mode launched {launches}, expected {want}")
    node_rounds = n * rep["rounds"]
    rates = {f"{k}_per_node_round": rep[k] / node_rounds
             for k in ("suspicions", "refutes")}
    if rep["false_positives"] or rep["rounds"] != m.cli.SIM_ROUNDS \
            or any(v > CLI_FD_CEILING * FD_REF[k] for k, v in rates.items()):
        bad.append(f"cli default mode FD quality: {rep} ({rates})")
    snap = reg.snapshot()
    counters = {c["Name"]: c["Count"] for c in snap["Counters"]}
    gauges = {g["Name"]: g["Value"] for g in snap["Gauges"]}
    pre = f"{reg.prefix}.sim."
    off = {k: (counters.get(pre + k, 0.0), rep[k]) for k in REPORT_COUNTERS
           if counters.get(pre + k, 0.0) != rep[k]}
    off.update({k: (gauges.get(f"{pre}fd.{k}"), v) for k, v in rep.items()
                if k != "rounds_per_sec" and gauges.get(f"{pre}fd.{k}")
                != float(v)})
    if off:
        bad.append(f"cli registry differs from the report: {off}")
    return {"n": n, "wall_s": wall_s, "report": rep, **rates,
            "registry_counters": {k: v for k, v in counters.items()
                                  if k.startswith(pre)},
            "launches": launches}, bad, launches


def seams_chaos(torch, m, dev, n=N, name=SEAMS_CHAOS):
    """(b) the CLI's chaos mode on one honest class: its signature
    (``class_failures``) and one fault launch and one flight row a
    round."""
    cr = m.cuda_round
    cr.reset_launches()
    t0 = time.perf_counter()
    rc, rep = cli_report(m, ["agent", "-dev", "-gossip-sim",
                             _platform(torch, dev), "-gossip-sim-nodes",
                             str(n), "-gossip-sim-chaos", name])
    wall_s = time.perf_counter() - t0
    launches = dict(cr.LAUNCHES)
    if rc != 0 or "gossip_sim_error" in rep:
        return {"rc": rc, **rep}, [f"cli chaos mode: rc {rc}, {rep}"], \
            launches
    want = {"round_kernel/fault": rep["rounds"],
            "frame/in_place": rep["rounds"],
            "flight_row": rep["rounds"]} \
        if torch.device(dev).type == "cuda" else {}
    bad = class_failures(name, rep)
    if launches != want:
        bad.append(f"cli chaos mode launched {launches}, expected {want}")
    rep.pop("flight", None)
    return {"class": name, "wall_s": wall_s, "report": rep,
            "launches": launches}, bad, launches


def seams_twin(torch, m, dev, root, n=N, chunk=SEAMS_TWIN_CHUNK):
    """(c) the twin's sim half (``twin.SimHalf``) on the full soak plan
    at n nodes in chunks of ``chunk``, checkpointed under ``root``, with
    the per-chunk host copy of the three lanes the provider reads (the
    set-up — ``compile_plan`` and the state — and each chunk's wall,
    rounds, save and copy, timed apart); then
    ``resume_digest_proof`` from the mid cut. One fault launch per round
    of the soak and of the proof's rerun. No agent is built here."""
    tw, cr = m.twin, m.cuda_round
    plan = tw.twin_plan(n)
    rounds = plan.total_rounds
    d = os.path.join(root, "twin")
    cr.reset_launches()
    t0 = time.perf_counter()
    sim = tw.SimHalf(n, plan, seed=0, chunk=chunk, ckpt_dir=d, device=dev)
    setup_s = time.perf_counter() - t0
    prev = tw.host_lanes(sim.state)
    host_ms, moved, chunk_ms = [], [], []
    t1 = time.perf_counter()
    for _, state in sim.chunks():
        t2 = time.perf_counter()
        lanes = tw.host_lanes(state)
        host_ms.append((time.perf_counter() - t2) * 1e3)
        chunk_ms.append((time.perf_counter() - t1) * 1e3)
        moved.append(int(((lanes[0] != prev[0]) |
                          (lanes[1] != prev[1])).sum()))
        prev = lanes
        t1 = time.perf_counter()
    sim_wall_s = time.perf_counter() - t0
    digest = tw._state_digest(sim.state)
    t2 = time.perf_counter()
    proof = tw.resume_digest_proof(sim.mid_cut(), sim.p, sim.cp, digest,
                                   device=dev)
    proof_s = time.perf_counter() - t2
    launches = dict(cr.LAUNCHES)
    after_mid = rounds - sim.mid_cursor
    want = {"round_kernel/fault": rounds + after_mid,
            "frame/in_place": rounds + after_mid} \
        if torch.device(dev).type == "cuda" else {}
    st = sim.state.stats
    stats = {f: int(getattr(st, f)) for f in
             ("crashes", "rejoins", "false_positives", "refutes")}
    bad = []
    if launches != want:
        bad.append(f"twin sim half launched {launches}, expected {want}")
    if not proof or sim.cursor != rounds or stats["crashes"] <= 0:
        bad.append(f"twin sim half: resume proof {proof}, cursor "
                   f"{sim.cursor}/{rounds}, stats {stats}")
    files = sorted(f for f in os.listdir(d) if f.endswith(".ckpt"))
    return {"n": n, "rounds": rounds, "chunk": chunk,
            "mid_cursor": sim.mid_cursor, "sim_wall_s": sim_wall_s,
            "setup_s": setup_s, "chunk_ms": chunk_ms,
            "host_copy_ms": host_ms, "transitions_per_chunk": moved,
            "file_bytes": os.path.getsize(os.path.join(d, files[-1])),
            "files": files, "resume_digest_equal": proof,
            "resume_s": proof_s, "sim_digest": digest,
            "plan_digest": sim.plan_digest, "sim_stats": stats,
            "agent": "not built: the agent half (consul_tpu.agent on an "
                     "in-memory network) is the control plane's",
            "launches": launches}, bad, launches


def seams_entry(torch, m, dev):
    """(d) ``graft_entry.entry()``: one live-engine round at 65,536
    nodes (plain PyTorch: no kernel launch)."""
    cr = m.cuda_round
    cr.reset_launches()
    fn, (state, key) = m.graft_entry.entry(device=dev)
    t0 = time.perf_counter()
    out = fn(state, key)
    rep = {"n": int(out.status.shape[0]), "round_idx": int(out.round_idx),
           "wall_s": time.perf_counter() - t0,
           "informed_finite": bool(torch.isfinite(out.informed).all())}
    bad = [] if (rep["round_idx"] == 1 and rep["informed_finite"]
                 and rep["n"] == m.graft_entry.ENTRY_N
                 and not cr.LAUNCHES) else [f"graft entry: {rep}, "
                                            f"launches {dict(cr.LAUNCHES)}"]
    return rep, bad, {}


def seams_trace(torch, m, dev, nodes=SEAMS_TRACE[0], rounds=SEAMS_TRACE[1]):
    """(e) ``cli.capture_flight_trace`` on the device: its columns, one
    finite row a round and the black box's tracked sample."""
    cr = m.cuda_round
    cr.reset_launches()
    cap = m.cli.capture_flight_trace(nodes, rounds, device=dev)
    rows = cap["rows"]
    rep = {"n": nodes, "rounds": rounds, "columns": len(cap["columns"]),
           "rows": len(rows), "tracked": cap["blackbox"]["tracked"],
           "events": cap["blackbox"]["events"]}
    ok = (cap["columns"] == list(m.flight.FLIGHT_COLUMNS)
          and len(rows) == rounds
          and all(len(r) == len(cap["columns"]) for r in rows)
          and all(math.isfinite(x) for r in rows for x in r)
          and rep["tracked"] == min(m.params.SimParams(n=nodes).blackbox_k,
                                    nodes)
          and not cr.LAUNCHES)
    return rep, [] if ok else [f"flight trace capture: {rep}"], {}


def phase_seams(torch, m, dev, root):
    """The entry points and seams, each part counted on its own."""
    out, bad, launches = {}, [], {}
    for name, part in (
            ("cli", lambda: seams_cli(torch, m, dev)),
            ("chaos", lambda: seams_chaos(torch, m, dev)),
            ("twin", lambda: seams_twin(torch, m, dev, root)),
            ("entry", lambda: seams_entry(torch, m, dev)),
            ("trace", lambda: seams_trace(torch, m, dev))):
        t0 = time.perf_counter()
        out[name], b, got = part()
        bad += b
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        print(f"seams: {name} {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    if bad:
        raise SmokeFailure("seams: " + "; ".join(bad))
    emit({"phase": "seams", "nvidia_smi": nvidia_smi(), **out,
          "launches": launches})
    return launches


GRAPH_CALL_ROUNDS = (48, 512)
GRAPH_REPS = 3
GRAPH_LANE_ROUNDS, GRAPH_LANE_K = 8, 4
GRAPH_GRID_ROUNDS = 2
GRAPH_TWIN_WARM = 5
GRAPH_TRACE_TOP = 12


def _tensor_leaves(torch, out) -> list:
    from torch.utils._pytree import tree_flatten
    return [x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]


def _bit_diffs(torch, a, b) -> list:
    """Indices of the output leaves that differ in dtype, shape or bits."""
    la, lb = _tensor_leaves(torch, a), _tensor_leaves(torch, b)
    if len(la) != len(lb):
        return [f"{len(la)} leaves against {len(lb)}"]
    return [i for i, (x, y) in enumerate(zip(la, lb))
            if x.dtype != y.dtype or x.shape != y.shape
            or not torch.equal(x, y)]


def _timed_call(torch, m, dev, prep, call) -> tuple:
    """One call on fresh inputs (made outside the clock), ending in a
    sync: (its outputs, wall ms)."""
    args = prep()
    m.bench._sync(torch.device(dev))
    t0 = time.perf_counter()
    out = call(*args)
    m.bench._sync(torch.device(dev))
    return out, (time.perf_counter() - t0) * 1e3


def graph_pair(torch, m, dev, label, prep, call, rounds, cache=None,
               profile=True) -> tuple:
    """The captured runner ``call`` beside its explicit eager run on the
    same inputs (``prep()`` makes fresh ones). On the default path a
    key's first call runs eagerly and its second is the capture: the
    second call and the first replay-only call are compared with the
    eager run, bits of every output and launch counts. Wall ms a call
    (the first two apart), per round, the device's busy share of each,
    the capture's ms and pool bytes (``profile=False`` leaves out the
    busy shares). Launches count the round kernels and the draw and sum
    kernels. Returns (report, failures, captured launches)."""
    cr, g = m.cuda_round, m.graphs

    mark = {}

    def reset():
        # the draw and sum kernels' counts are read as differences: the
        # script totals them over its phases
        cr.reset_launches()
        mark.clear()
        mark.update(_fused_counts(m))

    def counts():
        return {**cr.LAUNCHES, **_count_delta(_fused_counts(m), mark)}

    reset()
    with g.eager():
        want, eager_first = _timed_call(torch, m, dev, prep, call)
    eager_launches = counts()
    _, first = _timed_call(torch, m, dev, prep, call)
    reset()
    got, second = _timed_call(torch, m, dev, prep, call)
    launches = counts()
    diffs = _bit_diffs(torch, want, got)
    del got
    eager_ms, graph_ms, replay_launches = [], [], None
    for i in range(GRAPH_REPS):
        with g.eager():
            eager_ms.append(_timed_call(torch, m, dev, prep, call)[1])
        reset()
        out, ms = _timed_call(torch, m, dev, prep, call)
        graph_ms.append(ms)
        if i == 0:
            replay_launches = counts()
            diffs += [f"replay {d}" for d in _bit_diffs(torch, want, out)]
        del out
    del want
    busy = {"eager": {}, "captured": {}}
    for name, ctx in (("eager", g.eager), ("captured",
                                           contextlib.nullcontext)):
        if not profile:
            break
        args = prep()
        with ctx():
            _, prof = m.bench.profile_call(lambda: call(*args), rounds,
                                           torch.device(dev))
        busy[name] = {k: prof.get(k) for k in
                      ("busy_share", "device_busy_us", "kernels_per_round",
                       "wall_us_per_round")}
    eager_med = sorted(eager_ms)[GRAPH_REPS // 2]
    graph_med = sorted(graph_ms)[GRAPH_REPS // 2]
    rep = {"rounds": rounds, "bit_diffs": diffs,
           "launches": launches, "eager_launches": eager_launches,
           "eager": {"first_call_ms": eager_first, "ms_per_call": eager_ms,
                     "us_per_round": eager_med / rounds * 1e3,
                     **busy["eager"]},
           "captured": {"first_call_ms": first, "second_call_ms": second,
                        "ms_per_call": graph_ms,
                        "us_per_round": graph_med / rounds * 1e3,
                        **busy["captured"]}}
    if cache is not None:
        rep["captured"]["graphs"] = cache.stats()
    bad = []
    if diffs:
        bad.append(f"{label}: captured outputs differ from the eager "
                   f"run's in leaves {diffs}")
    for which, got_l in (("captured", launches), ("replayed",
                                                  replay_launches)):
        if got_l != eager_launches:
            bad.append(f"{label}: {which} launches {got_l}, eager "
                       f"{eager_launches}")
    return rep, bad, launches


def eager_call_trace(torch, m, dev, n=N,
                     rounds=GRAPH_CALL_ROUNDS[0]) -> dict:
    """Where an eager 48-round call of the per-round runner spends its
    host time: ``torch.profiler`` over one call at 1,048,576 nodes (the
    profiler's own cost inflates it), the ops with the most self CPU
    time and the CUDA runtime calls, beside the untraced call's wall."""
    from torch.profiler import ProfilerActivity, profile

    run = m.cuda_round.make_run_rounds_cuda(m.bench.headline_params(n),
                                            rounds)
    key = m.prng.key(41, device=dev)
    state = m.state.init_state(n, device=dev)
    with m.graphs.eager():
        run(state, key)
        m.bench._sync(torch.device(dev))
        t0 = time.perf_counter()
        run(state, m.prng.fold_in(key, 1))
        m.bench._sync(torch.device(dev))
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(state, m.prng.fold_in(key, 2))
            m.bench._sync(torch.device(dev))
            traced = (time.perf_counter() - t0) * 1e3
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"rounds": rounds, "wall_ms": wall, "traced_wall_ms": traced,
            "host_self_ms_by_op": {
                e.key: {"self_ms": e.self_cpu_time_total / 1e3,
                        "count": e.count}
                for e in rows[:GRAPH_TRACE_TOP]}}


def graph_cases(torch, m, dev, n=N, call_rounds=GRAPH_CALL_ROUNDS,
                grid_n=None) -> list:
    """(label, prep, call, rounds, cache) of each captured runner the
    phase holds against its eager run, at ``n`` nodes (the grid at the
    sweep bench's size unless ``grid_n``)."""
    b, cr, key = m.bench, m.cuda_round, m.prng.key(43, device=dev)
    cases = []
    for R in (1, MEGA_R):
        for rounds in call_rounds:
            run = cr.make_run_rounds_cuda(b.headline_params(n), rounds,
                                          rounds_per_call=R)
            s0 = m.state.init_state(n, device=dev)

            def prep(s0=s0):
                return b.clone_state(s0), key

            cases.append((f"kernel R={R} x{rounds}", prep, run, rounds,
                          run.graphs))
    p_diag = b.diag_params(n)
    rec = cr.make_run_rounds_cuda(p_diag, call_rounds[0], flight_every=4,
                                  blackbox=True)
    tracked = m.blackbox.default_tracked(n, p_diag.blackbox_k, dev)
    s0 = m.state.init_state(n, device=dev)
    cases.append((f"kernel R=1 x{call_rounds[0]} flight+blackbox",
                  lambda: (b.clone_state(s0), key),
                  lambda s, k: rec(s, k, tracked=tracked),
                  call_rounds[0], rec.graphs))
    p_cli = m.params.SimParams.from_gossip_config(
        m.config.GossipConfig.local(), n=n, loss=0.01)
    cases.append(("cli default mode", lambda: (), lambda: m.cli.default_run(
        p_cli, dev), m.cli.SIM_ROUNDS, None))
    tw = m.twin
    sim = tw.SimHalf(n, tw.twin_plan(n), seed=0, chunk=SEAMS_TWIN_CHUNK,
                     device=dev)
    for _, _ in zip(range(GRAPH_TWIN_WARM), sim.chunks()):
        pass
    twin_run = sim._runner(SEAMS_TWIN_CHUNK)
    ts, tsc = b.clone_state(sim.state), sim.scalars.clone()
    cases.append((f"twin sim half chunk at round {sim.cursor}",
                  lambda: (b.clone_state(ts), sim.key, tsc.clone()),
                  lambda s, k, sc: twin_run(s, k, scalars0=sc),
                  SEAMS_TWIN_CHUNK, twin_run.graphs))
    live = m.round.make_run_rounds(p_diag, GRAPH_LANE_ROUNDS)
    cases.append(("live engine", lambda: (b.clone_state(s0), key), live,
                  GRAPH_LANE_ROUNDS, live.graphs))
    lane = m.round.make_run_rounds_lanes(
        p_diag.with_(stale_k=GRAPH_LANE_K), GRAPH_LANE_ROUNDS,
        flight_every=GRAPH_LANE_K, carry=True)
    cases.append((f"lane engine stale_k={GRAPH_LANE_K}",
                  lambda: (b.clone_state(s0), key), lane,
                  GRAPH_LANE_ROUNDS, lane.graphs))
    n_grid = grid_n or b.SWEEP_SIZE[0]
    p_grid = m.scenarios.autotune_params("lan", n_grid)
    tp, _ = m.params.grid_params(
        p_grid, m.params.SweepAxes.of(**b.AUTOTUNE_GRID), dev)
    for engine in ("xla", "lanes"):
        grid = m.sweep.make_run_sweep(p_grid, GRAPH_GRID_ROUNDS,
                                      engine=engine, device=dev)
        cases.append((f"grid round {engine} {tp.grid_shape[0]} x {n_grid}",
                      lambda: (tp, key), grid, GRAPH_GRID_ROUNDS,
                      grid.graphs))
    return cases


def graphs_parts(torch, m, dev, profile=True, **sizes) -> tuple:
    """The phase's parts at ``sizes`` (``graph_cases``' keywords), with
    or without the busy shares: (report, failures, captured
    launches)."""
    out, bad, launches = {}, [], {}
    out["eager_call_trace"] = eager_call_trace(
        torch, m, dev, n=sizes.get("n", N),
        rounds=sizes.get("call_rounds", GRAPH_CALL_ROUNDS)[0])
    for label, prep, call, rounds, cache in graph_cases(torch, m, dev,
                                                        **sizes):
        t1 = time.perf_counter()
        out[label], b, got = graph_pair(torch, m, dev, label, prep, call,
                                        rounds, cache, profile=profile)
        bad += b
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        print(f"graphs: {label} {time.perf_counter() - t1:.1f} s",
              file=sys.stderr, flush=True)
    return out, bad, launches


def phase_graphs(torch, m, dev):
    """Every captured runner beside its eager run at 1,048,576 nodes."""
    t0 = time.perf_counter()
    out, bad, launches = graphs_parts(torch, m, dev)
    if bad:
        raise SmokeFailure("graphs: " + "; ".join(bad))
    emit({"phase": "graphs", "n": N, "nvidia_smi": nvidia_smi(),
          "phase_s": time.perf_counter() - t0, **out,
          "launches": launches})
    return launches


# ------------------------------------------------------------- draws

#: the draws phase's sizes: words a draw, key stacks, row lengths
DRAW_WORDS = (1, 2, 3, 255, 65_536, 1_048_576, 16_777_216)
DRAW_STACKS = (1, 5, 4096)
SUM_LENGTHS = (1, 2, 3, 7, 1_000_003, 1_048_576)
#: the sum kernel's plan edges, (rows, length): the flight means' [5, 1M]
#: (64 CTAs a row), a last CTA that owns the carrying last position alone
#: (278,529: scalar) or one float4 group (86,016), the lengths on both
#: sides of a row's cut (32,752: one CTA; 32,753: two), the rows on both
#: sides of fused.ROWS_ALONE (263 rows of 32,768: two CTAs a row; 264:
#: one), odd steps (65,540: scalar loads), a CTA's shared memory beyond
#: 48 KB (2^24), short rows packed 16 and 1,000 to a CTA with a last CTA
#: that packs fewer
SUM_EDGES = ((5, 1_048_576), (1, 278_529), (1, 86_016), (3, 32_752),
             (3, 32_753), (263, 32_768), (264, 32_768), (3, 65_540),
             (1, 16_777_216), (4097, 1024), (1001, 7))
#: the engines held kernels against plain: lane-engine rounds, views
#: rounds at 4,096, the kernel runner's (R, rounds) calls, grid rounds
DRAWS_LANE_ROUNDS = 16
DRAWS_VIEWS_ROUNDS = 40
DRAWS_RUNNER_CALLS = ((1, 48), (1, 512), (8, 48))
#: the live engine's rounds, and both engines' on the byzantine check
#: plan (2 warm rounds, 8 of attack, 2 after)
DRAWS_LIVE_ROUNDS = 8
DRAWS_PLAN_ROUNDS = 12
#: a value past 2^32 - 1 for the wrapping offsets
WRAP = 2**32 - 1000
#: the draw and sum kernels, by their launch counters' names
DRAW_KERNELS = ("threefry/words", "threefry/xor", "threefry/seeds",
                "threefry/uniform", "threefry/u01_global", "tree_sum")
#: the live period's three stages (``live_kernel.NAMES``)
LIVE_KERNELS = ("live_round/a", "live_round/b", "live_round/c")
#: the slot sets the engines draw (round.draw_slots): the headline
#: config's, the full model's (slow), a churn model's, a fault frame's
#: with the slow model, a byzantine frame's (the replay slot), all six
SLOT_SETS = ((2, 3, 4), (1, 2, 3, 4), (0, 1, 2, 3, 4), (0, 2, 3, 4, 5),
             (0, 1, 2, 3, 4, 5))
#: the full model's slots: the lane and live engines' round in the
#: draws timing
ROUND_SLOTS = SLOT_SETS[1]
#: the words of the draw past the 32-bit index path (2^31 words less
#: the grid's room): u01_global held by slices
WIDE_WORDS = 2**31 + 5
#: the threefry launches of one call of each draws-phase engine at
#: PR 13, (launches, rounds), from its chip run's draws phase (the live
#: engine's from its graphs phase, the same config and rounds)
PR13_THREEFRY = {
    "lane engine stale_k=4 x16": (81, 16),
    f"live engine x{DRAWS_LIVE_ROUNDS}": (41, DRAWS_LIVE_ROUNDS),
    "grid round xla 64 x 65536": (6, 1),
    "grid round lanes 64 x 65536": (6, 1),
    "views 4096 x40": (524, 40),
    "kernel runner R=1 x48": (2, 48),
    "kernel runner R=1 x512": (2, 512),
    "kernel runner R=8 x48": (2, 48),
    "coordinate round": (7, 1)}


def _fused_counts(m) -> dict:
    return dict(m.fused.LAUNCHES)


def _count_delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _same_bits(torch, a, b) -> bool:
    la, lb = _tensor_leaves(torch, a), _tensor_leaves(torch, b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.view(torch.int32) if x.dtype == torch.float32 else x,
            y.view(torch.int32) if y.dtype == torch.float32 else y)
        for x, y in zip(la, lb))


def _sum_input(torch, shape, dev, seed):
    """f32 with magnitudes from 1e-30 to 1e30, -0.0 and +0.0 among them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, device=dev, generator=g)
    x *= 10.0 ** torch.randint(-30, 31, shape, device=dev, generator=g)
    x[..., ::3] = -0.0
    x[..., 1::7] = 0.0
    return x


def round_draws(fn, slots, *args) -> tuple:
    """A round's slot draws through ``fn`` (``prng.threefry_u01`` or
    ``global_u01`` on ``args``), each slot of ``slots`` read once; on a
    checkout whose ``fn`` takes no slot set (an older one that
    ``kernel_ab.py`` times) its lazy form."""
    if "slots" in inspect.signature(fn).parameters:
        u = fn(*args, slots)
    else:
        u = fn(*args)
    return tuple(u(s) for s in slots)


def draw_cases(torch, m, dev, words=DRAW_WORDS, stacks=DRAW_STACKS):
    """(label, call) of every draw the phase holds against its plain
    version: each mode at each size, key stacks, a wrapping offset, a
    ``fold_in`` on a data tensor, every bound kind of ``uniform``, and
    the keys derived in the launch: ``round_seeds``, each engine's slot
    set as one draw, ``SubKey`` draws and stacks, rows that start off a
    vector boundary."""
    P = m.prng
    k = P.key(17, device=dev)
    start = torch.tensor(WRAP, device=dev)
    cases = []
    for n in words:
        cases += [
            (f"words split x{n}", lambda n=n: P.split(k, n)),
            (f"xor bits x{n}", lambda n=n: P.bits(k, n)),
            (f"uniform x{n}", lambda n=n: P.uniform(k, n)),
            (f"u01_global x{n} from {WRAP}",
             lambda n=n: P.u01_global(k, WRAP, n)),
            (f"u01_global x{n} from a device offset",
             lambda n=n: P.u01_global(k, start, n))]
    for n in words[:5]:
        cases += [
            (f"words fold_in on data x{n}",
             lambda n=n: P.fold_in(k, torch.arange(n, device=dev) * 977)),
            (f"words round_keys x{n}",
             lambda n=n: P.round_keys(k, start, n)),
            (f"xor round_seeds x{n}",
             lambda n=n: P.round_seeds(k, start, n))]
    x0 = P.bits(P.fold_in(k, 1), words[4])
    x1 = P.bits(P.fold_in(k, 2), words[4])
    cases += [("words threefry2x32 on data",
               lambda: P.threefry2x32(k[0], k[1], x0, x1)),
              ("words fold_in x1", lambda: P.fold_in(k, 2**32 - 1))]
    per = words[-1] // stacks[-1]
    for s in stacks:
        ks = P.split(k, s)
        cases += [(f"words split of {s} keys", lambda ks=ks: P.split(ks, 3)),
                  (f"xor bits of {s} keys", lambda ks=ks: P.bits(ks)),
                  (f"uniform {s} keys x{per}",
                   lambda ks=ks: P.uniform(ks, per))]
    mid = words[-2]
    for lo, hi in ((1e-9, 1.0), (P._NORMAL_LO, 1.0), (-3.0, 5.5)):
        cases.append((f"uniform [{lo:g}, {hi:g}) x{mid}",
                      lambda lo=lo, hi=hi: P.uniform(k, mid, lo, hi)))
    side = int(round(words[-1] ** 0.5))
    cases += [(f"uniform [1e-09, 1) {side} x {side} (views)",
               lambda: P.uniform(k, (side, side), 1e-9, 1.0)),
              (f"normal x{mid}", lambda: P.normal(k, (mid,))),
              (f"exponential x{mid}", lambda: P.exponential(k, (mid,))),
              (f"randint x{mid}", lambda: P.randint(k, (mid,), 1, mid))]
    # keys derived in the launch: a round's slots as one draw's rows (at
    # a row length off a vector boundary too), SubKeys
    for n in (mid, words[4] + 3):
        for slots in SLOT_SETS:
            cases += [
                (f"uniform slots {slots} x{n}",
                 lambda n=n, s=slots: round_draws(P.threefry_u01, s, k, n)),
                (f"u01_global slots {slots} x{n} from {WRAP}",
                 lambda n=n, s=slots: round_draws(P.global_u01, s, k, WRAP,
                                                  n))]
    cases.append((f"u01_global slots {SLOT_SETS[-2]} x{mid} from a device "
                  "offset", lambda: round_draws(P.global_u01, SLOT_SETS[-2],
                                                k, start, mid)))
    sub = P.SubKey(k, P.COORD_FOLD)
    # a [5, 3] SubKey stack: the views' gossip chain's last level
    stack = P.SubKey(P.split(P.split(k, 5), 3), 2)
    cases += [(f"seeds round_seeds x{n}",
               lambda n=n: P.round_seeds(k, start, n))
              for n in (1, 3, words[4] + 1)]
    cases += [("words split of a SubKey", lambda: P.split(sub, 4)),
              ("words split of a SubKey stack", lambda: P.split(stack, 3)),
              ("words round_keys of a SubKey",
               lambda: P.round_keys(sub, start, 48)),
              (f"uniform of a SubKey x{mid}", lambda: P.uniform(sub, mid)),
              ("uniform of a SubKey stack [5, 3] x 255",
               lambda: P.uniform(stack, 255)),
              (f"uniform [1e-09, 1) of a SubKey stack [5, 3] x {mid}",
               lambda: P.uniform(stack, mid, 1e-9, 1.0)),
              ("u01_global of a SubKey x4099 from a device offset",
               lambda: P.u01_global(sub, start, 4099)),
              ("normal of a SubKey", lambda: P.normal(sub, (1001,))),
              ("randint of a SubKey x1001",
               lambda: P.randint(sub, (1001,), 1, 1001))]
    return cases


def wide_draw_check(torch, m, dev, words=WIDE_WORDS, piece=65_536,
                    offset=7) -> tuple:
    """A ``u01_global`` of ``words`` (at full size past the kernel's
    32-bit index path) held by slices at its start, middle and end
    against its plain version on those slices: node i draws the same
    value on any slice. (report, failures)"""
    P = m.prng
    k = P.key(19, device=dev)
    big = P.u01_global(k, offset, words)
    out, bad = {}, []
    for a in (0, words // 2, words - piece):
        with m.fused.plain():
            want = P.u01_global(k, offset + a, piece)
        same = _same_bits(torch, big[a:a + piece], want)
        out[f"u01_global x{words} [{a}:{a + piece}]"] = same
        if not same:
            bad.append(f"u01_global x{words}: words {a}.. differ from the "
                       "plain version")
    del big
    return out, bad


def sum_cases(torch, m, dev, lengths=SUM_LENGTHS, grid_l=65_536,
              lane_l=N, edges=SUM_EDGES):
    """(label, call) of every sum the phase holds against its plain
    version: each length alone and in 3 rows, the plan's ``edges``, a
    contiguous ``[4, grid_l]`` view whose base is not 16-byte aligned,
    the grid rows ``[K * 64, grid_l]``, the lane tables ``[K, 64]``, the
    lane engine's block partials of ``[K, lane_l]``, ``row_sums``."""
    L = m.lanes
    cases = []
    shapes = [(rows, n) for n in lengths for rows in (1, 3)] + list(edges)
    for rows, n in shapes:
        x = _sum_input(torch, (rows, n), dev, n + rows)
        cases.append((f"tree_sum [{rows}, {n}]", lambda x=x: L.tree_sum(x)))
    flat = _sum_input(torch, (1 + 4 * grid_l,), dev, 4)
    skew = flat[1:].view(4, grid_l)
    cases.append((f"tree_sum [4, {grid_l}] at a 4-byte offset",
                  lambda: L.tree_sum(skew)))
    grid = _sum_input(torch, (L.N_LANES * L.LANE_BLOCKS, grid_l), dev, 1)
    table = _sum_input(torch, (L.N_LANES, L.LANE_BLOCKS), dev, 2)
    stack = _sum_input(torch, (L.N_LANES, lane_l), dev, 3)
    stack[1] = -0.0
    cases += [(f"tree_sum grid rows {tuple(grid.shape)}",
               lambda: L.tree_sum(grid)),
              (f"tree_sum lane table {tuple(table.shape)}",
               lambda: L.tree_sum(table)),
              (f"block partials {tuple(stack.shape)}",
               lambda: L._block_partials(stack, L.LANE_BLOCKS)),
              ("row_sums", lambda: L.row_sums(stack[:4], stack[4:8]))]
    return cases


def kernel_checks(torch, m, dev, cases) -> tuple:
    """Each case on the kernels and inside ``fused.plain()``, bit for
    bit; (report, failures). The plain side must launch no kernel."""
    out, bad = {}, []
    for label, call in cases:
        got = call()
        before = _fused_counts(m)
        with m.fused.plain():
            want = call()
        if _fused_counts(m) != before:
            bad.append(f"{label}: plain() launched a kernel")
        same = _same_bits(torch, got, want)
        out[label] = same
        if not same:
            bad.append(f"{label}: the kernel differs from its plain version")
        del got, want
    return out, bad


def captured_draws(torch, m, dev, calls=4, words=4096, rows=3) -> tuple:
    """A body holding every draw mode and both sum kernels through
    ``graphs.GraphCache``, called with new keys, offsets and inputs: the
    first call eager, the second captured, the rest replayed; each equal
    to its eager run, launches equal. (report, failures)."""
    P, L, g = m.prng, m.lanes, m.graphs
    cache = g.GraphCache()

    def body(donated, key, offset, x):
        return (P.round_seeds(key, offset, 48), P.round_keys(key, offset, 5),
                P.u01_global(key, offset, words), P.uniform(key, words),
                P.bits(key, words), P.fold_in(key, offset),
                *round_draws(P.threefry_u01, SLOT_SETS[-1], key, words),
                *round_draws(P.global_u01, SLOT_SETS[-2], key, offset,
                             words),
                P.split(P.SubKey(key, 3), 4),
                P.round_keys(P.SubKey(key, P.COORD_FOLD), offset, 5),
                P.randint(key, (words,), 1, words),
                L.tree_sum(x), L._block_partials(x, L.LANE_BLOCKS))

    dummy = torch.zeros(1, device=dev)
    out, bad = [], []
    for i in range(calls):
        args = (P.key(100 + i, device=dev),
                torch.tensor(WRAP + 333 * i, device=dev),
                _sum_input(torch, (rows, L.LANE_BLOCKS * 300), dev, i))
        before = _fused_counts(m)
        got = cache(("draws",), body, (dummy,), *args)
        launches = _count_delta(_fused_counts(m), before)
        before = _fused_counts(m)
        with g.eager():
            want = body((dummy,), *args)
        eager = _count_delta(_fused_counts(m), before)
        same = _same_bits(torch, got, want)
        out.append({"call": i, "bitwise": same, "launches": launches})
        if not same or launches != eager:
            bad.append(f"captured draws call {i}: bitwise {same}, launches "
                       f"{launches} against eager {eager}")
    replays = [s["replays"] for s in cache.stats()]
    if dev.type == "cuda" and replays != [calls - 1]:
        bad.append(f"captured draws: replays {replays}")
    return {"calls": out, "replays": replays}, bad


def engine_pair(torch, m, dev, label, prep, call, rounds, warm, traced,
                profile=True):
    """``call(*prep())`` on the kernels and inside ``fused.plain()``:
    each side called ``warm`` times (a captured runner's eager call and
    its capture), then once timed (a replay), and ``traced`` (a call and
    its rounds; ``call`` itself when None) once under the profiler for
    device time; the kernels' side's launches counted from zero, and the
    timed call's threefry launches a call and a round beside PR 13's
    (``PR13_THREEFRY``). (report, failures, the kernels' launches)."""
    t_call, t_rounds = traced or (call, rounds)
    rep, outs = {}, {}
    launches = {}
    for side in ("kernels", "plain"):
        ctx = m.fused.plain if side == "plain" else contextlib.nullcontext
        with ctx():
            before = _fused_counts(m)
            cr_before = collections.Counter(m.cuda_round.LAUNCHES)
            for _ in range(warm):
                call(*prep())
            args = prep()
            m.bench._sync(torch.device(dev))
            timed0 = _fused_counts(m)
            outs[side], ms = _wall_ms(torch, lambda: call(*args))
            timed = _count_delta(_fused_counts(m), timed0)
            counts = _count_delta(_fused_counts(m), before)
            rk = dict(collections.Counter(m.cuda_round.LAUNCHES)
                      - cr_before)
            prof = {}
            if profile and dev.type == "cuda":
                args = prep()
                _, prof = m.bench.profile_call(lambda: t_call(*args),
                                               t_rounds, torch.device(dev))
        rep[side] = {"wall_us_per_round": ms / rounds * 1e3,
                     "device_us_per_round":
                         prof.get("device_busy_us", 0.0) / t_rounds
                         if prof else None,
                     "kernels_per_round": prof.get("kernels_per_round"),
                     "tree_sum_us_per_round": sum_us_per_round(prof),
                     "threefry_us_per_round": draw_us_per_round(prof),
                     "round_kernel_launches": rk}
        rep[side]["lane_round_launches_per_round"] = \
            timed.get("lane_round", 0) / rounds
        rep[side]["live_round_launches_per_round"] = {
            k: timed.get(k, 0) / rounds for k in LIVE_KERNELS}
        if side == "kernels":
            launches = counts
            fry = sum(v for k, v in timed.items()
                      if k.startswith("threefry/"))
            pr13 = PR13_THREEFRY.get(label)
            rep["threefry_launches"] = {
                "call": timed, "per_call": fry, "per_round": fry / rounds,
                "pr13_per_call": pr13[0] if pr13 else None,
                "pr13_per_round": pr13[0] / pr13[1] if pr13 else None}
        elif counts:
            rep["bad_plain_launches"] = counts
    bad = []
    if not _same_bits(torch, outs["kernels"], outs["plain"]):
        bad.append(f"{label}: kernels and plain() differ")
    if rep["kernels"]["round_kernel_launches"] != \
            rep["plain"]["round_kernel_launches"]:
        bad.append(f"{label}: round-kernel launches differ")
    if "bad_plain_launches" in rep:
        bad.append(f"{label}: plain() launched {rep['bad_plain_launches']}")
    if dev.type == "cuda" and not launches:
        bad.append(f"{label}: no draw or sum kernel launched")
    # the lane engine and the lanes grid: one lane_round launch a round
    # on the kernels
    per_round = rep["kernels"]["lane_round_launches_per_round"]
    if dev.type == "cuda" and label.startswith(("lane engine",
                                                "grid round lanes")) \
            and per_round != 1:
        bad.append(f"{label}: {per_round} lane_round launches a round")
    # the live engine: each live_round stage once a round on the kernels;
    # on a fault plan the plain body
    live = rep["kernels"]["live_round_launches_per_round"]
    want = 1.0 if label.startswith("live engine x") else 0.0
    if dev.type == "cuda" and label.startswith("live engine") \
            and set(live.values()) != {want}:
        bad.append(f"{label}: live_round launches a round {live}")
    rep["launches"] = launches
    return rep, bad, launches


#: the sum kernels' names in a profile: ``sum_kernel``, and the earlier
#: design's ``level_kernel`` / ``rows_kernel`` (``kernel_ab.py --sums``
#: times a checkout of it)
SUM_KERNEL_NAMES = re.compile(r"\b(sum|level|rows)_kernel\b")


#: the draw kernel's name in a profile
DRAW_KERNEL_NAMES = re.compile(r"\bdraw_kernel\b")


def _us_per_round(prof: dict, names):
    by = prof.get("device_us_per_round_by_kernel")
    if by is None:
        return None
    return sum(v for k, v in by.items() if names.search(k))


def sum_us_per_round(prof: dict):
    """The device µs a round of the sum kernels in a profile
    (``bench.device_breakdown``'s by-kernel times), or None."""
    return _us_per_round(prof, SUM_KERNEL_NAMES)


def draw_us_per_round(prof: dict):
    """The device µs a round of the draw kernel in a profile, or
    None."""
    return _us_per_round(prof, DRAW_KERNEL_NAMES)


def engine_cases(torch, m, dev, n=N, grid_n=None, views_n=VIEWS_N,
                 lane_rounds=DRAWS_LANE_ROUNDS,
                 views_rounds=DRAWS_VIEWS_ROUNDS,
                 runner_calls=DRAWS_RUNNER_CALLS,
                 live_rounds=DRAWS_LIVE_ROUNDS,
                 plan_rounds=DRAWS_PLAN_ROUNDS):
    """(label, prep, call, rounds, warm-up calls, traced call or None) of
    each engine the phase runs on the kernels and on the plain versions:
    the lane engine in sweep_lanes' configuration, the live engine on
    the full model, both engines on the byzantine check plan (its churn
    and replay slots; eager, not captured), a lan grid round on
    the xla and lanes engines, the views at 4,096 (views_single's first
    stage; not a captured runner, so no warm-up; traced over
    ``VIEWS_PROFILE_ROUNDS``: the profiler's cost grows with the plain
    version's ~2,900 launches a round), the kernel runner's calls and a
    coordinate round."""
    b, P = m.bench, m.prng
    key = P.key(61, device=dev)
    cases = []
    p_diag = b.diag_params(n)
    s0 = m.state.init_state(n, device=dev)
    lane = m.round.make_run_rounds_lanes(
        p_diag.with_(stale_k=LANE_KS[-1]), lane_rounds,
        flight_every=LANE_STRIDE, carry=True)
    cases.append((f"lane engine stale_k={LANE_KS[-1]} x{lane_rounds}",
                  lambda: (b.clone_state(s0), key), lane, lane_rounds, 2,
                  None))
    live = m.round.make_run_rounds(p_diag, live_rounds)
    cases.append((f"live engine x{live_rounds}",
                  lambda: (b.clone_state(s0), key), live, live_rounds, 2,
                  None))
    p_chaos = m.scenarios.chaos_params(n)
    cp = m.faults.compile_plan(check_plans(n)["byz"], n, dev)
    s_chaos = m.state.init_state(n, device=dev)
    lane_byz = m.round.make_run_rounds_lanes(p_chaos, plan_rounds, plan=cp)
    cases += [
        (f"live engine byzantine plan x{plan_rounds}",
         lambda: (b.clone_state(s_chaos), key),
         lambda s, k: m.round.run_rounds(s, k, p_chaos, plan_rounds,
                                         plan=cp)[0], plan_rounds, 0, None),
        (f"lane engine byzantine plan x{plan_rounds}",
         lambda: (b.clone_state(s_chaos), key), lane_byz, plan_rounds, 2,
         None)]
    n_grid = grid_n or b.SWEEP_SIZE[0]
    p_grid = m.scenarios.autotune_params("lan", n_grid)
    tp, _ = m.params.grid_params(
        p_grid, m.params.SweepAxes.of(**b.AUTOTUNE_GRID), dev)
    for engine in ("xla", "lanes"):
        grid = m.sweep.make_run_sweep(p_grid, 1, engine=engine, device=dev)
        cases.append((f"grid round {engine} {tp.grid_shape[0]} x {n_grid}",
                      lambda: (tp, key), grid, 1, 2, None))
    V = m.views
    pv = m.params.SimParams(n=views_n, loss=0.01)
    v0 = V.init_views(views_n, device=dev)
    cases.append((f"views {views_n} x{views_rounds}", lambda: (v0,),
                  lambda v: V.run_views(v, P.key(71, dev), pv, views_rounds),
                  views_rounds, 0,
                  (lambda v: V.run_views(v, P.key(72, dev), pv,
                                         VIEWS_PROFILE_ROUNDS),
                   VIEWS_PROFILE_ROUNDS)))
    for R, rounds in runner_calls:
        run = m.cuda_round.make_run_rounds_cuda(b.headline_params(n), rounds,
                                                rounds_per_call=R)
        cases.append((f"kernel runner R={R} x{rounds}",
                      lambda: (b.clone_state(s0), key), run, rounds, 2,
                      None))
    topo = m.topology.make_topology(m.topology.TopologyParams(n=n), dev)
    coo = m.coords.init_coords(n, device=dev)
    up = torch.ones(n, dtype=torch.bool, device=dev)
    sc = torch.tensor([float(n), float(n), float(n), 0.0, 0.01 * n,
                       0.01 * n, 0.0, 1e-9], device=dev)
    ckey = P.fold_in(key, P.COORD_FOLD)
    cases.append(("coordinate round", lambda: (),
                  lambda: m.cuda_round.coord_round(coo, topo, ckey, up, sc),
                  1, 1, None))
    return cases


def draws_engines(torch, m, dev, profile=True, **sizes) -> tuple:
    """Every engine of ``engine_cases`` on the kernels and plain:
    (report, failures, the kernels' launches over them)."""
    out, bad, launches = {}, [], collections.Counter()
    for label, prep, call, rounds, warm, traced in engine_cases(
            torch, m, dev, **sizes):
        t1 = time.perf_counter()
        out[label], b, got = engine_pair(torch, m, dev, label, prep, call,
                                         rounds, warm, traced,
                                         profile=profile)
        bad += b
        launches.update(got)
        print(f"draws: {label} {time.perf_counter() - t1:.1f} s",
              file=sys.stderr, flush=True)
    return out, bad, dict(launches)


def draw_timing_cases(torch, m, dev, n=N, grid_l=65_536, views=VIEWS_N,
                      bounds=True):
    """(name, shape, kernel call, plain call, bound, library call or
    None) of each kernel at the shapes of its paths: ``round_keys`` of a
    512-round call, its seeds (one launch deriving each round's key),
    the live engine's 1M-word uniform, the views' 4,096 x 4,096 one, the
    lane engine's ``u01_global``, a round's draws of the full model's
    slots on the live and lane engines (one launch each), the coordinate
    round's ``randint`` (both words one launch), and the sums: the lane
    engine's block partials of ``[32, 1M]``, a coordinate mean ``[1,
    1M]``, the flight means ``[5, 1M]``, the grid rows ``[2048,
    grid_l]``, the lanes grid engine's block partials of ``[32, 64,
    grid_l]`` and the lane table ``[32, 64]``. A draw's kernel call is
    its one launch (``prng._draw`` of its ``Draw``) and its plain call
    the kernel's twin on that ``Draw`` (``prng._draw_twin``: the same
    function, where the prng call may do more, as ``randint``'s
    remainders); with ``bounds`` False (``kernel_ab.py``, on a checkout
    of either design) both are the prng function and no draw has a
    bound."""
    P, L, F, cm = m.prng, m.lanes, m.fused, m.costmodel
    k = P.key(23, device=dev)
    start = torch.tensor(5, device=dev)
    S = len(ROUND_SLOTS)
    draws = [
        ("threefry/words", "round_keys x512",
         lambda: P.round_keys(k, start, 512),
         lambda: F.draw("words", k[..., 0], k[..., 1], gen=512,
                        base=P._on(start, dev))),
        ("threefry/seeds", "round_seeds x512",
         lambda: P.round_seeds(k, start, 512),
         lambda: F.draw("seeds", k[..., 0], k[..., 1], gen=512,
                        base=P._on(start, dev), derive_gen=True)),
        ("threefry/uniform", f"uniform x{n}", lambda: P.uniform(k, n),
         lambda: F.draw("uniform", k[..., 0, None], k[..., 1, None],
                        gen=n)),
        ("threefry/uniform", f"uniform [1e-9, 1) {views} x {views}",
         lambda: P.uniform(k, (views, views), 1e-9, 1.0),
         lambda: F.draw("uniform", k[..., 0, None], k[..., 1, None],
                        gen=views * views, minval=1e-9, maxval=1.0)),
        ("threefry/u01_global", f"u01_global x{n}",
         lambda: P.u01_global(k, 0, n),
         lambda: F.draw("u01_global", k[0], k[1], gen=n,
                        base=P._on(0, dev))),
        ("threefry/uniform", f"threefry_u01 slots {ROUND_SLOTS} x{n}",
         lambda: round_draws(P.threefry_u01, ROUND_SLOTS, k, n),
         lambda: F.draw("uniform", k[0].expand(S, 1), k[1].expand(S, 1),
                        gen=n, derive=P.slot_words(ROUND_SLOTS))),
        ("threefry/u01_global", f"global_u01 slots {ROUND_SLOTS} x{n}",
         lambda: round_draws(P.global_u01, ROUND_SLOTS, k, 0, n),
         lambda: F.draw("u01_global", k[0].expand(S, 1),
                        k[1].expand(S, 1), gen=n, base=P._on(0, dev),
                        derive=P.slot_words(ROUND_SLOTS))),
        ("threefry/xor", f"randint x{n}", lambda: P.randint(k, (n,), 1, n),
         lambda: F.draw("xor", k[0].expand(2, 1), k[1].expand(2, 1), gen=n,
                        gen_hi=True, derive=(0, 1)))]
    cases = []
    for name, shape, call, make in draws:
        d = make() if bounds else None
        cases.append((name, shape,
                      (lambda d=d: P._draw(d)) if bounds else call,
                      (lambda d=d: P._draw_twin(d)) if bounds else call,
                      cm.draw_bound(d) if bounds else None, None))
    for shape, x, plus_zero in (
            (f"block partials [32, {n}]",
             _sum_input(torch, (L.N_LANES, L.LANE_BLOCKS, n // L.LANE_BLOCKS),
                        dev, 5), True),
            (f"coordinate mean [1, {n}]", _sum_input(torch, (1, n), dev, 6),
             False),
            (f"flight means [5, {n}]", _sum_input(torch, (5, n), dev, 9),
             False),
            (f"grid rows [2048, {grid_l}]",
             _sum_input(torch, (L.N_LANES * L.LANE_BLOCKS, grid_l), dev, 7),
             False),
            (f"grid block partials [131072, {grid_l // L.LANE_BLOCKS}]",
             _sum_input(torch, (L.N_LANES, L.LANE_BLOCKS, L.LANE_BLOCKS,
                                grid_l // L.LANE_BLOCKS), dev, 10), True),
            ("lane table [32, 64]",
             _sum_input(torch, (L.N_LANES, L.LANE_BLOCKS), dev, 8), False)):
        rows = x.numel() // x.shape[-1]
        plain = (lambda x=x: L.tree_sum(x) + 0.0) if plus_zero else \
            (lambda x=x: L.tree_sum(x))
        cases.append(("tree_sum", shape,
                      lambda x=x, z=plus_zero: F.tree_sum(x, z), plain,
                      cm.sum_bound(rows, x.shape[-1]),
                      lambda x=x: torch.sum(x, -1)))
    return cases


def draws_timing(torch, m, dev, n=N) -> dict:
    """Each kernel's and the library call's device ms at its paths'
    shapes (both by CUDA-graph replay), its plain version's ms (CUDA
    events), its bound and the time over it."""
    out = {}
    for name, shape, kern, plain, bound, library in draw_timing_cases(
            torch, m, dev, n):
        with m.fused.plain():
            plain_ms = _events_ms(torch, plain, 5)
        ms = _graph_ms(torch, kern, 200)
        out.setdefault(name, {})[shape] = {
            "ms": ms, "plain_ms": plain_ms,
            "library_ms": _graph_ms(torch, library, 200) if library
            else None,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "x_bound": ms / bound["bound_ms"], "bytes": bound["bytes"],
            "int32_bound_ms": bound.get("int32_bound_ms")}
    return out


def phase_draws(torch, m, dev):
    """The draw and sum kernels: (a) each against its plain version,
    bit for bit; (b) captured replays; (c) the engines on the kernels
    against ``fused.plain()``; (d) times. Returns (report, the engines'
    kernel launches)."""
    t0 = time.perf_counter()
    draws, bad = kernel_checks(torch, m, dev, draw_cases(torch, m, dev))
    sums, b = kernel_checks(torch, m, dev, sum_cases(torch, m, dev))
    bad += b
    captured, b = captured_draws(torch, m, dev)
    bad += b
    wide, b = wide_draw_check(torch, m, dev)
    draws.update(wide)
    bad += b
    checks_s = time.perf_counter() - t0
    engines, b, launches = draws_engines(torch, m, dev)
    bad += b
    missing = [k for k in DRAW_KERNELS + ("lane_round",)
               if not launches.get(k)]
    if missing:
        bad.append(f"draws: the engines never launched {missing}")
    if bad:
        raise SmokeFailure("draws: " + "; ".join(bad))
    timing = draws_timing(torch, m, dev)
    rep = {"phase": "draws", "n": N, "nvidia_smi": nvidia_smi(),
           "phase_s": time.perf_counter() - t0, "checks_s": checks_s,
           "draws": draws, "sums": sums, "captured": captured,
           "engines": engines, "timing": timing, "launches": launches}
    emit(rep)
    return rep, launches



def _events_ms(torch, fn, reps, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(torch, fn, reps, per_graph=20):
    """Device time per call of ``fn``: CUDA events around replays of a
    CUDA graph of ``per_graph`` calls, so the host's time per launch
    (the wrapper's checks, ctypes) does not stretch the gaps between
    kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    replays = max(1, reps // per_graph)
    return _events_ms(torch, graph.replay, replays, warm=1) / per_graph


def launch_times(torch, kern, reps) -> dict:
    """Three times per launch of the wrapper call ``kern``: ``ms``, the
    device's (``_graph_ms``); ``enqueue_ms``, CUDA events around
    ``reps`` back-to-back calls (the older measure: the device's time, or
    the host's once a call takes the host longer than the kernel takes
    the device); ``host_ms``, the host's own time per call in that loop
    (the wrapper's checks, ctypes, the launch)."""
    for _ in range(10):
        kern()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        kern()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    end.record()
    torch.cuda.synchronize()
    return {"ms": _graph_ms(torch, kern, reps),
            "enqueue_ms": start.elapsed_time(end) / reps,
            "host_ms": host_ms}


def timing_cases(m, inputs) -> list:
    """(name, params, mega, frame) of each variant ``time_kernels``
    times: the six of the paths, the gated full variant, and the byz one
    on its frame read in place, as the kernel runner hands it over."""
    b = m.bench
    frames = inputs[3]
    p_full, p_chaos = b.diag_params(N), m.scenarios.chaos_params(N)
    return [("round_kernel/stable", b.headline_params(N), False, None),
            ("round_kernel/full", p_full, False, None),
            ("round_kernel/full corroboration_k=1",
             p_full.with_(corroboration_k=1), False, None),
            ("mega_kernel/stable", b.headline_params(N), True, None),
            ("mega_kernel/full", p_full, True, None),
            ("round_kernel/fault", p_chaos, False, frames["fault"]),
            ("round_kernel/byz", p_chaos.with_(corroboration_k=2), False,
             frames["byz"]),
            ("round_kernel/byz in place", p_chaos.with_(corroboration_k=2),
             False, frames["byz in place"])]


def kernel_call(m, inputs, p, mega, fx):
    """The wrapper call of one timed launch, on copies of the state that
    it updates, writing its partials into one buffer; and the rounds it
    runs and the launches to time."""
    cr = m.cuda_round
    arrays, scal, seeds, _ = inputs
    work = tuple(a.clone() for a in arrays)
    if mega:
        buf = cr.mega_kernel(work, scal, seeds, p)

        def kern():
            cr.mega_kernel(work, scal, seeds, p, out=buf)
        return kern, MEGA_R, 50
    buf = cr.round_kernel(work, scal, seeds, 0, p, fx=fx)

    def kern():
        cr.round_kernel(work, scal, seeds, 0, p, out=buf, fx=fx)
    return kern, 1, 200


def time_kernels(torch, m, inputs) -> dict:
    """Each variant's ``launch_times``, its bound and its plain
    version's time."""
    cr = m.cuda_round
    arrays, scal, seeds, _ = inputs
    out = {}
    for name, p, mega, fx in timing_cases(m, inputs):
        kern, rounds, reps = kernel_call(m, inputs, p, mega, fx)
        pfx, ref_out = plain_frame(m, fx), None
        if fx is not None:
            ref_out, _ = cr.block_round_ref(arrays, scal, seeds[0], p,
                                            fx=pfx)
        if mega:
            def plain():
                cr.mega_round_ref(arrays, scal, seeds, p)
        else:
            def plain():
                cr.block_round_ref(arrays, scal, seeds[0], p, fx=pfx)
        out[name] = {**launch_times(torch, kern, reps),
                     "plain_ms": _events_ms(torch, plain, 3, warm=1),
                     **m.costmodel.kernel_bound(p, arrays, rounds, fx=pfx,
                                                out=ref_out),
                     "rounds_per_launch": rounds}
    return out


def lane_plain(torch, m, arrays, scal, u, slots, p, fx):
    """``lane_round``'s plain version on the same slot rows: the plain
    body in lane mode, its lanes narrowed and its stack made."""
    outs, lanes = m.round._round_body(arrays, m.round._grid_scalars(scal),
                                      p,
                                      m.prng._slot_rows(u, slots), fx=fx,
                                      lane_mode=True)
    outs = m.round._cast_like(outs, arrays)
    zeros = torch.zeros_like(outs[2])
    return outs, torch.stack([zeros if x is None else x for x in lanes])


def lane_timing_cases(m, inputs) -> list:
    """(name, params, frame, stats, inst) of each ``lane_round`` launch
    ``time_lane_kernel`` times: a round of the full model (the lane
    engine at stale_k 1), of the stable config, on the honest and the
    byzantine check frames, and a mid-window round of the full model at
    stale_k > 1 (its counter rows added, its other rows skipped)."""
    b = m.bench
    n = inputs[0][0].shape[0]
    frames = inputs[3]
    p_full, p_chaos = b.diag_params(n), m.scenarios.chaos_params(n)
    return [("lane_round/full", p_full, None, "write", True),
            ("lane_round/stable", b.headline_params(n), None, "write",
             True),
            ("lane_round/fault", p_chaos, frames["fault"], "write", True),
            ("lane_round/byz", p_chaos.with_(corroboration_k=2),
             frames["byz"], "write", True),
            ("lane_round/full mid-window", p_full, None, "add", False)]


def lane_grid_inputs(torch, m, dev, n=LANE_GRID_N):
    """The lan autotune grid's state, scalars and params (the sweep's
    lanes engine's cell): (name, params, frame, stats, inst, state
    lanes, scalars), timed as a ``lane_timing_cases`` case."""
    label, p, axes, kind = lane_grids(m, n)[0]
    tp, s, lv, _ = lane_grid_state(torch, m, p, axes, kind, dev, warm=1)
    return (f"lane_round/{label} {tp.grid_shape[0]} x {n}", tp, None,
            "write", True, s.node_arrays(),
            m.lanes.scalars_from_lanes(lv).contiguous())


def time_lane_kernel(torch, m, inputs) -> dict:
    """Each ``lane_timing_cases`` launch's ``launch_times``, its bound
    (``costmodel.lane_bound``) and its plain version's time; and the
    lan autotune grid's (``lane_grid_inputs``)."""
    arrays, scal, _, _ = inputs
    dev = arrays[0].device
    key = m.prng.key(43, device=dev)
    out = {}
    cases = [(*c, arrays, scal) for c in lane_timing_cases(m, inputs)]
    for name, p, fx, stats, inst, arrays, scal in cases + [
            lane_grid_inputs(torch, m, dev)]:
        slots = m.round.draw_slots(p, fx)
        u = m.prng.global_rows(key, 0, arrays[0].shape[-1], slots)
        stack = torch.zeros((m.lane_kernel.N_ROWS,) + tuple(arrays[0].shape),
                            dtype=torch.float32, device=dev)

        def kern():
            m.lane_kernel.lane_round(arrays, scal, u, slots, p, fx,
                                     stack=stack, stats=stats, inst=inst)

        def plain():
            lane_plain(torch, m, arrays, scal, u, slots, p, fx)

        bound = m.costmodel.lane_bound(arrays, u, fx, stats, inst)
        t = launch_times(torch, kern, 200)
        out[name] = {**t, "plain_ms": _events_ms(torch, plain, 3, warm=1),
                     **bound, "x_bound": t["ms"] / bound["bound_ms"]}
    return out


def live_timing_cases(m, n) -> list:
    """(label, params) of each live period ``time_live_kernel`` times:
    the full model (the slow model, counters) and the live cell's
    deployment (``gossipbench/configs/wan-1m-churn5.json``: the WAN with
    5%/min churn) at ``n`` agents."""
    from gossipbench.program import SIM_FIELDS

    cfg = json.loads((pathlib.Path(__file__).parent / "gossipbench"
                      / "configs" / "wan-1m-churn5.json").read_text())
    return [("full", m.bench.diag_params(n)),
            ("wan-1m-churn5", m.params.SimParams(
                n=n, **{f: cfg[f] for f in SIM_FIELDS}))]


def time_live_kernel(torch, m, inputs) -> dict:
    """Each stage of a live period (``live_kernel``) on the check state:
    its ``launch_times`` on the sums its chain gives it, its bound
    (``costmodel.live_bound``), and the plain body's period on the same
    draws (the period's, on each of its stages' rows)."""
    arrays = inputs[0]
    dev = arrays[0].device
    n = arrays[0].shape[0]
    LV = m.live_kernel
    out = {}
    for label, p in live_timing_cases(m, n):
        slots = m.round.draw_slots(p)
        u01 = m.prng.threefry_u01(m.prng.key(47, device=dev), n, slots)
        per = LV.Period(arrays, u01, slots, p, None)
        LV.launch(per, 0, [])
        sa = [torch.sum(r) for r in per.rows]
        LV.launch(per, 1, sa)
        sums = ([], sa, sa + [torch.sum(r) for r in per.rows])
        state = m.state.SimState(
            *arrays, t=torch.zeros((), device=dev),
            round_idx=torch.zeros((), dtype=torch.int32, device=dev),
            stats=m.state.SimStats.zeros(dev))

        def plain():
            with m.fused.plain():
                m.round.round_core(state, None, p, u01)

        plain_ms = _events_ms(torch, plain, 3, warm=1)
        for stage, name in enumerate(LIVE_KERNELS):
            def kern(stage=stage):
                LV.launch(per, stage, sums[stage])

            bound = m.costmodel.live_bound(arrays, slots, stage,
                                           p.collect_stats, p.has_churn)
            t = launch_times(torch, kern, 200)
            out[f"{name} {label}"] = {
                **t, "plain_ms": plain_ms, **bound,
                "x_bound": t["ms"] / bound["bound_ms"]}
    return out


def time_flight_row(torch, m, inputs) -> dict:
    """The kernel runner's flight row on the check state: one
    ``flight_row`` launch's ``launch_times``, its bound
    (``costmodel.flight_bound``) and its largest gap from
    ``flight.flight_row``; beside it the plain row as the runner built
    it before the kernel (the up mask, the window's delta,
    ``flight_row``, the slot write, the snapshot's two clones): ``ms``
    eager (CUDA events, ``plain_ms``) and device ms by graph replay
    (``plain_device_ms``)."""
    cr, fl = m.cuda_round, m.flight
    arrays = inputs[0]
    dev = arrays[0].device
    lat = m.round.LAT
    acc = 1000 * torch.arange(1, len(m.state.STATS_FIELDS) + 1,
                              dtype=torch.int32, device=dev)
    acc[lat] = 0
    acc_lat = torch.tensor(5000.0, device=dev)
    prev, prev_lat = torch.zeros_like(acc), torch.zeros_like(acc_lat)
    t = torch.tensor(100.0, device=dev)
    trace = torch.zeros((2, fl.N_COLS), device=dev)
    scratch = cr.flight_scratch(dev)

    def plain():
        delta = (acc - prev).to(torch.float32)
        delta[lat] = acc_lat - prev_lat
        fl.record_row(trace, fl.flight_row(
            up=arrays[3] < 0, status=arrays[0], informed=arrays[2],
            local_health=arrays[7], incarnation=arrays[1], t=t,
            stats_delta=delta, phase=-1), 1, 1)
        return acc.clone(), acc_lat.clone()

    def kern():
        cr.record_flight_row(trace, 0, 1, arrays, t, acc, acc_lat, prev,
                             prev_lat, scratch=scratch)

    plain()
    kern()
    torch.cuda.synchronize()
    gap = float((trace[0] - trace[1]).abs().max())
    bound = m.costmodel.flight_bound(arrays)
    tk = launch_times(torch, kern, 200)
    return {"flight_row": {
        **tk, "plain_ms": _events_ms(torch, plain, 20),
        "plain_device_ms": _graph_ms(torch, plain, 200), **bound,
        "x_bound": tk["ms"] / bound["bound_ms"], "max_abs_err": gap}}


#: periods the timed coordinate state relaxes from a cold start first
COORD_TIMING_WARM = 30


def coord_timing_case(torch, m, dev, n=N, warm=COORD_TIMING_WARM) -> dict:
    """The coordinates cell's period at ``n`` agents (``coords_setup``:
    its latency map and deadlines), its coordinates relaxed ``warm``
    periods from a cold start: the inputs of each coordinate launch."""
    co, prng = m.coords, m.prng
    su = m.scenarios.coords_setup(n, device=dev)
    key = prng.key(61, device=dev)
    c = co.init_coords(n, device=dev)
    up = torch.ones(n, dtype=torch.bool, device=dev)
    for r in range(warm):
        k_pair, k_jit, k_dir, _ = prng.split(prng.fold_in(key, r), 4)
        j = m.topology.sample_pairs(n, k_pair)
        rtt, _, _ = co.probe(c, su.topo, j, k_jit)
        c, _, _ = co.relax(c, j, rtt, k_dir, up, up)
    k_pair, k_jit, k_dir, k_q = prng.split(prng.fold_in(key, warm), 4)
    j = m.topology.sample_pairs(n, k_pair)
    p = su.p
    return {"topo": su.topo, "coords": c, "pair_j": j,
            "q_in": m.topology.sample_pairs(n, k_q),
            "z": prng.normal(k_jit, (n,)), "k_dir": k_dir,
            "lh": torch.zeros(n, dtype=torch.int32, device=dev), "up": up,
            "deadline": (p.coord_timeout_mult, p.probe_interval,
                         p.probe_timeout)}


def _coord_outputs(torch, m, name, c, got, want) -> list:
    """(output, the launch's, the plain version's) of every output a
    coordinate launch shares with its plain version on the inputs ``c``:
    the relaxation's new state field by field, its gate, each agent's
    moved distance against the plain step's and their mean against the
    plain drift."""
    if name == "vivaldi_relax":
        (new, relaxed, moved), (c2, w_relaxed, drift) = got, want
        d = c2.vec - c.vec
        return [*zip(new._fields, new, c2),
                ("relaxed", relaxed, w_relaxed),
                ("moved", moved, torch.sqrt(torch.sum(d * d, dim=-1))),
                ("drift", m.coords._mean_moved(moved), drift)]
    if name == "coord_probe":
        return list(zip(("rtt_obs", "timely", "late_in"), got, want))
    return [("rel", got, want)]


def time_coord_kernels(torch, m, dev, n=N) -> dict:
    """Each coordinate launch (``coord_kernel``) on the coordinates
    cell's period at ``n`` agents (``coord_timing_case``): every output
    bit for bit its plain version's on the card, its ``launch_times``,
    its bound (``costmodel.coord_bound``), and its plain version's
    times, the ATen route it replaces: eager by CUDA events
    (``plain_ms``) and its device time by graph replay
    (``plain_device_ms``)."""
    CK, co = m.coord_kernel, m.coords
    k = coord_timing_case(torch, m, dev, n)
    c, topo, j = k["coords"], k["topo"], k["pair_j"]
    dl = (k["q_in"], k["lh"], k["deadline"])
    rtt, _, _ = CK.probe(c, topo, j, k["z"])
    u = m.prng.uniform(k["k_dir"], n * CK.DIMS)
    cases = {
        "coord_probe": (lambda: CK.probe(c, topo, j, k["z"], *dl),
                        lambda: co.probe_plain(c, topo, j, k["z"], *dl)),
        "vivaldi_relax": (
            lambda: CK.relax(c, j, rtt, u, k["up"], k["up"]),
            lambda: co.relax_plain(c, j, rtt, k["k_dir"], k["up"],
                                   k["up"])),
        "coord_quality": (lambda: CK.quality(c, topo, j),
                          lambda: co.quality_plain(c, topo, j))}
    bounds = m.costmodel.coord_bound(n, topo_dims=topo.pos.shape[-1])
    out = {}
    for name, (kern, plain) in cases.items():
        pairs = _coord_outputs(torch, m, name, c, kern(), plain())
        gaps = {f: float((a.double() - b.double()).abs().max())
                if a.shape == b.shape else None for f, a, b in pairs}
        bad = [f for f, a, b in pairs if a.dtype != b.dtype
               or a.shape != b.shape or not torch.equal(a, b)]
        if bad:
            raise SmokeFailure(f"{name}: {bad} differ from the plain "
                               f"version's (max abs err {gaps})")
        t = launch_times(torch, kern, 200)
        out[name] = {**t, "plain_ms": _events_ms(torch, plain, 5),
                     "plain_device_ms": _graph_ms(torch, plain, 20,
                                                  per_graph=5),
                     **bounds[name], "x_bound": t["ms"]
                     / bounds[name]["bound_ms"],
                     "max_abs_err": max(gaps.values())}
    return out


def phase_timing(torch, m, inputs):
    out = time_kernels(torch, m, inputs)
    out.update(time_lane_kernel(torch, m, inputs))
    out.update(time_live_kernel(torch, m, inputs))
    out.update(time_flight_row(torch, m, inputs))
    out.update(time_coord_kernels(torch, m, inputs[0][0].device))
    emit({"phase": "timing", "n": N, "kernels": out})
    return out


def modules():
    """The port's modules the phases use, as one namespace."""
    import types

    from consul_tpu_torch import bench, cli, config, faults, graft_entry
    from consul_tpu_torch.sim import (autotune, blackbox, checkpoint, coords,
                                      costmodel, cuda_round, flight, fused,
                                      graphs, lanes, mesh, metrics, params,
                                      prng, round, scenarios, state, sweep,
                                      topology, twin, views)
    try:
        from consul_tpu_torch.sim import coord_kernel
    except ImportError:
        # a checkout from before the coordinate kernels
        coord_kernel = None
    try:
        from consul_tpu_torch.sim import lane_kernel
    except ImportError:
        # a checkout from before the lane kernel (kernel_ab.py times one)
        lane_kernel = None
    try:
        from consul_tpu_torch.sim import live_kernel
    except ImportError:
        # a checkout from before the live stages
        live_kernel = None
    from consul_tpu_torch.utils import telemetry

    return types.SimpleNamespace(
        autotune=autotune, bench=bench, blackbox=blackbox,
        checkpoint=checkpoint, cli=cli, config=config,
        coord_kernel=coord_kernel, coords=coords,
        costmodel=costmodel, cuda_round=cuda_round, faults=faults,
        flight=flight, fused=fused, graft_entry=graft_entry, graphs=graphs,
        lane_kernel=lane_kernel, lanes=lanes, live_kernel=live_kernel,
        mesh=mesh, metrics=metrics,
        params=params, prng=prng, round=round, scenarios=scenarios,
        state=state, sweep=sweep, telemetry=telemetry, topology=topology,
        twin=twin, views=views)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; nothing was run",
              file=sys.stderr)
        return 2
    m = modules()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from consul_tpu_torch.utils import build

    phase_env(torch, build, m.cuda_round, m.fused, m.lane_kernel,
              m.coord_kernel)
    checks, inputs = phase_check(torch, m, dev)
    phase_lanes(torch, m, dev, inputs)
    headline, launches = phase_headline(torch, m, dev)
    # the draw and sum kernels' launches on every path from here on
    draws0 = _fused_counts(m)
    chaos, chaos_launches = phase_chaos(torch, m, dev)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as root:
        parts = (chaos_launches, phase_observe(torch, m, dev),
                 phase_sweep(torch, m, dev),
                 phase_resume(torch, m, dev, root))
        phase_mesh(torch, m, dev, os.path.join(root, "mesh"))
        parts += (phase_tune(torch, m, dev, os.path.join(root, "records"),
                             headline),
                  phase_seams(torch, m, dev, root),
                  phase_graphs(torch, m, dev))
    draw_launches = collections.Counter(_count_delta(_fused_counts(m),
                                                     draws0))
    draws, engine_launches = phase_draws(torch, m, dev)
    draw_launches.update(engine_launches)
    for part in parts:
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    timing = phase_timing(torch, m, inputs)

    source = "consul_tpu_torch/csrc/round_kernels.cu"
    replaces = {"round_kernel": "consul_tpu/sim/pallas_round.py:439",
                "mega_kernel": "consul_tpu/sim/pallas_round.py:526"}
    kernels = []
    # the kernels of the paths; the gated full variant, which no path
    # launches yet, is timed in phase timing only
    for name, t in timing.items():
        if name not in launches or name == "flight_row" \
                or name in m.coord_kernel.NAMES:
            continue
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces[name.split("/")[0]],
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in (
                checks[name], checks.get(f"{name} R={TUNE_R}")) if c),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    # each draw and sum kernel at its main path's shape; bit for bit
    # against its plain version in phase draws
    shapes = {"threefry/words": "round_keys x512",
              "threefry/xor": f"randint x{N}",
              "threefry/seeds": "round_seeds x512",
              "threefry/uniform": f"uniform x{N}",
              "threefry/u01_global": f"u01_global x{N}",
              "tree_sum": f"block partials [32, {N}]"}
    for name in DRAW_KERNELS:
        t = draws["timing"][name][shapes[name]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "consul_tpu_torch/csrc/" + (
                "sum_kernels.cu" if name == "tree_sum"
                else "prng_kernels.cu"),
            "replaces": "consul_tpu/sim/lanes.py:199 (jnp.sum)"
            if name == "tree_sum" else
            "consul_tpu/sim/lanes.py:181 (jax.random.*)",
            "launches": draw_launches[name], "max_abs_err": 0.0,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    # the lane engine's period, at the full model's round (stale_k 1);
    # bit for bit against the plain body in phase lanes
    t = timing["lane_round/full"]
    kernels.append({
        "name": "lane_round", "route": "cuda",
        "source": "consul_tpu_torch/csrc/lane_kernels.cu",
        "replaces": "consul_tpu/sim/round.py:113 (_round_core, lane mode, "
                    "via :766)",
        "launches": draw_launches["lane_round"], "max_abs_err": 0.0,
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None})
    # the live period's stages on the live cell's deployment; bit for bit
    # against the plain body in phases graphs and draws
    for name in LIVE_KERNELS:
        t = timing[f"{name} wan-1m-churn5"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "consul_tpu_torch/csrc/lane_kernels.cu",
            "replaces": "consul_tpu/sim/round.py:113 (_round_core, live "
                        "mode: the fusions between its sums)",
            "launches": draw_launches[name], "max_abs_err": 0.0,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    # the kernel runner's flight row at N; its rows against
    # flight.flight_row in phases observe, chaos and seams
    t = timing["flight_row"]
    kernels.append({
        "name": "flight_row", "route": "cuda", "source": source,
        "replaces": "consul_tpu/sim/flight.py:95 (flight_row, fused into "
                    "the recorded round)",
        "launches": launches.get("flight_row", 0),
        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None})
    # the coordinate round's launches on the coordinates cell's period,
    # counted on the paths of phase observe; against their plain
    # versions there, and bit for bit in phase timing
    for name in m.coord_kernel.NAMES:
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "consul_tpu_torch/csrc/coord_kernels.cu",
            "replaces": "consul_tpu/sim/coords.py (vivaldi_step, "
                        "estimate_rtt), consul_tpu/sim/topology.py "
                        "(true_rtt, sample_rtt): XLA fusions",
            "launches": launches.get(name, 0),
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
