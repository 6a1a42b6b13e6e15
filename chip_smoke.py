#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dpcorr_torch``) on one NVIDIA card.

Drives the port's main path, the Monte-Carlo replication loop of the
north-star workload (n = 10⁴ Gaussian pair → NI sign-batch estimate + CI →
(se², cover, ci_len); ε = (1, 1), ρ = 0.5, α = 0.05), end to end:

1. card name and power limit (``nvidia-smi``);
2. builds every kernel from ``dpcorr_torch/csrc`` (one ``nvcc`` per source,
   started together) and prints what ``ptxas`` reports for each of K1's
   48 variants (16 modes × planes with the batch noise in shared memory,
   planes with the noise drawn in the sweep, no planes; registers, stack
   frame, spills; the main-path variant must not spill);
3. holds the fused kernel against its plain PyTorch version in all 16
   modes (8 flag combinations × external or in-kernel uniforms) at every
   lane-group layout the kernel branches on (m' = 1, 8, 16 with leftovers,
   32, 64, 128; n = 1000 and 20,000; m' = 8 with leftovers at n = 1500),
   and near the shared-memory cap,
   where the kernel draws the batch noise in its sweep (m' = 1, 2, 4, 8,
   64, 128), B = 256: external mode on random uniforms, and in-kernel
   mode, which must equal external mode on ``philox_uniforms`` (its draws
   laid out) bit for bit;
4. the unfused path: ``RepBlockPipeline`` on the key-tree, 2¹⁶ reps;
5. the fused path: the same pipeline through the kernel's in-kernel
   Philox mode, 2²⁰ reps, and ``sim_detail_fused`` (NI + INT), 2¹⁶ reps,
   with the kernel's launch count and the stage ladder's (which must be
   0: it is a diagnostic) read around this phase;
6. gates: coverage in [0.90, 0.99] on every path; fused against unfused
   mse and ci_len within 5% and coverage within 0.01; fused INT against
   the unfused ``run_sim_one``; launches > 0;
7. times: the kernel at the main path's launch shape (CUDA events), its
   plain version on the same replications, blocks resident per SM, and
   the least time the card could take for the same work, by pipe and by
   issue slots;
8. the sub-Gaussian and streaming paths (no kernel of their own: torch
   ops on the key-tree), each driven with the launch counts set to 0
   just before it and read just after:
   (a) card against CPU on the same keys: ``permutation`` and the
       bounded-factor data bit for bit, and ``_one_rep`` for the subG grid
       pair, the real-data pair and the streaming pair within 1e-5 for
       ≥ 99% of 256 replications;
   (b) the acceptance points ``subg_factor`` (det and mc) and
       ``subg_real`` (det) through ``run_sim_one``, 2¹⁸ replications
       each, against the JAX package's committed coverage at B ≈ 10⁶:
       |Δ coverage| ≤ 0.003, ci_length within 1%, mse within 3%;
   (c) full width: ``RepBlockPipeline`` over the subG body at
       n = 12,000, ε = (1.5, 0.5), 2¹⁶ replications: NI coverage in
       [0.90, 0.99], one host read per run, reps/s;
   (d) streaming: n = 10⁶, ``stream_n_chunk`` = 65536, the subG pair,
       2048 replications: finite values, NI coverage in [0.90, 0.99],
       reps/s. The INT estimator's receiver clips its products at
       λ_r = 30, which biases η̂ by about −0.031 at every n ≥ 403 (the
       JAX package's construction, replication by replication:
       ``tests/test_torch_sim.py``); at n = 10⁶ its CI is 0.034 wide, so
       it covers ρ in about 5% of replications. Its gates are therefore
       against the materialized path of (b) in the same run: bias within
       0.003, and ci_length within 2% of (b)'s scaled by √(4000/n);
9. the design grid (``dpcorr_torch.grid``) and the acceptance campaign
   (``dpcorr_torch.acceptance``), the path users run the paper's studies
   through, each part driven with the launch counts set to 0 just before
   it and read just after:
   (a) the reference's v1 sign grid (144 points, B = 250, bucketed),
       ``fused="auto"`` and ``"off"`` in turns: wall time, grid reps/s,
       K1 launches (one per (n, ε) bucket: 18); gates: per method the
       grid-wide mean coverage of the two arms within 0.01 and mean
       ci_len within 2%, 144 × 250 finite fused rows, the two fused runs
       bit-equal; then K1 on each bucket's own seeds and ρ (2000 reps,
       NI + INT), held against its plain version (≥ 99% of replications
       within tolerance) and timed against its bound;
   (b) the smallest bucket (n = 1000, ε = (1, 1), 8 points) unfused on the
       card and the CPU: within 1e-5 on ≥ 99% of replications;
   (c) the reference's subG grid (120 points, n = 2500-12,000, B = 250),
       ε-merged and not: wall time; per-method mean coverage within 0.01;
   (d) resume: the fused grid rerun into its directory runs no point,
       launches nothing and is bit-equal; the unfused grid there loads no
       fused cache; ``detail_all.rds`` reads back;
   (e) the sign acceptance points at 2¹⁸ reps through ``run_campaign``,
       against the JAX package's committed coverage at B = 1,015,808:
       within 0.003, ``sign_laplace`` exactly (NI 0, INT 1), and the
       det-vs-mc criterion passes;
10. the HRS real-data pipeline (``dpcorr_torch.hrs``; no kernel of its
    own: torch ops on the key-tree), at the panel's full shape, driven
    with the launch counts set to 0 just before it and read just after:
    (a) ingest: a synthetic panel of the real one's shape
        (``perf_hrs.synthetic_panel``: 723,744 rows, 16 waves, 19,433
        complete cases in wave 2) written as gzip RDS by the port's
        writer and read back through ``io.rds.read_rds_table``, timed;
    (b) card against CPU on the same keys: the point estimates (ρ̂ and CI
        ends within 1e-5, the λ/geometry block within 1e-5 relative, k
        and m exact), 3 ε × 64 sweep replications and the bootstrap's
        first 256 replications (≥ 99% of rows within 1e-5);
    (c) the ε-sweep at the reference size (23 ε × 200 replications × 2
        methods = 9,200 runs, real-data-sims.R:345-346) under a tracer
        writing a temporary JSONL (one ``hrs.eps_sweep`` root with 23
        ``hrs.dispatch`` and 23 ``hrs.fetch`` children), and the
        bootstrap at 10,000 replications at ε = 2 (BASELINE.md config 4):
        seconds, reps/s, peak device memory, and from ``perf_hrs`` one
        ε and one bootstrap chunk split by stage with the device's idle
        share;
    (d) statistics gates: per method the mean CI length at ε = 2.45 is
        below that at ε = 0.25, and the mean ρ̂ over the three largest ε
        lies within 0.05 of the non-private ρ; the NI bootstrap's
        [q025, q975] contains the non-private ρ;
11. the R seam, the native RDS reader and the grid's fan-out, driven with
    the launch counts set to 0 just before it and read just after (the
    worker processes report their own):
    (a) ``rbridge.run_design_rows`` over the v1 grid's 144 rows, B = 250,
        bucketed, ``fused="auto"``: 18 K1 launches, the reference's column
        order and dtypes, bit-equal to phase 9a's fused grid; on the
        smallest bucket's 8 rows ``local``, ``sharded`` and bucketed
        unfused bit-equal; ``run_hrs_sweep`` on phase 10a's panel file
        (3 ε × 64 reps) equal to ``hrs.eps_sweep`` on the same keys;
    (b) the native reader (``csrc/rdsread.cpp``, built in phase 2 with the
        kernels): ``native_reader()`` loads it, and it and the Python
        reader read phase 10a's 723,744-row panel in turns, every column
        equal (values, NA positions, levels, labels), seconds of each;
    (c) ``run_grid_multihost`` on the v1 grid (B = 250, bucketed, fused
        auto) over two worker processes sharing the card, then as a gloo
        group: each bit-equal to phase 9a's fused grid, the workers' K1
        launches summing to 18, one rank merging; ``run_summary_sharded``
        at the north-star point (2¹⁴ reps) against ``run_detail_sharded``:
        the f32 sums and the mean fields within 1e-6 relative (the
        variance, a difference of two sums, within 1e-3); seconds of each
        arm beside the single-process grid's;
    (d) the tables ``report --from`` reads (``detail_all.npz``,
        ``summ_all.npz``, ``hrs_sweep_summary.npz``) reload equal; the
        card's machine has no matplotlib, so nothing is drawn;
12. the online serving stack (``dpcorr_torch.serve``; no kernel of its
    own: the estimators' torch ops, as the JAX package serves through
    XLA), driven with the launch counts set to 0 just before it and read
    just after (K1 must not launch):
    (a) the exact engine in process: 4 families × 256 pinned requests at
        n = 10⁴, ε = (1.0, 0.5), from 32 client threads through
        ``InProcessClient`` (``max_batch`` 64, ``max_delay`` 5 ms):
        every response bit-equal to the direct single call on the card,
        mean flush size > 1; req/s and p50/p99 latency;
    (b) the vector engine: 1024 ``ni_sign`` requests at n = 10⁴ ((a)'s
        256 and 768 more), every lane within the registry's card
        contract against the direct call (1e-5; lanes bit-equal and the
        largest distance in ulps printed), and lanes at widths 2 and 5
        within it against the same lanes at width 64; req/s, p50/p99;
    (c) the HRS wave-2 width: 64 ``ni_sign`` and 64 ``int_sign`` requests
        at n = 19,433 through (a)'s server, in the 32,768 n-bucket with
        exact-n kernel keys, bit-equal to the direct call;
    (d) the HTTP front end on port 0 with a warm set: ``/readyz`` 503
        until it is resident, then 200; 64 of (a)'s requests through
        ``HttpEstimateClient`` bit-equal to the direct call;
        ``/healthz``, ``/stats`` and ``/metrics`` served and agreeing; an
        over-budget request gets 403 and spends nothing; a full queue
        (``max_queue`` 2) gets 429 with its charge refunded;
    (e) the ledger and the trail: the spend equals Σ ``request_charges``
        of the admitted requests, and the audit trail replays to the
        ledger's state (in memory for (a)-(c), the JSONL file for (d));
    (f) 16 requests per family through a CPU server and a card server:
        within 1e-5 on ≥ 99% of them (phase 8a's tolerance);
    (g) the cost of request-key derivation per admission, the launches
        of one flush per engine and family (``torch.profiler``), and the
        phase's seconds.

13. the two-party protocol and the N-party federation
    (``dpcorr_torch.protocol``; no kernel of its own: the estimators'
    torch ops, as the JAX parties compute through XLA), at the HRS wave-2
    width (n = 19,433 complete cases of phase 10a's panel, age for X and
    BMI for Y, DP-standardized), driven with the launch counts set to 0
    just before it and read just after (K1 must not launch):
    (a) all four families at ε = (1.0, 0.5) and (0.5, 2.0) in process,
        over loopback TCP and over TCP with faults (drop 0.10, delay
        50 ms, duplicate 0.05, benchmarks/protocol_load.py's): every
        result bit-equal across arms, roles and repeats and to
        ``serving_entry`` on the card on the same master key; the faulted
        arm retransmits; ``"hardened"`` keys give finite results unlike
        replay's; session latency p50/p90 per arm and family;
    (b) two ``python -m dpcorr_torch party`` processes (int_sign, y
        sends), each with its journal, ledger, audit trail and
        transcript: bit-equal to (a), every transcript clean and its
        ledger balanced;
    (c) a second pair (ni_sign) whose y is killed at ``gate.post_charge``
        (``DPCORR_CHAOS``, exit 42) and restarted with the same command
        line: bit-equal to (a), each role's ε charged once;
    (d) the 3-party, 4-column federation of benchmarks/protocol_load.py
        --matrix for all four families, in process and over TCP: every
        cell bit-equal to its two-party run on the card, ε spent at
        ``optimal_eps``, a crash at ``federation.pre_release`` resumed
        with ε spent once; cells/s;
    (e) each session on the CPU within 1e-5 of the card's (subG also
        2.5e-7 relative; a sign family beyond it only at a tie);
    (f) CUDA activities per session (``torch.profiler``).

14. the stream service and the per-user budget directory
    (``dpcorr_torch.stream``, ``dpcorr_torch.serve.budget_dir``; no kernel
    of their own), at n = 10⁶ and 19,433 (``stream_phase``; K1 must not
    launch).

15. the serve fleet (``dpcorr_torch.serve.fleet``), the fleet telemetry
    plane (``dpcorr_torch.obs.fleet``) and the step-kill ``chaos``
    command; no kernel of their own (the replicas and parties compute
    through phases 12-13's paths), driven with the launch counts set to 0
    just before it and read just after (K1 must not launch in this
    process):
    (a) three ``python -m dpcorr_torch serve --device cuda`` replicas
        under ``Supervisor`` over one leased budget directory (64 users,
        8 shards, lease TTL 1.5 s) behind a ``FleetFrontend``; pinned
        ``ni_sign`` requests at n = 10⁴, ε = (1.0, 0.5) from 8 client
        threads over HTTP through the front end: every request answers
        200; client successes equal Σ of the per-replica
        ``requests_total`` deltas in ``FleetCollector``'s merged
        registry; 16 answers bit-equal to the direct call on the card;
    (b) one replica SIGKILLed during the second phase of traffic: every
        request still succeeds, the supervisor restarts it once with the
        same argv, each of its shards is re-leased live at a higher
        epoch, ``fleet_replay`` of the merged audit trails, the on-disk
        user balances and Σ charges agree binary-exact, and each
        survivor's trail replays to its ledger;
    (c) ``python -m dpcorr_torch chaos --device cuda`` on four cases at
        once (gate.post_charge x, ledger.post_persist y,
        budget.mid_compaction x, federation.pre_release y), each
        bit-identical to its uninterrupted reference with ε spent once;
    (d) 0 K1 launches in this process;
    (e) card-stamped: boot seconds, req/s with p50/p99 through the front
        end for a one-replica cell and the fleet, qps(3)/qps(1)
        (reported only), seconds from the kill to the first success on a
        victim shard, seconds per chaos case, the phase's wall time.

16. the build-and-dispatch layer (``dpcorr_torch.plan``,
    ``dpcorr_torch.utils.compile``, ``dpcorr_torch.obs.transfer``) at
    n = 10⁴, each part reading the K1 launch count and the transfer
    counters around itself:
    (a) ``RepBlockPipeline`` unfused (2¹⁶ reps) and fused (K1, 2²⁰ reps)
        under ``placement="local"`` and ``"mesh"`` over the one card:
        sums bit-equal across placements and to phases 4-5's on the same
        keys; one fetch and ``blocks`` donated blocks per run; K1
        launches = blocks x chunks on the fused arm, 0 on the other;
    (b) the fused v1 grid through the executor: 18 K1 launches, 18
        fetches, tables bit-equal to phase 9a's fused run;
    (c) ``python -m dpcorr_torch serve --aot on | off`` in turns (on,
        then off) with the same warmup set (``ni_sign`` at n = 10⁴, every
        batch width to 64): seconds to ``/readyz`` 200, the first flush's
        latency after it, the ``dpcorr_compile_seconds`` count and sum,
        the recompile causes; 8 answers bit-equal to the direct call in
        every arm;
    (d) ``finish_batch`` through the executor bit-equal to the direct
        ``finish`` on the HRS-width pair, all four families;
    (e) ``StreamService(placement="mesh")`` over the one card against
        ``"local"``: release bytes equal; the transfer counters' host
        reads and copies per release;
    (f) the CUDA-graph probe (a measurement; no path dispatches through a
        graph): one fused block (2¹⁴ reps, key-tree plus K1) and one
        exact-engine ``ni_sign`` single call captured into
        ``torch.cuda.CUDAGraph``: each replay bit-equal to the eager call
        or not, host ms of eager and replay, device activities of each
        (``torch.profiler``); replays counted here, since
        ``KERNEL_LAUNCHES`` counts in Python.

17. the measuring layer (``dpcorr_torch.utils.{geometry,roofline,
    profiling,doctor}``, ``dpcorr_torch.obs.{prof,devicemon}``), each
    part reading the K1 launch count around itself:
    (a) ``python -m dpcorr_torch doctor --probe --json``: verdict ok,
        the probe names the card, ``nvcc`` with ``sm_90a``, K1's library
        current in ``_build/``, no strays;
    (b) chunk widths on the main path at n = 10⁴: the unfused
        ``run_sim_one`` (B = 4096; width 2 on its first 256 replications)
        at widths 2, 64 and each ladder chunk, and the fused pipeline's
        ``block_detail`` at each ladder chunk, every field against the
        widest: bit-equal or not and the largest difference;
    (c) ``autotune`` of the fused (K1) and unfused main-path pipelines
        and of ``grid-sign`` at n = 1000 into a work-directory cache
        (``DPCORR_GEOMETRY_CACHE``): winners with probe reps/s; a second
        call from the cache with no probe; ``obs geometry --json`` lists
        the three; the unfused v1 grid with ``geometry="auto"`` takes the
        tuned chunk at n = 1000 and equals 9a's unfused run (bit-equal
        under one stamp when (b) found the widths bit-equal);
    (d) the v1 grid unfused, then fused, with ``precompile`` off, then
        on: bit-equal, ``precompiled`` on no bucket (the knob is inert
        in the port), the wall time of each arm;
    (e) the 2²⁰-rep fused pipeline without a ``BlockProfiler``, with one
        at ``max_syncs=64`` (cadence 1) and with one at ``max_syncs=8``
        (cadence 8), four turns each: sums bit-equal to phase 5's, one
        fetch a run, syncs within each profiler's cap, the artifacts
        read back; seconds of the three (reported only: the card's
        call-to-call spread is wider than a 3% gate);
    (f) ``roofline.summarize`` of (e)'s reps/s against the H100's peaks;
        K1's bound from ``utils.roofline`` equal to phase 7's; the
        device monitor's watermarks (in use ≤ peak ≤ limit = the card's
        memory); a ``profiling.trace`` of one fused block whose CUDA
        events name K1's kernel, with its ``profiler.trace`` span.
18. the operator's tools (``python -m dpcorr_torch obs ...``; they
    compute nothing on a device), each run as a process that sees no
    card (``CUDA_VISIBLE_DEVICES`` empty) and cannot import torch, over
    services running on the card, the K1 launch count zeroed before the
    phase and read after it (0):
    (a) one ``serve`` process at phase 12's width (n = 10⁴, ε = (1, 0.5))
        with ``--audit``, ``--trace``, ``--flight-recorder`` and a ledger,
        32 requests over ``ni_sign`` and ``int_sign``: ``obs top --once``
        shows the request count and ε spent of ``/stats``; ``obs top
        --fleet`` with a dead second target shows it DOWN; ``obs budget
        --json`` spends what the ledger holds, binary-exact; ``POST
        /obs/trigger`` slo_page answers 200 and dumps, a bogus reason
        400; ``obs dump --trace-id`` rebuilds one admitted request's span
        chain, cost record and ε trail; ``obs chrome`` writes one event
        per span;
    (b) phase 13's 3-party, 4-column federation (``ni_sign``, ε = 1,
        n = 19,433) in process on the card with ledgers, audit trails,
        transcripts, journals and a scrape endpoint per party: ``obs
        provenance --json`` finds no divergence and a total equal to
        ``optimal_eps()`` float for float; a copy with one charge amount
        halved exits 1 naming ``tampered-charge`` and the party; ``obs
        top --federation --once`` shows every party's cells done;
    (c) ``obs watch --once`` over phase 14c's stream workdir, (a)'s trail
        (with its URL) and (b)'s transcripts and journals: no violation;
        copies with a WAL byte flipped, a charge line duplicated and a
        release seq rewound each exit 1 with the expected kind, and a
        rerun from the same checkpoint raises nothing again; one live
        ``obs watch --interval 0.5`` over a copy of (a)'s trail: the
        seconds from a duplicated charge line to the violation and to the
        serve's ``sentinel_violation`` dump.
19. the static analyser and the lock witness (``dpcorr_torch.analysis``,
    ``dpcorr_torch.utils.syncwatch``) and ``dpcorr_torch.ops.fastnorm``,
    the K1 launch count zeroed before the phase and read after it (0 in
    this process; the witnessed grid reports its own):
    (a) ``lint`` and ``lint --deep`` each in a process that cannot
        import torch: exit 0, seconds, and the findings each rule's
        reviewed suppressions hold back (the deep pass rerun with them
        off);
    (b) with ``DPCORR_SYNCWATCH=1`` and one ``DPCORR_SYNCWATCH_DIR``:
        ``grid --fused auto`` on phase 9a's v1 grid (table bit-equal to
        9a's unwatched run, 18 K1 launches); one ``serve --user-dir``
        process at phase 18a's width under concurrent HTTP requests over
        8 users, then SIGINT; one ``chaos`` case (``ni_sign``, victim x
        killed at ``budget.mid_compaction``);
    (c) every watched process left its artifact (the killed victim its
        crash-hook dump), the artifacts wrap port lock sites, and ``lint
        --witness`` over them exits 0: artifacts, wrapped sites, observed
        and predicted edges, unknown sites;
    (d) ``fastnorm.gen_gaussian_bm`` at n = 10⁶ on the card within 1e-5
        of the CPU per element, its sample correlation within 0.005 of
        ρ = 0.5, and its time.
20. K1's stage ladder (``dpcorr_torch.bisect``, ``ops/ladder.py`` →
    ``csrc/fused_ni_ladder.cu``, the counterpart of
    ``benchmarks/pallas_bisect.py``'s kernel) and K1 above its
    shared-memory cap on the planes:
    (a) ``ptxas`` registers and spills of the ladder's 14 variants (L1-L5
        × external or in-kernel bits, L4-L5 with planes and without); the
        ladder kernel against its plain version at L1-L5, B = 256 random
        bits, at n = 1000, 10⁴, the m' = 16 layout and n = 40,000 (L4-L5
        without planes): every replication within 1e-5 × Σ|terms| at
        L1-L4, ≥ 99% at L5 (a sign at a tie moves it by 1/m); in-kernel
        mode bit-equal to external mode on ``philox_bits``; where the
        planes fit, L4-L5's variant without them forced bit-equal to the
        one with them in both modes; the bisect's L4-L5 probes in
        process at n = 40,000;
    (b) each level's ms at B = 2¹⁴, n = 10⁴, in-kernel (L6 = K1 at the
        same shape, L7 = K1 at B = 4096), its plain version's ms, its
        bound (``utils.roofline.ladder_pipe_ops``) and the increment from
        the level before; L6 within 10% of phase 7's K1 time;
    (c) ``python -m dpcorr_torch.bisect`` as a process, started beside
        phase 19 and waited on before (b)'s times, the launch counts its
        probes report read from its report: health OK, seven probes ok
        and finite, no culprit, the ladder launched once in each of L1-L5
        and K1 once in each of L6-L7 (the probes' own ms, taken beside
        phase 19, are not printed);
    (d) K1's variant without planes against its plain version in all 16
        modes at n = 28,673 (NI) / 25,601 (INT), 40,000 and 10⁵ at
        ε = (1, 1), and 10⁵ at ε = (0.25, 0.25) (m = m' = 128), B = 256,
        as phase 3 holds the variant with planes; the variant forced at
        every phase 3 layout (n ≤ 20,000) bit-equal to the one with
        planes in all 16 modes; its in-kernel NI time at n = 10⁵,
        B = 2¹⁴ and n = 10⁶, B = 2¹⁰ beside its bound;
    (e) the v1 sign grid cut to one bucket at n = 40,000, ε = (1, 1)
        (8 ρ × 250), ``fused="auto"`` then ``"off"``, the launch counts
        set to 0 before each arm and read after it: one K1 launch, of the
        variant without planes, where the earlier gate (``fits_on_chip``)
        sent the bucket unfused (0 launches); coverage in [0.90, 0.99]
        per method and arm; the arms' mean ρ̂ − ρ within 4 Monte-Carlo
        standard errors.
21. the key-tree's rbg-family implementations (``DPCORR_PRNG=rbg`` or
    ``unsafe_rbg``; ``utils/rng.py``), whose draws run on XLA's Philox
    bit generator, ``ops/rbg.py`` → ``csrc/rbg_bits.cu``:
    (a) the kernel bit-equal to its plain version on the CPU (and on the
        card) for 2¹⁰ rbg keys × 2·10⁴ words, the carry-crossing key
        ``[5, 2³²−1, 2³²−2, 2³²−1]``, and unsafe_rbg's ``fold_in`` (2¹⁰
        replication keys) and ``split``;
    (b) the north star on rbg keys, every launch count set to 0 just
        before and read just after: unfused, NI and INT, 2¹⁶
        replications, each coverage in [0.90, 0.99]; fused (K1), 2²⁰
        replications, NI coverage in [0.90, 0.99] and sums other than
        phase 5's threefry sums (the seeds come from the impl); rbg_bits
        and K1 each launched;
    (c) the unfused NI pipeline (2¹⁶ replications) on threefry and on rbg
        in turns (threefry, rbg, rbg, threefry): reps/s; per block of
        2¹⁴, rbg_bits launches and CUDA activities (a measurement, not a
        claim);
    (d) the kernel's ms at 2¹⁴ keys × 2·10⁴ words (the unfused block's
        draw), its bound (``utils.roofline.rbg_bits_ops`` and
        ``rbg_bits_bytes``: int64 words at 3.35 TB/s against its int32
        operations), its plain version's ms on the card, its ``ptxas``.
22. HRS, serving, the stream, the protocol and the federation on the
    rbg-family key-trees, each reading the rbg_bits and K1 launch counts
    around itself.
23. the key-tree's threefry2x32 kernel (``ops/threefry.py`` →
    ``csrc/threefry.cu``), whose launches phases 4-5 count on the main
    path (the hash and the uniform entries must launch there, and every
    ``uniform`` call take the kernel: ``rng.UNIFORM_CALLS["ops"]`` 0):
    (a) bits bit-equal to ``threefry_bits_plain`` on the same card keys
        at 2¹⁴ replication keys × 2·10⁴ words (the unfused block's
        draw) and at 512 × 65,536 (a chunk draw of the stress study),
        uniform bit-equal to ``threefry_uniform_plain`` at both shapes
        (``normal``'s bounds and the bounded factor's), and hash
        bit-equal to ``threefry_hash_plain`` on the same card operands
        at the fused path's 2²⁰ folds (one key over the replication
        indices), each call one launch;
    (b) each case's ms at those shapes against its bound (the
        definition's rotations and xors, 41 a bits or uniform word and
        40 a hash, at the integer ALU's 64 a clock per SM; the int64 or
        f32 stores at 3.35 TB/s), its plain version's ms on the card,
        its ``ptxas``.

Every failure raises. The last line is the device record; before it come
the per-kernel JSON record and the card line. Run from the repository
root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
import sys
import threading
import time

import numpy as np
import torch

N, EPS, RHO, ALPHA = 10_000, (1.0, 1.0), 0.5, 0.05
UNFUSED_REPS = 1 << 16
FUSED_BLOCK = 1 << 14          # replications per kernel launch on the main path
FUSED_BLOCKS = 64              # 2^20 replications
DETAIL_REPS = 1 << 16
COMPARE_B = 256
INT_REF_REPS = 1 << 13

#: (n, ε) of each lane-group layout the kernel branches on: m' = 1, 8,
#: 16 (m = 11, with leftovers), 32, 64, 128, n = 1000 and 20,000, and
#: m' = 8 with leftovers (n = 1500)
COMPARE_GEOMETRIES = [
    (10_000, (4.0, 2.0)), (10_000, (1.0, 1.0)), (9_000, (1.5, 0.5)),
    (10_000, (0.5, 0.5)), (10_000, (0.5, 0.25)), (10_000, (0.25, 0.25)),
    (1_000, (1.0, 1.0)), (20_000, (1.0, 1.0)), (1_500, (1.0, 1.0)),
]
#: (n, ε, compute_int) where the batch noise does not fit beside the
#: planes, so the sweep draws it: m' = 1 and 8 at the cap on n (NI and
#: INT), m' = 2, 4, 64, 128
NOISE_IN_SWEEP = [
    (28_000, (4.0, 2.0), False), (25_000, (4.0, 2.0), True),
    (20_000, (2.0, 2.0), False), (20_000, (2.0, 2.0), True),
    (24_000, (1.5, 1.5), False), (24_000, (1.5, 1.5), True),
    (28_000, (1.0, 1.0), False), (25_000, (1.0, 1.0), True),
    (28_000, (0.5, 0.25), False), (28_000, (0.25, 0.25), False),
]

#: the JAX package's committed coverage at B ≈ 10⁶ for the sub-Gaussian
#: acceptance points (dpcorr/acceptance.py:109-130), copied here so the
#: script reads nothing of the JAX package: benchmarks/results/
#: acceptance_r02.json, points "subg_factor" det and mc (b = 1,015,808),
#: and benchmarks/results/acceptance_r03_subg_real.json, point
#: "subg_real" det (b = 1,048,576)
SUBG_POINT = dict(n=4000, rho=0.5, eps1=1.0, eps2=1.0,
                  dgp="bounded_factor", use_subg=True)
_NI_FACTOR = {"coverage": 0.9507869597404234, "mse": 0.33798967205709024,
              "ci_length": 1.4930936636463288}
ACCEPTANCE = {
    "subg_factor det": (SUBG_POINT, {
        "NI": _NI_FACTOR,
        "INT": {"coverage": 0.9415470246345766, "mse": 0.02039640261641433,
                "ci_length": 0.5391578020588044}}),
    "subg_factor mc": (dict(SUBG_POINT, mixquant_mode="mc"), {
        "NI": _NI_FACTOR,
        "INT": {"coverage": 0.9396736391129032, "mse": 0.02039640261641433,
                "ci_length": 0.5365214145952656}}),
    "subg_real det": (dict(SUBG_POINT, subg_variant="real"), {
        "NI": {"coverage": 0.9502944946289062, "mse": 0.3388798236846924,
               "ci_length": 1.492500677704811},
        "INT": {"coverage": 0.9500713348388672, "mse": 0.04646471468731761,
                "ci_length": 0.8032669238746166}}),
}
ACCEPTANCE_REPS = 1 << 18
#: card-against-CPU configurations of phase 8a, 256 replications each
PARITY = {
    "subg-grid": SUBG_POINT,
    "subg-real": dict(SUBG_POINT, subg_variant="real"),
    "stream-subg": dict(SUBG_POINT, n=40_000, stream_n_chunk=8192),
}
PARITY_REPS = 256
FULL_WIDTH = dict(n=12_000, rho=0.5, eps1=1.5, eps2=0.5,
                  dgp="bounded_factor", use_subg=True)
FULL_WIDTH_REPS, FULL_WIDTH_BLOCK = 1 << 16, 1 << 14
STREAM = dict(n=10**6, rho=0.5, eps1=1.0, eps2=1.0, dgp="bounded_factor",
              use_subg=True, stream_n_chunk=65536)
STREAM_REPS = 2048
#: replications resident per chunk on the materialized subG path
SUBG_CHUNK = 8192

#: the main-path variant's template flags (external, INT, ndtri, normalise,
#: noise in shared memory, planes in shared memory)
MAIN_VARIANT = (0, 0, 0, 1, 1, 1)

#: phase 9: the reference's grids at their published sizes, B = 250 per
#: point (vert-cor.R:486-499, ver-cor-subG.R:245)
GRID_B = 250
V1_POINTS, V1_BUCKETS = 144, 18
SUBG_GRID = dict(n_grid=(2500, 4000, 6000, 9000, 12000),
                 dgp="bounded_factor", use_subg=True)
SUBG_GRID_POINTS = 120
#: phase 10: the HRS pipeline at the panel's shape; the sweep's size is the
#: reference's (real-data-sims.R:345-346), the bootstrap's BASELINE.md
#: config 4's
HRS_SEED = 0
HRS_ROWS, HRS_COMPLETE = 723_744, 19_433
HRS_SWEEP_EPS, HRS_SWEEP_REPS = 23, 200
HRS_BOOT_REPS = 10_000
HRS_PARITY_EPS = (0.25, 1.25, 2.45)
HRS_PARITY_SWEEP_REPS, HRS_PARITY_BOOT_REPS = 64, 256

#: phase 11: the fan-out's worker processes, and the sharded summary's
#: replications at the north-star point
FANOUT_HOSTS = 2
SUMMARY_REPS = 1 << 14

#: phase 12: the serving stack at the north-star width, the JAX package's
#: load-generator ε pair (benchmarks/serve_load.py), and the HRS wave-2
#: width
SERVE_N, SERVE_EPS = 10_000, (1.0, 0.5)
SERVE_FAMILIES = ("ni_sign", "int_sign", "ni_subg", "int_subg")
SERVE_PER_FAMILY, SERVE_VECTOR_REQS, SERVE_CLIENTS = 256, 1024, 32
SERVE_HRS_PER_FAMILY, SERVE_HTTP_REQS, SERVE_PARITY_PER_FAMILY = 64, 64, 16
SERVE_MAX_BATCH, SERVE_MAX_DELAY_S = 64, 0.005
SERVE_HRS_BUCKET = 32_768

#: phase 13: the two-party protocol and the federation at the HRS wave-2
#: width, both ε orders (the second makes y the INT sender); the fault
#: arm at benchmarks/protocol_load.py's rates and ack timeout
PROTO_N, PROTO_SEED = HRS_COMPLETE, 2025
PROTO_EPS = ((1.0, 0.5), (0.5, 2.0))
PROTO_FAULT = {"drop": 0.10, "delay_s": 0.050, "duplicate": 0.05}
PROTO_FAULT_TIMEOUT_S = 0.5
PROTO_REPEATS = {"inproc": 3, "tcp": 3, "tcp+faults": 1}
FED_PARTIES = [("p0", ["a", "b"]), ("p1", ["c"]), ("p2", ["d"])]
PARTY_TIMEOUT_S = 300
#: phase 14 (widths, ε and seed in dpcorr_torch.perf_stream): timed
#: releases per family and width; serving with a user directory at the
#: north-star width; the directory drill of benchmarks/serve_load.py cut
#: from 10⁶ users to 2¹⁷
STREAM_TIMED_REPS = 10
SERVE_USERS, SERVE_USER_REQS = 32, 128
DIR_USERS, DIR_SHARDS, DIR_MAX_RESIDENT = 1 << 17, 64, 256
#: phase 15: the fleet at benchmarks/serve_load.py --fleet's settings (3
#: replicas, 64 users, 8 shards, lease TTL 1.5 s, 24 requests per replica
#: per phase) but at phase 12's width, n = 10⁴; 8 client threads; 16
#: answers held bit-equal to the direct call
FLEET_REPLICAS, FLEET_USERS, FLEET_SHARDS = 3, 64, 8
FLEET_LEASE_TTL_S, FLEET_PER_REPLICA, FLEET_CLIENTS = 1.5, 24, 8
FLEET_PARITY = 16
#: phase 16: the serving A/B's warm set and requests (phase 12's width and
#: ε pair), the stream comparison's windows at the HRS wave-2 width, and
#: the graph probe's block and timed calls
PLAN_WARMUP = f"ni_sign:{SERVE_N}:{SERVE_EPS[0]}:{SERVE_EPS[1]}:auto"
PLAN_SERVE_REQS, PLAN_STREAM_WINDOWS = 8, 2
GRAPH_BLOCK, GRAPH_CALLS = 1 << 14, 20
#: phase 18: requests per family through the watched serve, and the live
#: sentinel's poll interval
OBS_REQS_PER_FAMILY, OBS_WATCH_INTERVAL_S = 16, 0.5

#: the JAX package's committed coverage at B = 1,015,808 for the sign
#: acceptance points (dpcorr/acceptance.py:89-108), copied from
#: benchmarks/results/acceptance_r02.json so the script reads nothing of
#: the JAX package
SIGN_ACCEPTANCE = {
    "sign_normal": {"NI": 0.949646980531754, "INT": 0.9497798796622984,
                    "INT mc": 0.9479015719506049},
    "sign_low_eps": {"NI": 0.9485453944052419, "INT": 0.9497326266381049},
    "sign_laplace": {"NI": 0.0, "INT": 1.0},
}


def mode_label(flags) -> str:
    ext, ci, nd, norm, noise_smem, planes = flags
    return (f"{'external' if ext else 'philox'} {'NI+INT' if ci else 'NI'} "
            f"{'ndtri' if nd else 'boxmuller'} "
            f"{'normalise' if norm else 'raw'} "
            + (f"noise in {'smem' if noise_smem else 'sweep'}" if planes
               else "no planes"))


def within_tolerance(got, want):
    """Per replication: ΣT and ΣT² within 1e-4 relative, and the third
    output within 1e-5 absolute, of the plain version."""
    close = torch.isclose(got[:, :2], want[:, :2], rtol=1e-4, atol=0.0).all(1)
    return close & torch.isclose(got[:, 2], want[:, 2], rtol=0.0, atol=1e-5)


def compare_mode(n: int, eps, kw: dict, gen, rho, b: int = COMPARE_B):
    """One mode at one geometry, ``b`` replications (``rho`` of that
    length): per uniform source (external random, in-kernel Philox laid
    out by its plain twin) the share of replications within tolerance of
    the plain version and the largest |error| per output; and whether
    in-kernel mode equals external mode on ``philox_uniforms`` bit for
    bit."""
    from dpcorr_torch.ops import fused_ni

    rows = fused_ni.n_uniform_rows(n, *eps, kw["compute_int"])
    # dpcorr-lint: ignore[rng-raw-api] — random uniforms to hold the kernel's external mode against its plain version, not DP noise
    u = torch.rand(b, rows, 128, device="cuda",
                   generator=gen) * (1 - 2e-7) + 1e-7
    zeros = torch.zeros(b, 2, dtype=torch.int32, device="cuda")
    # dpcorr-lint: ignore[rng-raw-api] — random seeds for the same comparison, not DP noise
    seeds = torch.randint(-2**31, 2**31, (b, 2), generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)
    pu = fused_ni.philox_uniforms(seeds, n, *eps, kw["compute_int"],
                                  kw["normalise"])
    fracs, errs = [], []
    for sd, uu in ((zeros, u), (seeds, pu)):
        got = fused_ni.fused_ni_sums(sd, rho, n, *eps, uniforms=uu, **kw)
        # dpcorr-lint: ignore[sync-in-loop] — the kernel must finish before its plain version runs on the same buffers
        torch.cuda.synchronize()
        want = fused_ni.fused_ni_plain(sd, rho, uu, n=n, eps1=eps[0],
                                       eps2=eps[1], **kw)
        if not torch.isfinite(got).all():
            raise RuntimeError(f"kernel gave NaN/Inf: n={n} eps={eps} {kw}")
        # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
        fracs.append(within_tolerance(got, want).float().mean().item())
        # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
        errs.append((got - want).abs().max(0).values.tolist())
    inside = fused_ni.fused_ni_sums(seeds, rho, n, *eps, **kw)
    torch.cuda.synchronize()
    return fracs, errs, torch.equal(inside, got)


def compare_kernel_with_plain() -> float:
    """Phase 3: the kernel against its plain version in all 16 modes at
    every geometry of ``COMPARE_GEOMETRIES`` and ``NOISE_IN_SWEEP``.
    Returns the largest |ΣT| error seen."""
    from dpcorr_torch.ops import fused_ni

    # dpcorr-lint: ignore[rng-raw-api,rng-literal-seed] — a fixed generator for the comparison's inputs, not DP noise
    gen = torch.Generator(device="cuda").manual_seed(2025)
    rho = torch.linspace(-0.6, 0.9, COMPARE_B, device="cuda")
    worst = 0.0
    cases = [(n, eps, ci) for n, eps in COMPARE_GEOMETRIES
             for ci in (False, True)] + NOISE_IN_SWEEP
    for n, eps, compute_int in cases:
        m, m_pad, k, leftover, _ = fused_ni.layout(n, *eps)
        noise_smem = fused_ni._Consts(n, *eps, (0.0, 0.0), (1.0, 1.0)
                                      ).noise_in_smem(compute_int)
        if (n, eps, compute_int) in NOISE_IN_SWEEP and noise_smem:
            raise RuntimeError(f"n={n} eps={eps} int={compute_int} keeps "
                               f"its noise in shared memory")
        for gauss in ("boxmuller", "ndtri"):
            for normalise in (True, False):
                kw = dict(normalise=normalise, compute_int=compute_int,
                          gauss=gauss)
                fracs, errs, bit_equal = compare_mode(n, eps, kw, gen, rho)
                worst = max(worst, errs[0][0], errs[1][0])
                print(f"compare n={n} eps={eps} m={m} m'={m_pad} k={k} "
                      f"left={leftover} int={int(compute_int)} {gauss} "
                      f"norm={int(normalise)} noise in "
                      f"{'smem' if noise_smem else 'sweep'}: within tol "
                      f"external {fracs[0]:.4f} philox {fracs[1]:.4f} of "
                      f"{COMPARE_B}; in-kernel == external on "
                      f"philox_uniforms: {bit_equal}; max |err| "
                      f"{[f'{e:.3g}' for e in errs[0] + errs[1]]}",
                      flush=True)
                if min(fracs) < 0.99:
                    raise RuntimeError(
                        f"kernel disagrees with its plain version: {fracs} "
                        f"within tolerance, n={n} eps={eps} {kw}")
                if not bit_equal:
                    raise RuntimeError(
                        f"in-kernel mode differs from external mode on "
                        f"philox_uniforms: n={n} eps={eps} {kw}")
    return worst


def run_pipeline(body, block_reps, chunk, n_blocks, key, out_len=3):
    from dpcorr_torch.sim import DETAIL_FIELDS, RepBlockPipeline

    pipe = RepBlockPipeline(body, out_len, key=key, block_reps=block_reps,
                            chunk_size=chunk)
    pipe.run(1, start_block=10_000)  # warm: allocator, first launches
    t0 = time.perf_counter()
    sums, n_reps = pipe.run(n_blocks)
    dt = time.perf_counter() - t0
    if pipe.fetches != 2:
        raise RuntimeError(f"expected one host read per run, saw "
                           f"{pipe.fetches} over two runs")
    out = {"reps": n_reps, "seconds": dt, "reps_per_s": n_reps / dt,
           "sums": list(sums)}
    if out_len == 3:
        mse, cover, ci_len = (s / n_reps for s in sums)
        return {**out, "mse": mse, "coverage": cover, "ci_length": ci_len}
    return {**out, **{f: s / n_reps for f, s in zip(DETAIL_FIELDS, sums,
                                                      strict=True)}}


def reset_launches() -> None:
    from dpcorr_torch.ops import fused_ni

    for name in fused_ni.KERNEL_LAUNCHES:
        fused_ni.KERNEL_LAUNCHES[name] = 0


def read_launches(label: str) -> dict:
    from dpcorr_torch.ops import fused_ni

    launches = dict(fused_ni.KERNEL_LAUNCHES)
    print(f"launches in the {label} run: {launches} (the path has no kernel "
          f"of its own)", flush=True)
    return launches


def detail_agreement(got, want) -> float:
    """Share of replications whose 12 detail fields agree: 1e-5 absolute,
    and 1e-6 relative on the squared errors, which magnify ρ̂'s last bits
    by 2|ρ̂ − ρ|."""
    from dpcorr_torch.sim import DETAIL_FIELDS

    ok = torch.ones(got[0].shape[0], dtype=torch.bool)
    for name, g, w in zip(DETAIL_FIELDS, got, want, strict=True):
        rtol = 1e-6 if name.endswith("se2") else 0.0
        # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
        ok &= torch.isclose(g.cpu(), w.cpu(), rtol=rtol, atol=1e-5)
    return ok.float().mean().item()


def card_against_cpu(card: str) -> None:
    """Phase 8a: the same keys through the card and the CPU."""
    from dpcorr_torch.models.dgp import gen_bounded_factor
    from dpcorr_torch.sim import SimConfig, _one_rep
    from dpcorr_torch.utils import rng

    for n, seed in ((4000, 1), (10_000, 98)):
        keys = rng.rep_keys(rng.master_key(seed), 64)
        # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
        perm = torch.equal(rng.permutation(keys.cuda(), n).cpu(),
                           rng.permutation(keys, n))
        # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
        data = torch.equal(gen_bounded_factor(keys.cuda(), n, 0.5).cpu(),
                           gen_bounded_factor(keys, n, 0.5))
        print(f"[{card}] card == CPU at n={n}, seed {seed}: permutation "
              f"{perm}, bounded-factor data {data}", flush=True)
        if not (perm and data):
            raise RuntimeError(f"card and CPU differ at n={n}: permutation "
                               f"{perm}, bounded-factor data {data}")
    keys = rng.rep_keys(rng.master_key(), PARITY_REPS)
    for name, kw in PARITY.items():
        cfg = SimConfig(**kw, b=PARITY_REPS)
        share = detail_agreement(_one_rep(keys.cuda(), cfg.rho, cfg),
                                 _one_rep(keys, cfg.rho, cfg))
        print(f"[{card}] _one_rep {name}: card agrees with CPU on "
              f"{share:.4f} of {PARITY_REPS} replications", flush=True)
        if share < 0.99:
            raise RuntimeError(f"_one_rep {name}: card agrees with CPU on "
                               f"only {share:.4f} of replications")


def acceptance_points(card: str) -> dict:
    """Phase 8b: the subG acceptance points against the committed
    coverage of the JAX package. Returns each point's summary."""
    from dpcorr_torch.sim import SimConfig, run_sim_one

    summaries = {}
    for label, (kw, ref) in ACCEPTANCE.items():
        cfg = SimConfig(**kw, b=ACCEPTANCE_REPS, chunk_size=SUBG_CHUNK)
        # dpcorr-lint: ignore[sync-in-loop] — timing barrier: the clock starts on an idle card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = run_sim_one(cfg).summary
        dt = time.perf_counter() - t0
        summaries[label] = summary
        print(f"[{card}] acceptance {label}, B={ACCEPTANCE_REPS}, "
              f"{dt:.3f} s ({ACCEPTANCE_REPS / dt:.1f} reps/s): "
              f"{json.dumps(summary)}", flush=True)
        for meth in ("NI", "INT"):
            got, want = summary[meth], ref[meth]
            gaps = {"coverage": abs(got["coverage"] - want["coverage"]),
                    "ci_length": abs(got["ci_length"] / want["ci_length"]
                                     - 1.0),
                    "mse": abs(got["mse"] / want["mse"] - 1.0)}
            print(f"acceptance {label} {meth}: |Δ coverage| "
                  f"{gaps['coverage']:.5f} (≤ 0.003), ci_length "
                  f"{gaps['ci_length']:.2%} (≤ 1%), mse {gaps['mse']:.2%} "
                  f"(≤ 3%) from the JAX package at B ≈ 10⁶", flush=True)
            if (gaps["coverage"] > 0.003 or gaps["ci_length"] > 0.01
                    or gaps["mse"] > 0.03):
                raise RuntimeError(f"acceptance {label} {meth} outside its "
                                   f"gates: {gaps}")
    return summaries


def full_width(card: str) -> dict:
    """Phase 8c: the block pipeline over the subG body at n = 12,000."""
    from dpcorr_torch.sim import DETAIL_FIELDS, SimConfig, _one_rep
    from dpcorr_torch.utils import rng

    cfg = SimConfig(**FULL_WIDTH)
    res = run_pipeline(lambda k: _one_rep(k, cfg.rho, cfg),
                       FULL_WIDTH_BLOCK, SUBG_CHUNK,
                       FULL_WIDTH_REPS // FULL_WIDTH_BLOCK,
                       rng.master_key(device="cuda"), len(DETAIL_FIELDS))
    print(f"[{card}] subG pipeline n={cfg.n} eps=({cfg.eps1}, {cfg.eps2}) "
          f"bounded_factor: {json.dumps(res)}", flush=True)
    if not 0.90 <= res["ni_cover"] <= 0.99:
        raise RuntimeError(f"full-width NI coverage {res['ni_cover']} "
                           f"outside [0.90, 0.99]")
    return res


def streaming(card: str, materialized: dict) -> dict:
    """Phase 8d: the streaming subG pair at n = 10⁶; ``materialized`` is
    the INT summary of phase 8b's ``subg_factor det`` point."""
    from dpcorr_torch.sim import DETAIL_FIELDS, SimConfig, run_sim_one
    from dpcorr_torch.sim import stress_chunk_size

    cfg = SimConfig(**STREAM, b=STREAM_REPS,
                    chunk_size=stress_chunk_size(STREAM_REPS, True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_sim_one(cfg)
    dt = time.perf_counter() - t0
    out = {"reps": STREAM_REPS, "seconds": dt,
           "reps_per_s": STREAM_REPS / dt, "chunk": cfg.chunk_size,
           **res.summary}
    print(f"[{card}] streaming n={cfg.n} n_chunk={cfg.stream_n_chunk} subG "
          f"pair: {json.dumps(out)}", flush=True)
    for name in DETAIL_FIELDS:
        if not torch.isfinite(res.detail[name]).all():
            raise RuntimeError(f"streaming {name}: non-finite values")
    if not 0.90 <= res.summary["NI"]["coverage"] <= 0.99:
        raise RuntimeError(f"streaming NI coverage outside [0.90, 0.99]: "
                           f"{res.summary['NI']}")
    it = res.summary["INT"]
    bias_gap = abs(it["bias"] - materialized["bias"])
    len_gap = abs(it["ci_length"] / (materialized["ci_length"]
                                     * math.sqrt(SUBG_POINT["n"] / cfg.n))
                  - 1.0)
    print(f"streaming INT against the materialized path at n="
          f"{SUBG_POINT['n']}: |Δ bias| {bias_gap:.5f} (≤ 0.003), ci_length "
          f"{len_gap:.2%} from √n scaling (≤ 2%)", flush=True)
    if bias_gap > 0.003 or len_gap > 0.02:
        raise RuntimeError(f"streaming INT differs from the materialized "
                           f"path: |Δ bias| {bias_gap}, ci_length {len_gap}")
    return out


def run_grid_timed(gcfg):
    """One grid run, host clock around it (it ends in host reads)."""
    from dpcorr_torch.grid import run_grid

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_grid(gcfg)
    return res, time.perf_counter() - t0


def method_means(res, metric: str) -> dict:
    """Grid-wide mean of one summary column per method."""
    s = res.summ_all
    return {m: float(s[metric][s["method"] == m].mean())
            for m in ("NI", "INT")}


def v1_grid_arms(card: str) -> dict:
    """Phase 9a: the reference's 144-point sign grid, bucketed, fused and
    unfused in turns, the launch counts set to 0 before each fused arm and
    read after it."""
    import numpy as np

    from dpcorr_torch.grid import GridConfig
    from dpcorr_torch.ops import fused_ni
    from dpcorr_torch.sim import DETAIL_FIELDS

    arms = {"auto": [], "off": []}
    fused_res = None
    for fused in ("auto", "off", "auto", "off"):
        reset_launches()
        res, dt = run_grid_timed(GridConfig(b=GRID_B, backend="bucketed",
                                            fused=fused))
        launches = fused_ni.KERNEL_LAUNCHES["fused_ni"]
        rps = V1_POINTS * GRID_B / dt
        arms[fused].append({"seconds": dt, "reps_per_s": rps,
                            "launches": launches,
                            "grid_reps_per_sec": float(
                                res.timings["grid_reps_per_sec"][0])})
        print(f"[{card}] 9a v1 grid, fused={fused}: {V1_POINTS} points x "
              f"{GRID_B} reps in {dt:.3f} s ({rps:.1f} grid reps/s; "
              f"dispatch+fetch {res.timings['grid_reps_per_sec'][0]:.1f}); "
              f"K1 launches {launches}; fused buckets "
              f"{int(res.timings['fused'].sum())}", flush=True)
        if fused == "auto":
            if launches != V1_BUCKETS or not res.timings["fused"].all():
                raise RuntimeError(f"fused v1 grid: {launches} launches, "
                                   f"expected {V1_BUCKETS}, one per bucket")
            for f in DETAIL_FIELDS:
                col = res.detail_all[f]
                if col.shape != (V1_POINTS * GRID_B,) or \
                        not np.isfinite(col).all():
                    raise RuntimeError(f"fused v1 grid {f}: bad values")
            if fused_res is not None:
                for f in DETAIL_FIELDS:
                    if not np.array_equal(res.detail_all[f],
                                          fused_res.detail_all[f]):
                        raise RuntimeError("two fused v1 runs differ")
            fused_res = res
        else:
            off_res = res
            if launches:
                raise RuntimeError("the unfused grid launched K1")
    cov_f, cov_o = method_means(fused_res, "coverage"), method_means(
        off_res, "coverage")
    len_f, len_o = method_means(fused_res, "ci_len"), method_means(
        off_res, "ci_len")
    for m in ("NI", "INT"):
        d_cov = abs(cov_f[m] - cov_o[m])
        d_len = abs(len_f[m] / len_o[m] - 1.0)
        print(f"9a {m}: mean coverage fused {cov_f[m]:.5f} unfused "
              f"{cov_o[m]:.5f} (|Δ| {d_cov:.5f} ≤ 0.01); mean ci_len "
              f"{len_f[m]:.5f} / {len_o[m]:.5f} ({d_len:.2%} ≤ 2%)",
              flush=True)
        if d_cov > 0.01 or d_len > 0.02:
            raise RuntimeError(f"fused and unfused v1 grids differ on {m}: "
                               f"coverage {d_cov}, ci_len {d_len}")
    return {"arms": arms, "fused": fused_res, "off": off_res}


def grid_bucket_times(card: str) -> dict:
    """K1 at each v1 bucket's launch, on that bucket's inputs: its points'
    seeds (``kernel_seeds`` of ``rep_keys(design_key(master, i), 250)``)
    and ρ per replication, NI + INT. Each launch is held against the plain
    version on the same words (``philox_uniforms``), then timed (CUDA
    events) beside the bound of the same work. These launches do not
    count."""
    from dpcorr_torch.grid import GridConfig
    from dpcorr_torch.ops import fused_ni
    from dpcorr_torch.utils import rng
    from dpcorr_torch.utils.device import time_cuda
    from dpcorr_torch.utils.roofline import fused_pipe_ops, least_time_ms

    gc = GridConfig()
    points = gc.design_points()
    master = rng.master_key(gc.seed, "cuda")
    out = {}
    for eps in gc.eps_pairs:
        for n in gc.n_grid:
            at = ((points["n"] == n) & (points["eps1"] == eps[0])
                  & (points["eps2"] == eps[1]))
            design = rng.design_key(master, torch.as_tensor(
                points["i"][at], dtype=torch.int64, device="cuda"))
            seeds = rng.kernel_seeds(rng.rep_keys(design, GRID_B)
                                     .reshape(-1, 2)).contiguous()
            rhos = torch.as_tensor(points["rho"][at], dtype=torch.float32,
                                   device="cuda").repeat_interleave(GRID_B)
            b = rhos.numel()
            got = fused_ni.fused_ni_sums(seeds, rhos, n, *eps,
                                         compute_int=True)
            want = fused_ni.fused_ni_plain(
                seeds, rhos, fused_ni.philox_uniforms(seeds, n, *eps, True),
                n=n, eps1=eps[0], eps2=eps[1], compute_int=True)
            # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
            share = within_tolerance(got, want).float().mean().item()
            # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
            err = (got - want).abs().max(0).values.tolist()
            if not torch.isfinite(got).all() or share < 0.99:
                raise RuntimeError(f"K1 at the v1 bucket n={n} eps={eps} "
                                   f"disagrees with its plain version: "
                                   f"{share} within tolerance")
            ms = time_cuda(lambda: fused_ni.fused_ni_sums(
                seeds, rhos, n, *eps, compute_int=True), 20)
            times = least_time_ms(fused_pipe_ops(n, eps, True), b,
                                  b * (8 + 4 + 12))
            by = max(times, key=times.get)
            out[(n, eps)] = {"ms": ms, "bound_ms": times[by], "bound_by": by,
                             "max_abs_err": err[0]}
            print(f"[{card}] K1 at the v1 bucket n={n} eps={eps} ({b} reps, "
                  f"NI+INT): within tol of the plain version {share:.4f}, "
                  f"max |err| {[f'{e:.3g}' for e in err]}; {ms:.4f} ms per "
                  f"launch, bound {times[by]:.4f} ms by {by} "
                  f"({times[by] / ms:.1%})", flush=True)
    return out


def grid_card_against_cpu(card: str) -> None:
    """Phase 9b: the smallest v1 bucket, unfused, on the card and the CPU."""
    from dpcorr_torch.grid import GridConfig, run_grid
    from dpcorr_torch.sim import DETAIL_FIELDS

    kw = dict(n_grid=(1000,), eps_pairs=((1.0, 1.0),), b=GRID_B,
              backend="bucketed")
    card_res = run_grid(GridConfig(**kw))
    cpu_res = run_grid(GridConfig(**kw, device="cpu"))
    share = detail_agreement(
        [torch.from_numpy(card_res.detail_all[f]) for f in DETAIL_FIELDS],
        [torch.from_numpy(cpu_res.detail_all[f]) for f in DETAIL_FIELDS])
    print(f"[{card}] 9b grid bucket n=1000 eps=(1, 1), 8 points: card "
          f"agrees with CPU on {share:.4f} of {8 * GRID_B} replications",
          flush=True)
    if share < 0.99:
        raise RuntimeError(f"grid bucket: card agrees with CPU on only "
                           f"{share:.4f} of replications")


def subg_grid_arms(card: str) -> dict:
    """Phase 9c: the reference's 120-point subG grid, bucketed, ε-merged
    and not."""
    from dpcorr_torch.grid import GridConfig

    runs = {}
    for merge in ("eps", "off"):
        res, dt = run_grid_timed(GridConfig(**SUBG_GRID, b=GRID_B,
                                            backend="bucketed",
                                            bucket_merge=merge))
        rps = SUBG_GRID_POINTS * GRID_B / dt
        runs[merge] = {"seconds": dt, "reps_per_s": rps,
                       "buckets": len(res.timings["n"]),
                       "coverage": method_means(res, "coverage")}
        print(f"[{card}] 9c subG grid, bucket_merge={merge}: "
              f"{SUBG_GRID_POINTS} points x {GRID_B} reps in {dt:.3f} s "
              f"({rps:.1f} grid reps/s; {len(res.timings['n'])} buckets); "
              f"mean coverage {json.dumps(runs[merge]['coverage'])}",
              flush=True)
    for m in ("NI", "INT"):
        gap = abs(runs["eps"]["coverage"][m] - runs["off"]["coverage"][m])
        if gap > 0.01:
            raise RuntimeError(f"merged and unmerged subG grids differ on "
                               f"{m} coverage by {gap}")
    return runs


def grid_resume(card: str, fused_res) -> None:
    """Phase 9d: the fused v1 grid into a directory, rerun there (every
    point cached, bit-equal, no launch), then unfused there (no fused
    cache loads); detail_all.rds reads back."""
    import tempfile

    import numpy as np

    from dpcorr_torch.grid import GridConfig, run_grid
    from dpcorr_torch.io.rds import read_rds_table
    from dpcorr_torch.ops import fused_ni

    with tempfile.TemporaryDirectory(prefix="dpcorr_smoke_grid_") as out:
        gc = GridConfig(b=GRID_B, backend="bucketed", fused="auto",
                        out_dir=out)
        first = run_grid(gc)
        reset_launches()
        again = run_grid(gc)
        launches = fused_ni.KERNEL_LAUNCHES["fused_ni"]
        ran = int(again.timings["points_run"].sum())
        same = all(np.array_equal(again.detail_all[f], v)
                   and np.array_equal(fused_res.detail_all[f], v)
                   for f, v in first.detail_all.items())
        off = run_grid(GridConfig(b=GRID_B, backend="bucketed", out_dir=out))
        off_ran = int(off.timings["points_run"].sum())
        table = read_rds_table(f"{out}/detail_all.rds")
        rds_ok = list(table) == list(off.detail_all) and all(
            np.array_equal(table[f].values, v)
            for f, v in off.detail_all.items())
    print(f"[{card}] 9d resume: rerun ran {ran} points with {launches} K1 "
          f"launches, detail bit-equal {same}; unfused in the same "
          f"directory ran {off_ran} of {V1_POINTS}; detail_all.rds reads "
          f"back equal: {rds_ok}", flush=True)
    if ran or launches or not same or off_ran != V1_POINTS or not rds_ok:
        raise RuntimeError("grid resume failed its gates")


def sign_acceptance(card: str) -> dict:
    """Phase 9e: the sign acceptance points through the port's campaign,
    against the JAX package's committed coverage."""
    from dpcorr_torch import acceptance

    points = [p for p in acceptance.POINTS if p.name in SIGN_ACCEPTANCE]
    t0 = time.perf_counter()
    table = acceptance.run_campaign(b=ACCEPTANCE_REPS, points=points)
    dt = time.perf_counter() - t0
    for row in table["points"]:
        ref = SIGN_ACCEPTANCE[row["point"]]
        got = {"NI": row["det"]["NI"]["coverage"],
               "INT": row["det"]["INT"]["coverage"]}
        if "mc" in row:
            got["INT mc"] = row["mc"]["INT"]["coverage"]
        print(f"[{card}] 9e acceptance {row['point']}, B={row['det']['b']}, "
              f"{row['det']['seconds']} s det: coverage {json.dumps(got)} "
              f"against the JAX package's {json.dumps(ref)}", flush=True)
        for key, want in ref.items():
            gap = abs(got[key] - want)
            exact = row["point"] == "sign_laplace"
            if (exact and got[key] != want) or gap > 0.003:
                raise RuntimeError(f"acceptance {row['point']} {key}: "
                                   f"{got[key]} against {want}")
    print(f"9e campaign {dt:.1f} s; det_mc_pass {table['det_mc_pass']}",
          flush=True)
    if not table["det_mc_pass"]:
        raise RuntimeError("acceptance: det-vs-mc criterion failed")
    return table


def rows_within(got: dict, want: dict, fields, atol: float = 1e-5) -> float:
    """Share of rows whose ``fields`` all agree within ``atol``."""
    import numpy as np

    ok = np.ones(len(want[fields[0]]), dtype=bool)
    for f in fields:
        ok &= np.isclose(got[f], want[f], rtol=0.0, atol=atol)
    return float(ok.mean())


def hrs_ingest(card: str, path: str):
    """Phase 10a: the full-shape synthetic panel written as gzip RDS to
    ``path`` and read back; returns the columns read."""
    import os

    from dpcorr_torch import hrs, perf_hrs
    from dpcorr_torch.io.rds import read_rds_table

    t0 = time.perf_counter()
    perf_hrs.write_panel(path, perf_hrs.synthetic_panel(HRS_SEED))
    write_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    cols = read_rds_table(path)
    read_s = time.perf_counter() - t0
    miss = hrs.wave_missingness(cols)
    rows = len(cols["wave"].values)
    complete = int(miss["complete"][miss["wave"] == 2][0])
    print(f"[{card}] 10a ingest: {rows} rows x {len(cols)} columns, "
          f"{size} bytes gzip; written in {write_s:.3f} s, read back through "
          f"io.rds.read_rds_table in {read_s:.3f} s (host); wave 2 "
          f"complete cases {complete}", flush=True)
    if rows != HRS_ROWS or complete != HRS_COMPLETE:
        raise RuntimeError(f"HRS ingest: {rows} rows and {complete} wave-2 "
                           f"complete cases, expected {HRS_ROWS} and "
                           f"{HRS_COMPLETE}")
    return cols


def hrs_card_against_cpu(card: str, cols, boot) -> None:
    """Phase 10b: point estimates, a sweep subset and the bootstrap's first
    replications on the card and the CPU, on the same keys. ``boot`` is
    the card's full bootstrap run."""
    import numpy as np

    from dpcorr_torch import hrs

    card_pt = hrs.point_estimates(cols=cols)
    cpu_pt = hrs.point_estimates(cols=cols, device="cpu")
    for meth in ("ni", "int_"):
        got, want = getattr(card_pt, meth), getattr(cpu_pt, meth)
        ci = max(abs(got[f] - want[f]) for f in ("rho_hat", "ci_low",
                                                 "ci_high"))
        aux = max(abs(got[f] / want[f] - 1.0) for f in want
                  if f not in ("rho_hat", "ci_low", "ci_high") and want[f])
        geometry = all(got[f] == want[f] for f in ("k", "m") if f in want)
        print(f"[{card}] 10b point estimates {meth.strip('_').upper()}: card "
              f"{json.dumps(got)}; |card - CPU| {ci:.3g} on rho_hat and CI "
              f"ends (<= 1e-5), {aux:.3g} relative on the lambda/geometry "
              f"block (<= 1e-5), k and m equal: {geometry}", flush=True)
        if ci > 1e-5 or aux > 1e-5 or not geometry or set(got) != set(want):
            raise RuntimeError(f"HRS point estimates {meth}: card and CPU "
                               f"differ")
    sweeps = [hrs.eps_sweep(cols=cols, eps_grid=HRS_PARITY_EPS,
                            reps=HRS_PARITY_SWEEP_REPS, device=dev)
              for dev in (None, "cpu")]
    share = rows_within(sweeps[0].runs, sweeps[1].runs, hrs.SWEEP_FIELDS)
    first = {f: v[:HRS_PARITY_BOOT_REPS] for f, v in boot.runs.items()}
    cpu_boot = hrs.bootstrap(cols=cols, reps=HRS_PARITY_BOOT_REPS,
                             device="cpu")
    boot_share = rows_within(first, cpu_boot.runs, hrs.BOOT_FIELDS)
    print(f"[{card}] 10b sweep {len(HRS_PARITY_EPS)} eps x "
          f"{HRS_PARITY_SWEEP_REPS} reps x 2 methods: card agrees with CPU "
          f"on {share:.4f} of rows; bootstrap's first "
          f"{HRS_PARITY_BOOT_REPS} reps: {boot_share:.4f} (>= 0.99 within "
          f"1e-5)", flush=True)
    if share < 0.99 or boot_share < 0.99 or not np.array_equal(
            sweeps[0].runs["eps_corr"], sweeps[1].runs["eps_corr"]):
        raise RuntimeError(f"HRS card and CPU differ: sweep {share}, "
                           f"bootstrap {boot_share}")


def hrs_workloads(card: str, cols) -> tuple:
    """Phase 10c: the ε-sweep at the reference size under a tracer, and
    the bootstrap at 10,000 replications; returns both results."""
    import os
    import tempfile

    import numpy as np

    from dpcorr_torch import hrs, perf_hrs
    from dpcorr_torch.obs import trace as obs_trace

    with tempfile.TemporaryDirectory(prefix="dpcorr_smoke_trace_") as d:
        spans_path = os.path.join(d, "spans.jsonl")
        obs_trace.configure(spans_path)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sweep = hrs.eps_sweep(cols=cols, reps=HRS_SWEEP_REPS)
            sweep_s = time.perf_counter() - t0
        finally:
            obs_trace.configure(None)
        spans = obs_trace.read_spans(spans_path)
    sweep_peak = torch.cuda.max_memory_allocated() / 2**30
    runs = len(sweep.runs["rho_hat"])
    roots = [sp for sp in spans if sp["name"] == "hrs.eps_sweep"]
    children = {name: [sp for sp in spans if sp["name"] == name
                       and roots and sp["parent_id"] == roots[0]["span_id"]]
                for name in ("hrs.dispatch", "hrs.fetch")}
    print(f"[{card}] 10c eps-sweep {HRS_SWEEP_EPS} eps x {HRS_SWEEP_REPS} "
          f"reps x 2 methods = {runs} runs in {sweep_s:.3f} s "
          f"({runs / sweep_s:.1f} runs/s), peak device memory "
          f"{sweep_peak:.3f} GiB; spans: {len(roots)} hrs.eps_sweep root, "
          f"{len(children['hrs.dispatch'])} hrs.dispatch and "
          f"{len(children['hrs.fetch'])} hrs.fetch children", flush=True)
    if runs != 2 * HRS_SWEEP_EPS * HRS_SWEEP_REPS or len(roots) != 1 or any(
            len(v) != HRS_SWEEP_EPS for v in children.values()):
        raise RuntimeError("HRS sweep: wrong number of runs or spans")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    boot = hrs.bootstrap(cols=cols, reps=HRS_BOOT_REPS)
    boot_s = time.perf_counter() - t0
    print(f"[{card}] 10c bootstrap {HRS_BOOT_REPS} reps at eps = 2, chunk "
          f"{boot.chunk}: {boot_s:.3f} s ({HRS_BOOT_REPS / boot_s:.1f} "
          f"reps/s), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; summary "
          f"{json.dumps(boot.summary)}", flush=True)
    for name, split in (("one sweep eps", perf_hrs.sweep_eps_split(cols)),
                        ("one bootstrap chunk",
                         perf_hrs.boot_chunk_split(cols, boot.chunk))):
        print(f"[{card}] 10c {name} by stage: {json.dumps(split)}",
              flush=True)
    for name, res in (("sweep", sweep.runs), ("bootstrap", boot.runs)):
        if not all(np.isfinite(v).all() for k, v in res.items()
                   if k not in ("method",)):
            raise RuntimeError(f"HRS {name}: non-finite values")
    return sweep, boot


def hrs_gates(card: str, sweep, boot, label: str = "10d") -> None:
    """Phase 10d: the statistics gates."""
    import numpy as np

    runs, rho_np = sweep.runs, sweep.rho_np
    eps = np.asarray(runs["eps_corr"])
    top3 = np.sort(np.unique(eps))[-3:]
    top3_eps = top3.tolist()
    method = np.asarray(runs["method"])
    length = (np.asarray(runs["ci_high"], np.float64)
              - np.asarray(runs["ci_low"], np.float64))
    rho_hat = np.asarray(runs["rho_hat"], np.float64)
    for meth in ("NI", "INT"):
        m = method == meth
        lo_len = length[m & (eps == eps.min())].mean()
        hi_len = length[m & (eps == eps.max())].mean()
        top = rho_hat[m & np.isin(eps, top3)].mean()
        print(f"[{card}] {label} {meth}: mean CI length {hi_len:.4f} at "
              f"eps = {eps.max()} against {lo_len:.4f} at eps = {eps.min()} "
              f"(must be below); mean rho_hat over eps {top3_eps} "
              f"{top:.4f}, non-private rho {rho_np:.4f} (within 0.05)",
              flush=True)
        if not hi_len < lo_len or abs(top - rho_np) > 0.05:
            raise RuntimeError(f"HRS sweep gate failed for {meth}")
    ni = boot.summary["ni"]
    print(f"[{card}] {label} NI bootstrap [q025, q975] = "
          f"[{ni['q025']:.4f}, {ni['q975']:.4f}] (must contain "
          f"{rho_np:.4f})", flush=True)
    if not ni["q025"] <= rho_np <= ni["q975"]:
        raise RuntimeError("HRS NI bootstrap interval misses rho_np")


def same_table(got: dict, want: dict, label: str) -> None:
    """Raise unless two tables hold the same columns, in order, bit for
    bit (NaN where NaN) and of the same dtypes."""
    import numpy as np

    if list(got) != list(want):
        raise RuntimeError(f"{label}: columns {list(got)} != {list(want)}")
    for c, w in want.items():
        g = got[c]
        if g.dtype != w.dtype or not np.array_equal(
                g, w, equal_nan=g.dtype.kind == "f"):
            raise RuntimeError(f"{label}: column {c} differs")


def r_seam(card: str, fused_res, panel_path: str, cols) -> int:
    """Phase 11a: the R seam on the card; returns its K1 launches."""
    import numpy as np

    from dpcorr_torch import hrs, rbridge
    from dpcorr_torch.grid import GridConfig
    from dpcorr_torch.ops import fused_ni
    from dpcorr_torch.sim import DETAIL_FIELDS

    design = GridConfig().design_points()
    rows = [{"n": int(n), "rho": float(r), "eps1": float(e1),
             "eps2": float(e2)} for n, r, e1, e2 in zip(
                 design["n"], design["rho"], design["eps1"], design["eps2"])]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    detail = rbridge.run_design_rows(rows, b=GRID_B, backend="bucketed",
                                     fused="auto")
    dt = time.perf_counter() - t0
    launches = fused_ni.KERNEL_LAUNCHES["fused_ni"]
    order = ["repl", *DETAIL_FIELDS, "n", "rho_true", "eps1", "eps2"]
    kinds = {c: ("i8" if c in ("repl", "n") else "f8"
                 if c in ("rho_true", "eps1", "eps2") else "f4")
             for c in order}
    print(f"[{card}] 11a R seam: run_design_rows over {len(rows)} rows x "
          f"{GRID_B} reps, bucketed, fused auto, in {dt:.3f} s; K1 launches "
          f"{launches} (expected {V1_BUCKETS}); columns {list(detail)}",
          flush=True)
    if launches != V1_BUCKETS or list(detail) != order or any(
            detail[c].dtype != np.dtype(k) for c, k in kinds.items()):
        raise RuntimeError("R seam: wrong launches, column order or dtypes")
    same_table(detail, fused_res.detail_all, "R seam against phase 9a")
    first = [r for r in rows if (r["n"], r["eps1"], r["eps2"])
             == (rows[0]["n"], rows[0]["eps1"], rows[0]["eps2"])]
    arms = {name: rbridge.run_design_rows(first, b=GRID_B, backend=name)
            for name in ("local", "sharded", "bucketed")}
    for name in ("sharded", "bucketed"):
        same_table(arms[name], arms["local"], f"R seam {name} against local")
    print(f"[{card}] 11a {len(first)} rows of the smallest bucket: local, "
          f"sharded and bucketed (fused off) bit-equal; R seam bit-equal to "
          f"phase 9a's fused grid", flush=True)
    summary = rbridge.run_hrs_sweep(HRS_PARITY_EPS,
                                    reps=HRS_PARITY_SWEEP_REPS,
                                    panel_path=panel_path)
    want = hrs.eps_sweep(cols=cols, eps_grid=HRS_PARITY_EPS,
                         reps=HRS_PARITY_SWEEP_REPS).summary
    same_table(summary, want, "run_hrs_sweep against hrs.eps_sweep")
    print(f"[{card}] 11a run_hrs_sweep ({len(HRS_PARITY_EPS)} eps x "
          f"{HRS_PARITY_SWEEP_REPS} reps) from the panel file equals "
          f"hrs.eps_sweep on the same keys", flush=True)
    return launches


def native_ingest(card: str, panel_path: str) -> dict:
    """Phase 11b: the native reader against the Python reader on the
    full-shape panel, in turns."""
    import numpy as np

    from dpcorr_torch.io import rds, rds_py
    from dpcorr_torch.ops import _build

    rds.native_reader()
    secs = {"native": [], "python": []}
    got = {}
    for _ in range(2):
        for name, read in (("native", rds.read_native),
                           ("python", rds_py.read_rds_table)):
            t0 = time.perf_counter()
            got[name] = read(panel_path)
            secs[name].append(time.perf_counter() - t0)
    nat, py = got["native"], got["python"]
    if list(nat) != list(py):
        raise RuntimeError("native reader: other columns than Python's")
    for name, want in py.items():
        col = nat[name]
        meta = ("kind", "levels", "labels", "label")
        if any(getattr(col, a) != getattr(want, a) for a in meta):
            raise RuntimeError(f"native reader: column {name} metadata")
        if want.kind == "string":
            ok = col.values == want.values
        else:
            ok = np.array_equal(col.values, want.values, equal_nan=True) \
                and np.array_equal(np.isnan(col.values),
                                   np.isnan(want.values))
        if not ok:
            raise RuntimeError(f"native reader: column {name} values")
    rows = len(py["wave"].values)
    print(f"[{card}] 11b native RDS reader: built in "
          f"{_build.BUILD_SECONDS.get('rdsread', float('nan')):.3f} s "
          f"(phase 2, beside the kernels); {rows} rows x {len(py)} columns "
          f"equal to the Python reader (values, NA positions, levels, "
          f"labels); read seconds in turns (host): native "
          f"{json.dumps([round(t, 4) for t in secs['native']])}, Python "
          f"{json.dumps([round(t, 4) for t in secs['python']])}", flush=True)
    if rows != HRS_ROWS:
        raise RuntimeError(f"native reader: {rows} rows")
    return secs


def fanout(card: str, fused_res, single_s: float, out_root: str) -> dict:
    """Phase 11c: the v1 grid over two worker processes on the card, then
    as a gloo group; returns each arm's seconds and worker launches."""
    from dpcorr_torch.grid import GridConfig, run_grid
    from dpcorr_torch.parallel import run_grid_multihost

    arms = {}
    for distributed in (False, True):
        label = "gloo group" if distributed else "independent workers"
        out_dir = f"{out_root}/{'gloo' if distributed else 'workers'}"
        # dpcorr-lint: ignore[sync-in-loop] — timing barrier: the clock starts on an idle card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_grid_multihost(
            GridConfig(b=GRID_B, backend="bucketed", fused="auto",
                       out_dir=out_dir),
            n_hosts=FANOUT_HOSTS, distributed=distributed)
        dt = time.perf_counter() - t0
        worker_launches = sum(h["launches"] for h in res.hosts)
        merged = sum(h["merged"] for h in res.hosts)
        t0 = time.perf_counter()  # the parent's merge alone: cache hits
        run_grid(GridConfig(b=GRID_B, backend="bucketed", fused="auto",
                            out_dir=out_dir))
        merge_s = time.perf_counter() - t0
        print(f"[{card}] 11c fan-out, {label}: {FANOUT_HOSTS} workers on "
              f"one card in {dt:.3f} s (single-process fused grid "
              f"{single_s:.3f} s, phase 9a; the parent's merge from the "
              f"cache alone {merge_s:.3f} s); worker reports "
              f"{json.dumps(res.hosts)}", flush=True)
        if len(res.hosts) != FANOUT_HOSTS or worker_launches != V1_BUCKETS \
                or merged != (1 if distributed else 0):
            raise RuntimeError(f"fan-out {label}: {worker_launches} worker "
                               f"launches (expected {V1_BUCKETS}), {merged} "
                               f"merged, {len(res.hosts)} reports")
        same_table(res.detail_all, fused_res.detail_all,
                   f"fan-out {label} against phase 9a")
        arms[label] = {"seconds": dt,
                       "worker_launches": worker_launches,
                       "out_dir": out_dir, "result": res}
    return arms


def sharded_summary(card: str) -> None:
    """Phase 11c: ``run_summary_sharded`` against the detail of
    ``run_detail_sharded`` at the north-star point."""
    import numpy as np

    from dpcorr_torch.parallel import backend as sharded
    from dpcorr_torch.sim import SimConfig, summarize
    from dpcorr_torch.utils import rng

    cfg = SimConfig(n=N, rho=RHO, eps1=EPS[0], eps2=EPS[1], b=SUMMARY_REPS,
                    alpha=ALPHA, chunk_size=1 << 11)
    key = rng.design_key(rng.master_key(device="cuda"), 4242)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summ = sharded.run_summary_sharded(cfg, key)
    summ_s = time.perf_counter() - t0
    sums = sharded.summary_sums(cfg, key)
    t0 = time.perf_counter()
    det = sharded.run_detail_sharded(cfg, key)
    det_s = time.perf_counter() - t0
    want = summarize(det.detail, RHO)
    # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
    host = {k: v.cpu().numpy().astype(np.float64)
            for k, v in det.detail.items()}
    worst, var_gap = 0.0, 0.0
    for meth in ("ni", "int"):
        est = host[f"{meth}_hat"]
        ref = {"sum_hat": est.sum(), "sum_hat2": (est * est).sum(),
               "sum_se2": host[f"{meth}_se2"].sum(),
               "sum_cover": host[f"{meth}_cover"].sum(),
               "sum_len": host[f"{meth}_ci_len"].sum()}
        for k, v in ref.items():
            worst = max(worst, abs(sums[meth][k] / v - 1.0))
        got, w = summ[meth.upper()], want[meth.upper()]
        for k in ("mse", "coverage", "ci_length"):
            worst = max(worst, abs(got[k] / w[k] - 1.0))
        worst = max(worst, abs((got["bias"] + RHO) / (w["bias"] + RHO) - 1))
        var_gap = max(var_gap, abs(got["var"] / w["var"] - 1.0))
    print(f"[{card}] 11c run_summary_sharded at n={N}, {SUMMARY_REPS} reps: "
          f"{summ_s:.3f} s (run_detail_sharded {det_s:.3f} s); sums and "
          f"mean fields within {worst:.3g} relative of the detail's "
          f"(<= 1e-6), variance {var_gap:.3g} (<= 1e-3); NI "
          f"{json.dumps(summ['NI'])}", flush=True)
    if worst > 1e-6 or var_gap > 1e-3:
        raise RuntimeError("run_summary_sharded differs from the detail")


def report_tables(card: str, fan, sweep) -> None:
    """Phase 11d: the tables ``report --from`` reads reload equal."""
    from dpcorr_torch import report

    arm = fan["independent workers"]
    report.write_hrs_tables(arm["out_dir"], sweep)
    tables = report.read_tables(arm["out_dir"])
    same_table(tables["detail"], arm["result"].detail_all,
               "detail_all.npz reload")
    same_table(tables["summ"], arm["result"].summ_all, "summ_all.npz reload")
    same_table(tables["hrs_summ"], sweep.summary,
               "hrs_sweep_summary.npz reload")
    if tables["hrs_rho_np"] != sweep.rho_np:
        raise RuntimeError("hrs_sweep.json: rho_np differs")
    print(f"[{card}] 11d report --from tables reload equal: "
          f"{sorted(report.TABLE_FILES.values())} and "
          f"{report.HRS_META_FILE} (nothing drawn: no matplotlib here)",
          flush=True)


def serve_requests(family: str, count: int, n: int, seed0: int,
                   **kw) -> list:
    """``count`` pinned requests of one family: a ρ = 0.5 Gaussian pair of
    length n per request, from numpy seeds ``seed0 + i`` (also each
    request's pinned noise seed)."""
    from dpcorr_torch.serve import EstimateRequest

    out = []
    for i in range(count):
        z = np.random.default_rng(seed0 + i).standard_normal(
            (2, n), dtype=np.float32)
        y = (0.5 * z[0] + math.sqrt(0.75) * z[1]).astype(np.float32)
        out.append(EstimateRequest(family, z[0], y, *SERVE_EPS,
                                   seed=seed0 + i, **kw))
    return out


def drive(client, reqs: list, threads: int) -> tuple:
    """Closed loop: ``threads`` client threads, each sending its share of
    ``reqs`` one after another through ``client.estimate``. Returns the
    responses as an (N, 3) float64 array, their server-side latencies
    and the wall seconds."""
    out = [None] * len(reqs)
    errors = []

    def worker(c):
        try:
            for i in range(c, len(reqs), threads):
                out[i] = client.estimate(reqs[i], timeout=600)
        except BaseException as e:  # re-raised on the driving thread
            errors.append(e)
    ts = [threading.Thread(target=worker, args=(c,)) for c in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=900)
    dt = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in ts) or any(r is None for r in out):
        raise RuntimeError("serving drive: a client thread did not finish")
    vals = np.array([[r.rho_hat, r.ci_low, r.ci_high] for r in out])
    return vals, np.array([r.latency_s for r in out]), dt


def direct_answers(reqs: list, device) -> np.ndarray:
    """The reference: the port's direct single call on each request's
    pinned key-tree address, (N, 3) float64."""
    from dpcorr_torch.models.estimators.registry import serving_entry
    from dpcorr_torch.serve import pinned_request_key
    from dpcorr_torch.utils import rng

    master = rng.master_key(rng.MASTER_SEED)
    singles, out = {}, []
    for r in reqs:
        single = singles.get(r.family)
        if single is None:
            single = singles[r.family] = serving_entry(
                r.family, r.eps1, r.eps2, device=device)
        out.append(torch.stack(single(
            pinned_request_key(master, r, r.seed), torch.from_numpy(r.x),
            torch.from_numpy(r.y))))
    return torch.stack(out).cpu().double().numpy()


def load_line(label: str, lat: np.ndarray, dt: float) -> dict:
    from dpcorr_torch.serve.stats import percentiles

    p = percentiles(lat.tolist())
    line = {"requests": len(lat), "seconds": dt, "req_per_s": len(lat) / dt,
            "p50_ms": p["p50"] * 1e3, "p99_ms": p["p99"] * 1e3}
    print(f"{label}: {json.dumps(line)}", flush=True)
    return line


def bit_equal(label: str, got: np.ndarray, want: np.ndarray) -> None:
    bad = np.flatnonzero(~(got == want).all(1))
    print(f"{label}: {len(got) - len(bad)} of {len(got)} responses "
          f"bit-equal to the direct call", flush=True)
    if len(bad):
        raise RuntimeError(f"{label}: rows {bad[:8].tolist()} differ from "
                           f"the direct call: {got[bad[0]]} vs "
                           f"{want[bad[0]]}")


def vector_contract(label: str, got: np.ndarray, want: np.ndarray) -> dict:
    """The vector engine's card contract (estimators.registry): within
    1e-5 of the reference on ρ̂ and the CI ends, beyond that on at most
    1% of lanes (a centered value within an ulp of 0 flipping sign).
    Returns the lanes bit-equal and the largest distances in f32 ulps."""
    d = np.abs(got - want)
    bad = ~(d <= 1e-5).all(1)
    ulps = d / np.spacing(np.abs(want).astype(np.float32))
    out = {"lanes": len(got), "bit_equal": int((got == want).all(1).sum()),
           "rho_bit_equal": int((got[:, 0] == want[:, 0]).sum()),
           "max_abs": float(d[~bad].max(initial=0.0)),
           "max_ulps_rho": float(ulps[~bad, 0].max(initial=0.0)),
           "max_ulps_ci": float(ulps[~bad, 1:].max(initial=0.0)),
           "beyond_1e-5": int(bad.sum())}
    print(f"{label}: {json.dumps(out)}", flush=True)
    if bad.sum() > 0.01 * len(got):
        raise RuntimeError(f"{label}: {int(bad.sum())} lanes beyond 1e-5 "
                           f"of the reference (> 1%)")
    return out


def ledger_matches(label: str, srv, admitted: list, events) -> None:
    """(e): the spend equals Σ request_charges of the admitted requests,
    and the audit trail replays to the ledger's state."""
    from dpcorr_torch.obs.audit import replay
    from dpcorr_torch.serve import request_charges

    want: dict = {}
    for r in admitted:
        for party, eps in request_charges(r).items():
            want[party] = want.get(party, 0.0) + eps
    parties = srv.ledger.snapshot()["parties"]
    spent = {p: v["spent"] for p, v in parties.items()}
    replayed = {p: v for p, v in replay(events).items() if v or p in spent}
    print(f"{label}: ledger spend {json.dumps(spent)}; Σ request_charges "
          f"{json.dumps(want)}; trail replay {json.dumps(replayed)}",
          flush=True)
    for p in set(want) | set(spent):
        if not math.isclose(spent.get(p, 0.0), want.get(p, 0.0),
                            rel_tol=1e-12, abs_tol=1e-9):
            raise RuntimeError(f"{label}: party {p} spent "
                               f"{spent.get(p)} != Σ charges {want.get(p)}")
        if replayed.get(p, 0.0) != spent.get(p, 0.0):
            raise RuntimeError(f"{label}: the audit trail replays party {p}"
                               f" to {replayed.get(p)}, ledger "
                               f"{spent.get(p)}")


def launches_of(fn) -> int:
    """CUDA activities (kernels, copies, sets) ``torch.profiler`` records
    for one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type.name == "CUDA")


def serving_exact(card: str, device, work: str) -> dict:
    """Phase 12 (a), (c), (e) and (g) on one exact-engine server."""
    from dpcorr_torch.obs.audit import AuditTrail
    from dpcorr_torch.serve import (
        DpcorrServer,
        InProcessClient,
        KernelCache,
        pinned_request_key,
    )
    from dpcorr_torch.serve.request import bucket_key, kernel_key
    from dpcorr_torch.utils import rng

    reqs = [r for j, fam in enumerate(SERVE_FAMILIES)
            for r in serve_requests(fam, SERVE_PER_FAMILY, SERVE_N,
                                    1_000_000 * (j + 1))]
    hrs = [r for j, fam in enumerate(("ni_sign", "int_sign"))
           for r in serve_requests(fam, SERVE_HRS_PER_FAMILY, HRS_COMPLETE,
                                   7_000_000 + 100_000 * j)]
    master = rng.master_key(rng.MASTER_SEED)
    t0 = time.perf_counter()
    for r in reqs:
        pinned_request_key(master, r, r.seed)
    key_us = (time.perf_counter() - t0) / len(reqs) * 1e6
    print(f"[{card}] 12g request-key derivation on the host: {key_us:.1f} "
          f"µs per admission at n={SERVE_N} (SHA-256 of the request and ten "
          f"fold_ins in Python ints; no device launch)", flush=True)
    trail = AuditTrail()
    srv = DpcorrServer(budget=1e12, max_batch=SERVE_MAX_BATCH,
                       max_delay_s=SERVE_MAX_DELAY_S, audit=trail,
                       device=device)
    try:
        got, lat, dt = drive(InProcessClient(srv), reqs, SERVE_CLIENTS)
        snap = srv.stats_snapshot()
        line = load_line(f"[{card}] 12a exact engine, {len(reqs)} requests "
                         f"(4 families), {SERVE_CLIENTS} clients", lat, dt)
        line["mean_flush"] = snap["batch_fill_ratio"]
        line["flush_size_max"] = snap["flush_size_max"]
        print(f"[{card}] 12a flushes {snap['batches_flushed']}, mean flush "
              f"size {snap['batch_fill_ratio']:.2f}, largest "
              f"{snap['flush_size_max']}", flush=True)
        if not snap["batch_fill_ratio"] > 1.0:
            raise RuntimeError("12a: mean flush size <= 1, no coalescing")
        t0 = time.perf_counter()
        want = direct_answers(reqs, device)
        line["direct_s"] = time.perf_counter() - t0
        bit_equal(f"[{card}] 12a exact engine", got, want)
        ni = [i for i, r in enumerate(reqs) if r.family == "ni_sign"]
        ni_reqs, ni_want = [reqs[i] for i in ni], want[ni]
        # (c) the HRS wave-2 width through the same server
        if {bucket_key(r).n_pad for r in hrs} != {SERVE_HRS_BUCKET}:
            raise RuntimeError(f"12c: n = {HRS_COMPLETE} did not land in "
                               f"the {SERVE_HRS_BUCKET} n-bucket")
        hgot, hlat, hdt = drive(InProcessClient(srv), hrs, SERVE_CLIENTS)
        line["hrs"] = load_line(f"[{card}] 12c n={HRS_COMPLETE}, "
                                f"{len(hrs)} requests", hlat, hdt)
        bit_equal(f"[{card}] 12c exact engine at n={HRS_COMPLETE}", hgot,
                  direct_answers(hrs, device))
        ns = {e["n"] for e in srv.cache.manifest()
              if e["family"] in ("ni_sign", "int_sign")}
        if HRS_COMPLETE not in ns:
            raise RuntimeError(f"12c: no exact-n kernel key at n = "
                               f"{HRS_COMPLETE} in the cache ({ns})")
        ledger_matches(f"[{card}] 12e exact server", srv, reqs + hrs,
                       trail.events())
        # (g) launches of one flush: a 64-lane vector call and a 4-lane
        # exact call per family (exact launches grow with the lanes)
        launches = {}
        for fam in SERVE_FAMILIES:
            fr = [r for r in reqs if r.family == fam][:SERVE_MAX_BATCH]
            keys = torch.stack([pinned_request_key(master, r, r.seed)
                                for r in fr])
            xs = np.stack([r.x for r in fr])
            ys = np.stack([r.y for r in fr])
            kk = kernel_key(fr[0])
            vec = KernelCache(mode="vector", device=device)
            vec.run_batch(kk, keys, xs, ys)
            launches[fam] = {
                "vector_64": launches_of(
                    lambda: vec.run_batch(kk, keys, xs, ys)),
                "exact_4": launches_of(
                    lambda: srv.cache.run_batch(kk, keys[:4], xs[:4],
                                                ys[:4]))}
        print(f"[{card}] 12g launches per flush (CUDA activities): "
              f"{json.dumps(launches)}", flush=True)
        line["launches"] = launches
        line["key_us"] = key_us
    finally:
        srv.close()
    return line, ni_reqs, ni_want


def serving_vector(card: str, device, ni_reqs: list,
                   ni_want: np.ndarray) -> dict:
    """Phase 12 (b): the vector engine, on (a)'s ``ni_sign`` requests (whose
    direct answers (a) computed) and new ones up to 1024."""
    from dpcorr_torch.serve import DpcorrServer, InProcessClient, KernelCache
    from dpcorr_torch.serve import pinned_request_key
    from dpcorr_torch.serve.request import kernel_key
    from dpcorr_torch.utils import rng

    new = serve_requests("ni_sign", SERVE_VECTOR_REQS - len(ni_reqs),
                         SERVE_N, 20_000_000)
    reqs = list(ni_reqs) + new
    srv = DpcorrServer(budget=1e12, max_batch=SERVE_MAX_BATCH,
                       max_delay_s=SERVE_MAX_DELAY_S, batch_mode="vector",
                       device=device)
    try:
        got, lat, dt = drive(InProcessClient(srv), reqs, SERVE_CLIENTS)
        snap = srv.stats_snapshot()
    finally:
        srv.close()
    line = load_line(f"[{card}] 12b vector engine, {len(reqs)} ni_sign "
                     f"requests, {SERVE_CLIENTS} clients", lat, dt)
    line["mean_flush"] = snap["batch_fill_ratio"]
    print(f"[{card}] 12b flushes {snap['batches_flushed']}, mean flush size "
          f"{snap['batch_fill_ratio']:.2f}", flush=True)
    t0 = time.perf_counter()
    want = np.concatenate([ni_want, direct_answers(new, device)])
    line["direct_s"] = time.perf_counter() - t0
    line["contract"] = vector_contract(
        f"[{card}] 12b vector engine against the direct call", got, want)
    # lanes across widths: 2 and 5 against the same lanes of a 64-wide call
    master = rng.master_key(rng.MASTER_SEED)
    fr = reqs[:SERVE_MAX_BATCH]
    keys = torch.stack([pinned_request_key(master, r, r.seed) for r in fr])
    xs, ys = np.stack([r.x for r in fr]), np.stack([r.y for r in fr])
    cache = KernelCache(mode="vector", device=device)
    kk = kernel_key(fr[0])
    full = np.stack(cache.run_batch(kk, keys, xs, ys), 1).astype(np.float64)
    for w in (2, 5):
        part = np.stack(cache.run_batch(kk, keys[:w], xs[:w], ys[:w]), 1)
        line[f"width_{w}_vs_{len(fr)}"] = vector_contract(
            f"[{card}] 12b vector lanes at width {w} against width "
            f"{len(fr)}", part.astype(np.float64), full[:w])
    return line


def _http_status(url: str) -> tuple:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def serving_http(card: str, device, work: str, reqs: list,
                 want: np.ndarray) -> dict:
    """Phase 12 (d) and (e) over the HTTP front end, on requests whose
    direct answers ``want`` holds (a fresh server: no idempotency hit)."""
    from dpcorr_torch.obs.audit import AuditTrail, read_events
    from dpcorr_torch.obs.metrics import parse_exposition
    from dpcorr_torch.serve import (
        BudgetExceededError,
        DpcorrServer,
        HttpEstimateClient,
        ServerClosedError,
        ServerOverloadedError,
        make_http_server,
    )

    audit = f"{work}/serve_audit.jsonl"
    srv = DpcorrServer(budget=1e12, ledger_path=f"{work}/serve_ledger.json",
                       audit=audit, per_party_budget={"tiny": 1.0},
                       warmup=f"ni_sign:{SERVE_N}:{SERVE_EPS[0]}:"
                              f"{SERVE_EPS[1]}:auto",
                       warmup_autostart=False, max_batch=SERVE_MAX_BATCH,
                       max_delay_s=SERVE_MAX_DELAY_S, device=device)
    httpd = make_http_server(srv, host="127.0.0.1", port=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        cold = _http_status(f"{base}/readyz")[0]
        srv.start_warmup()
        if not srv.wait_ready(120):
            raise RuntimeError("12d: the warm set never became resident")
        warm, body = _http_status(f"{base}/readyz")
        print(f"[{card}] 12d /readyz {cold} before the warm set, {warm} after"
              f" ({body})", flush=True)
        if (cold, warm) != (503, 200):
            raise RuntimeError(f"12d: /readyz {cold} then {warm}, expected "
                               f"503 then 200")
        if _http_status(f"{base}/healthz") != (200, '{"ok": true}'):
            raise RuntimeError("12d: /healthz is not 200 {ok: true}")
        client = HttpEstimateClient(base, timeout_s=300.0)
        got, lat, dt = drive(client, reqs, 8)
        line = load_line(f"[{card}] 12d HTTP, {len(reqs)} requests, 8 "
                         f"clients", lat, dt)
        bit_equal(f"[{card}] 12d HTTP front end", got, want)
        tiny = serve_requests("ni_sign", 1, SERVE_N, 31_000_000,
                              party_x="tiny")[0]
        try:
            client.estimate(tiny)
        except BudgetExceededError as e:
            print(f"[{card}] 12d over-budget request: 403 ({e}); party tiny"
                  f" spent {srv.ledger.spent('tiny')}", flush=True)
        else:
            raise RuntimeError("12d: an over-budget request was answered")
        if srv.ledger.spent("tiny") != 0.0:
            raise RuntimeError("12d: the refused request spent budget")
        code, stats_body = _http_status(f"{base}/stats")
        snap = json.loads(stats_body)
        code_m, text = _http_status(f"{base}/metrics")
        series = parse_exposition(text)
        pairs = {
            "dpcorr_serve_requests_total": snap["requests_total"],
            "dpcorr_serve_batches_flushed_total": snap["batches_flushed"],
            "dpcorr_serve_kernel_compiles_total": snap["kernel_compiles"],
            'dpcorr_serve_requests_refused_total{reason="budget"}':
                snap["requests_refused_budget"],
            "dpcorr_serve_latency_seconds_count":
                snap["batched_requests"] + snap["unbatched_requests"],
            'dpcorr_ledger_spent_eps{party="party-x"}':
                snap["ledger"]["parties"]["party-x"]["spent"]}
        off = {k: (series.get(k), v) for k, v in pairs.items()
               if series.get(k) != v}
        print(f"[{card}] 12d /stats {code} and /metrics {code_m} agree on "
              f"{len(pairs) - len(off)} of {len(pairs)} series", flush=True)
        if code != 200 or code_m != 200 or off:
            raise RuntimeError(f"12d: /metrics disagrees with /stats: {off}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    ledger_matches(f"[{card}] 12e HTTP server (file trail)", srv, reqs,
                   read_events(audit))
    # backpressure: a queue of 2 that never flushes; the third gets 429
    trail = AuditTrail()
    bp = DpcorrServer(budget=1e12, max_batch=1024, max_delay_s=30.0,
                      max_queue=2, audit=trail, device=device)
    httpd = make_http_server(bp, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    held = serve_requests("ni_sign", 3, SERVE_N, 32_000_000)
    try:
        futs = [bp.submit(r) for r in held[:2]]
        spent = bp.ledger.spent("party-x")
        client = HttpEstimateClient(
            f"http://127.0.0.1:{httpd.server_address[1]}", timeout_s=60.0)
        try:
            client.estimate(held[2])
        except ServerOverloadedError as e:
            print(f"[{card}] 12d full queue: 429 ({e}, Retry-After "
                  f"{e.retry_after_s})", flush=True)
        else:
            raise RuntimeError("12d: a full queue answered a request")
        if bp.ledger.spent("party-x") != spent:
            raise RuntimeError("12d: the 429'd request was not refunded")
    finally:
        httpd.shutdown()
        httpd.server_close()
        bp.close()
    for f in futs:
        try:
            f.result(timeout=60)
        except ServerClosedError:
            continue
        raise RuntimeError("12d: a drained request was answered")
    ledger_matches(f"[{card}] 12e backpressure server", bp, [],
                   trail.events())
    return line


def serving_card_against_cpu(card: str) -> None:
    """Phase 12 (f): the same requests through a CPU and a card server."""
    from dpcorr_torch.serve import DpcorrServer, InProcessClient

    reqs = [r for j, fam in enumerate(SERVE_FAMILIES)
            for r in serve_requests(fam, SERVE_PARITY_PER_FAMILY, SERVE_N,
                                    40_000_000 + 100_000 * j)]
    out = {}
    for dev in ("cpu", "cuda"):
        srv = DpcorrServer(budget=1e12, max_batch=SERVE_MAX_BATCH,
                           max_delay_s=SERVE_MAX_DELAY_S, device=dev)
        try:
            out[dev] = drive(InProcessClient(srv), reqs, 8)[0]
        finally:
            srv.close()
    ok = np.isclose(out["cuda"], out["cpu"], rtol=0.0, atol=1e-5).all(1)
    print(f"[{card}] 12f card against CPU: {int(ok.sum())} of {len(reqs)} "
          f"requests within 1e-5, max |Δ| "
          f"{float(np.abs(out['cuda'] - out['cpu']).max()):.3g}", flush=True)
    if ok.mean() < 0.99:
        raise RuntimeError(f"12f: card and CPU agree on only "
                           f"{ok.mean():.4f} of the requests")


# ------------------------------------------------------------ phase 13 ----
def proto_columns(card: str, cols) -> tuple:
    """Phase 13's pair: wave 2's complete cases of the synthetic panel
    (phase 10a's, seed 0), age for X and BMI for Y, DP-standardized on the
    card as ``hrs.standardize`` does it (real-data-sims.R:273-287), then
    held on the host as f32 columns, one per party."""
    from dpcorr_torch import hrs

    _ids, age, bmi = hrs.extract_wave(cols)
    std = hrs.standardize(age, bmi, hrs.HrsConfig(), device="cuda")
    x = std.age_z.cpu().numpy().astype(np.float32)
    y = std.bmi_z.cpu().numpy().astype(np.float32)
    print(f"[{card}] 13 columns: wave 2 complete cases n = {len(x)}, age "
          f"and BMI z-scores (DP standardisation on the card)", flush=True)
    if len(x) != PROTO_N:
        raise RuntimeError(f"phase 13: n = {len(x)}, expected {PROTO_N}")
    return x, y


def session_bits(res) -> tuple:
    """Both roles' (ρ̂, lo, hi); raises when the roles disagree."""
    bx = (res["x"].rho_hat, res["x"].ci_low, res["x"].ci_high)
    by = (res["y"].rho_hat, res["y"].ci_low, res["y"].ci_high)
    if bx != by:
        raise RuntimeError(f"the roles disagree: x {bx}, y {by}")
    return bx


def direct_bits(family: str, eps, x, y, device) -> tuple:
    """The port's monolithic estimator on the session's master key."""
    from dpcorr_torch.models.estimators.registry import serving_entry
    from dpcorr_torch.utils import rng

    out = serving_entry(family, *eps, device=device)(
        rng.master_key(PROTO_SEED), torch.from_numpy(x),
        torch.from_numpy(y))
    return tuple(float(v) for v in torch.stack(out).cpu().numpy())


def protocol_sessions(card: str, x, y) -> dict:
    """Phase 13a: every family at both ε orders through the three arms,
    each result bit-equal across arms, roles, repeats and to the direct
    call on the card; the faulted arm retransmits; hardened keys give
    finite results unlike replay's."""
    from dpcorr_torch.protocol import ProtocolSpec, run_inproc, run_tcp

    arms = {"inproc": (run_inproc, None, 10.0),
            "tcp": (run_tcp, None, 10.0),
            "tcp+faults": (run_tcp, PROTO_FAULT, PROTO_FAULT_TIMEOUT_S)}
    lat = {arm: {f: [] for f in SERVE_FAMILIES} for arm in arms}
    want, retries = {}, 0
    for family in SERVE_FAMILIES:
        for eps in PROTO_EPS:
            spec = ProtocolSpec(family=family, n=PROTO_N, eps1=eps[0],
                                eps2=eps[1], seed=PROTO_SEED)
            ref = direct_bits(family, eps, x, y, "cuda")
            want[(family, eps)] = ref
            for arm, (run, fault, timeout_s) in arms.items():
                for _ in range(PROTO_REPEATS[arm]):
                    t0 = time.perf_counter()
                    res = run(spec, x, y, fault=fault, timeout_s=timeout_s)
                    lat[arm][family].append(time.perf_counter() - t0)
                    got = session_bits(res)
                    if got != ref:
                        raise RuntimeError(
                            f"13a {family} ε={eps} {arm}: {got}, the "
                            f"direct call on the card gives {ref}")
                    if fault is not None:
                        retries += sum(r.stats["total_retries"]
                                       for r in res.values())
        hard = session_bits(run_inproc(
            ProtocolSpec(family=family, n=PROTO_N, eps1=1.0, eps2=0.5,
                         seed=PROTO_SEED, noise_mode="hardened"), x, y))
        # the estimates differ; a CI end clamped at ±1 may coincide
        if not np.isfinite(hard).all() \
                or hard[0] == want[(family, (1.0, 0.5))][0]:
            raise RuntimeError(f"13a {family} hardened: {hard} against "
                               f"replay's {want[(family, (1.0, 0.5))]}")
    if retries <= 0:
        raise RuntimeError("13a: the faulted arm never retransmitted")
    table = {arm: {f: {"sessions": len(v),
                       "p50_ms": float(np.percentile(v, 50)) * 1e3,
                       "p90_ms": float(np.percentile(v, 90)) * 1e3}
                   for f, v in per.items()} for arm, per in lat.items()}
    n_sessions = sum(len(v) for per in lat.values() for v in per.values())
    print(f"[{card}] 13a: {n_sessions} sessions, every result bit-equal "
          f"across arms, roles, repeats and to serving_entry on the card; "
          f"faulted arm retransmits {retries}; hardened finite and unlike "
          f"replay in all 4 families", flush=True)
    for arm, per in table.items():
        print(f"[{card}] 13a latency {arm}: {json.dumps(per)}", flush=True)
    return {"want": want, "latency": table, "retries": retries}


def _repo_env() -> dict:
    """This process's environment with the checkout first on
    ``PYTHONPATH`` and no crash plan, for the ``python -m dpcorr_torch``
    processes the phases start."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.pop("DPCORR_CHAOS", None)
    return env


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _party_cmd(role: str, family: str, eps, port: int, d: str) -> list:
    return [sys.executable, "-m", "dpcorr_torch", "party", "--role", role,
            "--port", str(port), "--n", str(PROTO_N), "--family", family,
            "--eps1", str(eps[0]), "--eps2", str(eps[1]),
            "--seed", str(PROTO_SEED), "--data", f"{d}/{role}.npy",
            "--ledger", f"{d}/ledger.{role}.json",
            "--audit", f"{d}/audit.{role}.jsonl",
            "--journal", f"{d}/journal.{role}.json",
            "--transcript", f"{d}/transcript.{role}.jsonl",
            "--connect-timeout", "180", "--recv-timeout", "180",
            "--timeout", "1.0"]


def _party_result(label: str, proc) -> tuple:
    out, err = proc.communicate(timeout=PARTY_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"{label}: rc {proc.returncode}: {err[-2000:]}")
    res = json.loads(out.split("\n", 1)[1])["result"]
    return res["rho_hat"], res["ci_low"], res["ci_high"]


def party_processes(card: str, x, y, want: dict, work: str) -> dict:
    """Phase 13b and 13c: real ``python -m dpcorr_torch party`` processes
    on the card, two sessions at once. (b) int_sign at ε = (0.5, 2.0),
    where y sends; (c) ni_sign at (1.0, 0.5) with y killed at
    ``gate.post_charge`` (exit 42) and restarted with the same command
    line. Each result bit-equal to 13a's; every transcript scans clean and
    balances; each role's ε charged exactly once."""
    import os
    import subprocess

    from dpcorr_torch import chaos
    from dpcorr_torch.obs.audit import read_events
    from dpcorr_torch.protocol import ProtocolSpec
    from dpcorr_torch.protocol.scan import ledger_balance, scan_transcript

    root = os.path.dirname(os.path.abspath(__file__))
    env = _repo_env()
    cases = {"b": ("int_sign", (0.5, 2.0), None),
             "c": ("ni_sign", (1.0, 0.5), "point=gate.post_charge,hit=1")}
    t0 = time.perf_counter()
    procs, cmds = {}, {}
    for case, (family, eps, kill) in cases.items():
        d = f"{work}/13{case}"
        os.makedirs(d)
        np.save(f"{d}/x.npy", x)
        np.save(f"{d}/y.npy", y)
        port = _free_port()
        for role in ("y", "x"):
            cmds[(case, role)] = _party_cmd(role, family, eps, port, d)
            role_env = dict(env)
            if kill and role == "y":
                role_env["DPCORR_CHAOS"] = kill
            procs[(case, role)] = subprocess.Popen(
                cmds[(case, role)], cwd=root, env=role_env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    victim = procs[("c", "y")]
    _out, err = victim.communicate(timeout=PARTY_TIMEOUT_S)
    if victim.returncode != chaos.EXIT_CODE:
        raise RuntimeError(f"13c: the victim exited {victim.returncode}, "
                           f"not {chaos.EXIT_CODE}: {err[-2000:]}")
    killed_s = time.perf_counter() - t0
    procs[("c", "y")] = subprocess.Popen(
        cmds[("c", "y")], cwd=root, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    bits = {key: _party_result(f"13{key[0]} {key[1]}", p)
            for key, p in procs.items()}
    wall = time.perf_counter() - t0
    for case, (family, eps, _kill) in cases.items():
        ref = want[(family, eps)]
        spec = ProtocolSpec(family=family, n=PROTO_N, eps1=eps[0],
                            eps2=eps[1], seed=PROTO_SEED)
        d = f"{work}/13{case}"
        for role in ("x", "y"):
            if bits[(case, role)] != ref:
                raise RuntimeError(f"13{case} {role}: {bits[(case, role)]}"
                                   f", 13a gives {ref}")
            path = f"{d}/transcript.{role}.jsonl"
            rep = scan_transcript(path, raw_x=x, raw_y=y)
            bal = ledger_balance(path, read_events(f"{d}/audit.{role}.jsonl"))
            if not rep["ok"] or not bal["ok"]:
                raise RuntimeError(f"13{case} {role}: scan {rep['violations']}"
                                   f", balance {bal}")
            with open(f"{d}/ledger.{role}.json") as fh:
                spent = json.load(fh)["spent"]
            for party, eps_role in spec.charges_for(role).items():
                if abs(spent.get(party, 0.0) - eps_role) > 1e-12:
                    raise RuntimeError(
                        f"13{case} {role}: ledger spent {spent}, the "
                        f"session charges {party} {eps_role} once")
    print(f"[{card}] 13b,c: 5 party processes (2 sessions, one victim "
          f"killed at gate.post_charge after {killed_s:.1f} s, exit 42, "
          f"restarted) in {wall:.1f} s; results bit-equal to 13a, each "
          f"transcript clean (schema, no raw columns) and balanced, each "
          f"role's ε charged once", flush=True)
    return {"seconds": wall, "killed_after_s": killed_s}


def _fed_data(x, y) -> dict:
    """The federation's four columns at n = 19,433: a = age and b = BMI
    (13's pair, both at p0), c and d equicorrelated at 0.3 with a numpy
    generator."""
    z = np.random.default_rng(PROTO_SEED).standard_normal((3, PROTO_N))
    c = (np.sqrt(0.3) * z[0] + np.sqrt(0.7) * z[1]).astype(np.float32)
    d = (np.sqrt(0.3) * z[0] + np.sqrt(0.7) * z[2]).astype(np.float32)
    return {"a": x, "b": y, "c": c, "d": d}


def _cells(results) -> dict:
    cells: dict = {}
    for res in results.values():
        for key, val in res.cells.items():
            if key in cells and cells[key] != val:
                raise RuntimeError(f"parties disagree on cell {key}")
            cells[key] = val
    return cells


def federation_runs(card: str, x, y) -> dict:
    """Phase 13d: the 3-party, 4-column plan of benchmarks/protocol_load.py
    --matrix for each family, in process and over TCP: every cell
    bit-equal to its independent two-party run on the card, ε spent at
    ``optimal_eps``; a raise-mode crash of p0 at
    ``federation.pre_release`` resumes with ε spent once."""
    import tempfile
    import threading

    from dpcorr_torch import chaos
    from dpcorr_torch.protocol import InProcTransport, run_inproc
    from dpcorr_torch.protocol.federation import (
        make_federation_parties,
        run_federation_inproc,
        run_federation_tcp,
    )
    from dpcorr_torch.protocol.matrix import FederationPlan
    from dpcorr_torch.serve.ledger import PrivacyLedger

    data = _fed_data(x, y)
    rates = {}
    for family in SERVE_FAMILIES:
        plan = FederationPlan(family=family, n=PROTO_N, eps=1.0,
                              parties=FED_PARTIES, seed=PROTO_SEED)
        ledgers = {p: PrivacyLedger(1e6) for p, _ in FED_PARTIES}
        t0 = time.perf_counter()
        cells = _cells(run_federation_inproc(plan, data, ledgers=ledgers))
        dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        tcp = _cells(run_federation_tcp(plan, data))
        dt_tcp = time.perf_counter() - t0
        if tcp != cells:
            raise RuntimeError(f"13d {family}: TCP cells differ")
        for i, j in plan.cells():
            ref = run_inproc(plan.cell_spec(i, j), data[plan.label(i)],
                             data[plan.label(j)])["x"]
            got = cells[f"{i},{j}"]
            if (got["rho_hat"], got["ci_low"], got["ci_high"]) != (
                    ref.rho_hat, ref.ci_low, ref.ci_high):
                raise RuntimeError(f"13d {family} cell {i},{j}: {got}, its "
                                   f"two-party run gives {ref}")
        spent = {p: led.spent(p) for p, led in ledgers.items()}
        if any(abs(spent[p] - e) > 1e-9
               for p, e in plan.party_eps().items()) \
                or not sum(spent.values()) < plan.naive_eps():
            raise RuntimeError(f"13d {family}: spent {spent}, the plan's "
                               f"optimum {plan.party_eps()}")
        rates[family] = {"cells": len(cells), "inproc_s": dt,
                         "tcp_s": dt_tcp,
                         "cells_per_s": len(cells) / dt,
                         "tcp_cells_per_s": len(cells) / dt_tcp,
                         "optimal_eps": plan.optimal_eps(),
                         "naive_eps": plan.naive_eps()}
    plan = FederationPlan(family="ni_sign", n=PROTO_N, eps=1.0,
                          parties=FED_PARTIES, seed=PROTO_SEED)
    ref = _cells(run_federation_inproc(plan, data))
    with tempfile.TemporaryDirectory(prefix="fed_resume_") as d:
        def ledgers():
            return {p: PrivacyLedger(1e6, path=f"{d}/ledger.{p}.json")
                    for p, _ in FED_PARTIES}

        endpoints = {lk: InProcTransport() for lk in plan.links()}
        fast = dict(timeout_s=0.1, max_retries=400)
        parties = make_federation_parties(plan, data, ledgers=ledgers(),
                                          endpoints=endpoints,
                                          journal_dir=d, **fast)
        results, errors = {}, {}

        def run(name, party):
            try:
                results[name] = party.run()
            except BaseException as e:  # SimulatedCrash is one
                errors[name] = e

        chaos.install(chaos.ChaosPlan("federation.pre_release", mode="raise",
                                      thread_name="party-p0"))
        threads = {n: threading.Thread(target=run, args=(n, p),
                                       name=f"party-{n}")
                   for n, p in parties.items()}
        try:
            for t in threads.values():
                t.start()
            threads["p0"].join(timeout=120)
        finally:
            chaos.clear()
        if not isinstance(errors.pop("p0", None), chaos.SimulatedCrash):
            raise RuntimeError("13d: p0 did not crash at "
                               "federation.pre_release")
        fresh = make_federation_parties(plan, data, ledgers=ledgers(),
                                        endpoints=endpoints, journal_dir=d,
                                        **fast)
        rerun = threading.Thread(target=run, args=("p0", fresh["p0"]),
                                 name="party-p0")
        rerun.start()
        rerun.join(timeout=120)
        for n, t in threads.items():
            t.join(timeout=120)
        final = ledgers()
        if errors or _cells(results) != ref or any(
                abs(final[p].spent(p) - e) > 1e-9
                for p, e in plan.party_eps().items()):
            raise RuntimeError(f"13d resume: errors {errors}, spent "
                               f"{ {p: final[p].spent(p) for p in final} }")
    print(f"[{card}] 13d: 4 families x {len(plan.cells())} cells in "
          f"process and over TCP, every cell bit-equal to its two-party run"
          f" on the card, ε at optimal_eps {plan.optimal_eps()} (naive "
          f"{plan.naive_eps()}); crash at federation.pre_release resumed "
          f"with ε once: {json.dumps(rates)}", flush=True)
    return rates


def protocol_card_against_cpu(card: str, x, y, want: dict) -> None:
    """Phase 13e: each family's session on the CPU against 13a's card bits:
    1e-5 absolute (subG also 2.5e-7 relative); a sign family may miss only
    where a privately centered value lies within 1e-5 of 0."""
    from dpcorr_torch.models.estimators.ni_sign import l_clip_for
    from dpcorr_torch.ops.standardize import priv_center
    from dpcorr_torch.protocol import ProtocolSpec, run_inproc
    from dpcorr_torch.utils import rng

    worst = 0.0
    for (family, eps), ref in want.items():
        spec = ProtocolSpec(family=family, n=PROTO_N, eps1=eps[0],
                            eps2=eps[1], seed=PROTO_SEED)
        got = session_bits(run_inproc(spec, x, y, device="cpu"))
        rtol = 2.5e-7 if family.endswith("subg") else 0.0
        diff = float(np.max(np.abs(np.subtract(got, ref))))
        if np.isclose(got, ref, rtol=rtol, atol=1e-5).all():
            worst = max(worst, diff)
            continue
        tie = False
        if family.endswith("sign"):
            key = rng.master_key(PROTO_SEED)
            for role, col, e in (("x", x, eps[0]), ("y", y, eps[1])):
                c = priv_center(rng.stream(key, f"{family}/std_{role}"),
                                torch.from_numpy(col), e, l_clip_for(PROTO_N))
                tie |= bool((c.abs() < 1e-5).any())
        if not tie:
            raise RuntimeError(f"13e {family} ε={eps}: CPU {got}, card "
                               f"{ref}")
    print(f"[{card}] 13e: 8 sessions on the CPU within tolerance of the "
          f"card's (largest difference {worst:.3g})", flush=True)


def protocol_launch_counts(card: str, x, y) -> dict:
    """Phase 13f: CUDA activities (kernels, copies, sets) of one in-process
    session per family at ε = (1.0, 0.5)."""
    from dpcorr_torch.protocol import ProtocolSpec, run_inproc

    out = {}
    for family in SERVE_FAMILIES:
        spec = ProtocolSpec(family=family, n=PROTO_N, eps1=1.0, eps2=0.5,
                            seed=PROTO_SEED)
        out[family] = launches_of(lambda: run_inproc(spec, x, y))
    print(f"[{card}] 13f CUDA activities per session: {json.dumps(out)}",
          flush=True)
    return out


def protocol_phase(card: str, cols, work: str) -> dict:
    """Phase 13 (a)-(f); the caller sets the launch counts to 0 before."""
    parts = {}
    t0 = time.perf_counter()
    x, y = proto_columns(card, cols)
    a = protocol_sessions(card, x, y)
    parts["13a s"] = time.perf_counter() - t0
    for label, fn in (
            ("13b,c", lambda: party_processes(card, x, y, a["want"], work)),
            ("13d", lambda: federation_runs(card, x, y)),
            ("13e", lambda: protocol_card_against_cpu(card, x, y,
                                                      a["want"])),
            ("13f", lambda: protocol_launch_counts(card, x, y))):
        t0 = time.perf_counter()
        parts[label] = fn()
        parts[label + " s"] = time.perf_counter() - t0
    parts["13a"] = a
    return parts


# ------------------------------------------------------------ phase 14 ----
def _post_json(url: str, payload: dict) -> tuple:
    """POST a JSON body; (status, headers, decoded body), errors included."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _stream_service(workdir: str, **kw):
    """A service at benchmarks/stream_load.py's settings (2 s tumbling
    windows, ε = 0.4 for both parties, normalise on) over all four
    families, on the card; the CLI's budget and seed."""
    from dpcorr_torch.perf_stream import STREAM_EPS, STREAM_SEED, WINDOW_S
    from dpcorr_torch.stream.service import StreamService
    from dpcorr_torch.stream.windows import WindowSpec

    args = dict(normalise=True, budget=100.0, seed=STREAM_SEED,
                device="cuda")
    args.update(kw)
    return StreamService(workdir, WindowSpec(size_s=WINDOW_S),
                         SERVE_FAMILIES, STREAM_EPS, STREAM_EPS, **args)


def _feed_service(sv, plan) -> None:
    """Send every batch in order, swallowing refusals as a client would;
    a simulated crash propagates."""
    from dpcorr_torch.stream.service import StreamOverloadedError
    from dpcorr_torch.stream.windows import LateRecordError

    for bid, ts, rows in plan:
        try:
            sv.ingest(bid, ts, rows)
        except (LateRecordError, StreamOverloadedError):
            continue


def _spent(snapshot: dict) -> dict:
    return {p: v["spent"] for p, v in snapshot["parties"].items()}


def _eps_exact(label: str, spent: dict, windows: int) -> None:
    """Each party spent ``windows`` × its per-window charge, and no
    reserved principal beyond those asked for."""
    from dpcorr_torch.perf_stream import stream_charges

    want = {p: windows * v for p, v in stream_charges().items()}
    parties = {p: v for p, v in spent.items()
               if not p.startswith(("user/", "global/"))}
    if set(parties) != set(want) or any(
            abs(parties[p] - e) > 1e-9 for p, e in want.items()):
        raise RuntimeError(f"{label}: party spend {parties}, expected "
                           f"{want} ({windows} windows, each charged once)")


def stream_assoc(card: str, xy: np.ndarray) -> dict:
    """Phase 14a: at n = 10⁶ every partition of the chunk grid releases the
    monolith's bytes on the card, for the four families (normalise on)
    and ni_sign with normalise off, ε = (1.0, 0.5)."""
    from dpcorr_torch.perf_stream import RELEASE_EPS, STREAM_SEED
    from dpcorr_torch.stream import sketch
    from dpcorr_torch.utils import rng

    class Four:
        device_count = 4

    wkey = sketch.window_key(rng.master_key(STREAM_SEED), "0-2000")
    configs = [(f, True) for f in SERVE_FAMILIES] + [("ni_sign", False)]
    out = {}
    for family, norm in configs:
        params = sketch.ReleaseParams(family, *RELEASE_EPS, normalise=norm)
        grid = sketch.grid_for(params, len(xy))
        ids = list(range(grid.n_chunks))
        # dpcorr-lint: ignore[sync-in-loop] — timing barrier: the clock starts on an idle card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = json.dumps(sketch.release_window(xy, params, wkey,
                                               device="cuda"),
                         sort_keys=True)
        mono_ms = 1e3 * (time.perf_counter() - t0)
        parts = {"even_odd": [ids[0::2], ids[1::2]],
                 "head_tail": [ids[:1], ids[1:]],
                 "singletons_reversed": [[c] for c in reversed(ids)],
                 "placement_4": sketch.placement_shards(Four(),
                                                        grid.n_chunks)}
        for name, shards in parts.items():
            got = json.dumps(sketch.release_window(xy, params, wkey,
                                                   shards=shards,
                                                   device="cuda"),
                             sort_keys=True)
            if got != ref:
                raise RuntimeError(f"14a {family} normalise={norm}: the "
                                   f"{name} partition released {got}, the "
                                   f"monolith {ref}")
        out[f"{family}{'' if norm else ' raw'}"] = {
            "chunks": grid.n_chunks, "monolith_ms": mono_ms}
    print(f"[{card}] 14a n = {len(xy)}: 4 partitions (even/odd, head/tail, "
          f"16 singletons reversed, placement over 4 devices) byte-equal to "
          f"the monolith for {len(configs)} configurations on the card: "
          f"{json.dumps(out)}", flush=True)
    return out


def _staged_release(xy: np.ndarray, params, wkey, device,
                    moments=None) -> tuple:
    """``release_window`` in its stages on ``device``: pass A and the
    window's moments (unless ``moments`` is given), the estimate pass and
    the finisher. Returns (moments, release)."""
    from dpcorr_torch.stream import sketch

    if moments is None:
        grid = sketch.grid_for(params, len(xy))
        pass_a = sketch.sketch_window(xy, params, wkey, "pass_a",
                                      device=device)
        moments = sketch.moments_for_window(pass_a, params, grid, wkey,
                                            device)
    est = sketch.sketch_window(xy, params, wkey, "estimate",
                               moments=moments, device=device)
    return moments, sketch.release_from_sketch(est, params, wkey, device)


def _sign_ties(xy: np.ndarray, mo: dict) -> int:
    """Rows whose centered value (clip, minus μ, times 1/σ) lies within
    1e-5 of 0 in either column: the only rows whose sign can follow the
    last bits of the moments."""
    lc = np.float32(mo["l_clip"])
    cx = (np.clip(xy[:, 0], -lc, lc) - np.float32(mo["mu_x"])) \
        * np.float32(mo["inv_x"])
    cy = (np.clip(xy[:, 1], -lc, lc) - np.float32(mo["mu_y"])) \
        * np.float32(mo["inv_y"])
    return int(((np.abs(cx) < 1e-5) | (np.abs(cy) < 1e-5)).sum())


def _release_diff(got: dict, want: dict, family: str) -> tuple:
    """(ρ̂, lo, hi) of both, their largest difference, and whether it is
    within atol 1e-5 (subG also rtol 2.5e-7)."""
    g = np.array([got[k] for k in ("rho", "lo", "hi")])
    w = np.array([want[k] for k in ("rho", "lo", "hi")])
    tol = 1e-5 + (2.5e-7 * np.abs(w) if family.endswith("subg") else 0.0)
    return g, w, float(np.abs(g - w).max()), bool((np.abs(g - w)
                                                    <= tol).all())


def stream_card_against_cpu(card: str, xy: np.ndarray) -> dict:
    """Phase 14b: each family's release at n = 10⁶ on the card and on the
    CPU, within atol 1e-5 (subG also rtol 2.5e-7). A normalised sign
    family's signs follow the last bits of the window's moments, so for
    it the card's moments must agree with the CPU's (1e-6 relative and
    absolute, the tolerance of ``priv_standardize``), and the CPU's
    release from the card's moments must agree with the card's release
    within atol 1e-5: the CPU then takes the card's sign at every tied
    row. Its release from its own moments may miss only where a centered
    value lies within 1e-5 of 0. The sign families near ρ = 0.5 with ρ̂
    inside their CI; int_subg reported only."""
    from dpcorr_torch.perf_stream import RELEASE_EPS, STREAM_SEED
    from dpcorr_torch.stream import sketch
    from dpcorr_torch.utils import rng

    wkey = sketch.window_key(rng.master_key(STREAM_SEED), "0-2000")
    out = {}
    for family in SERVE_FAMILIES:
        params = sketch.ReleaseParams(family, *RELEASE_EPS)
        card_rel = sketch.release_window(xy, params, wkey, device="cuda")
        row = {}
        if params.needs_moments:
            mo_card, staged = _staged_release(xy, params, wkey, "cuda")
            if json.dumps(staged, sort_keys=True) \
                    != json.dumps(card_rel, sort_keys=True):
                raise RuntimeError(f"14b {family}: the staged release "
                                   f"{staged} is not release_window's "
                                   f"{card_rel}")
            mo_cpu, cpu_rel = _staged_release(xy, params, wkey, "cpu")
            names = ("mu_x", "inv_x", "mu_y", "inv_y")
            mo_diff = max(abs(mo_card[k] - mo_cpu[k]) for k in names)
            if any(abs(mo_card[k] - mo_cpu[k]) > 1e-6 + 1e-6 * abs(mo_cpu[k])
                   for k in names):
                raise RuntimeError(f"14b {family}: card moments {mo_card} "
                                   f"against CPU {mo_cpu}")
            _mo, same_mo = _staged_release(xy, params, wkey, "cpu",
                                           moments=mo_card)
            _g, _w, same_diff, same_within = _release_diff(
                card_rel, same_mo, family)
            if not same_within:
                raise RuntimeError(f"14b {family}: card {card_rel} against "
                                   f"the CPU from the card's moments "
                                   f"{same_mo}, beyond atol 1e-5")
            row = {"moments_diff": mo_diff,
                   "max_abs_diff_card_moments": same_diff,
                   "sign_ties": _sign_ties(xy, mo_cpu)}
        else:
            cpu_rel = sketch.release_window(xy, params, wkey, device="cpu")
        got, want, diff, within = _release_diff(card_rel, cpu_rel, family)
        if not within and not row.get("sign_ties"):
            raise RuntimeError(f"14b {family}: card {got} against CPU "
                               f"{want}, beyond the tolerance with no "
                               f"sign tie")
        if family in ("ni_sign", "int_sign") and not (
                abs(got[0] - 0.5) < 0.05 and got[1] <= got[0] <= got[2]):
            raise RuntimeError(f"14b {family}: ρ̂ {got[0]} with CI "
                               f"[{got[1]}, {got[2]}] at ρ = 0.5")
        # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
        out[family] = {"card": got.tolist(), "cpu": want.tolist(),
                       "max_abs_diff": diff, "within": within, **row}
    print(f"[{card}] 14b card against CPU at n = {len(xy)}: "
          f"{json.dumps(out)}", flush=True)
    return out


def stream_http(card: str, plan: list, work: str) -> dict:
    """Phase 14c: a service behind its HTTP front end on an ephemeral port
    takes the plan from one client; every release equals ``release_window``
    on the window's rows under its key; each party spent 4 × its
    per-window charge and the audit replay equals the ledger; a resent
    batch spends nothing; a late batch gets 400 with the watermark; a
    service with a small ``max_pending_rows`` answers 429 with
    ``Retry-After``."""
    import urllib.request

    from dpcorr_torch.obs.audit import read_events, replay_levels
    from dpcorr_torch.perf_stream import STREAM_EPS, STREAM_SEED, plan_windows
    from dpcorr_torch.stream import sketch
    from dpcorr_torch.stream.http import make_stream_http_server
    from dpcorr_torch.utils import rng

    workdir = f"{work}/14c"
    sv = _stream_service(workdir)
    httpd = make_stream_http_server(sv, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    ingest_s = release_s = 0.0
    ingest_rows = 0
    try:
        t0 = time.perf_counter()
        for bid, ts, rows in plan:
            t = time.perf_counter()
            code, _h, ack = _post_json(f"{base}/ingest", {
                "batch_id": bid, "ts": ts, "rows": rows})
            dt = time.perf_counter() - t
            if code != 200:
                raise RuntimeError(f"14c: batch {bid} got {code}: {ack}")
            if ack["released"] or ack["refused"]:
                release_s += dt
            else:
                ingest_s += dt
                ingest_rows += len(rows)
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(f"{base}/releases?since=0",
                                    timeout=60) as resp:
            feed = json.loads(resp.read())["releases"]
        spent = _spent(sv.ledger.snapshot())
        code, _h, ack = _post_json(f"{base}/ingest", {
            "batch_id": plan[0][0], "ts": plan[0][1], "rows": plan[0][2]})
        if code != 200 or not ack["deduped"] \
                or _spent(sv.ledger.snapshot()) != spent:
            raise RuntimeError(f"14c: a resent batch gave {code} {ack} or "
                               f"spent ε")
        code, _h, late = _post_json(f"{base}/ingest", {
            "batch_id": "late", "ts": 1.0, "rows": [[1.0, 2.0]]})
        if code != 400 or late.get("refused") != "late" \
                or late.get("watermark") != sv.manager.watermark:
            raise RuntimeError(f"14c: a late batch gave {code} {late}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        sv.close()
    windows = plan_windows(plan)
    master = rng.master_key(STREAM_SEED)
    if [e["window_id"] for e in feed] != sorted(windows, key=lambda w:
                                                int(w.split("-")[0])):
        raise RuntimeError(f"14c: the feed holds windows "
                           f"{[e['window_id'] for e in feed]}")
    for entry in feed:
        wkey = sketch.window_key(master, entry["window_id"])
        for family in SERVE_FAMILIES:
            params = sketch.ReleaseParams(family, STREAM_EPS, STREAM_EPS,
                                          normalise=True)
            direct = sketch.release_window(windows[entry["window_id"]],
                                           params, wkey, device="cuda")
            if entry["releases"][family] != direct:
                raise RuntimeError(
                    f"14c {entry['window_id']} {family}: the service "
                    f"released {entry['releases'][family]}, the direct call "
                    f"{direct}")
    _eps_exact("14c", spent, len(feed))
    levels = replay_levels(read_events(f"{workdir}/audit.jsonl"))
    if levels["party"] != spent or levels["user"] or levels["global"]:
        raise RuntimeError(f"14c: the audit replay {levels} is not the "
                           f"ledger's {spent}")
    small = _stream_service(f"{work}/14c-small", max_pending_rows=1000)
    httpd = make_stream_http_server(small, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        code, headers, body = _post_json(
            f"http://127.0.0.1:{httpd.server_address[1]}/ingest",
            {"batch_id": plan[0][0], "ts": plan[0][1], "rows": plan[0][2]})
    finally:
        httpd.shutdown()
        httpd.server_close()
        small.close()
    if code != 429 or int(headers.get("Retry-After", "0")) < 1:
        raise RuntimeError(f"14c: a batch past max_pending_rows gave {code}"
                           f" {headers} {body}")
    out = {"windows": len(feed), "rows_per_window": len(next(iter(
        windows.values()))), "batches": len(plan), "wall_s": wall,
           "ingest_rows_per_s": ingest_rows / ingest_s,
           "windows_per_s": len(feed) / wall,
           "release_posts_s": release_s}
    print(f"[{card}] 14c HTTP service: {json.dumps(out)}; every release "
          f"equal to the direct call, ε = {len(feed)} × the per-window "
          f"charge, audit replay = ledger, resend free, late 400 (watermark "
          f"{late['watermark']}), small queue 429 (Retry-After "
          f"{headers.get('Retry-After')})", flush=True)
    return {"feed": json.dumps(feed, sort_keys=True), **out}


def stream_crashes(card: str, plan: list, ref_feed: str, work: str) -> dict:
    """Phase 14d in process: a raise-mode crash at each stream point at
    hits 1 and 2, then a fresh service on the same workdir and a resend of
    every batch: the feed byte-identical to 14c's, ε exact."""
    from dpcorr_torch import chaos

    cases = {}
    for point in ("stream.mid_window", "stream.pre_release",
                  "stream.post_journal"):
        for hit in (1, 2):
            workdir = f"{work}/14d-{point}-{hit}"
            chaos.install(chaos.ChaosPlan(point, hit=hit, mode="raise"))
            try:
                sv = _stream_service(workdir)
                try:
                    _feed_service(sv, plan)
                except chaos.SimulatedCrash:
                    pass
                else:
                    raise RuntimeError(f"14d: {point}#{hit} never fired")
            finally:
                chaos.clear()
            t0 = time.perf_counter()
            sv2 = _stream_service(workdir)
            _feed_service(sv2, plan)
            feed = json.dumps(sv2.releases(), sort_keys=True)
            spent = _spent(sv2.ledger.snapshot())
            sv2.close()
            if feed != ref_feed:
                raise RuntimeError(f"14d {point}#{hit}: the recovered feed "
                                   f"differs from 14c's")
            _eps_exact(f"14d {point}#{hit}", spent, 4)
            cases[f"{point}#{hit}"] = time.perf_counter() - t0
    print(f"[{card}] 14d in process: 6 crashes (3 points × hits 1, 2) "
          f"recovered with the feed byte-identical to 14c's and ε exact; "
          f"recovery seconds {json.dumps(cases)}", flush=True)
    return cases


def stream_process(card: str, plan: list, ref_feed: str, work: str) -> dict:
    """Phase 14d, one real process: ``python -m dpcorr_torch stream`` killed
    at ``stream.pre_release`` (hit 2, exit 42), restarted with the same
    command line while the client resends: the feed byte-identical to
    14c's, ε exact. Times the restart to the first release."""
    import os
    import subprocess
    import urllib.error
    import urllib.request

    from dpcorr_torch import chaos
    from dpcorr_torch.perf_stream import STREAM_EPS, STREAM_SEED, WINDOW_S

    root = os.path.dirname(os.path.abspath(__file__))
    env = _repo_env()
    workdir = f"{work}/14d-process"
    cmd = [sys.executable, "-m", "dpcorr_torch", "stream",
           "--workdir", workdir, "--port", "0",
           "--window-s", str(WINDOW_S), "--families",
           ",".join(SERVE_FAMILIES), "--eps1", str(STREAM_EPS),
           "--eps2", str(STREAM_EPS), "--normalise", "on",
           "--budget", "100", "--seed", str(STREAM_SEED)]

    def start(chaos_spec):
        e = dict(env)
        if chaos_spec:
            e["DPCORR_CHAOS"] = chaos_spec
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=root, env=e, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(f"14d process: no banner: "
                               f"{proc.communicate(timeout=60)[1][-2000:]}")
        banner = json.loads(line)["streaming"]
        return proc, banner, time.perf_counter() - t0

    proc, banner, _ = start("point=stream.pre_release,hit=2,mode=exit")
    base = f"http://127.0.0.1:{banner['port']}"
    died = False
    for bid, ts, rows in plan:
        try:
            _post_json(f"{base}/ingest", {"batch_id": bid, "ts": ts,
                                          "rows": rows})
        except (urllib.error.URLError, ConnectionError, OSError):
            died = True
            break
    rc = proc.wait(timeout=120)
    proc.stdout.close()
    proc.stderr.close()
    if not died or rc != chaos.EXIT_CODE:
        raise RuntimeError(f"14d process: the server exited {rc} (died mid"
                           f"-send: {died}), not {chaos.EXIT_CODE}")
    proc, banner, restart_s = start(None)
    base = f"http://127.0.0.1:{banner['port']}"
    try:
        for bid, ts, rows in plan:
            code, _h, ack = _post_json(f"{base}/ingest", {
                "batch_id": bid, "ts": ts, "rows": rows})
            if code != 200:
                raise RuntimeError(f"14d process: resend of {bid} gave "
                                   f"{code}: {ack}")
        with urllib.request.urlopen(f"{base}/releases?since=0",
                                    timeout=60) as resp:
            feed = json.dumps(json.loads(resp.read())["releases"],
                              sort_keys=True)
        with urllib.request.urlopen(f"{base}/stats", timeout=60) as resp:
            stats = json.loads(resp.read())
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stdout.close()
        proc.stderr.close()
    if feed != ref_feed:
        raise RuntimeError("14d process: the feed after the kill differs "
                           "from 14c's")
    _eps_exact("14d process", _spent(stats["ledger"]), 4)
    out = {"kill_rc": rc, "restart_to_first_release_s": restart_s,
           "released_at_restart": banner["released"]}
    print(f"[{card}] 14d process: killed at stream.pre_release#2 (exit "
          f"{rc}), restarted with the same command line: "
          f"{json.dumps(out)}; feed byte-identical to 14c's, ε exact",
          flush=True)
    return out


def stream_budgets(card: str, plan: list, work: str) -> dict:
    """Phase 14e on the stream: (1) a user budget of two windows' user leg
    — the directory's clock is each window's event-time start and its
    period the hop, so every window opens a fresh user window: all four
    release, three renewals, lifetime 4 legs; (2) a user budget below one
    window's leg: every window refused at the user level, no release, no
    spend at any level; (3) a global budget of two windows: the third
    and fourth refused at the global level, charge-free."""
    from dpcorr_torch.obs.budget_replay import read_user_balances
    from dpcorr_torch.perf_stream import stream_charges

    leg = sum(stream_charges().values())
    out = {}
    for label, kw, released, level in (
            ("user_renewing", {"user": "u1", "user_budget": 2 * leg}, 4,
             None),
            ("user_refused", {"user": "u1", "user_budget": 0.5 * leg}, 0,
             "user"),
            ("global", {"global_budget": 2 * leg}, 2, "global")):
        workdir = f"{work}/14e-{label}"
        sv = _stream_service(workdir, **kw)
        _feed_service(sv, plan)
        st = sv.stats()
        refusals = sv.ledger.refusals_by_level()
        spent = _spent(sv.ledger.snapshot())
        sv.close()
        if st["released"] != released or len(st["refused"]) != 4 - released:
            raise RuntimeError(f"14e {label}: {st['released']} released, "
                               f"refused {st['refused']}")
        if level is not None and refusals[level] != 4 - released:
            raise RuntimeError(f"14e {label}: refusals {refusals}")
        if released:
            _eps_exact(f"14e {label}", spent, released)
        elif any(v != 0.0 for v in spent.values()):
            raise RuntimeError(f"14e {label}: refused windows spent {spent}")
        if "global_budget" in kw and spent.get("global/total") != 2 * leg:
            raise RuntimeError(f"14e global: global spent {spent}")
        row = {"released": st["released"], "refused": len(st["refused"]),
               "refusals_by_level": refusals}
        if "user" in kw:
            bal = read_user_balances(f"{workdir}/budget_dir").get("u1", {})
            renewals = st["budget_dir"]["counters"]["renewals"]
            if abs(bal.get("l", 0.0) - released * leg) > 1e-9 or (
                    released and renewals != released - 1):
                raise RuntimeError(f"14e {label}: user balance {bal}, "
                                   f"renewals {renewals}")
            row.update(user_lifetime=bal.get("l", 0.0), renewals=renewals)
        out[label] = row
    print(f"[{card}] 14e stream budgets (per-window user leg {leg}): "
          f"{json.dumps(out)}", flush=True)
    return out


def serve_user_budgets(card: str, work: str) -> dict:
    """Phase 14e on serving: a server with a budget directory behind its
    HTTP front end, 128 pinned requests at n = 10⁴ over 32 users (four
    each, all four families, dyadic ε: each request 1.0 per party and 2.0
    for its user, user budget 6.0): every answer bit-equal to the direct
    call, each user's fourth request 403 at the user level, party and
    directory spends exact, the audit replay equal to both."""
    from dpcorr_torch.obs.audit import read_events, replay_levels
    from dpcorr_torch.obs.budget_replay import read_user_balances
    from dpcorr_torch.serve import (
        BudgetExceededError,
        DpcorrServer,
        HttpEstimateClient,
        make_http_server,
    )

    eps = {"ni_sign": (0.5, 0.5), "int_sign": (0.5, 0.5),
           "ni_subg": (1.0, 1.0), "int_subg": (1.0, 1.0)}
    reqs = []
    for i in range(SERVE_USER_REQS):
        fam = SERVE_FAMILIES[i % 4]
        r = serve_requests(fam, 1, SERVE_N, 14_000_000 + i)[0]
        reqs.append(type(r)(fam, r.x, r.y, *eps[fam], seed=r.seed,
                            user=f"user{(i // 4) % SERVE_USERS:02d}"))
    want = direct_answers(reqs, "cuda")
    audit = f"{work}/14e-serve-audit.jsonl"
    user_dir = f"{work}/14e-users"
    srv = DpcorrServer(budget=1000.0, audit=audit, user_dir=user_dir,
                       user_budget=6.0, user_shards=8,
                       batch_mode="exact", max_batch=SERVE_MAX_BATCH,
                       max_delay_s=SERVE_MAX_DELAY_S, device="cuda")
    httpd = make_http_server(srv, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    client = HttpEstimateClient(
        f"http://127.0.0.1:{httpd.server_address[1]}", timeout_s=600.0)
    got = [None] * len(reqs)
    refused: list = []
    errors: list = []

    def worker(u0):
        try:
            for u in range(u0, SERVE_USERS, 8):
                for i in range(4 * u, 4 * u + 4):
                    try:
                        r = client.estimate(reqs[i])
                        got[i] = (r.rho_hat, r.ci_low, r.ci_high)
                    except BudgetExceededError as e:
                        refused.append((i, e.level))
        except BaseException as e:
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(c,)) for c in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    dt = time.perf_counter() - t0
    try:
        if errors:
            raise errors[0]
        spent = _spent(srv.ledger.snapshot())
        snap = srv.stats_snapshot()["budget_dir"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    answered = [i for i, g in enumerate(got) if g is not None]
    if sorted(i for i, _ in refused) != [4 * u + 3
                                         for u in range(SERVE_USERS)] \
            or {lv for _, lv in refused} != {"user"}:
        raise RuntimeError(f"14e serve: refusals {sorted(refused)}")
    bit_equal(f"[{card}] 14e serve with a user directory",
              np.array([got[i] for i in answered]), want[answered])
    n_ok = len(answered)
    if spent != {"party-x": float(n_ok), "party-y": float(n_ok)}:
        raise RuntimeError(f"14e serve: party spend {spent}, {n_ok} "
                           f"answered")
    bal = read_user_balances(user_dir)
    if {u: b["l"] for u, b in bal.items()} != {
            f"user{u:02d}": 6.0 for u in range(SERVE_USERS)}:
        raise RuntimeError(f"14e serve: directory lifetimes {bal}")
    levels = replay_levels(read_events(audit))
    if levels["party"] != spent or levels["user"] != {
            u: b["l"] for u, b in bal.items()}:
        raise RuntimeError(f"14e serve: the audit replay {levels}")
    out = {"requests": len(reqs), "answered": n_ok,
           "refused_user": len(refused), "seconds": dt,
           "req_per_s": len(reqs) / dt,
           "refusals_by_level": snap["refusals_by_level"]}
    print(f"[{card}] 14e serve with a user directory: {json.dumps(out)}; "
          f"answers bit-equal to the direct call, spends exact, audit "
          f"replay = ledger and directory", flush=True)
    return out


def directory_drill(card: str) -> dict:
    """Phase 14e: benchmarks/serve_load.py's directory drill cut to 2¹⁷
    users (64 shards, 256 resident per shard, fsync off): every gate
    exact, evictions and rehydrations above 0."""
    from dpcorr_torch.perf_stream import users_drill

    out = users_drill(DIR_USERS, DIR_SHARDS, DIR_MAX_RESIDENT)
    print(f"[{card}] 14e directory drill: {json.dumps(out)}", flush=True)
    if not out["ok"]:
        raise RuntimeError(f"14e drill: gates {out['gates']}")
    return out


def stream_costs(card: str, hrs_xy: np.ndarray, xy: np.ndarray) -> dict:
    """Phase 14f: per family, ms per release, CUDA activities and host
    syncs of one release at n = 19,433 and at n = 10⁶."""
    from dpcorr_torch.perf_stream import RELEASE_EPS, release_cost

    out = {}
    for width, data in (("hrs", hrs_xy), ("stress", xy)):
        for family in SERVE_FAMILIES:
            out[f"{family} {width}"] = release_cost(data, family, "cuda",
                                                    STREAM_TIMED_REPS)
    print(f"[{card}] 14f release costs (ε = {RELEASE_EPS}): "
          f"{json.dumps(out)}", flush=True)
    return out


def stream_phase(card: str, cols, work: str) -> dict:
    """Phase 14 (a)-(f); the caller sets the launch counts to 0 before."""
    from dpcorr_torch.perf_stream import (
        STREAM_SEED,
        STRESS_ROWS,
        batch_plan,
        gaussian_pair,
        hrs_pair,
    )

    parts = {}
    t0 = time.perf_counter()
    hrs_xy = hrs_pair(cols)
    if len(hrs_xy) != PROTO_N:
        raise RuntimeError(f"phase 14: n = {len(hrs_xy)}, expected "
                           f"{PROTO_N}")
    xy = gaussian_pair(STRESS_ROWS, STREAM_SEED, "cuda")
    plan = batch_plan(hrs_xy)
    parts["data s"] = time.perf_counter() - t0
    c = {}
    for label, fn in (
            ("14a", lambda: stream_assoc(card, xy)),
            ("14b", lambda: stream_card_against_cpu(card, xy)),
            ("14c", lambda: c.update(stream_http(card, plan, work)) or c),
            ("14d", lambda: stream_crashes(card, plan, c["feed"], work)),
            ("14d process", lambda: stream_process(card, plan, c["feed"],
                                                   work)),
            ("14e stream", lambda: stream_budgets(card, plan, work)),
            ("14e serve", lambda: serve_user_budgets(card, work)),
            ("14e drill", lambda: directory_drill(card)),
            ("14f", lambda: stream_costs(card, hrs_xy, xy))):
        t0 = time.perf_counter()
        parts[label] = fn()
        parts[label + " s"] = time.perf_counter() - t0
    parts["14c"] = {k: v for k, v in c.items() if k != "feed"}
    return parts


# ------------------------------------------------------------ phase 15 ----
class FleetCell:
    """``n`` supervised ``python -m dpcorr_torch serve`` replicas on the
    card over one leased budget directory, behind a ``FleetFrontend`` on
    an HTTP port of its own, with a background readiness poller."""

    def __init__(self, d: str, names: list):
        import os

        from dpcorr_torch.serve.fleet import (
            FleetFrontend,
            ReplicaSpec,
            Supervisor,
            make_frontend_http_server,
        )

        self.d, self.names = d, names
        os.makedirs(d)
        self.lease_dir = f"{d}/leases"
        target = -(-FLEET_SHARDS // len(names))
        env = _repo_env()
        specs = [ReplicaSpec(name=nm, argv=[
            sys.executable, "-m", "dpcorr_torch", "serve", "--port", "0",
            "--instance", nm, "--device", "cuda", "--budget", "1e9",
            "--ledger", f"{d}/{nm}_ledger.json",
            "--audit", f"{d}/{nm}_audit.jsonl",
            "--user-dir", f"{d}/budget",
            "--user-shards", str(FLEET_SHARDS), "--user-budget", "1e9",
            "--lease-dir", self.lease_dir,
            "--lease-ttl-s", str(FLEET_LEASE_TTL_S),
            "--lease-target", str(target), "--max-batch", "8",
            "--max-delay-ms", "5"], env=env,
            stderr_path=f"{d}/{nm}.log") for nm in names]
        self.fe = FleetFrontend({}, lease_dir=self.lease_dir,
                                cooldown_s=0.5, table_ttl_s=0.25)
        self.sup = Supervisor(specs, banner_deadline_s=240.0,
                              on_up=lambda name, url, banner:
                              self.fe.set_replica(name, url))
        self.httpd = make_frontend_http_server(self.fe)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._stop = threading.Event()

    def start(self) -> float:
        """Boot every replica (in parallel), serve the front end, wait
        until each replica is ready; returns the boot seconds."""
        t0 = time.perf_counter()
        self.sup.start()
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        deadline = time.monotonic() + 240
        while True:
            ready = self.fe.poll_ready()
            if len(ready) == len(self.names) and all(ready.values()):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"15a: replicas never ready: {ready}")
            time.sleep(0.1)
        boot = time.perf_counter() - t0

        def health():
            while not self._stop.is_set():
                try:
                    self.fe.poll_ready()
                except Exception:
                    pass
                self._stop.wait(0.25)
        threading.Thread(target=health, daemon=True).start()
        return boot

    def collector(self):
        from dpcorr_torch.obs.fleet import FleetCollector

        return FleetCollector(self.sup.urls())

    def admitted(self) -> dict:
        """Per-replica ``dpcorr_serve_requests_total`` out of the
        collector's merged (instance-labelled) registry."""
        from dpcorr_torch.obs.fleet import families_to_flat

        snap = self.collector().scrape(timeout_s=30)
        if snap.errors():
            raise RuntimeError(f"15a: scrape errors {snap.errors()}")
        flat = families_to_flat(snap.merged())
        return {n: flat[f'dpcorr_serve_requests_total{{instance="{n}"}}']
                for n in self.names}

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.sup.stop()


def fleet_requests(count: int, seed0: int, users: list) -> list:
    """``serve_requests`` of ``ni_sign`` at n = 10⁴ charged to the fleet's
    parties, request i for ``users[i % len(users)]``."""
    import dataclasses

    return [dataclasses.replace(r, user=users[i % len(users)])
            for i, r in enumerate(serve_requests(
                "ni_sign", count, SERVE_N, seed0, party_x="fleet-x",
                party_y="fleet-y"))]


def fleet_drive(url: str, reqs: list, policy, kill=None) -> dict:
    """``FLEET_CLIENTS`` threads send ``reqs`` through the front end with a
    ``RetryingClient``; every request must end in a response. ``kill`` =
    (after, fn): ``fn()`` runs once ``after`` requests have succeeded.
    Returns the responses, their completion times, latencies and wall
    seconds."""
    from dpcorr_torch.serve import HttpEstimateClient, RetryingClient

    cli = RetryingClient(HttpEstimateClient(url, timeout_s=120.0), policy)
    out, done_at, lat = [None] * len(reqs), [0.0] * len(reqs), []
    errors, lock, fired = [], threading.Lock(), threading.Event()
    done = [0]

    def worker(c):
        for i in range(c, len(reqs), FLEET_CLIENTS):
            t = time.perf_counter()
            try:
                out[i] = cli.estimate(reqs[i], timeout=120.0)
            except Exception as e:
                errors.append(f"#{i}: {type(e).__name__}: {e}")
                continue
            with lock:
                done_at[i] = time.perf_counter()
                lat.append(done_at[i] - t)
                done[0] += 1
                due = (kill is not None and not fired.is_set()
                       and done[0] >= kill[0])
                if due:
                    fired.set()
            if due:
                kill[1]()
    ts = [threading.Thread(target=worker, args=(c,))
          for c in range(FLEET_CLIENTS)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(r is None for r in out):
        raise RuntimeError(f"15: {len(errors)} requests failed: "
                           f"{errors[:3]}")
    return {"resp": out, "done_at": done_at, "lat": np.array(lat),
            "wall": wall}


def fleet_serve(card: str, work: str) -> dict:
    """Phase 15 (a), (b) and the req/s, boot and failover numbers of (e).
    A one-replica cell (the qps baseline) and the three-replica fleet
    boot together; the one replica is driven and stopped first."""
    from dpcorr_torch.obs.audit import read_events
    from dpcorr_torch.obs.budget_replay import fold_levels, read_user_balances
    from dpcorr_torch.obs.fleet import conservation, fleet_replay
    from dpcorr_torch.obs.fleet import ledger_parties
    from dpcorr_torch.serve import RetryPolicy, request_charges
    from dpcorr_torch.serve.budget_dir import build_ring, ring_shard_index
    from dpcorr_torch.serve.fleet import lease_table

    users = [f"user-{u}" for u in range(FLEET_USERS)]
    per_phase = FLEET_PER_REPLICA * FLEET_REPLICAS
    steady = RetryPolicy(max_attempts=6, base_delay_s=0.05,
                         max_delay_s=1.0, deadline_s=120.0)
    failover = RetryPolicy(max_attempts=40, base_delay_s=0.1,
                           max_delay_s=1.0, deadline_s=240.0)
    warm_reqs = fleet_requests(len(users), 700_000, users)
    b_reqs = fleet_requests(per_phase, 800_000, users)
    c_reqs = fleet_requests(per_phase, 900_000, users)
    solo = FleetCell(f"{work}/15solo", ["solo-0"])
    fleet = FleetCell(f"{work}/15fleet",
                      [f"rep-{i}" for i in range(FLEET_REPLICAS)])
    boots = {}
    threads = [threading.Thread(
        target=lambda c, k: boots.__setitem__(k, c.start()),
        args=(c, k)) for c, k in ((solo, "solo"), (fleet, "fleet"))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if set(boots) != {"solo", "fleet"}:
            raise RuntimeError(f"15a: boot failed: {sorted(boots)} up; see "
                               f"the replica logs under {work}")
        print(f"[{card}] 15e boot: {FLEET_REPLICAS} replicas and the "
              f"one-replica cell in parallel, ready in "
              f"{boots['fleet']:.2f} s (fleet), {boots['solo']:.2f} s "
              f"(one replica)", flush=True)
        fleet_drive(solo.url, warm_reqs, steady)
        r = fleet_drive(solo.url, b_reqs, steady)
        one = load_line(f"[{card}] 15e one replica through its front end",
                        r["lat"], r["wall"])
    finally:
        solo.stop()
    sent: dict = {}

    def count(reqs):
        for r in reqs:
            sent[r.user] = sent.get(r.user, 0) + 1
    try:
        fleet_drive(fleet.url, warm_reqs, steady)
        count(warm_reqs)
        before = fleet.admitted()
        b = fleet_drive(fleet.url, b_reqs, steady)
        count(b_reqs)
        after = fleet.admitted()
        three = load_line(f"[{card}] 15e {FLEET_REPLICAS} replicas "
                          f"through the front end", b["lat"], b["wall"])
        delta = {n: after[n] - before[n] for n in fleet.names}
        print(f"[{card}] 15a: {per_phase} client successes; admitted per "
              f"replica (merged registry deltas) {json.dumps(delta)}",
              flush=True)
        if sum(delta.values()) != per_phase:
            raise RuntimeError(f"15a: Σ admitted {sum(delta.values())} != "
                               f"{per_phase} client successes")
        got = np.array([[r.rho_hat, r.ci_low, r.ci_high]
                        for r in b["resp"][:FLEET_PARITY]])
        bit_equal("15a fleet over HTTP", got,
                  direct_answers(b_reqs[:FLEET_PARITY], "cuda"))

        # (b) SIGKILL one replica during the second phase of traffic
        victim = fleet.names[-1]
        table0 = lease_table(fleet.lease_dir)
        victim_shards = sorted(s for s, r in table0.items()
                               if r.get("owner") == victim)
        epochs0 = {s: table0[s]["epoch"] for s in victim_shards}
        killed = {}

        def kill():
            killed["t"] = time.perf_counter()
            fleet.sup.kill(victim)
        c = fleet_drive(fleet.url, c_reqs, failover,
                        kill=(per_phase // 3, kill))
        count(c_reqs)
        fleet.sup.wait_restarted(victim, 1, timeout_s=240.0)
        time.sleep(2 * FLEET_LEASE_TTL_S)
        table1 = lease_table(fleet.lease_dir)
        ring = build_ring(FLEET_SHARDS)
        on_victim = [c["done_at"][i] - killed["t"]
                     for i, r in enumerate(c_reqs)
                     if c["done_at"][i] > killed["t"]
                     and ring_shard_index(r.user, *ring) in victim_shards]
        recovery = min(on_victim) if on_victim else None
        now = time.time()
        for s in victim_shards:
            rec = table1.get(s, {})
            if (rec.get("owner") is None or rec["epoch"] <= epochs0[s]
                    or rec["expires_at"] <= now):
                raise RuntimeError(f"15b: shard {s} of {victim} not "
                                   f"re-leased live at a higher epoch: "
                                   f"{rec} (was epoch {epochs0[s]})")
        launched = fleet.sup.launched[victim]
        if (fleet.sup.restarts.get(victim) != 1 or len(launched) != 2
                or launched[0] != launched[1]):
            raise RuntimeError(f"15b: restarts {fleet.sup.restarts}, "
                               f"launches {len(launched)} (argv equal: "
                               f"{launched[0] == launched[-1]})")
        stats = fleet.collector().scrape(timeout_s=30).stats()
    finally:
        fleet.stop()

    trails = {n: read_events(f"{fleet.d}/{n}_audit.jsonl")
              for n in fleet.names}
    merged = sorted((ev for evs in trails.values() for ev in evs),
                    key=lambda ev: ev["ts"])
    user_replay = fold_levels(fleet_replay({"fleet": merged})["fleet"])[
        "user"]
    disk = {u: rec["l"] for u, rec in
            read_user_balances(f"{fleet.d}/budget").items()}
    user_eps = sum(request_charges(c_reqs[0]).values())
    expected = {u: k * user_eps for u, k in sent.items()}
    if not user_replay == disk == expected:
        raise RuntimeError(f"15b: fleet ε not conserved: replay "
                           f"{user_replay}, directory {disk}, expected "
                           f"{expected}")

    def party_only(events):
        return [{**ev, "charges": ch} for ev in events
                if (ch := {p: e for p, e in ev["charges"].items()
                           if not p.startswith(("user/", "global/"))})]
    survivors = [n for n in fleet.names if n != victim]
    cons = conservation({n: party_only(trails[n]) for n in survivors},
                        {n: ledger_parties(stats[n]) for n in survivors})
    if not cons["ok"]:
        raise RuntimeError(f"15b: survivors' audit replay != ledger: "
                           f"{cons['mismatches']}")
    print(f"[{card}] 15b: {victim} SIGKILLed after {per_phase // 3} of "
          f"{per_phase} requests, every request answered 200 in the end, "
          f"1 restart with the same argv, its shards {victim_shards} "
          f"re-leased at higher epochs ({json.dumps({str(s): table1[s]['epoch'] for s in victim_shards})}); "
          f"first success on a victim shard {recovery:.3f} s after the "
          f"kill; {len(users)} users' ε: merged-trail replay == directory "
          f"== Σ charges (binary-exact, {sum(sent.values())} requests); "
          f"survivors' trails replay to their ledgers", flush=True)
    return {"boot_s": boots, "one": one, "three": three,
            "qps_ratio": three["req_per_s"] / one["req_per_s"],
            "kill_to_first_victim_shard_success_s": recovery,
            "failover_wall_s": c["wall"]}


#: phase 15c: (point, victim role) of the chaos sweep's smoke cases
CHAOS_CASES = (("gate.post_charge", "x"), ("ledger.post_persist", "y"),
               ("budget.mid_compaction", "x"),
               ("federation.pre_release", "y"))


def chaos_sweep(card: str, work: str) -> dict:
    """Phase 15c: ``python -m dpcorr_torch chaos --device cuda`` on the 4
    cases at once (one command each); every case bit-identical to its
    uninterrupted in-process reference with ε spent once."""
    import os
    import subprocess

    env = _repo_env()
    procs = {}
    t0 = time.perf_counter()
    for point, role in CHAOS_CASES:
        d = f"{work}/15c/{point}.{role}"
        os.makedirs(d)
        procs[(point, role)] = subprocess.Popen(
            [sys.executable, "-m", "dpcorr_torch", "chaos", "--device",
             "cuda", "--points", point, "--roles", role,
             "--n", str(SERVE_N), "--timeout", "1", "--case-timeout", "120",
             "--workdir", d], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    seconds = {}
    for (point, role), p in procs.items():
        out, err = p.communicate(timeout=300)
        if p.returncode != 0:
            raise RuntimeError(f"15c {point} {role}: rc {p.returncode}: "
                               f"{out[-1500:]} {err[-1500:]}")
        doc = json.loads(out)
        case = doc["cases"][0]
        if not doc["ok"] or doc["device"] != "cuda" or not case["ok"]:
            raise RuntimeError(f"15c {point} {role}: {doc}")
        seconds[case["case"]] = case["seconds"]
    wall = time.perf_counter() - t0
    print(f"[{card}] 15c: chaos --device cuda, {len(CHAOS_CASES)} cases at "
          f"once in {wall:.1f} s, each bit-identical to its uninterrupted "
          f"reference with each role's ε spent once; seconds per case "
          f"{json.dumps({k: round(v, 2) for k, v in seconds.items()})}",
          flush=True)
    return {"wall_s": wall, "case_s": seconds}


def fleet_phase(card: str, work: str) -> dict:
    """Phase 15 (a)-(c), (e); the caller sets the launch counts to 0
    before and reads them after (d)."""
    parts = {}
    for label, fn in (("15a,b", lambda: fleet_serve(card, work)),
                      ("15c", lambda: chaos_sweep(card, work))):
        t0 = time.perf_counter()
        parts[label] = fn()
        parts[label + " s"] = time.perf_counter() - t0
    return parts


# ------------------------------------------------------------ phase 16 ----
def with_transfers(fn):
    """``fn()`` and the transfer counters' delta over it
    (``obs.transfer``, process default registry)."""
    from dpcorr_torch.obs import transfer

    tc = transfer.default_counters()
    before = tc.snapshot()
    out = fn()
    return out, transfer.diff(tc.snapshot(), before)


def plan_pipeline(card: str, key, main: dict) -> dict:
    """16a: the rep pipeline under both placements, each run against
    phases 4-5's sums on the same keys."""
    from dpcorr_torch.ops import fused_ni
    from dpcorr_torch.sim import RepBlockPipeline, fused_ni_rep_fn, ni_rep_fn

    arms = {"unfused": (ni_rep_fn(N, RHO, *EPS, ALPHA), 1 << 14, 1 << 11,
                        UNFUSED_REPS >> 14),
            "fused": (fused_ni_rep_fn(N, RHO, *EPS, ALPHA), FUSED_BLOCK,
                      FUSED_BLOCK, FUSED_BLOCKS)}
    out = {}
    for label, (body, block, chunk, blocks) in arms.items():
        for placement in ("local", "mesh"):
            pipe = RepBlockPipeline(body, 3, key=key, block_reps=block,
                                    chunk_size=chunk, placement=placement)
            reset_launches()
            # dpcorr-lint: ignore[sync-in-loop] — timing barrier: the clock starts on an idle card
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (sums, reps), delta = with_transfers(lambda: pipe.run(blocks))
            dt = time.perf_counter() - t0
            launches = fused_ni.KERNEL_LAUNCHES["fused_ni"]
            want_launches = (blocks * -(-block // chunk)
                             if label == "fused" else 0)
            print(f"[{card}] 16a {label} pipeline, placement={placement} "
                  f"({pipe.placement.device_count} device): {reps} reps in "
                  f"{dt:.3f} s; sums {list(sums)}; K1 launches {launches} "
                  f"(blocks x chunks {want_launches}); transfers "
                  f"{json.dumps(delta)}", flush=True)
            if list(sums) != main[label]["sums"]:
                raise RuntimeError(f"16a {label} {placement}: sums {sums} "
                                   f"differ from phases 4-5's "
                                   f"{main[label]['sums']}")
            if launches != want_launches:
                raise RuntimeError(f"16a {label} {placement}: {launches} K1 "
                                   f"launches, expected {want_launches}")
            if (delta["fetches"], pipe.fetches) != (1, 1) or \
                    delta["donated_blocks"] != blocks:
                raise RuntimeError(f"16a {label} {placement}: transfers "
                                   f"{delta}, fetches {pipe.fetches}; "
                                   f"expected one fetch, {blocks} blocks")
            out[f"{label} {placement}"] = {"seconds": dt, "reps": reps,
                                           "launches": launches, **delta}
    print(f"[{card}] 16a: local and mesh sums bit-equal to phases 4-5's on "
          f"both arms", flush=True)
    return out


def plan_grid(card: str, fused_res) -> dict:
    """16b: the fused v1 grid through the executor."""
    from dpcorr_torch.grid import GridConfig
    from dpcorr_torch.ops import fused_ni
    from dpcorr_torch.sim import DETAIL_FIELDS

    reset_launches()
    (res, dt), delta = with_transfers(lambda: run_grid_timed(GridConfig(
        b=GRID_B, backend="bucketed", fused="auto")))
    launches = fused_ni.KERNEL_LAUNCHES["fused_ni"]
    print(f"[{card}] 16b fused v1 grid through the plan executor: {dt:.3f} s,"
          f" K1 launches {launches}, transfers {json.dumps(delta)}",
          flush=True)
    if launches != V1_BUCKETS or delta["fetches"] != V1_BUCKETS:
        raise RuntimeError(f"16b: {launches} K1 launches and "
                           f"{delta['fetches']} fetches, expected "
                           f"{V1_BUCKETS} each")
    for f in DETAIL_FIELDS:
        if res.detail_all[f].tobytes() != fused_res.detail_all[f].tobytes():
            raise RuntimeError(f"16b: {f} differs from phase 9a's fused run")
    print(f"[{card}] 16b: all {len(DETAIL_FIELDS)} detail columns bit-equal "
          f"to phase 9a's fused run", flush=True)
    return {"seconds": dt, "launches": launches, **delta}


def _banner_of(proc, deadline_s: float) -> dict:
    """The first stdout line of a ``python -m dpcorr_torch`` process, as
    JSON; raises with its stderr if it ends or misses the deadline."""
    box = []
    t = threading.Thread(target=lambda: box.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(deadline_s)
    if not box or not box[0]:
        proc.kill()
        _, err = proc.communicate(timeout=30)
        raise RuntimeError(f"no banner within {deadline_s} s: "
                           f"{err[-2000:]}")
    return json.loads(box[0])


def _serve_arm(card: str, aot: str, work: str, reqs: list,
               want: np.ndarray) -> dict:
    """One ``serve --aot`` process: spawn → banner → /readyz 200 → the
    first flush → the rest; its compile series and causes."""
    import subprocess

    from dpcorr_torch.obs.metrics import parse_exposition
    from dpcorr_torch.serve import HttpEstimateClient

    tag = f"{aot}-{time.monotonic_ns()}"
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dpcorr_torch", "serve", "--port", "0",
         "--device", "cuda", "--aot", aot, "--warmup", PLAN_WARMUP,
         "--budget", "1e12", "--ledger", f"{work}/plan_{tag}.json",
         "--max-batch", str(SERVE_MAX_BATCH),
         "--max-delay-ms", str(SERVE_MAX_DELAY_S * 1e3)],
        env=_repo_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        banner = _banner_of(proc, 240)["serving"]
        t_banner = time.perf_counter()
        base = f"http://127.0.0.1:{banner['port']}"
        while _http_status(f"{base}/readyz")[0] != 200:
            if time.perf_counter() - t_banner > 120:
                raise RuntimeError(f"16c aot={aot}: never ready")
            time.sleep(0.005)
        t_ready = time.perf_counter()
        client = HttpEstimateClient(base, timeout_s=300.0)
        t1 = time.perf_counter()
        first = client.estimate(reqs[0])
        first_ms = 1e3 * (time.perf_counter() - t1)
        got = [first] + [client.estimate(r) for r in reqs[1:]]
        vals = np.array([[r.rho_hat, r.ci_low, r.ci_high] for r in got])
        bit_equal(f"[{card}] 16c serve --aot {aot}", vals, want)
        stats = json.loads(_http_status(f"{base}/stats")[1])
        series = parse_exposition(_http_status(f"{base}/metrics")[1])
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
    line = {"aot": aot, "spawn_to_ready_s": t_ready - t0,
            "banner_to_ready_s": t_ready - t_banner,
            "first_flush_ms": first_ms,
            "first_flush_server_ms": 1e3 * first.latency_s,
            "compile_seconds_count": series.get(
                "dpcorr_compile_seconds_count", 0.0),
            "compile_seconds_sum": series.get("dpcorr_compile_seconds_sum",
                                              0.0),
            "recompiles": stats["recompiles"],
            "kernel_compiles": stats["kernel_compiles"]}
    print(f"[{card}] 16c serve --aot {aot}: {json.dumps(line)}", flush=True)
    return line


def plan_serving(card: str, work: str) -> list:
    """16c: ``serve --aot on`` and ``--aot off`` in turns."""
    reqs = serve_requests("ni_sign", PLAN_SERVE_REQS, SERVE_N, 50_000_000)
    want = direct_answers(reqs, "cuda")
    arms = [_serve_arm(card, aot, work, reqs, want)
            for aot in ("on", "off")]
    for a in arms:
        warm = a["compile_seconds_count"]
        if (a["aot"] == "on") != (warm > 0) or \
                (a["aot"] == "off" and any(a["recompiles"].values())):
            raise RuntimeError(f"16c: compile series {a} do not match "
                               f"--aot {a['aot']}")
    return arms


def plan_federation(card: str, x: np.ndarray, y: np.ndarray) -> dict:
    """16d: ``finish_batch`` through the executor against the direct
    ``finish``, three cells per family, the HRS-width pair."""
    from dpcorr_torch.models.estimators import split_reference as sr
    from dpcorr_torch.utils import rng

    eps = PROTO_EPS[0]
    cols = {"x": torch.from_numpy(x).cuda(), "y": torch.from_numpy(y).cuda()}
    root = rng.master_key(PROTO_SEED, "cuda")
    out = {}
    for family in SERVE_FAMILIES:
        releaser, finisher = sr.split_roles(family, *eps)
        keys, rels = [], []
        for j in range(3):
            # dpcorr-lint: ignore[rng-raw-api] — the federation cells' keys, as benchmarks/protocol_load.py folds them
            cell = rng.fold_in(root, 1000 + j)
            rels.append(sr.party_release(
                family, rng.stream(cell, "release"), releaser,
                cols[releaser], *eps, True, device="cuda"))
            keys.append(rng.stream(cell, "finish"))
        fin = [cols[finisher]] * 3
        batch = torch.stack(sr.finish_batch(family, keys, rels, fin, *eps,
                                            device="cuda"))
        direct = torch.stack([torch.stack(sr.finish(
            family, k, r, c, *eps, device="cuda"))
            for k, r, c in zip(keys, rels, fin)], dim=1)
        # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
        a, b = batch.cpu().numpy(), direct.cpu().numpy()
        if a.tobytes() != b.tobytes():
            # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
            raise RuntimeError(f"16d {family}: finish_batch {a.tolist()} "
                               f"differs from the direct finish "
                               # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
                               f"{b.tolist()}")
        # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
        out[family] = a[0].tolist()
    print(f"[{card}] 16d finish_batch through the executor bit-equal to the "
          f"direct finish for {len(out)} families x 3 cells at n = {len(x)}",
          flush=True)
    return out


def plan_stream(card: str, xy: np.ndarray, work: str) -> dict:
    """16e: the stream service under a mesh placement over the one card
    against the local one: release bytes equal; transfers per release."""
    from dpcorr_torch.perf_stream import batch_plan

    plan = batch_plan(xy, windows=PLAN_STREAM_WINDOWS)
    out = {}
    for placement in ("local", "mesh"):
        sv = _stream_service(f"{work}/plan_stream_{placement}",
                             placement=placement)
        try:
            # dpcorr-lint: ignore[sync-in-loop] — timing barrier: the clock starts on an idle card
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, delta = with_transfers(lambda: _feed_service(sv, plan))
            dt = time.perf_counter() - t0
            entries = sv.journal.entries()
        finally:
            sv.close()
        releases = len(entries) * len(SERVE_FAMILIES)
        out[placement] = {
            "bytes": json.dumps(entries, sort_keys=True),
            "windows": len(entries), "seconds": dt, **delta,
            "fetches_per_release": delta["fetches"] / releases,
            "device_puts_per_release": delta["device_put"] / releases}
        print(f"[{card}] 16e stream, placement={placement}: "
              f"{len(entries)} windows x {len(SERVE_FAMILIES)} families in "
              f"{dt:.3f} s; transfers {json.dumps(delta)}; per release "
              f"{out[placement]['fetches_per_release']:.2f} host reads, "
              f"{out[placement]['device_puts_per_release']:.2f} "
              f"host-to-card copies", flush=True)
    if out["local"]["windows"] != PLAN_STREAM_WINDOWS or \
            out["local"]["bytes"] != out["mesh"]["bytes"]:
        raise RuntimeError("16e: the mesh placement's releases differ from "
                           "the local placement's")
    print(f"[{card}] 16e: release bytes equal across placements", flush=True)
    return {k: {f: v for f, v in d.items() if f != "bytes"}
            for k, d in out.items()}


def _device_activities(fn) -> int:
    """CUDA activities ``fn`` makes on the card (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.device_type == DeviceType.CUDA for ev in prof.events())


def _host_ms(fn) -> tuple:
    """(host ms to issue one call, wall ms per call with the card
    drained), over ``GRAPH_CALLS`` calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GRAPH_CALLS):
        fn()
    issue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return 1e3 * issue / GRAPH_CALLS, 1e3 * wall / GRAPH_CALLS


def _graph_case(fn) -> dict:
    """``fn`` captured into a CUDA graph after two warm calls on a side
    stream, then replayed against the eager call: bits, host ms and
    device activities of each. Replays are counted here."""
    eager = [t.clone() for t in fn()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # dpcorr-lint: ignore[aot-outside-compile-layer] — the CUDA-graph probe measures a capture; no path dispatches through one
    with torch.cuda.graph(graph):
        static = fn()
    replays = 0

    def replay():
        nonlocal replays
        graph.replay()
        replays += 1

    equal = []
    for _ in range(3):
        replay()
        # dpcorr-lint: ignore[sync-in-loop] — each replay's bits are read after it finishes
        torch.cuda.synchronize()
        equal.append(all(a.view(torch.int32).equal(b.view(torch.int32))
                         for a, b in zip(static, eager, strict=True)))
    eager_ms, replay_ms = _host_ms(fn), _host_ms(replay)
    acts = (_device_activities(fn), _device_activities(replay))
    return {"bit_equal": all(equal), "replays": replays,
            "eager_host_issue_ms": eager_ms[0], "eager_wall_ms": eager_ms[1],
            "replay_host_issue_ms": replay_ms[0],
            "replay_wall_ms": replay_ms[1], "eager_activities": acts[0],
            "replay_activities": acts[1]}


def graph_probe(card: str, key) -> dict:
    """16f: one fused block (key-tree plus K1) and one exact-engine
    ``ni_sign`` single call at n = 10⁴, each captured into a CUDA graph
    and replayed against its eager call. A measurement: no path
    dispatches through a graph."""
    from dpcorr_torch.models.estimators.registry import serving_entry
    from dpcorr_torch.ops import fused_ni
    from dpcorr_torch.serve import pinned_request_key
    from dpcorr_torch.sim import fused_ni_rep_fn
    from dpcorr_torch.utils import rng

    body = fused_ni_rep_fn(N, RHO, *EPS, ALPHA)
    reset_launches()
    fused = _graph_case(lambda: body(rng.rep_keys(rng.design_key(key, 0),
                                                  GRAPH_BLOCK)))
    fused["k1_launches_counted"] = fused_ni.KERNEL_LAUNCHES["fused_ni"]
    req = serve_requests("ni_sign", 1, SERVE_N, 60_000_000)[0]
    single = serving_entry("ni_sign", *SERVE_EPS, device="cuda")
    args = (pinned_request_key(rng.master_key(rng.MASTER_SEED), req,
                               req.seed).cuda(),
            torch.from_numpy(req.x).cuda(), torch.from_numpy(req.y).cuda())
    serve = _graph_case(lambda: single(*args))
    for label, res in (("fused block (2^14 reps, key-tree plus K1)", fused),
                       ("exact-engine ni_sign single call (n = 10^4)",
                        serve)):
        print(f"[{card}] 16f CUDA graph of one {label}: {json.dumps(res)}",
              flush=True)
    if not fused["bit_equal"]:
        print(f"[{card}] 16f: fused-block replays are not bit-equal to the "
              f"eager call", flush=True)
    return {"fused_block": fused, "ni_sign_single": serve,
            "replays": fused["replays"] + serve["replays"]}


def plan_phase(card: str, key, main: dict, fused_res, x, y, xy,
               work: str) -> dict:
    """Phase 16 (a)-(f); each part reads the launch count and the
    transfer counters around itself."""
    parts = {}
    for label, fn in (
            ("16a", lambda: plan_pipeline(card, key, main)),
            ("16b", lambda: plan_grid(card, fused_res)),
            ("16c", lambda: plan_serving(card, work)),
            ("16d", lambda: plan_federation(card, x, y)),
            ("16e", lambda: plan_stream(card, xy, work)),
            ("16f", lambda: graph_probe(card, key))):
        t0 = time.perf_counter()
        parts[label] = fn()
        parts[label + " s"] = time.perf_counter() - t0
    return parts


#: 17b: the unfused run_sim_one's replications and its widths besides the
#: ladder's; width 2 runs the first WIDTH2_REPS of them (the same keys;
#: all 4096 at width 2 would take ~30 s of launches)
CHUNK_BITS_B = 4096
CHUNK_BITS_WIDTHS = (2, 64)
WIDTH2_REPS = 256
#: 17e: profiled and unprofiled runs of the fused pipeline, in turns
PROFILE_TURNS = 4
#: the profiled arms' sync caps: cadence 1 and cadence 8 over 64 blocks
PROFILE_MAX_SYNCS = {"profiled": 64, "profiled_coarse": 8}


def doctor_check(card: str) -> dict:
    """17a: ``python -m dpcorr_torch doctor --probe --json`` in its own
    process: verdict ok, the probe names the card, nvcc found with
    sm_90a, K1's library current in ``_build/``, no strays."""
    import subprocess

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "dpcorr_torch", "doctor",
                          "--probe", "--json"], capture_output=True,
                         text=True, timeout=300, env=_repo_env())
    dt = time.perf_counter() - t0
    if out.returncode != 0:
        raise RuntimeError(f"17a doctor exited {out.returncode}: "
                           f"{out.stderr[-2000:]}")
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    probe, cache, nvcc = (rep["device_probe"], rep["compile_cache"],
                          rep["nvcc"])
    print(f"[{card}] 17a doctor --probe in {dt:.2f} s: verdict "
          f"{rep['verdict']!r}; probe {json.dumps(probe)}; nvcc "
          f"{json.dumps(nvcc)}; build cache {json.dumps(cache)}; strays "
          f"{rep['stray_workers']}", flush=True)
    if rep["verdict"] != "ok" or not probe.get("ok") or \
            torch.cuda.get_device_name(0) != probe.get("device"):
        raise RuntimeError(f"17a doctor: verdict {rep['verdict']!r}, "
                           f"probe {probe}")
    if not (nvcc["found"] and nvcc["sm_90a"]):
        raise RuntimeError(f"17a doctor: nvcc {nvcc}")
    if not cache["current"].get("fused_ni") or any(
            s.startswith("fused_ni-") for s in cache["stale"]):
        raise RuntimeError(f"17a doctor: K1's build cache {cache}")
    if rep["stray_workers"]:
        raise RuntimeError(f"17a doctor: strays {rep['stray_workers']}")
    return {"seconds": dt, "verdict": rep["verdict"]}


def _field_gaps(got, want, fields) -> dict:
    """Per field: bit-equal or not, and the largest absolute difference."""
    out = {}
    for f, g, w in zip(fields, got, want, strict=True):
        g, w = g.double(), w.double()
        out[f] = {"bit_equal": bool(torch.equal(g, w)),
                  "max_abs": float((g - w).abs().max())}
    return out


def _print_gaps(card: str, label: str, gaps: dict) -> None:
    print(f"[{card}] 17b {label}: " + ", ".join(
        f"{f} {'bit-equal' if g['bit_equal'] else 'differs'} (max |Δ| "
        f"{g['max_abs']:.3e})" for f, g in gaps.items()), flush=True)


def chunk_width_bits(card: str, key) -> dict:
    """17b: the main path at n = 10⁴, ε = (1, 1), ρ = 0.5 at several
    chunk widths, each field against the widest: the unfused
    ``run_sim_one`` (B = 4096) at widths 2, 64 and each ladder chunk,
    and the fused pipeline's ``block_detail`` at each ladder chunk."""
    import dataclasses

    from dpcorr_torch.sim import (DETAIL_FIELDS, RepBlockPipeline,
                                  SimConfig, fused_ni_rep_fn, run_sim_one)
    from dpcorr_torch.utils import geometry
    from dpcorr_torch.utils.device import device_kind

    ladder = geometry.LADDERS[device_kind()][0]
    widths = sorted(set(CHUNK_BITS_WIDTHS + ladder))
    widest = widths[-1]
    cfg = SimConfig(n=N, rho=RHO, eps1=EPS[0], eps2=EPS[1],
                    b=CHUNK_BITS_B, alpha=ALPHA)
    runs = {}
    for w in widths:
        res = run_sim_one(dataclasses.replace(
            cfg, b=WIDTH2_REPS if w == 2 else CHUNK_BITS_B, chunk_size=w))
        runs[w] = [res.detail[f] for f in DETAIL_FIELDS]
    out = {"unfused": {}, "fused": {}}
    for w in widths[:-1]:
        cut = len(runs[w][0])
        out["unfused"][w] = _field_gaps(
            runs[w], [c[:cut] for c in runs[widest]], DETAIL_FIELDS)
        _print_gaps(card, f"unfused run_sim_one, width {w} against {widest} "
                    f"({cut} reps)", out["unfused"][w])
    fused = {}
    for c in ladder:
        pipe = RepBlockPipeline(fused_ni_rep_fn(N, RHO, *EPS, ALPHA), 3,
                                key=key, block_reps=FUSED_BLOCK,
                                chunk_size=c)
        fused[c] = list(pipe.block_detail(0))
    for c in ladder[:-1]:
        out["fused"][c] = _field_gaps(fused[c], fused[ladder[-1]],
                                      ("se2", "cover", "ci_len"))
        _print_gaps(card, f"fused block_detail, chunk {c} against "
                    f"{ladder[-1]} ({FUSED_BLOCK} reps)", out["fused"][c])
    out["all_bit_equal"] = all(
        g["bit_equal"] for part in ("unfused", "fused")
        for gaps in out[part].values() for g in gaps.values())
    print(f"[{card}] 17b verdict: every field bit-equal across chunk "
          f"widths >= 2: {out['all_bit_equal']}", flush=True)
    return out


def geometry_phase(card: str, key, v1_off, bits_equal: bool,
                   work: str) -> dict:
    """17c: ``autotune`` the fused (K1) and unfused main-path pipelines
    and ``grid-sign`` at n = 1000 into a work-directory cache, read each
    back from the cache with no probe, list them with ``obs geometry``,
    and run the unfused v1 grid with ``geometry="auto"`` against phase
    9a's."""
    import os
    import subprocess

    from dpcorr_torch.grid import GridConfig, _rows, _stamp
    from dpcorr_torch.ops import fused_ni
    from dpcorr_torch.sim import (DETAIL_FIELDS, SimConfig, _one_rep,
                                  fused_ni_rep_fn, ni_rep_fn)
    from dpcorr_torch.utils import geometry
    from dpcorr_torch.utils.device import device_kind

    old = os.environ.get("DPCORR_GEOMETRY_CACHE")
    os.environ["DPCORR_GEOMETRY_CACHE"] = f"{work}/geometry.json"
    kind = device_kind()
    grid_n = GridConfig().n_grid[0]
    grid_cfg = SimConfig(n=grid_n, rho=RHO, eps1=EPS[0], eps2=EPS[1])
    families = {
        "ni-sign-fused": (fused_ni_rep_fn(N, RHO, *EPS, ALPHA), 3, N),
        "ni-sign": (ni_rep_fn(N, RHO, *EPS, ALPHA), 3, N),
        "grid-sign": (lambda k: _one_rep(k, RHO, grid_cfg), 12, grid_n),
    }
    out = {}
    try:
        for fam, (body, out_len, n) in families.items():
            runner = geometry.pipeline_runner(body, out_len, key=key)
            launches0 = fused_ni.KERNEL_LAUNCHES["fused_ni"]
            t0 = time.perf_counter()
            geo = geometry.autotune(fam, n, runner, device_kind=kind,
                                    eps_pairs=[EPS])
            dt = time.perf_counter() - t0
            launches = fused_ni.KERNEL_LAUNCHES["fused_ni"] - launches0
            probes = runner.probes
            geometry._MEMO.clear()
            again = geometry.autotune(fam, n, runner, device_kind=kind,
                                      eps_pairs=[EPS])
            print(f"[{card}] 17c autotune {fam} n={n}: chunk "
                  f"{geo.chunk_size}, block {geo.block_reps}, probe "
                  f"{geo.reps_per_sec:.1f} reps/s ({probes} probe runs, "
                  f"{dt:.2f} s, K1 launches {launches}); second call "
                  f"source={again.source}, probe runs "
                  f"{runner.probes - probes}", flush=True)
            if geo.source != "autotune" or again.source != "cache" or \
                    runner.probes != probes or \
                    (again.chunk_size, again.block_reps) != \
                    (geo.chunk_size, geo.block_reps):
                raise RuntimeError(f"17c {fam}: {geo} then {again}, "
                                   f"{runner.probes - probes} probes")
            if (launches > 0) != (fam == "ni-sign-fused"):
                raise RuntimeError(f"17c {fam}: {launches} K1 launches")
            out[fam] = {"geometry": geo.as_detail(), "seconds": dt,
                        "probes": probes, "launches": launches}
        ls = subprocess.run([sys.executable, "-m", "dpcorr_torch", "obs",
                             "geometry", "--json"], capture_output=True,
                            text=True, timeout=120, env=_repo_env())
        if ls.returncode != 0:
            raise RuntimeError(f"17c obs geometry: {ls.stderr[-2000:]}")
        listed = {e["family"]: e for e in json.loads(ls.stdout)["entries"]}
        print(f"[{card}] 17c obs geometry --json: {json.dumps(listed)}",
              flush=True)
        if sorted(listed) != sorted(families) or any(
                e["device_kind"] != kind for e in listed.values()):
            raise RuntimeError(f"17c obs geometry lists {sorted(listed)}")
        tuned = out["grid-sign"]["geometry"]["chunk_size"]
        gcfg = GridConfig(b=GRID_B, backend="bucketed", geometry="auto")
        rows = _rows(gcfg.design_points())
        chunks = {r.n: gcfg.sim_config(r).chunk_size for r in rows}
        if chunks != {n: tuned if n == grid_n else gcfg.chunk_size
                      for n in gcfg.n_grid}:
            raise RuntimeError(f"17c: geometry=auto resolved {chunks}")
        res, dt = run_grid_timed(gcfg)
        gap = max(float(np.abs(res.detail_all[f].astype(np.float64)
                               - v1_off.detail_all[f]).max())
                  for f in DETAIL_FIELDS)
        same = all(np.array_equal(res.detail_all[f], v1_off.detail_all[f])
                   for f in DETAIL_FIELDS)
        row = next(r for r in rows if r.n == grid_n)
        same_stamp = (_stamp(GridConfig().sim_config(row))
                      == _stamp(gcfg.sim_config(row)))
        print(f"[{card}] 17c v1 grid unfused, geometry=auto (chunk "
              f"{tuned} at n={grid_n}, {gcfg.chunk_size} elsewhere): "
              f"{dt:.3f} s; against 9a's unfused run: bit-equal {same}, "
              f"max |Δ| {gap:.3e}; one stamp {same_stamp}", flush=True)
        if bits_equal or tuned == gcfg.chunk_size:
            if not (same and same_stamp):
                raise RuntimeError("17c: the geometry=auto grid is not "
                                   "bit-equal to 9a's under one stamp")
        elif gap > 1e-5 or same_stamp:
            raise RuntimeError(f"17c: geometry=auto grid max |Δ| {gap}, "
                               f"one stamp {same_stamp}")
        out["grid"] = {"seconds": dt, "bit_equal": same}
    finally:
        if old is None:
            os.environ.pop("DPCORR_GEOMETRY_CACHE", None)
        else:
            os.environ["DPCORR_GEOMETRY_CACHE"] = old
        geometry._MEMO.clear()
    return out


def precompile_phase(card: str) -> dict:
    """17d: the v1 grid, unfused then fused, each with ``precompile``
    off, then on: bit-equal tables, ``precompiled`` on no bucket (eager
    torch has nothing to build ahead, ``GridConfig.precompile``), the
    wall time of each arm."""
    from dpcorr_torch.grid import GridConfig
    from dpcorr_torch.sim import DETAIL_FIELDS

    out = {}
    for fused in ("off", "auto"):
        secs = {"off": [], "on": []}
        ref = None
        for pc in ("off", "on"):
            res, dt = run_grid_timed(GridConfig(
                b=GRID_B, backend="bucketed", fused=fused, precompile=pc))
            secs[pc].append(dt)
            flags = res.timings["precompiled"]
            if flags.any():
                raise RuntimeError(f"17d fused={fused} precompile={pc}: "
                                   f"precompiled {list(flags)}")
            if ref is None:
                ref = res
            elif not all(np.array_equal(res.detail_all[f],
                                        ref.detail_all[f])
                         for f in DETAIL_FIELDS):
                raise RuntimeError(f"17d fused={fused}: precompile={pc} "
                                   f"is not bit-equal to off")
        print(f"[{card}] 17d v1 grid fused={fused}: precompile off "
              f"{secs['off']} s, on {secs['on']} s (bit-equal; "
              f"precompiled buckets 0)",
              flush=True)
        out[fused] = secs
    return out


def profiler_phase(card: str, key, fused_sums: list, work: str) -> dict:
    """17e: the 2²⁰-rep fused pipeline without a ``BlockProfiler`` and
    with one at each cap of ``PROFILE_MAX_SYNCS``, in turns: sums
    bit-equal to phase 5's, one fetch a run, syncs within the cap and
    only when profiled, the artifacts read back; the seconds of every
    arm (reported only)."""
    from dpcorr_torch.obs import prof, transfer
    from dpcorr_torch.obs.metrics import Registry
    from dpcorr_torch.ops import fused_ni
    from dpcorr_torch.sim import RepBlockPipeline, fused_ni_rep_fn

    profilers = {label: prof.BlockProfiler(
        max_syncs=cap, registry=Registry(),
        artifact_path=f"{work}/profile_{label}.json")
        for label, cap in PROFILE_MAX_SYNCS.items()}
    body = fused_ni_rep_fn(N, RHO, *EPS, ALPHA)
    pipes = {}
    for label, p in (("unprofiled", None), *profilers.items()):
        counters = transfer.TransferCounters(registry=Registry())
        pipes[label] = (RepBlockPipeline(
            body, 3, key=key, block_reps=FUSED_BLOCK, chunk_size=FUSED_BLOCK,
            counters=counters, profiler=p), counters)
    pipes["unprofiled"][0].run(1, start_block=10_000)  # warm
    order = tuple(pipes)
    secs = {label: [] for label in order}
    launches = {label: 0 for label in order}
    for turn in range(PROFILE_TURNS):
        for label in order if turn % 2 == 0 else order[::-1]:
            pipe, counters = pipes[label]
            profiler = profilers.get(label)
            before = counters.snapshot()
            syncs0 = 0 if profiler is None else int(
                profiler.syncs_total.value())
            launches0 = fused_ni.KERNEL_LAUNCHES["fused_ni"]
            # dpcorr-lint: ignore[sync-in-loop] — timing barrier: the clock starts on an idle card
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sums, _ = pipe.run(FUSED_BLOCKS)
            secs[label].append(time.perf_counter() - t0)
            launches[label] += fused_ni.KERNEL_LAUNCHES["fused_ni"] - launches0
            fetches = transfer.diff(counters.snapshot(), before)["fetches"]
            syncs = 0 if profiler is None else int(
                profiler.syncs_total.value()) - syncs0
            if list(sums) != fused_sums:
                raise RuntimeError(f"17e {label}: sums {sums} differ from "
                                   f"phase 5's {fused_sums}")
            if fetches != 1:
                raise RuntimeError(f"17e {label}: {fetches} fetches")
            if (profiler is not None) != (syncs > 0) or \
                    syncs > PROFILE_MAX_SYNCS.get(label, 0):
                raise RuntimeError(f"17e {label}: {syncs} profiler syncs")
    cadence = {}
    for label, profiler in profilers.items():
        runs = prof.read_profile(profiler.artifact_path)["runs"]
        if len(runs) != PROFILE_TURNS or any(
                r["transfer"]["fetches"] != 1
                or r["n_blocks"] != FUSED_BLOCKS for r in runs):
            raise RuntimeError(f"17e {label}: the artifact holds {runs}")
        cadence[label] = (runs[-1]["sync_count"], runs[-1]["cadence"])
    reps = FUSED_BLOCK * FUSED_BLOCKS
    print(f"[{card}] 17e fused pipeline, {reps} reps, {PROFILE_TURNS} turns "
          f"each (reported only): " + "; ".join(
              f"{label} {secs[label]} s" + (
                  f" ({cadence[label][0]} syncs a run, cadence "
                  f"{cadence[label][1]})" if label in cadence else "")
              for label in order)
          + f"; sums bit-equal to phase 5's, one fetch a run; K1 launches "
          f"{launches}", flush=True)
    return {"seconds": secs, "launches": launches,
            "profiled_reps_per_s": reps / min(secs["profiled"])}


def roofline_trace_phase(card: str, key, phase7_bound: float, rps: float,
                         work: str) -> dict:
    """17f: 17e's reps/s against the H100's peaks, K1's bound from
    ``utils.roofline``, the device monitor's watermarks, and a
    ``torch.profiler`` trace of one fused block naming K1's kernel."""
    from dpcorr_torch.obs import devicemon, trace
    from dpcorr_torch.sim import RepBlockPipeline, fused_ni_rep_fn
    from dpcorr_torch.utils import profiling, roofline
    from dpcorr_torch.utils.device import device_kind

    model = roofline.analytic_rep_model(N, *EPS)
    summary = roofline.summarize(rps, model["flops_per_rep"],
                                 model["bytes_per_rep_floor"],
                                 roofline.peaks_for(device_kind()))
    t = roofline.least_time_ms(roofline.fused_pipe_ops(N, EPS, False),
                               FUSED_BLOCK, FUSED_BLOCK * 24)
    bound = max(t.values())
    print(f"[{card}] 17f roofline of 17e's {rps:.1f} reps/s (the "
          f"analytic model): {json.dumps(summary)}; K1's bound from "
          f"utils.roofline {bound:.4f} ms by {max(t, key=t.get)} (phase 7: "
          f"{phase7_bound:.4f} ms)", flush=True)
    if bound != phase7_bound or round(bound, 4) != 0.3453:
        raise RuntimeError(f"17f: K1's bound {bound} is not phase 7's "
                           f"{phase7_bound}")
    mon = devicemon.DeviceMonitor()
    mon.sample()
    wm = mon.watermarks()["cuda:0"]
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[{card}] 17f device watermarks after 17e: {json.dumps(wm)}",
          flush=True)
    if not (wm["bytes_in_use"] <= wm["peak_bytes_in_use"]
            <= wm["bytes_limit"] == total):
        raise RuntimeError(f"17f: watermarks {wm}, card memory {total}")
    spans = f"{work}/trace_spans.jsonl"
    log_dir = f"{work}/trace"
    pipe = RepBlockPipeline(fused_ni_rep_fn(N, RHO, *EPS, ALPHA), 3, key=key,
                            block_reps=FUSED_BLOCK, chunk_size=FUSED_BLOCK)
    # The first profiler session after 17e loses the card's first few
    # dozen activity records (on an H100 its trace held only the block's
    # last 18-25 kernels, without K1, which runs early in the block; a
    # second session held all ~52): the warm-up block runs under a session
    # of its own, which takes that loss.
    launches_of(lambda: pipe.run(1, start_block=20_000))  # warm
    trace.configure(spans)
    try:
        with profiling.trace(log_dir):
            pipe.run(1, start_block=20_001)
    finally:
        trace.configure(None)
    with open(f"{log_dir}/{profiling.TRACE_FILE}") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "fused_ni_kernel" in e.get("name", "")]
    sp = [s for s in trace.read_spans(spans) if s["name"] == "profiler.trace"]
    k1_us = sum(e.get("dur", 0) for e in k1)
    print(f"[{card}] 17f torch.profiler trace of one fused block: "
          f"{len(events)} events, {len(kernels)} kernel events, K1 "
          f"{len(k1)} ({k1_us} us), profiler.trace spans {len(sp)}",
          flush=True)
    if len(k1) != 1 or len(sp) != 1:
        raise RuntimeError(f"17f: the trace holds {len(k1)} K1 kernel "
                           f"events and {len(sp)} profiler.trace spans")
    return {"summary": summary, "bound_ms": bound, "watermarks": wm,
            "trace_k1_us": k1_us}


def measuring_phase(card: str, key, main: dict, v1_off, phase7_bound: float,
                    work: str) -> dict:
    """Phase 17 (a)-(f); the K1 launch count is zeroed before each part
    and read after it (the parts count their own launches as
    differences, never by zeroing)."""
    from dpcorr_torch.ops import fused_ni

    parts = {}
    for label, fn in (
            ("17a", lambda: doctor_check(card)),
            ("17b", lambda: chunk_width_bits(card, key)),
            ("17c", lambda: geometry_phase(
                card, key, v1_off, parts["17b"]["all_bit_equal"], work)),
            ("17d", lambda: precompile_phase(card)),
            ("17e", lambda: profiler_phase(card, key, main["fused"]["sums"],
                                           work)),
            ("17f", lambda: roofline_trace_phase(
                card, key, phase7_bound,
                parts["17e"]["profiled_reps_per_s"], work))):
        reset_launches()
        t0 = time.perf_counter()
        parts[label] = fn()
        parts[label + " s"] = time.perf_counter() - t0
        parts[label + " launches"] = fused_ni.KERNEL_LAUNCHES["fused_ni"]
        print(f"[{card}] {label}: {parts[label + ' s']:.1f} s, K1 launches "
              f"{parts[label + ' launches']}", flush=True)
    return parts


# ------------------------------------------------------------ phase 18 ----
#: runs ``python -m dpcorr_torch`` in a process that cannot import torch
#: (the operator's tools compute nothing on a device)
_NO_TORCH = ("import sys; sys.modules['torch'] = None; "
             "from dpcorr_torch.__main__ import main; main(sys.argv[1:])")


def _tool_env() -> dict:
    env = _repo_env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def obs_tool(*argv, rc: int = 0):
    """One ``obs`` command in a process that sees no card and cannot
    import torch; raises unless it exits with ``rc``."""
    import subprocess

    proc = subprocess.run([sys.executable, "-c", _NO_TORCH, "obs", *argv],
                          env=_tool_env(), capture_output=True, text=True,
                          timeout=120)
    if proc.returncode != rc:
        raise RuntimeError(f"obs {argv[0]}: rc {proc.returncode}, expected "
                           f"{rc}: {proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    return proc


def _violations(stdout: str) -> list:
    return [json.loads(line)["violation"] for line in stdout.splitlines()
            if line.startswith('{"violation"')]


def obs_serve(card: str, work: str, device: str = "cuda") -> dict:
    """Phase 18a; the serve process stays up for 18c (the caller stops
    ``out["proc"]``)."""
    import os
    import subprocess

    from dpcorr_torch.obs.trace import read_spans
    from dpcorr_torch.serve import HttpEstimateClient

    d = f"{work}/18a"
    os.makedirs(d)
    files = {k: f"{d}/serve_{k}" for k in ("ledger.json", "audit.jsonl",
                                           "trace.jsonl", "dump.json")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dpcorr_torch", "serve", "--port", "0",
         "--device", device, "--instance", "r0", "--budget", "1e12",
         "--ledger", files["ledger.json"], "--audit", files["audit.jsonl"],
         "--trace", files["trace.jsonl"],
         "--flight-recorder", files["dump.json"],
         "--max-batch", str(SERVE_MAX_BATCH),
         "--max-delay-ms", str(SERVE_MAX_DELAY_S * 1e3)],
        env=_repo_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    out = {"proc": proc, "audit": files["audit.jsonl"],
           "dump": files["dump.json"]}
    try:
        banner = _banner_of(proc, 240)["serving"]
        base = out["url"] = f"http://127.0.0.1:{banner['port']}"
        reqs = (serve_requests("ni_sign", OBS_REQS_PER_FAMILY, SERVE_N,
                               60_000_000)
                + serve_requests("int_sign", OBS_REQS_PER_FAMILY, SERVE_N,
                                 61_000_000))
        client = HttpEstimateClient(base, timeout_s=300.0)
        vals, _lat, dt = drive(client, reqs, 8)
        if vals.shape != (len(reqs), 3) or not np.isfinite(vals).all():
            raise RuntimeError("18a: a request got a non-finite answer")
        stats = json.loads(_http_status(f"{base}/stats")[1])
        spent = {p: v["spent"] for p, v in stats["ledger"]["parties"].items()}
        t0 = time.perf_counter()
        frame = obs_tool("top", "--url", base, "--once").stdout
        top_s = time.perf_counter() - t0
        want = [f"traffic     : {stats['requests_total']} admitted",
                f"party-x={spent['party-x']:.4g}/",
                f"party-y={spent['party-y']:.4g}/"]
        if stats["requests_total"] != len(reqs) or \
                not all(w in frame for w in want):
            raise RuntimeError(f"18a obs top: {frame!r} does not show {want}")
        dead = f"http://127.0.0.1:{_free_port()}"
        fleet = obs_tool("top", "--fleet", f"r0={base},r1={dead}",
                         "--once").stdout
        if "1/2 instances up" not in fleet or not any(
                ln.startswith("r1") and "DOWN" in ln
                for ln in fleet.splitlines()):
            raise RuntimeError(f"18a obs top --fleet: {fleet!r}")
        replayed = json.loads(obs_tool("budget", "--audit", files["audit.jsonl"],
                                       "--json").stdout)
        if replayed["spent"] != spent:
            raise RuntimeError(f"18a obs budget: {replayed['spent']}, the "
                               f"ledger {spent}")
        code, _h, body = _post_json(f"{base}/obs/trigger", {
            "reason": "slo_page", "detail": {"objective": "chip-smoke"}})
        with open(files["dump.json"]) as fh:
            dumped = json.load(fh)
        if code != 200 or body != {"dumped": files["dump.json"], "armed": True} \
                or dumped["reason"] != "slo_page":
            raise RuntimeError(f"18a POST /obs/trigger: {code} {body}, dump "
                               f"reason {dumped['reason']}")
        code, _h, bogus = _post_json(f"{base}/obs/trigger", {"reason": "bogus"})
        if code != 400:
            raise RuntimeError(f"18a a bogus trigger reason got {code} {bogus}")
        spans = read_spans(files["trace.jsonl"])
        tid = next(sp["trace_id"] for sp in spans
                   if sp["name"] == "serve.request")
        story = json.loads(obs_tool("dump", files["dump.json"], "--trace-id",
                                    tid, "--json").stdout)
        if not story["spans"] or story["spans"][0]["name"] != "serve.request" \
                or (story["cost"] or {}).get("trace_id") != tid \
                or not story["audit"] \
                or story["eps_net"] != story["cost"]["eps_charged"]:
            raise RuntimeError(f"18a obs dump --trace-id {tid}: {story}")
        chrome = f"{d}/chrome.json"
        obs_tool("chrome", "--trace", files["trace.jsonl"], "--out", chrome)
        with open(chrome) as fh:
            events = [e for e in json.load(fh)["traceEvents"]
                      if e["ph"] == "X"]
        if len(events) != len(spans):
            raise RuntimeError(f"18a obs chrome: {len(events)} events for "
                               f"{len(spans)} spans")
    except BaseException:
        proc.kill()
        proc.communicate(timeout=60)
        raise
    out["line"] = {"requests": len(reqs), "drive_s": dt,
                   "requests_total": stats["requests_total"],
                   "spent": spent, "obs_top_s": top_s, "spans": len(spans),
                   "dump_spans": len(story["spans"]),
                   "eps_net": story["eps_net"]}
    print(f"[{card}] 18a serve under the tools: {json.dumps(out['line'])}; "
          f"obs top shows /stats, r1 DOWN, obs budget = ledger, trigger "
          f"200/400, obs dump rebuilds trace {tid}, obs chrome one event "
          f"per span", flush=True)
    return out


def obs_federation(card: str, x, y, work: str, device: str = "cuda") -> dict:
    """Phase 18b: the federation's files and endpoints under ``obs
    provenance`` and ``obs top --federation``."""
    import os
    import shutil

    from dpcorr_torch.obs.audit import AuditTrail
    from dpcorr_torch.obs.endpoint import start_obs_server
    from dpcorr_torch.protocol.federation import (
        _drive_parties,
        make_federation_parties,
    )
    from dpcorr_torch.protocol.matrix import FederationPlan
    from dpcorr_torch.serve.ledger import PrivacyLedger

    d = f"{work}/18b"
    os.makedirs(d)
    plan = FederationPlan(family="ni_sign", n=len(x), eps=1.0,
                          parties=FED_PARTIES, seed=PROTO_SEED)
    ledgers = {p: PrivacyLedger(1e6, path=f"{d}/ledger.{p}.json",
                                audit=AuditTrail(f"{d}/audit.{p}.jsonl"))
               for p, _ in FED_PARTIES}
    parties = make_federation_parties(plan, _fed_data(x, y), ledgers=ledgers,
                                      transcript_dir=d, journal_dir=d,
                                      device=device)
    servers = {n: start_obs_server(p.registry, stats_fn=p.stats_snapshot)
               for n, p in parties.items()}
    try:
        t0 = time.perf_counter()
        _drive_parties(parties)
        run_s = time.perf_counter() - t0
        targets = ",".join(f"{n}=http://127.0.0.1:{port}"
                           for n, (_srv, port) in sorted(servers.items()))
        frame = obs_tool("top", "--federation", targets, "--once").stdout
    finally:
        for srv, _port in servers.values():
            srv.shutdown()
    plan_path = f"{d}/plan.json"
    with open(plan_path, "w") as fh:
        json.dump({"plan": plan.to_public()}, fh)
    audits = [a for p, _ in FED_PARTIES
              for a in ("--audit", f"{p}={d}/audit.{p}.jsonl")]
    doc = json.loads(obs_tool("provenance", "--plan", plan_path,
                              "--transcript-dir", d, *audits,
                              "--journal-dir", d, "--json").stdout)
    if not doc["ok"] or doc["divergences"] \
            or doc["eps"]["total"] != plan.optimal_eps():
        raise RuntimeError(f"18b obs provenance: ok {doc['ok']}, total "
                           f"{doc['eps']['total']!r} against optimal_eps "
                           f"{plan.optimal_eps()!r}: {doc['divergences']}")
    bad = f"{work}/18b-tampered"
    shutil.copytree(d, bad)
    victim = sorted(f for f in os.listdir(bad)
                    if f.startswith(plan.fed) and f.endswith(".p0.jsonl"))[0]
    with open(f"{bad}/{victim}") as fh:
        lines = [json.loads(ln) for ln in fh]
    hit = next(e for e in lines
               if e.get("dir") == "send" and e.get("eps", 0) > 0)
    hit["eps"] = hit["eps"] / 2
    with open(f"{bad}/{victim}", "w") as fh:
        fh.writelines(json.dumps(e) + "\n" for e in lines)
    text = obs_tool("provenance", "--plan", plan_path, "--transcript-dir",
                    bad, *[a.replace(d, bad) for a in audits],
                    "--journal-dir", bad, rc=1).stdout
    if "DIVERGENCE [tampered-charge] party=p0" not in text:
        raise RuntimeError(f"18b a halved charge was not named: {text}")
    expect = {n: p.stats_snapshot()["cells_done"]
              for n, p in parties.items()}
    rows = {ln.split()[0]: ln.split()[1] for ln in frame.splitlines()
            if ln.split() and ln.split()[0] in expect}
    cells = len(plan.cells())
    want_rows = {n: f"{k}/{cells}" for n, k in expect.items()}
    if "3/3 parties up" not in frame or "DISAGREE" in frame \
            or rows != want_rows \
            or f"cells {sum(expect.values())} done (matrix {cells})" \
            not in frame:
        raise RuntimeError(f"18b obs top --federation: {frame!r}, the "
                           f"parties' cells {expect}")
    line = {"n": plan.n, "cells": cells, "run_s": run_s,
            "optimal_eps": plan.optimal_eps(),
            "total_eps": doc["eps"]["total"],
            "nodes": doc["counts"]["nodes"], "edges": doc["counts"]["edges"]}
    print(f"[{card}] 18b federation provenance: {json.dumps(line)}; no "
          f"divergence, ε float for float at optimal_eps, a halved charge "
          f"named tampered-charge at p0, obs top --federation every party's "
          f"cells done", flush=True)
    return {"dir": d, **line}


def _watch(ck: str, *sources, rc: int = 0) -> list:
    """``obs watch --once --json`` over ``sources`` from checkpoint ``ck``;
    the violations it printed."""
    return _violations(obs_tool("watch", "--checkpoint", ck, *sources,
                                "--once", "--json", rc=rc).stdout)


def _flip_byte(path: str) -> None:
    with open(path, "r+b") as fh:
        fh.seek(3)
        fh.write(b"X")


def _dup_first_charge(path: str) -> None:
    with open(path) as fh:
        first = next(ln for ln in fh if '"kind": "charge"' in ln)
    with open(path, "a") as fh:
        fh.write(first)


def _rewind_release(path: str) -> None:
    with open(path) as fh:
        entry = json.loads(fh.readline())
    entry.update(window_id="rewound", charge_id="rewound", release_seq=1)
    with open(path, "a") as fh:
        fh.write(json.dumps(entry) + "\n")


def obs_sentinel(card: str, work: str, stream_dir: str, served: dict,
                 fed_dir: str) -> dict:
    """Phase 18c."""
    import os
    import shutil
    import subprocess

    d = f"{work}/18c"
    os.makedirs(d)
    found = _watch(f"{d}/all.json", "--stream", f"s14={stream_dir}",
                   "--audit", f"r0={served['audit']}",
                   "--url", f"r0={served['url']}",
                   "--transcripts", f"fed={fed_dir}",
                   "--journals", f"fed={fed_dir}")
    if found:
        raise RuntimeError(f"18c the services' files raised {found}")
    faults = {}
    for label, kind in (("wal byte flip", "wal-regression"),
                        ("duplicated charge", "double-charged-artifact"),
                        ("rewound release seq", "wal-regression")):
        copy = f"{d}/{label.replace(' ', '-')}"
        if label == "duplicated charge":
            shutil.copyfile(served["audit"], f"{copy}.jsonl")
            src, fault = ("--audit", f"r0={copy}.jsonl"), (
                lambda c=copy: _dup_first_charge(f"{c}.jsonl"))
        else:
            shutil.copytree(stream_dir, copy)
            src = ("--stream", f"s14={copy}")
            fault = (lambda c=copy: _flip_byte(f"{c}/wal.jsonl")) \
                if label == "wal byte flip" else \
                (lambda c=copy: _rewind_release(f"{c}/releases.jsonl"))
        ck = f"{copy}.ck.json"
        _watch(ck, *src)
        fault()
        got = _watch(ck, *src, rc=1)
        again = _watch(ck, *src)
        if kind not in {v["kind"] for v in got} or again:
            raise RuntimeError(f"18c {label}: {got}, rerun {again}")
        faults[label] = sorted({v["kind"] for v in got})
    live = f"{d}/live.jsonl"
    shutil.copyfile(served["audit"], live)
    ck = f"{d}/live.ck.json"
    proc = subprocess.Popen(
        [sys.executable, "-c", _NO_TORCH, "obs", "watch", "--checkpoint",
         ck, "--audit", f"r0={live}", "--url", f"r0={served['url']}",
         "--interval", str(OBS_WATCH_INTERVAL_S), "--json"],
        env=_tool_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        _banner_of(proc, 60)
        deadline = time.perf_counter() + 30
        while not os.path.exists(ck):
            if time.perf_counter() > deadline:
                raise RuntimeError("18c the live sentinel never polled")
            time.sleep(0.01)
        box = []

        def first_violation():
            for line in proc.stdout:
                if line.startswith('{"violation"'):
                    box.append((time.perf_counter(), json.loads(line)))
                    return
        reader = threading.Thread(target=first_violation, daemon=True)
        reader.start()
        t0 = time.perf_counter()
        _dup_first_charge(live)
        t_dump = None
        while t_dump is None or not box:
            if time.perf_counter() - t0 > 30:
                raise RuntimeError(f"18c live: violation {box}, dump at "
                                   f"{t_dump}")
            if t_dump is None:
                with open(served["dump"]) as fh:
                    if json.load(fh)["reason"] == "sentinel_violation":
                        t_dump = time.perf_counter()
            time.sleep(0.005)
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
    t_violation, hit = box[0]
    if hit["violation"]["kind"] not in ("double-charged-artifact",
                                        "wal-regression"):
        raise RuntimeError(f"18c live: {hit}")
    line = {"faults": faults, "live_violation_s": t_violation - t0,
            "live_dump_s": t_dump - t0,
            "interval_s": OBS_WATCH_INTERVAL_S}
    print(f"[{card}] 18c sentinel: {json.dumps(line)}; the services' files "
          f"clean, each fault caught and not raised again on a rerun",
          flush=True)
    return line


def obs_phase(card: str, work: str, x, y, device: str = "cuda") -> dict:
    """Phase 18 (a)-(c); the caller sets the launch counts to 0 before."""
    parts = {}
    t0 = time.perf_counter()
    served = obs_serve(card, work, device)
    try:
        parts["18a"] = served["line"]
        parts["18a s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fed = obs_federation(card, x, y, work, device)
        parts["18b"] = fed
        parts["18b s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        parts["18c"] = obs_sentinel(card, work, f"{work}/14c", served,
                                    fed["dir"])
        parts["18c s"] = time.perf_counter() - t0
    finally:
        served["proc"].terminate()
        served["proc"].communicate(timeout=60)
    return parts


# ------------------------------------------------------------ phase 19 ----
#: the chaos case phase 19 watches: a budget-directory window, victim x
WITNESS_POINT, WITNESS_ROLE = "budget.mid_compaction", "x"
#: serve requests per family under the witness, and their users
WITNESS_REQS, WITNESS_USERS = 16, 8
FASTNORM_N, FASTNORM_RHO = 10**6, 0.5
#: the deep pass with every suppression off, in a process that cannot
#: import torch: what each rule would report without its reviewed
#: suppressions
_SUPPRESSED = ("import collections, json, sys; sys.modules['torch'] = None\n"
               "from dpcorr_torch.analysis import cli, core\n"
               "core.Module.suppressed = lambda self, rule, line: False\n"
               "vs = core.run_lint(list(cli.DEFAULT_PATHS), '.', deep=True)\n"
               "print(json.dumps(collections.Counter(v.rule for v in vs)))\n")
#: ``python -m dpcorr_torch`` that prints its K1 launch count last
_COUNTED = ("import json, sys\n"
            "from dpcorr_torch.__main__ import main\n"
            "try:\n"
            "    main(sys.argv[1:])\n"
            "finally:\n"
            "    from dpcorr_torch.ops import fused_ni\n"
            "    print(json.dumps({'k1_launches': "
            "fused_ni.KERNEL_LAUNCHES['fused_ni']}))\n")


def _witness_env(wdir: str) -> dict:
    env = _repo_env()
    env["DPCORR_SYNCWATCH"] = "1"
    env["DPCORR_SYNCWATCH_DIR"] = wdir
    return env


def lint_phase(card: str) -> dict:
    """19a: ``lint`` and ``lint --deep`` each in a process that cannot
    import torch, and the findings the suppressions hold back, per
    rule."""
    import subprocess

    out = {}
    for label, argv in (("lint", ["lint"]), ("lint --deep",
                                             ["lint", "--deep"])):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _NO_TORCH, *argv],
                              env=_tool_env(), capture_output=True,
                              text=True, timeout=300)
        out[label] = time.perf_counter() - t0
        if proc.returncode != 0 or "0 new violations" not in proc.stdout:
            raise RuntimeError(f"19a {label}: rc {proc.returncode}: "
                               f"{proc.stdout[-2000:]} {proc.stderr[-1500:]}")
    proc = subprocess.run([sys.executable, "-c", _SUPPRESSED],
                          env=_tool_env(), capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"19a suppressed count: {proc.stderr[-1500:]}")
    out["suppressed"] = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"[{card}] 19a lint {out['lint']:.2f} s and lint --deep "
          f"{out['lint --deep']:.2f} s (processes, torch blocked): 0 new "
          f"violations each; findings held by a suppression, per rule "
          f"{json.dumps(out['suppressed'], sort_keys=True)}", flush=True)
    return out


def witness_grid(card: str, want, wdir: str, work: str,
                 device: str = "cuda", b: int = GRID_B) -> dict:
    """19b(1): phase 9a's v1 grid (``grid --fused auto``) in a watched
    process; its table bit-equal to ``want`` (the unwatched run) and its
    K1 launches one per bucket."""
    import subprocess

    from dpcorr_torch import report

    out_dir = f"{work}/19b-grid"
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", _COUNTED, "grid", "--fused", "auto",
         "--backend", "bucketed", "--b", str(b), "--device", device,
         "--out", out_dir], env=_witness_env(wdir), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    out, err = proc.communicate(timeout=900)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"19b grid: rc {proc.returncode}: {err[-2000:]}")
    launches = json.loads(out.strip().splitlines()[-1])["k1_launches"]
    same_table(report.read_tables(out_dir)["detail"], want.detail_all,
               "19b witnessed v1 grid against the unwatched run")
    expected = V1_BUCKETS if device == "cuda" else 0
    print(f"[{card}] 19b(1) grid --fused auto under the witness: "
          f"{V1_POINTS} points x {b} reps, table bit-equal to the unwatched "
          f"run; K1 launches {launches} (expected {expected}); process "
          f"{dt:.1f} s", flush=True)
    if launches != expected:
        raise RuntimeError(f"19b grid: {launches} K1 launches")
    return {"pid": proc.pid, "launches": launches, "seconds": dt}


def witness_serve(card: str, wdir: str, work: str,
                  device: str = "cuda") -> dict:
    """19b(2): one ``serve --user-dir`` process at phase 18a's width under
    concurrent HTTP requests from 8 client threads, then SIGINT so that
    it exits and leaves its witness."""
    import signal
    import subprocess

    from dpcorr_torch.serve import HttpEstimateClient

    proc = subprocess.Popen(
        [sys.executable, "-m", "dpcorr_torch", "serve", "--port", "0",
         "--device", device, "--budget", "1e12",
         "--user-dir", f"{work}/19b-users", "--user-budget", "1e12",
         "--max-batch", str(SERVE_MAX_BATCH),
         "--max-delay-ms", str(SERVE_MAX_DELAY_S * 1e3)],
        env=_witness_env(wdir), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        base = f"http://127.0.0.1:{_banner_of(proc, 240)['serving']['port']}"
        per_user = WITNESS_REQS // WITNESS_USERS
        reqs = [r for f, seed0 in (("ni_sign", 70_000_000),
                                   ("int_sign", 71_000_000))
                for u in range(WITNESS_USERS)
                for r in serve_requests(f, per_user, SERVE_N,
                                        seed0 + per_user * u,
                                        user=f"user{u:02d}")]
        vals, _lat, dt = drive(HttpEstimateClient(base, timeout_s=300.0),
                               reqs, 8)
        if vals.shape != (len(reqs), 3) or not np.isfinite(vals).all():
            raise RuntimeError("19b serve: a request got a non-finite "
                               "answer")
    finally:
        proc.send_signal(signal.SIGINT)
        _, err = proc.communicate(timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"19b serve: rc {proc.returncode} after SIGINT: "
                           f"{err[-2000:]}")
    print(f"[{card}] 19b(2) serve --user-dir under the witness: "
          f"{len(reqs)} requests over {WITNESS_USERS} users from 8 threads "
          f"in {dt:.3f} s, all finite; exited 0 on SIGINT", flush=True)
    return {"pid": proc.pid, "seconds": dt}


def start_witness_chaos(wdir: str, work: str, device: str = "cuda"):
    """19b(3), started: one ``chaos`` case (``ni_sign``, victim x killed
    at a budget-directory window) with every process watched (the chaos
    command, both parties and the restarted victim), running beside
    19b(1)-(2)."""
    import subprocess

    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "dpcorr_torch", "chaos", "--device", device,
         "--families", "ni_sign", "--points", WITNESS_POINT, "--roles",
         WITNESS_ROLE, "--n", str(SERVE_N), "--timeout", "1",
         "--case-timeout", "120", "--workdir", f"{work}/19b-chaos"],
        env=_witness_env(wdir), text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)


def witness_chaos(card: str, started) -> dict:
    """19b(3), awaited: the case bit-identical to its reference."""
    t0, proc = started
    out, err = proc.communicate(timeout=600)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"19b chaos: rc {proc.returncode}: {out[-1500:]} "
                           f"{err[-1500:]}")
    doc = json.loads(out)
    if not doc["ok"] or not doc["cases"][0]["ok"]:
        raise RuntimeError(f"19b chaos: {doc}")
    print(f"[{card}] 19b(3) chaos {doc['cases'][0]['case']} under the "
          f"witness, beside 19a-b(2): bit-identical to its reference, ε "
          f"spent once, {dt:.1f} s from its start", flush=True)
    return {"pid": proc.pid, "seconds": dt}


def witness_gate(card: str, wdir: str, watched: dict) -> dict:
    """19c: every watched process left its artifact (the chaos victim its
    crash dump), the artifacts wrap port locks, and ``lint --witness``
    passes over them in a process that cannot import torch."""
    import glob
    import os
    import subprocess

    from dpcorr_torch.utils.syncwatch import ARTIFACT_PREFIX

    arts = []
    for path in sorted(glob.glob(f"{wdir}/{ARTIFACT_PREFIX}*.json")):
        with open(path, encoding="utf-8") as fh:
            arts.append(json.load(fh))
    pids = {a["pid"] for a in arts}
    missing = [k for k, v in watched.items() if v["pid"] not in pids]
    parties = [a for a in arts if "party" in a["argv"]]
    killed = [a for a in parties if a["end"] == f"chaos:{WITNESS_POINT}"]
    if missing or len(parties) != 3 or len(killed) != 1:
        raise RuntimeError(
            f"19c: a watched process left no artifact: missing {missing}, "
            f"parties {len(parties)} (3: x, y, x restarted), chaos-killed "
            f"{len(killed)}; artifacts "
            f"{[(a['pid'], a['argv'][:3], a['end']) for a in arts]}")
    wrapped = sorted({s for a in arts for s in a["locks"]})
    if not wrapped:
        raise RuntimeError("19c: the witness wrapped no lock site")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _NO_TORCH, "lint",
                           "--witness", wdir, "--json"], env=_tool_env(),
                          capture_output=True, text=True, timeout=300)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"19c lint --witness: rc {proc.returncode}: "
                           f"{proc.stdout[-3000:]} {proc.stderr[-1500:]}")
    rep = json.loads(proc.stdout)
    print(f"[{card}] 19c lint --witness {os.path.basename(wdir)}: exit 0 "
          f"in {dt:.2f} s; {len(rep['witness_files'])} artifacts (grid, "
          f"serve, chaos command, 3 party processes, the killed victim's "
          f"from its crash hook), {len(wrapped)} wrapped lock sites, "
          f"{len(rep['observed_edges'])} observed edges against "
          f"{len(rep['static_edges'])} predicted, "
          f"{len(rep['unknown_sites'])} unknown sites; observed "
          f"{json.dumps(rep['observed_edges'])}", flush=True)
    return {"artifacts": len(arts), "wrapped_sites": len(wrapped),
            "observed_edges": len(rep["observed_edges"]),
            "predicted_edges": len(rep["static_edges"]),
            "unknown_sites": len(rep["unknown_sites"]), "seconds": dt}


def fastnorm_card(card: str) -> dict:
    """19d: ``fastnorm.gen_gaussian_bm`` at n = 10⁶ on the card against
    the CPU on the same key (1e-5 absolute per element) and its sample
    correlation against ρ (0.005)."""
    from dpcorr_torch.ops import fastnorm
    from dpcorr_torch.utils import rng
    from dpcorr_torch.utils.device import time_cuda

    key = rng.stream(rng.master_key(), "fastnorm")
    xy = fastnorm.gen_gaussian_bm(key.cuda(), FASTNORM_N, FASTNORM_RHO)
    ms = time_cuda(lambda: fastnorm.gen_gaussian_bm(
        key.cuda(), FASTNORM_N, FASTNORM_RHO), 10)
    cpu = fastnorm.gen_gaussian_bm(key, FASTNORM_N, FASTNORM_RHO)
    err = (xy.cpu() - cpu).abs().max().item()
    corr = torch.corrcoef(xy.double().T)[0, 1].item()
    print(f"[{card}] 19d fastnorm.gen_gaussian_bm, n = {FASTNORM_N}: "
          f"{ms:.4f} ms on the card; max |card − CPU| {err:.3e} (≤ 1e-5); "
          f"sample correlation {corr:.5f} (ρ = {FASTNORM_RHO}, within "
          f"0.005)", flush=True)
    if tuple(xy.shape) != (FASTNORM_N, 2) or err > 1e-5 or \
            abs(corr - FASTNORM_RHO) > 0.005:
        raise RuntimeError(f"19d fastnorm: shape {tuple(xy.shape)}, error "
                           f"{err}, correlation {corr}")
    return {"ms": ms, "max_abs_err": err, "corr": corr}


def witness_phase(card: str, want_grid, work: str,
                  device: str = "cuda") -> dict:
    """Phase 19 (a)-(d); the caller sets the launch counts to 0 before."""
    import os

    wdir = f"{work}/19-witness"
    os.makedirs(wdir)
    parts, watched = {}, {}
    chaos = start_witness_chaos(wdir, work, device)
    try:
        for label, fn in (
                ("19a", lambda: lint_phase(card)),
                ("grid", lambda: witness_grid(card, want_grid, wdir, work,
                                              device)),
                ("serve", lambda: witness_serve(card, wdir, work, device)),
                ("chaos", lambda: witness_chaos(card, chaos)),
                ("19c", lambda: witness_gate(card, wdir, watched)),
                ("19d", lambda: fastnorm_card(card) if device == "cuda"
                 else None)):
            t0 = time.perf_counter()
            parts[label] = fn()
            parts[label + " s"] = time.perf_counter() - t0
            if label in ("grid", "serve", "chaos"):
                watched[label] = parts[label]
    finally:
        if chaos[1].poll() is None:  # a part above failed first
            chaos[1].kill()
            chaos[1].communicate()
    return parts


# ------------------------------------------------------------ phase 20 ----
#: phase 20a: the ladder's comparison layouts (m' = 8 at n = 1000 and
#: 10⁴, m = 11 in m' = 16 with leftovers, and m' = 8 at n = 40,000, where
#: L4-L5 keep no planes) and replications
LADDER_GEOMETRIES = [(1_000, (1.0, 1.0)), (10_000, (1.0, 1.0)),
                     (9_000, (1.5, 0.5)), (40_000, (1.0, 1.0))]
LADDER_B = 256
#: phase 20b: K1's probe shape (the script's L7)
LADDER_BIG_B = 4096
#: phase 20d: (n, ε, compute_int) above the cap on the planes, at phase
#: 3's B = 256 (external uniforms: 1.6-2 MB a replication at n = 10⁵, so
#: 0.4-0.5 GB a case); the timed in-kernel shapes (n, B)
REGEN_CASES = [(28_673, (1.0, 1.0), False), (25_601, (1.0, 1.0), True),
               (40_000, (1.0, 1.0), False), (40_000, (1.0, 1.0), True),
               (100_000, (1.0, 1.0), False), (100_000, (1.0, 1.0), True),
               (100_000, (0.25, 0.25), False),
               (100_000, (0.25, 0.25), True)]
REGEN_B = COMPARE_B
REGEN_TIMED = [(100_000, 1 << 14), (1_000_000, 1 << 10)]
#: phase 20e: the one-bucket grid above the cap
CAP_GRID_N = 40_000
BISECT_TIMEOUT_S = 900


def ladder_levels_ptxas(card: str) -> dict:
    """20a(1): ``ptxas`` registers and spills of the ladder's 14 variants
    (L4-L5 with planes and without), by level name, bit source and
    planes."""
    from dpcorr_torch.bisect import LEVELS
    from dpcorr_torch.ops import _build

    log = _build.log_path("fused_ni_ladder")
    if not log.exists():
        raise RuntimeError(f"no compiler report beside this build of "
                           f"fused_ni_ladder ({log})")
    report = _build.ptxas_report(log.read_text())
    want = [(lv, ext, pl) for lv in range(1, 6) for ext in (0, 1)
            for pl in ((0, 1) if lv >= 4 else (0,))]
    if sorted(report) != want:
        raise RuntimeError(f"ptxas reported ladder variants "
                           f"{sorted(report)}, expected {want}")
    out = {}
    for (lv, ext, pl), (regs, stack, st, ld) in sorted(report.items()):
        src = ("external" if ext else "in-kernel") + (
            "" if pl or lv < 4 else ", no planes")
        out.setdefault(LEVELS[lv - 1], {})[src] = {
            "registers": regs, "stack": stack, "spill_stores": st,
            "spill_loads": ld}
        print(f"ptxas fused_ni_ladder [L{lv} {LEVELS[lv - 1]} {src}]: "
              f"{regs} registers, {stack} bytes stack frame, {st} bytes "
              f"spill stores, {ld} bytes spill loads", flush=True)
    return out


def ladder_against_plain(card: str) -> dict:
    """20a(2): the ladder kernel against its plain version at L1-L5 on
    random external bits, in-kernel mode against external mode on
    ``philox_bits``, and at L4-L5 where the planes fit the variant
    without them forced, bit-equal to the one with them in both modes.
    Returns per level the largest |error| and the largest error over
    Σ|terms|. These launches do not count."""
    from dpcorr_torch import bisect
    from dpcorr_torch.bisect import LEVELS, RHO
    from dpcorr_torch.ops import fused_ni, ladder

    # dpcorr-lint: ignore[rng-raw-api,rng-literal-seed] — a fixed generator for the comparison's inputs, not DP noise
    gen = torch.Generator(device="cuda").manual_seed(2026)
    errs = {}
    for n, eps in LADDER_GEOMETRIES:
        m, m_pad, k, leftover, _ = fused_ni.layout(n, *eps)
        # dpcorr-lint: ignore[rng-raw-api] — random bits to hold the kernel's external mode against its plain version, not DP noise
        bits = torch.randint(-2**31, 2**31, (LADDER_B, ladder.bit_rows(
            n, *eps), 128), generator=gen, device="cuda",
            dtype=torch.int64).to(torch.int32)
        # dpcorr-lint: ignore[rng-raw-api] — random seeds for the same comparison, not DP noise
        seeds = torch.randint(-2**31, 2**31, (LADDER_B, 2), generator=gen,
                              device="cuda", dtype=torch.int64).to(
                                  torch.int32)
        laid = ladder.philox_bits(seeds, n, *eps)
        for level in ladder.KERNEL_LEVELS:
            got = ladder.ladder_sums(seeds, RHO, n, *eps, level, bits)
            inside = ladder.ladder_sums(seeds, RHO, n, *eps, level)
            outside = ladder.ladder_sums(seeds, RHO, n, *eps, level, laid)
            # dpcorr-lint: ignore[sync-in-loop] — the kernel must finish before its plain version runs on the same buffers
            torch.cuda.synchronize()
            want = ladder.ladder_plain(bits, RHO, n, *eps, level)
            mag = ladder.ladder_plain(bits, RHO, n, *eps, level,
                                      magnitude=True)
            diff = (got - want).abs()
            # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
            share = (diff <= 1e-5 * mag).float().mean().item()
            # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
            abs_err, rel_err = diff.max().item(), (diff / mag).max().item()
            same = torch.equal(inside, outside)
            kept = ladder.planes_kept(n, *eps, level)
            forced = None
            if kept:  # the variant without planes, forced, both sources
                forced = (torch.equal(got, ladder.ladder_sums(
                    seeds, RHO, n, *eps, level, bits, _regen=True))
                    and torch.equal(inside, ladder.ladder_sums(
                        seeds, RHO, n, *eps, level, _regen=True)))
            name = LEVELS[level - 1]
            e = errs.setdefault(name, {"max_abs_err": 0.0,
                                       "max_err_over_terms": 0.0})
            e["max_abs_err"] = max(e["max_abs_err"], abs_err)
            e["max_err_over_terms"] = max(e["max_err_over_terms"], rel_err)
            print(f"[{card}] 20a L{level} {name} n={n} eps={eps} m={m} "
                  f"m'={m_pad} k={k} left={leftover}: within 1e-5 x "
                  f"sum|terms| of the plain version {share:.4f} of "
                  f"{LADDER_B}; max |err| {abs_err:.4g} ({rel_err:.3g} of "
                  f"sum|terms|); in-kernel == external on philox_bits: "
                  f"{same}; planes {'kept' if kept else 'none'}"
                  + ("" if forced is None else
                     f", forced variant without planes bit-equal: "
                     f"{forced}"), flush=True)
            need = 0.99 if level == 5 else 1.0
            if not torch.isfinite(got).all() or share < need:
                raise RuntimeError(f"20a: the ladder kernel disagrees with "
                                   f"its plain version at L{level}, n={n} "
                                   f"eps={eps}: {share} within tolerance")
            if not same or not torch.isfinite(inside).all():
                raise RuntimeError(f"20a: in-kernel ladder mode differs "
                                   f"from external mode on philox_bits at "
                                   f"L{level}, n={n} eps={eps}")
            if forced is False:
                raise RuntimeError(f"20a: the ladder's variant without "
                                   f"planes differs from the one with them "
                                   f"at L{level}, n={n} eps={eps}")
    for level in ("center", "matmul"):  # the bisect's probes above the cap
        res = bisect.probe_level(level, n=CAP_GRID_N)
        print(f"[{card}] 20a bisect probe {level} at n={CAP_GRID_N}: "
              f"{json.dumps(res)}", flush=True)
        if not (res["ok"] and res["finite"]):
            raise RuntimeError(f"20a: the probe {level} at n={CAP_GRID_N} "
                               f"failed: {res}")
    return errs


def ladder_times(card: str, k1_ms: float) -> dict:
    """20b: each level's ms at B = 2¹⁴, n = 10⁴, in-kernel (CUDA events;
    L6 = K1 at the same shape, L7 = K1 at B = 4096), beside its bound
    and its plain version's ms on random bits of the same shape, and the
    increment from the level before. These launches do not count."""
    from dpcorr_torch.bisect import LEVELS, RHO
    from dpcorr_torch.ops import fused_ni, ladder
    from dpcorr_torch.utils.device import time_cuda
    from dpcorr_torch.utils.roofline import ladder_pipe_ops, least_time_ms

    b = FUSED_BLOCK
    seeds = torch.stack([torch.arange(b, dtype=torch.int32),
                         torch.zeros(b, dtype=torch.int32)], 1).cuda()
    rho_b = torch.full((b,), RHO, device="cuda")
    # dpcorr-lint: ignore[rng-raw-api] — timing bits for the plain version, not DP noise
    bits = torch.randint(-2**31, 2**31, (b, ladder.bit_rows(N, *EPS), 128),
                         device="cuda", dtype=torch.int64).to(torch.int32)
    u = None
    out, prev = {}, None
    for level in range(1, 8):
        name = LEVELS[level - 1]
        reps = b if level < 7 else LADDER_BIG_B
        if level <= 5:
            ms = time_cuda(lambda: ladder.ladder_sums(
                seeds, RHO, N, *EPS, level), 20)
            plain_ms = time_cuda(lambda: ladder.ladder_plain(
                bits, RHO, N, *EPS, level), 3)
            bytes_ = reps * (8 + 4)
        else:
            s, r = seeds[:reps], rho_b[:reps]
            ms = time_cuda(lambda: fused_ni.fused_ni_sums(s, r, N, *EPS), 20)
            if u is None:
                # dpcorr-lint: ignore[rng-raw-api] — timing uniforms for the plain version, not DP noise
                u = torch.rand(b, fused_ni.n_uniform_rows(N, *EPS), 128,
                               device="cuda") * (1 - 2e-7) + 1e-7
            plain_ms = time_cuda(lambda: fused_ni.fused_ni_plain(
                s, r, u[:reps], n=N, eps1=EPS[0], eps2=EPS[1]), 3)
            bytes_ = reps * (8 + 4 + 12)
        times = least_time_ms(ladder_pipe_ops(level, N, EPS), reps, bytes_)
        by = max(times, key=times.get)
        inc = None if prev is None or level == 7 else ms - prev
        out[name] = {"level": level, "batch": reps, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": times[by],
                     "bound_by": by, "increment_ms": inc}
        print(f"[{card}] 20b L{level} {name}, B={reps}, n={N}, in-kernel: "
              f"{ms:.4f} ms"
              + (f" (+{inc:.4f} ms on L{level - 1})" if inc is not None
                 else "")
              + f"; bound {times[by]:.4f} ms by {by} ({times[by] / ms:.1%})"
              f"; plain version {plain_ms:.4f} ms", flush=True)
        if level <= 6:
            prev = ms
    l6 = out["full"]["ms"]
    print(f"[{card}] 20b L6 {l6:.4f} ms against phase 7's K1 {k1_ms:.4f} ms "
          f"({l6 / k1_ms - 1.0:+.2%}; gate ±10%)", flush=True)
    if abs(l6 / k1_ms - 1.0) > 0.10:
        raise RuntimeError(f"20b: L6 {l6} ms is not phase 7's K1 time "
                           f"{k1_ms} ms")
    return out


def start_bisect(work: str) -> dict:
    """20c, started: ``python -m dpcorr_torch.bisect`` as a process on the
    card, running beside phase 19 (its eight processes start one at a
    time). It is stopped at exit if a phase fails first: SIGTERM lets the
    orchestrator kill its probe's process group."""
    import atexit
    import subprocess

    out = f"{work}/bisect.json"
    log = open(f"{work}/bisect.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dpcorr_torch.bisect", "--out", out],
        stdout=log, stderr=subprocess.STDOUT, text=True, env=_repo_env())
    started = {"proc": proc, "t0": time.perf_counter(), "out": out,
               "log": log}
    atexit.register(stop_bisect, started)
    return started


def stop_bisect(started: dict) -> None:
    import subprocess

    proc = started["proc"]
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    started["log"].close()


def bisect_process(card: str, started: dict) -> dict:
    """20c: the bisect started beside phase 19, waited on. Its probes
    report their own launches (each in its own process). Their ``ms``
    are left out: they ran beside phase 19's processes (20b times every
    level on an idle card)."""
    from dpcorr_torch.bisect import LEVELS

    proc = started["proc"]
    rc = proc.wait(timeout=BISECT_TIMEOUT_S)
    dt = time.perf_counter() - started["t0"]
    started["log"].seek(0)
    said = started["log"].read()
    stop_bisect(started)
    if rc != 0:
        raise RuntimeError(f"20c: bisect exited {rc}: {said[-4000:]}")
    with open(started["out"]) as f:
        report = json.load(f)
    probes = report["probes"]
    results = [p["result"] for p in probes]
    ok = (report["culprit"] is None and not report["wedged"]
          and report["health"].startswith("HEALTH-OK")
          and [p["level"] for p in probes] == LEVELS
          and all(isinstance(r, dict) and r["ok"] and r["finite"]
                  for r in results))
    launches = {"fused_ni_ladder": sum(r["launches"] for r in results[:5]),
                "fused_ni": sum(r["launches"] for r in results[5:])}
    for p in probes:
        r = {k: v for k, v in p["result"].items() if k != "ms"}
        print(f"[{card}] 20c probe {p['level']}: {json.dumps(r)}",
              flush=True)
    print(f"[{card}] 20c bisect process {dt:.1f} s from its start beside "
          f"phase 19: health "
          f"{report['health']!r} ({report['initial_health_s']} s), "
          f"culprit {report['culprit']}, wedged {report['wedged']}, "
          f"launches reported by the probes {launches}", flush=True)
    if not ok or launches != {"fused_ni_ladder": 5, "fused_ni": 2}:
        raise RuntimeError(f"20c: bisect report not clean: {report}")
    return {"seconds": dt, "launches": launches}


def regen_against_plain(card: str) -> float:
    """20d(1): K1's variant without planes against its plain version in
    all 16 modes above the cap; returns the largest |ΣT| error. These
    launches do not count."""
    from dpcorr_torch.ops import fused_ni

    # dpcorr-lint: ignore[rng-raw-api,rng-literal-seed] — a fixed generator for the comparison's inputs, not DP noise
    gen = torch.Generator(device="cuda").manual_seed(2027)
    rho = torch.linspace(-0.6, 0.9, REGEN_B, device="cuda")
    worst = 0.0
    for n, eps, compute_int in REGEN_CASES:
        c = fused_ni._Consts(n, *eps, (0.0, 0.0), (1.0, 1.0))
        if c.planes_kept(compute_int):
            raise RuntimeError(f"20d: n={n} eps={eps} keeps its planes")
        for gauss in ("boxmuller", "ndtri"):
            for normalise in (True, False):
                kw = dict(normalise=normalise, compute_int=compute_int,
                          gauss=gauss)
                fracs, errs, bit_equal = compare_mode(n, eps, kw, gen, rho,
                                                      REGEN_B)
                worst = max(worst, errs[0][0], errs[1][0])
                print(f"[{card}] 20d no planes n={n} eps={eps} m={c.m} "
                      f"m'={c.m_pad} int={int(compute_int)} {gauss} "
                      f"norm={int(normalise)}: within tol external "
                      f"{fracs[0]:.4f} philox {fracs[1]:.4f} of {REGEN_B}; "
                      f"in-kernel == external on philox_uniforms: "
                      f"{bit_equal}; max |err| "
                      f"{[f'{e:.3g}' for e in errs[0] + errs[1]]}",
                      flush=True)
                if min(fracs) < 0.99 or not bit_equal:
                    raise RuntimeError(f"20d: the variant without planes "
                                       f"disagrees: n={n} eps={eps} {kw} "
                                       f"{fracs} {bit_equal}")
    return worst


def regen_forced_bits(card: str) -> int:
    """20d(2): at every phase 3 layout, the variant without planes forced
    gives the bits of the variant with them, in all 16 modes. Returns
    the cases held. These launches do not count."""
    from dpcorr_torch.ops import fused_ni

    # dpcorr-lint: ignore[rng-raw-api,rng-literal-seed] — a fixed generator for the comparison's inputs, not DP noise
    gen = torch.Generator(device="cuda").manual_seed(2028)
    rho = torch.linspace(-0.6, 0.9, COMPARE_B, device="cuda")
    # dpcorr-lint: ignore[rng-raw-api] — random seeds for the comparison, not DP noise
    seeds = torch.randint(-2**31, 2**31, (COMPARE_B, 2), generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)
    cases = 0
    for n, eps in COMPARE_GEOMETRIES:
        for compute_int in (False, True):
            rows = fused_ni.n_uniform_rows(n, *eps, compute_int)
            # dpcorr-lint: ignore[rng-raw-api] — random uniforms for the comparison, not DP noise
            u = torch.rand(COMPARE_B, rows, 128, device="cuda",
                           generator=gen) * (1 - 2e-7) + 1e-7
            for uu in (None, u):
                for gauss in ("boxmuller", "ndtri"):
                    for normalise in (True, False):
                        kw = dict(normalise=normalise, gauss=gauss,
                                  compute_int=compute_int, uniforms=uu)
                        kept = fused_ni.fused_ni_sums(seeds, rho, n, *eps,
                                                      **kw)
                        forced = fused_ni.fused_ni_sums(seeds, rho, n, *eps,
                                                        **kw, _regen=True)
                        if not torch.equal(kept, forced):
                            raise RuntimeError(
                                f"20d: the forced variant differs from the "
                                f"one with planes: n={n} eps={eps} "
                                f"external={uu is not None} {kw.keys()}")
                        cases += 1
    print(f"[{card}] 20d forced variant without planes bit-equal to the one "
          f"with planes in {cases} cases (9 layouts x 16 modes, B = "
          f"{COMPARE_B})", flush=True)
    return cases


def regen_times(card: str) -> dict:
    """20d(3): the variant without planes, in-kernel NI, timed at
    n = 10⁵, B = 2¹⁴ and n = 10⁶, B = 2¹⁰ beside the bound of the same
    work (the function's, not the variant's second draw). These launches
    do not count."""
    from dpcorr_torch.ops import fused_ni
    from dpcorr_torch.utils import rng
    from dpcorr_torch.utils.device import time_cuda
    from dpcorr_torch.utils.roofline import fused_pipe_ops, least_time_ms

    key = rng.master_key(device="cuda")
    out = {}
    for n, b in REGEN_TIMED:
        seeds = rng.kernel_seeds(rng.rep_keys(key, b)).contiguous()
        rho_b = torch.full((b,), RHO, device="cuda")
        got = fused_ni.fused_ni_sums(seeds, rho_b, n, *EPS)
        if not torch.isfinite(got).all():
            raise RuntimeError(f"20d: NaN/Inf at n={n}")
        ms = time_cuda(lambda: fused_ni.fused_ni_sums(seeds, rho_b, n, *EPS),
                       3)
        times = least_time_ms(fused_pipe_ops(n, EPS, False), b,
                              b * (8 + 4 + 12))
        by = max(times, key=times.get)
        blocks = fused_ni.blocks_per_sm(n, *EPS)
        out[n] = {"batch": b, "ms": ms, "bound_ms": times[by],
                  "bound_by": by, "blocks_per_sm": blocks}
        print(f"[{card}] 20d no planes, in-kernel NI, n={n}, B={b}: "
              f"{ms:.4f} ms, bound {times[by]:.4f} ms by {by} "
              f"({times[by] / ms:.1%}); {blocks} blocks per SM", flush=True)
    return out


def cap_grid(card: str) -> dict:
    """20e: the v1 sign grid cut to one bucket above the cap, fused then
    unfused, the launch counts set to 0 before each arm and read after
    it."""
    from dpcorr_torch.grid import GridConfig
    from dpcorr_torch.ops import fused_ni

    eps = (1.0, 1.0)
    old_gate = fused_ni.fits_on_chip(CAP_GRID_N, *eps, compute_int=True)
    arms = {}
    for fused in ("auto", "off"):
        reset_launches()
        res, dt = run_grid_timed(GridConfig(
            n_grid=(CAP_GRID_N,), eps_pairs=(eps,), b=GRID_B,
            backend="bucketed", fused=fused))
        launches = dict(fused_ni.KERNEL_LAUNCHES)
        d = res.detail_all
        err = d["ni_hat"] - d["rho_true"]
        arms[fused] = {"seconds": dt, "launches": launches, "err": err,
                       "ni_cover": float(d["ni_cover"].mean()),
                       "int_cover": float(d["int_cover"].mean())}
        print(f"[{card}] 20e grid n={CAP_GRID_N} eps={eps}, fused={fused}: "
              f"{len(err)} reps in {dt:.3f} s; K1 launches {launches}; "
              f"fused buckets {int(res.timings['fused'].sum())}; coverage "
              f"NI {arms[fused]['ni_cover']:.4f} INT "
              f"{arms[fused]['int_cover']:.4f}; mean rho_hat - rho "
              f"{err.mean():+.5f}", flush=True)
        for m in ("ni_cover", "int_cover"):
            if not 0.90 <= arms[fused][m] <= 0.99:
                raise RuntimeError(f"20e {fused}: {m} {arms[fused][m]} "
                                   f"outside [0.90, 0.99]")
    if arms["auto"]["launches"] != {"fused_ni": 1, "fused_ni_regen": 1} \
            or arms["off"]["launches"]["fused_ni"]:
        raise RuntimeError(f"20e: launches {arms['auto']['launches']} / "
                           f"{arms['off']['launches']}; expected one K1 "
                           f"launch without planes, then none")
    ef, eo = arms["auto"]["err"], arms["off"]["err"]
    se = math.sqrt(ef.var(ddof=1) / len(ef) + eo.var(ddof=1) / len(eo))
    gap = abs(ef.mean() - eo.mean())
    print(f"[{card}] 20e fused - unfused mean rho_hat {ef.mean() - eo.mean():+.5f}"
          f" ({gap / se:.2f} MC standard errors of {se:.5f}; gate 4); the "
          f"earlier gate fits_on_chip={old_gate} sent this bucket unfused "
          f"(0 K1 launches)", flush=True)
    if gap > 4 * se or old_gate:
        raise RuntimeError(f"20e: fused and unfused mean rho_hat differ by "
                           f"{gap} > 4 x {se}")
    return {"launches": arms["auto"]["launches"],
            "seconds": {k: v["seconds"] for k, v in arms.items()},
            "z": gap / se}


def ladder_phase(card: str, bisect_run: dict, k1_ms: float) -> dict:
    """Phase 20, part by part with each part's seconds; 20c waits for the
    bisect started beside phase 19, so 20b's times run after it ends."""
    parts = {}
    for label, fn in (
            ("20a ptxas", lambda: ladder_levels_ptxas(card)),
            ("20a", lambda: ladder_against_plain(card)),
            ("20c", lambda: bisect_process(card, bisect_run)),
            ("20b", lambda: ladder_times(card, k1_ms)),
            ("20d", lambda: regen_against_plain(card)),
            ("20d forced", lambda: regen_forced_bits(card)),
            ("20d times", lambda: regen_times(card)),
            ("20e", lambda: cap_grid(card))):
        t0 = time.perf_counter()
        parts[label] = fn()
        parts[label + " s"] = time.perf_counter() - t0
    return parts


RBG_KEYS = 1 << 10             # 21a: keys held against the plain version
RBG_WORDS = 2 * N              # words a replication draws for its data
RBG_CARRY = [5, 0xFFFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF]
RBG_TURNS = ("threefry2x32", "rbg", "rbg", "threefry2x32")
RBG_TIMED_KEYS = 1 << 14       # 21d: the unfused block's keys


def _prng_impl(impl: str):
    """``DPCORR_PRNG`` set to ``impl`` inside the block, restored after."""
    import os
    from unittest import mock

    return mock.patch.dict(os.environ, {"DPCORR_PRNG": impl})


def rbg_against_plain(card: str) -> dict:
    """Phase 21a: the rbg_bits kernel bit-equal to its plain version on the
    CPU (and on the card) for 2¹⁰ rbg keys × 2·10⁴ words, the
    carry-crossing key, and unsafe_rbg's fold_in and split."""
    from dpcorr_torch.ops import rbg
    from dpcorr_torch.utils import rng

    keys = rng.rep_keys(rng.master_key(impl="rbg"), RBG_KEYS)
    card_bits = rbg.rbg_bits(keys.cuda(), RBG_WORDS)
    cases = {
        "rbg keys": (card_bits.cpu(), rbg.rbg_bits_plain(keys, RBG_WORDS)),
        "rbg keys, plain on the card": (
            card_bits, rbg.rbg_bits_plain(keys.cuda(), RBG_WORDS)),
    }
    carry = torch.tensor([RBG_CARRY], dtype=torch.int64)
    cases["carry-crossing key"] = (rbg.rbg_bits(carry.cuda(), 4096).cpu(),
                                   rbg.rbg_bits_plain(carry, 4096))
    with _prng_impl("unsafe_rbg"):
        root = rng.design_key(rng.master_key(), 3)
        cases["unsafe_rbg fold_in"] = (
            rng.rep_keys(root.cuda(), RBG_KEYS).cpu(),
            rng.rep_keys(root, RBG_KEYS))
        cases["unsafe_rbg split"] = (rng.split(root.cuda(), 257).cpu(),
                                     rng.split(root, 257))
    torch.cuda.synchronize()
    worst = 0
    for label, (got, want) in cases.items():
        # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
        err = int((got.cpu() - want.cpu()).abs().max())
        worst = max(worst, err)
        print(f"[{card}] 21a rbg_bits {label} {tuple(got.shape)}: card "
              f"bit-equal to plain {err == 0}", flush=True)
        if err:
            raise RuntimeError(f"21a: rbg_bits disagrees with its plain "
                               f"version on {label} by {err}")
    return {"max_abs_err": worst, "cases": len(cases)}


def rbg_north_star(card: str, tf_fused_sums) -> dict:
    """Phase 21b: the north star on rbg keys, unfused (NI and INT, 2¹⁶
    replications) and fused (K1, 2²⁰), every launch count set to 0 just
    before and read just after."""
    from dpcorr_torch.ops import fused_ni, rbg
    from dpcorr_torch.sim import (
        DETAIL_FIELDS,
        SimConfig,
        _one_rep,
        fused_ni_rep_fn,
    )
    from dpcorr_torch.utils import rng

    cfg = SimConfig(n=N, rho=RHO, eps1=EPS[0], eps2=EPS[1], alpha=ALPHA)

    def body(keys):
        return _one_rep(keys, RHO, cfg)

    reset_launches()
    rbg.KERNEL_LAUNCHES["rbg_bits"] = 0
    with _prng_impl("rbg"):
        key = rng.master_key(device="cuda")
        unfused = run_pipeline(body, 1 << 14, 1 << 11, UNFUSED_REPS >> 14,
                               key, out_len=len(DETAIL_FIELDS))
        fused = run_pipeline(fused_ni_rep_fn(N, RHO, *EPS, ALPHA),
                             FUSED_BLOCK, FUSED_BLOCK, FUSED_BLOCKS, key)
    launches = {**fused_ni.KERNEL_LAUNCHES, **rbg.KERNEL_LAUNCHES}
    print(f"[{card}] 21b unfused on rbg, NI + INT: {json.dumps(unfused)}",
          flush=True)
    print(f"[{card}] 21b fused on rbg: {json.dumps(fused)}", flush=True)
    print(f"launches in the rbg main path's run: {launches}", flush=True)
    for label, cov in (("unfused NI", unfused["ni_cover"]),
                       ("unfused INT", unfused["int_cover"]),
                       ("fused NI", fused["coverage"])):
        if not 0.90 <= cov <= 0.99:
            raise RuntimeError(f"21b {label} coverage on rbg {cov} outside "
                               f"[0.90, 0.99]")
    if fused["sums"] == tf_fused_sums:
        raise RuntimeError("21b: the fused sums on rbg keys equal the "
                           "threefry run's: the seeds did not come from "
                           "the impl")
    if not launches["rbg_bits"] or not launches["fused_ni"]:
        raise RuntimeError(f"21b: the rbg main path launched {launches}")
    return {"unfused": unfused, "fused": fused, "launches": launches}


def rbg_turns(card: str) -> dict:
    """Phase 21c: the unfused north-star pipeline (NI, 2¹⁶ replications)
    on threefry and on rbg keys in paired turns; then, per impl, the
    kernel launches and CUDA activities of one block."""
    from dpcorr_torch.ops import rbg
    from dpcorr_torch.sim import RepBlockPipeline, ni_rep_fn
    from dpcorr_torch.utils import rng

    body = ni_rep_fn(N, RHO, *EPS, ALPHA)
    turns = {impl: [] for impl in RBG_TURNS}
    for impl in RBG_TURNS:
        with _prng_impl(impl):
            run = run_pipeline(body, 1 << 14, 1 << 11, UNFUSED_REPS >> 14,
                               rng.master_key(device="cuda"))
        turns[impl].append(run["reps_per_s"])
    per_block = {}
    for impl in ("threefry2x32", "rbg"):
        with _prng_impl(impl):
            pipe = RepBlockPipeline(body, 3, key=rng.master_key(
                device="cuda"), block_reps=1 << 14, chunk_size=1 << 11)
            pipe.run(1)  # warm
            before = rbg.KERNEL_LAUNCHES["rbg_bits"]
            acts = _device_activities(lambda: pipe.run(1))
        per_block[impl] = {
            "rbg_bits_launches": rbg.KERNEL_LAUNCHES["rbg_bits"] - before,
            "cuda_activities": acts}
    print(f"[{card}] 21c unfused NI pipeline, {UNFUSED_REPS} reps, turns "
          f"{list(RBG_TURNS)}: reps/s {json.dumps(turns)}; per block of "
          f"2^14 reps {json.dumps(per_block)} (a measurement, not a claim)",
          flush=True)
    return {"reps_per_s": turns, "per_block": per_block}


def rbg_times(card: str) -> dict:
    """Phase 21d: the kernel's ms at the unfused block's shape (2¹⁴ keys ×
    2·10⁴ words), its bound and its plain version's ms on the card."""
    from dpcorr_torch.ops import _build, rbg
    from dpcorr_torch.utils import rng
    from dpcorr_torch.utils.device import time_cuda
    from dpcorr_torch.utils.roofline import (
        least_time_ms,
        rbg_bits_bytes,
        rbg_bits_ops,
    )

    keys = rng.rep_keys(rng.master_key(impl="rbg", device="cuda"),
                        RBG_TIMED_KEYS).contiguous()
    before = rbg.KERNEL_LAUNCHES["rbg_bits"]
    ms = time_cuda(lambda: rbg.rbg_bits(keys, RBG_WORDS), 20)
    rbg.KERNEL_LAUNCHES["rbg_bits"] = before  # timing launches do not count
    plain_ms = time_cuda(lambda: rbg.rbg_bits_plain(keys, RBG_WORDS), 3)
    times = least_time_ms(rbg_bits_ops(RBG_WORDS), RBG_TIMED_KEYS,
                          rbg_bits_bytes(RBG_TIMED_KEYS, RBG_WORDS))
    by = max(("bytes", "int32"), key=times.get)
    bound = times[by]
    log = _build.log_path("rbg_bits").read_text()
    ptxas = _build.ptxas_report(log)
    print(f"[{card}] 21d rbg_bits, {RBG_TIMED_KEYS} keys x {RBG_WORDS} "
          f"words: {ms:.4f} ms ({bound / ms:.1%} of its bound {bound:.4f} ms "
          f"by {by}; int32 {times['int32']:.4f} ms); plain version "
          f"{plain_ms:.4f} ms; ptxas {ptxas}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if by == "bytes" else "operations",
            "int32_bound_ms": times["int32"], "ptxas": list(ptxas.values())}


def rbg_phase(card: str, tf_fused_sums) -> dict:
    """Phase 21: the key-tree's rbg-family implementations."""
    out = {}
    for label, fn in (("21a", lambda: rbg_against_plain(card)),
                      ("21b", lambda: rbg_north_star(card, tf_fused_sums)),
                      ("21c", lambda: rbg_turns(card)),
                      ("21d", lambda: rbg_times(card))):
        t0 = time.perf_counter()
        out[label] = fn()
        out[label + " s"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------ phase 22 ----
PATH_FOLDS = 1 << 10                  # 22a: data values folded per impl
PATH_CHAIN_CHUNKS = 64                # 22a: the stream's per-chunk keys
PATH_HRS_EPS = (1.25, 2.35, 2.45)     # 22b: 3 of the sweep's 23 ε
PATH_HRS_REPS, PATH_HRS_BOOT = HRS_SWEEP_REPS, 1_000
PATH_HRS_PARITY_REPS, PATH_HRS_PARITY_BOOT = 8, 16
PATH_SERVE_REQS, PATH_SERVE_CLIENTS, PATH_UNSAFE_REQS = 32, 8, 8
PATH_FED_PARTIES = [("p0", ["a"]), ("p1", ["b"]), ("p2", ["c"])]
PATH_STREAM_CHUNK = 512               # 22d: stream_load.py's --assoc-chunk


def rbg_path(card: str, label: str, fn) -> tuple:
    """``fn()`` with the rbg_bits and K1 launch counts set to 0 just before
    and read just after: raises unless rbg_bits launched and K1 did not.
    Returns (result, rbg_bits launches, seconds)."""
    from dpcorr_torch.ops import fused_ni, rbg

    reset_launches()
    rbg.KERNEL_LAUNCHES["rbg_bits"] = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = rbg.KERNEL_LAUNCHES["rbg_bits"]
    k1 = dict(fused_ni.KERNEL_LAUNCHES)
    print(f"[{card}] {label}: {seconds:.1f} s; launches rbg_bits "
          f"{launches}, K1 {k1}", flush=True)
    if not launches or any(k1.values()):
        raise RuntimeError(f"{label}: rbg_bits launched {launches} times "
                           f"and K1 {k1}; the path must launch rbg_bits "
                           f"and not K1")
    return out, launches, seconds


def _same_keys(label: str, host, device_keys) -> None:
    got = torch.as_tensor(host).reshape(-1, 4).numpy()
    want = device_keys.cpu().numpy().reshape(-1, 4)
    if not np.array_equal(got, want):
        bad = int(np.flatnonzero(~(got == want).all(1))[0])
        raise RuntimeError(f"22a {label}: host key {got[bad].tolist()} "
                           f"against the card's {want[bad].tolist()}")


def rbg_host_keys(card: str) -> dict:
    """Phase 22a: four-word host chains (``rng.fold_in_words``) bit-equal to
    ``rng.fold_in`` on the card, under rbg and unsafe_rbg: 2¹⁰ data values
    (0, 2³¹, 2³² − 1 among them) on the master key, serve's pinned and
    boot chains, the stream's window key and per-chunk keys; then the
    bits drawn from the host keys and from the card's, equal."""
    from dpcorr_torch.serve import pinned_request_key
    from dpcorr_torch.serve.server import (
        boot_request_key,
        request_digest_words,
    )
    from dpcorr_torch.stream import sketch
    from dpcorr_torch.utils import rng

    data = [0, 1, 2**31 - 1, 2**31, 2**32 - 1] + np.random.default_rng(
        22).integers(0, 2**32, PATH_FOLDS - 5).tolist()
    reqs = serve_requests("int_subg", 4, 1000, 22_000_000)
    out = {}
    for impl in ("rbg", "unsafe_rbg"):
        with _prng_impl(impl):
            host_master = rng.master_key(rng.MASTER_SEED)
            # dpcorr-lint: ignore[sync-in-loop] — a host tensor: no device sync
            words = tuple(host_master.tolist())
            master = host_master.cuda()
            t0 = time.perf_counter()
            # dpcorr-lint: ignore[rng-raw-api] — the host chain under test
            host = [rng.fold_in_words(words, d) for d in data]
            fold_us = (time.perf_counter() - t0) / len(data) * 1e6
            chains = [(torch.tensor(host), rng.design_key(
                master, torch.tensor(data, device="cuda")))]
            for r in reqs:
                k = rng.design_key(rng.stream(master, "serve/pinned"), r.seed)
                for w in request_digest_words(r):
                    k = rng.design_key(k, w)
                chains.append((pinned_request_key(host_master, r, r.seed),
                               k))
            boot = rng.design_key(rng.design_key(
                rng.stream(master, "serve/boot"), 12345), 77)
            chains.append((boot_request_key(host_master, 12345, 77), boot))
            host_w = sketch.window_key(host_master, "0-2000")
            wkey = rng.stream(master, "stream/0-2000")
            chains.append((host_w, wkey))
            # dpcorr-lint: ignore[sync-in-loop] — a host tensor: no device sync
            base = tuple(rng.stream(rng.stream(host_w, "int_sign/est"),
                                    "int_sign/flips").tolist())
            flips = rng.stream(rng.stream(wkey, "int_sign/est"),
                               "int_sign/flips")
            idx = torch.arange(PATH_CHAIN_CHUNKS, device="cuda")
            # dpcorr-lint: ignore[rng-raw-api] — the stream's per-chunk host keys, under test
            chunk_keys = [rng.fold_in_words(base, c)
                          for c in range(PATH_CHAIN_CHUNKS)]
            chains.append((torch.tensor(chunk_keys),
                           rng.chunk_key(flips, idx)))
            for j, (h, d) in enumerate(chains):
                _same_keys(f"{impl} chain {j}", h, d)
            host_keys = torch.cat([h.reshape(-1, 4) for h, _ in chains])
            dev_keys = torch.cat([d.reshape(-1, 4) for _, d in chains])
            bits_host = rng.random_bits(host_keys.cuda(), (1024,))
            bits_dev = rng.random_bits(dev_keys, (1024,))
            if not torch.equal(bits_host, bits_dev):
                raise RuntimeError(f"22a {impl}: bits from the host keys "
                                   f"differ from the card's")
        out[impl] = {"folds": len(data), "chains": len(chains),
                     "chunk_keys": PATH_CHAIN_CHUNKS,
                     "host_fold_us": fold_us}
    print(f"[{card}] 22a host keys bit-equal to the card's fold_in: "
          f"{json.dumps(out)}", flush=True)
    return out


def _point_diff(card_pt, cpu_pt) -> tuple:
    """Largest |card − CPU| on ρ̂ and the CI ends, largest relative gap on
    the λ/geometry block, and whether k and m are equal."""
    ci = aux = 0.0
    geometry = True
    for meth in ("ni", "int_"):
        got, want = getattr(card_pt, meth), getattr(cpu_pt, meth)
        if set(got) != set(want):
            raise RuntimeError(f"22b {meth}: fields {set(got)} != "
                               f"{set(want)}")
        ci = max(ci, *(abs(got[f] - want[f])
                       for f in ("rho_hat", "ci_low", "ci_high")))
        aux = max(aux, *(abs(got[f] / want[f] - 1.0) for f in want
                         if f not in ("rho_hat", "ci_low", "ci_high")
                         and want[f]), 0.0)
        geometry &= all(got[f] == want[f] for f in ("k", "m") if f in want)
    return ci, aux, geometry


def rbg_hrs(card: str, cols) -> dict:
    """Phase 22b: HRS at the panel's shape on rbg keys (point estimates,
    the sweep cut to 3 ε × 200 × 2, the bootstrap cut to 1,000), card
    against CPU within 1e-5 on the rows compared, phase 10's gates; then
    the point estimates on unsafe_rbg."""
    from dpcorr_torch import hrs

    out = {}
    for impl in ("rbg", "unsafe_rbg"):
        with _prng_impl(impl):
            card_pt = hrs.point_estimates(cols=cols)
            ci, aux, geometry = _point_diff(
                card_pt, hrs.point_estimates(cols=cols, device="cpu"))
            row = {"point_ci_diff": ci, "point_aux_rel": aux,
                   "ni": card_pt.ni["rho_hat"],
                   "int": card_pt.int_["rho_hat"],
                   "rho_np": card_pt.std.rho_np}
            if ci > 1e-5 or aux > 1e-5 or not geometry:
                raise RuntimeError(f"22b {impl} point estimates: card and "
                                   f"CPU differ by {ci} (CI), {aux} (aux), "
                                   f"geometry equal {geometry}")
            if impl == "rbg":
                sweep = hrs.eps_sweep(cols=cols, eps_grid=PATH_HRS_EPS,
                                      reps=PATH_HRS_REPS)
                boot = hrs.bootstrap(cols=cols, reps=PATH_HRS_BOOT)
                first = sweep.runs["rep"] <= PATH_HRS_PARITY_REPS
                cpu_sweep = hrs.eps_sweep(cols=cols, eps_grid=PATH_HRS_EPS,
                                          reps=PATH_HRS_PARITY_REPS,
                                          device="cpu")
                cpu_boot = hrs.bootstrap(cols=cols,
                                         reps=PATH_HRS_PARITY_BOOT,
                                         device="cpu")
                row["sweep_share"] = rows_within(
                    {f: v[first] for f, v in sweep.runs.items()},
                    cpu_sweep.runs, hrs.SWEEP_FIELDS)
                row["boot_share"] = rows_within(
                    {f: v[:PATH_HRS_PARITY_BOOT]
                     for f, v in boot.runs.items()},
                    cpu_boot.runs, hrs.BOOT_FIELDS)
                row["boot_summary"] = boot.summary
                if row["sweep_share"] < 0.99 or row["boot_share"] < 0.99:
                    raise RuntimeError(f"22b rbg: card and CPU differ on "
                                       f"the sweep ({row['sweep_share']}) "
                                       f"or the bootstrap "
                                       f"({row['boot_share']})")
                hrs_gates(card, sweep, boot, "22b rbg")
        out[impl] = row
    print(f"[{card}] 22b HRS at n = {HRS_COMPLETE}: {json.dumps(out)}",
          flush=True)
    return out


def rbg_serving(card: str) -> dict:
    """Phase 22c: ``DpcorrServer`` on rbg keys, 32 requests at n = 10⁴
    through the exact engine and 32 through the vector engine, 8 client
    threads each (exact bit-equal to the direct call, vector within its
    contract, ε charged once per request); 8 exact requests on
    unsafe_rbg; the host's key µs per request under each impl."""
    from dpcorr_torch.obs.audit import AuditTrail
    from dpcorr_torch.serve import (
        DpcorrServer,
        InProcessClient,
        pinned_request_key,
    )
    from dpcorr_torch.utils import rng

    per = PATH_SERVE_REQS // len(SERVE_FAMILIES)
    reqs = {mode: [r for j, fam in enumerate(SERVE_FAMILIES)
                   for r in serve_requests(fam, per, SERVE_N,
                                           seed0 + 100_000 * j)]
            for mode, seed0 in (("exact", 30_000_000),
                                ("vector", 31_000_000))}
    key_us = {impl: [] for impl in ("threefry2x32", "rbg", "unsafe_rbg")}
    for _turn in range(3):  # the first turn warms; the least of two kept
        for impl, times in key_us.items():
            with _prng_impl(impl):
                master = rng.master_key(rng.MASTER_SEED)
                t0 = time.perf_counter()
                for r in reqs["exact"]:
                    pinned_request_key(master, r, r.seed)
                times.append((time.perf_counter() - t0)
                             / len(reqs["exact"]) * 1e6)
    key_us = {impl: min(times[1:]) for impl, times in key_us.items()}
    print(f"[{card}] 22c request-key derivation on the host, µs per "
          f"admission at n = {SERVE_N} (SHA-256 of the request and ten "
          f"fold_ins in Python ints; least of two warm turns): "
          f"{json.dumps(key_us)}", flush=True)
    out = {"key_us": key_us}
    for impl, mode, batch in (("rbg", "exact", reqs["exact"]),
                              ("rbg", "vector", reqs["vector"]),
                              ("unsafe_rbg", "exact", reqs["exact"][
                                  ::PATH_SERVE_REQS // PATH_UNSAFE_REQS])):
        label = f"[{card}] 22c {impl} {mode} engine"
        with _prng_impl(impl):
            trail = AuditTrail()
            srv = DpcorrServer(budget=1e12, max_batch=SERVE_MAX_BATCH,
                               max_delay_s=SERVE_MAX_DELAY_S,
                               batch_mode=mode, audit=trail, device="cuda")
            try:
                got, lat, dt = drive(InProcessClient(srv), batch,
                                     PATH_SERVE_CLIENTS)
                ledger_matches(label, srv, batch, trail.events())
            finally:
                srv.close()
            want = direct_answers(batch, "cuda")
        line = load_line(f"{label}, {len(batch)} requests, "
                         f"{PATH_SERVE_CLIENTS} clients", lat, dt)
        if mode == "exact":
            bit_equal(label, got, want)
        else:
            line["contract"] = vector_contract(label, got, want)
        out[f"{impl} {mode}"] = line
    return out


def rbg_stream(card: str, xy: np.ndarray) -> dict:
    """Phase 22d: one window per family on rbg keys at n = 19,433 (the HRS
    pair) and stream_load.py's ε and associativity chunk (512 rows), one
    on unsafe_rbg: two partitions
    byte-equal to the monolith on the card, the card within phase 14's
    tolerance of the CPU (a normalised sign family's CPU release taken
    from the card's moments when the signs follow their last bits)."""
    from dpcorr_torch.perf_stream import STREAM_EPS, STREAM_SEED
    from dpcorr_torch.stream import sketch
    from dpcorr_torch.utils import rng

    out = {}
    for impl, families in (("rbg", SERVE_FAMILIES),
                           ("unsafe_rbg", ("ni_sign",))):
        with _prng_impl(impl):
            wkey = sketch.window_key(rng.master_key(STREAM_SEED), "0-2000")
            for family in families:
                params = sketch.ReleaseParams(family, STREAM_EPS, STREAM_EPS,
                                              target_chunk=PATH_STREAM_CHUNK)
                card_rel = sketch.release_window(xy, params, wkey,
                                                 device="cuda")
                ref = json.dumps(card_rel, sort_keys=True)
                ids = list(range(sketch.grid_for(params, len(xy)).n_chunks))
                for shards in ([ids[0::2], ids[1::2]],
                               [[c] for c in reversed(ids)]):
                    got = json.dumps(sketch.release_window(
                        xy, params, wkey, shards=shards, device="cuda"),
                        sort_keys=True)
                    if got != ref:
                        raise RuntimeError(f"22d {impl} {family}: a "
                                           f"partition released {got}, the "
                                           f"monolith {ref}")
                cpu_rel = sketch.release_window(xy, params, wkey,
                                                device="cpu")
                g, w, diff, within = _release_diff(card_rel, cpu_rel, family)
                # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
                row = {"card": g.tolist(), "cpu": w.tolist(),
                       "max_abs_diff": diff, "chunks": len(ids)}
                if not within and params.needs_moments \
                        and family.endswith("sign"):
                    mo_card, _ = _staged_release(xy, params, wkey, "cuda")
                    _mo, same = _staged_release(xy, params, wkey, "cpu",
                                                moments=mo_card)
                    within = _release_diff(card_rel, same, family)[3]
                    row["from_card_moments"] = within
                if not within:
                    raise RuntimeError(f"22d {impl} {family}: card {g} "
                                       f"against CPU {w}, beyond phase "
                                       f"14's tolerance")
                out[f"{impl} {family}"] = row
    print(f"[{card}] 22d stream windows at n = {len(xy)}, partitions "
          f"byte-equal to the monolith: {json.dumps(out)}", flush=True)
    return out


def rbg_protocol(card: str, x, y) -> dict:
    """Phase 22e: on rbg keys a replay session per family on the HRS pair,
    each bit-equal to the direct call on the card, one hardened session,
    and a federation plan of 3 columns whose exact finisher gives every
    cell its independent session's bits; one replay session on
    unsafe_rbg."""
    from dpcorr_torch.protocol import ProtocolSpec, run_inproc
    from dpcorr_torch.protocol.federation import run_federation_inproc
    from dpcorr_torch.protocol.matrix import FederationPlan

    eps = PROTO_EPS[0]
    out = {}
    for impl, families in (("rbg", SERVE_FAMILIES),
                           ("unsafe_rbg", ("int_subg",))):
        with _prng_impl(impl):
            for family in families:
                spec = ProtocolSpec(family=family, n=PROTO_N, eps1=eps[0],
                                    eps2=eps[1], seed=PROTO_SEED)
                got = session_bits(run_inproc(spec, x, y))
                want = direct_bits(family, eps, x, y, "cuda")
                if got != want:
                    raise RuntimeError(f"22e {impl} {family}: session "
                                       f"{got}, the direct call {want}")
                out[f"{impl} {family}"] = list(got)
    with _prng_impl("rbg"):
        hard = session_bits(run_inproc(ProtocolSpec(
            family="ni_subg", n=PROTO_N, eps1=eps[0], eps2=eps[1],
            seed=PROTO_SEED, noise_mode="hardened"), x, y))
        if not np.isfinite(hard).all() or hard[0] == out["rbg ni_subg"][0]:
            raise RuntimeError(f"22e hardened: {hard} against replay's "
                               f"{out['rbg ni_subg']}")
        out["rbg ni_subg hardened"] = list(hard)
        data = {"a": x, "b": y, "c": _fed_data(x, y)["c"]}
        plan = FederationPlan(family="int_subg", n=PROTO_N, eps=1.0,
                              parties=PATH_FED_PARTIES, seed=PROTO_SEED)
        cells = _cells(run_federation_inproc(plan, data))
        for i, j in plan.cells():
            ref = run_inproc(plan.cell_spec(i, j), data[plan.label(i)],
                             data[plan.label(j)])["x"]
            got = cells[f"{i},{j}"]
            if (got["rho_hat"], got["ci_low"], got["ci_high"]) != (
                    ref.rho_hat, ref.ci_low, ref.ci_high):
                raise RuntimeError(f"22e federation cell {i},{j}: {got}, "
                                   f"its two-party run gives {ref}")
        out["rbg federation cells"] = len(cells)
    print(f"[{card}] 22e protocol and federation: {json.dumps(out)}",
          flush=True)
    return out


def rbg_paths_phase(card: str, cols, x, y) -> dict:
    """Phase 22: the remaining paths on the rbg-family key-trees, each
    sub-phase in :func:`rbg_path`."""
    from dpcorr_torch.perf_stream import hrs_pair

    out, path_launches = {}, {}
    for label, name, fn in (
            ("22a", "host_keys", lambda: rbg_host_keys(card)),
            ("22b", "hrs", lambda: rbg_hrs(card, cols)),
            ("22c", "serve", lambda: rbg_serving(card)),
            ("22d", "stream", lambda: rbg_stream(card, hrs_pair(cols))),
            ("22e", "protocol", lambda: rbg_protocol(card, x, y))):
        out[label], path_launches[name], out[label + " s"] = rbg_path(
            card, label, fn)
    out["path_launches"] = path_launches
    return out


# ------------------------------------------------------------ phase 23 ----
THREEFRY_KEYS = 1 << 14        # 23: the unfused block's keys
THREEFRY_WORDS = 2 * N         # words a replication draws for its data
THREEFRY_FOLDS = FUSED_BLOCK * FUSED_BLOCKS  # the fused path's rep keys
#: 23: a chunk draw of the stress study (``subg.stream_n1e6``): 512
#: resident replications × an n-chunk of 65,536 rows
STRESS_KEYS, STRESS_WORDS = 512, 1 << 16
#: int32 operations of the definition that only the integer ALU runs:
#: the 20 rotations and 20 xors of the rounds, and bits' output xor (the
#: uniform's map adds a shift and an or, left out of its bound)
THREEFRY_ALU_OPS = {"threefry_bits": 41, "threefry_hash": 40,
                    "threefry_uniform": 41}
#: (minval, maxval) of the timed uniform draws: the bounded factor's
#: U, E1, E2 at the stress shape, ``normal``'s at the unfused one
STRESS_BOUNDS = (-1.0, 1.0)
NORMAL_BOUNDS = (float(np.nextafter(np.float32(-1), np.float32(0))), 1.0)


def threefry_cases():
    """The main path's operands on the card, as ``{label: (entry, kernel
    call, plain call, words, bytes moved)}``: 2¹⁴ replication keys × 2·10⁴
    words for bits and for ``normal``'s uniforms (the unfused block's
    draw), 512 keys × 65,536 words for bits and the bounded factor's
    uniforms (a stress chunk draw), and the master key's words over 2²⁰
    replication indices for the hash (``rep_keys`` of the fused path)."""
    from dpcorr_torch.ops import threefry
    from dpcorr_torch.utils import rng

    key = rng.master_key(device="cuda")
    keys = rng.rep_keys(key, THREEFRY_KEYS).contiguous()
    stress = rng.rep_keys(rng.design_key(key, 24), STRESS_KEYS).contiguous()
    hash_ops = (key[0], key[1], 0, torch.arange(THREEFRY_FOLDS,
                                                device="cuda"))
    words = THREEFRY_KEYS * THREEFRY_WORDS
    stress_words = STRESS_KEYS * STRESS_WORDS

    def rows(entry, k, n, *bounds):
        kernel = getattr(threefry, entry)
        plain = getattr(threefry, entry + "_plain")
        return lambda: kernel(k, n, *bounds), lambda: plain(k, n, *bounds)

    return {
        "threefry_bits": (
            "threefry_bits", *rows("threefry_bits", keys, THREEFRY_WORDS),
            words, THREEFRY_KEYS * 16 + words * 8),
        "threefry_hash": (
            "threefry_hash", lambda: threefry.threefry_hash(*hash_ops),
            lambda: threefry.threefry_hash_plain(*hash_ops),
            THREEFRY_FOLDS, THREEFRY_FOLDS * (8 + 2 * 8)),
        "threefry_uniform": (
            "threefry_uniform",
            *rows("threefry_uniform", stress, STRESS_WORDS, *STRESS_BOUNDS),
            stress_words, STRESS_KEYS * 16 + stress_words * 4),
        "threefry_uniform.unfused": (
            "threefry_uniform",
            *rows("threefry_uniform", keys, THREEFRY_WORDS, *NORMAL_BOUNDS),
            words, THREEFRY_KEYS * 16 + words * 4),
        "threefry_bits.stress": (
            "threefry_bits", *rows("threefry_bits", stress, STRESS_WORDS),
            stress_words, STRESS_KEYS * 16 + stress_words * 8),
    }
def threefry_against_plain(card: str) -> dict:
    """Phase 23a: every entry bit-equal to its plain version on the same
    card operands at each case's shape, each call counted as one
    launch."""
    from dpcorr_torch.ops import threefry

    cases = {}
    for label, (name, kernel, plain, _, _) in threefry_cases().items():
        before = threefry.KERNEL_LAUNCHES[name]
        got = kernel()
        launched = threefry.KERNEL_LAUNCHES[name] - before
        want = plain()
        if got.dtype == torch.float32:  # compare the f32 words' bits
            got, want = got.view(torch.int32), want.view(torch.int32)
        # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
        err = int((got != want).sum())
        del want
        print(f"[{card}] 23a {label} {tuple(got.shape)}: card bit-equal to "
              f"plain {err == 0}; launches {launched}", flush=True)
        if err or launched != 1:
            raise RuntimeError(f"23a: {label} disagrees with its plain "
                               f"version in {err} words, or launched "
                               f"{launched} times for one call")
        cases[label] = {"words_differing": err, "shape": list(got.shape)}
    return cases


def threefry_times(card: str) -> dict:
    """Phase 23b: each case's ms at 23a's shapes, its bound and its plain
    version's ms on the card."""
    from dpcorr_torch.ops import _build, threefry
    from dpcorr_torch.utils.device import time_cuda
    from dpcorr_torch.utils.roofline import CLOCK_HZ, HBM_BYTES_PER_S, SMS

    ptxas = _build.ptxas_report(_build.log_path("threefry").read_text())
    out = {"ptxas": list(ptxas.values())}
    before = dict(threefry.KERNEL_LAUNCHES)
    for label, (name, kernel, plain, words, bytes_) in (
            threefry_cases().items()):
        ms = time_cuda(kernel, 20)
        plain_ms = time_cuda(plain, 3)
        alu_ms = 1e3 * words * THREEFRY_ALU_OPS[name] / (64 * SMS * CLOCK_HZ)
        bytes_ms = 1e3 * bytes_ / HBM_BYTES_PER_S
        bound = max(alu_ms, bytes_ms)
        by = "operations" if alu_ms >= bytes_ms else "bytes"
        print(f"[{card}] 23b {label}, {words} words: {ms:.4f} ms "
              f"({bound / ms:.1%} of its bound {bound:.4f} ms by {by}; "
              f"ALU {alu_ms:.4f} ms, bytes {bytes_ms:.4f} ms); plain "
              f"version {plain_ms:.4f} ms", flush=True)
        out[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "alu_bound_ms": alu_ms,
                      "bytes_bound_ms": bytes_ms, "words": words}
    threefry.KERNEL_LAUNCHES.update(before)  # timing launches do not count
    print(f"[{card}] 23b threefry ptxas {ptxas}", flush=True)
    return out


def threefry_phase(card: str) -> dict:
    """Phase 23: the key-tree's threefry2x32 kernel."""
    out = {}
    for label, fn in (("23a", lambda: threefry_against_plain(card)),
                      ("23b", lambda: threefry_times(card))):
        t0 = time.perf_counter()
        out[label] = fn()
        out[label + " s"] = time.perf_counter() - t0
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from dpcorr_torch.grid import GridConfig
    from dpcorr_torch.ops import _build, fused_ni, ladder, rbg, threefry
    from dpcorr_torch.sim import (
        DETAIL_FIELDS,
        SimConfig,
        fused_ni_rep_fn,
        ni_rep_fn,
        run_sim_one,
        sim_detail_fused,
    )
    from dpcorr_torch.utils import rng
    from dpcorr_torch.utils.device import card_line, time_cuda
    from dpcorr_torch.utils.roofline import fused_pipe_ops, least_time_ms

    import tempfile

    t_start = time.perf_counter()
    work = tempfile.TemporaryDirectory(prefix="dpcorr_smoke_")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- 2. build every kernel from the checkout's sources
    t0 = time.perf_counter()
    libs = _build.build_all()
    each = {k: round(v, 2) for k, v in _build.BUILD_SECONDS.items()}
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s, each "
          f"{json.dumps(each)}", flush=True)
    log = _build.log_path("fused_ni")
    if not log.exists():
        raise RuntimeError(f"no compiler report beside this build of "
                           f"fused_ni ({log}); remove its library to rebuild")
    report = _build.ptxas_report(log.read_text())
    for flags, (regs, stack, st, ld) in sorted(report.items()):
        print(f"ptxas fused_ni [{mode_label(flags)}]: {regs} registers, "
              f"{stack} bytes stack frame, {st} bytes spill stores, {ld} "
              f"bytes spill loads", flush=True)
    if len(report) != 48:
        raise RuntimeError(f"ptxas reported {len(report)} fused_ni "
                           f"variants, expected 48")
    if any(report[MAIN_VARIANT][2:]):
        raise RuntimeError(f"the main-path variant spills: "
                           f"{report[MAIN_VARIANT]}")

    # ---- 3. kernel against its plain version (these launches do not count)
    worst_err = compare_kernel_with_plain()

    # ---- 4-5. the main path, unfused then fused: every launch count (K1's,
    # the ladder's and the key-tree's) is set to 0 just before and read
    # just after
    for counts in (fused_ni.KERNEL_LAUNCHES, ladder.KERNEL_LAUNCHES,
                   rbg.KERNEL_LAUNCHES, threefry.KERNEL_LAUNCHES,
                   rng.UNIFORM_CALLS):
        for name in counts:
            counts[name] = 0
    key = rng.master_key(device="cuda")
    unfused = run_pipeline(ni_rep_fn(N, RHO, *EPS, ALPHA), 1 << 14, 1 << 11,
                           UNFUSED_REPS >> 14, key)
    print(f"[{card}] unfused pipeline: {json.dumps(unfused)}", flush=True)

    fused = run_pipeline(fused_ni_rep_fn(N, RHO, *EPS, ALPHA), FUSED_BLOCK,
                         FUSED_BLOCK, FUSED_BLOCKS, key)
    keys = rng.rep_keys(rng.design_key(key, 777), DETAIL_REPS)
    t0 = time.perf_counter()
    detail = sim_detail_fused(rng.kernel_seeds(keys).contiguous(), RHO, N,
                              *EPS, alpha=ALPHA)
    torch.cuda.synchronize()
    detail_s = time.perf_counter() - t0
    launches = dict(fused_ni.KERNEL_LAUNCHES)
    ladder_main = dict(ladder.KERNEL_LAUNCHES)
    rbg_threefry = dict(rbg.KERNEL_LAUNCHES)
    tf_main = dict(threefry.KERNEL_LAUNCHES)
    uniform_main = dict(rng.UNIFORM_CALLS)
    print(f"[{card}] fused pipeline: {json.dumps(fused)}", flush=True)
    # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the values are needed on the host
    d = {f: v.double().mean().item() for f, v in zip(DETAIL_FIELDS, detail)}
    print(f"[{card}] sim_detail_fused {DETAIL_REPS} reps in {detail_s:.3f} s:"
          f" {json.dumps(d)}", flush=True)
    print(f"launches in the main path's run: {launches}, the ladder "
          f"{ladder_main}, rbg_bits {rbg_threefry}, threefry {tf_main}; "
          f"uniform calls {uniform_main}", flush=True)
    if not (tf_main["threefry_hash"] and tf_main["threefry_uniform"]):
        raise RuntimeError(f"the threefry main path launched the threefry "
                           f"kernel {tf_main} times: its folds and its "
                           f"uniforms must run there")
    if uniform_main["ops"] or not uniform_main["kernel"]:
        raise RuntimeError(f"the threefry main path's uniforms took the "
                           f"paths {uniform_main}: each must launch the "
                           f"uniform entry")
    if rbg_threefry["rbg_bits"]:
        raise RuntimeError(f"the threefry main path launched rbg_bits "
                           f"{rbg_threefry} times")
    if ladder_main["fused_ni_ladder"]:
        raise RuntimeError(f"the main path launched the stage ladder "
                           f"{ladder_main} times: it is a diagnostic")

    # ---- 6. gates
    for field in DETAIL_FIELDS:
        col = dict(zip(DETAIL_FIELDS, detail))[field]
        if tuple(col.shape) != (DETAIL_REPS,) or not torch.isfinite(col).all():
            raise RuntimeError(f"sim_detail_fused {field}: bad values")
    for label, cov in (("unfused", unfused["coverage"]),
                       ("fused", fused["coverage"]),
                       ("fused NI detail", d["ni_cover"]),
                       ("fused INT detail", d["int_cover"])):
        if not 0.90 <= cov <= 0.99:
            raise RuntimeError(f"{label} coverage {cov} outside [0.90, 0.99]")
    for metric in ("mse", "ci_length"):
        rel = abs(fused[metric] / unfused[metric] - 1.0)
        print(f"fused/unfused {metric}: relative difference {rel:.5f}",
              flush=True)
        if rel > 0.05:
            raise RuntimeError(f"fused {metric} differs from unfused by "
                               f"{rel:.4f} > 0.05")
    if abs(fused["coverage"] - unfused["coverage"]) > 0.01:
        raise RuntimeError("fused and unfused coverage differ by > 0.01")
    ref = run_sim_one(SimConfig(n=N, rho=RHO, eps1=EPS[0], eps2=EPS[1],
                                b=INT_REF_REPS, alpha=ALPHA,
                                chunk_size=1 << 11)).summary["INT"]
    print(f"[{card}] unfused run_sim_one INT ({INT_REF_REPS} reps): "
          f"{json.dumps(ref)}", flush=True)
    if abs(d["int_cover"] - ref["coverage"]) > 0.02:
        raise RuntimeError("fused INT coverage differs from unfused by > 0.02")
    if abs(d["int_ci_len"] / ref["ci_length"] - 1.0) > 0.05:
        raise RuntimeError("fused INT ci_length differs from unfused by > 5%")
    if abs(d["int_se2"] / ref["mse"] - 1.0) > 0.15:
        raise RuntimeError("fused INT mse differs from unfused by > 15%")
    if launches["fused_ni"] <= 0:
        raise RuntimeError("the main path never launched the fused kernel")

    # ---- 7. times at the main path's launch shape
    b = FUSED_BLOCK
    seeds = rng.kernel_seeds(rng.rep_keys(key, b)).contiguous()
    rho_b = torch.full((b,), RHO, device="cuda")
    ms = time_cuda(lambda: fused_ni.fused_ni_sums(seeds, rho_b, N, *EPS), 20)
    int_ms = time_cuda(lambda: fused_ni.fused_ni_sums(
        seeds, rho_b, N, *EPS, compute_int=True), 10)
    rows = fused_ni.n_uniform_rows(N, *EPS)
    # dpcorr-lint: ignore[rng-raw-api] — timing uniforms for the external mode, not DP noise
    u = torch.rand(b, rows, 128, device="cuda") * (1 - 2e-7) + 1e-7
    ext_ms = time_cuda(lambda: fused_ni.fused_ni_sums(seeds, rho_b, N, *EPS,
                                                      uniforms=u), 10)
    plain_ms = time_cuda(lambda: fused_ni.fused_ni_plain(
        seeds, rho_b, u, n=N, eps1=EPS[0], eps2=EPS[1]), 3)
    blocks = {ci: fused_ni.blocks_per_sm(N, *EPS, compute_int=ci)
              for ci in (False, True)}
    print(f"blocks resident per SM at n={N}: NI {blocks[False]}, NI+INT "
          f"{blocks[True]}", flush=True)
    bounds = {}
    for label, ci, philox, bytes_ in (
            ("in-kernel NI", False, True, b * (8 + 4 + 12)),
            ("in-kernel NI+INT", True, True, b * (8 + 4 + 12)),
            ("external NI", False, False, u.numel() * 4 + b * 24)):
        ops = fused_pipe_ops(N, EPS, ci, philox)
        times = least_time_ms(ops, b, bytes_)
        by = max(times, key=times.get)
        bounds[label] = (times[by], by, times["issue"])
        print(f"[{card}] bound, {label}, B={b}, n={N}: operations per "
              f"replication by pipe {json.dumps(ops)}; least ms "
              f"{json.dumps({p: round(t, 4) for p, t in times.items()})}; "
              f"bound {times[by]:.4f} ms by {by}", flush=True)
    bound_ms, bound_pipe, issue_ms = bounds["in-kernel NI"]
    print(f"[{card}] fused_ni in-kernel mode, B={b}, n={N}: {ms:.4f} ms "
          f"({bound_ms / ms:.1%} of its bound {bound_ms:.4f} ms by "
          f"{bound_pipe}; {issue_ms / ms:.1%} of the issue bound "
          f"{issue_ms:.4f} ms); NI+INT {int_ms:.4f} ms; external mode "
          f"{ext_ms:.4f} ms ({bounds['external NI'][0] / ext_ms:.1%} of "
          f"{bounds['external NI'][0]:.4f} ms by "
          f"{bounds['external NI'][1]}); plain version {plain_ms:.4f} ms",
          flush=True)

    # ---- 8. the sub-Gaussian and streaming paths, each driven with the
    # launch counts set to 0 just before it and read just after
    t0 = time.perf_counter()
    reset_launches()
    card_against_cpu(card)
    read_launches("card-against-CPU")
    reset_launches()
    accepted = acceptance_points(card)
    read_launches("subG acceptance")
    reset_launches()
    full_width(card)
    read_launches("subG full-width")
    reset_launches()
    streaming(card, accepted["subg_factor det"]["INT"])
    read_launches("streaming")
    print(f"sub-Gaussian and streaming phases: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 9. the design grid and the acceptance campaign, each part driven
    # with the launch counts set to 0 just before it and read just after
    t9 = time.perf_counter()
    parts = {}
    t0 = time.perf_counter()
    v1 = v1_grid_arms(card)
    grid_launches = v1["arms"]["auto"][-1]["launches"]
    parts["9a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    buckets = grid_bucket_times(card)
    parts["bucket times"] = time.perf_counter() - t0
    for label, part, fn in (("9b", "card-against-CPU grid bucket",
                             lambda: grid_card_against_cpu(card)),
                            ("9c", "subG grid", lambda: subg_grid_arms(card)),
                            ("9d", "grid resume",
                             lambda: grid_resume(card, v1["fused"])),
                            ("9e", "sign acceptance",
                             lambda: sign_acceptance(card))):
        t0 = time.perf_counter()
        reset_launches()
        fn()
        print(f"launches in the {part} run: "
              f"{dict(fused_ni.KERNEL_LAUNCHES)}", flush=True)
        parts[label] = time.perf_counter() - t0
    print(f"phase 9: {time.perf_counter() - t9:.1f} s "
          f"{json.dumps({k: round(v, 1) for k, v in parts.items()})}",
          flush=True)

    # ---- 10. the HRS real-data pipeline, driven with the launch counts
    # set to 0 just before it and read just after
    t10 = time.perf_counter()
    reset_launches()
    panel_path = f"{work.name}/hrs_long_panel.rds"
    cols = hrs_ingest(card, panel_path)
    sweep, boot = hrs_workloads(card, cols)
    hrs_card_against_cpu(card, cols, boot)
    hrs_gates(card, sweep, boot)
    read_launches("HRS")
    print(f"phase 10: {time.perf_counter() - t10:.1f} s", flush=True)

    # ---- 11. the R seam, the native reader and the fan-out, driven with
    # the launch counts set to 0 just before it and read just after; the
    # workers' launches come in their reports
    t11 = time.perf_counter()
    parts = {}
    t0 = time.perf_counter()
    seam_launches = r_seam(card, v1["fused"], panel_path, cols)
    parts["11a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_ingest(card, panel_path)
    parts["11b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fan = fanout(card, v1["fused"], v1["arms"]["auto"][-1]["seconds"],
                 work.name)
    sharded_summary(card)
    parts["11c"] = time.perf_counter() - t0
    report_tables(card, fan, sweep)
    worker_launches = sum(a["worker_launches"] for a in fan.values())
    phase11_launches = fused_ni.KERNEL_LAUNCHES["fused_ni"] + worker_launches
    print(f"launches in the R seam, reader and fan-out run: parent "
          f"{dict(fused_ni.KERNEL_LAUNCHES)}, workers {worker_launches}",
          flush=True)
    if seam_launches != V1_BUCKETS or phase11_launches != 3 * V1_BUCKETS:
        raise RuntimeError(f"phase 11: {phase11_launches} K1 launches, "
                           f"expected {3 * V1_BUCKETS}")
    print(f"phase 11: {time.perf_counter() - t11:.1f} s "
          f"{json.dumps({k: round(v, 1) for k, v in parts.items()})}",
          flush=True)

    # ---- 12. the serving stack, driven with the launch counts set to 0
    # just before it and read just after
    t12 = time.perf_counter()
    parts = {}
    reset_launches()
    t0 = time.perf_counter()
    parts["12a,c,e,g"], ni_reqs, ni_want = serving_exact(card, "cuda",
                                                        work.name)
    parts["12a,c,e,g s"] = time.perf_counter() - t0
    for label, fn in (
            ("12b", lambda: serving_vector(card, "cuda", ni_reqs, ni_want)),
            ("12d,e", lambda: serving_http(
                card, "cuda", work.name, ni_reqs[:SERVE_HTTP_REQS],
                ni_want[:SERVE_HTTP_REQS])),
            ("12f", lambda: serving_card_against_cpu(card))):
        t0 = time.perf_counter()
        parts[label] = fn()
        parts[label + " s"] = time.perf_counter() - t0
    serve_launches = fused_ni.KERNEL_LAUNCHES["fused_ni"]
    print(f"launches in the serving run: {dict(fused_ni.KERNEL_LAUNCHES)}",
          flush=True)
    if serve_launches:
        raise RuntimeError(f"phase 12: {serve_launches} K1 launches; the "
                           f"serving path has no kernel of its own")
    print(f"phase 12: {time.perf_counter() - t12:.1f} s "
          f"{json.dumps({k: round(v, 1) for k, v in parts.items() if k.endswith(' s')})}",
          flush=True)

    # ---- 13. the two-party protocol and the federation, driven with the
    # launch counts set to 0 just before it and read just after
    t13 = time.perf_counter()
    reset_launches()
    parts = protocol_phase(card, cols, work.name)
    protocol_launches = fused_ni.KERNEL_LAUNCHES["fused_ni"]
    print(f"launches in the protocol run: {dict(fused_ni.KERNEL_LAUNCHES)}",
          flush=True)
    if protocol_launches:
        raise RuntimeError(f"phase 13: {protocol_launches} K1 launches; the "
                           f"protocol path has no kernel of its own")
    seconds = {k: round(v, 1) for k, v in parts.items() if k.endswith(" s")}
    print(f"phase 13: {time.perf_counter() - t13:.1f} s "
          f"{json.dumps(seconds)}", flush=True)

    # ---- 14. the stream service and the per-user budget directory,
    # driven with the launch counts set to 0 just before it and read just
    # after
    t14 = time.perf_counter()
    reset_launches()
    parts = stream_phase(card, cols, work.name)
    stream_launches = fused_ni.KERNEL_LAUNCHES["fused_ni"]
    print(f"launches in the stream run: {dict(fused_ni.KERNEL_LAUNCHES)}",
          flush=True)
    if stream_launches:
        raise RuntimeError(f"phase 14: {stream_launches} K1 launches; the "
                           f"stream and directory paths have no kernel of "
                           f"their own")
    seconds = {k: round(v, 1) for k, v in parts.items() if k.endswith(" s")}
    print(f"phase 14: {time.perf_counter() - t14:.1f} s "
          f"{json.dumps(seconds)}", flush=True)

    # ---- 15. the serve fleet, the fleet telemetry plane and the chaos
    # sweep, driven with the launch counts set to 0 just before it and
    # read just after (the replicas' and parties' launches are their own
    # processes', on the serving and protocol paths phases 12-13 hold)
    t15 = time.perf_counter()
    reset_launches()
    parts = fleet_phase(card, work.name)
    fleet_launches = fused_ni.KERNEL_LAUNCHES["fused_ni"]
    print(f"launches in the fleet run (this process): "
          f"{dict(fused_ni.KERNEL_LAUNCHES)}", flush=True)
    if fleet_launches:
        raise RuntimeError(f"phase 15: {fleet_launches} K1 launches; the "
                           f"fleet and chaos paths have no kernel of their "
                           f"own")
    fa = parts["15a,b"]
    print(f"[{card}] 15e: qps(3)/qps(1) = {fa['qps_ratio']:.3f} "
          f"({fa['three']['req_per_s']:.1f} / {fa['one']['req_per_s']:.1f} "
          f"req/s; reported only: three replicas share one card)",
          flush=True)
    seconds = {k: round(v, 1) for k, v in parts.items() if k.endswith(" s")}
    print(f"[{card}] phase 15: {time.perf_counter() - t15:.1f} s "
          f"{json.dumps(seconds)}", flush=True)

    # ---- 16. the build-and-dispatch layer, each part reading the launch
    # count and the transfer counters around itself
    from dpcorr_torch.perf_stream import hrs_pair

    t16 = time.perf_counter()
    x, y = proto_columns(card, cols)
    parts = plan_phase(card, key, {"unfused": unfused, "fused": fused},
                       v1["fused"], x, y, hrs_pair(cols), work.name)
    plan_launches = {k: v["launches"] for k, v in parts["16a"].items()}
    plan_grid_launches = parts["16b"]["launches"]
    graph_replays = parts["16f"]["replays"]
    seconds = {k: round(v, 1) for k, v in parts.items() if k.endswith(" s")}
    print(f"[{card}] phase 16: {time.perf_counter() - t16:.1f} s "
          f"{json.dumps(seconds)}", flush=True)

    # ---- 17. the measuring layer, the K1 launch count zeroed before each
    # part and read after it
    t17 = time.perf_counter()
    parts = measuring_phase(card, key, {"unfused": unfused, "fused": fused},
                            v1["off"], bound_ms, work.name)
    seconds = {k: round(v, 1) for k, v in parts.items() if k.endswith(" s")}
    print(f"[{card}] phase 17: {time.perf_counter() - t17:.1f} s "
          f"{json.dumps(seconds)}", flush=True)
    bucket_ms = [v["ms"] for v in buckets.values()]

    # ---- 18. the operator's tools over services on the card, driven with
    # the launch counts set to 0 just before it and read just after
    t18 = time.perf_counter()
    reset_launches()
    obs_parts = obs_phase(card, work.name, x, y)
    obs_launches = fused_ni.KERNEL_LAUNCHES["fused_ni"]
    print(f"launches in the tools' run: {dict(fused_ni.KERNEL_LAUNCHES)}",
          flush=True)
    if obs_launches:
        raise RuntimeError(f"phase 18: {obs_launches} K1 launches; the "
                           f"tools and the services they watch have no "
                           f"kernel of their own")
    seconds = {k: round(v, 1) for k, v in obs_parts.items()
               if k.endswith(" s")}
    print(f"[{card}] phase 18: {time.perf_counter() - t18:.1f} s "
          f"{json.dumps(seconds)}", flush=True)

    # ---- 19. the lint and the lock witness over K1's main path, a serve
    # process and a chaos case, then fastnorm; the launch counts set to 0
    # just before and read just after (the witnessed grid's come in its
    # report)
    t19 = time.perf_counter()
    reset_launches()
    bisect_run = start_bisect(work.name)  # 20c, beside phase 19
    wit_parts = witness_phase(card, v1["fused"], work.name)
    wit_launches = wit_parts["grid"]["launches"]
    print(f"launches in the lint and witness run: this process "
          f"{dict(fused_ni.KERNEL_LAUNCHES)}, the witnessed grid "
          f"{wit_launches}", flush=True)
    if fused_ni.KERNEL_LAUNCHES["fused_ni"] or wit_launches != V1_BUCKETS:
        raise RuntimeError(f"phase 19: {wit_launches} K1 launches in the "
                           f"witnessed grid, expected {V1_BUCKETS}, and "
                           f"{fused_ni.KERNEL_LAUNCHES['fused_ni']} here")
    seconds = {k: round(v, 1) for k, v in wit_parts.items()
               if k.endswith(" s")}
    print(f"[{card}] phase 19: {time.perf_counter() - t19:.1f} s "
          f"{json.dumps(seconds)}", flush=True)

    # ---- 20. K1's stage ladder and K1 above its shared-memory cap; the
    # bisect's probes report their launches, 20e's grid arms read the
    # counts around themselves
    t20 = time.perf_counter()
    for name in ladder.KERNEL_LAUNCHES:
        ladder.KERNEL_LAUNCHES[name] = 0
    lad = ladder_phase(card, bisect_run, ms)
    work.cleanup()
    seconds = {k: round(v, 1) for k, v in lad.items() if k.endswith(" s")}
    print(f"[{card}] phase 20: {time.perf_counter() - t20:.1f} s "
          f"{json.dumps(seconds)}", flush=True)
    # ---- 21. the key-tree's rbg-family implementations: the rbg_bits
    # kernel against its plain version, the north star on rbg keys (the
    # launch counts set to 0 just before and read just after), paired
    # turns against threefry, the kernel's times
    t21 = time.perf_counter()
    rbg_parts = rbg_phase(card, fused["sums"])
    seconds = {k: round(v, 1) for k, v in rbg_parts.items()
               if k.endswith(" s")}
    print(f"[{card}] phase 21: {time.perf_counter() - t21:.1f} s "
          f"{json.dumps(seconds)}", flush=True)
    rbg_main = rbg_parts["21b"]["launches"]
    rbg_t = rbg_parts["21d"]

    # ---- 22. HRS, serving, the stream, the protocol and the federation on
    # the rbg-family key-trees, each sub-phase reading the rbg_bits and K1
    # launch counts around itself
    t22 = time.perf_counter()
    paths = rbg_paths_phase(card, cols, x, y)
    seconds = {k: round(v, 1) for k, v in paths.items() if k.endswith(" s")}
    print(f"[{card}] phase 22: {time.perf_counter() - t22:.1f} s "
          f"{json.dumps(seconds)}; rbg_bits launches per path "
          f"{json.dumps(paths['path_launches'])}", flush=True)

    # ---- 23. the key-tree's threefry2x32 kernel against its plain
    # version at the main path's shapes, and its times
    t23 = time.perf_counter()
    tf_parts = threefry_phase(card)
    seconds = {k: round(v, 1) for k, v in tf_parts.items()
               if k.endswith(" s")}
    print(f"[{card}] phase 23: {time.perf_counter() - t23:.1f} s "
          f"{json.dumps(seconds)}", flush=True)
    tf_t = tf_parts["23b"]

    levels = lad["20b"]
    for name, t in levels.items():
        t["ptxas"] = lad["20a ptxas"].get(name)
        t.update(lad["20a"].get(name, {}))
    top = levels["matmul"]
    regen_t = lad["20d times"]

    record = {"kernels": [{
        "name": "fused_ni",
        "route": "cuda",
        "source": "dpcorr_torch/csrc/fused_ni.cu",
        "replaces": "dpcorr/ops/pallas_ni.py:280",
        "launches": launches["fused_ni"] + phase11_launches + wit_launches,
        "main_path_launches": launches["fused_ni"],
        "r_seam_launches": seam_launches,
        "fanout_worker_launches": worker_launches,
        "max_abs_err": max(worst_err, *(v["max_abs_err"]
                                        for v in buckets.values())),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_pipe == "bytes" else "operations",
        "library_ms": None,
        "bound_pipe": bound_pipe,
        "issue_bound_ms": issue_ms,
        "batch": b,
        "blocks_per_sm": blocks[False],
        "ptxas_main": dict(zip(("registers", "stack", "spill_stores",
                                "spill_loads"), report[MAIN_VARIANT])),
        "int_ms": int_ms,
        "int_bound_ms": bounds["in-kernel NI+INT"][0],
        "external_ms": ext_ms,
        "external_bound_ms": bounds["external NI"][0],
        "grid_launches": grid_launches,
        "grid_bucket_reps": len(GridConfig().rho_grid) * GRID_B,
        "grid_bucket_ms_min": min(bucket_ms),
        "grid_bucket_ms_max": max(bucket_ms),
        "grid_bucket_ms_sum": sum(bucket_ms),
        "serve_launches": serve_launches,
        "protocol_launches": protocol_launches,
        "stream_launches": stream_launches,
        "fleet_launches": fleet_launches,
        "plan_pipeline_launches": plan_launches,
        "plan_grid_launches": plan_grid_launches,
        "graph_replays": graph_replays,
        "geometry_probe_launches": parts["17c"]["ni-sign-fused"]["launches"],
        "profiled_launches": parts["17e"]["launches"]["profiled"],
        "profiled_seconds": parts["17e"]["seconds"]["profiled"],
        "unprofiled_seconds": parts["17e"]["seconds"]["unprofiled"],
        "profiled_coarse_seconds":
            parts["17e"]["seconds"]["profiled_coarse"],
        "obs_launches": obs_launches,
        "witness_launches": wit_launches,
        "bisect_launches": lad["20c"]["launches"]["fused_ni"],
        "cap_grid_launches": lad["20e"]["launches"]["fused_ni"],
        "regen_launches": lad["20e"]["launches"]["fused_ni_regen"],
        "regen_max_abs_err": lad["20d"],
        "regen_forced_bit_equal_cases": lad["20d forced"],
        "regen_ms": {str(n): t["ms"] for n, t in regen_t.items()},
        "regen_bound_ms": {str(n): t["bound_ms"] for n, t in regen_t.items()},
        "regen_batch": {str(n): t["batch"] for n, t in regen_t.items()},
    }, {
        "name": "fused_ni_ladder",
        "route": "cuda",
        "source": "dpcorr_torch/csrc/fused_ni_ladder.cu",
        "replaces": "benchmarks/pallas_bisect.py:100",
        "launches": lad["20c"]["launches"]["fused_ni_ladder"],
        "main_path_launches": ladder_main["fused_ni_ladder"],
        "max_abs_err": max(v["max_abs_err"] for k, v in lad["20a"].items()
                           if k != "prng"),
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": "bytes" if top["bound_by"] == "bytes" else "operations",
        "library_ms": None,
        "batch": top["batch"],
        "levels": levels,
    }, {
        "name": "rbg_bits",
        "route": "cuda",
        "source": "dpcorr_torch/csrc/rbg_bits.cu",
        "replaces": "dpcorr/utils/rng.py:32 (lax.rng_bit_generator under "
                    "jax.random.bits on rbg-family keys; an XLA op)",
        "launches": rbg_main["rbg_bits"],
        "main_path_launches": rbg_main["rbg_bits"],
        "threefry_main_path_launches": rbg_threefry["rbg_bits"],
        "rbg_main_path_fused_ni_launches": rbg_main["fused_ni"],
        "max_abs_err": rbg_parts["21a"]["max_abs_err"],
        "ms": rbg_t["ms"],
        "plain_ms": rbg_t["plain_ms"],
        "bound_ms": rbg_t["bound_ms"],
        "bound_by": rbg_t["bound_by"],
        "library_ms": None,
        "int32_bound_ms": rbg_t["int32_bound_ms"],
        "shape": [RBG_TIMED_KEYS, RBG_WORDS],
        "ptxas": rbg_t["ptxas"],
        "turns_reps_per_s": rbg_parts["21c"]["reps_per_s"],
        "per_block": rbg_parts["21c"]["per_block"],
        "path_launches": paths["path_launches"],
    }, {
        "name": "threefry",
        "route": "cuda",
        "source": "dpcorr_torch/csrc/threefry.cu",
        "replaces": "dpcorr/utils/rng.py (threefry_2x32 under jax.random "
                    "on threefry2x32 keys; integer ops under XLA)",
        "launches": sum(tf_main.values()) + len(tf_parts["23a"]),
        "main_path_launches": sum(tf_main.values()),
        "main_path_launches_by_entry": tf_main,
        "words_differing": sum(v["words_differing"]
                               for v in tf_parts["23a"].values()),
        "ms": tf_t["threefry_bits"]["ms"],
        "plain_ms": tf_t["threefry_bits"]["plain_ms"],
        "bound_ms": tf_t["threefry_bits"]["bound_ms"],
        "bound_by": tf_t["threefry_bits"]["bound_by"],
        "library_ms": None,
        "shape": [THREEFRY_KEYS, THREEFRY_WORDS],
        "hash": {**tf_t["threefry_hash"], "library_ms": None},
        "uniform": {**tf_t["threefry_uniform"], "library_ms": None,
                    "shape": [STRESS_KEYS, STRESS_WORDS],
                    "unfused": tf_t["threefry_uniform.unfused"],
                    "bits_at_this_shape": tf_t["threefry_bits.stress"]},
        "main_path_uniform_calls": uniform_main,
        "ptxas": tf_t["ptxas"],
    }]}
    print(f"smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(record), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
