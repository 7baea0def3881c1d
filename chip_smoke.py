#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which exits non-zero when it fails:

1. print the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together);
3. hold every kernel against its plain PyTorch version on the card, at
   every shape its path launches it with (one micro-batch chunk), at 16
   events and at the 64-event calibration batch, with TF32 off; time
   kernel, plain version and, where one PyTorch call computes the same
   function, that library call (``torch.addmm`` + ``relu`` for
   ``fused_dense``; ``torch._int_mm``, the int8 product alone without
   the epilogue, for ``fused_dense_int8`` at the shapes it accepts;
   ``index_add_`` for ``edge_aggregate``'s sum and, over 0/1 masks,
   ``index_reduce_('mean')`` for its mean), checked once against the
   plain version before it is timed. ``fused_dense`` and
   ``edge_aggregate`` are held bitwise at every shape checked, the f32
   dense also on the inputs of ``kernels/f32_cases.py`` (K from 1 past
   its staging limit, row-strided x, N and M off every tile, with and
   without bias), with each tile's shared-memory plan against the
   library's own. The int8 pair (``fused_dense_int8``,
   ``gravnet_block_int8``) is held bitwise everywhere: at the main
   path's shapes, at the current detector's (its mixed deployment's
   calls, 32 hits, at one chunk, 16 and 64 events), at the bucketed
   mixed deployment's (its calls at buckets of 8, 16, 32, 64 and 128 hits,
   8 events a launch: phase 11's shapes, n = k = 8 at the smallest), the
   block also at one event of the main path's chunk, and on the inputs of
   ``kernels/int8_cases.py`` (exact distance ties, 32 and 50 hits, fewer
   valid hits than k, rows off the tile, K = 4 and N = 7 in both output
   forms, K past one staged slice, x quantized on the hard quotients of
   ``int8_cases.quotient_edges``). So is the f32 GravNet pair
   (``gravnet_block``, ``gravnet_aggregate``): at the fp and unfused
   paths' shapes (the block also at one event of its chunk), at the
   current detector's fp deployment (its calls, 32 hits, at one chunk,
   16 and 64 events), and on the inputs of ``kernels/f32_cases.py``
   (exact distance ties, 1 to 600 hits, fewer valid hits than k, a
   masked event, k past n, d_s 1 and 9, d_f 1 to 129, 1 to 64 events,
   the register cell and the shared-memory cell past it), with each
   shape's shared-memory plan against the library's own;
4. the main path, as ``python -m repro_torch.launch.serve
   --train-steps 0`` runs it: deploy the upgrade-width CaloClusterNet
   (random weights from a seed) at design point 3 under the **mixed**
   policy, at the P the design flow picks on the H100's cost model
   (``Requirements.platform="h100"``, serve's target of 1e5 events/s
   within 2 ms), calibrated on the card, serve 256 events through the
   in-order loop with every launch counter at 0, check that each of the
   5 int8 denses (``fused_dense_int8``) and 2 int8 blocks
   (``gravnet_block_int8``) launches once per P-chunk of its segment,
   and no f32 dense, block or aggregate launch, and that the heads and
   trigger decisions equal bitwise those of the same deployment with the
   plain versions substituted, calibration included; print events/s,
   decision latency p50/p99, trigger efficiency, the device's idle share
   and the host time per op type; then (4b) the default run: warm-train
   those weights on the card for 40 steps (``serve.warm_train``, the
   reference's condensation training, autograd through the plain ops;
   the loss must stay finite and fall), deploy the trained weights the
   same way and serve and check the same 256 events as above;
5. the other paths, each with the counters at 0 just before it: the fp
   policy at design point 3 (64 events; 5 ``fused_dense`` and 2
   ``gravnet_block`` per chunk), design point 1 under fp and design
   point 3 under mixed with ``fuse_int8=False`` (16 events each; both
   launch ``gravnet_aggregate``), each held against its plain versions;
6. the padding-free ragged path, as ``deploy(ragged=True)`` serves it:
   the upgrade-width CaloClusterNet at design point 3, fp, 8 bins of 128
   rows per launch, serving 128 events whose occupancy spreads over a
   quarter to three quarters of the readout (so bins hold 1–3 events),
   16 per call, with the counters at 0 just before: 2 ``knn_build``, 2
   ``knn_aggregate`` and the graph's ``fused_dense`` count per launch,
   no GravNet block or aggregate launch; heads and every CPS output
   bitwise equal to the plain-substituted deployment; real rows within
   the float32 row of the padded fp path on the same events, with the
   same trigger decisions; events/s and latency of ragged and padded in
   turns, and the idle share; then the same at design point 1 (16
   events, the kNN pair as graph ops). Phase 3 holds both kNN kernels
   against their plain versions, bitwise, at 1, 8 and 16 bins of this
   path, with segment ids from its real bin packing, and on the inputs
   of ``kernels/f32_cases.py`` (bins of 1–3 events, spent slots, an
   all-padding bin, coincident rows, exact ties, 40 to 600 rows, d_s 3
   and 12, d_f 22 and 129, indices outside [0, n), k 40), with their
   shared-memory plans against the library's own; it times each against
   the first design (each source's second path, the kernel it
   replaced) in turns at 1, 8 and 16 bins of packed events
   (``kernels/source_ab.py``), and prints where a CTA of each spends its
   time (``kernels/phase_split.py``);
7. the edge-based GNNs, as ``python -m repro_torch.launch.serve --model
   gatedgcn graphsage`` deploys them but at their published widths:
   GatedGCN 16 layers × 70 and GraphSAGE 2 layers × 128 (random weights
   from generator seeds 1 and 2) on the serve routes' graphs of 64 nodes
   and 256 edges, design point 3, fp. Each serves 64 events (graphs of
   seed 7, ``max(8, microbatch)`` per dispatch as the reference's
   service serves its GNN routes) with the counters at 0 just before:
   exactly 2 ``edge_aggregate`` per layer and chunk, the graph's
   ``fused_dense`` count, no other kernel; logits bitwise equal to the
   plain-substituted deployment on the card, and within the float32 row
   of the same deployment with ``device="cpu"``; events/s, latency and
   the idle share. The kernel calls of each path (graphs of seed 17) are
   held against their plain versions, bitwise (``edge_aggregate`` at one
   graph, the path's micro-batch and 16 graphs, the denses on the
   row-strided own-K views the executor gives them), and the device time
   of a chunk is printed: the two kernels' timed launches beside the
   library calls', and the profiled busy time; so is ``edge_aggregate``
   held on synthetic graphs of the routes' size with masked edges and
   destinations outside [0, N), for sum and mean, at d 16, 32, 70 and
   128 and 1, 8 and 16 graphs, and on the inputs of
   ``kernels/f32_cases.py`` (E from 1 to the largest a launch takes, one
   node taking every edge, every edge masked, every dst out of range, d
   1 to 129), with its shared-memory plans against the library's own.
   Then ``launch.serve.main`` serves
   ``--model ccn gatedgcn graphsage`` and every route must answer every
   event;
8. the ``attention`` op and the tuning layer: ``flash_attention`` (FMA
   code, so held to the float32 row of its plain version
   ``flash_attention_blocked_ref``, not to its bits) at the reference's
   LM prefill tuning cell (8, 512, 512, 64), its regression bench's
   (8, 1024, 1024, 64) and OLMo-1B's heads at 4096 tokens (16, 4096,
   4096, 128), causal; at (8, 512, 512, 64) not causal; the same four on
   bf16 q, k, v against the bfloat16 row; where the wrapper splits the
   kv tiles over CTAs, unsplit too; at S = 1000 padded to the blocks;
   and at every (bq, bk) that ``tuning/candidates.py`` keeps at (8, 512,
   512, 64); its shared memory plans must agree with the library's own;
   times beside ``F.scaled_dot_product_attention`` on the same inputs
   (its max |err| printed, the port never calls it). Then an
   ``attention`` graph (q, k, v denses of random weights from numpy
   seed 0 at scale 1/√64) deployed at design point 3, fp, ``batch=8``,
   n 512, d 64, serving 32 events with the counters at 0 just before:
   one ``flash_attention`` and one ``fused_dense`` per dense of the
   deployed graph (the fusion pass merges q, k and v into one) per
   micro-batch of 8, its output within the float32 row of the
   plain-substituted deployment and of ``device="cpu"``. Then
   ``autotune_graph`` over that deployment and
   over the main path's, a redeploy with the cache whose attention op
   binds the cached (bq, bk) and launches it, a ``save``/``load`` round
   trip and ``warm_from_cache`` of every entry; the tuner's row: the
   bound (bq, bk)'s device time is at most the default's (the tuner
   times on the card's clock); then ``serve.main`` with
   ``--tune --tuning-cache --train-steps 0`` and again on the saved
   cache alone, which binds every problem without searching;
9. the whole-pipeline compile: on eight paths (the served default
   warm-trained, fp, fp at design point 1, mixed with
   ``fuse_int8=False``, ragged, GatedGCN, GraphSAGE, attention) the
   captured deployment (one CUDA graph replay per chunk, per segment at
   design point 1, per launch on the ragged path) answers every output
   bitwise as its eager ``run_chunk`` loop does; in turns (captured,
   eager, eager, captured, captured, eager) the events/s, latency
   p50/p99 and host wall per chunk of both, and their medians; the idle
   share of both for the served default and GatedGCN, with a profiler
   cross-check that each replay runs the default's int8 denses and
   blocks once per P-chunk; and CPS alone on one chunk's heads, its
   device time captured and eager (``capture.json``). Every phase above
   serves through the captures too; the plain-substituted and the
   recording runs go through ``run_eager``. A path's launch counts are
   read from its counted run: its served events once more under
   torch.profiler, every counter at 0 just before, each kernel's runs
   on the card counted from the profiler's records (``counted``); the
   counters, which a replay adds to by what its capture recorded, must
   read the same, and the kernels line takes the profiler's counts;
10. the serving layer: ``serve.run`` (``python -m
    repro_torch.launch.serve``) through ``ShardedTriggerService``, each
    replica on a lane of its own (a CUDA stream, captures and pinned
    rings): (a) the default run (warm-trained mixed, design point 3, one
    replica, the streaming loop, 512 events), (b) ``--replicas 2`` under
    each policy, (c) ``--loop deadline``, (d) ``--model gatedgcn
    graphsage``, (f) ``--replicas 2 --inject-faults
    'fail:p=1.0,replica=1' --max-retries 2`` (0 client-visible
    failures; (b), (c) and (f) serve the default's random weights,
    ``--train-steps 0``: the service is under test, not the weights),
    and (e) a ``ragged=`` service over the ragged deployment,
    16 events a launch. Every event released once, in submission order,
    every output bitwise equal to ``serve_events`` on the same deployment
    (the plain captured loop, timed right after it), each lane captured
    before traffic and nothing during it; then a fresh service on the
    same deployment serves the events once more as its counted run (the
    profiler's kernel runs equal to the counters; on the mixed runs the
    int8 denses and blocks once per P-chunk of every launch that ran)
    and its idle share; events/s, p50/p99, the budget,
    batches and padded events beside the plain loop's and phase 9's
    (``service.json``). The kernel line's launches add these runs';
11. the rest of the serve entry point: (g) ``serve.run`` with
    ``--buckets 32 64 128 --bucket-microbatch 8`` (the warm-trained
    default, whose full events all take the largest bucket), checked as
    in phase 10; then a bucketed service on the same deployment over 512
    events of seed 7 spread over the buckets (``with_occupancy``): every
    event bitwise equal to the same ``BucketedPipeline`` in the plain
    captured loop and to its plain-substituted deployment, one lane a
    bucket captured before traffic only, the counted run's 5
    ``fused_dense_int8`` and 2 ``gravnet_block_int8`` per chunk, events/s,
    p50/p99 and the per-bucket rows beside the padded default's service on
    the same events (in turns, medians of 5); (h) ``serve.run`` with
    ``--monitor-port 0 --event-display PATH``: ``/snapshot`` counts the
    completed events, the snapshot's trigger rate is the released
    results', the display file parses, and events/s and p50/p99 with the
    monitor on and off in turns (medians of 5, with the taps' own host
    time and the garbage collector's runs; ``phase11.json``);
12. training on the card (``repro_torch.launch.train``, each step one
    CUDA graph): (a) the driver, ``train.run(["--arch",
    "caloclusternet", "--steps", "60", "--ckpt-every", "20",
    "--inject-failure-at", "30", ...])``: it must resume from checkpoint
    20 at step 30, leave checkpoints 20, 40 and 60 on disk (every leaf's
    crc32 verified on restore, 60 equal to the final state), and give
    finite losses; its loss on 1024 held-out events must fall (the
    per-batch means of the first and last 10 steps are printed: at 16
    events a batch they are noise); then twice without the failure, the
    step-60 parameters' largest difference against the interrupted run
    printed beside that between the two uninterrupted runs; (b)
    CaloClusterNet at full width (128 hits, d_hidden 64) at 1024 events
    a step of the upgrade generator through ``train.build_step``: 30
    captured steps (finite losses, the held-out loss falling), steps/s,
    events/s, TFLOP/s of the model's FLOPs, peak memory and the idle
    share under the profiler; 5 captured steps against eager ones, each
    from the eager run's state (loss, parameters and moments within the
    float32 row); one step's loss and gradients on the card against the
    CPU at 32 events (a batch whose kNN selections agree on both), within
    the float32 row; (c) GatedGCN 16 × 70 and GraphSAGE 2 × 128 on
    ``powerlaw_graph(2708, 10556, d_feat=1433)`` (full_graph_sm's size),
    20 captured ``gnn_common.train_step`` steps each, and GraphSAGE on
    minibatch_lg's sampled batches (``NeighborSampler`` fanout 15-10, 32
    groups of 32 seeds, one pass) from a graph of Reddit's 232,965 nodes
    with its edges cut to a mean in-degree of 10, 10 steps: losses
    finite, the loss on the graph (or a held-out sample) falling, steps/s,
    peak memory, one step's loss and gradients against the CPU within the
    float32 row (a gradient leaf outside it no further from float64 than
    twice the CPU's float32 error on that leaf, over up to three orders of
    the graph's nodes and edges, plus the row at the leaf's largest
    |value|); ``edge_aggregate`` bitwise against its plain version at
    every shape these steps launch it with (d 1433 and 602, E 10556, 480
    and 4800), and its launches from a counted run (one step of each: 2 ×
    16 + 2 + 3) join the kernel line's; ``training.json``;
13. the LM transformer and MIND recsys (``models/transformer.py``,
    ``models/recsys.py``; they reach no kernel of the port, and the
    phase fails if a launch counter moves): (a) every LM smoke config
    (olmo-1b, yi-9b, granite-34b, granite-moe-1b-a400m,
    llama4-maverick-400b-a17b) and MIND's on the card against the CPU,
    one set of weights drawn on the CPU and moved across, within the
    float32 row: forward (the MoE configs under einsum and scatter
    dispatch), ``loss_fn`` and its gradients, ``prefill``, eight
    ``decode_step``s with the f32 cache and with the int8 cache (its
    entries equal but for flips by one where the CPU's quotient lies
    within ``HALF_TOL`` of a half; the logits held to the bfloat16 row
    where a flip happened), MIND's loss, gradients and
    ``score_candidates`` (shared and per-user); (b) olmo-1b at full
    width (``full_config()``, random weights drawn on the card):
    ``prefill`` at B 4, S 2048, then 64 ``decode_step``s into a bf16
    cache of 2112 and again into an int8 cache (the prefill's k/v
    quantized), the last decode logits within the bfloat16 row of a
    ``forward`` of the whole sequence (argmax equal wherever the top-2
    margin exceeds the row), the int8 cache's within
    ``INT8_LOGIT_BOUND`` of the bf16 cache's; prefill ms and tokens/s,
    decode ms a step and tokens/s, peak memory; (c) granite-moe-1b-a400m
    at full width, the same prefill and decodes, and on each layer's MoE
    input from the prefill the einsum dispatch (one group of all 8192
    tokens) against the scatter dispatch within the bfloat16 row with
    the same count of dropped assignments; (d) training: olmo-1b at full
    width at B 4, S 1024 (``train_4k``'s 256 × 4096 cut to one card),
    ``train.build_step``'s step captured as one CUDA graph, its first
    step within the float32 row of the eager step from the same state
    (the schedule's rate is 0 there: the moments) and its last step
    within the row of an eager step teacher-forced from the captured
    state (the parameters' update, which must move some beyond the row),
    10 steps of ``lm_stream`` batches with the held-out loss falling, ms
    a step, tokens/s, TFLOP/s of ``model_flops(training=True)``, peak
    memory and the idle share; ``train.run`` on olmo-1b and mind (smoke
    configs, 30 steps, checkpoints every 10, a failure at 15 resumed
    from 10, checkpoints crc-verified, olmo-1b's held-out loss falling)
    and once without the failure; (e) MIND at full width
    (``full_config()``): ``serve_p99`` (B 512, 1024 candidates each) and
    ``retrieval_cand`` (one user, 10⁶ shared candidates, top 100) on the
    card against the CPU (the top-k indices equal wherever neighbours
    are apart), ms a call and users/s, and 5 captured train steps of
    8192 users (``train_batch``'s 65536 cut: the in-batch logits are B ×
    B), the first and the last held against eager steps as olmo-1b's;
    ``lm_recsys.json``;
14. DimeNet and NequIP (``models/gnn/{dimenet,nequip}.py``) and the
    ``molecule`` step: (a) their smoke configs on the card against the
    CPU, one set of weights drawn on the CPU and moved across: DimeNet's
    energies, loss and gradients, NequIP's energies, forces and the
    gradients of its force-weighted loss (``force_weight`` 0.1 on force
    labels: second order, through ``edge_aggregate``'s gather backward),
    within the float32 row (a gradient leaf outside it held as phase 12
    holds one); DimeNet's invariance and NequIP's equivariance on the
    card at the reference test's tolerances; (b) full width at
    full_graph_sm's size: ``geometric_graph(2708, cutoff=5.0, box=64.0)``,
    whose radius graph fills the 10,556-edge budget, and DimeNet's
    triplets under the 65,536 budget; DimeNet 6 × 128 and NequIP 5 × 32,
    20 captured ``gnn_common.train_step`` steps each: losses finite, the
    first step's loss and gradients against the CPU (the captured first
    loss equal to the eager one within the row), the last step
    against the eager step teacher-forced from the captured state (some
    parameters moving beyond the row), NequIP's forces against the CPU;
    ms a step, TFLOP/s of ``_flops``, peak memory and the idle share;
    (c) ``gnn_common.batched_train_step`` on 128 graphs of n 30, e 64
    (``molecule_graphs``; DimeNet's triplet budget 256) for DimeNet,
    NequIP, GatedGCN and GraphSAGE at their full configs, 10 captured
    steps each, the first against the CPU; ms a step and graphs/s; (d)
    ``edge_aggregate`` bitwise against its plain version at every shape
    these runs launch it with (NequIP's d 32, 96 and 160 and DimeNet's
    128 at E 10,556, and the molecule batches), and one counted step of
    each run (``GEO_LAUNCHES``), which joins the kernel line's launches;
    ``geometric.json``;
15. the multi-device tools (``dist/sharding.py``, ``configs/base.py``,
    ``optim/compress.py``, ``checkpoint/manager.py``'s restore onto a
    mesh) on a (1, 1) ("data", "model") mesh over a world of one (NCCL,
    ``launch/mesh.make_host_mesh``): (a) every cell of
    ``configs.all_cells(include_paper=True)``: ``make_step(mesh)`` on the
    arguments placed by ``resolve_shardings`` (weights from a seed, data
    in each leaf's range, CaloClusterNet's events generated) against
    ``make_step(None)`` on the same tensors, every output bitwise, with
    deterministic scatter-adds; the cuts: LM training at B 4, S 1024,
    prefill at B 4, S 2048, decode_32k at B 4 with a cache of 2112,
    long_500k at B 1 with 32768; yi-9b, granite-34b and
    llama4-maverick at their smoke widths (with their full configs'
    attention and loss chunks); MIND's train_batch at 8192;
    DimeNet's ``minibatch_lg`` at half of its triplets
    (``CELL_DIMENET_TRIPLETS``); ``ogb_products`` on the dry-run's fake
    mesh only (``CELL_FAKE_ONLY``: memory); every other cell at full
    size; ms a call of both; the GNN cells' ``edge_aggregate``
    launches (one GNN cell's run counted under the profiler) join the
    kernel line's; (b) the decode cells of olmo-1b and
    granite-moe-1b-a400m at full width (``lm_common.CapturedDecode``: one
    CUDA graph a step, the cache its static buffer written in place): a
    2048-token prefill at B 4, then 64 steps replayed from one capture
    into a cache of 32768 (decode_32k's, B 128 cut to 4) and of 2112, bf16
    and int8, logits of every step and the cache bitwise equal to 64
    eager ``decode_step``s (at 2112, phase 13's own: the phase takes over
    its tokens and prefill and makes its weights again from their seed);
    ms a step and tokens/s of both, the idle share of both (bf16; the
    eager one at 2112 phase 13's), peak memory; (c) ``compressed_tree_psum`` over
    the one-rank world, 3 rounds of error feedback on olmo-1b's smoke
    gradients, bitwise against its math in plain PyTorch; (d) phase 12's
    driver checkpoint restored with ``mesh=`` and ``shardings=``, byte
    for byte the plain restore; ``cells.json``;
16. the kernels' last forms: (a) gelu and silu epilogues (CUDA's tanhf
    and expf, so within the float32 row of the plain versions, an int8
    output within a step) in ``fused_dense`` at the fp path's five dense
    shapes and the attention dense (4096, 64) -> 192, in
    ``fused_dense_int8`` at the mixed path's shapes with f32 and int8
    out, and in both blocks at x (2, 128, 64), each timed beside its
    plain version and, for the f32 dense, ``addmm`` then
    ``F.gelu(approximate="tanh")`` or ``F.silu``; (b) bitwise: both
    blocks with ``concat_x=False`` at (2, 128, 64) and the current
    detector's (8, 32, 64), the f32 block also past the register cell
    (600 hits; d_f 129: its shared-memory cell, each plan against the
    library's), and the int8 block's int8 output at both shapes, at its
    output's calibrated scale and at 1e38 (quotients below the normal
    range: the division path); (c) CaloClusterNet's graph at the
    upgrade width with each ``gn{i}_cat`` taken out (``gn{i}_out`` on
    the aggregate alone), deployed fp and mixed at design point 3 (64
    events) and ragged fp (16): 2 ``gravnet_block`` (fp) or
    ``gravnet_block_int8`` (mixed) and 5 denses a chunk, the kNN pair on
    the ragged path, heads and CPS bitwise with the plain-substituted
    deployment; (d) ``ccn.apply`` under (topk, onehot) × (f32, bf16) on
    4096 events (trigger_serve's batch), the card (timed first) against
    the CPU within the float32 or bfloat16 row, but on the events whose
    kNN selection differs between the two (at most
    ``FORWARD_SWAP_LIMIT``; at their first differing block the card's
    selection the top-k of its own distances, each differing slot a near
    tie on the CPU's), ``n_clusters`` and ``trigger`` bitwise under f32,
    ms a call on the card; ``forms.json``;
17. the bf16 forms (``kernels/bf16_cases.py``): (a) every kernel's bf16
    operand form (the int8 block: its x) at the path shapes (the fp
    path's five denses and the attention dense (4096, 64) -> 192, both
    blocks at x (2, 128, 64) and (8, 32, 64), the aggregation at 1 and
    16 events, the kNN pair at 8 bins, the GatedGCN and GraphSAGE edge
    shapes) and on the edge inputs (K 4, 70 and 257, a row-strided x,
    600 hits, d_f 129, k 40, indices out of range, 30,000 edges over
    three launches, subnormal and large values), bitwise with its plain
    version with a bf16 and an f32 output (the int8 block f32 and int8),
    and each kernel once from f32 operands into bf16; (b) each timed
    beside its f32 form at the same shape, with its bound (2 bytes a
    bf16 element) and, for the dense, ``addmm`` on the bf16 operands;
    (c) one call of each under the profiler runs its kernel alone (the
    30,000-edge mean its three launches), no conversion kernel; (d) a
    deployed graph whose dense is tagged bf16, eager (one
    ``fused_dense`` launch a micro-batch, bf16 x, w, b and output) and
    captured, bitwise with the plain-substituted deployment; (e)
    ``autotune`` and ``warm_from_cache`` on bf16 dense, GravNet and edge
    problems, their operands bf16; ``bf16.json``;
18. the launch knobs (``tuning/candidates.py``): (a) every candidate of
    every family at the path shapes (``KNOB_SHAPES``: the mixed and fp
    chunks, the current detector's, the ragged bins, GatedGCN, GraphSAGE,
    the attention dense, the GravNet and edge inputs past the register
    cell) launched as asked (the wrapper's ``last_plan``), its shared
    memory the library's, bitwise with its plain version (the int8 forms
    with f32 and int8 out), its device ms beside the default's; (b)
    ``autotune_graph`` on "cuda" over the mixed default, fp,
    ``fuse_int8=False``, ragged, the current detector, GatedGCN and
    GraphSAGE: each problem searched its whole list, a redeploy binds
    and launches the winners, serves bitwise with the untuned
    deployment captured and eager, events/s of both in turns (medians of
    3); (c) the entries written before the knobs bind nothing and serve
    bitwise; (d) ``serve --tune --tuning-cache`` then the saved cache
    alone; ``knobs.json``;
19. the design flow's H100 model against the card
    (``launch/h100_model.py``): the warm-trained default's graph and fp
    at P = 1 to 64 and GatedGCN 16 x 70 at P = 1 to 16, each deployed at
    that P, the modelled seconds a step beside the profiler's busy time
    of one captured chunk and their ratio; the served default at the P
    its model picked, failing where that ratio leaves [0.5, 2.0]; the P,
    modelled events/s and latency at design points 1-3 under the paper's
    targets (3e6 events/s, 10 µs); the served default at its P against
    P = 2 in turns (events/s, p50/p99, medians of 3; ``model.json``);
20. print ``{"kernels": [...]}`` with every kernel of the port (the int8
    dense with each CTA tile's ms), then ``{"ok": true, "device":
    {...}}`` as the last line.

The served default (phases 4, 4b, 9-11 and 18's "mixed default") is
deployed as serve deploys it on the card, on the H100's model; every
deployment that holds the kernels at the reference's chunk shapes (the
other paths of phases 3 and 5-9, the current detector, the GNN routes
at their published widths, phases 16-18's graphs) passes
``platform="cpu"``, the reference's model, so that ``PERF.md``'s kernel
table keeps its shapes. The script refuses to run without CUDA or
outside a checkout. Long output (compiler logs, profiler tables) goes to
``chiprun_out/chip_smoke/``.
"""
from __future__ import annotations

import gc
import io
import json
import re
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager, redirect_stdout
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# the float32 row of tests/_numerics.py: |got - want| <= ATOL + RTOL·|want|
RTOL, ATOL = 1e-5, 1e-5
BF16_RTOL, BF16_ATOL = 3e-2, 3e-2   # its bfloat16 row
SERVE_EVENTS = 256              # the main path
FP_EVENTS = 64                  # the fp path of the first slice
SHORT_EVENTS = 16               # design point 1, and mixed without fuse_int8
CHECK_BATCHES = (2, 16, 64)     # one chunk, serve batch, calibration
RAGGED_EVENTS = 128             # the ragged path
RAGGED_BINS = 8                 # bins per launch (benchmarks/batching.py)
RAGGED_OCCUPANCY = (33, 65, 97)  # a quarter to three quarters of 128
RAGGED_CHECK_BINS = (1, 8, 16)  # the kNN kernels' checks
DISPATCH = 16                   # events per call of the serving loop on
                                # the CaloClusterNet paths and attention:
                                # max(microbatch, 16)
GNN_EVENTS = 64                 # the edge-based GNNs' served graphs
EDGE_WIDTHS = (16, 32, 70, 128)  # edge_aggregate's synthetic checks
EDGE_BATCHES = (1, 8, 16)
# flash_attention's (BH, S, T, D), causal: the reference's LM prefill
# tuning cell (benchmarks/tuning_bench.py), its regression bench's
# (benchmarks/regression.py) and OLMo-1B's 16 heads of 128 at the
# train_4k length (src/repro/configs/olmo_1b.py, lm_common.py)
ATTN_SHAPES = ((8, 512, 512, 64), (8, 1024, 1024, 64),
               (16, 4096, 4096, 128))
ATTN_N, ATTN_D, ATTN_BATCH = 512, 64, 8  # the deployed attention graph
ATTN_EVENTS = 32
CAPTURE_EVENTS = 128            # CaloClusterNet events of phase 9's paths
CHECK_BUCKETS = (8, 16, 32, 64, 128)  # the bucketed int8 pair's checks
BUCKETS = (32, 64, 128)         # phase 11's occupancy buckets
BUCKET_MICROBATCH = 8           # events a launch of each bucket
PROFILE_MARGIN_S = 0.02         # idle time at each edge of a profiled window
PROFILE_SENTINELS = 1024        # kernels at each edge of a counted call
TRAIN_BATCH = 1024              # condensation_train's batch
TRAIN_STEPS = 30                # captured full-width CaloClusterNet steps
TRAIN_DISTINCT = 6              # distinct batches they cycle over
HELD_OUT_SEED = 10 ** 6         # the held-out events' seed
FULL_GRAPH_STEPS = 20           # captured full_graph_sm steps a GNN
SAMPLED_STEPS = 10              # captured minibatch_lg steps
GNN_TRAIN_SEED = 0
# minibatch_lg's graph: Reddit's 232,965 nodes, its edges cut to a mean
# in-degree of 10 (host generation in seconds; the sampled step's shapes
# do not depend on the edge count)
REDDIT_NODES, REDDIT_EDGES = 232965, 2329650

KERNELS = {
    "fused_dense": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_dense.cu",
        "replaces": "src/repro/kernels/fused_dense.py:83",
    },
    "gravnet_block": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gravnet_block.cu",
        "replaces": "src/repro/kernels/gravnet_block.py:208",
    },
    "fused_dense_int8": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_dense_int8.cu",
        "replaces": "src/repro/kernels/fused_dense.py:221",
    },
    "gravnet_aggregate": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gravnet_aggregate.cu",
        "replaces": "src/repro/kernels/gravnet.py:142",
    },
    "gravnet_block_int8": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gravnet_block_int8.cu",
        "replaces": "src/repro/kernels/gravnet_block.py:427",
    },
    "knn_build": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/knn_build.cu",
        "replaces": "src/repro/kernels/knn_build.py:172",
    },
    "knn_aggregate": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/knn_aggregate.cu",
        "replaces": "src/repro/kernels/knn_build.py:242",
    },
    "edge_aggregate": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/edge_aggregate.cu",
        "replaces": "src/repro/kernels/edge_aggregate.py:117",
    },
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:78",
    },
}
# kernels held bitwise to their plain versions at every shape checked,
# except under the activations of INEXACT
BITWISE = {"fused_dense", "fused_dense_int8", "gravnet_block",
           "gravnet_block_int8", "gravnet_aggregate", "edge_aggregate",
           "knn_build", "knn_aggregate"}
# epilogues on CUDA's tanhf and expf (csrc/activation.cuh), which need not
# round as PyTorch's do: an f32 output held to the float32 row, an int8
# one to a step of its output scale (a quotient at a half step)
INEXACT = {"gelu", "silu"}
# the f32 operations of each activation an output (cost): gelu's cube,
# scale, add, scale, tanh, add, two products; silu's negation, exp, add,
# division
ACT_OPS = {"gelu": 9.0, "silu": 4.0}
# the int8 block's widths on the edge inputs: the served model's and the
# reference's smoke config's (repro/configs/caloclusternet.py)
INT8_WIDTHS = dict(dh=64, ds=4, df=22, dout=64)
SMOKE_WIDTHS = dict(dh=24, ds=3, df=8, dout=24)
# leading arguments of each kernel that carry the events (stacked to
# check a kernel at more events than one chunk)
EVENT_ARGS = {"fused_dense": 1, "fused_dense_int8": 1, "gravnet_block": 2,
              "gravnet_block_int8": 2, "gravnet_aggregate": 3,
              "knn_build": 2, "knn_aggregate": 3, "edge_aggregate": 3}


LOG: list[str] = []


def _save_log() -> None:
    """Keep the whole output under chiprun_out/, whose tail alone comes
    back from a chip run."""
    if OUT.is_dir():
        (OUT / "log.txt").write_text("".join(LOG))


def fail(msg: str) -> None:
    say(f"FAIL: {msg}")
    _save_log()
    sys.exit(1)


def say(msg: str) -> None:
    line = f"[chip_smoke] {msg}"
    LOG.append(line + "\n")
    print(line, flush=True)


class Eager:
    """A deployment run without capture, for ``serve_events``: the eager
    ``run_chunk`` loop (a ragged deployment's launches eagerly). The
    runs with the plain versions substituted on the card go this way:
    a replay would run the captured kernels, and the plain
    ``edge_aggregate`` reads its loop length back to the host."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.microbatch = pipe.microbatch

    def __call__(self, feeds):
        return self.pipe.run_eager(feeds)


# --------------------------------------------------------------- timing ----
class Timer:
    """Device time of a callable: a sleep kernel holds the card while
    the host enqueues ``reps`` calls, so the events bracket the calls'
    device work and not the host's launch overhead."""

    def __init__(self, torch):
        self.torch = torch
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        torch.cuda._sleep(20_000_000)
        b.record()
        b.synchronize()
        self.cycles_per_ms = 20_000_000 / a.elapsed_time(b)

    def once_ms(self, fn) -> float:
        """Device time of one call, after one untimed call."""
        torch = self.torch
        fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def device_ms(self, fn, reps: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int(self.cycles_per_ms * (1.5 * host_ms + 1.0)))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps


# ------------------------------------------------------------------ cost ----
# Bytes and operations of one launch, each input read once and each
# output written once, at each tensor's element size (a bf16 operand or
# output 2 bytes an element). Operations are counted by type: products and sums
# as one each, an argmin round as n compares per row, each round's exp,
# each quantization's division and rounding, and each dequantization's
# multiply as one f32 operation; the products and sums of a matrix
# product at the tensor-core rate of its operands' type (int8; bf16 for
# the bf16 forms' denses and attention's q·k and p·v), all else at f32.
# The bound is the largest of the byte time and each type's operation
# time.
def bound(nbytes: float, ops: dict) -> tuple[float, str]:
    # the H100 SXM datasheet's rates, as the design flow's model holds
    # them: HBM, f32 outside the tensor cores, bf16 and int8 tensor cores
    from repro_torch.launch import mesh as hw
    rates = {"f32": hw.H100_PEAK_FLOPS_F32, "bf16": hw.H100_PEAK_FLOPS_BF16,
             "int8": hw.H100_PEAK_OPS_INT8}
    t_b = nbytes / hw.H100_HBM_BW
    t_o = max(n / rates[kind] for kind, n in ops.items())
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def _ops(t, products, f32_ops):
    """Operations by type: ``products`` (a matrix product's) at the
    rate of ``t``'s type (bf16 or f32), ``f32_ops`` at f32."""
    kind = "bf16" if t.element_size() == 2 else "f32"
    ops = {"f32": f32_ops}
    ops[kind] = ops.get(kind, 0.0) + products
    return ops


def _numel(*ts):
    return float(sum(t.numel() for t in ts if t is not None))


def _nbytes(*ts):
    return float(sum(t.numel() * t.element_size() for t in ts
                     if t is not None))


def _out_size(kw, t):
    """Bytes an element of a kernel's float output: ``out_dtype``'s, by
    default its input's."""
    return float((kw.get("out_dtype") or t.dtype).itemsize)


def _cell_ops(n, ds, df, k):
    """f32 operations of the GravNet cell per query row."""
    return n * (2.0 * ds + 3.0) + k * (n + 1.0 + 3.0 * df)


def _segment_sizes(seg):
    """Per packed row, the rows of its own event (itself included); 0
    on padding rows."""
    same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] >= 0)
    return same.sum(dim=2).double()


def _real_k(w):
    """The dense's own K, its weight's nonzero rows: the executor pads an
    int8 w with zero rows to meet a lane-padded input
    (``core/pipeline.py``), and those rows and x's padding columns are
    no work the function needs (the f32 dense reads its own K)."""
    return int((w != 0).any(dim=1).sum().item())


def cost(name, args, kw):
    if name == "flash_attention":
        # each unmasked (row, key) pair: D products and sums for its
        # score, D for its share of p·v, one exp; under causal only the
        # pairs with key <= row (about half); q, k, v read, o written
        q, k = args[0], args[1]
        bh, s, d = q.shape
        t = k.shape[1]
        pairs = float(bh * (sum(min(r + 1, t) for r in range(s))
                            if kw.get("causal", True) else s * t))
        return q.element_size() * (2.0 * _numel(q) + 2.0 * _numel(k)), \
            _ops(q, pairs * 4.0 * d, pairs)
    # the kNN pair's work depends on the packing: count the distances
    # and argmin rounds a real row needs against its own event's rows,
    # and the aggregation's valid slots, not the whole bin
    if name == "knn_build":
        s, seg = args[:2]
        b, n, ds = s.shape
        k = kw["k"]
        c = _segment_sizes(seg)
        cand = (c - 1).clamp_min(0)
        nbytes = _nbytes(s, seg) + 4.0 * 2.0 * b * n * k
        return nbytes, {"f32": float(((c > 0) * 2.0 * ds + cand * (
            2.0 * ds + 3.0) + k * cand).sum())}
    if name == "knn_aggregate":
        f, idx, d2 = args[:3]
        b, n, df = f.shape
        valid = float((d2 < 0.5e30).sum())
        rows = float((d2[..., 0] < 0.5e30).sum())
        nbytes = _nbytes(f, idx, d2) + _out_size(kw, f) * b * n * 2 * df
        return nbytes, {"f32": valid * (2.0 + 3.0 * df) + rows * 2.0 * df}
    if name == "edge_aggregate":
        # only edges whose dst lies in [0, n) are summed
        msg, dst, mask = args[:3]
        b, e, d = msg.shape
        n = kw["n_nodes"]
        valid = float(((dst >= 0) & (dst < n)).sum())
        nbytes = _nbytes(msg, dst, mask) + _out_size(kw, msg) * b * n * d
        mean = kw.get("reduce", "sum") == "mean"
        return nbytes, {"f32": 2.0 * valid * d + (
            valid + b * n * d if mean else 0.0)}
    act_ops = ACT_OPS.get(kw.get("activation"), 0.0)
    if name == "fused_dense":
        x, w, b = args[:3]
        m, kd = x.shape[0], _real_k(w)
        n = w.shape[1]
        return (x.element_size() * (m + n) * kd + _nbytes(b)
                + _out_size(kw, x) * m * n), _ops(x, 2.0 * m * kd * n,
                                                  act_ops * m * n)
    if name == "fused_dense_int8":
        x, w, b, _, ws = args[:5]
        m, kd = x.shape[0], _real_k(w)
        n = w.shape[1]
        out8 = kw.get("out_int8", False)
        nbytes = (m + n) * kd + 4.0 * _numel(b, ws) + m * n * (
            1.0 if out8 else 4.0)
        return nbytes, {"int8": 2.0 * m * kd * n,
                        "f32": m * n * (3.0 + act_ops
                                        + (2.0 if out8 else 0.0)) + n}
    if name == "gravnet_aggregate":
        s, f, mask = args[:3]
        b, n, ds = s.shape
        df = f.shape[2]
        nbytes = _nbytes(s, f, mask) + _out_size(kw, f) * b * n * 2 * df
        return nbytes, {"f32": b * n * (2.0 * ds
                                        + _cell_ops(n, ds, df, kw["k"]))}
    x = args[0]
    b, n, dh = x.shape
    ws, bs, wf, bf, wo, bo = args[2:8]
    ds, df = ws.shape[1], wf.shape[1]
    dcat, dout = wo.shape
    if name == "gravnet_block":
        # the S/F prologue once per event (the kernel recomputes it in
        # each row block of an event; the repeat is not counted)
        nbytes = _nbytes(x, *args[1:8]) + _out_size(kw, x) * b * n * dout
        return nbytes, _ops(x, b * n * (2.0 * dh * (ds + df)
                                        + 2.0 * dcat * dout),
                            b * n * (_cell_ops(n, ds, df, kw["k"])
                                     + act_ops * dout))
    out8 = kw.get("out_int8", False)
    nbytes = (_nbytes(x, args[1], bs, bf, bo, *args[8:11])
              + _numel(ws, wf, wo) + (1.0 if out8 else 4.0) * b * n * dout)
    return nbytes, {
        "int8": b * n * (2.0 * dh * (ds + df) + 2.0 * dcat * dout),
        "f32": b * n * (2.0 * dh + 3.0 * (ds + df)
                        + _cell_ops(n, ds, df, kw["k"]) + 4.0 * 2 * df
                        + 2.0 * (dcat - 2 * df)
                        + (3.0 + act_ops + (2.0 if out8 else 0.0)) * dout)}


def shape_of(name, args, kw):
    if name == "flash_attention":
        split = kw.get("splits")
        return (f"q{tuple(args[0].shape)} T={args[1].shape[1]} "
                f"{str(args[0].dtype)[6:]} "
                f"{'causal' if kw.get('causal', True) else 'full'} "
                f"bq={kw['bq']} bk={kw['bk']}"
                + ("" if split is None else f" splits={split}"))
    if name == "edge_aggregate":
        return (f"msg{tuple(args[0].shape)} n={kw['n_nodes']} "
                f"{kw.get('reduce', 'sum')}")
    if name == "knn_build":
        return f"s{tuple(args[0].shape)} k={kw['k']}"
    if name == "knn_aggregate":
        return f"f{tuple(args[0].shape)} k={args[1].shape[2]}"
    if name in ("fused_dense", "fused_dense_int8"):
        x, w = args[0], args[1]
        tag = f"({x.shape[0]},{x.shape[1]})->{w.shape[1]} " \
              f"{kw.get('activation', 'relu')}"
        return tag + (" int8 out" if kw.get("out_int8") else "")
    if name == "gravnet_aggregate":
        return f"s{tuple(args[0].shape)} f{tuple(args[1].shape)} k={kw['k']}"
    return (f"x{tuple(args[0].shape)} k={kw['k']}"
            + ("" if kw.get("concat_x", True) else " agg only")
            + (f" {kw['activation']}" if kw.get("activation", "relu")
               != "relu" else "")
            + (f" int8 out /{kw['out_scale']:g}" if kw.get("out_int8")
               else ""))


def dtype_tag(name, args, kw):
    """The bf16 forms' part of a launch's label: its float operands'
    dtype and, where it is not theirs, its output's (empty for the f32
    forms)."""
    if name == "flash_attention":
        return ""
    x = args[0]
    tag = " bf16" if str(x.dtype) == "torch.bfloat16" else ""
    out = kw.get("out_dtype")
    if out is not None and out != x.dtype:
        tag += f" -> {str(out).rsplit('.', 1)[-1]}"
    return tag


# ----------------------------------------------------------------- main ----
# ------------------------------------------- phase 13: LM and recsys ----
LM_SMOKE_ARCHS = ("olmo-1b", "yi-9b", "granite-34b", "granite-moe-1b-a400m",
                  "llama4-maverick-400b-a17b")
LM_PREFILL = (4, 2048)          # (B, S) of the full-width prefills
LM_DECODE_STEPS = 64            # decode steps after each prefill
LM_CACHE = 2112                 # their cache length: S + 64
LM_TRAIN = (4, 1024)            # olmo-1b's train step: train_4k's B 256,
                                # S 4096 cut to one card and the time limit
LM_TRAIN_STEPS = 10
DRIVER_STEPS = 30               # the driver runs of olmo-1b and mind
HALF_TOL = 1e-3                 # the int8 cache's flip rule
INT8_LOGIT_BOUND = 0.25         # max|Δlogit|, int8 cache against bf16:
                                # a per-token quantization step of k and v
                                # moves logits of a few units by hundredths
MIND_SERVE = (512, 1024)        # serve_p99: users, candidates each
MIND_RETRIEVAL = (1, 1_000_000, 100)   # retrieval_cand: users, shared
                                       # candidates, top k
MIND_TRAIN_BATCH = 8192         # train_batch's 65536 cut: the in-batch
                                # logits are B x B
MIND_TRAIN_STEPS = 5
TIE_REL = 1e-5                  # neighbours this close (relative) may swap


def lm_and_recsys(torch, np, dev, card, idle_share, decoded) -> dict:
    """Phase 13: the LM transformer and MIND on the card (module
    docstring, item 13). Returns the phase's record. Fills ``decoded``
    with what phase 15's decode cells are held against, by arch: the
    weights' seed, the tokens, the prefill's cache, and per cache dtype
    ("bf16", "int8") the logits of each of the 64 eager decode steps,
    the cache after them and their ms a step."""
    import dataclasses

    from repro_torch import configs as arch_configs
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.data.lm import lm_batch
    from repro_torch.data.recsys import mind_batch
    from repro_torch.launch import train
    from repro_torch.models import recsys as rec
    from repro_torch.models import transformer as tr
    from repro_torch.optim import adamw_init
    from repro_torch.optim.step import CompiledStep, value_and_grad
    cpu = torch.device("cpu")
    out = {"card": card}
    row = f"{ATOL:g} + {RTOL:g}·|want|"
    brow = f"{BF16_ATOL:g} + {BF16_RTOL:g}·|want|"

    def on(tree, device):
        return ckpt.unflatten(tree, iter(t.to(device)
                                         for _, t in ckpt.flatten(tree)))

    def within(label, got, want, rtol=RTOL, atol=ATOL):
        """Every leaf of ``got`` finite and within (atol, rtol) of the
        same leaf of ``want`` (compared in float64 on ``got``'s device);
        returns the largest |err|."""
        worst = 0.0
        for (name, g), (_, w) in zip(ckpt.flatten(got), ckpt.flatten(want),
                                     strict=True):
            g64 = g.detach().double()
            w64 = w.detach().to(g64.device).double()
            err = (g64 - w64).abs()
            bad = err > atol + rtol * w64.abs()
            if not bool(torch.isfinite(g64).all()) or bool(bad.any()):
                fail(f"[{label}] {name}: max|err| {err.max().item():.3e} at "
                     f"|want| up to {w64.abs().max().item():.3e}, "
                     f"{int(bad.sum())} of {err.numel()} outside {atol:g} + "
                     f"{rtol:g}·|want|")
            worst = max(worst, float(err.max()) if err.numel() else 0.0)
        return worst

    def int8_flips(label, got, want, f32_cache):
        """The card's int8 cache against the CPU's: every entry equal but
        a flip by one where the CPU's quotient k/scale (its float32
        cache's k over its int8 cache's scale) lies within HALF_TOL of a
        half-integer; the scales within the float32 row. Returns the
        flips."""
        flips = 0
        for n in ("k", "v"):
            within(f"{label} {n}_scale", got[f"{n}_scale"],
                   want[f"{n}_scale"])
            g = got[n].cpu().to(torch.int32)
            w = want[n].to(torch.int32)
            quot = f32_cache[n].double().abs() / want[f"{n}_scale"].double(
                )[..., None].clamp_min(1e-30)
            near = (quot - quot.floor() - 0.5).abs() < HALF_TOL
            diff = g != w
            if bool(((g - w).abs() > 1).any()) or bool((diff & ~near).any()):
                fail(f"[{label}] int8 {n}: {int(diff.sum())} entries differ, "
                     f"{int((diff & ~near).sum())} of them away from a half")
            flips += int(diff.sum())
        return flips

    def share(v):
        return "not measured" if v is None else f"{v:.4f}"

    def timed(fn, sync=True):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        if sync:
            torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3

    def teacher_forced(label, step_fn, stepper, batch):
        """The captured step on ``batch`` against the eager step from the
        same state (the stepper's, taken before it steps): loss,
        parameters and moments within the float32 row. The parameters
        whose eager update the row can see are counted and must not be
        none, so a captured step that left the state unchanged fails
        (cosine_warmup gives step 1 a rate of 0: this is held at a later
        step). Returns (metrics, ms, max|err|, moved, of)."""
        p_e, o_e, m_e = step_fn(stepper.params, stepper.opt, batch)
        moved = of = 0
        for (_, a), (_, b) in zip(ckpt.flatten(p_e),
                                  ckpt.flatten(stepper.params)):
            moved += int(((a - b).abs() > ATOL + RTOL * b.abs()).sum())
            of += b.numel()
        eager = on({"loss": m_e["loss"], "p": p_e, "o": o_e}, cpu)
        del p_e, o_e, m_e
        m, ms = timed(lambda: stepper(batch))
        err = within(label, {"loss": m["loss"], "p": stepper.params,
                             "o": stepper.opt}, eager)
        if moved == 0:
            fail(f"[{label}] the eager step moved no parameter beyond {row}")
        return m, ms, err, moved, of

    # (a) every LM smoke config and MIND's on the card against the CPU,
    # one set of weights drawn on the CPU and moved across
    smoke = {}
    for i, arch in enumerate(LM_SMOKE_ARCHS):
        cfg = arch_configs.get_arch(arch).smoke_config()
        p_cpu = tr.init_params(torch.Generator().manual_seed(100 + i), cfg)
        p_dev = on(p_cpu, dev)
        toks = torch.from_numpy(lm_batch(cfg.vocab, 2, 16, seed=i,
                                         step=0)["tokens"])
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
        b_dev = on(batch, dev)
        errs = {}
        with torch.no_grad():
            errs["forward"] = within(
                f"{arch} forward", tr.forward(p_dev, b_dev["tokens"], cfg),
                tr.forward(p_cpu, toks, cfg))
            if cfg.moe is not None:
                for disp in ("einsum", "scatter"):
                    c_ = dataclasses.replace(cfg, moe=dataclasses.replace(
                        cfg.moe, dispatch=disp))
                    errs[f"moe_{disp}"] = within(
                        f"{arch} forward, {disp} dispatch",
                        tr.forward(p_dev, b_dev["tokens"], c_),
                        tr.forward(p_cpu, toks, c_))
            lg_d, c_d = tr.prefill(p_dev, b_dev["tokens"], cfg)
            lg_c, c_c = tr.prefill(p_cpu, toks, cfg)
            errs["prefill"] = within(f"{arch} prefill", (lg_d, c_d),
                                     (lg_c, c_c))
        (l_d, m_d), g_d = value_and_grad(
            lambda p: tr.loss_fn(p, b_dev, cfg), p_dev)
        (l_c, m_c), g_c = value_and_grad(
            lambda p: tr.loss_fn(p, batch, cfg), p_cpu)
        errs["loss_grads"] = within(f"{arch} loss and gradients",
                                    (l_d, m_d, g_d), (l_c, m_c, g_c))
        caches = {}
        with torch.no_grad():
            for int8 in (False, True):
                c_ = dataclasses.replace(cfg, kv_cache_int8=int8)
                cd = tr.init_cache(c_, 2, 16, device=dev)
                cc = tr.init_cache(c_, 2, 16, device=cpu)
                logits = []
                for t in range(8):
                    ld_, cd = tr.decode_step(p_dev, cd, b_dev["tokens"][
                        :, t:t + 1], c_)
                    lc_, cc = tr.decode_step(p_cpu, cc, toks[:, t:t + 1], c_)
                    logits.append((ld_, lc_))
                caches[int8] = (cd, cc)
                kind = "int8" if int8 else "f32"
                if not int8:
                    errs["decode"] = within(
                        f"{arch} 8 decode steps",
                        ([d for d, _ in logits], cd),
                        ([c for _, c in logits], cc))
                    continue
                flips = int8_flips(f"{arch} int8 cache", cd, cc,
                                   caches[False][1])
                # a flip moves a cached k or v by one step of its scale:
                # then the logits are held to the bfloat16 row
                tol = (RTOL, ATOL) if flips == 0 else (BF16_RTOL, BF16_ATOL)
                errs["decode_int8"] = within(
                    f"{arch} 8 decode steps, {kind} cache",
                    [d for d, _ in logits], [c for _, c in logits], *tol)
                errs["int8_flips"] = flips
        smoke[arch] = errs
        say(f"[lm smoke {arch}] card vs CPU max|err|: " + ", ".join(
            f"{k} {v:.2e}" if isinstance(v, float) else f"{k} {v}"
            for k, v in errs.items()) + f" (float32 row {row}) ({card})")
    m_cfg = arch_configs.get_arch("mind").smoke_config()
    mp_cpu = rec.init(torch.Generator().manual_seed(110), m_cfg)
    mp_dev = on(mp_cpu, dev)
    raw = mind_batch(n_items=m_cfg.n_items, n_user_tags=m_cfg.n_user_tags,
                     hist_len=m_cfg.hist_len, tag_bag=m_cfg.tag_bag,
                     batch=16, seed=5, step=0)
    mb = {k: torch.from_numpy(v) for k, v in raw.items()}
    mb_dev = on(mb, dev)
    (ml_d, mm_d), mg_d = value_and_grad(
        lambda p: rec.loss_fn(p, mb_dev, m_cfg), mp_dev)
    (ml_c, mm_c), mg_c = value_and_grad(
        lambda p: rec.loss_fn(p, mb, m_cfg), mp_cpu)
    m_errs = {"loss_grads": within("mind smoke loss and gradients",
                                   (ml_d, mm_d, mg_d), (ml_c, mm_c, mg_c))}
    with torch.no_grad():
        for shared in (True, False):
            cands = (torch.arange(m_cfg.n_items, dtype=torch.int32) if shared
                     else torch.from_numpy(np.random.default_rng(6).integers(
                         0, m_cfg.n_items, (16, 40)).astype(np.int32)))
            m_errs["scores_" + ("shared" if shared else "per_user")] = \
                within(f"mind smoke score_candidates shared={shared}",
                       rec.score_candidates(mp_dev, {**mb_dev, "cand_ids":
                                                     cands.to(dev)}, m_cfg),
                       rec.score_candidates(mp_cpu, {**mb, "cand_ids": cands},
                                            m_cfg))
    smoke["mind"] = m_errs
    say(f"[mind smoke] card vs CPU max|err|: " + ", ".join(
        f"{k} {v:.2e}" for k, v in m_errs.items()) + f" (float32 row {row}) "
        f"({card})")
    out["smoke"] = smoke

    # (b), (c) olmo-1b and granite-moe-1b-a400m at full width: a prefill,
    # then decode steps into the cache
    B, S = LM_PREFILL

    def prefill_decode(arch, seed, moe_inputs=None):
        decoded[arch] = {"seed": seed}
        cfg = arch_configs.get_arch(arch).full_config()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params = tr.init_params(torch.Generator(dev).manual_seed(seed), cfg)
        seq = torch.from_numpy(lm_batch(cfg.vocab, B, S + LM_DECODE_STEPS,
                                        seed=seed, step=0)["tokens"]).to(dev)
        r = {"config": repr(cfg)}
        with torch.no_grad():
            tr.prefill(params, seq[:, :S], cfg)          # warm-up
            if moe_inputs is not None:
                saved = tr._moe_einsum

                def rec_moe(x, lp, cfg_, mesh=None):
                    moe_inputs.append((x, lp))
                    return saved(x, lp, cfg_, mesh)
                tr._moe_einsum = rec_moe
            try:
                (lg_pf, cache_pf), pf_ms = timed(
                    lambda: tr.prefill(params, seq[:, :S], cfg))
            finally:
                if moe_inputs is not None:
                    tr._moe_einsum = saved
            # its host time spreads between calls: the median of 3
            pf_ms = float(np.median([pf_ms] + [timed(lambda: tr.prefill(
                params, seq[:, :S], cfg))[1] for _ in range(2)]))
            r["prefill_ms"] = pf_ms
            r["prefill_tokens_per_s"] = B * S / pf_ms * 1e3
            decoded[arch].update(seq=seq, cache_pf=cache_pf)

            def decode(cfg_):
                c = tr.init_cache(cfg_, B, LM_CACHE, device=dev)
                if cfg_.kv_cache_int8:
                    for n in ("k", "v"):
                        q, sc = tr.quantize_kv(cache_pf[n])
                        c[n][:, :, :S] = q
                        c[f"{n}_scale"][:, :, :S] = sc
                else:
                    c["k"][:, :, :S] = cache_pf["k"]
                    c["v"][:, :, :S] = cache_pf["v"]
                c["pos"].fill_(S)
                tr.decode_step(params, c, seq[:, S:S + 1], cfg_)   # warm-up

                lgs = []

                def run():
                    cc, lg = c, None
                    for t in range(LM_DECODE_STEPS):
                        lg, cc = tr.decode_step(params, cc, seq[
                            :, S + t:S + t + 1], cfg_)
                        lgs.append(lg)
                    return lg, cc
                (lg, cc), ms = timed(run)
                decoded[arch]["int8" if cfg_.kv_cache_int8 else "bf16"] = (
                    lgs, cc, ms / LM_DECODE_STEPS)
                if not cfg_.kv_cache_int8:
                    # where a decode step's time goes
                    tok = seq[:, S + LM_DECODE_STEPS - 1:S + LM_DECODE_STEPS]
                    busy, _, wall = idle_share(
                        lambda: tr.decode_step(params, c, tok, cfg_),
                        f"{arch} decode steps", f"_decode_{arch}")
                    r["decode_idle_share"] = (1 - busy / wall if busy > 0
                                              else None)
                return lg, cc, ms / LM_DECODE_STEPS
            lg16, c16, d16_ms = decode(cfg)
            lg8, c8, d8_ms = decode(dataclasses.replace(cfg,
                                                        kv_cache_int8=True))
        r.update(decode_ms_per_step=d16_ms, decode_tokens_per_s=B / d16_ms
                 * 1e3, decode_int8_ms_per_step=d8_ms,
                 decode_int8_tokens_per_s=B / d8_ms * 1e3)
        d8 = float((lg8 - lg16).abs().max())
        r["int8_vs_bf16_cache_max_abs_dlogit"] = d8
        r["max_abs_logit"] = float(lg16.abs().max())
        if not (bool(torch.isfinite(lg8).all()) and d8 <= INT8_LOGIT_BOUND):
            fail(f"[{arch}] int8 cache's last logits max|Δ| {d8:.4f} against "
                 f"the bf16 cache's, bound {INT8_LOGIT_BOUND}")
        if int(c16["pos"][0, 0]) != S + LM_DECODE_STEPS:
            fail(f"[{arch}] cache at {int(c16['pos'][0, 0])}")
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        return cfg, params, seq, lg16, r

    cfg_o, params_o, seq_o, lg_o, r_o = prefill_decode("olmo-1b", 200)
    # the last decode logits against a forward of the whole sequence in
    # bf16, and against one in f32 compute (the same weights): through 16
    # bf16 layers the bf16 forward itself leaves the bfloat16 row of the
    # f32 one on a few logits, so a decode logit outside the row of the
    # bf16 forward must lie no further from the f32 forward than twice
    # the bf16 forward's largest distance from it (phase 12's rule for
    # gradients, with f32 compute as the truth)
    full = dataclasses.replace(cfg_o, attn_mode="full")
    with torch.no_grad():
        x, _ = tr.forward(params_o, seq_o, full)
        lg_f = (x[:, -1] @ params_o["lm_head"].to(cfg_o.compute_dtype)
                ).float()
        x, _ = tr.forward(params_o, seq_o, dataclasses.replace(
            full, compute_dtype=torch.float32))
        lg_t = x[:, -1] @ params_o["lm_head"]
    del x
    err = (lg_o - lg_f).abs()
    outside = err > BF16_ATOL + BF16_RTOL * lg_f.abs()
    e_fwd = float((lg_f - lg_t).abs().max())
    e_dec = (lg_o - lg_t).abs()
    r_o.update(decode_vs_forward_max_abs_err=float(err.max()),
               decode_outside_bf16_row=int(outside.sum()),
               bf16_forward_vs_f32_max_abs_err=e_fwd,
               decode_vs_f32_forward_max_abs_err=float(e_dec.max()))
    if bool((e_dec[outside] > 2 * e_fwd).any()):
        fail(f"[olmo-1b] last decode logits against the forward: "
             f"{int(outside.sum())} outside the bfloat16 row ({brow}), "
             f"max|err| against the f32 forward there "
             f"{float(e_dec[outside].max()):.4f} above twice the bf16 "
             f"forward's {e_fwd:.4f}")
    top2 = lg_f.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > BF16_ATOL + BF16_RTOL * top2[:, 0].abs()
    same = lg_o.argmax(-1) == lg_f.argmax(-1)
    r_o["argmax_clear_rows"] = int(clear.sum())
    if bool((clear & ~same).any()):
        fail(f"[olmo-1b] argmax differs on a row whose top-2 margin exceeds "
             f"the bfloat16 row: {same.tolist()}, clear {clear.tolist()}")
    out["olmo_full"] = r_o
    say(f"[olmo-1b full width] prefill B={B} S={S} ({cfg_o.attn_mode}, "
        f"{S // min(cfg_o.block_q, S)} q chunks): "
        f"{r_o['prefill_ms']:.2f} ms, {r_o['prefill_tokens_per_s']:.0f} "
        f"tokens/s; {LM_DECODE_STEPS} decode steps into a cache of "
        f"{LM_CACHE}: bf16 cache {r_o['decode_ms_per_step']:.3f} ms a step, "
        f"{r_o['decode_tokens_per_s']:.1f} tokens/s; int8 cache "
        f"{r_o['decode_int8_ms_per_step']:.3f} ms, "
        f"{r_o['decode_int8_tokens_per_s']:.1f} tokens/s, its last logits "
        f"max|Δ| {r_o['int8_vs_bf16_cache_max_abs_dlogit']:.4f} against the "
        f"bf16 cache's (bound {INT8_LOGIT_BOUND}; logits up to "
        f"{r_o['max_abs_logit']:.2f}); last decode logits against a bf16 "
        f"forward of all {S + LM_DECODE_STEPS} tokens max|err| "
        f"{r_o['decode_vs_forward_max_abs_err']:.4f}, "
        f"{r_o['decode_outside_bf16_row']} of {lg_o.numel()} outside the "
        f"bfloat16 row ({brow}), each no further from the f32 forward than "
        f"twice the bf16 forward's {e_fwd:.4f} (decode: "
        f"{r_o['decode_vs_f32_forward_max_abs_err']:.4f}); argmax equal on "
        f"the {r_o['argmax_clear_rows']} of {B} rows with a clear top-2 "
        f"margin; decode idle share {share(r_o['decode_idle_share'])}; peak "
        f"{r_o['peak_gib']:.3f} GiB ({card})")

    # (d) olmo-1b training at full width, LM_TRAIN (B, S); the state
    # starts from (b)'s weights
    mod_o = arch_configs.get_arch("olmo-1b")
    step_o, _, _, ocfg = train.build_step("olmo-1b", mod_o, cfg_o, device=dev)
    tb, ts = LM_TRAIN
    lm_train = [{k: torch.from_numpy(v).to(dev) for k, v in lm_batch(
        cfg_o.vocab, tb, ts, seed=300, step=i).items()}
        for i in range(LM_TRAIN_STEPS)]
    held = {k: torch.from_numpy(v).to(dev) for k, v in lm_batch(
        cfg_o.vocab, tb, ts, seed=HELD_OUT_SEED, step=0).items()}
    del seq_o, lg_o, lg_f, lg_t
    opt0 = adamw_init(params_o, ocfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the eager step from the initial state, kept on the host
    p1, o1, m_e = step_o(params_o, opt0, lm_train[0])
    eager1 = on({"loss": m_e["loss"], "p": p1, "o": o1}, cpu)
    del p1, o1, m_e
    stepper = CompiledStep(step_o, params_o, opt0, device=dev)
    with torch.no_grad():
        h0 = float(tr.loss_fn(params_o, held, cfg_o)[0])
    del params_o, opt0
    m1, cap_ms = timed(lambda: stepper(lm_train[0]))
    ce_err = within("olmo-1b train captured vs eager, step 1",
                    {"loss": m1["loss"], "p": stepper.params,
                     "o": stepper.opt}, eager1)
    del eager1
    losses, step_ms = [float(m1["loss"])], []
    for b_ in lm_train[1:-1]:
        m_, ms = timed(lambda: stepper(b_))
        step_ms.append(ms)
        losses.append(float(m_["loss"]))
    m_, ms, tf_err, moved, of = teacher_forced(
        f"olmo-1b train captured vs eager, step {LM_TRAIN_STEPS}", step_o,
        stepper, lm_train[-1])
    step_ms.append(ms)
    losses.append(float(m_["loss"]))
    with torch.no_grad():
        h1 = float(tr.loss_fn(stepper.params, held, cfg_o)[0])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not np.isfinite(losses).all() or not h1 < h0:
        fail(f"[olmo-1b train] losses {losses}, held-out {h0} -> {h1}")
    med = float(np.median(step_ms))
    flops = tr.model_flops(cfg_o, tb, ts, training=True)
    busy, _, wall = idle_share(lambda: stepper(lm_train[1]),
                               "captured olmo-1b train steps", "_train_lm")
    out["olmo_train"] = {
        "batch": tb, "seq": ts, "steps": LM_TRAIN_STEPS,
        "capture_ms": cap_ms, "losses": losses, "held_out_loss": [h0, h1],
        "step_ms": step_ms, "ms_per_step": med,
        "tokens_per_s": tb * ts / med * 1e3,
        "model_tflops": flops / (med * 1e-3) / 1e12, "peak_gib": peak,
        "idle_share": 1 - busy / wall if busy > 0 else None,
        "captured_vs_eager_max_err": ce_err,
        "captured_vs_eager_last_step_max_err": tf_err,
        "params_moved_beyond_row_last_step": [moved, of]}
    say(f"[olmo-1b train full width] B={tb} S={ts} (train_4k's 256 x 4096 "
        f"cut to one card), one CUDA graph a step (first step with its "
        f"capture {cap_ms:.0f} ms): loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"held-out {h0:.4f} -> {h1:.4f}; median {med:.2f} ms a step, "
        f"{tb * ts / med * 1e3:.0f} tokens/s, "
        f"{out['olmo_train']['model_tflops']:.1f} TFLOP/s of "
        f"model_flops(training=True); peak {peak:.3f} GiB; idle share "
        f"{share(out['olmo_train']['idle_share'])}; captured vs eager "
        f"max|err| step 1 (lr 0: the moments) {ce_err:.3e}, step "
        f"{LM_TRAIN_STEPS} (teacher-forced; {moved} of {of} parameters "
        f"moved beyond the row) {tf_err:.3e}, within {row} ({card})")
    del stepper, lm_train, held
    torch.cuda.empty_cache()

    moe_inputs = []
    cfg_g, params_g, seq_g, _, r_g = prefill_decode(
        "granite-moe-1b-a400m", 201, moe_inputs)
    del seq_g
    # einsum against scatter dispatch on each layer's MoE input from the
    # prefill, the einsum over one group of all its tokens (so both queue
    # the same tokens for the same capacity)
    one = dataclasses.replace(cfg_g, moe=dataclasses.replace(
        cfg_g.moe, group_size=B * S))
    sc = dataclasses.replace(cfg_g, moe=dataclasses.replace(
        cfg_g.moe, dispatch="scatter"))
    worst, drops, drops_cfg = 0.0, [], []
    with torch.no_grad():
        for li, (x, lp) in enumerate(moe_inputs):
            ye, _ = tr._moe_einsum(x, lp, one)
            ys, _ = tr._moe_scatter(x, lp, sc)
            worst = max(worst, within(
                f"granite-moe layer {li} einsum vs scatter", ye, ys,
                BF16_RTOL, BF16_ATOL))
            de, ds = int(tr.moe_dropped(x, lp, one)), int(
                tr.moe_dropped(x, lp, sc))
            if de != ds:
                fail(f"[granite-moe] layer {li}: einsum drops {de}, scatter "
                     f"{ds}")
            drops.append(de)
            drops_cfg.append(int(tr.moe_dropped(x, lp, cfg_g)))
    r_g.update(einsum_vs_scatter_max_abs_err=worst, dropped=drops,
               dropped_groups_of_512=drops_cfg)
    out["granite_moe_full"] = r_g
    say(f"[granite-moe-1b-a400m full width] prefill B={B} S={S}: "
        f"{r_g['prefill_ms']:.2f} ms, {r_g['prefill_tokens_per_s']:.0f} "
        f"tokens/s; decode bf16 cache {r_g['decode_ms_per_step']:.3f} ms a "
        f"step ({r_g['decode_tokens_per_s']:.1f} tokens/s), int8 cache "
        f"{r_g['decode_int8_ms_per_step']:.3f} ms, last logits max|Δ| "
        f"{r_g['int8_vs_bf16_cache_max_abs_dlogit']:.4f}; einsum vs scatter "
        f"dispatch over {len(moe_inputs)} layers' inputs ({B * S} tokens, "
        f"one group) max|err| {worst:.4f} within {brow}, dropped "
        f"assignments equal on both: {sum(drops)} of "
        f"{len(drops) * B * S * cfg_g.moe.top_k} (in the config's groups of "
        f"{cfg_g.moe.group_size}: {sum(drops_cfg)}); decode idle share "
        f"{share(r_g['decode_idle_share'])}; peak {r_g['peak_gib']:.3f} GiB "
        f"({card})")
    del params_g, moe_inputs
    torch.cuda.empty_cache()

    # (d) the driver on olmo-1b and mind: a failure injected and resumed
    drivers = {}
    for arch in ("olmo-1b", "mind"):
        runs = {}
        for tag, extra in (("failure", ["--inject-failure-at", "15"]),
                           ("whole", [])):
            ck = OUT / "ckpt" / f"{arch}_{tag}"
            shutil.rmtree(ck, ignore_errors=True)
            buf = io.StringIO()
            with redirect_stdout(buf):
                rep = train.run(["--arch", arch, "--steps", str(DRIVER_STEPS),
                                 "--ckpt-every", "10", *extra,
                                 "--ckpt-dir", str(ck)])
            LOG.append(buf.getvalue())
            if rep.device.type != dev.type or not rep.captured or not \
                    np.isfinite([v for _, v in rep.losses]).all():
                fail(f"[train driver {arch} {tag}] on {rep.device}, captured "
                     f"{rep.captured}, losses {rep.losses}")
            runs[tag] = (rep, ck)
        rep, ck = runs["failure"]
        if rep.resumes != [(15, 10)] or rep.checkpoints != [10, 20, 30]:
            fail(f"[train driver {arch}] resumed {rep.resumes}, checkpoints "
                 f"{rep.checkpoints}")
        final = {"p": rep.params, "o": rep.opt}
        for st in (10, 20, 30):
            try:    # every leaf's crc32 verified
                got, got_step = ckpt.restore(str(ck), st, final)
            except (IOError, KeyError, ValueError) as e:
                fail(f"[train driver {arch}] checkpoint {st}: {e}")
        if max(float((a.double() - b.double()).abs().max()) for (_, a), (_, b)
               in zip(ckpt.flatten(got), ckpt.flatten(final))) != 0.0:
            fail(f"[train driver {arch}] checkpoint 30 differs from the "
                 "final state")
        mod = arch_configs.get_arch(arch)
        scfg = mod.smoke_config()
        _, init_s, to_batch, _ = train.build_step(arch, mod, scfg, device=dev)
        held_raw = next(train.make_data_stream(arch, mod, scfg, 64,
                                               HELD_OUT_SEED, 0))
        loss_of = (tr.loss_fn if mod.FAMILY == "lm" else rec.loss_fn)
        with torch.no_grad():
            hl = [float(loss_of(p_, to_batch(held_raw), scfg)[0])
                  for p_ in (init_s(0), rep.params)]
        if arch == "olmo-1b" and not hl[1] < hl[0]:
            fail(f"[train driver {arch}] held-out loss {hl} not falling")
        d_fail = max(float((a.double() - b.double()).abs().max())
                     for (_, a), (_, b) in zip(
                         ckpt.flatten(rep.params),
                         ckpt.flatten(runs["whole"][0].params)))
        drivers[arch] = {"resumes": rep.resumes,
                         "checkpoints": rep.checkpoints,
                         "losses": rep.losses, "held_out_loss": hl,
                         "steps_per_s": [r_.steps_per_s for r_, _ in
                                         runs.values()],
                         "max_param_diff_failure_vs_whole": d_fail}
        say(f"[train driver {arch}] smoke config, {DRIVER_STEPS} captured "
            f"steps of 16: failure at 15 resumed from 10, checkpoints "
            f"{rep.checkpoints} crc-verified, the last equal to the final "
            f"state; losses finite ({rep.losses[0][1]:.4f} -> "
            f"{rep.losses[-1][1]:.4f}); held-out loss (64 of seed "
            f"{HELD_OUT_SEED}) {hl[0]:.5f} -> {hl[1]:.5f}; step-30 parameters' "
            f"max|diff| against an uninterrupted run {d_fail:.3e}; "
            f"{runs['whole'][0].steps_per_s:.1f} steps/s ({card})")
    out["drivers"] = drivers

    # (e) MIND at full width: serve_p99, retrieval_cand, captured steps
    mcfg = arch_configs.get_arch("mind").full_config()
    mp_cpu = rec.init(torch.Generator().manual_seed(120), mcfg)
    mp = on(mp_cpu, dev)

    def users(b, seed):
        return {k: torch.from_numpy(v) for k, v in mind_batch(
            n_items=mcfg.n_items, n_user_tags=mcfg.n_user_tags,
            hist_len=mcfg.hist_len, tag_bag=mcfg.tag_bag, batch=b,
            seed=seed, step=0).items() if k != "target"}

    def per_call(fn, reps=20):
        fn()
        ms = []
        for _ in range(reps):
            _, t_ = timed(fn)
            ms.append(t_)
        return float(np.median(ms))
    mind = {}
    ub, uc = MIND_SERVE
    u = users(ub, 400)
    u["cand_ids"] = torch.from_numpy(np.random.default_rng(401).integers(
        0, mcfg.n_items, (ub, uc)).astype(np.int32))
    u_dev = on(u, dev)
    with torch.no_grad():
        s_dev = rec.score_candidates(mp, u_dev, mcfg)
        s_cpu = rec.score_candidates(mp_cpu, u, mcfg)
        e_p99 = within("mind serve_p99 card vs CPU", s_dev, s_cpu)
        ms = per_call(lambda: rec.score_candidates(mp, u_dev, mcfg))
    mind["serve_p99"] = {"batch": ub, "cands": uc, "max_abs_err": e_p99,
                         "ms_per_call": ms, "users_per_s": ub / ms * 1e3}
    rb, rc, rk = MIND_RETRIEVAL
    r_ = users(rb, 402)
    r_["cand_ids"] = torch.arange(rc, dtype=torch.int32)
    r_dev = on(r_, dev)
    with torch.no_grad():
        v_dev, i_dev = rec.serve_topk(mp, r_dev, mcfg, k=rk)
        v_cpu, i_cpu = rec.serve_topk(mp_cpu, r_, mcfg, k=rk)
        e_ret = within("mind retrieval_cand top-k values", v_dev, v_cpu)
        vc = v_cpu.double()
        apart = (vc[:, 1:] - vc[:, :-1]).abs() > TIE_REL * torch.maximum(
            vc[:, 1:].abs(), vc[:, :-1].abs())
        sep = torch.ones_like(vc, dtype=torch.bool)
        sep[:, 1:] &= apart
        sep[:, :-1] &= apart
        if not torch.equal(i_dev.cpu()[sep], i_cpu[sep]):
            fail("[mind retrieval_cand] top-k indices differ where the "
                 "CPU's neighbours are apart")
        ms_r = per_call(lambda: rec.serve_topk(mp, r_dev, mcfg, k=rk))
    mind["retrieval_cand"] = {
        "batch": rb, "cands": rc, "topk": rk, "max_abs_err": e_ret,
        "indices_held": int(sep.sum()), "ms_per_call": ms_r,
        "users_per_s": rb / ms_r * 1e3}
    del mp_cpu
    mod_m = arch_configs.get_arch("mind")
    step_m, _, to_batch_m, ocfg_m = train.build_step("mind", mod_m, mcfg,
                                                     device=dev)
    t = time.perf_counter()
    m_batches = [to_batch_m(mind_batch(
        n_items=mcfg.n_items, n_user_tags=mcfg.n_user_tags,
        hist_len=mcfg.hist_len, tag_bag=mcfg.tag_bag,
        batch=MIND_TRAIN_BATCH, seed=403, step=i))
        for i in range(MIND_TRAIN_STEPS)]
    gen_s = time.perf_counter() - t
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the eager step from the initial state, then the captured steps; the
    # first held against it (lr 0: the moments), the last teacher-forced
    opt_m = adamw_init(mp, ocfg_m)
    p1, o1, m_e = step_m(mp, opt_m, m_batches[0])
    eager1 = on({"loss": m_e["loss"], "p": p1, "o": o1}, cpu)
    del p1, o1, m_e
    st_m = CompiledStep(step_m, mp, opt_m, device=dev)
    del opt_m
    m_, cap_ms = timed(lambda: st_m(m_batches[0]))
    m_err1 = within("mind train captured vs eager, step 1",
                    {"loss": m_["loss"], "p": st_m.params, "o": st_m.opt},
                    eager1)
    del eager1
    m_losses, m_ms = [float(m_["loss"])], []
    for b_ in m_batches[1:-1]:
        m_, ms_ = timed(lambda: st_m(b_))
        m_ms.append(ms_)
        m_losses.append(float(m_["loss"]))
    m_, ms_, m_err, m_moved, m_of = teacher_forced(
        f"mind train captured vs eager, step {MIND_TRAIN_STEPS}", step_m,
        st_m, m_batches[-1])
    m_ms.append(ms_)
    m_losses.append(float(m_["loss"]))
    if not np.isfinite(m_losses).all():
        fail(f"[mind train] losses {m_losses}")
    med_m = float(np.median(m_ms))
    mind["train"] = {"batch": MIND_TRAIN_BATCH, "steps": MIND_TRAIN_STEPS,
                     "batches_made_s": gen_s, "capture_ms": cap_ms,
                     "losses": m_losses, "ms_per_step": med_m,
                     "captured_vs_eager_max_err": [m_err1, m_err],
                     "params_moved_beyond_row_last_step": [m_moved, m_of],
                     "users_per_s": MIND_TRAIN_BATCH / med_m * 1e3,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    out["mind_full"] = mind
    say(f"[mind full width] {mcfg.n_items} items x {mcfg.embed_dim}, "
        f"{mcfg.n_user_tags} tags, K {mcfg.n_interests}, H {mcfg.hist_len}: "
        f"serve_p99 (B {ub}, {uc} candidates each) {ms:.3f} ms a call, "
        f"{ub / ms * 1e3:.0f} users/s, card vs CPU max|err| {e_p99:.2e}; "
        f"retrieval_cand (1 user, {rc} shared candidates, top {rk}) "
        f"{ms_r:.3f} ms a call, values max|err| {e_ret:.2e}, indices equal "
        f"at the {int(sep.sum())} of {rk} places apart from their "
        f"neighbours; {MIND_TRAIN_STEPS} captured train steps of "
        f"{MIND_TRAIN_BATCH} users (65536 cut: the in-batch logits are B x "
        f"B; batches made ahead in {gen_s:.1f}s): {med_m:.3f} ms a step, "
        f"{MIND_TRAIN_BATCH / med_m * 1e3:.0f} users/s, loss "
        f"{m_losses[0]:.6f} -> {m_losses[-1]:.6f}; captured vs eager "
        f"max|err| step 1 {m_err1:.3e}, step {MIND_TRAIN_STEPS} "
        f"(teacher-forced; {m_moved} of {m_of} parameters moved beyond the "
        f"row) {m_err:.3e}, within {row}; peak "
        f"{mind['train']['peak_gib']:.3f} GiB ({card})")
    del st_m, mp
    torch.cuda.empty_cache()
    return out


# ------------------------------------------ phase 14: geometric GNNs ----
# full_graph_sm's radius graph: 2708 atoms in a box of GEO_BOX with the
# models' cutoff; at seed GEO_SEED 13,264 pairs lie within it and the
# 10,556 shortest are kept (the budget filled), with 42,126 triplets
GEO_BOX, GEO_CUTOFF, GEO_SEED = 64.0, 5.0, 0
GEO_STEPS = 20                  # captured full_graph_sm steps a model
MOLECULE_STEPS = 10             # captured molecule steps an arch
FORCE_WEIGHT = 0.1              # the smoke check's force-weighted loss
# edge_aggregate launches of one step of each counted run: DimeNet one a
# block (6), NequIP one a path and layer (11 x 5), at full_graph_sm and
# on the molecule batch; GatedGCN 2 a layer (32) and GraphSAGE 1 a layer
GEO_LAUNCHES = 6 + 55 + 6 + 55 + 32 + 2


def geometric_gnns(torch, np, dev, card, h) -> tuple[dict, dict]:
    """Phase 14: DimeNet and NequIP on the card, and the molecule step
    (module docstring, item 14). ``h`` holds phase 12's comparisons
    (``within_row``, ``grads_close``, ``reordered``, ``widened_note``,
    ``on``, ``float64_aggregate``) and
    the script's ``check``, ``counted``, ``idle_share``, ``substituted``,
    ``plain_fns`` and ``wrappers``. Returns the phase's record and the
    counted run's launches."""
    from repro_torch import configs as arch_configs
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import gnn_common
    from repro_torch.data.graphs import build_triplets, geometric_graph
    from repro_torch.models.gnn import dimenet, gatedgcn, graphsage, nequip
    from repro_torch.models.gnn.sph import _random_rotation
    from repro_torch.optim import adamw_init
    from repro_torch.optim.step import CompiledStep, value_and_grad
    cpu = torch.device("cpu")
    row = f"{ATOL:g} + {RTOL:g}·|want|"
    rec = {"card": card}
    dn_arch = arch_configs.get_arch("dimenet")
    nq_arch = arch_configs.get_arch("nequip")

    def tensors(g, device=cpu):
        return {k: torch.as_tensor(v).to(device) for k, v in g.items()}

    def mean_loss(model, cfg, **kw):
        def lf(p, g):
            loss, met = model.loss_fn(p, g, cfg, **kw)
            return loss.mean(), {k: v.mean() for k, v in met.items()}
        return lf

    def card_vs_cpu(label, lf, p_cpu, g_cpu):
        """The loss and every gradient of ``lf`` on the card against the
        CPU from the same weights and graph: the loss and metrics within
        the float32 row, the gradients by phase 12's ``grads_close``, with
        the CPU in two more orders of nodes and edges where a leaf needs
        them (through 16 layers of a batch norm over 30 nodes, GatedGCN's
        molecule step, float32's error depends on the order of the sums
        by more than an order of magnitude). Returns the record."""
        p_dev, g_dev = h.on(p_cpu, dev), h.on(g_cpu, dev)
        (lc, mc), gc = value_and_grad(lambda p: lf(p, g_dev), p_dev)
        (lp, mp), gp = value_and_grad(lambda p: lf(p, g_cpu), p_cpu)
        with h.float64_aggregate():
            _, g64 = value_and_grad(
                lambda p: lf(p, h.on(g_cpu, cpu, torch.float64)),
                h.on(p_cpu, cpu, torch.float64))
        l_err = h.within_row(f"{label} loss", {"loss": lc, **mc},
                             {"loss": lp, **mp})
        g_err, orders, widened = h.grads_close(label, gc, gp, g64, (
            value_and_grad(lambda p, k=k: lf(p, h.reordered(g_cpu, k)),
                           p_cpu)[1] for k in (1, 2)))
        say(f"[{label}] card vs CPU: loss {float(lc):.6g} (max|err| "
            f"{l_err:.3e}, within {row}), gradients max|err| {g_err:.3e}, "
            f"{h.widened_note(widened, orders)} ({card})")
        return {"loss": float(lc), "loss_max_err": l_err,
                "grad_max_err": g_err, "cpu_orders": orders,
                "widened": widened}

    def check_shapes(label, lf, p_dev, g_dev):
        """edge_aggregate at every shape one forward of ``lf`` launches it
        with, bitwise against its plain version (one check a shape)."""
        calls = []

        def rec_(*args, **kw):
            calls.append((args, kw))
            return h.plain_fns["edge_aggregate"](*args, **kw)
        with h.substituted({"edge_aggregate": rec_}), torch.no_grad():
            lf(p_dev, g_dev)
        seen = []
        for pos, (args, kw) in enumerate(calls):
            key = (tuple(args[0].shape), kw["n_nodes"], kw.get("reduce"))
            if key not in seen:
                seen.append(key)
                h.check(f"geometric {label}", pos, args[0].shape[0],
                        "edge_aggregate", list(args), kw)
        return {"launches_a_forward": len(calls), "shapes": seen}

    def run_steps(label, step_fn, p_dev, o_dev, batch, n_steps, first_loss):
        """``n_steps`` captured steps of ``step_fn`` (the first one's loss
        within the float32 row of ``first_loss``, the eager loss from the
        same state; the last one held against the eager step
        teacher-forced from the captured state); returns the stepper and
        the record."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        st = CompiledStep(step_fn, p_dev, o_dev, device=dev)
        t = time.perf_counter()
        m = st(batch)
        torch.cuda.synchronize()
        cap_s = time.perf_counter() - t
        if abs(float(m["loss"]) - first_loss) > ATOL + RTOL * abs(first_loss):
            fail(f"[{label}] the captured first step's loss "
                 f"{float(m['loss'])} is not the eager one's {first_loss}")
        losses, ms = [m["loss"].clone()], []
        for _ in range(n_steps - 2):
            t = time.perf_counter()
            m = st(batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            losses.append(m["loss"].clone())
        # the last step: the eager step from the captured state, then the
        # captured one (the rate is not 0 past step 1)
        p_e, o_e, m_e = step_fn(st.params, st.opt, batch)
        moved = sum(int(((a - b).abs() > ATOL + RTOL * b.abs()).sum())
                    for (_, a), (_, b) in zip(ckpt.flatten(p_e),
                                              ckpt.flatten(st.params)))
        eager = h.on({"loss": m_e["loss"], "p": p_e, "o": o_e}, cpu)
        del p_e, o_e, m_e
        m = st(batch)
        torch.cuda.synchronize()
        losses.append(m["loss"].clone())
        tf_err = h.within_row(f"{label} captured vs eager, step {n_steps}",
                              {"loss": m["loss"], "p": st.params,
                               "o": st.opt}, eager)
        if moved == 0:
            fail(f"[{label}] the eager step moved no parameter beyond {row}")
        losses = [float(x) for x in losses]
        if not np.isfinite(losses).all():
            fail(f"[{label}] non-finite losses {losses}")
        peak = torch.cuda.max_memory_allocated()
        med = float(np.median(ms))
        return st, {"steps": n_steps, "capture_s": cap_s,
                    "losses": losses, "step_ms": ms, "median_ms": med,
                    "peak_bytes": peak, "step_peak_bytes": peak - base,
                    "teacher_forced_max_err": tf_err,
                    "moved_beyond_row": moved,
                    "edge_aggregate_per_step": st.launches.get(
                        "edge_aggregate_cuda", 0)}

    # (a) the smoke configs, card against CPU, one set of weights drawn
    # on the CPU and moved across
    dcfg, ncfg = dn_arch.smoke_config(), nq_arch.smoke_config()
    gd = geometric_graph(24, cutoff=1.8, box=3.0, n_species=4, seed=0,
                         max_edges=128)
    gd["triplets"], gd["triplet_mask"] = build_triplets(
        gd["edge_index"], gd["edge_mask"], max_triplets=512)
    gn = geometric_graph(20, cutoff=1.8, box=3.0, n_species=4, seed=0,
                         max_edges=96)
    gn["forces"] = np.random.default_rng(20).normal(
        size=(20, 3)).astype(np.float32)
    gd, gn = tensors(gd), tensors(gn)
    pd = dimenet.init(torch.Generator().manual_seed(21), dcfg)
    pn = nequip.init(torch.Generator().manual_seed(22), ncfg)
    smoke = {}
    with torch.no_grad():
        smoke["dimenet_apply_max_err"] = h.within_row(
            "dimenet smoke apply", dimenet.apply(h.on(pd, dev), h.on(gd, dev),
                                                 dcfg),
            dimenet.apply(pd, gd, dcfg))
        smoke["nequip_apply_max_err"] = h.within_row(
            "nequip smoke apply", nequip.apply(h.on(pn, dev), h.on(gn, dev),
                                               ncfg),
            nequip.apply(pn, gn, ncfg))
    smoke["nequip_forces_max_err"] = h.within_row(
        "nequip smoke forces", nequip.forces(h.on(pn, dev), h.on(gn, dev),
                                             ncfg),
        nequip.forces(pn, gn, ncfg))
    smoke["dimenet_loss"] = card_vs_cpu(
        "dimenet smoke", mean_loss(dimenet, dcfg), pd, gd)
    smoke["nequip_force_loss"] = card_vs_cpu(
        f"nequip smoke, force_weight {FORCE_WEIGHT} (second order)",
        mean_loss(nequip, ncfg, force_weight=FORCE_WEIGHT), pn, gn)
    # invariance and equivariance on the card, at the reference test's
    # tolerances (tests/test_gnn_models.py)
    icfg = dimenet.DimeNetConfig(n_blocks=2, d_hidden=16, n_bilinear=4)
    gi = geometric_graph(20, cutoff=1.8, box=3.0, n_species=4, seed=3,
                         max_edges=96)
    gi["triplets"], gi["triplet_mask"] = build_triplets(
        gi["edge_index"], gi["edge_mask"], max_triplets=256)
    gi = tensors(gi, dev)
    pi_ = h.on(dimenet.init(torch.Generator().manual_seed(2), icfg), dev)
    rot = torch.from_numpy(_random_rotation(
        np.random.default_rng(4))).float().to(dev)
    with torch.no_grad():
        e0 = float(dimenet.apply(pi_, gi, icfg)[0])
        e1 = float(dimenet.apply(pi_, dict(
            gi, positions=gi["positions"] @ rot.T + 2.5), icfg)[0])
    if not abs(e0 - e1) <= 1e-4 * abs(e1):
        fail(f"[dimenet invariance] energy {e0} -> {e1} under a rotation "
             "and translation: outside rtol 1e-4")
    smoke["dimenet_invariance"] = [e0, e1]
    ecfg = nequip.NequIPConfig(n_layers=2, mult=4, n_rbf=4)
    equi = []
    for seed in range(4):
        ge = tensors(geometric_graph(12, cutoff=1.8, box=2.5, n_species=4,
                                     seed=seed, max_edges=64), dev)
        pe = h.on(nequip.init(torch.Generator().manual_seed(seed), ecfg),
                  dev)
        rot = torch.from_numpy(_random_rotation(
            np.random.default_rng(seed + 1))).float().to(dev)
        g2 = dict(ge, positions=ge["positions"] @ rot.T + 1.0)
        with torch.no_grad():
            e0 = float(nequip.apply(pe, ge, ecfg)[0])
            e1 = float(nequip.apply(pe, g2, ecfg)[0])
        f0, f1 = nequip.forces(pe, ge, ecfg), nequip.forces(pe, g2, ecfg)
        f_err = float((f1 - f0 @ rot.T).abs().max())
        if not abs(e0 - e1) < 1e-4 * max(1.0, abs(e0)) or not bool(
                ((f1 - f0 @ rot.T).abs()
                 <= 1e-4 + 1e-3 * (f0 @ rot.T).abs()).all()):
            fail(f"[nequip equivariance] seed {seed}: energy {e0} -> {e1}, "
                 f"rotated forces max|err| {f_err:.3e}")
        equi.append({"seed": seed, "energy": [e0, e1],
                     "forces_max_err": f_err})
    smoke["nequip_equivariance"] = equi
    rec["smoke"] = smoke
    say(f"[geometric smoke] DimeNet and NequIP smoke configs on the card "
        f"within {row} of the CPU (apply, loss, gradients; NequIP's "
        "forces and the force-weighted loss's second-order gradients); "
        "DimeNet invariant within rtol 1e-4, NequIP equivariant (4 seeds, "
        f"forces within 1e-4 + 1e-3·|want|) ({card})")

    # (b) full width at full_graph_sm's size
    meta = gnn_common.SHAPES["full_graph_sm"]
    t = time.perf_counter()
    gg = geometric_graph(meta["n"], cutoff=GEO_CUTOFF, box=GEO_BOX,
                         n_species=16, seed=GEO_SEED, max_edges=meta["e"])
    n_real = int(gg["edge_mask"].sum())
    if n_real != meta["e"]:
        fail(f"[geometric full] the radius graph has {n_real} edges, not "
             f"the budget's {meta['e']}")
    trips, tmask = build_triplets(gg["edge_index"], gg["edge_mask"],
                                  max_triplets=meta["trip"])
    n_trip = int(tmask.sum())
    gen_s = time.perf_counter() - t
    g_nq = tensors(gg)
    g_dn = dict(g_nq, triplets=torch.from_numpy(trips),
                triplet_mask=torch.from_numpy(tmask))
    rec["full_graph"] = {"atoms": meta["n"], "edges": n_real,
                         "box": GEO_BOX, "cutoff": GEO_CUTOFF,
                         "triplets": n_trip, "triplet_budget": meta["trip"],
                         "host_generation_s": gen_s}
    say(f"[geometric full] geometric_graph({meta['n']}, cutoff={GEO_CUTOFF}, "
        f"box={GEO_BOX}, seed={GEO_SEED}): {n_real} edges (the budget "
        f"filled); build_triplets found {n_trip} triplets under the "
        f"{meta['trip']} budget ({gen_s:.1f}s on the host)")
    steppers = []
    full = {}
    for name, model, cfg, g_cpu, pseed in (
            ("dimenet", dimenet, dn_arch.full_config(), g_dn, 31),
            ("nequip", nequip, nq_arch.full_config(), g_nq, 32)):
        label = f"{name} full_graph_sm"
        p_cpu = model.init(torch.Generator().manual_seed(pseed), cfg)
        p_dev, g_dev = h.on(p_cpu, dev), h.on(g_cpu, dev)
        lf = mean_loss(model, cfg)
        shapes = check_shapes(f"{name} full", lf, p_dev, g_dev)
        first = card_vs_cpu(label, lf, p_cpu, g_cpu)
        st, r = run_steps(label, gnn_common.train_step(model, cfg), p_dev,
                          adamw_init(p_dev, gnn_common.OCFG), g_dev,
                          GEO_STEPS, first["loss"])
        flops = (dn_arch if name == "dimenet" else nq_arch)._flops(meta,
                                                                   cfg)
        busy, _, wall = h.idle_share(lambda st=st, g=g_dev: st(g),
                                     f"captured {label} steps",
                                     f"_geo_{name}")
        r.update(first_step=first, edge_aggregate=shapes,
                 tflops=flops / (r["median_ms"] * 1e-3) / 1e12,
                 idle_share=1 - busy / wall if busy > 0 else None)
        if name == "nequip":
            f_dev = nequip.forces(st.params, g_dev, cfg)
            f_cpu = nequip.forces(h.on(st.params, cpu), g_cpu, cfg)
            r["forces_max_err"] = h.within_row(f"{label} forces", f_dev,
                                               f_cpu)
        full[name] = r
        steppers.append((st, g_dev))
        say(f"[{label}] {GEO_STEPS} captured steps (captured in "
            f"{r['capture_s']:.2f}s): loss {r['losses'][0]:.6g} -> "
            f"{r['losses'][-1]:.6g}; median {r['median_ms']:.3f} ms a step, "
            f"{r['tflops']:.3f} TFLOP/s of _flops; peak "
            f"{r['peak_bytes'] / 2**30:.3f} GiB allocated "
            f"({r['step_peak_bytes'] / 2**30:.3f} above what was allocated "
            "before the capture); idle share "
            + ("not measured" if r["idle_share"] is None
               else f"{r['idle_share']:.4f}")
            + f"; {r['edge_aggregate_per_step']} edge_aggregate a step; last "
            f"step against the eager step from its state max|err| "
            f"{r['teacher_forced_max_err']:.3e} ({r['moved_beyond_row']} "
            "parameters moved beyond the row)"
            + (f"; forces card vs CPU max|err| {r['forces_max_err']:.3e}"
               if "forces_max_err" in r else "") + f" ({card})")
    rec["full"] = full

    # (c) the molecule step: 128 graphs of n 30, e 64 at the full configs
    mol_meta = gnn_common.SHAPES["molecule"]
    mol = {}
    for arch_id, model in (("dimenet", dimenet), ("nequip", nequip),
                           ("gatedgcn", gatedgcn),
                           ("graphsage-reddit", graphsage)):
        arch = arch_configs.get_arch(arch_id)
        cfg = arch.full_config("molecule")
        label = f"{arch_id} molecule"
        g_cpu = gnn_common.molecule_graphs(arch_id, seed=GEO_SEED,
                                           device=cpu)
        p_cpu = model.init(torch.Generator().manual_seed(41), cfg)
        p_dev, g_dev = h.on(p_cpu, dev), h.on(g_cpu, dev)
        lf = mean_loss(model, cfg)
        shapes = check_shapes(f"{arch_id} molecule", lf, p_dev, g_dev)
        first = card_vs_cpu(label, lf, p_cpu, g_cpu)
        st, r = run_steps(label, gnn_common.batched_train_step(model, cfg),
                          p_dev, adamw_init(p_dev, gnn_common.OCFG), g_dev,
                          MOLECULE_STEPS, first["loss"])
        r.update(first_step=first, edge_aggregate=shapes,
                 graphs_per_s=mol_meta["batch"] * 1e3 / r["median_ms"])
        mol[arch_id] = r
        steppers.append((st, g_dev))
        say(f"[{label}] {mol_meta['batch']} graphs a step, "
            f"{MOLECULE_STEPS} captured steps: loss {r['losses'][0]:.6g} -> "
            f"{r['losses'][-1]:.6g}; median {r['median_ms']:.3f} ms a step, "
            f"{r['graphs_per_s']:.0f} graphs/s; "
            f"{r['edge_aggregate_per_step']} edge_aggregate a step ({card})")
    rec["molecule"] = mol

    # (d) edge_aggregate's launches from one counted step of each run
    def one_step_each():
        for st, b in steppers:
            st(b)
    _, launches, _ = h.counted(one_step_each, one_step_each, "geometric gnn")
    want = dict.fromkeys(h.wrappers, 0)
    want["edge_aggregate"] = GEO_LAUNCHES
    if launches != want:
        fail(f"[geometric gnn] launch counts {launches} != {want}")
    rec["counted_launches"] = launches
    return rec, launches


# ------------------------------------ phase 15: the multi-device tools ----
# (a) every cell's step on a one-card mesh: the cuts (module docstring,
# item 15); every other cell at its full size, ogb_products only on the
# fake mesh of the dry-run
CELL_LM_TRAIN = (4, 1024)       # phase 13's train cut of train_4k
CELL_LM_PREFILL = (4, 2048)     # phase 13's prefill of prefill_32k
CELL_LM_DECODE = (4, 2112)      # phase 13's decode of decode_32k
CELL_LM_LONG = (1, 32768)       # long_500k's 524288-token cache cut
CELL_SMOKE_ARCHS = ("yi-9b", "granite-34b", "llama4-maverick-400b-a17b")
CELL_MIND_TRAIN = 8192          # phase 13's train_batch cut
# cells whose step and its twin would not fit the card in 60 GiB: on
# the dry-run's fake mesh only
CELL_FAKE_ONLY = {
    "ogb_products": "one graph of 61.9 M edges: a per-edge tensor at "
                    "GatedGCN's d 70 is 17.3 GB, GraphSAGE's first gather "
                    "(d 100) 24.8 GB",
}
# DimeNet's minibatch_lg at half of its 2,097,152 triplets: its 6 blocks
# keep a (T, b.h) product of T x 8 x 128 x 4 B each; a quarter of the
# triplets peaked at 25.1 GiB on the H100 over the step, its warm-up and
# its twin, so half stays under 60 GiB and the full count does not
CELL_DIMENET_TRIPLETS = 1048576
# the GNN cell whose mesh step the profiler counts too (the cheapest)
CELL_COUNTED = "graphsage-reddit:molecule"
# (b) the captured decode cells: decode_32k's B 128 cut to 4, the caches
DECODE_CELL_CACHES = (32768, LM_CACHE)
DECODE_CELL_ARCHS = ("olmo-1b", "granite-moe-1b-a400m")
COMPRESS_ROUNDS = 3


def _cell_inputs(torch, np, dev, arch_id, mod, cell, cfg, seed,
                 feeds=None):
    """Inputs of ``cell`` on the card: the model's weights from a seeded
    generator, AdamW's zero state, and data in each leaf's valid range
    (token and item ids, node and edge indices without self-loops, 0/1
    masks with a tenth off, labels below the class count), or ``feeds``
    (generated events, cut to the cell's batch)."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs.base import sds
    from repro_torch.optim import adamw_init
    gen = torch.Generator(dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    abstract = cell.abstract_args()

    def ints(hi, shape):
        return torch.from_numpy(rng.integers(0, hi, shape).astype(
            np.int32)).to(dev)

    def data(path, s):
        key = path.split("/")[-1] if not path.split("/")[-1].isdigit() \
            else path.split("/")[-2]
        shape = s.shape
        if s.dtype == torch.float32 and key.endswith("mask"):
            return (torch.rand(shape, generator=gen, device=dev)
                    < 0.9).float()
        if key in ("tokens", "labels") and mod.FAMILY == "lm":
            return ints(cfg.vocab, shape)
        if mod.FAMILY == "recsys":
            hi = {"behav_ids": cfg.n_items, "target": cfg.n_items,
                  "cand_ids": cfg.n_items, "tag_ids": cfg.n_user_tags}
            return ints(hi[key], shape)
        if key == "edge_index":
            n = abstract[2]["node_mask"].shape[-1] if "node_mask" in \
                abstract[2] else None
            src = rng.integers(0, n, (*shape[:-2], shape[-1]))
            dst = (src + 1 + rng.integers(0, n - 1, src.shape)) % n
            return torch.from_numpy(np.stack([src, dst], -2).astype(
                np.int32)).to(dev)
        if key == "triplets":
            e = abstract[2]["edge_mask"].shape[-1]
            kj = rng.integers(0, e, (*shape[:-2], shape[-1]))
            ji = (kj + 1 + rng.integers(0, e - 1, kj.shape)) % e
            return torch.from_numpy(np.stack([kj, ji], -2).astype(
                np.int32)).to(dev)
        if key == "edges":        # graphsage's sampled frontiers
            from itertools import accumulate
            f = int(path.split("/")[-1])
            sizes = mod.model.cfg_frontier_sizes(
                cfg, abstract[2]["labels"].shape[-1])
            offs = list(accumulate(sizes, initial=0))
            src = rng.integers(offs[f + 1], offs[f + 1] + sizes[f + 1],
                               (shape[0], shape[-1]))
            dst = rng.integers(offs[f], offs[f] + sizes[f],
                               (shape[0], shape[-1]))
            return torch.from_numpy(np.stack([src, dst], -2).astype(
                np.int32)).to(dev)
        if key == "positions":
            n = shape[-2]
            box = float(n) ** (1 / 3) * 1.6
            return torch.rand(shape, generator=gen, device=dev) * box
        if key == "species":
            return ints(cfg.n_species, shape)
        if key == "labels":
            return ints(max(getattr(cfg, "n_classes", 2), 2), shape)
        if s.dtype == torch.float32:
            return torch.randn(shape, generator=gen, device=dev)
        fail(f"[cells] {arch_id}:{cell.shape} input {path} {s}: no rule")

    if mod.FAMILY == "lm":
        from repro_torch.models import transformer as tr
        params = tr.init_params(gen, cfg)
    elif mod.FAMILY == "recsys":
        from repro_torch.models import recsys as rec
        params = rec.init(gen, cfg)
    else:
        if arch_id == "caloclusternet":
            from repro_torch.core import caloclusternet as model
        else:
            model = mod.model
        cpu_p = model.init(torch.Generator().manual_seed(seed), cfg)
        params = ckpt.unflatten(cpu_p, iter(t.to(dev) for _, t in
                                            ckpt.flatten(cpu_p)))
    args = [params]
    rest = list(abstract[1:])
    if cell.kind == "train":
        from repro_torch.configs import gnn_common, lm_common
        ocfg = (lm_common.opt_config(
            cfg, quantize=arch_id.startswith("llama4"))
            if mod.FAMILY == "lm" else getattr(mod, "OCFG", gnn_common.OCFG))
        args.append(adamw_init(params, ocfg))
        rest = rest[1:]
    for tree in rest:
        if feeds is not None:
            args.append({k: feeds[k][:tree[k].shape[0]].to(dev)
                         for k in tree})
            continue
        if isinstance(tree, sds):
            args.append(data("tokens", tree))
            continue
        if cell.kind == "decode" and "pos" in tree:
            from repro_torch.models import transformer as tr
            b, t = tree["k"].shape[1], tree["k"].shape[2]
            c = tr.init_cache(cfg, b, t, device=dev)
            c["k"].copy_(torch.randn(c["k"].shape, generator=gen,
                                     device=dev))
            c["v"].copy_(torch.randn(c["v"].shape, generator=gen,
                                     device=dev))
            c["pos"].fill_(t - 8)
            args.append(c)
            continue
        named = ckpt.flatten(tree)
        args.append(ckpt.unflatten(tree, iter(data(p, s) for p, s in named)))
    return tuple(args)


def multi_device(torch, np, dev, card, h) -> tuple[dict, dict]:
    """Phase 15: the multi-device tools on one card (module docstring,
    item 15). ``h`` holds ``counted``, ``idle_share``, ``wrappers``,
    ``reset_counts``, ``read_counts``, ``decoded`` (phase 13's decode
    runs, ``lm_and_recsys``) and ``eager_decode_idle_share`` (phase 13's
    idle share of the eager decode_step at B 4 x LM_CACHE, by arch).
    Returns the phase's record and the GNN cells' kernel launches."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import configs as arch_configs
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import lm_common
    from repro_torch.configs.base import distribute, sds
    from repro_torch.dist.sharding import specs_from_rules
    from repro_torch.launch.mesh import destroy_host_mesh, make_host_mesh
    from repro_torch.models import transformer as tr
    from repro_torch.optim.adamw import opt_state_specs, tree_map
    from repro_torch.optim.compress import (compressed_tree_psum,
                                            error_feedback_init)
    from repro_torch.optim.step import value_and_grad
    rec = {"card": card}

    def local(x):
        return x.to_local() if isinstance(x, DTensor) else x

    def same(label, got, want):
        """Every leaf of ``got`` (DTensors read locally) bitwise equal to
        the same leaf of ``want``; a NaN equals a NaN. Returns the
        leaves compared."""
        g_l, w_l = ckpt.flatten(got), ckpt.flatten(want)
        if [n for n, _ in g_l] != [n for n, _ in w_l]:
            fail(f"[{label}] trees differ: {[n for n, _ in g_l][:5]} vs "
                 f"{[n for n, _ in w_l][:5]}")
        for (name, g), (_, w) in zip(g_l, w_l):
            g = local(g)
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"[{label}] {name}: {tuple(g.shape)} {g.dtype} against "
                     f"{tuple(w.shape)} {w.dtype}")
            eq = g == w
            if g.is_floating_point():
                eq = eq | (torch.isnan(g) & torch.isnan(w))
            if not bool(eq.all()):
                d = (g.double() - w.double()).abs()
                fail(f"[{label}] {name}: {int((~eq).sum())} of {g.numel()} "
                     f"entries differ, max|Δ| {float(d.nan_to_num().max()):.3e}")
        return len(g_l)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3

    mesh = make_host_mesh(dev)
    if dist.get_backend() != ("nccl" if dev.type == "cuda" else "gloo") \
            or tuple(mesh.shape) != (1, 1):
        fail(f"[cells] host mesh {mesh}, backend {dist.get_backend()}")
    try:
        # (a) every cell on the one-card mesh ------------------------------
        cells, launches = [], dict.fromkeys(h.wrappers, 0)
        deterministic = torch.are_deterministic_algorithms_enabled()
        fill = torch.utils.deterministic.fill_uninitialized_memory
        # the backward's scatter-adds (index_add_, index_put_) take their
        # sorted, deterministic forms: the step and its twin then differ
        # only if the mesh path changes the arithmetic (new tensors are
        # not filled: every kernel writes its whole output)
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = False
        t_a = time.perf_counter()
        gnn_counted = None
        from repro_torch.data.belle2 import Belle2Config, generate
        from repro_torch.launch.serve import detector_configs
        ccn_feeds = {v: {k: torch.from_numpy(a) for k, a in generate(
            g_, 4096, seed=77).items() if k != "trigger_truth"}
            for v, g_ in (("upgrade", Belle2Config()),
                          ("current", detector_configs("current")[1]))}
        for i, (arch_id, shape, mod) in enumerate(
                arch_configs.all_cells(include_paper=True)):
            t_cell = time.perf_counter()
            why = CELL_FAKE_ONLY.get(shape) or CELL_FAKE_ONLY.get(
                f"{arch_id}:{shape}")
            if why:
                cells.append({"cell": f"{arch_id}:{shape}",
                              "reduced": f"fake mesh only: {why}"})
                continue
            reduced = None
            if mod.FAMILY == "lm":
                smoke = arch_id in CELL_SMOKE_ARCHS
                # the smoke config's widths with the full config's
                # attention and loss chunks (the smoke config's q chunks
                # of 8 make 128 a layer at S 1024)
                cfg = (dataclasses.replace(
                    mod.smoke_config(), block_q=mod.full_config().block_q,
                    loss_chunk=mod.full_config().loss_chunk) if smoke
                    else mod.full_config())
                b, s = {"train_4k": CELL_LM_TRAIN,
                        "prefill_32k": CELL_LM_PREFILL,
                        "decode_32k": CELL_LM_DECODE,
                        "long_500k": CELL_LM_LONG}[shape]
                if shape == "train_4k":
                    cell = lm_common.train_cell(
                        arch_id, cfg, batch=b, seq=s,
                        quantize_opt=arch_id.startswith("llama4"))
                elif shape == "prefill_32k":
                    cell = lm_common.prefill_cell(arch_id, cfg, batch=b,
                                                  seq=s)
                else:
                    cell = lm_common.decode_cell(arch_id, cfg, shape,
                                                 batch=b, seq=s)
                reduced = (f"B {b}, S {s}" + (" at smoke width" if smoke
                                             else ""))
            elif arch_id == "mind" and shape == "train_batch":
                cfg = mod.full_config()
                cell = mod._train_cell(cfg, CELL_MIND_TRAIN)
                reduced = f"B {CELL_MIND_TRAIN} (the logits are B x B)"
            elif (arch_id, shape) == ("dimenet", "minibatch_lg"):
                from repro_torch.configs import gnn_common
                cfg = mod.full_config(shape)
                meta = dict(gnn_common.SHAPES[shape],
                            trip=CELL_DIMENET_TRIPLETS)
                g = gnn_common.graph_sds(meta, geometric=True,
                                         triplets=True)
                cell = gnn_common.make_train_cell(
                    arch_id, shape, mod.model, cfg, g,
                    gnn_common.graph_specs(g, edge_dp=True),
                    model_flops=mod._flops(meta, cfg))
                reduced = (f"{CELL_DIMENET_TRIPLETS:,} of "
                           f"{gnn_common.SHAPES[shape]['trip']:,} triplets")
            else:
                cell = mod.cell(shape)
                cfg = (mod.full_config(shape) if mod.FAMILY == "gnn" else
                       mod.full_config(mod._META[shape]["variant"])
                       if arch_id == "caloclusternet" else mod.full_config())
            torch.cuda.reset_peak_memory_stats()
            t_in = time.perf_counter()
            args = _cell_inputs(
                torch, np, dev, arch_id, mod, cell, cfg, seed=1000 + i,
                feeds=ccn_feeds[mod._META[shape]["variant"]]
                if arch_id == "caloclusternet" else None)
            t_in = time.perf_counter() - t_in
            dargs = distribute(args, cell.resolve_shardings(mesh))
            step_m, step_p = cell.make_step(mesh), cell.make_step(None)
            grad = torch.enable_grad if cell.kind == "train" else \
                torch.no_grad
            with grad():
                step_m(*dargs)                              # warm-up
                h.reset_counts()
                got, ms = timed(lambda: step_m(*dargs))
                used = {k: v for k, v in h.read_counts().items() if v}
                want, plain_ms = timed(lambda: step_p(*args))
            n = same(f"cell {arch_id}:{shape}", got, want)
            for k, v in used.items():
                launches[k] = launches.get(k, 0) + v
            if f"{arch_id}:{shape}" == CELL_COUNTED:
                # the profiler's count of one GNN cell's mesh step
                with grad():
                    _, seen, _ = h.counted(lambda: step_m(*dargs),
                                           lambda: step_m(*dargs),
                                           f"cell {arch_id}:{shape}")
                gnn_counted = {k: v for k, v in seen.items() if v}
            cells.append({"cell": f"{arch_id}:{shape}", "kind": cell.kind,
                          "reduced": reduced, "leaves": n, "ms": ms,
                          "plain_ms": plain_ms, "launches": used,
                          "bitwise": True, "inputs_s": t_in,
                          "peak_gib": torch.cuda.max_memory_allocated()
                          / 2 ** 30,
                          "wall_s": time.perf_counter() - t_cell})
            say(f"[cell {arch_id}:{shape}] one-card mesh step {ms:.3f} ms, "
                f"mesh=None {plain_ms:.3f} ms, {n} outputs bitwise equal"
                + (f"; reduced: {reduced}" if reduced else "")
                + (f"; launches {used}" if used else ""))
            del args, dargs, got, want, step_m, step_p
            torch.cuda.empty_cache()
        torch.use_deterministic_algorithms(deterministic)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        rec["cells"] = cells
        rec["cells_s"] = time.perf_counter() - t_a
        if not gnn_counted:
            fail(f"[cells] {CELL_COUNTED} was not counted under the profiler")
        rec["gnn_cell_counted"] = gnn_counted
        if launches.get("edge_aggregate", 0) == 0:
            fail("[cells] the GNN cells launched no edge_aggregate")
        ran = [c for c in cells if "ms" in c]
        say(f"[cells] {len(ran)} of {len(cells)} cells run on the one-card "
            f"mesh, each bitwise equal to its mesh=None step "
            f"({rec['cells_s']:.1f}s; {len(cells) - len(ran)} on the fake "
            f"mesh only); kernel launches {launches} ({card})")

        # (b) the captured decode cells -----------------------------------
        B, S = LM_PREFILL
        decode = {}
        t_b = time.perf_counter()
        with torch.no_grad():
            setup_s = {}
            for arch_id in DECODE_CELL_ARCHS:
                # phase 13's weights (made again from their seed), tokens
                # and prefill; at LM_CACHE its 64 eager decode_steps from
                # that prefill are the ones held against
                t_setup = time.perf_counter()
                ho = h.decoded[arch_id]
                cfg = arch_configs.get_arch(arch_id).full_config()
                params = tr.init_params(
                    torch.Generator(dev).manual_seed(ho["seed"]), cfg)
                seq, cache_pf = ho["seq"], ho["cache_pf"]
                torch.cuda.synchronize()
                setup_s[arch_id] = time.perf_counter() - t_setup
                for t_len in DECODE_CELL_CACHES:
                    for int8 in (False, True):
                        cfg_ = dataclasses.replace(cfg, kv_cache_int8=int8)
                        tag = (f"{arch_id} decode B {B} cache {t_len} "
                               f"{'int8' if int8 else 'bf16'}")
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                        c = tr.init_cache(cfg_, B, t_len, device=dev)
                        if int8:
                            for n in ("k", "v"):
                                q, sc = tr.quantize_kv(cache_pf[n])
                                c[n][:, :, :S] = q
                                c[f"{n}_scale"][:, :, :S] = sc
                        else:
                            c["k"][:, :, :S] = cache_pf["k"]
                            c["v"][:, :, :S] = cache_pf["v"]
                        c["pos"].fill_(S)
                        phase13 = t_len == LM_CACHE
                        if not phase13:
                            eager_c = {k: v.clone() for k, v in c.items()}
                        t_cfg = time.perf_counter()
                        cap = lm_common.CapturedDecode(params, c, cfg_)
                        toks = [seq[:, S + t:S + t + 1]
                                for t in range(LM_DECODE_STEPS)]
                        (lg0,), cap_first_ms = timed(
                            lambda: (cap(toks[0]).clone(),))
                        if not cap.captured:
                            fail(f"[{tag}] not captured on the card")

                        def replays():
                            return [cap(tk).clone() for tk in toks[1:]]
                        cap_lg, cap_ms = timed(replays)
                        cap_lg = [lg0] + cap_lg
                        cap_peak = torch.cuda.max_memory_allocated()

                        if phase13:
                            eag_lg, eag_c, eag_step_ms = ho[
                                "int8" if int8 else "bf16"]
                        else:
                            held = [eager_c]
                            del eager_c

                            def eager():
                                # the old cache freed as each step
                                # returns its copy: two caches at a time
                                out_ = []
                                for tk in toks:
                                    lg, held[0] = tr.decode_step(
                                        params, held[0], tk, cfg_)
                                    out_.append(lg)
                                return out_, held.pop()
                            (eag_lg, eag_c), eag_ms = timed(eager)
                            eag_step_ms = eag_ms / LM_DECODE_STEPS
                        for t, (a, b_) in enumerate(zip(cap_lg, eag_lg)):
                            same(f"{tag} step {t} logits", a, b_)
                        same(f"{tag} cache", c, eag_c)
                        if int(c["pos"][0, 0]) != S + LM_DECODE_STEPS:
                            fail(f"[{tag}] cache at {int(c['pos'][0, 0])}")
                        r = {"steps": LM_DECODE_STEPS,
                             "capture_and_first_ms": cap_first_ms,
                             "captured_ms_per_step":
                                 cap_ms / (LM_DECODE_STEPS - 1),
                             "eager_ms_per_step": eag_step_ms,
                             "eager_from": "phase 13" if phase13 else
                             "phase 15",
                             "peak_gib": torch.cuda.max_memory_allocated()
                             / 2 ** 30,
                             "captured_peak_gib": cap_peak / 2 ** 30,
                             "cache_gib": sum(v.numel() * v.element_size()
                                              for v in c.values()) / 2 ** 30}
                        r["captured_tokens_per_s"] = \
                            B / r["captured_ms_per_step"] * 1e3
                        r["eager_tokens_per_s"] = \
                            B / r["eager_ms_per_step"] * 1e3
                        del eag_c, eag_lg
                        r["steps_s"] = time.perf_counter() - t_cfg
                        if not int8:
                            # where a step's time goes: the captured step
                            # (the static cache past its end clamps the
                            # write to its last row) and the eager one
                            tk = toks[-1]
                            busy, _, wall = h.idle_share(
                                lambda: cap(tk), f"{tag} captured steps",
                                f"_cell_{arch_id}_{t_len}_captured")
                            r["captured_idle_share"] = (
                                1 - busy / wall if busy > 0 else None)
                            if t_len == LM_CACHE:
                                # phase 13 profiled this eager decode_step
                                # at this shape (bf16 cache of LM_CACHE,
                                # B 4); at 32768 the eager step is
                                # device-bound too (the captured one's
                                # idle share and the two times say it)
                                r["eager_idle_share"] = \
                                    h.eager_decode_idle_share[arch_id]
                                r["eager_idle_share_from"] = "phase 13"
                            r["profile_s"] = (time.perf_counter() - t_cfg
                                              - r["steps_s"])
                        decode[tag] = r
                        say(f"[{tag}] {LM_DECODE_STEPS} steps replayed "
                            f"from one captured step, logits and cache "
                            f"bitwise equal to {LM_DECODE_STEPS} eager "
                            f"decode_steps ({r['eager_from']}'s): captured "
                            f"{r['captured_ms_per_step']:.3f} ms a step "
                            f"({r['captured_tokens_per_s']:.1f} tokens/s), "
                            f"eager {r['eager_ms_per_step']:.3f} ms "
                            f"({r['eager_tokens_per_s']:.1f} tokens/s); "
                            f"idle share captured "
                            f"{r.get('captured_idle_share')}, eager "
                            f"{r.get('eager_idle_share')}; cache "
                            f"{r['cache_gib']:.3f} GiB, peak "
                            f"{r['peak_gib']:.3f} GiB ({card})")
                        del cap, c
                        torch.cuda.empty_cache()
                del params, cache_pf
                torch.cuda.empty_cache()
        rec["decode_cells"] = decode
        rec["decode_setup_s"] = setup_s
        rec["decode_cells_s"] = time.perf_counter() - t_b

        # (c) the compressed all-reduce over the one-rank world -----------
        cfg = arch_configs.get_arch("olmo-1b").smoke_config()
        params = tr.init_params(torch.Generator(dev).manual_seed(5), cfg)
        toks = torch.randint(0, cfg.vocab, (2, 16), device=dev,
                             generator=torch.Generator(dev).manual_seed(6),
                             dtype=torch.int32)
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
        _, grads = value_and_grad(lambda p: tr.loss_fn(p, batch, cfg),
                                  params)
        err = error_feedback_init(grads)
        err_p = error_feedback_init(grads)
        for r_ in range(COMPRESS_ROUNDS):
            g = tree_map(lambda v: v * (r_ + 1), grads)
            out, err = compressed_tree_psum(g, err, dist.group.WORLD, 1)
            # its math in plain PyTorch: with one rank the MAX and SUM
            # reductions are the rank's own values
            flat_p = []
            for (_, x), (_, e) in zip(ckpt.flatten(g), ckpt.flatten(err_p)):
                xf = x.to(torch.float32) + e
                one = torch.full((), 127.0, device=dev)
                scale = torch.clamp_min(torch.amax(torch.abs(xf)),
                                        1e-12) / one
                q = torch.clamp(torch.round(xf / scale), -127, 127)
                flat_p.append((q.to(torch.int32).to(torch.float32) * scale
                               / torch.full((), 1.0, device=dev),
                               xf - q * scale))
            want_o = ckpt.unflatten(g, iter(o for o, _ in flat_p))
            err_p = ckpt.unflatten(g, iter(e for _, e in flat_p))
            same(f"compressed_tree_psum round {r_}", out, want_o)
            same(f"compressed_tree_psum round {r_} error feedback", err,
                 err_p)
        rec["compress"] = {"rounds": COMPRESS_ROUNDS,
                           "leaves": len(ckpt.flatten(grads)),
                           "bitwise": True}
        say(f"[compress] compressed_tree_psum over the one-rank NCCL world, "
            f"{COMPRESS_ROUNDS} rounds of error feedback on olmo-1b's smoke "
            f"gradients ({len(ckpt.flatten(grads))} leaves): bitwise equal "
            f"to its math in plain PyTorch on the card")

        # (d) phase 12's driver checkpoint restored onto the mesh ----------
        ck = OUT / "ckpt" / "failure"
        manifest = json.loads((ck / f"step_{60:08d}" /
                               "manifest.json").read_text())
        like: dict = {}
        for e in manifest["leaves"]:
            node = like
            parts = e["path"].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = sds(tuple(e["shape"]), torch.float32)
        ccn_arch = arch_configs.get_arch("caloclusternet")
        pspecs = specs_from_rules(like["p"], ccn_arch.PARAM_RULES)
        shard = {"p": pspecs, "o": opt_state_specs(pspecs, ccn_arch.OCFG)}
        plain, st = ckpt.restore(str(ck), 60, like, device=dev)
        on_mesh, st_m = ckpt.restore(str(ck), 60, like, mesh=mesh,
                                     shardings=shard)
        n_bytes = 0
        for (name, a), (_, b_) in zip(ckpt.flatten(on_mesh),
                                      ckpt.flatten(plain)):
            if not isinstance(a, DTensor) or a.device_mesh is not mesh:
                fail(f"[restore] {name} is not on the mesh")
            ha = a.to_local().cpu().numpy()
            hb = b_.cpu().numpy()
            if ha.dtype != hb.dtype or ha.tobytes() != hb.tobytes():
                fail(f"[restore] {name}: the bytes differ")
            n_bytes += ha.nbytes
        if st != st_m or st != 60:
            fail(f"[restore] steps {st} {st_m}")
        rec["restore"] = {"leaves": len(ckpt.flatten(plain)),
                          "bytes": n_bytes, "step": st}
        say(f"[restore] phase 12's driver checkpoint (step 60, "
            f"{rec['restore']['leaves']} leaves, {n_bytes} bytes) restored "
            f"onto the one-card mesh with shardings: byte for byte the "
            f"plain restore")
    finally:
        destroy_host_mesh()
    return rec, launches


# ------------------------------------ phase 16: the kernels' last forms ----
FORMS_EVENTS = 64               # the no-concat graph's fp and mixed runs
FORMS_RAGGED_EVENTS = 16        # and its ragged fp run
FORWARD_EVENTS = 4096           # trigger_serve's batch: the four forwards
# the events of the four forwards whose heads may leave the row, each only
# where its kNN selection differs between the card and the CPU at a near
# tie: the devices' denses and distance products round S otherwise, an
# ulp in f32, a bf16 step in bf16. The H100 runs so far saw none in any
# forward; these are a handful in f32 and 1 % in bf16
FORWARD_SWAP_LIMIT = {"f32": 4, "bf16": 41}
# a near tie: the CPU's distances of the two neighbours the devices chose
# for a slot differ by at most this many steps of the forward's dtype
# (its eps) times |s_i|² + |s_j|², the rounding scale of a distance
NEAR_TIE_STEPS = {"f32": 16, "bf16": 4}
FORWARD_OPTIONS = (("topk", "f32"), ("topk", "bf16"), ("onehot", "f32"),
                   ("onehot", "bf16"))


def knn_selections(torch, p, feats, mask, cfg, events=None):
    """The neighbours each hit takes at each GravNet block along
    ``ccn.apply``'s forward of ``cfg`` on ``p`` (both gravnet_impl choose
    the same: top-k of the matrix-product distances, ties to the lowest
    column), -1 in a slot with no candidate; a list of (B, n, k) tensors
    on the CPU. With ``events`` (indices into the batch, which runs
    whole), a list of (idx, d2, sq) of those events: the selections, the
    full masked distances (E, n, n) they were taken from and the squared
    norms |s_i|² (E, n)."""
    from repro_torch.core import caloclusternet as ccn
    from repro_torch.kernels import ref
    from repro_torch.nn.layers import dense_apply
    if cfg.compute_dtype == "bf16":
        feats = feats.to(torch.bfloat16)
        p = {n: {k: t.to(torch.bfloat16) for k, t in q.items()}
             for n, q in p.items()}
    out = []
    with torch.no_grad():
        x = torch.relu(dense_apply(p["enc1"], feats))
        x = torch.relu(dense_apply(p["enc2"], x))
        for i in range(cfg.n_gravnet_blocks):
            s = dense_apply(p[f"gn{i}_s"], x)
            f = dense_apply(p[f"gn{i}_flr"], x)
            d2, idx = ref.knn_topk_ref(s, mask, k=cfg.k)
            idx = torch.where(d2 < 5e29, idx, -1)
            if events is None:
                out.append(idx.cpu())
            else:
                sf = s[events].float()
                out.append((idx[events].cpu(),
                            ref.knn_d2_ref(sf, mask[events]).cpu(),
                            (sf * sf).sum(dim=-1).cpu()))
            x = torch.relu(dense_apply(p[f"gn{i}_out"], torch.cat(
                [x, ccn.aggregate(s, f, mask, cfg)], dim=-1)))
    return out


def near_ties(torch, o, sel_d, sel_c):
    """The swapped events' selections, card (``sel_d``) against CPU
    (``sel_c``), both from :func:`knn_selections` with ``events``: at
    each event's first block whose selections differ, the card's must be
    the lowest-column top-k of its own distances, and each slot the two
    fill otherwise must be a near tie (``NEAR_TIE_STEPS``) on the CPU's
    distances; later blocks follow from the first. Fails otherwise;
    returns the largest such gap, in steps of the dtype's eps times the
    distance's scale."""
    from repro_torch.nn.layers import top_k
    dt = torch.bfloat16 if o[1] == "bf16" else torch.float32
    eps = torch.finfo(dt).eps
    worst = 0.0
    for e in range(len(sel_c[0][0])):
        for blk, ((id_, dd, _), (ic, dc, sq)) in enumerate(zip(sel_d,
                                                               sel_c)):
            id_, ic, dd, dc, sq = id_[e], ic[e], dd[e], dc[e], sq[e]
            if torch.equal(id_, ic):
                continue
            neg, want = top_k(-dd, id_.shape[-1])
            want = torch.where(-neg < 5e29, want, -1)
            if not torch.equal(want, id_):
                fail(f"[forward {o}] block {blk}: the card's selection is "
                     "not the lowest-column top-k of its own distances")
            rows, slots = (id_ != ic).nonzero(as_tuple=True)
            ja, jc = id_[rows, slots], ic[rows, slots]
            if bool((ja < 0).any() | (jc < 0).any()):
                fail(f"[forward {o}] block {blk}: a slot filled on one "
                     "device and empty on the other")
            gap = (dc[rows, ja] - dc[rows, jc]).abs() / (
                eps * (sq[rows] + torch.maximum(sq[ja], sq[jc])))
            worst = max(worst, float(gap.max()))
            if worst > NEAR_TIE_STEPS[o[1]]:
                fail(f"[forward {o}] block {blk}: the devices' neighbours "
                     f"differ by {worst:.1f} steps of the distances' "
                     f"rounding scale, past a near tie "
                     f"({NEAR_TIE_STEPS[o[1]]})")
            break
    return worst


def drop_concat(g, d_hidden):
    """CaloClusterNet's graph with each ``gn{i}_cat`` taken out:
    ``gn{i}_out`` reads ``gn{i}_agg`` and keeps the aggregate's rows of
    its weight, (2·d_f, d_hidden); the fusion pass then fuses each chain
    into a block with ``concat_x=False``."""
    import dataclasses
    g = g.clone()
    for name in [op.name for op in g if op.op_type == "concat"]:
        agg = g.ops.pop(name).inputs[1]
        for op in list(g):
            if name in op.inputs:
                new = dataclasses.replace(
                    op, inputs=[agg if i == name else i for i in op.inputs])
                new.params = dict(op.params,
                                  w=op.params["w"][d_hidden:].contiguous())
                g.ops[op.name] = new
    g.validate()
    return g


def epilogue_forms(torch, np, dev, card, h) -> tuple[dict, dict]:
    """Phase 16: (a) gelu and silu in both denses and both blocks; (b) the
    blocks without concat and the int8 block's int8 output; (c) a
    deployed no-concat graph; (d) CaloClusterNet's four forwards, card
    against CPU. Returns (the record, launches by path)."""
    import dataclasses

    from repro_torch.core import caloclusternet as ccn
    from repro_torch.core.pipeline import Requirements, deploy
    from repro_torch.core.quantization import activation_scale
    from repro_torch.data.belle2 import generate, with_occupancy
    from repro_torch.kernels import f32_cases, int8_cases, ref
    from repro_torch.kernels import gravnet_block as block_mod
    from repro_torch.launch import serve
    cfg, gen_cfg, check = h.cfg, h.gen_cfg, h.check
    rec = {"card": card}
    launches = {}
    t0 = time.perf_counter()

    def t(a):
        return (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                if isinstance(a, np.ndarray) else a)

    def as_args(arrays):
        return [t(a) for a in arrays]

    # (a) gelu and silu, within the float32 row (int8 outputs a step)
    rows = 2 * cfg.n_hits            # a chunk of the fp and mixed paths
    dh, ds, df = cfg.d_hidden, cfg.d_s, cfg.d_flr
    dense_shapes = ((rows, cfg.d_in, dh), (rows, dh, dh), (rows, dh, dh),
                    (rows, dh, cfg.d_decoder),
                    (rows, cfg.d_decoder, sum(cfg.head_dims.values())))
    rng = np.random.default_rng(16)
    for pos, (m, kd, n) in enumerate((*dense_shapes, (4096, 64, 192))):
        x = t(rng.normal(size=(m, kd)).astype(np.float32))
        w = t((rng.normal(size=(kd, n)) / np.sqrt(kd)).astype(np.float32))
        b = t((rng.normal(size=(n,)) * 0.1).astype(np.float32))
        for act in sorted(INEXACT):
            check("epilogues", pos, 2, "fused_dense", [x, w, b],
                  {"activation": act})
    for pos, (m, kd, n) in enumerate(dense_shapes):
        ops_, out_scale = int8_cases.dense_inputs(m, kd, n, seed=pos)
        for act in sorted(INEXACT):
            for out8 in (False, True):
                check("epilogues", pos, 2, "fused_dense_int8",
                      as_args(ops_), dict(activation=act, out_int8=out8,
                                          out_scale=out_scale))
    widths = dict(dh=dh, ds=ds, df=df, dout=dh)
    f_ops = as_args(f32_cases.block_inputs(
        2, cfg.n_hits, **widths, seed=16, n_valid=cfg.n_hits * 3 // 4))
    q_ops, q_sc = int8_cases.block_inputs(2, cfg.n_hits, **widths, seed=16,
                                          n_valid=cfg.n_hits * 3 // 4)
    q_ops = as_args(q_ops)
    y_max = float(ref.gravnet_block_int8_ref(*q_ops, **q_sc, k=cfg.k)
                  .abs().max())
    for act in sorted(INEXACT):
        check("epilogues", 0, 2, "gravnet_block", f_ops,
              dict(k=cfg.k, activation=act))
        for out8 in (False, True):
            check("epilogues", 0, 2, "gravnet_block_int8", q_ops,
                  dict(q_sc, k=cfg.k, activation=act, out_int8=out8,
                       out_scale=activation_scale(y_max)))
    say(f"[epilogues] gelu and silu within the float32 row of the plain "
        f"versions (int8 outputs within a step) ({card})")

    # (b) the blocks without concat and the int8 output, bitwise
    def agg_only(ops_, d):
        return [o[d:].contiguous() if i == 6 else o
                for i, o in enumerate(ops_)]
    # (tag, events, hits, widths, k, valid hits, duplicated rows)
    f32_shapes = [("chunk", 2, cfg.n_hits, widths, cfg.k, 96, 2),
                  ("current detector", 8, 32, widths, cfg.k, 24, 2)]
    for case in ("n600_past_the_register_cell",
                 "df129_past_the_register_cell"):
        b_, n_, dh_, ds_, df_, dout_, k_, nv, dup, _ = \
            f32_cases.GRAVNET_CASES[case]
        f32_shapes.append((case, b_, n_, dict(dh=dh_, ds=ds_, df=df_,
                                              dout=dout_), k_, nv, dup))
    for tag, b_, n_, w_, k_, nv, dup in f32_shapes:
        ops_ = agg_only(as_args(f32_cases.block_inputs(
            b_, n_, **w_, seed=len(tag), n_valid=nv, dup=dup)), w_["dh"])
        bm, cell = block_mod.plan(n_, *w_.values(), concat_x=False)
        want = block_mod.smem_bytes(n_, *w_.values(), bm, cell,
                                    concat_x=False)
        lib = block_mod.library_smem_bytes(n_, *w_.values(), bm,
                                           concat_x=False)
        if lib != want:
            fail(f"gravnet_block without concat at {tag}: the plan's "
                 f"{want} B of shared memory, the library's {lib}")
        check(f"agg only: {tag} ({cell} cell)", 0, b_, "gravnet_block",
              ops_, dict(k=k_, concat_x=False))
    for tag, b_, n_ in (("chunk", 2, cfg.n_hits), ("current detector", 8,
                                                   32)):
        q_, sc_ = int8_cases.block_inputs(b_, n_, **widths, seed=len(tag),
                                          n_valid=n_ * 3 // 4, dup=2)
        q_ = as_args(q_)
        y_max = float(ref.gravnet_block_int8_ref(*q_, **sc_, k=cfg.k)
                      .abs().max())
        check(f"agg only: {tag}", 0, b_, "gravnet_block_int8",
              agg_only(q_, dh), dict(sc_, k=cfg.k, concat_x=False))
        for out_scale in (activation_scale(y_max), 1e38):
            for cx in (True, False):
                check(f"int8 out: {tag}", 0, b_, "gravnet_block_int8",
                      q_ if cx else agg_only(q_, dh),
                      dict(sc_, k=cfg.k, concat_x=cx, out_int8=True,
                           out_scale=out_scale))
    say(f"[forms] the blocks without concat (both cells of the f32 block) "
        f"and the int8 block's int8 output (quotients below the normal "
        f"range at out_scale 1e38) bitwise with their plain versions "
        f"({card})")

    # (c) a deployed graph whose gn{i}_out reads the aggregate alone
    nc_params = ccn.init(torch.Generator().manual_seed(17), cfg)
    calib = serve.calibration_feeds(gen_cfg)

    def build(prec, **kw):
        """The no-concat graph, exported afresh, deployed at design point
        3 as serve.build_pipeline deploys (its CPU cost constants)."""
        req = Requirements(design_point=3, platform="cpu",
                           precision_policy=prec, n_hits=cfg.n_hits,
                           target_throughput=serve.TARGET_THROUGHPUT,
                           max_latency_s=2e-3)
        graph = drop_concat(ccn.to_graph(nc_params, cfg), dh)
        return deploy(graph, req, calibration_feeds=(
            calib if prec == "mixed" else None), device=dev, **kw)

    block_of = {"fp": "gravnet_block", "mixed": "gravnet_block_int8"}
    dense_of = {"fp": "fused_dense", "mixed": "fused_dense_int8"}
    occ = generate(with_occupancy(gen_cfg, RAGGED_OCCUPANCY),
                   FORMS_RAGGED_EVENTS, seed=17)
    runs = (("no-concat fp", "fp", {}, FORMS_EVENTS),
            ("no-concat mixed", "mixed", {}, FORMS_EVENTS),
            ("no-concat ragged", "fp", dict(ragged=True, batch=RAGGED_BINS),
             FORMS_RAGGED_EVENTS))
    for label, prec, kw, n_ev in runs:
        pipe = build(prec, **kw)
        g = pipe.pipe.graph if kw else pipe.graph
        blocks = [op for op in g if op.op_type == "gravnet_block"]
        if len(blocks) != 2 or any(op.attrs["concat_x"] for op in blocks):
            fail(f"[{label}] deployed {len(blocks)} blocks, concat_x "
                 f"{[op.attrs['concat_x'] for op in blocks]}")
        if kw:
            feeds = {"hits": occ["feats"], "mask": occ["mask"]}
        else:
            ev = generate(gen_cfg, n_ev, seed=17)
            feeds = {"hits": ev["feats"], "mask": ev["mask"]}

        def warm(pipe=pipe, feeds=feeds):
            serve.serve_events(pipe, {k: v[:DISPATCH]
                                      for k, v in feeds.items()})
        warm()
        (res, _, _), seen, _ = h.counted(
            lambda pipe=pipe, feeds=feeds: serve.serve_events(pipe, feeds),
            warm, label)
        launches[label] = seen
        step = max(pipe.microbatch, serve.MIN_SERVE_BATCH)
        counts = feeds["mask"].sum(axis=1).astype(int)
        if kw:
            n_unit = sum(len(pipe._plan_launches(counts[s:s + step]))
                         for s in range(0, n_ev, step))
            dense = (sum(op.op_type in ("dense", "linear") for op in g)
                     + 3 * len(blocks))
            want = dict(fused_dense=dense * n_unit, knn_build=2 * n_unit,
                        knn_aggregate=2 * n_unit)
        else:
            n_unit = sum(-(-min(step, n_ev - s) // pipe.microbatch)
                         for s in range(0, n_ev, step))
            want = {block_of[prec]: 2 * n_unit, dense_of[prec]: 5 * n_unit}
        want = {**dict.fromkeys(seen, 0), **want}
        if seen != want:
            fail(f"[{label}] launch counts {seen} != {want}")
        with h.substituted(h.plain_fns):
            plain_pipe = build(prec, **kw)
            plain_res, _, _ = serve.serve_events(Eager(plain_pipe), feeds)
        if prec == "mixed":
            for op in blocks:
                pop = plain_pipe.graph[op.name]
                if any(op.attrs[a] != pop.attrs[a] for a in
                       ("in_scale", "agg_scale", "h_scale")):
                    fail(f"[{label}] {op.name}: the scales calibrated "
                         "with the kernels differ from the plain versions'")
        h.heads_and_cps(res, plain_res, n_ev, label, bitwise=True,
                        every_cps=bool(kw))
        say(f"[{label}] {n_ev} events, {n_unit} "
            f"{'launches' if kw else 'chunks'}: launches "
            f"{({k: v for k, v in seen.items() if v})}, heads and CPS "
            f"bitwise with the plain-substituted deployment ({card})")
    rec["no_concat"] = {k: {n: c for n, c in v.items() if c}
                        for k, v in launches.items()}

    # (d) the four forwards at the upgrade width, card against CPU: the
    # card's timed first, then the CPU's, so that no timing shares the
    # host with them
    p_cpu = ccn.init(torch.Generator().manual_seed(16), cfg)
    fwd_ev = generate(gen_cfg, FORWARD_EVENTS, seed=16)
    feats_c = torch.from_numpy(fwd_ev["feats"])
    mask_c = torch.from_numpy(fwd_ev["mask"])

    def option(impl, dt):
        return dataclasses.replace(cfg, gravnet_impl=impl, compute_dtype=dt)

    p_dev = {n: {k: v.to(dev) for k, v in q.items()}
             for n, q in p_cpu.items()}
    feats_d, mask_d = feats_c.to(dev), mask_c.to(dev)
    heads = ("beta_logit", "coords", "energy", "cls_logits")
    card_out, ms = {}, {}
    with torch.no_grad():
        for o in FORWARD_OPTIONS:
            c = option(*o)
            card_out[o] = ccn.apply(p_dev, feats_d, mask_d, c)
            ms[o] = h.timer.device_ms(
                lambda c=c: ccn.apply(p_dev, feats_d, mask_d, c), 5)
        cpu_out = {o: ccn.apply(p_cpu, feats_c, mask_c, option(*o))
                   for o in FORWARD_OPTIONS}
    rec["forwards"] = {}
    for o in FORWARD_OPTIONS:
        c = option(*o)
        bf16 = o[1] == "bf16"
        rtol, atol = (BF16_RTOL, BF16_ATOL) if bf16 else (RTOL, ATOL)
        bad = torch.zeros(FORWARD_EVENTS, dtype=torch.bool)
        worst = 0.0
        for hd in heads:
            g_ = card_out[o][hd].double().cpu()
            w_ = cpu_out[o][hd].double()
            if not bool(torch.isfinite(g_).all()) or g_.shape != w_.shape:
                fail(f"[forward {o}] {hd}: non-finite or shape "
                     f"{tuple(g_.shape)} against {tuple(w_.shape)}")
            err = (g_ - w_).abs()
            out_ = (err > atol + rtol * w_.abs()).reshape(
                FORWARD_EVENTS, -1).any(dim=1)
            bad |= out_
            worst = max(worst, float(err.reshape(FORWARD_EVENTS, -1)[
                ~out_].max()))
        n_swapped = int(bad.sum())
        if n_swapped > FORWARD_SWAP_LIMIT[o[1]]:
            fail(f"[forward {o}] {n_swapped} of {FORWARD_EVENTS} events "
                 f"leave the {'bfloat16' if bf16 else 'float32'} row "
                 f"(at most {FORWARD_SWAP_LIMIT[o[1]]} may, at a near tie)")
        gap = None
        if n_swapped:
            # both devices' selections from the whole batch, as their
            # forwards ran it (a library may round another batch size
            # otherwise)
            ev_ = bad.nonzero()[:, 0]
            sel_d = knn_selections(torch, p_dev, feats_d, mask_d, c,
                                   events=ev_.to(dev))
            sel_c = knn_selections(torch, p_cpu, feats_c, mask_c, c,
                                   events=ev_)
            same = torch.ones(n_swapped, dtype=torch.bool)
            for (a_, *_), (b_, *_) in zip(sel_d, sel_c):
                same &= (a_ == b_).reshape(n_swapped, -1).all(dim=1)
            if bool(same.any()):
                fail(f"[forward {o}] {int(same.sum())} events leave the "
                     f"{'bfloat16' if bf16 else 'float32'} row with the "
                     "same neighbours on the card and the CPU")
            gap = near_ties(torch, o, sel_d, sel_c)
        keep = ~bad
        cps_ok = None
        if not bf16:
            cd = ccn.cps({k: v[keep.to(dev)] for k, v in card_out[o].items()},
                         mask_d[keep.to(dev)], c)
            cc = ccn.cps({k: v[keep] for k, v in cpu_out[o].items()},
                         mask_c[keep], c)
            for k in ("n_clusters", "trigger"):
                if not torch.equal(cd[k].cpu(), cc[k]):
                    fail(f"[forward {o}] CPS {k} differs between the card "
                         "and the CPU")
            cps_ok = True
        rec["forwards"][f"{o[0]} {o[1]}"] = {
            "ms": ms[o], "max_abs_err": worst, "swapped_events": n_swapped,
            "near_tie_steps": gap, "cps_bitwise": cps_ok}
        say(f"[forward {o[0]} {o[1]}] {FORWARD_EVENTS} events: {ms[o]:.3f} "
            f"ms a call on the card; heads within the "
            f"{'bfloat16' if bf16 else 'float32'} row of the CPU "
            f"(max|err| {worst:.3e}) on {FORWARD_EVENTS - n_swapped} "
            f"events, {n_swapped} with a neighbour swapped by a near tie"
            + (f" (at most {gap:.2f} steps apart)" if n_swapped else "")
            + ("; n_clusters and trigger bitwise" if cps_ok else "")
            + f" ({card})")
    rec["phase_s"] = time.perf_counter() - t0
    return rec, launches


# ----------------------------------------- phase 17: the bf16 forms ----
# the executor's bf16-tagged dense: events of (rows, K) through one dense
# of K -> N (GatedGCN's (256, 70) -> 70), 8 events a micro-batch
BF16_EXEC_EVENTS, BF16_EXEC_ROWS, BF16_EXEC_K, BF16_EXEC_N = 32, 256, 70, 70
BF16_EXEC_BATCH = 8


def bf16_forms(torch, np, dev, card, h) -> dict:
    """Phase 17: the kernels' bf16 operand and output forms. (a) every
    form at the path shapes and on ``kernels/bf16_cases.py``'s inputs,
    bitwise with its plain version with a bf16 and an f32 output (the
    int8 block: f32 and int8), and each kernel once from f32 operands
    into bf16; (b) each bf16 form timed beside its f32 form at the same
    shape, with its bound (2 bytes a bf16 element) and, for the dense,
    ``addmm`` on the bf16 operands; (c) one call of each kernel (and the
    chunked edge sum) under the profiler: only its own kernel runs on
    the card, no conversion; (d) a dense tagged bf16 through the
    executor of a deployment, eager and captured, against the
    plain-substituted deployment; (e) ``autotune`` and
    ``warm_from_cache`` on bf16-keyed dense, GravNet and edge problems.
    Returns the record."""
    from repro_torch.core.graph_ir import Graph, Operator
    from repro_torch.core.pipeline import Requirements, deploy
    from repro_torch.core.quantization import activation_scale
    from repro_torch.kernels import bf16_cases, f32_cases, int8_cases, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.edge_aggregate import chunk_plan
    from repro_torch.kernels.f32_cases import EDGE_NODES
    from repro_torch.kernels.fused_dense import fused_dense_cuda
    from repro_torch.tuning import TuningCache, autotune, warm_from_cache
    cfg, check, timer = h.cfg, h.check, h.timer
    bf16, f32 = torch.bfloat16, torch.float32
    rec = {"card": card, "forms": []}
    t0 = time.perf_counter()

    def on(a, dt=f32):
        """A numpy array (None passes) on the card in dt; float arrays
        only are converted (on the host: exact on the bf16 grid)."""
        if a is None:
            return None
        x = torch.from_numpy(np.ascontiguousarray(a))
        return (x.to(dt) if x.is_floating_point() else x).to(dev)

    def args_in(arrays, dt, keep=()):
        """The arrays as kernel operands, floats in dt but those at the
        positions of ``keep`` (masks, d2, the int8 block's weights and
        scales), which stay as they are."""
        return [on(a) if i in keep else on(a, dt)
                for i, a in enumerate(arrays)]

    def form(label, name, make, kw, outs=(None, f32)):
        """A bf16 form: ``make(dtype)`` gives the operands with the float
        ones in that dtype. Checked bitwise and timed with each output of
        ``outs``; its f32 form timed at the same shape."""
        args = make(bf16)
        rows = []
        for out in outs:
            kw_ = dict(kw, **out) if isinstance(out, dict) else (
                kw if out is None else dict(kw, out_dtype=out))
            rows.append(check(f"bf16 {label}", 0, args[0].shape[0], name,
                              args, kw_))
        args32 = make(f32)
        kw32 = dict(kw, **outs[0]) if isinstance(outs[0], dict) else kw
        f32_ms = timer.device_ms(lambda: h.wrappers[name](*args32, **kw32),
                                 200)
        f32_bound, _ = bound(*cost(name, args32, kw32))
        # the same function as a cast of the bf16 operands, then the f32
        # form into the bf16 form's output dtype
        kw_cast = dict(kw32) if outs[0] is not None or name == "knn_build" \
            else dict(kw32, out_dtype=bf16)
        cast_ms = timer.device_ms(lambda: h.wrappers[name](*[
            a.float() if a is not None and a.dtype == bf16 else a
            for a in args], **kw_cast), 200)
        r = rows[0]
        other = [x["ms"] for x in rows[1:]]
        rec["forms"].append({
            "form": label, "kernel": name, "shape": r["shape"],
            "ms": r["ms"], "ms_other_out": other, "f32_form_ms": f32_ms,
            "cast_then_f32_ms": cast_ms,
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "f32_form_bound_ms": f32_bound, "plain_ms": r["plain_ms"],
            "library_ms": r["library_ms"], "library": r["library"]})
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.5f}"
        say(f"[bf16] {label}: {name} {r['shape']}: {r['ms']:.5f} ms (other "
            f"out {' '.join(f'{v:.5f}' for v in other)}; the f32 form "
            f"{f32_ms:.5f}; cast, then the f32 form {cast_ms:.5f}), bound {r['bound_ms']:.7f} ({r['bound_by']}; "
            f"f32 form {f32_bound:.7f}), plain {r['plain_ms']:.5f}, "
            f"library {lib} ({card})")

    # (a), (b) at the path shapes
    rng = np.random.default_rng(17)
    rows = 2 * cfg.n_hits            # a chunk of the fp path
    dh, ds, df = cfg.d_hidden, cfg.d_s, cfg.d_flr
    dense_shapes = ((rows, cfg.d_in, dh), (rows, dh, dh), (rows, dh, dh),
                    (rows, dh, cfg.d_decoder),
                    (rows, cfg.d_decoder, sum(cfg.head_dims.values())),
                    (4096, 64, 192))
    for pos, (m, kd, n) in enumerate(dense_shapes):
        x, w, b_ = (bf16_cases.bf16_values(a) for a in (
            rng.normal(size=(m, kd)), rng.normal(size=(kd, n)) / np.sqrt(kd),
            rng.normal(size=(n,)) * 0.1))
        label = "attention dense" if pos == 5 else f"fp dense {pos}"
        form(label, "fused_dense",
             lambda dt, x=x, w=w, b_=b_: args_in((x, w, b_), dt),
             {"activation": "relu"})
    widths = dict(dh=dh, ds=ds, df=df, dout=dh)
    for tag, bsz, n in (("fp chunk", 2, cfg.n_hits),
                        ("current detector", 8, 32)):
        ops_ = [bf16_cases.bf16_values(a) if i != 1 else a
                for i, a in enumerate(f32_cases.block_inputs(
                    bsz, n, **widths, seed=bsz, n_valid=n * 3 // 4, dup=2))]
        form(f"block, {tag}", "gravnet_block",
             lambda dt, o=ops_: args_in(o, dt, keep=(1,)), {"k": cfg.k})
        q_ops, q_sc = int8_cases.block_inputs(bsz, n, **widths, seed=bsz,
                                              n_valid=n * 3 // 4, dup=2)
        q_ops = [bf16_cases.bf16_values(q_ops[0]), *q_ops[1:]]
        y_max = float(ref.gravnet_block_int8_ref(
            *args_in(q_ops, f32), **q_sc, k=cfg.k).abs().max())
        form(f"int8 block x, {tag}", "gravnet_block_int8",
             lambda dt, o=q_ops: args_in(o, dt, keep=range(1, 11)),
             dict(q_sc, k=cfg.k),
             outs=({}, {"out_int8": True,
                        "out_scale": activation_scale(y_max)}))
    for bsz in (1, 16):
        agg_path = [bf16_cases.bf16_values(a) if i < 2 else a
                    for i, a in enumerate(f32_cases.aggregate_inputs(
                        bsz, cfg.n_hits, ds=ds, df=df, seed=bsz, n_valid=96,
                        dup=2))]
        form(f"aggregate, {bsz} event(s)", "gravnet_aggregate",
             lambda dt, o=agg_path: args_in(o, dt, keep=(2,)), {"k": cfg.k})
    s_, seg = f32_cases.knn_build_inputs(f32_cases.knn_path_bins(RAGGED_BINS),
                                         cfg.n_hits, ds, cfg.k, "grid", 0,
                                         seed=17)
    s_ = bf16_cases.bf16_values(s_)
    form("kNN build, 8 bins", "knn_build",
         lambda dt: args_in((s_, seg), dt), {"k": cfg.k}, outs=(None,))
    idx, d2 = ref.knn_build_ref(on(s_, bf16), on(seg), k=cfg.k)
    kf, kidx = f32_cases.knn_aggregate_inputs(idx.cpu().numpy(), cfg.n_hits,
                                              df, False, seed=17)
    kf = bf16_cases.bf16_values(kf)
    kd2 = d2.cpu().numpy()
    form("kNN aggregate, 8 bins", "knn_aggregate",
         lambda dt: args_in((kf, kidx, kd2), dt, keep=(1, 2)), {})
    for tag, bsz, d, reduce in (("GatedGCN", 1, 70, "sum"),
                                ("GraphSAGE", 8, 16, "mean"),
                                ("GraphSAGE", 8, 128, "mean")):
        msg, dst, mask = f32_cases.edge_inputs(bsz, 256, d, "random",
                                               seed=d)
        mask = (mask > 0).astype(np.float32)      # the routes' 0/1 masks
        msg = bf16_cases.bf16_values(msg)
        form(f"edge, {tag}", "edge_aggregate",
             lambda dt, a=(msg, dst, mask): args_in(a, dt, keep=(1, 2)),
             {"n_nodes": EDGE_NODES, "reduce": reduce})
    # (a) on the edge inputs
    for name in bf16_cases.DENSE_CASES:
        x, w, b_, act = bf16_cases.dense_inputs(name, seed=len(name))
        kd = w.shape[0]
        form(f"dense {name}", "fused_dense",
             lambda dt, x=x, w=w, b_=b_, kd=kd: [
                 on(x, dt)[:, :kd], on(w, dt), on(b_, dt)],
             {"activation": act})
    for name in bf16_cases.GRAVNET_CASES:
        block, agg, k = bf16_cases.gravnet_inputs(name, seed=len(name))
        form(f"block {name}", "gravnet_block",
             lambda dt, o=block: args_in(o, dt, keep=(1,)), {"k": k})
        form(f"aggregate {name}", "gravnet_aggregate",
             lambda dt, o=agg: args_in(o, dt, keep=(2,)), {"k": k})
    for name in bf16_cases.KNN_CASES:
        s_c, seg_c, k = bf16_cases.knn_build_inputs(name, seed=len(name))
        form(f"kNN build {name}", "knn_build",
             lambda dt, a=(s_c, seg_c): args_in(a, dt), {"k": k},
             outs=(None,))
        idx_c, d2_c = ref.knn_build_ref(on(s_c, bf16), on(seg_c), k=k)
        f_c, idx_c = bf16_cases.knn_aggregate_inputs(
            name, idx_c.cpu().numpy(), seed=len(name),
            extreme=name == "occupancy_33_65_97")
        form(f"kNN aggregate {name}", "knn_aggregate",
             lambda dt, a=(f_c, idx_c, d2_c.cpu().numpy()): args_in(
                 a, dt, keep=(1, 2)), {})
    for name in bf16_cases.EDGE_CASES:
        msg, dst, mask = bf16_cases.edge_inputs(name, seed=len(name))
        for reduce in ("sum", "mean"):
            form(f"edge {name} {reduce}", "edge_aggregate",
                 lambda dt, a=(msg, dst, mask): args_in(a, dt, keep=(1, 2)),
                 {"n_nodes": EDGE_NODES, "reduce": reduce})
    # each kernel once from f32 operands into a bf16 output
    x, w, b_ = (bf16_cases.bf16_values(a) for a in (
        rng.normal(size=(rows, dh)), rng.normal(size=(dh, dh)) / 8,
        rng.normal(size=(dh,))))
    f32_to_bf16 = {
        "fused_dense": ([x, w, b_], (), {"activation": "relu"}),
        "gravnet_block": (f32_cases.block_inputs(2, cfg.n_hits, **widths,
                                                 seed=5), (1,),
                          {"k": cfg.k}),
        "gravnet_aggregate": (f32_cases.aggregate_inputs(
            2, cfg.n_hits, ds=ds, df=df, seed=5), (2,), {"k": cfg.k}),
        "knn_aggregate": ([kf.astype(np.float32), kidx, kd2], (1, 2), {}),
        "edge_aggregate": (list(f32_cases.edge_inputs(8, 256, 16, "random",
                                                      seed=5)), (1, 2),
                           {"n_nodes": EDGE_NODES}),
    }
    for name, (arrays, keep, kw) in f32_to_bf16.items():
        check("f32 in, bf16 out", 0, arrays[0].shape[0], name,
              args_in(arrays, f32, keep), dict(kw, out_dtype=bf16))
    say(f"[bf16] every form bitwise with its plain version, both output "
        f"dtypes ({len(rec['forms'])} forms) ({card})")

    # (c) one call of each under the profiler: its kernel alone
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def device_records(call, host_ops=None):
        """The names of the card's records of one warm ``call``, between
        sentinel kernels; ``host_ops`` (a list) takes the host's."""
        call()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            h.sentinels()
            call()
            torch.cuda.synchronize()
            h.sentinels()
        cuda = torch.autograd.DeviceType.CUDA
        if host_ops is not None:
            host_ops.extend(e.name for e in prof.events()
                            if e.device_type != cuda)
        return [e.name for e in prof.events() if e.device_type == cuda]

    sleep_names = set(device_records(lambda: torch.cuda._sleep(1)))
    msg30, dst30, mask30 = bf16_cases.edge_inputs("past_one_launch", seed=3)
    e30 = msg30.shape[1]
    only = [
        ("fused_dense", [on(x, bf16)[:, :dh], on(w, bf16), on(b_, bf16)],
         {}, 1),
        ("gravnet_block", args_in(f32_cases.block_inputs(
            2, cfg.n_hits, **widths, seed=6), bf16, keep=(1,)),
         {"k": cfg.k}, 1),
        ("gravnet_block_int8", args_in(q_ops, bf16, keep=range(1, 11)),
         dict(q_sc, k=cfg.k), 1),
        ("gravnet_aggregate", args_in(agg_path, bf16, keep=(2,)),
         {"k": cfg.k}, 1),
        ("knn_build", args_in((s_, seg), bf16), {"k": cfg.k}, 1),
        ("knn_aggregate", args_in((kf, kidx, kd2), bf16, keep=(1, 2)), {},
         1),
        ("edge_aggregate", args_in((msg30, dst30, mask30), bf16,
                                   keep=(1, 2)),
         {"n_nodes": EDGE_NODES, "reduce": "mean"}, len(chunk_plan(e30))),
    ]
    rec["launches_only_its_kernel"] = {}
    for name, args, kw, n_launch in only:
        names = [n_ for n_ in device_records(
            lambda: h.wrappers[name](*args, **kw)) if n_ not in sleep_names]
        ours = [n_ for n_ in names if h.kernel_rx[name].search(n_)]
        if len(ours) != n_launch or len(names) != n_launch:
            fail(f"[bf16] one {name} call ran {names} on the card; want "
                 f"{n_launch} launch(es) of its kernel and nothing else")
        rec["launches_only_its_kernel"][name] = names
    say(f"[bf16] under the profiler each call runs only its kernel on the "
        f"card (the bf16 edge mean over {e30} edges: "
        f"{len(chunk_plan(e30))} launches, f32 sums and counts carried, "
        f"rounded once), no conversion kernel ({card})")

    # (d) a dense tagged bf16 through the executor, eager and captured
    g = Graph()
    g.add(Operator(name="x", op_type="input", out_dim=BF16_EXEC_K,
                   attrs={"feature": "x"}))
    g.add(Operator(name="d", op_type="dense", inputs=["x"], params={
        "w": torch.tensor(rng.normal(size=(BF16_EXEC_K, BF16_EXEC_N))
                          / np.sqrt(BF16_EXEC_K), dtype=f32),
        "b": torch.tensor(rng.normal(size=(BF16_EXEC_N,)) * 0.1,
                          dtype=f32)},
        out_dim=BF16_EXEC_N, attrs={"activation": "relu"}))
    g.add(Operator(name="out", op_type="output", inputs=["d"],
                   attrs={"head_names": ["y"]}, out_dim=BF16_EXEC_N))
    req = Requirements(design_point=3, platform="cpu",
                       precision_policy="fp", n_hits=BF16_EXEC_ROWS,
                       target_throughput=1e3)

    def tagged():
        """The graph deployed on the card, its dense then tagged bf16
        (before the first call captures it)."""
        pipe = deploy(g, req, batch=BF16_EXEC_BATCH, device=dev)
        denses = [op for op in pipe.graph
                  if op.op_type in ("dense", "linear")]
        for op in denses:
            op.precision = "bf16"
        return pipe, len(denses)

    feeds = {"x": rng.normal(size=(BF16_EXEC_EVENTS, BF16_EXEC_ROWS,
                                   BF16_EXEC_K)).astype(np.float32)}
    pipe, n_dense = tagged()
    seen = []

    def recorder(x_, w_, b__=None, **kw):
        y = fused_dense_cuda(x_, w_, b__, **kw)
        seen.append((x_.dtype, w_.dtype, b__.dtype, y.dtype))
        return y
    with h.substituted({"fused_dense": recorder}):
        pipe.run_eager(feeds)
    if not seen or set(seen) != {(bf16,) * 4}:
        fail(f"[bf16 executor] the dense's kernel calls took {set(seen)}")
    n_mb = -(-BF16_EXEC_EVENTS // pipe.microbatch)
    h.reset_counts()
    eager = pipe.run_eager(feeds)
    torch.cuda.synchronize()
    launched = h.read_counts()
    want = {**dict.fromkeys(launched, 0), "fused_dense": n_dense * n_mb}
    if launched != want or n_dense != 1:
        fail(f"[bf16 executor] launches {launched} over {n_mb} "
             f"micro-batches of {n_dense} dense(s), want {want}")
    # one warm micro-batch under the profiler: w and b were cast once, so
    # its conversions are the two the graph asks for (x to bf16 at the
    # dense, the dense's output to f32 at the output op)
    mb_feeds = pipe._chunks(feeds)[2][0]
    host_ops = []
    mb_kernels = [n_ for n_ in device_records(
        lambda: pipe.run_chunk(mb_feeds), host_ops) if n_ not in sleep_names]
    casts = host_ops.count("aten::_to_copy")
    ours = [n_ for n_ in mb_kernels if h.kernel_rx["fused_dense"].search(n_)]
    if casts != 2 or len(ours) != 1:
        fail(f"[bf16 executor] one micro-batch ran {casts} conversions "
             f"and the device kernels {mb_kernels}; want 2 conversions "
             "(x in, the output out) and one fused_dense launch")
    captured = pipe(feeds)
    torch.cuda.synchronize()
    with h.substituted({"fused_dense": ref.fused_dense_ref}):
        plain_pipe, _ = tagged()
        plain = plain_pipe.run_eager(feeds)
    for label, other in (("captured", captured), ("plain-substituted",
                                                  plain)):
        if not torch.equal(eager["y"], other["y"]):
            fail(f"[bf16 executor] eager and {label} outputs differ: "
                 f"max|err| {(eager['y'] - other['y']).abs().max():.3e}")
    rec["executor"] = {"events": BF16_EXEC_EVENTS,
                       "microbatch": pipe.microbatch,
                       "launches": launched["fused_dense"],
                       "microbatch_conversions": casts,
                       "microbatch_kernels": mb_kernels,
                       "captures": pipe.captures}
    say(f"[bf16 executor] a dense tagged bf16 ({BF16_EXEC_EVENTS} events of "
        f"({BF16_EXEC_ROWS}, {BF16_EXEC_K}) -> {BF16_EXEC_N}): bf16 x, w, b "
        f"and output, {launched['fused_dense']} fused_dense launches for "
        f"{n_mb} micro-batches, captured = eager = plain-substituted "
        f"bitwise; a micro-batch runs {len(mb_kernels)} device kernels, of "
        f"them {casts} conversions, w and b cast once ({card})")

    # (e) the tuner and the warm-up on bf16 problems
    tc = TuningCache()
    spied = []
    names = ("fused_dense", "gravnet_aggregate_batched",
             "edge_aggregate_batched")
    saved = {n_: getattr(kops, n_) for n_ in names}

    def spy(n_):
        def call(*a, **kw):
            spied.append((n_, a[0].dtype))
            return saved[n_](*a, **kw)
        return call
    try:
        for n_ in names:
            setattr(kops, n_, spy(n_))
        autotune.tune_fused_dense(4096, 64, 192, dtype="bf16",
                                  backend="cuda", cache=tc, iters=1)
        autotune.tune_gravnet(cfg.n_hits, ds, df, cfg.k, batch=16,
                              dtype="bf16", backend="cuda", cache=tc,
                              iters=1)
        autotune.tune_edge_aggregate(EDGE_NODES, 256, 16, batch=8,
                                     reduce="mean", dtype="bf16",
                                     backend="cuda", cache=tc, iters=1)
        tuned = len(spied)
        warmed = warm_from_cache(tc, backend="cuda")
    finally:
        for n_, fn in saved.items():
            setattr(kops, n_, fn)
    keys = sorted(k_.encode() for k_ in tc.entries())
    if (warmed != 3 or len(keys) != 3 or any("|bf16|" not in k_ for k_ in keys)
            or {d for _, d in spied} != {bf16}
            or {n_ for n_, _ in spied[tuned:]} != set(names)):
        fail(f"[bf16 tuning] keys {keys}, warmed {warmed}, operand dtypes "
             f"{sorted(set(spied), key=str)}")
    rec["tuning"] = {k_.encode(): {"us": e.us, "config": e.config}
                     for k_, e in tc.entries().items()}
    say(f"[bf16 tuning] {keys}: tuned and warmed on bf16 operands "
        f"({', '.join(f'{e.us:.2f} us' for e in tc.entries().values())}) "
        f"({card})")
    rec["phase_s"] = time.perf_counter() - t0
    return rec


# ------------------------------------------ phase 18: the launch knobs ----
#: the events each tuned and untuned deployment serves in phase 18 (b)
KNOB_EVENTS = 64
KNOB_ROUNDS = 3                 # events/s of both in turns: medians
KNOB_REPS = 50                  # calls a candidate's device time averages
#: the served paths' launch shapes (tests/test_torch_launch_knobs.py's):
#: the mixed and fp chunks of 2 x 128 hits, the current detector's 8 x
#: 32, the ragged 8 bins of 128, GatedGCN (1, 256, 70), GraphSAGE (8,
#: 256, 16 and 128), the attention dense (4096, 64) -> 192, and the
#: GravNet and edge inputs past the register cell (kernels/f32_cases.py:
#: 600 hits at the smoke widths, d_f 129). Denses (rows, K, N); GravNet
#: (events, n, ...); edges (graphs, nodes, edges, d, reduce).
KNOB_SHAPES = {
    "fused_dense": ((256, 4, 64), (256, 64, 64), (256, 64, 32), (256, 32, 7),
                    (1024, 4, 64), (1024, 64, 22), (1024, 108, 64),
                    (256, 70, 70), (256, 70, 140), (64, 70, 70),
                    (512, 32, 128), (512, 256, 128), (512, 128, 5),
                    (4096, 64, 192)),
    "fused_dense_int8": ((256, 4, 64), (256, 64, 64), (256, 64, 32),
                         (256, 32, 7)),
    "gravnet_aggregate": ((1, 128, 4, 22), (2, 128, 4, 22), (8, 32, 4, 22),
                          (1, 600, 3, 8), (2, 64, 4, 129)),
    "gravnet_block": ((2, 128, 64, 4, 22, 64), (8, 32, 64, 4, 22, 64),
                      (1, 600, 24, 3, 8, 24), (2, 64, 32, 4, 129, 32)),
    "gravnet_block_int8": ((2, 128, 64, 4, 22, 64), (8, 32, 64, 4, 22, 64)),
    "knn_build": ((8, 128, 4), (1, 600, 3)),
    "knn_aggregate": ((8, 128, 22), (1, 128, 129)),
    "edge_aggregate": ((1, 64, 256, 70, "sum"), (8, 64, 256, 16, "mean"),
                       (8, 64, 256, 128, "mean"), (1, 600, 1000, 129, "sum")),
}


def launch_knobs(torch, np, dev, card, h) -> dict:
    """Phase 18: every kernel's plan as a launch knob. (a) every candidate
    of every family (``tuning/candidates.py``) at the path shapes of
    ``KNOB_SHAPES``: the wrapper's ``last_plan`` is the knob, the
    library's shared memory the Python formula's, the output its plain
    version's bitwise (the int8 forms with f32 and int8 out), and its
    device ms beside the default's; (b) ``autotune_graph`` on "cuda" over
    the mixed default (warm-trained), fp, ``fuse_int8=False``, ragged,
    the current detector and GatedGCN and GraphSAGE at their published
    widths: every entry searched its family's whole list; a redeploy on
    the cache binds the winners and its launches take them; its heads
    and decisions, captured and eager, bitwise with the untuned
    deployment's; the captured loop's events/s, tuned against untuned, in
    turns (medians of 3, for information); (c) a cache of the entries
    the tuner wrote before these knobs ({"bm": 128}, the dense's
    reference blocks) binds nothing and serves bitwise with no cache;
    (d) ``serve.main --tune --tuning-cache`` on the default route, then
    on the saved cache alone. Returns the record."""
    import warnings

    from repro_torch.core.op_registry import (tuning_candidates,
                                              tuning_problem)
    from repro_torch.kernels import edge_aggregate as edge
    from repro_torch.kernels import fused_dense as fd
    from repro_torch.kernels import gravnet as gn
    from repro_torch.kernels import gravnet_block as gb
    from repro_torch.kernels import knn_build as kb
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.tuning import TuningCache, autotune_graph
    from repro_torch.tuning import candidates as cand
    from repro_torch.tuning.autotune import _launch, _ragged_segids
    timer, wrappers = h.timer, h.wrappers
    rec = {"card": card, "candidates": [], "paths": {}}
    t0 = time.perf_counter()
    rng = np.random.default_rng(18)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def normal(*shape, scale=1.0):
        return t(rng.normal(size=shape) * scale)

    def int8(*shape):
        return t(rng.integers(-127, 128, size=shape), torch.int8)

    def mask(*shape):
        return t(rng.uniform(size=shape) < 0.85)

    def scales(n):
        return t(rng.uniform(1e-3, 2e-2, size=(n,)))

    # (a) every candidate at the path shapes --------------------------------
    def case(name, label, args, kw, cands, smem=None, outs=(None,)):
        """Every candidate of one launch shape through the wrapper: the
        plan it launched, its shared memory, its output bitwise against
        the plain version's (each output form of ``outs``) and its device
        ms; the first candidate is the default."""
        wrapper, plain = wrappers[name], h.plain_fns[name]
        row = {"name": name, "shape": label, "plans": []}
        for out in outs:
            kw_ = dict(kw, **(out or {}))
            want = plain(*args, **kw_)
            want = want if isinstance(want, tuple) else (want,)
            for c in cands:
                got = wrapper(*args, **kw_, **c)
                got = got if isinstance(got, tuple) else (got,)
                if wrapper.last_plan != c:
                    fail(f"[knobs] {name} {label} {c}: launched "
                         f"{wrapper.last_plan}")
                if any(not torch.equal(g_, w_) for g_, w_ in zip(got, want)):
                    fail(f"[knobs] {name} {label} {kw_} {c}: the output "
                         "differs from the plain version's")
                if smem is not None and smem(c)[0] != smem(c)[1]:
                    fail(f"[knobs] {name} {label} {c}: shared memory "
                         f"{smem(c)}, Python against the library")
                if out is outs[0]:
                    row["plans"].append({**c, "ms": timer.device_ms(
                        lambda c=c: wrapper(*args, **kw_, **c),
                        KNOB_REPS)})
        d_ms = row["plans"][0]["ms"]
        best = min(row["plans"], key=lambda p: p["ms"])
        row["default_ms"], row["best"] = d_ms, best
        rec["candidates"].append(row)
        say(f"[knobs] {name} {label}: " + ", ".join(
            "{}={:.5f}".format(",".join(str(v) for k, v in p.items()
                                        if k != "ms"), p["ms"])
            for p in row["plans"]) + f" ms (default first; best "
            f"{best['ms'] / d_ms:.3f}x the default; {card})")

    for m, k, n in KNOB_SHAPES["fused_dense"]:
        case("fused_dense", f"({m},{k})->{n}",
             (normal(m, k), normal(k, n), normal(n)), {"activation": "relu"},
             cand.fused_dense_candidates(m, k, n),
             lambda c, k=k: (fd.smem_bytes(fd.variant_of(1, 1, **c), k),
                             fd.library_smem_bytes(
                                 fd.variant_of(1, 1, **c), k)))
    for m, k, n in KNOB_SHAPES["fused_dense_int8"]:
        case("fused_dense_int8", f"({m},{k})->{n}",
             (int8(m, k), int8(k, n), normal(n), 0.02, scales(n)),
             {"activation": "relu"}, cand.fused_dense_int8_candidates(m, k, n),
             outs=({"out_int8": True, "out_scale": 0.05}, {}))
    for b, n, ds, df in KNOB_SHAPES["gravnet_aggregate"]:
        case("gravnet_aggregate", f"({b},{n},{ds},{df})",
             (normal(b, n, ds), normal(b, n, df), mask(b, n)),
             {"k": 8 if n <= 128 else 4},
             cand.gravnet_candidates(n, batch=b, d_f=df),
             lambda c, n=n, ds=ds, df=df: (gn.smem_bytes(n, ds, df),
                                           gn.library_smem_bytes(n, ds, df)))
    for b, n, dh, ds, df, do in KNOB_SHAPES["gravnet_block"]:
        case("gravnet_block", f"({b},{n},{dh}) d_f {df}",
             (normal(b, n, dh), mask(b, n), normal(dh, ds, scale=0.3),
              normal(ds), normal(dh, df, scale=0.3), normal(df),
              normal(dh + 2 * df, do, scale=0.3), normal(do)),
             {"k": 8 if n <= 128 else 4, "activation": "relu"},
             cand.gravnet_block_candidates(n, dh, df, do, d_s=ds, batch=b),
             lambda c, a=(n, dh, ds, df, do): (
                 gb.smem_bytes(*a, c["bm"], gb.plan(*a, True, **c)[1]),
                 gb.library_smem_bytes(*a, c["bm"])))
    for b, n, dh, ds, df, do in KNOB_SHAPES["gravnet_block_int8"]:
        case("gravnet_block_int8", f"({b},{n},{dh})",
             (normal(b, n, dh), mask(b, n), int8(dh, ds), normal(ds),
              int8(dh, df), normal(df), int8(dh + 2 * df, do), normal(do),
              scales(ds), scales(df), scales(do)),
             {"x_scale": 0.03, "agg_scale": 0.02, "h_scale": 0.03, "k": 8,
              "activation": "relu"},
             cand.gravnet_block_int8_candidates(n, dh, df, do, d_s=ds,
                                                batch=b),
             lambda c, a=(n, dh, ds, df, do): (
                 gb.int8_smem_bytes(*a, c["bm"]),
                 gb.library_int8_smem_bytes(*a, c["bm"])),
             outs=({}, {"out_int8": True, "out_scale": 0.05}))
    for b, n, ds in KNOB_SHAPES["knn_build"]:
        case("knn_build", f"({b},{n},{ds})",
             (normal(b, n, ds), t(_ragged_segids(rng, (b, n)), torch.int32)),
             {"k": 8 if n <= 128 else 4}, cand.knn_build_candidates(n, batch=b),
             lambda c, n=n, ds=ds: (kb.build_smem_bytes(n, ds),
                                    kb.library_build_smem_bytes(n, ds)))
    for b, n, df in KNOB_SHAPES["knn_aggregate"]:
        idx, d2 = ref.knn_build_ref(normal(b, n, 4), t(
            _ragged_segids(rng, (b, n)), torch.int32), k=8)
        case("knn_aggregate", f"({b},{n},{df})", (normal(b, n, df), idx, d2),
             {"scale": 10.0},
             cand.knn_aggregate_candidates(n, batch=b, d_f=df),
             lambda c, n=n, df=df: (kb.aggregate_smem_bytes(n, df),
                                    kb.library_aggregate_smem_bytes(n, df)))
    for b, n, e, d, red in KNOB_SHAPES["edge_aggregate"]:
        ec = min(e, edge.max_edges())
        case("edge_aggregate", f"({b},{e},{d}) {red} into {n}",
             (normal(b, e, d), t(rng.integers(0, n, size=(b, e)),
                                 torch.int32), mask(b, e)),
             {"n_nodes": n, "reduce": red},
             cand.edge_aggregate_candidates(n, e, d=d, batch=b),
             lambda c, ec=ec: (
                 edge.smem_bytes(ec, c["bn"], edge.staged(ec, c["bn"])),
                 edge.library_smem_bytes(ec, c["bn"],
                                         edge.staged(ec, c["bn"]))))
    n_plans = sum(len(r["plans"]) for r in rec["candidates"])
    rec["int8_tiles"] = {
        r["shape"]: {f"{p['bm']}x{p['bn']}": p["ms"] for p in r["plans"]}
        for r in rec["candidates"] if r["name"] == "fused_dense_int8"}
    say(f"[knobs] (a) {n_plans} candidates at {len(rec['candidates'])} "
        f"launch shapes: each launched as asked, bitwise with its plain "
        f"version, its shared memory the Python formula's "
        f"({time.perf_counter() - t0:.1f}s)")

    # (b) the tuner on the card over the served paths ----------------------
    def problems(pipe):
        """(graph, n_rows, batch, {key: op}) of a deployment, as
        ``serve.cache_hits`` reads them."""
        inner = getattr(pipe, "pipe", pipe)
        g = inner.graph
        n_rows = g.meta["n_hits"]
        batch = inner.microbatch if inner.batch_packed else 1
        ops_ = {}
        for op in g:
            key = tuning_problem(op, n_rows=n_rows, backend="cuda",
                                 batch=batch)
            if key is not None:
                ops_.setdefault(key, op)
        return g, n_rows, batch, ops_

    # the wrappers a family's bound knob reaches (a raggedized block: the
    # kNN pair)
    def reached(key, op):
        if key.kernel == "fused_dense":
            return ("fused_dense_int8",) if key.dtype == "int8" \
                else ("fused_dense",)
        if key.kernel == "gravnet_block" and op.attrs.get("ragged"):
            return ("knn_build", "knn_aggregate")
        return {"gravnet": ("gravnet_aggregate",)}.get(key.kernel,
                                                       (key.kernel,))

    def launched_knobs(pipe, feeds):
        """{wrapper: {knobs}} that one eager pass of ``feeds`` hands the
        wrappers, each launch checked to take what it was handed."""
        seen = {n: set() for n in wrappers}

        def recorder(n):
            real = wrappers[n]

            def call(*a, **kw):
                out = real(*a, **kw)
                knobs = {k: v for k, v in kw.items()
                         if k in ("bm", "bn") and v is not None}
                if knobs:
                    if real.last_plan != knobs:
                        fail(f"[knobs] {n} was handed {knobs}, launched "
                             f"{real.last_plan}")
                    seen[n].add(tuple(sorted(knobs.items())))
                return out
            return call
        with h.substituted({n: recorder(n) for n in wrappers
                            if n != "flash_attention"}):
            pipe.run_eager(feeds)
        torch.cuda.synchronize()
        return seen

    def served(pipe, feeds, eager=False):
        res, _, elapsed = serve.serve_events(Eager(pipe) if eager else pipe,
                                             feeds)
        return dict(h.leaves(res)), elapsed

    t_b = time.perf_counter()
    for label, (pipe, redeploy, feeds) in h.knob_paths.items():
        t_p = time.perf_counter()
        g, n_rows, batch, ops_ = problems(pipe)
        cache = TuningCache()
        buf = io.StringIO()
        with redirect_stdout(buf):
            n_tuned = autotune_graph(g, n_rows=n_rows, backend="cuda",
                                     cache=cache, batch=batch, verbose=True)
        for line in buf.getvalue().splitlines():
            say(f"  {line}")
        if n_tuned != len(ops_) or set(cache.entries()) != set(ops_):
            fail(f"[knobs {label}] tuned {n_tuned} of {len(ops_)} problems")
        want = {n: set() for n in wrappers}
        winners = {}
        for key, op in ops_.items():
            e = cache.entry(key)
            # the list the tuner searched: at the events a launch takes
            # (a dense's rows carry them already)
            events, _ = _launch(g, key, n_rows=n_rows, backend="cuda",
                                batch=batch)
            full = tuning_candidates(op, n_rows=n_rows, batch=(
                batch if key.kernel == "fused_dense" else events))
            if e.candidates != len(full):
                fail(f"[knobs {label}] {key.encode()} searched "
                     f"{e.candidates} of its {len(full)} candidates")
            knobs = {k: v for k, v in e.config.items() if k in ("bm", "bn")}
            winners[key.encode()] = {"config": e.config, "us": e.us,
                                     "default_us": e.default_us,
                                     "candidates": e.candidates,
                                     "default": full[0], "events": events}
            for w in reached(key, op):
                want[w].add(tuple(sorted(knobs.items())))
        tpipe = redeploy(cache)
        _, _, _, tops = problems(tpipe)
        for key, op in tops.items():
            cfg_ = cache.lookup(key)
            bound_ = {k: op.attrs_opt.get(k) for k in cfg_
                      if k in ("bm", "bn", "bq", "bk")}
            if bound_ != {k: cfg_[k] for k in bound_} or (
                    key.kernel == "fused_dense"
                    and not op.attrs_opt.get("tuned")):
                fail(f"[knobs {label}] {op.name} binds {op.attrs_opt}, the "
                     f"cache's winner is {cfg_}")
        one = {k: v[:tpipe.microbatch] for k, v in feeds.items()}
        seen = launched_knobs(tpipe, one)
        if seen != want:
            fail(f"[knobs {label}] the launches took {seen}, the winners "
                 f"are {want}")
        base, _ = served(pipe, feeds)
        for mode in ("captured", "eager"):
            got, _ = served(tpipe, feeds, eager=mode == "eager")
            diff = sorted(k for k in base
                          if not np.array_equal(base[k], got.get(k)))
            if set(got) != set(base) or diff:
                fail(f"[knobs {label}] the tuned deployment ({mode}) differs "
                     f"from the untuned one: {diff}")
        n_ev = len(next(iter(feeds.values())))
        rates = {"untuned": [], "tuned": []}
        for _ in range(KNOB_ROUNDS):
            for which, p in (("untuned", pipe), ("tuned", tpipe)):
                rates[which].append(n_ev / served(p, feeds)[1])
        med = {k: float(np.median(v)) for k, v in rates.items()}
        nondefault = {k: w for k, w in winners.items()
                      if {kk: w["config"].get(kk) for kk in w["default"]}
                      != w["default"]}
        rec["paths"][label] = {"problems": winners, "events": n_ev,
                               "events_s": med, "runs": rates,
                               "non_default": sorted(nondefault),
                               "phase_s": time.perf_counter() - t_p}
        say(f"[knobs {label}] autotune_graph searched every candidate of "
            f"{len(ops_)} problems; {len(nondefault)} non-default winners "
            f"{ {k: w['config'] for k, w in nondefault.items()} }; the "
            f"redeploy binds and launches them; captured and eager bitwise "
            f"with the untuned deployment over {n_ev} events; events/s "
            f"untuned {med['untuned']:.1f}, tuned {med['tuned']:.1f} "
            f"(medians of {KNOB_ROUNDS}, in turns; {card}) "
            f"({time.perf_counter() - t_p:.1f}s)")
    say(f"[knobs] (b) done ({time.perf_counter() - t_b:.1f}s)")

    # (c) a cache written before the knobs ----------------------------------
    pipe, redeploy, feeds = h.knob_paths["mixed default"]
    g, n_rows, batch, ops_ = problems(pipe)
    stale = TuningCache()
    for key in ops_:
        stale.put(key, {"bm": min(n_rows, 128)} if key.kernel != "fused_dense"
                  else {"variant": "looped", "bm": 128, "bn": 128,
                        "bk": 512})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        spipe = redeploy(stale)
    n_warn = sum("binds nothing" in str(w.message) for w in caught)
    if n_warn != len(stale) or [sorted(op.attrs_opt.items()) for op in
                                problems(spipe)[0]] != [
            sorted(op.attrs_opt.items()) for op in g]:
        fail(f"[knobs stale] {n_warn} warnings for {len(stale)} stale "
             "entries, or the bindings differ from no cache's")
    base, _ = served(pipe, feeds)
    got, _ = served(spipe, feeds)
    if any(not np.array_equal(base[k], got.get(k)) for k in base):
        fail("[knobs stale] the deployment on the stale cache differs from "
             "the untuned one")
    rec["stale"] = {"entries": len(stale), "warnings": n_warn}
    say(f"[knobs] (c) a cache of the {len(stale)} entries written before "
        f"the knobs ({{'bm': 128}}, the dense's reference blocks) binds "
        f"nothing ({n_warn} warnings) and serves bitwise with no cache")

    # (d) the serve entry point: tune and save, then bind from the file ----
    path = OUT / "knobs_serve_tuning_cache.json"
    path.unlink(missing_ok=True)
    outs = []
    for extra in (["--tune"], []):
        buf = io.StringIO()
        try:
            with redirect_stdout(buf):
                rc = serve.main(extra + ["--tuning-cache", str(path),
                                         "--train-steps", "0", "--events",
                                         str(KNOB_EVENTS)])
        except SystemExit as e:
            rc = e.code
        for line in buf.getvalue().splitlines():
            say(f"  {line}")
        if rc != 0 or f"answered={KNOB_EVENTS} in-order=True" \
                not in buf.getvalue():
            fail(f"[knobs serve] {' '.join(extra)}: exit {rc}")
        outs.append(buf.getvalue())
    saved = TuningCache.load(path)
    n_saved = len(saved)
    if (not re.search(r"autotuned [1-9]\d* kernel problem", outs[0])
            or "autotuned" in outs[1] or "[tune]" in outs[1]
            or f"{n_saved} of {n_saved} kernel problems bound" not in outs[1]
            or any(e.candidates < 2 for e in saved.entries().values())):
        fail("[knobs serve] --tune must search every candidate and save, "
             "the run on the saved cache bind every problem without "
             "searching")
    rec["serve"] = {k.encode(): e.to_json()
                    for k, e in saved.entries().items()}
    say(f"[knobs] (d) serve --tune searched {n_saved} problems' whole lists "
        f"and saved them; the run on the saved cache bound all of them "
        f"without searching")
    rec["phase_s"] = time.perf_counter() - t0
    return rec


# ------------------------------ phase 19: the H100 model against the card ----
# the ratio of the modelled to the measured device time of a chunk that the
# served default's P must stay within
MODEL_RATIO = (0.5, 2.0)
MODEL_ROUNDS = 3        # in turns: new P, P = 2, P = 2, new P, ...


def model_against_card(torch, np, dev, card, h) -> dict:
    """The design flow's "h100" model (``core/passes/parallelize.py``)
    against the card: (a) the warm-trained mixed default's graph and fp
    at P = 1 to 64 and GatedGCN 16 x 70 at P = 1 to 16, each deployed at
    a fixed P (``launch/h100_model.sweep``): the modelled seconds a step
    beside the profiler's busy time of one captured chunk, and their
    ratio; (b) the served default at the P its model picked: the same,
    failing outside ``MODEL_RATIO``; (c) the P, modelled events/s and
    latency at design points 1-3 under the paper's targets (3e6 events/s,
    10 µs); (d) the served default at its P against P = 2 (the
    reference's CPU model's pick) on the same weights and events, in
    turns, events/s and p50/p99 (medians of ``MODEL_ROUNDS``)."""
    from repro_torch.launch import h100_model, serve
    t0 = time.perf_counter()
    rec = {"card": card}
    rows = h100_model.sweep(h100_model.served_paths(dev, params=h.trained),
                            dev)
    for r in rows:
        say(f"[model] {r['path']} at P={r['P']}: modelled "
            f"{r['model_ms']:.5f} ms a chunk, measured {r['measured_ms']:.5f}"
            f" ms busy, ratio {r['ratio']:.3f} ({card})")
    rec["sweep"] = rows
    mt = h.served
    par = mt.graph.meta["parallelization"]
    feeds = {k: torch.from_numpy(np.ascontiguousarray(v[:mt.microbatch]))
             .to(dev) for k, v in h.ccn_feeds.items()}
    model_s = h100_model.modelled_s(mt)
    meas_s = h100_model.chunk_busy_s(mt, feeds)
    ratio = model_s / meas_s
    rec["served"] = {"P_mxu": par["P_mxu"], "P_xla": par["P_xla"],
                     "microbatch": mt.microbatch,
                     "launches_per_chunk": h.chunk_launches(mt),
                     "model_events_s": par["model_throughput_ev_s"],
                     "model_ms": model_s * 1e3, "measured_ms": meas_s * 1e3,
                     "ratio": ratio}
    say(f"[model] the served default: P_mxu={par['P_mxu']} P_xla="
        f"{par['P_xla']}, {mt.microbatch} events a chunk, modelled "
        f"{model_s * 1e3:.5f} ms a chunk ({par['model_throughput_ev_s']:.1f}"
        f" events/s), measured {meas_s * 1e3:.5f} ms busy, ratio "
        f"{ratio:.3f} ({card})")
    if not MODEL_RATIO[0] <= ratio <= MODEL_RATIO[1]:
        fail(f"[model] the served default's modelled chunk is {ratio:.3f}x "
             f"its measured one, outside {MODEL_RATIO}")
    rec["design_points"] = h100_model.design_points(dev, params=h.trained)
    for r in rec["design_points"]:
        say(f"[model] design point {r['design_point']} at the paper's "
            f"targets (3e6 events/s, 10 us): P_mxu={r['P_mxu']} P_xla="
            f"{r['P_xla']}, modelled {r['model_events_s']:.1f} events/s, "
            f"latency {r['model_latency_us']:.2f} us")
    p2 = h.p2()
    ev = {k: v for k, v in h.ccn_feeds.items()}
    n = len(ev["hits"])
    runs = {"new P": [], "P = 2": []}
    for r in range(MODEL_ROUNDS):       # new, 2, 2, new, new, 2
        order = (("new P", mt), ("P = 2", p2))
        for name, pipe in (order if r % 2 == 0 else order[::-1]):
            res, lat, elapsed = serve.serve_events(pipe, ev)
            runs[name].append([n / elapsed, np.percentile(lat, 50) * 1e6,
                               np.percentile(lat, 99) * 1e6])
            if name == "new P":
                new_res = res
            else:
                old_res = res
    for k in ("trigger", "n_clusters", "cluster_valid"):
        if not np.array_equal(new_res["cps"][k], old_res["cps"][k]):
            fail(f"[model] cps {k} differs between the served default at "
                 "its P and at P = 2")
    rec["in_turns"] = {}
    for name, v in runs.items():
        med = np.median(np.array(v), axis=0).tolist()
        rec["in_turns"][name] = {"events_s": med[0], "p50_us": med[1],
                                 "p99_us": med[2], "runs": v}
        say(f"[model] the served default at {name} "
            f"({mt.microbatch if name == 'new P' else p2.microbatch} "
            f"events a chunk): {med[0]:.1f} events/s, p50={med[1]:.1f}us "
            f"p99={med[2]:.1f}us (medians of {len(v)} in turns, {n} "
            f"events, the plain captured loop; {card})")
    rec["phase_s"] = time.perf_counter() - t0
    return rec


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no "
             "src/repro_torch): run chip_smoke.py from its root")
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs "
             "an NVIDIA card")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import caloclusternet as ccn
    from repro_torch.data.belle2 import (Belle2Config, generate,
                                         with_occupancy)
    from repro_torch.kernels import _build, f32_cases, int8_cases
    from repro_torch.kernels import edge_aggregate as edge_mod
    from repro_torch.kernels import fused_dense as dense_mod
    from repro_torch.kernels import gravnet as agg_mod
    from repro_torch.kernels import gravnet_block as block_mod
    from repro_torch.kernels import knn_build as knn_mod
    from repro_torch.kernels import phase_split, source_ab
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_dense import (fused_dense_cuda,
                                                 fused_dense_int8_cuda)
    from repro_torch.kernels.gravnet import gravnet_aggregate_cuda
    from repro_torch.kernels.gravnet_block import (gravnet_block_cuda,
                                                   gravnet_block_int8_cuda)
    from repro_torch.kernels.knn_build import (knn_aggregate_cuda,
                                               knn_build_cuda)
    from repro_torch.kernels.edge_aggregate import edge_aggregate_cuda
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     kv_split,
                                                     library_smem_bytes,
                                                     smem_bytes)
    from repro_torch.core.pipeline import RaggedPipeline, _cut_hits
    from repro_torch.launch import serve
    from repro_torch.models.gnn import gatedgcn, graphsage

    OUT.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    # 1. the card --------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    LOG.append(card + "\n")
    print(card, flush=True)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    try:
        logs = _build.build_all()
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    if sorted(logs) != sorted(KERNELS):
        fail(f"built {sorted(logs)}, expected {sorted(KERNELS)}")
    say(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f}s")
    for name, log in logs.items():
        (OUT / f"nvcc_{name}.log").write_text(log)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")

    wrappers = {"fused_dense": fused_dense_cuda,
                "gravnet_block": gravnet_block_cuda,
                "fused_dense_int8": fused_dense_int8_cuda,
                "gravnet_aggregate": gravnet_aggregate_cuda,
                "gravnet_block_int8": gravnet_block_int8_cuda,
                "knn_build": knn_build_cuda,
                "knn_aggregate": knn_aggregate_cuda,
                "edge_aggregate": edge_aggregate_cuda,
                "flash_attention": flash_attention_cuda}
    plain_fns = {"fused_dense": ref.fused_dense_ref,
                 "gravnet_block": ref.gravnet_block_ref,
                 "fused_dense_int8": ref.fused_dense_int8_ref,
                 "gravnet_aggregate": ref.gravnet_aggregate_ref,
                 "gravnet_block_int8": ref.gravnet_block_int8_ref,
                 "knn_build": ref.knn_build_ref,
                 "knn_aggregate": ref.knn_aggregate_ref,
                 "edge_aggregate": ref.edge_aggregate_ref,
                 "flash_attention": ref.flash_attention_blocked_ref}

    @contextmanager
    def substituted(fns):
        """Swap the kernel wrappers that kernels/ops.py calls for
        ``fns[name]``; restore them afterwards."""
        saved = {n: getattr(kops, f"{n}_cuda") for n in fns}
        try:
            for n, fn in fns.items():
                setattr(kops, f"{n}_cuda", fn)
            yield
        finally:
            for n, fn in saved.items():
                setattr(kops, f"{n}_cuda", fn)

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
        flash_attention_cuda.launches_by_blocks.clear()

    def read_counts():
        return {n: w.launches for n, w in wrappers.items()}

    # a kernel's records in the profiler: its __global__ function (or the
    # shared-memory one), once per launch; flash_attention's template
    # arguments name its (bq, bk), its combine launch is not counted
    kernel_rx = {n: re.compile(rf"(?<!\w){n}(?:_shared)?_kernel(?!\w)")
                 for n in wrappers}
    flash_rx = re.compile(r"flash_attention_kernel<\w+, (\d+), (\d+),")

    def sentinels():
        """PROFILE_SENTINELS tiny kernels no counter counts, then a sync."""
        for _ in range(PROFILE_SENTINELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()

    def counted(call, warm, label):
        """The main path's counted run: ``call()`` under torch.profiler,
        every counter at 0 just before it (a step of ``warm()`` first,
        whose records are dropped: the tracer may lose its first ones).
        Returns (its result, {kernel: launches}, {(bq, bk): launches} of
        flash_attention) as the profiler saw the kernels run on the card;
        fails unless the wrappers' counters, which a replay adds to by
        what its capture recorded, read the same."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(
                activities=acts, schedule=torch.profiler.schedule(
                    wait=0, warmup=1, active=1, repeat=1)) as prof:
            warm()
            torch.cuda.synchronize()
            prof.step()
            # a margin at each edge of the active window: a kernel that
            # ran just past its start was once dropped as before it; and
            # sentinel kernels on both sides of the call, since the
            # tracer has lost the first or the last records of a window
            # (a served chunk's first dense; the last third of a GatedGCN
            # chunk), which are then the sentinels'
            time.sleep(PROFILE_MARGIN_S)
            sentinels()
            reset_counts()
            out = call()
            torch.cuda.synchronize()
            counters = read_counts()
            by_blocks = dict(flash_attention_cuda.launches_by_blocks)
            sentinels()
            time.sleep(PROFILE_MARGIN_S)
            prof.step()
        seen = dict.fromkeys(wrappers, 0)
        seen_blocks: dict[tuple, int] = {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for n, rx in kernel_rx.items():
                seen[n] += bool(rx.search(e.name))
            m = flash_rx.search(e.name)
            if m:
                bq_bk = (int(m[1]), int(m[2]))
                seen_blocks[bq_bk] = seen_blocks.get(bq_bk, 0) + 1
        if seen != counters or seen_blocks != by_blocks:
            # every device record of the window, for the diagnosis
            tag = re.sub(r"\W+", "_", label)
            (OUT / f"profile_mismatch_{tag}.json").write_text(json.dumps([
                 (e.name, e.time_range.start, e.time_range.end,
                  e.device_index, str(e.device_type)) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA],
                 indent=0))
            fail(f"[{label}] the profiler saw {seen} {seen_blocks} kernel "
                 f"runs, the launch counters read {counters} {by_blocks}")
        say(f"[{label}] profiler: kernel runs on the card equal the launch "
            f"counters: {({n: c for n, c in seen.items() if c})}"
            + (f" {seen_blocks}" if seen_blocks else ""))
        return out, seen, seen_blocks

    def chunk_launches(pipe):
        """{kernel: launches} one chunk of a padded CaloClusterNet
        deployment makes: each dense and block once per P-chunk of its
        segment (microbatch / P; once in a batch-packed executable)."""
        per = {}
        for op in pipe.graph:
            name = {"dense": "fused_dense", "linear": "fused_dense",
                    "gravnet_block": "gravnet_block",
                    "gravnet_aggregate": "gravnet_aggregate"}.get(op.op_type)
            if name is None:
                continue
            if op.precision == "int8" and name != "gravnet_aggregate":
                name += "_int8"
            per[name] = per.get(name, 0) + (1 if pipe.batch_packed else (
                pipe.microbatch // op.attrs_opt.get("P", pipe.microbatch)))
        return per

    cfg = ccn.CCNConfig()
    gen_cfg = Belle2Config()

    def deploy(**kw):
        pipe = serve.build_pipeline(cfg, gen_cfg, device=dev, **kw)
        shown = {k: v for k, v in kw.items() if k != "params"}
        weights = "trained" if kw.get("params") is not None else "random"
        par = getattr(pipe, "pipe", pipe).graph.meta["parallelization"]
        say(f"deployed upgrade CaloClusterNet (n_hits={cfg.n_hits}, "
            f"d_hidden={cfg.d_hidden}, {weights} weights) {shown}: "
            f"microbatch={pipe.microbatch} (P_mxu={par['P_mxu']}, "
            f"P_xla={par['P_xla']} on the "
            f"{getattr(pipe, 'pipe', pipe).req.platform} model)")
        return pipe

    # the paths: (name, deploy kwargs). "served" is the default as serve
    # deploys it on the card: the P search on the H100's model; the others
    # keep the reference's CPU model, so that they launch the kernels at
    # the reference's chunk shapes (PERF.md's kernel table)
    paths = {
        "served": dict(design_point=3, precision="mixed"),
        "mixed": dict(design_point=3, precision="mixed", platform="cpu"),
        "fp": dict(design_point=3, precision="fp", platform="cpu"),
        "mixed_no_fuse_int8": dict(design_point=3, precision="mixed",
                                   fuse_int8=False, platform="cpu"),
        "fp_dp1": dict(design_point=1, precision="fp", platform="cpu"),
        "ragged": dict(design_point=3, precision="fp", ragged=True,
                       batch=RAGGED_BINS, platform="cpu"),
        "ragged_dp1": dict(design_point=1, precision="fp", ragged=True,
                           batch=RAGGED_BINS, platform="cpu"),
    }
    reset_counts()
    pipes = {name: deploy(**kw) for name, kw in paths.items()}
    calib_launches = read_counts()
    say(f"launches while deploying and calibrating on the card: "
        f"{calib_launches}")

    # 3. kernels against their plain versions ----------------------------
    calib = generate(gen_cfg, 64, seed=123)
    calib_feeds = {"hits": calib["feats"], "mask": calib["mask"]}

    def record(pipe, feeds=calib_feeds):
        """The kernel calls of ``pipe`` over ``feeds`` (the 64-event
        calibration batch unless given), made with the plain versions;
        returns (calls, calls per chunk)."""
        calls: list[tuple[str, tuple, dict]] = []

        def recorder(name):
            def rec(*args, **kw):
                calls.append((name, args, kw))
                return plain_fns[name](*args, **kw)
            return rec

        with substituted({n: recorder(n) for n in plain_fns}):
            pipe.run_eager(feeds)
        n_chunks = len(next(iter(feeds.values()))) // pipe.microbatch
        if len(calls) % n_chunks:
            fail(f"{len(calls)} kernel calls over {n_chunks} chunks")
        return calls, len(calls) // n_chunks

    def stacked(calls, per_chunk, mb, pos, n_events):
        """The pos-th call of a chunk, with the event inputs of the
        first n_events events (whole chunks) stacked."""
        parts = [calls[c * per_chunk + pos] for c in range(n_events // mb)]
        name, args0, kw = parts[0]
        if len(parts) == 1:   # as the path gave them (a strided x stays)
            return name, list(args0), kw
        args = list(args0)
        for i in range(EVENT_ARGS[name]):
            args[i] = torch.cat([p[1][i] for p in parts])
        return name, args, kw

    timer = Timer(torch)
    results = {k: {"max_abs_err": 0.0, "per_launch": []} for k in KERNELS}

    def check(path, pos, n_events, name, args, kw):
        """One kernel call against its plain version on the same inputs:
        every float output within the float32 row (the bfloat16 row for
        bf16 outputs; every element equal for the kernels of
        ``BITWISE``), every integer output (knn_build's idx) bitwise; then
        the times and the bound. ``splits`` in ``kw`` goes to the kernel
        alone. Returns the launch's row."""
        kern, plain = wrappers[name], plain_fns[name]
        inexact = kw.get("activation") in INEXACT
        bitwise = name in BITWISE and not inexact
        plain_kw = {k_: v_ for k_, v_ in kw.items() if k_ != "splits"}
        try:
            got = kern(*args, **kw)
            torch.cuda.synchronize()
        except (RuntimeError, ValueError, TypeError) as e:
            fail(f"{name} did not launch: {e}")
        want = plain(*args, **plain_kw)
        bf16 = (want if torch.is_tensor(want) else want[0]).dtype \
            == torch.bfloat16
        rtol, atol = (BF16_RTOL, BF16_ATOL) if bf16 else (RTOL, ATOL)
        gots = got if isinstance(got, tuple) else (got,)
        wants = want if isinstance(want, tuple) else (want,)
        shape = shape_of(name, args, kw) + dtype_tag(name, args, kw)
        if name.startswith("knn"):
            b_, n_ = args[0].shape[:2]
            bm_, cell_ = (knn_mod.build_plan(n_, b_) if name == "knn_build"
                          else knn_mod.aggregate_plan(n_, b_,
                                                      args[0].shape[2]))
            shape += f" (plan: {bm_} rows a CTA, {cell_} cell)"
        max_err, n_equal, n_all = 0.0, 0, 0
        for g_, w_ in zip(gots, wants, strict=True):
            if g_.dtype != w_.dtype or g_.shape != w_.shape:
                fail(f"{name}: kernel gives {g_.dtype} {tuple(g_.shape)}, "
                     f"plain version {w_.dtype} {tuple(w_.shape)}")
            g64, w64 = g_.double(), w_.double()
            err = (g64 - w64).abs()
            excess = (err - (atol + rtol * w64.abs())).max().item()
            if not g_.is_floating_point() and not torch.equal(g_, w_):
                # integer outputs are held bitwise, but an int8 output of
                # an inexact epilogue to one step
                excess = (err.max().item() - 1.0 if inexact
                          and g_.dtype == torch.int8 else 1.0)
            max_err = max(max_err, err.max().item())
            n_equal += int((g_ == w_).sum().item())
            n_all += g_.numel()
            if not np.isfinite(max_err) or excess > 0:
                fail(f"{name} at {shape} disagrees with its plain version: "
                     f"max|err|={max_err:.3e} (tolerance {atol:g} + "
                     f"{rtol:g}·|want|, integer outputs bitwise, int8 "
                     "outputs of gelu and silu within a step)")
        exact = n_equal / max(n_all, 1)
        if bitwise and n_equal != n_all:
            fail(f"{name} at {shape} is not bitwise equal to its plain "
                 f"version: {exact:.2%} of elements equal, max|err|="
                 f"{max_err:.3e}")
        lib_ms, lib_name = None, None
        if name == "fused_dense":
            x, w, b = args[:3]
            act = kw.get("activation", "relu")

            def lib(x=x, w=w, b=b, act=act):
                y = x @ w if b is None else torch.addmm(b, x, w)
                if act == "gelu":
                    return F.gelu(y, approximate="tanh")
                if act == "silu":
                    return F.silu(y)
                return torch.relu_(y) if act == "relu" else y
            lib_ms = timer.device_ms(lib, 200)
            lib_name = {"gelu": "addmm+F.gelu(approximate='tanh')",
                        "silu": "addmm+F.silu"}.get(act, "addmm+relu")
        elif name == "fused_dense_int8":
            x, w = args[0], args[1]
            try:
                torch._int_mm(x, w)
                torch.cuda.synchronize()
            except RuntimeError:
                lib_name = "torch._int_mm refuses this shape"
            else:
                lib_ms = timer.device_ms(lambda: torch._int_mm(x, w), 200)
                lib_name = "torch._int_mm (int8 product only, no epilogue)"
        elif name == "edge_aggregate":
            # one call on the edges filtered (and, for sum, weighted)
            # beforehand, untimed: index_add_ of mask·msg for sum; for
            # mean, where every mask is 0 or 1, index_reduce_('mean',
            # include_self=False) of the unmasked edges, which leaves a
            # node without edges at 0 as max(count, 1) does
            msg, dst, mask = args[:3]
            n, mean = kw["n_nodes"], kw.get("reduce") == "mean"
            keep = (dst >= 0) & (dst < n)
            if mean:
                keep &= mask > 0
            rows = (dst.long() + n * torch.arange(
                msg.shape[0], device=dev)[:, None])[keep]
            acc = torch.zeros((msg.shape[0] * n, msg.shape[2]), device=dev)
            lib = None
            if torch.bfloat16 in (msg.dtype, want.dtype):
                lib_name = ("none in bf16 (index_add_ and index_reduce_ on "
                            "bf16 accumulate in bf16)")
            elif not mean:
                wmsg = (mask[..., None] * msg)[keep]

                def lib():
                    return acc.index_add_(0, rows, wmsg)
                lib_name = ("Tensor.index_add_ of the mask-weighted "
                            "messages (atomic, no fixed order; the "
                            "weighting not timed)")
            elif bool(((mask == 0) | (mask == 1)).all()):
                kmsg = msg[keep]

                def lib():
                    return acc.index_reduce_(0, rows, kmsg, "mean",
                                             include_self=False)
                lib_name = ("Tensor.index_reduce_('mean', include_self="
                            "False) of the unmasked messages (atomic, no "
                            "fixed order; the filtering not timed)")
            else:
                lib_name = ("none for mean over fractional masks (no "
                            "single PyTorch call)")
            if lib is not None:
                # an atomic sum in another order differs by rounding steps
                # of its partial sums: held to the float32 row of the
                # terms' magnitudes summed (the largest-E input sums ~225
                # terms a node, some near 0), the kernel itself bitwise
                lib_err = (lib().view_as(want) - want).abs()
                scale = plain(msg.abs(), dst, mask.abs(), **plain_kw)
                if not bool((lib_err <= ATOL + RTOL * scale).all()):
                    fail(f"{name} at {shape}: the library call timed "
                         f"beside it computes another function (max|err|="
                         f"{lib_err.max().item():.3e})")
                lib_ms = timer.device_ms(lib, 200)
        reps = 200
        if name == "flash_attention":
            # up to 17 ms a launch: ~0.4 s of launches per timing
            reps = max(5, min(200, int(400.0 / timer.once_ms(
                lambda: kern(*args, **kw)))))
            # SDPA, top-left causal like the reference where S == T; a
            # yardstick only: it may round otherwise, so it is held to
            # 1e-3 in f32 and to the bfloat16 row in bf16 (it computes
            # the same function) and its error printed
            q, k, v = args[:3]
            causal = kw.get("causal", True)
            if q.shape[1] == k.shape[1] or not causal:
                def lib(q=q, k=k, v=v, causal=causal):
                    return F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal)
                lib_err = (lib().float() - want.float()).abs().max().item()
                lib_tol = 1e-3 if q.dtype == torch.float32 else atol
                if not lib_err <= lib_tol:
                    fail(f"{name} at {shape}: scaled_dot_product_attention "
                         f"computes another function (max|err|="
                         f"{lib_err:.3e})")
                lib_ms = timer.device_ms(lib, reps)
                lib_name = (f"F.scaled_dot_product_attention(is_causal="
                            f"{causal}), {str(q.dtype)[6:]}, max|err| "
                            f"{lib_err:.3e} against the plain version")
        ms = timer.device_ms(lambda: kern(*args, **kw), reps)
        plain_ms = timer.device_ms(lambda: plain(*args, **plain_kw), 3)
        nbytes, ops = cost(name, args, plain_kw)
        b_ms, b_by = bound(nbytes, ops)
        row = {"path": path, "op": pos, "events": n_events, "shape": shape,
               "max_abs_err": max_err, "exact_share": exact, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": lib_name, "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes, "ops": ops}
        results[name]["per_launch"].append(row)
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           max_err)
        say(f"{name} [{path}] events={n_events} {shape}: "
            f"max|err|={max_err:.3e} ({exact:.1%} bitwise) ms={ms:.5f} "
            f"plain_ms={plain_ms:.5f} library_ms="
            f"{'n/a' if lib_ms is None else f'{lib_ms:.5f}'} "
            f"bound_ms={b_ms:.7f} ({b_by})")
        return row

    # (path, which kernels, event counts to check them at: one chunk of
    # the path, a 16-event dispatch, the 64-event calibration batch)
    plan = [("mixed", None, CHECK_BATCHES),
            ("fp", None, CHECK_BATCHES),
            ("mixed_no_fuse_int8", {"fused_dense_int8"}, CHECK_BATCHES[:1]),
            ("mixed_no_fuse_int8", {"gravnet_aggregate"}, CHECK_BATCHES),
            ("fp_dp1", {"gravnet_aggregate"}, CHECK_BATCHES[:2])]
    per_chunk_calls = {}
    recorded = {}
    for path, only, batches in plan:
        pipe = pipes[path]
        if path not in recorded:
            recorded[path] = record(pipe)
        calls, per_chunk = recorded[path]
        per_chunk_calls[path] = [c[0] for c in calls[:per_chunk]]
        for pos in range(per_chunk):
            if only is not None and calls[pos][0] not in only:
                continue
            for n_ev in (pipe.microbatch, *batches[1:]):
                check(path, pos, n_ev,
                      *stacked(calls, per_chunk, pipe.microbatch, pos, n_ev))
            if (path, calls[pos][0]) in (("fp", "gravnet_block"),
                                         ("mixed", "gravnet_block_int8")):
                # one event of the chunk: the per-event TPU kernel's form
                name, args, kw = calls[pos]
                check(path, pos, 1, name,
                      [a[:1] if i < EVENT_ARGS[name] else a
                       for i, a in enumerate(args)], kw)
    del recorded

    # the int8 pair at the current detector's shapes (32 hits: its mixed
    # deployment's calls on its own calibration batch) and on the inputs
    # that stress their designs (kernels/int8_cases.py), bitwise
    cur_cfg, cur_gen = serve.detector_configs("current")
    cur_pipe = serve.build_pipeline(cur_cfg, cur_gen, device=dev,
                                    design_point=3, precision="mixed",
                                    platform="cpu")
    say(f"deployed current-detector CaloClusterNet (n_hits="
        f"{cur_cfg.n_hits}, mixed, design point 3): microbatch="
        f"{cur_pipe.microbatch}")
    cur_fp = serve.build_pipeline(cur_cfg, cur_gen, device=dev,
                                  design_point=3, precision="fp",
                                  platform="cpu")
    for tag, pipe in (("mixed_current", cur_pipe), ("fp_current", cur_fp)):
        cur_calls, cur_per_chunk = record(
            pipe, serve.calibration_feeds(cur_gen))
        for pos in range(cur_per_chunk):
            for n_ev in (pipe.microbatch, *CHECK_BATCHES[1:]):
                check(tag, pos, n_ev, *stacked(
                    cur_calls, cur_per_chunk, pipe.microbatch, pos, n_ev))
        del cur_calls
    # the int8 pair at the bucketed deployment's shapes (phase 11): the
    # calls of the upgrade-width mixed deployment at buckets of 8 to 128
    # hits, 8 events a launch (n = k = 8 at the smallest), on the
    # calibration batch cut to each bucket; one launch each
    bk_pipe = serve.build_pipeline(cfg, gen_cfg, device=dev, design_point=3,
                                   precision="mixed", buckets=CHECK_BUCKETS,
                                   batch=BUCKET_MICROBATCH)
    for b, pipe in bk_pipe.pipes.items():
        b_calls, b_per_chunk = record(pipe, _cut_hits(calib_feeds, b))
        for pos in range(b_per_chunk):
            check(f"mixed_bucket{b}", pos, pipe.microbatch, *stacked(
                b_calls, b_per_chunk, pipe.microbatch, pos, pipe.microbatch))
        del b_calls
    del bk_pipe

    def as_args(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                if isinstance(a, np.ndarray) else a for a in arrays]

    for case, (b, n, n_valid, dup) in int8_cases.BLOCK_CASES.items():
        for tag, widths, k_ in (("", INT8_WIDTHS, cfg.k),
                                (" smoke widths", SMOKE_WIDTHS, 4)):
            ops_, scales = int8_cases.block_inputs(
                b, n, **widths, seed=len(case), n_valid=n_valid, dup=dup)
            check(f"edge:{case}{tag}", 0, b, "gravnet_block_int8",
                  as_args(ops_), dict(scales, k=k_))
    # x's quantizations (into xq and into h) on the quotients where the
    # kernels' division-free quotient (csrc/int8_quant.cuh) could round
    # otherwise than the division: ties of rint, float midpoints,
    # subnormal quotients (its division fallback), the clip, ±inf
    for tag, widths, k_ in (("", INT8_WIDTHS, cfg.k),
                            (" smoke widths", SMOKE_WIDTHS, 4)):
        ops_, scales = int8_cases.quotient_edges(*int8_cases.block_inputs(
            2, cfg.n_hits, **widths, seed=5, n_valid=cfg.n_hits * 3 // 4),
            seed=5)
        check(f"edge:quotients{tag}", 0, 2, "gravnet_block_int8",
              as_args(ops_), dict(scales, k=k_))
    for case, (m, kd, n, act, out8) in int8_cases.DENSE_CASES.items():
        ops_, out_scale = int8_cases.dense_inputs(m, kd, n, seed=len(case))
        check(f"edge:{case}", 0, 1, "fused_dense_int8", as_args(ops_),
              dict(activation=act, out_int8=out8, out_scale=out_scale))
    # the f32 dense on the inputs that stress its design
    # (kernels/f32_cases.py): K past the staging limit, row-strided x,
    # N and M off every tile; and each tile's shared-memory plan against
    # the built library's own
    for case, (m, kd, n, ldx, act, bias) in f32_cases.DENSE_CASES.items():
        x, w, b = as_args(f32_cases.dense_inputs(m, kd, n, ldx=ldx,
                                                 bias=bias, seed=len(case)))
        check(f"edge:{case}", 0, 1, "fused_dense", [x[:, :kd], w, b],
              dict(activation=act))
    # the f32 GravNet pair on the inputs that stress their designs
    # (kernels/f32_cases.py): ties, 1 to 600 hits, fewer valid hits than
    # k, a masked event, k past n, d_s 1 and 9, d_f 1 to 129, 1 to 64
    # events, both cells; and each shape's shared-memory plan against the
    # built library's own
    for case, (b, n, dh, ds, df, dout, k_, nv, dup,
               masked) in f32_cases.GRAVNET_CASES.items():
        kw_ = dict(seed=len(case), n_valid=nv, dup=dup, masked_event=masked)
        check(f"edge:{case}", 0, b, "gravnet_block", as_args(
            f32_cases.block_inputs(b, n, dh=dh, ds=ds, df=df, dout=dout,
                                   **kw_)), {"k": k_})
        check(f"edge:{case}", 0, b, "gravnet_aggregate", as_args(
            f32_cases.aggregate_inputs(b, n, ds=ds, df=df, **kw_)),
            {"k": k_})
        bm, cell = block_mod.plan(n, dh, ds, df, dout)
        want = block_mod.smem_bytes(n, dh, ds, df, dout, bm, cell)
        if block_mod.library_smem_bytes(n, dh, ds, df, dout, bm) != want:
            fail(f"gravnet_block: {case} plans {want} B of shared memory "
                 f"({cell} cell, bm {bm}), the library "
                 f"{block_mod.library_smem_bytes(n, dh, ds, df, dout, bm)}")
        if agg_mod.library_smem_bytes(n, ds, df) != agg_mod.smem_bytes(
                n, ds, df):
            fail(f"gravnet_aggregate: {case} plans "
                 f"{agg_mod.smem_bytes(n, ds, df)} B of shared memory, the "
                 f"library {agg_mod.library_smem_bytes(n, ds, df)}")
    say(f"gravnet_block, gravnet_aggregate: the shared-memory plans of the "
        f"{len(f32_cases.GRAVNET_CASES)} edge cases equal the library's")
    plan_ks = sorted({c[1] for c in f32_cases.DENSE_CASES.values()}
                     | {4, 8, 32, 64, 108, 192})
    for v in range(len(dense_mod.TILES)):
        for kd in plan_ks:
            if dense_mod.library_smem_bytes(v, kd) != dense_mod.smem_bytes(
                    v, kd):
                fail(f"fused_dense: tile {v} at K={kd} plans "
                     f"{dense_mod.smem_bytes(v, kd)} B of shared memory, "
                     f"the library {dense_mod.library_smem_bytes(v, kd)}")
    say(f"fused_dense: the {len(dense_mod.TILES)} tiles' shared-memory "
        f"plans equal the library's at K {plan_ks}")

    # the ragged path: its kernel calls while serving its events, made
    # with the plain versions (whose results phase 6 holds the kernels'
    # to); the kNN pair checked at 1, 8 and 16 bins of real packing
    rg_events = generate(with_occupancy(gen_cfg, RAGGED_OCCUPANCY),
                         RAGGED_EVENTS, seed=7)
    rg_feeds = {"hits": rg_events["feats"], "mask": rg_events["mask"]}
    rg_counts = rg_events["mask"].sum(axis=1).astype(int)

    def ragged_launches(pipe, n_events):
        """Launches of the ragged executable while serve_events serves
        the first n_events, max(microbatch, 16) per call."""
        step = max(pipe.microbatch, serve.MIN_SERVE_BATCH)
        return sum(len(pipe._plan_launches(
            rg_counts[s:min(s + step, n_events)]))
            for s in range(0, n_events, step))

    def record_ragged(path, n_events):
        calls: list[tuple[str, tuple, dict]] = []

        def recorder(name):
            def rec(*args, **kw):
                calls.append((name, args, kw))
                return plain_fns[name](*args, **kw)
            return rec

        with substituted({n: recorder(n) for n in plain_fns}):
            res, _, _ = serve.serve_events(
                Eager(pipes[path]),
                {k: v[:n_events] for k, v in rg_feeds.items()})
        n_launch = ragged_launches(pipes[path], n_events)
        if len(calls) % n_launch:
            fail(f"[{path}] {len(calls)} kernel calls over {n_launch} "
                 "launches")
        per_launch = len(calls) // n_launch
        per_chunk_calls[path] = [c[0] for c in calls[:per_launch]]
        return calls, per_launch, res

    rg_plain = {}
    for path, n_ev in (("ragged", RAGGED_EVENTS),
                       ("ragged_dp1", SHORT_EVENTS)):
        calls, per_launch, rg_plain[path] = record_ragged(path, n_ev)
        for pos in range(per_launch):
            name = calls[pos][0]
            if not name.startswith("knn") and path != "ragged":
                continue
            for nb in (RAGGED_CHECK_BINS if name.startswith("knn")
                       and path == "ragged" else (RAGGED_BINS,)):
                if nb < RAGGED_BINS:
                    _, args, kw = calls[pos]
                    args = [a[:nb] if i < EVENT_ARGS[name] else a
                            for i, a in enumerate(args)]
                else:
                    _, args, kw = stacked(calls, per_launch, RAGGED_BINS,
                                          pos, nb)
                check(path, pos, nb, name, args, kw)
        del calls
    # the kNN pair on the inputs that stress their designs
    # (kernels/f32_cases.py): bins of 1-3 events, spent slots, an
    # all-padding bin, coincident rows, ties, 40 to 600 rows, d_s 3 and
    # 12, d_f 22 and 129, indices outside [0, n), k 40; both paths of each
    # source; and each shape's shared-memory plan against the built
    # library's own
    for case, (bins, n, ds, df, k_, values, dup,
               corrupted) in f32_cases.KNN_CASES.items():
        s_, seg = f32_cases.knn_build_inputs(bins, n, ds, k_, values, dup,
                                             seed=len(case))
        check(f"edge:{case}", 0, len(bins), "knn_build", as_args([s_, seg]),
              {"k": k_})
        idx, d2 = ref.knn_build_ref(torch.from_numpy(s_),
                                    torch.from_numpy(seg), k=k_)
        f_, idx = f32_cases.knn_aggregate_inputs(idx.numpy(), n, df,
                                                 corrupted, seed=len(case))
        check(f"edge:{case}", 0, len(bins), "knn_aggregate",
              as_args([f_, idx, d2.numpy()]), {})
        for name, mine, lib_ in (
                ("knn_build", knn_mod.build_smem_bytes(n, ds),
                 knn_mod.library_build_smem_bytes(n, ds)),
                ("knn_aggregate", knn_mod.aggregate_smem_bytes(n, df),
                 knn_mod.library_aggregate_smem_bytes(n, df))):
            if mine != lib_:
                fail(f"{name}: {case} plans {mine} B of shared memory, the "
                     f"library {lib_}")
    say(f"knn_build, knn_aggregate: the {len(f32_cases.KNN_CASES)} edge "
        "cases bitwise; their shared-memory plans equal the library's")

    def captured(tool, argv, label):
        """Run a measuring tool's main in this process, its output into
        the log; fail if it exits otherwise than with 0."""
        buf = io.StringIO()
        try:
            with redirect_stdout(buf):
                rc = tool.main(argv)
        except SystemExit as e:
            rc = e.code
        for line in buf.getvalue().splitlines():
            say(f"  [{label}] {line}")
        if rc not in (0, None):
            fail(f"{label} {' '.join(argv)}: {rc}")

    # the kNN pair against the first design (the kernel it replaced,
    # each source's second path: its C entry at 32 rows a CTA), both
    # held bitwise, timed in turns at 1, 8 and 16 bins; then where a CTA
    # of each spends its time (the launch counts are not read here)
    captured(source_ab, ["--earlier", str(_build.CSRC), "--kernels",
                         "knn_build", "knn_aggregate", "--out",
                         str(OUT / "source_ab_knn.json")], "source_ab")
    ab = json.loads((OUT / "source_ab_knn.json").read_text())["rows"]
    for r in ab:
        say(f"{r['kernel']} at {r['shape']}: first design "
            f"{r['earlier_ms']:.5f} ms, register cell {r['current_ms']:.5f} "
            f"ms ({r['earlier_ms'] / r['current_ms']:.2f}x, "
            + ("faster)" if r["current_ms"] < r["earlier_ms"]
               else "NOT faster)"))
    for kname in ("knn_build", "knn_aggregate"):
        captured(phase_split, ["--kernel", kname], f"phase_split {kname}")
    main_chunk = per_chunk_calls["mixed"]
    if (main_chunk.count("fused_dense_int8"),
            main_chunk.count("gravnet_block_int8"),
            len(main_chunk)) != (5, 2, 7):
        fail(f"a main-path chunk calls {main_chunk}, expected 5 "
             "fused_dense_int8 and 2 gravnet_block_int8")
    say(f"phase 3 done at {time.perf_counter() - t_start:.1f}s")

    def heads_and_cps(res, want, n_events, label, bitwise,
                      every_cps=False):
        for h in ("beta", "coords", "energy", "cls"):
            got, ref_ = res[h], want[h]
            if not np.isfinite(got).all() or got.shape != (
                    n_events, cfg.n_hits, cfg.head_dims[h]):
                fail(f"{label} head {h}: shape {got.shape} or non-finite")
            err = np.abs(got - ref_)
            if (not np.array_equal(got, ref_)) if bitwise else (
                    err > ATOL + RTOL * np.abs(ref_)).any():
                fail(f"{label} head {h}: kernels vs plain versions "
                     f"max|err|={err.max():.3e}")
            say(f"{label} head {h}: kernels vs plain max|err|="
                f"{err.max():.3e}")
        for k in (sorted(want["cps"]) if every_cps
                  else ("trigger", "n_clusters", "cluster_valid")):
            if not np.array_equal(res["cps"][k], want["cps"][k]):
                fail(f"{label} cps {k} differs between kernels and plain "
                     "versions")

    def run_path(path, n_events, seed):
        """Serve n_events of the path, timed, then once more as its
        counted run (``counted``); returns (the counted run's results,
        the timed run's latencies and elapsed, the launches the profiler
        saw, feeds, events)."""
        pipe = pipes[path]
        events = generate(gen_cfg, n_events, seed=seed)
        feeds = {"hits": events["feats"], "mask": events["mask"]}

        def warm():
            serve.serve_events(pipe, {k: v[:32] for k, v in feeds.items()})
        warm()
        torch.cuda.synchronize()
        _, lat, elapsed = serve.serve_events(pipe, feeds)
        (res, _, _), launches, _ = counted(
            lambda: serve.serve_events(pipe, feeds), warm, path)
        batch = max(pipe.microbatch, serve.MIN_SERVE_BATCH)
        n_chunks = sum(-(-min(batch, n_events - s) // pipe.microbatch)
                       for s in range(0, n_events, batch))
        say(f"[{path}] served {n_events} events in {n_chunks} chunks of "
            f"{pipe.microbatch}: launches {launches}")
        return res, lat, elapsed, launches, n_chunks, feeds, events

    path_launches = {}

    # 4. the main path on the card ----------------------------------------
    def serve_mixed(path, params=None):
        """Serve SERVE_EVENTS events of the served default (weights
        ``params``, default random from seed 0; P on the H100's model)
        with the counters at 0 just before: each of the 5 int8 denses and
        2 int8 blocks once per P-chunk of its segment, no other launch;
        calibration, heads and trigger decisions equal to the same
        deployment with the plain versions substituted, CPS on the card
        equal to CPS on the CPU. Returns (results, latencies, elapsed,
        events)."""
        res, lat, elapsed, launches, n_chunks, feeds, events = run_path(
            path, SERVE_EVENTS, seed=7)
        path_launches[path] = launches
        per = chunk_launches(pipes[path])
        want = dict.fromkeys(wrappers, 0)
        want.update({n: c * n_chunks for n, c in per.items()})
        if set(per) != {"fused_dense_int8", "gravnet_block_int8"} \
                or launches != want:
            fail(f"[{path}] launch counts {launches} != {want} ({per} per "
                 f"chunk of {pipes[path].microbatch} events, no fp dense, "
                 "block or aggregate)")
        say(f"[{path}] {per} launches per chunk of "
            f"{pipes[path].microbatch} events")
        pipe = pipes[path]
        with substituted(plain_fns):
            plain_pipe = serve.build_pipeline(cfg, gen_cfg, device=dev,
                                              params=params,
                                              **paths["served"])
            plain_res, _, _ = serve.serve_events(Eager(plain_pipe), feeds)
        for op in pipe.graph:
            pop = plain_pipe.graph[op.name]
            for a in op.attrs:
                if a.endswith("_scale") and op.attrs[a] != pop.attrs[a]:
                    fail(f"[{path}] calibration: {op.name}.{a} "
                         f"{op.attrs[a]!r} with the kernels, "
                         f"{pop.attrs[a]!r} with the plain versions")
            for p in op.params or {}:
                if not torch.equal(op.params[p], pop.params[p]):
                    fail(f"[{path}] calibration: {op.name}/{p} differs")
        say(f"[{path}] calibration on the card: every activation scale and "
            "quantized weight equal to the plain versions'")
        heads_and_cps(res, plain_res, SERVE_EVENTS, path, bitwise=True)
        # CPS on the card against CPS on the CPU, on the card's heads
        cpu_cps = ccn.cps(
            {"beta_logit": torch.from_numpy(res["beta"][..., 0]),
             "coords": torch.from_numpy(res["coords"]),
             "energy": torch.from_numpy(res["energy"][..., 0])},
            torch.from_numpy(events["mask"]), cfg)
        for k in ("trigger", "n_clusters", "cluster_valid"):
            if not np.array_equal(res["cps"][k], cpu_cps[k].numpy()):
                fail(f"[{path}] cps {k} on the card differs from cps on "
                     "the CPU")
        eff, fake = serve.trigger_rates(res["cps"]["trigger"],
                                        events["trigger_truth"])
        batch = max(pipe.microbatch, serve.MIN_SERVE_BATCH)
        say(f"[{path}] trigger decisions bitwise equal to the plain path on "
            f"all {SERVE_EVENTS} events: efficiency={eff:.3f} "
            f"fake rate={fake:.3f}")
        say(f"serve ({path}, design point 3): "
            f"{SERVE_EVENTS / elapsed:.1f} events/s, latency "
            f"p50={np.percentile(lat, 50) * 1e6:.1f}us "
            f"p99={np.percentile(lat, 99) * 1e6:.1f}us "
            f"({batch} events per dispatch, {card})")
        return res, lat, elapsed, feeds

    res, lat, elapsed, feeds = serve_mixed("served")
    pipe = pipes["served"]
    batch = max(pipe.microbatch, serve.MIN_SERVE_BATCH)

    def idle_share(serve_once, label, tag):
        """The device's busy time and idle share over 4 calls of
        ``serve_once`` under torch.profiler; kernel sums go to
        profile{tag}.txt. Returns the busy µs and {kernel name: [µs,
        calls]}."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        # one warm-up step first: the tracer's first activity records
        # may be lost while it starts (2 kernels of 160 were, on a
        # replayed chunk), so only the 4 calls after it are read
        with torch.profiler.profile(
                activities=acts, schedule=torch.profiler.schedule(
                    wait=0, warmup=1, active=1, repeat=1)) as prof:
            serve_once()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(PROFILE_MARGIN_S)    # as in ``counted``
            t0 = time.perf_counter()
            for _ in range(4):
                serve_once()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            time.sleep(PROFILE_MARGIN_S)
            prof.step()
        kernels_us: dict[str, list] = {}
        for e in prof.events():
            # the step's annotation spans the window on the device's
            # timeline too: it is no kernel
            if e.device_type == torch.autograd.DeviceType.CUDA and not (
                    getattr(e, "is_user_annotation", False)
                    or e.name.startswith("ProfilerStep")):
                k = kernels_us.setdefault(e.name, [0.0, 0])
                k[0] += e.time_range.elapsed_us()
                k[1] += 1
        busy_us = sum(v[0] for v in kernels_us.values())
        top = sorted(kernels_us.items(), key=lambda kv: -kv[1][0])
        (OUT / f"profile{tag}.txt").write_text("".join(
            f"{us:12.1f} us {n:7d} calls  {name}\n"
            for name, (us, n) in top))
        if busy_us > 0:
            say(f"device busy {busy_us:.1f}us of {wall_us:.1f}us wall over "
                f"4 {label} (profiler on): idle share "
                f"{1 - busy_us / wall_us:.4f}")
            for name, (us, n) in top[:10]:
                say(f"  device {us:10.1f}us  calls {n:6d}  {name[:70]}")
        else:
            say("idle share: not measured (the profiler recorded no "
                "device time)")
        return busy_us, kernels_us, wall_us

    # where one served micro-batch's time goes, and the device idle share
    prof_feeds = {k: v[:batch] for k, v in feeds.items()}
    idle_share(lambda: serve.serve_events(pipe, prof_feeds),
               "served micro-batches", "")
    host = {}
    ex = pipe._ex
    run_op = ex.run_op

    def timed(op, vals, feeds_, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_op(op, vals, feeds_, **kw)
        torch.cuda.synchronize()
        host[op.op_type] = host.get(op.op_type, 0.0) + \
            time.perf_counter() - t
        return out
    ex.run_op = timed
    try:
        serve.serve_events(Eager(pipe), prof_feeds)
    finally:
        ex.run_op = run_op
    total = sum(host.values())
    say("per op type, one eager dispatch, synchronized after each op: "
        + ", ".join(f"{k}={v * 1e6:.1f}us ({v / total:.1%})"
                    for k, v in sorted(host.items(), key=lambda kv: -kv[1])))
    say(f"phase 4 done at {time.perf_counter() - t_start:.1f}s")

    # 4b. the default serve run: warm-training on the card, then the main
    # path with the trained weights -----------------------------------------
    t0 = time.perf_counter()
    trained, losses = serve.warm_train(cfg, gen_cfg, serve.TRAIN_STEPS,
                                       device=dev)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    loss_vals = [float(x) for x in losses]
    if len(loss_vals) != serve.TRAIN_STEPS \
            or not np.isfinite(loss_vals).all() \
            or not loss_vals[-1] < loss_vals[0]:
        fail(f"warm-training on the card: losses {loss_vals} (want "
             f"{serve.TRAIN_STEPS} finite, the last below the first)")
    for name, p_ in trained.items():
        for key, t_ in p_.items():
            if t_.device != dev or not bool(torch.isfinite(t_).all()):
                fail(f"warm-training: {name}/{key} on {t_.device} or "
                     "non-finite")
    say(f"warm-trained {serve.TRAIN_STEPS} steps on the card in "
        f"{t_train:.1f}s (autograd through CaloClusterNet.forward, no "
        f"kernel): loss {loss_vals[0]:.4f} -> {loss_vals[-1]:.4f}")
    reset_counts()
    pipes["served_trained"] = deploy(params=trained, **paths["served"])
    serve_mixed("served_trained", params=trained)
    say(f"phase 4b done at {time.perf_counter() - t_start:.1f}s")

    # 5. the other paths ----------------------------------------------------
    def other_path(path, n_events, per_chunk, redeploy):
        res, lat, elapsed, launches, n_chunks, feeds, _ = run_path(
            path, n_events, seed=17)
        path_launches[path] = launches
        want = dict.fromkeys(wrappers, 0)
        want.update({n: c * n_chunks for n, c in per_chunk.items()})
        if launches != want:
            fail(f"[{path}] launch counts {launches} != {want}")
        with substituted(plain_fns):
            pipe_ = (serve.build_pipeline(cfg, gen_cfg, device=dev,
                                          **paths[path])
                     if redeploy else pipes[path])
            plain_res, _, _ = serve.serve_events(Eager(pipe_), feeds)
        heads_and_cps(res, plain_res, n_events, path, bitwise=True)
        say(f"serve ({path}): {n_events / elapsed:.1f} events/s, latency "
            f"p50={np.percentile(lat, 50) * 1e6:.1f}us "
            f"p99={np.percentile(lat, 99) * 1e6:.1f}us")

    def per_chunk_of(path):
        calls = per_chunk_calls[path]
        return {n: calls.count(n) for n in set(calls)}

    if per_chunk_of("fp") != {"fused_dense": 5, "gravnet_block": 2}:
        fail(f"an fp chunk calls {per_chunk_calls['fp']}")
    other_path("fp", FP_EVENTS, per_chunk_of("fp"), redeploy=False)
    for path in ("fp_dp1", "mixed_no_fuse_int8"):
        pc = per_chunk_of(path)
        if pc.get("gravnet_aggregate") != 2 or "gravnet_block" in pc \
                or "gravnet_block_int8" in pc:
            fail(f"a {path} chunk calls {per_chunk_calls[path]}")
        other_path(path, SHORT_EVENTS, pc,
                   redeploy=paths[path]["precision"] == "mixed")
    say(f"phase 5 done at {time.perf_counter() - t_start:.1f}s")

    # 6. the ragged path ----------------------------------------------------
    heads = ("beta", "coords", "energy", "cls")

    def ragged_path(path, n_events):
        """Serve the first n_events of the ragged events, DISPATCH per
        call, with every counter at 0 just before; check the launch
        counts and hold heads and every CPS output bitwise to the
        plain-substituted run of phase 3."""
        pipe = pipes[path]
        feeds = {k: v[:n_events] for k, v in rg_feeds.items()}

        def warm():
            serve.serve_events(pipe, {k: v[:DISPATCH]
                                      for k, v in feeds.items()})
        warm()
        torch.cuda.synchronize()
        _, lat, elapsed = serve.serve_events(pipe, feeds)
        (res, _, _), launches, _ = counted(
            lambda: serve.serve_events(pipe, feeds), warm, path)
        path_launches[path] = launches
        n_launch = ragged_launches(pipe, n_events)
        g = pipe.pipe.graph
        dense = (sum(op.op_type in ("dense", "linear") for op in g)
                 + 3 * sum(op.op_type == "gravnet_block" for op in g))
        want = dict.fromkeys(wrappers, 0)
        want.update(fused_dense=dense * n_launch, knn_build=2 * n_launch,
                    knn_aggregate=2 * n_launch)
        if launches != want or per_chunk_calls[path].count("knn_build") != 2:
            fail(f"[{path}] launch counts {launches} != {want} ({dense} "
                 f"fused_dense, 2 knn_build, 2 knn_aggregate per launch)")
        say(f"[{path}] served {n_events} events in {n_launch} launches of "
            f"{RAGGED_BINS} bins: launches {launches}")
        heads_and_cps(res, rg_plain[path], n_events, path, bitwise=True,
                      every_cps=True)
        return res, lat, elapsed

    def against_padded(res, padded, n_events, label):
        """The real rows of every event within the float32 row of the
        padded path's, the rest zero; identical trigger decisions."""
        worst = 0.0
        for h in heads:
            for e, c in enumerate(rg_counts[:n_events]):
                got, want = res[h][e, :c], padded[h][e, :c]
                err = np.abs(got.astype(np.float64) - want)
                if (err > ATOL + RTOL * np.abs(want)).any() \
                        or res[h][e, c:].any():
                    fail(f"{label} head {h} event {e}: max|err| "
                         f"{err.max():.3e} against the padded fp path")
                worst = max(worst, float(err.max(initial=0.0)))
        if not np.array_equal(res["cps"]["trigger"],
                              padded["cps"]["trigger"][:n_events]):
            fail(f"{label}: trigger decisions differ from the padded path")
        say(f"{label} vs padded fp (design point 3) on {n_events} events: "
            f"real rows max|err|={worst:.3e}, trigger decisions identical")

    def rate(label, n_events, lat, elapsed, width=DISPATCH):
        say(f"serve ({label}): {n_events / elapsed:.1f} events/s, latency "
            f"p50={np.percentile(lat, 50) * 1e6:.1f}us "
            f"p99={np.percentile(lat, 99) * 1e6:.1f}us ({width} events "
            f"per call, {card})")

    rpipe = pipes["ragged"]
    res, lat, elapsed = ragged_path("ragged", RAGGED_EVENTS)
    serve.serve_events(pipes["fp"], {k: v[:DISPATCH] for k, v in
                                     rg_feeds.items()})
    padded, plat, pelapsed = serve.serve_events(pipes["fp"], rg_feeds)
    against_padded(res, padded, RAGGED_EVENTS, "ragged")
    # in turns: ragged, padded (above), padded, ragged
    _, plat2, pelapsed2 = serve.serve_events(pipes["fp"], rg_feeds)
    _, lat2, elapsed2 = serve.serve_events(rpipe, rg_feeds)
    for label, lt, el in (("ragged, design point 3, run 1", lat, elapsed),
                          ("padded fp, design point 3, run 1", plat,
                           pelapsed),
                          ("padded fp, design point 3, run 2", plat2,
                           pelapsed2),
                          ("ragged, design point 3, run 2", lat2, elapsed2)):
        rate(label, RAGGED_EVENTS, lt, el)
    say(f"ragged occupancy: {int(rg_counts.sum())} hits in "
        f"{RAGGED_EVENTS} events, {ragged_launches(rpipe, RAGGED_EVENTS)} "
        f"launches of {RAGGED_BINS}x{cfg.n_hits} rows")
    idle_share(lambda: serve.serve_events(
        rpipe, {k: v[:DISPATCH] for k, v in rg_feeds.items()}),
        "ragged calls of 16 events", "_ragged")
    res1, lat1, elapsed1 = ragged_path("ragged_dp1", SHORT_EVENTS)
    against_padded(res1, padded, SHORT_EVENTS, "ragged_dp1")
    rate("ragged, design point 1", SHORT_EVENTS, lat1, elapsed1)
    say(f"phase 6 done at {time.perf_counter() - t_start:.1f}s")

    # 7. the edge-based GNNs at their published widths ---------------------
    gnn_cfgs = {  # src/repro/configs/gatedgcn.py, graphsage_reddit.py
        "gatedgcn": gatedgcn.GatedGCNConfig(n_layers=16, d_hidden=70,
                                            d_in=8, d_edge_in=4,
                                            n_classes=2),
        "graphsage": graphsage.GraphSAGEConfig(n_layers=2, d_hidden=128,
                                               d_in=16, n_classes=5)}
    gnn_chunk_ms, gnn_feeds = {}, {}
    # the reference's CPU model, so the routes launch at its chunk shapes
    card_args = serve.parse_args(["--device", "cuda", "--platform", "cpu"])
    cpu_args = serve.parse_args(["--device", "cpu"])
    for gname, gcfg in gnn_cfgs.items():
        route = serve.MODELS[gname](card_args, gcfg)
        pipe = pipes[gname] = route.pipe
        mb = pipe.microbatch
        n_agg = sum(op.op_type == "edge_aggregate" for op in pipe.graph)
        if n_agg != (2 if gname == "gatedgcn" else 1) * gcfg.n_layers:
            fail(f"{gname}: {n_agg} edge_aggregate ops for "
                 f"{gcfg.n_layers} layers")
        say(f"deployed {gname} ({gcfg.n_layers} layers x {gcfg.d_hidden}, "
            f"d_in {gcfg.d_in}, {gcfg.n_classes} classes; graphs of "
            f"{serve._EDGE_N} nodes, {serve._EDGE_E} edges) at design "
            f"point 3, fp: microbatch={mb} segments={len(pipe.segments)}")
        # the path's kernel calls against their plain versions
        calls, per_chunk = record(pipe, route.events(16, 17)[0])
        per_chunk_calls[gname] = [c[0] for c in calls[:per_chunk]]
        for pos in range(per_chunk):
            name = calls[pos][0]
            for nb in (sorted({1, mb, 16}) if name == "edge_aggregate"
                       else (mb,)):
                if nb < mb:
                    _, args, kw = calls[pos]
                    args = [a[:nb] if i < EVENT_ARGS[name] else a
                            for i, a in enumerate(args)]
                else:
                    _, args, kw = stacked(calls, per_chunk, mb, pos, nb)
                check(gname, pos, nb, name, args, kw)
        del calls
        pc = {n: per_chunk_calls[gname].count(n)
              for n in set(per_chunk_calls[gname])}
        if set(pc) != {"fused_dense", "edge_aggregate"} \
                or pc["edge_aggregate"] != n_agg:
            fail(f"a {gname} chunk calls {pc}, expected {n_agg} "
                 "edge_aggregate and fused_dense only")
        # serve with every counter at 0 just before
        # at the width the reference's service serves its GNN routes
        # with: max(8, microbatch)
        batch = max(serve.MIN_ROUTES_BATCH, mb)
        feeds = gnn_feeds[gname] = route.events(GNN_EVENTS, 7)[0]

        def warm(pipe=pipe, feeds=feeds, batch=batch):
            pipe({k: v[:batch] for k, v in feeds.items()})
        warm()
        torch.cuda.synchronize()
        routed, elapsed = serve.serve_routes({gname: (pipe, feeds)}, batch)
        lat = routed[gname][1]
        (routed, _), launches, _ = counted(
            lambda pipe=pipe, feeds=feeds, batch=batch: serve.serve_routes(
                {gname: (pipe, feeds)}, batch), warm, gname)
        res = routed[gname][0]
        path_launches[gname] = launches
        n_chunks = sum(-(-min(batch, GNN_EVENTS - s) // mb)
                       for s in range(0, GNN_EVENTS, batch))
        want = dict.fromkeys(wrappers, 0)
        want.update({n: c * n_chunks for n, c in pc.items()})
        if launches != want:
            fail(f"[{gname}] launch counts {launches} != {want}")
        say(f"[{gname}] served {GNN_EVENTS} graphs, {batch} per dispatch, "
            f"in {n_chunks} chunks of {mb}: launches {launches} "
            f"({pc['edge_aggregate']} edge_aggregate and "
            f"{pc['fused_dense']} fused_dense per chunk)")
        logits = res["logits"]
        if logits.shape != (GNN_EVENTS, serve._EDGE_N, gcfg.n_classes) \
                or not np.isfinite(logits).all():
            fail(f"{gname} logits: shape {logits.shape} or non-finite")
        with substituted(plain_fns):
            plain_res = serve.serve_routes({gname: (Eager(pipe), feeds)},
                                           batch)[0][gname][0]
        if not np.array_equal(logits, plain_res["logits"]):
            err = np.abs(logits - plain_res["logits"]).max()
            fail(f"{gname} logits: kernels vs plain versions max|err|="
                 f"{err:.3e}, not bitwise")
        cpu_res, _, _ = serve.serve_events(
            serve.MODELS[gname](cpu_args, gcfg).pipe, feeds)
        want_cpu = cpu_res["logits"].astype(np.float64)
        err = np.abs(logits - want_cpu)
        if (err > ATOL + RTOL * np.abs(want_cpu)).any():
            fail(f"{gname} logits: max|err| {err.max():.3e} against the "
                 f"same deployment on the CPU (tolerance {ATOL:g} + "
                 f"{RTOL:g}·|cpu|)")
        say(f"{gname}: logits of {GNN_EVENTS} graphs bitwise equal to the "
            f"plain-substituted deployment on the card; max|err| "
            f"{err.max():.3e} against device='cpu' (tolerance {ATOL:g} + "
            f"{RTOL:g}·|cpu|)")
        rate(f"{gname}, design point 3, fp", GNN_EVENTS, lat, elapsed,
             batch)
        busy_us, by_kernel, _ = idle_share(
            lambda pipe=pipe, feeds=feeds: serve.serve_events(
                pipe, {k: v[:batch] for k, v in feeds.items()}),
            f"{gname} dispatches of {batch} graphs", f"_{gname}")
        # a chunk's device time: the two kernels' launches timed one by
        # one above (events at the path's micro-batch), beside the
        # library calls; and the profiled busy time of a served chunk
        rows_ = [r for n_ in ("fused_dense", "edge_aggregate")
                 for r in results[n_]["per_launch"]
                 if r["path"] == gname and r["events"] == mb]
        per = {n_: sum(r["ms"] for r in rows_
                       if per_chunk_calls[gname][r["op"]] == n_)
               for n_ in pc}
        lib_chunk = {n_: sum(r["library_ms"] or 0.0 for r in rows_
                             if per_chunk_calls[gname][r["op"]] == n_)
                     for n_ in pc}
        prof_chunks = 4 * -(-batch // mb)
        prof = {n_: sum(v[0] for k, v in by_kernel.items()
                        if f"{n_}_kernel" in k) / prof_chunks for n_ in pc}
        gnn_chunk_ms[gname] = {
            "kernels_ms": per, "library_ms": lib_chunk,
            "busy_ms": busy_us / prof_chunks / 1e3,
            "profiled_kernels_ms": {k: v / 1e3 for k, v in prof.items()}}
        say(f"[{gname}] device time per chunk of {mb} graphs: "
            + ", ".join(f"{n_} {per[n_]:.5f} ms ({pc[n_]} launches; "
                        f"library {lib_chunk[n_]:.5f})" for n_ in pc)
            + f" = {sum(per.values()):.5f} ms; profiled busy time "
            f"{busy_us / prof_chunks / 1e3:.5f} ms per chunk, of it "
            + ", ".join(f"{n_} {prof[n_] / 1e3:.5f}" for n_ in pc)
            + f" ({card})")

    # edge_aggregate on synthetic graphs of the routes' size: masked and
    # fractional edge weights, destinations outside [0, N)
    gen = torch.Generator().manual_seed(5)
    n_nodes, n_edges = serve._EDGE_N, serve._EDGE_E
    stray = torch.tensor([-1, n_nodes, n_nodes + 5, -n_nodes],
                         dtype=torch.int32)
    for d in EDGE_WIDTHS:
        for reduce in ("sum", "mean"):
            for nb in EDGE_BATCHES:
                msg = torch.randn(nb, n_edges, d, generator=gen)
                dst = torch.randint(0, n_nodes, (nb, n_edges), generator=gen,
                                    dtype=torch.int32)
                dst[:, ::16] = stray.repeat(n_edges // 64)
                mask = (torch.rand(nb, n_edges, generator=gen)
                        < 0.7).float()
                mask[:, 1::16] = 0.5
                check("synthetic", 0, nb, "edge_aggregate",
                      [msg.to(dev), dst.to(dev), mask.to(dev)],
                      {"n_nodes": n_nodes, "reduce": reduce})
    # and on the inputs that stress its design (kernels/f32_cases.py):
    # E past one warp round and past the staged plans, one node taking
    # every edge, every edge masked, every dst out of range, odd widths;
    # the shared-memory plans against the built library's own
    e_max = edge_mod.max_edges()
    for case, (nb, e, d, kind) in f32_cases.EDGE_CASES.items():
        for reduce in ("sum", "mean"):
            check(f"edge:{case}", 0, nb, "edge_aggregate", as_args(
                f32_cases.edge_inputs(nb, e or e_max, d, kind,
                                      seed=len(case))),
                  {"n_nodes": f32_cases.EDGE_NODES, "reduce": reduce})
    for e in (0, 1, 33, 256, 1000, e_max):
        for cw in (1, 2, 8, 16, 32):
            for staged in (False, True):
                if edge_mod.library_smem_bytes(e, cw, staged) \
                        != edge_mod.smem_bytes(e, cw, staged):
                    fail(f"edge_aggregate: E={e} cw={cw} staged={staged} "
                         f"plans {edge_mod.smem_bytes(e, cw, staged)} B, "
                         f"the library "
                         f"{edge_mod.library_smem_bytes(e, cw, staged)}")
    say(f"edge_aggregate: shared-memory plans equal the library's; the "
        f"largest E a launch takes: {e_max}")

    # the three routes through the serve entry point
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            rc = serve.main(["--model", "ccn", "gatedgcn", "graphsage",
                             "--events", "48"])
    except SystemExit as e:
        rc = e.code
    for line in buf.getvalue().splitlines():
        say(f"  {line}")
    answered = [m for m in ("ccn", "gatedgcn", "graphsage")
                if f"route {m}: 16 events" in buf.getvalue()
                and re.search(rf"route {m}: .*answered=16 in-order=True",
                              buf.getvalue())]
    if rc != 0 or len(answered) != 3:
        fail(f"serve --model ccn gatedgcn graphsage: exit {rc}, routes that "
             f"answered all 16 of their events: {answered}")
    say(f"phase 7 done at {time.perf_counter() - t_start:.1f}s")

    # 8. the attention op and the tuning layer ------------------------------
    from repro_torch.core.graph_ir import Graph, Operator
    from repro_torch.core.pipeline import Requirements
    from repro_torch.core.pipeline import deploy as deploy_graph
    from repro_torch.tuning import (TuningCache, autotune_graph,
                                    flash_attention_key,
                                    graph_kernel_problems, warm_from_cache)
    from repro_torch.tuning.candidates import flash_attention_candidates
    t8 = time.perf_counter()
    gen = torch.Generator().manual_seed(11)

    def qkv(bh, s_len, t_len, d):
        return [torch.randn(bh, n, d, generator=gen).to(dev)
                for n in (s_len, t_len, t_len)]

    def padded(q, k, v, bq, bk):
        bq, bk = min(bq, q.shape[1]), min(bk, k.shape[1])
        return ([kops._pad_rows(q, bq).contiguous(),
                 kops._pad_rows(k, bk).contiguous(),
                 kops._pad_rows(v, bk).contiguous()], bq, bk)

    # (a) the kernel against its plain version: the float32 row (the
    # kernel runs on FMAs, in its own order), bf16 inputs the bfloat16 row;
    # where the wrapper splits the kv tiles, also unsplit, to time the split
    def flash_checks(args, kw):
        check("shapes", 0, args[0].shape[0], "flash_attention", args, kw)
        chunk, nsplit = kv_split(args[0].shape[0], args[0].shape[1],
                                 args[1].shape[1], bq=kw["bq"], bk=kw["bk"],
                                 n_sm=torch.cuda.get_device_properties(
                                     dev).multi_processor_count)
        if nsplit > 1:
            check("shapes", 0, args[0].shape[0], "flash_attention", args,
                  {**kw, "splits": 1})

    for bh, s_len, t_len, d in ATTN_SHAPES:
        args, bq, bk = padded(*qkv(bh, s_len, t_len, d), 128, 128)
        for a in (args, [x.to(torch.bfloat16) for x in args]):
            flash_checks(a, {"causal": True, "bq": bq, "bk": bk})
    base = qkv(8, 512, 512, 64)
    for a in (base, [x.to(torch.bfloat16) for x in base]):
        flash_checks(a, {"causal": False, "bq": 128, "bk": 128})
    q, k, v = qkv(8, 1000, 1000, 64)
    args, bq, bk = padded(q, k, v, 128, 128)
    check("shapes", 0, 8, "flash_attention", args,
          {"causal": True, "bq": bq, "bk": bk})
    cut = kops.flash_attention(q, k, v)
    want_cut = ref.flash_attention_blocked_ref(*args, bq=bq, bk=bk)[:, :1000]
    cut_err = (cut.double() - want_cut.double()).abs()
    if cut.shape != want_cut.shape or bool(
            (cut_err > ATOL + RTOL * want_cut.double().abs()).any()):
        fail("ops.flash_attention at S = 1000: the padded kernel's output "
             f"cut to S is not within the float32 row of the plain "
             f"version's (max|err| {cut_err.max().item():.3e})")
    cands = flash_attention_candidates(512, 512, 64)
    for c in cands:
        check("candidates", 0, 8, "flash_attention", base,
              {"causal": True, **c})
    for d in (8, 40, 64, 72, 128):
        for bq in (16, 32, 48, 64, 128, 256):
            for bk in (16, 32, 48, 64, 128, 256):
                if library_smem_bytes(bq, bk, d) != smem_bytes(bq, bk, d):
                    fail(f"flash_attention_smem_bytes({bq}, {bk}, {d}) = "
                         f"{library_smem_bytes(bq, bk, d)} in the library, "
                         f"{smem_bytes(bq, bk, d)} in Python")
    say(f"flash_attention: within the float32 row (bf16: the bfloat16 row) "
        f"at {len(ATTN_SHAPES) + 2} shapes and {len(cands)} block plans "
        f"{[(c['bq'], c['bk']) for c in cands]}; shared-memory plans agree "
        "with the library")

    # (b) the deployed attention graph
    def attention_graph():
        rng = np.random.default_rng(0)
        g = Graph()
        g.add(Operator(name="tok", op_type="input", out_dim=ATTN_D,
                       attrs={"feature": "tok"}))
        for nm in ("q", "k", "v"):
            w = rng.normal(size=(ATTN_D, ATTN_D)) / np.sqrt(ATTN_D)
            g.add(Operator(name=nm, op_type="linear", inputs=["tok"],
                           params={"w": torch.tensor(w, dtype=torch.float32),
                                   "b": torch.zeros(ATTN_D)},
                           out_dim=ATTN_D))
        g.add(Operator(name="attn", op_type="attention",
                       inputs=["q", "k", "v"], attrs={"causal": True},
                       out_dim=ATTN_D))
        g.add(Operator(name="out", op_type="output", inputs=["attn"],
                       attrs={"head_names": ["y"]}, out_dim=ATTN_D))
        return g

    attn_req = Requirements(design_point=3, platform="cpu",
                            precision_policy="fp", n_hits=ATTN_N,
                            target_throughput=1e3)

    def deploy_attention(device=dev, cache=None):
        return deploy_graph(attention_graph(), attn_req, batch=ATTN_BATCH,
                            tuning_cache=cache, device=device)

    apipe = pipes["attention"] = deploy_attention()
    tok = np.random.default_rng(1).normal(
        size=(ATTN_EVENTS, ATTN_N, ATTN_D)).astype(np.float32)
    afeeds = {"tok": tok}
    # the fusion pass merges the q, k, v denses, siblings on one input,
    # into one wider dense and slices, as the reference's does
    n_dense = sum(op.op_type in ("dense", "linear") for op in apipe.graph)
    calls, per_chunk = record(apipe, {"tok": tok[:2 * ATTN_BATCH]})
    per_chunk_calls["attention"] = [c[0] for c in calls[:per_chunk]]
    if sorted(per_chunk_calls["attention"]) != ["flash_attention"] + [
            "fused_dense"] * n_dense or n_dense == 0:
        fail(f"an attention chunk calls {per_chunk_calls['attention']}, "
             f"the graph has {n_dense} denses")
    for pos in range(per_chunk):
        check("attention", pos, ATTN_BATCH, *calls[pos])
    del calls

    def awarm():
        serve.serve_events(apipe, {"tok": tok[:DISPATCH]})
    awarm()
    torch.cuda.synchronize()
    _, alat, aelapsed = serve.serve_events(apipe, afeeds)
    (ares, _, _), launches, by_blocks = counted(
        lambda: serve.serve_events(apipe, afeeds), awarm, "attention")
    path_launches["attention"] = launches
    n_chunks = ATTN_EVENTS // ATTN_BATCH
    want = dict.fromkeys(wrappers, 0)
    want.update(flash_attention=n_chunks, fused_dense=n_dense * n_chunks)
    if launches != want or by_blocks != {(128, 128): n_chunks}:
        fail(f"[attention] launch counts {launches} {by_blocks} != {want} "
             f"(one flash_attention at (128, 128) and {n_dense} fused_dense "
             "per micro-batch)")
    y = ares["y"]
    if y.shape != (ATTN_EVENTS, ATTN_N, ATTN_D) or not np.isfinite(y).all():
        fail(f"attention output: shape {y.shape} or non-finite")
    with substituted(plain_fns):
        plain_y = serve.serve_events(Eager(apipe), afeeds)[0]["y"]
    perr = np.abs(y - plain_y.astype(np.float64))
    if (perr > ATOL + RTOL * np.abs(plain_y)).any():
        fail(f"attention output: kernels vs plain versions max|err|="
             f"{perr.max():.3e}, outside the float32 row")
    cpu_y = serve.serve_events(deploy_attention("cpu"), afeeds)[0]["y"]
    err = np.abs(y - cpu_y.astype(np.float64))
    if (err > ATOL + RTOL * np.abs(cpu_y)).any():
        fail(f"attention output: max|err| {err.max():.3e} against "
             f"device='cpu' (tolerance {ATOL:g} + {RTOL:g}·|cpu|)")
    say(f"[attention] served {ATTN_EVENTS} events (n {ATTN_N}, d {ATTN_D}) "
        f"in {n_chunks} micro-batches of {ATTN_BATCH}: launches {launches}; "
        f"output within the float32 row of the plain-substituted deployment"
        f" (max|err| {perr.max():.3e}) and of device='cpu' (max|err| "
        f"{err.max():.3e})")
    rate("attention, design point 3, fp, batch 8", ATTN_EVENTS, alat,
         aelapsed)
    idle_share(lambda: serve.serve_events(apipe, {"tok": tok[:DISPATCH]}),
               f"attention dispatches of {DISPATCH} events", "_attention")

    # (c) tuning: search, bind, launch, persist, warm
    cache = TuningCache()
    buf = io.StringIO()
    t_tune = time.perf_counter()
    with redirect_stdout(buf):
        n_att = autotune_graph(apipe.graph, n_rows=ATTN_N, backend="cuda",
                               cache=cache, batch=ATTN_BATCH, verbose=True)
        n_ccn = autotune_graph(pipes["mixed"].graph, n_rows=cfg.n_hits,
                               backend="cuda", cache=cache, verbose=True)
    for line in buf.getvalue().splitlines():
        say(f"  {line}")
    keys = (graph_kernel_problems(apipe.graph, n_rows=ATTN_N,
                                  backend="cuda", batch=ATTN_BATCH)
            + graph_kernel_problems(pipes["mixed"].graph,
                                    n_rows=cfg.n_hits, backend="cuda"))
    if n_att + n_ccn != len(set(keys)) or set(cache.entries()) != set(keys):
        fail(f"autotune_graph tuned {n_att} + {n_ccn} problems, the "
             f"deployments emit {len(set(keys))}")
    fkey = flash_attention_key(ATTN_BATCH, ATTN_N, ATTN_N, ATTN_D,
                               "float32", "cuda")
    fentry = cache.entry(fkey)
    if fentry is None or fentry.candidates != len(cands):
        fail(f"flash_attention's entry {fentry} did not search the "
             f"{len(cands)} kept plans")
    winner = (fentry.config["bq"], fentry.config["bk"])
    say(f"tuned {len(cache)} problems in {time.perf_counter() - t_tune:.1f}s"
        f"; flash_attention {fkey.encode()}: winner bq,bk={winner} "
        f"{fentry.us:.1f}us against the default's {fentry.default_us:.1f}us "
        f"(the card's clock: CUDA events around back-to-back calls; "
        f"{fentry.candidates} plans)")
    # the tuner's contract on the card: the bound winner's device time
    # is at most the default's (timed here in turns, default, winner,
    # winner, default, on the deployment's q, k, v shape)
    tq = qkv(ATTN_BATCH, ATTN_N, ATTN_N, ATTN_D)
    plans_ms = [timer.device_ms(lambda c=c: kops.flash_attention(
        *tq, causal=True, bq=c[0], bk=c[1]), 200)
        for c in ((128, 128), winner, winner, (128, 128))]
    default_ms = (plans_ms[0] + plans_ms[3]) / 2
    winner_ms = (plans_ms[1] + plans_ms[2]) / 2
    if winner != (128, 128) and not winner_ms <= default_ms:
        fail(f"the tuner bound {winner} at {winner_ms:.5f} ms of device "
             f"time, slower than the default (128, 128) at "
             f"{default_ms:.5f} ms")
    tuner_row = {"winner": list(winner), "winner_ms": winner_ms,
                 "default_ms": default_ms, "tuner_us": fentry.us,
                 "tuner_default_us": fentry.default_us}
    say(f"tuner row: the bound winner {winner} takes {winner_ms:.5f} ms of "
        f"device time a call (ops.flash_attention), the default (128, 128) "
        f"{default_ms:.5f} ms: "
        + ("the winner is the default" if winner == (128, 128)
           else "at most the default's") + f" ({card})")
    tpipe = deploy_attention(cache=cache)
    knobs = tpipe.graph["attn"].attrs_opt
    if (knobs.get("bq"), knobs.get("bk")) != winner:
        fail(f"the redeployed attention op binds {knobs}, the cache's "
             f"winner is {winner}")
    (tres, _, _), _, by_blocks = counted(
        lambda: serve.serve_events(tpipe, {"tok": tok[:DISPATCH]}),
        lambda: serve.serve_events(tpipe, {"tok": tok[:ATTN_BATCH]}),
        "attention, tuned")
    ty = tres["y"]
    if by_blocks != {winner: DISPATCH // ATTN_BATCH}:
        fail(f"the tuned deployment launched {by_blocks}, not the winner "
             f"{winner}")
    terr = np.abs(ty - y[:DISPATCH].astype(np.float64))
    if (terr > ATOL + RTOL * np.abs(y[:DISPATCH])).any():
        fail(f"the tuned deployment's output: max|err| {terr.max():.3e} "
             "against the untuned one")
    cache_path = OUT / "tuning_cache.json"
    cache.save(cache_path)
    back = TuningCache.load(cache_path)
    if back.load_error or {k: e.to_json() for k, e in back.entries().items()} \
            != {k: e.to_json() for k, e in cache.entries().items()}:
        fail(f"tuning cache round trip: {back.load_error or 'entries differ'}")
    warmed = warm_from_cache(back)
    if warmed != len(back):
        fail(f"warm_from_cache warmed {warmed} of {len(back)} entries")
    say(f"the redeployed attention op binds and launches {winner} "
        f"({by_blocks}); output within the float32 row of the untuned "
        f"deployment (max|err| {terr.max():.3e}); cache saved to "
        f"{cache_path.relative_to(ROOT)} and loaded back equal; "
        f"warm_from_cache warmed {warmed} of {len(back)}")

    # (d) the serve entry point: tune and save, then bind from the file
    serve_cache = OUT / "serve_tuning_cache.json"
    serve_cache.unlink(missing_ok=True)
    outs = []
    for extra in (["--tune"], []):
        buf = io.StringIO()
        try:
            with redirect_stdout(buf):
                rc = serve.main(extra + ["--tuning-cache", str(serve_cache),
                                         "--train-steps", "0",
                                         "--events", str(ATTN_EVENTS)])
        except SystemExit as e:
            rc = e.code
        for line in buf.getvalue().splitlines():
            say(f"  {line}")
        if rc != 0 or f"answered={ATTN_EVENTS} in-order=True" \
                not in buf.getvalue():
            fail(f"serve {' '.join(extra)} --tuning-cache: exit {rc}, not "
                 f"every one of {ATTN_EVENTS} events answered")
        outs.append(buf.getvalue())
    n_saved = len(TuningCache.load(serve_cache))
    if not re.search(r"autotuned [1-9]\d* kernel problem", outs[0]) \
            or "autotuned" in outs[1] or "[tune]" in outs[1] \
            or f"{n_saved} of {n_saved} kernel problems bound" not in outs[1]:
        fail("serve --tune then --tuning-cache: the first run must search "
             "and save, the second bind every problem without searching")
    say(f"serve: --tune searched and saved {n_saved} problems; the run on "
        "the saved cache bound all of them without searching")
    say(f"phase 8 done at {time.perf_counter() - t_start:.1f}s "
        f"({time.perf_counter() - t8:.1f}s)")

    # 9. the whole-pipeline compile: captured chunks against eager ones ---
    t9 = time.perf_counter()

    def leaves(tree, pre=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{pre}/{k}")
        else:
            yield pre, tree

    def host_ms(call, feeds_dev, n_chunks):
        """Host wall per chunk of one dispatch: the call's time until it
        returns (its work enqueued), over its chunks; then a sync."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        call(feeds_dev)
        dt = time.perf_counter() - t
        torch.cuda.synchronize()
        return dt * 1e3 / n_chunks

    capture_rows = {}

    def captured_vs_eager(path, pipe, feeds, width):
        """Serve ``feeds`` through the captured deployment and through
        its eager run_chunk loop: every output bitwise equal; then in
        turns (captured, eager, eager, captured, captured, eager) the
        events/s, latency p50/p99 and the host wall per chunk of one
        dispatch (on device feeds; a ragged launch is its one chunk),
        and their medians."""
        n = len(next(iter(feeds.values())))
        eager = Eager(pipe)
        outs = [serve.serve_routes({path: (p, feeds)}, width)[0][path][0]
                for p in (pipe, eager)]
        a, b = (dict(leaves(o)) for o in outs)
        diff = sorted(k for k in a if not np.array_equal(a[k], b.get(k)))
        if set(a) != set(b) or diff:
            fail(f"[{path}] captured outputs differ from the eager run_chunk "
                 f"loop's: {diff or sorted(set(a) ^ set(b))}")
        unit = "chunk"
        if isinstance(pipe, RaggedPipeline):
            one = []    # the first launch's feeds of one dispatch
            pipe._launch({k: v[:width] for k, v in feeds.items()},
                         lambda f: one.append(f) or pipe.pipe(f))
            inner, hfeeds, chunks, unit = pipe.pipe, one[0], 1, "launch"
        else:
            inner, chunks = pipe, -(-width // pipe.microbatch)
            hfeeds = {k: v[:width] for k, v in feeds.items()}
        hfeeds = {k: torch.as_tensor(np.asarray(v)).to(dev)
                  for k, v in hfeeds.items()}
        calls = {"captured": (pipe, inner), "eager": (eager,
                                                      inner.run_eager)}
        stats = {"captured": [], "eager": []}
        for mode in ("captured", "eager", "eager", "captured", "captured",
                     "eager"):
            routed, elapsed = serve.serve_routes(
                {path: (calls[mode][0], feeds)}, width)
            lat = routed[path][1]
            stats[mode].append([
                n / elapsed, np.percentile(lat, 50) * 1e6,
                np.percentile(lat, 99) * 1e6,
                host_ms(calls[mode][1], hfeeds, chunks)])
        med = {m: dict(zip(("events_s", "p50_us", "p99_us",
                            "host_ms_per_chunk"),
                           np.median(np.array(v), axis=0).tolist()))
               for m, v in stats.items()}
        # of a captured chunk's host time, the replay of its graphs alone
        cap = next(iter(inner._graphs._by_sig.values()))
        med["captured"]["host_ms_replay"] = float(np.median([
            host_ms(lambda _: [g.replay() for g in cap.graphs], None, 1)
            for _ in range(5)]))
        capture_rows[path] = {**med, "events": n, "width": width,
                              "captures": pipe.captures,
                              "graphs_per_chunk": len(cap.graphs),
                              "runs": {m: v for m, v in stats.items()}}
        for m in ("captured", "eager"):
            r = med[m]
            say(f"[{path}] {m}: {r['events_s']:.1f} events/s, latency "
                f"p50={r['p50_us']:.1f}us p99={r['p99_us']:.1f}us, host "
                f"{r['host_ms_per_chunk']:.4f} ms per {unit}"
                + (f" (replaying its {len(cap.graphs)} graph(s) "
                   f"{r['host_ms_replay']:.4f})" if m == "captured" else "")
                + f" (median of 3; {n} events, {width} per dispatch, "
                f"{card})")
        return med

    cev = generate(gen_cfg, CAPTURE_EVENTS, seed=7)
    ccn_feeds = {"hits": cev["feats"], "mask": cev["mask"]}
    # the served default (warm-trained, at its P on the H100's model)
    # first, with the profiler's cross-check: its two kernels as many
    # times per replay as its segments' P-chunks launch them; a dispatch
    # of its serving width, max(microbatch, 16)
    mt = pipes["served_trained"]
    mt_width = max(DISPATCH, mt.microbatch)
    captured_vs_eager("served_trained", mt, ccn_feeds, mt_width)
    disp = {k: v[:mt_width] for k, v in ccn_feeds.items()}
    replays = 4 * mt_width // mt.microbatch
    per_replay = chunk_launches(mt)
    idle = {}
    for mode, p in (("captured", mt), ("eager", Eager(mt))):
        busy, by_kernel, wall = idle_share(
            lambda p=p: serve.serve_events(p, disp),
            f"{mode} dispatches of {mt_width} events (the served default, "
            "trained)", f"_mixed_{mode}")
        idle[mode] = {"busy_us": busy, "wall_us": wall,
                      "idle_share": 1 - busy / wall if busy else None}
        seen = {n_: sum(c for k, (_, c) in by_kernel.items()
                        if re.search(rf"(?<!\w){n_}_kernel(?!\w)", k))
                for n_ in ("fused_dense_int8", "gravnet_block_int8")}
        if mode == "captured" and seen != {n_: c * replays for n_, c in
                                           per_replay.items()}:
            fail(f"[served_trained] the profiler saw {seen} kernel runs "
                 f"over {replays} replays, expected {per_replay} per replay")
        say(f"[served_trained] profiler, {mode}: {seen} kernel runs over "
            f"{replays} chunks")
    capture_rows["served_trained"]["idle"] = idle
    for path in ("fp", "fp_dp1", "mixed_no_fuse_int8"):
        captured_vs_eager(path, pipes[path], ccn_feeds, DISPATCH)
    captured_vs_eager("ragged", pipes["ragged"], rg_feeds, DISPATCH)
    for gname, gfeeds in gnn_feeds.items():
        width = max(serve.MIN_ROUTES_BATCH, pipes[gname].microbatch)
        captured_vs_eager(gname, pipes[gname], gfeeds, width)
        if gname == "gatedgcn":
            gdisp = {k: v[:width] for k, v in gfeeds.items()}
            idle_g = {}
            for mode, p in (("captured", pipes[gname]),
                            ("eager", Eager(pipes[gname]))):
                busy, _, wall = idle_share(
                    lambda p=p: serve.serve_events(p, gdisp),
                    f"{mode} GatedGCN dispatches of {width} graphs",
                    f"_gatedgcn_{mode}")
                idle_g[mode] = {"busy_us": busy, "wall_us": wall,
                                "idle_share": 1 - busy / wall if busy
                                else None}
            capture_rows[gname]["idle"] = idle_g
    captured_vs_eager("attention", apipe, afeeds, DISPATCH)
    # CPS alone on one chunk's heads of the served default: its device
    # time eager and captured (one CUDA graph of its k_max steps)
    cev = generate(gen_cfg, mt.microbatch, seed=7)
    heads_ = mt({"hits": cev["feats"], "mask": cev["mask"]})
    cps_in = ({"beta_logit": heads_["beta"][..., 0].contiguous(),
               "coords": heads_["coords"].contiguous(),
               "energy": heads_["energy"][..., 0].contiguous()},
              torch.from_numpy(cev["mask"]).to(dev))
    cps_want = ccn.cps(*cps_in, cfg)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ccn.cps(*cps_in, cfg)
    torch.cuda.current_stream().wait_stream(side)
    cps_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cps_graph):
        cps_got = ccn.cps(*cps_in, cfg)
    cps_graph.replay()
    torch.cuda.synchronize()
    for k, v in cps_want.items():
        if not torch.equal(cps_got[k], v):
            fail(f"captured cps {k} differs from eager cps")
    cps_rows = {
        "captured_device_ms": timer.device_ms(cps_graph.replay, 200),
        # few calls: ~100 launches each would fill the launch queue and
        # pace the card by the host
        "eager_device_ms": timer.device_ms(lambda: ccn.cps(*cps_in, cfg),
                                           5),
        "eager_host_ms": float(np.median([host_ms(
            lambda _: ccn.cps(*cps_in, cfg), None, 1) for _ in range(5)])),
        "captured_host_ms": float(np.median([host_ms(
            lambda _: cps_graph.replay(), None, 1) for _ in range(5)])),
        "events": mt.microbatch}
    capture_rows["cps"] = cps_rows
    say(f"cps alone on one chunk's heads ({mt.microbatch} events): device "
        f"{cps_rows['captured_device_ms']:.5f} ms captured, "
        f"{cps_rows['eager_device_ms']:.5f} ms eager; host "
        f"{cps_rows['captured_host_ms']:.4f} ms to replay, "
        f"{cps_rows['eager_host_ms']:.4f} ms to enqueue eagerly ({card})")
    capture_rows["tuner"] = tuner_row
    (OUT / "capture.json").write_text(json.dumps(capture_rows, indent=1))
    say(f"phase 9 done at {time.perf_counter() - t_start:.1f}s "
        f"({time.perf_counter() - t9:.1f}s)")

    # 10. the service: ShardedTriggerService, one lane per replica --------
    t10 = time.perf_counter()
    from repro_torch.serving import ShardedTriggerService
    service_rows = {}

    def leaves_equal(got, want, label):
        """Every output leaf of the served events bitwise equal to the
        plain captured loop's."""
        a, b = dict(leaves(got)), dict(leaves(want))
        diff = sorted(k for k in b if not np.array_equal(a.get(k), b[k]))
        if set(a) != set(b) or diff:
            fail(f"[{label}] served events differ from serve_events on the "
                 f"same deployment: {diff or sorted(set(a) ^ set(b))}")

    def released_once_in_order(served, summary, label, n):
        """Every event released once, in submission order, answered."""
        if served.order != list(range(n)) or served.failed \
                or summary["completed"] != n \
                or sum(r["completed"] for r in summary["per_replica"]) != n:
            fail(f"[{label}] release: order {served.order[:8]}... of {n}, "
                 f"{served.failed} failed, completed {summary['completed']}")

    def lanes_captured_before_traffic(captures, label):
        if not captures or any(c["captures"] != c["captured_at_start"]
                               or c["captured_at_start"] < 1
                               for c in captures):
            fail(f"[{label}] lane captures {captures}: each lane must capture "
                 "before traffic and nothing during it")

    def profiled(label, make_svc, routed, expect=None):
        """A fresh service on the same deployment: its counted run (every
        counter at 0 just before, the profiler's kernel records equal to
        the counters), its lanes' captures unchanged under traffic, and
        the idle share over 4 calls of a quarter of the events."""
        svc = make_svc()
        try:
            n = sum(len(next(iter(f.values()))) for f in routed.values())
            part = {r: {k: v[:max(1, len(v) // 4)] for k, v in f.items()}
                    for r, f in routed.items()}
            ran = {}

            def call():
                ran["before"] = batches_ran(svc)
                out = serve.submit_all(svc, routed)
                ran["during"] = batches_ran(svc) - ran["before"]
                return out
            (served, launches, _) = counted(
                call, lambda: serve.submit_all(svc, part),
                f"service {label}")
            if served.failed or served.order != list(range(n)):
                fail(f"[service {label}] the counted run: {served.failed} "
                     "failed or out of order")
            if expect is not None and expect(svc, launches, ran["during"]):
                fail(f"[service {label}] launches {launches}: "
                     f"{expect(svc, launches, ran['during'])}")
            busy, _, wall = idle_share(
                lambda: serve.submit_all(svc, part),
                f"service calls of {label}",
                "_service_" + label.replace(" ", "_"))
            svc.drain()
            lanes_captured_before_traffic(svc.capture_summary(),
                                          f"service {label}, profiled")
        finally:
            svc.close()
        path_launches[f"service {label}"] = launches
        return launches, (1 - busy / wall) if busy else None

    def plain_rate(report):
        """The plain captured loop on the report's deployment and events,
        timed right after the service: events/s, p50 and p99 µs."""
        routes = {sv.name: (sv.pipe, report.feeds[sv.name])
                  for sv in report.servables}
        res, elapsed = serve.serve_routes(
            routes, None if len(routes) == 1 else
            serve.service_width(report.servables))
        n = sum(len(r[1]) for r in res.values())
        lat = np.concatenate([r[1] for r in res.values()])
        return res, {"events_s": n / elapsed,
                     "p50_us": float(np.percentile(lat, 50) * 1e6),
                     "p99_us": float(np.percentile(lat, 99) * 1e6)}

    def batches_ran(svc):
        """Batches the service launched that ran (one failed by an
        injected fault ran no kernel)."""
        return sum(r.stats.batches for r in svc.replicas) - (
            svc.faults.counts()["fail"] if svc.faults is not None else 0)

    def mixed_launches(svc, launches, ran):
        """The int8 pair as many times per chunk as the lane's deployment
        launches them (``chunk_launches``), per chunk of every launch that
        ran in the counted run, nothing else."""
        lane = svc.replicas[0].lane
        chunks = ran * (svc.microbatch // lane.microbatch)
        want = dict.fromkeys(wrappers, 0)
        want.update({n: c * chunks for n, c in
                     chunk_launches(lane.parent).items()})
        return None if launches == want else f"expected {want}"

    def row(label, served, s_, plain, idle, launches):
        bud = s_["budget"]
        n = sum(len(v) for v in served.results.values())
        r = {"events": n, "events_s": n / served.elapsed_s,
             "p50_us": s_["p50_us"], "p99_us": s_["p99_us"],
             "budget_us": bud, "batches": s_["batches"],
             "padded_events": s_["padded_events"], "idle_share": idle,
             "plain_loop": plain, "launches": launches,
             "per_replica": [{k: p[k] for k in ("replica_id", "completed",
                                                "batches")}
                             for p in s_["per_replica"]]}
        service_rows[label] = r
        say(f"[service {label}] {n} events: {r['events_s']:.1f} events/s, "
            f"p50={r['p50_us']:.1f}us p99={r['p99_us']:.1f}us, budget "
            f"queue_wait={bud['queue_wait_us_mean']:.1f}us dispatch="
            f"{bud['dispatch_us_mean']:.1f}us compute="
            f"{bud['compute_us_mean']:.1f}us, {r['batches']} batches, "
            f"{r['padded_events']} padded events, idle share "
            + ("not measured" if idle is None else f"{idle:.4f}")
            + f"; the plain captured loop on the same deployment and events:"
            f" {plain['events_s']:.1f} events/s, p50={plain['p50_us']:.1f}us"
            f" p99={plain['p99_us']:.1f}us ({card})")

    def routes_equal(report, label):
        """Every served event bitwise equal to serve_events on the same
        deployment; the plain loop's rate."""
        res, plain = plain_rate(report)
        for (route, got), sv in zip(report.served.results.items(),
                                    report.servables):
            leaves_equal(serve.stack_results(got), res[sv.name][0],
                         f"{label} {sv.name}")
        return plain

    def serve_run(label, argv, expect=None, equal=routes_equal):
        """``serve.run(argv)`` (``python -m repro_torch.launch.serve``),
        its output into the log; every event held bitwise against the
        plain loop on the same deployment (``equal``), released once and
        in order, the lanes captured before traffic only; then the
        counted and profiled run of a fresh service on the same
        deployment."""
        buf = io.StringIO()
        try:
            with redirect_stdout(buf):
                report = serve.run(argv)
        except SystemExit as e:
            for line in buf.getvalue().splitlines():
                say(f"  [{label}] {line}")
            fail(f"serve {' '.join(argv)}: exit {e.code}")
        for line in buf.getvalue().splitlines():
            say(f"  [{label}] {line}")
        n = sum(len(v) for v in report.served.results.values())
        released_once_in_order(report.served, report.summary, label, n)
        lanes_captured_before_traffic(report.captures, label)
        plain = equal(report, label)
        say(f"[service {label}] {n} events answered once each, in "
            "submission order, bitwise equal to the plain loop on the same "
            "deployment; every lane captured before traffic and nothing "
            "during it")
        routed = {(None if len(report.servables) == 1 else sv.name):
                  report.feeds[sv.name] for sv in report.servables}
        with redirect_stdout(io.StringIO()):   # its chaos line, again
            fk = serve.fault_kwargs(report.args)
        launches, idle = profiled(label, lambda: serve.build_service(
            report.args, report.servables,
            monitor=serve.monitor_config(report.args), **fk), routed, expect)
        row(label, report.served, report.summary, plain, idle, launches)
        return report

    # (a) the default run: warm-trained mixed, design point 3, one
    # replica, the streaming loop, 512 events
    default_report = serve_run("default", [], mixed_launches)
    # (b) two replicas, each policy; (c) the deadline loop
    # on the default's random weights: the service is under test here
    for policy in ("round_robin", "least_loaded"):
        serve_run(f"replicas 2 {policy}", ["--replicas", "2", "--policy",
                                           policy, "--train-steps", "0"],
                  mixed_launches)
    serve_run("deadline loop", ["--loop", "deadline", "--train-steps", "0"],
              mixed_launches)
    # (d) the GNN routes
    serve_run("routes", ["--model", "gatedgcn", "graphsage"])
    # (f) a dead lane: replica 1 fails every batch, failover to replica 0
    dead = serve_run("dead lane", ["--replicas", "2", "--inject-faults",
                                   "fail:p=1.0,replica=1", "--max-retries",
                                   "2", "--train-steps", "0"],
                     mixed_launches)
    ft = dead.fault_tolerance
    if dead.served.failed or not ft["failed_over"] or \
            dead.summary["per_replica"][1]["completed"]:
        fail(f"[service dead lane] {dead.served.failed} client-visible "
             f"failures, fault tolerance {ft}")
    say(f"[service dead lane] 0 client-visible failures: retried="
        f"{ft['retried']} failed_over={ft['failed_over']} breaker open="
        f"{ft['breaker']['open']}")
    # (e) a ragged= service over deploy(ragged=True, batch=8), 16 events a
    # launch of the service, held against serve_events on the same
    # deployment
    rpipe = pipes["ragged"]

    def ragged_service():
        return ShardedTriggerService(ragged=rpipe, n_replicas=1,
                                     microbatch=DISPATCH, window_s=2e-3,
                                     loop="streaming")
    svc = ragged_service()
    try:
        rcap = svc.capture_summary()
        served = serve.submit_all(svc, {None: rg_feeds})
        svc.drain()
        rsum = svc.stats.summary()
        rcaps = svc.capture_summary()
    finally:
        svc.close()
    released_once_in_order(served, rsum, "ragged", RAGGED_EVENTS)
    lanes_captured_before_traffic(rcaps, "ragged")
    if rcap != rcaps:
        fail(f"[service ragged] captures {rcap} -> {rcaps}")
    rwant, rlat, relapsed = serve.serve_events(rpipe, rg_feeds)
    leaves_equal(serve.stack_results(served.results[None]), rwant, "ragged")
    rlaunch, ridle = profiled("ragged", ragged_service, {None: rg_feeds})
    if not (rlaunch["knn_build"] and rlaunch["knn_aggregate"]
            and rlaunch["knn_build"] == rlaunch["knn_aggregate"]):
        fail(f"[service ragged] launches {rlaunch}")
    row("ragged", served, rsum, {
        "events_s": RAGGED_EVENTS / relapsed,
        "p50_us": float(np.percentile(rlat, 50) * 1e6),
        "p99_us": float(np.percentile(rlat, 99) * 1e6)}, ridle, rlaunch)
    ph9 = capture_rows["served_trained"]["captured"]
    say(f"[service] phase 9's captured plain loop of the warm-trained "
        f"default ({CAPTURE_EVENTS} events, "
        f"{capture_rows['served_trained']['width']} per dispatch): "
        f"{ph9['events_s']:.1f} events/s, p50={ph9['p50_us']:.1f}us "
        f"p99={ph9['p99_us']:.1f}us; the service's default: "
        f"{service_rows['default']['events_s']:.1f} events/s ({card})")
    service_rows["phase9_plain_default"] = ph9
    (OUT / "service.json").write_text(json.dumps(service_rows, indent=1,
                                                 default=str))
    say(f"phase 10 done at {time.perf_counter() - t_start:.1f}s "
        f"({time.perf_counter() - t10:.1f}s)")

    # 11. the rest of the serve entry point: buckets and the monitor -----
    t11 = time.perf_counter()
    phase11 = {}

    def medians(label, runs, rounds=5):
        """Each of ``runs`` (name -> a call returning a row of events_s,
        p50_us, p99_us and more) ``rounds`` times in turns (a b b a a b
        ...), and the median of each number."""
        seen = {name: [] for name in runs}
        order = list(runs)
        for r in range(rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                seen[name].append(runs[name]())
        out = {}
        for name, rows_ in seen.items():
            med = {k: float(np.median([x[k] for x in rows_]))
                   for k in rows_[0]}
            out[name] = {**med, "runs": rows_}
            more = "".join(f"; {k} {v:.4g}" for k, v in med.items()
                           if k not in ("events_s", "p50_us", "p99_us"))
            say(f"[{label}] {name}: {med['events_s']:.1f} events/s, p50="
                f"{med['p50_us']:.1f}us p99={med['p99_us']:.1f}us (medians of "
                f"{rounds} in turns; runs "
                f"{[round(x['events_s'], 1) for x in rows_]} events/s{more})"
                f" ({card})")
        return out

    def timed_service(make_svc, routed, truths=None):
        """A fresh service's run over ``routed``: events/s, p50, p99, the
        garbage collector's runs during it, and the monitor taps' host
        time (µs a batch, and their share of the run's wall time)."""
        svc = make_svc()
        try:
            gc0 = sum(g["collections"] for g in gc.get_stats())
            tap_s.clear()
            served = serve.submit_all(svc, routed, truths)
            svc.drain()
            gcs = sum(g["collections"] for g in gc.get_stats()) - gc0
            s_ = svc.stats.summary()
        finally:
            svc.close()
        n = sum(len(v) for v in served.results.values())
        if served.failed or served.order != list(range(n)):
            fail(f"a timed service run: {served.failed} failed or out of "
                 "order")
        return {"events_s": n / served.elapsed_s, "p50_us": s_["p50_us"],
                "p99_us": s_["p99_us"], "batches": s_["batches"],
                "gc_runs": gcs,
                "tap_us_per_batch": (sum(tap_s) / len(tap_s) * 1e6
                                     if tap_s else 0.0),
                "tap_share": sum(tap_s) / served.elapsed_s}

    # the monitor taps' own host time, measured around each call
    from repro_torch.serving.replica import ReplicaEngine
    tap_s: list[float] = []
    real_tap = ReplicaEngine._tap

    def timed_tap(self, *a, **kw):
        t = time.perf_counter()
        try:
            return real_tap(self, *a, **kw)
        finally:
            tap_s.append(time.perf_counter() - t)
    ReplicaEngine._tap = timed_tap

    def quiet_faults(args):
        with redirect_stdout(io.StringIO()):   # its chaos line, again
            return serve.fault_kwargs(args)

    # (g) occupancy buckets: the bucketed deployment's plain loop
    def bucket_loop(call, feeds, width):
        """The plain loop over a bucketed deployment: DISPATCH events a
        call, each call's results on the host before the next; each
        event's outputs at its own bucket's width (``width``); and
        events/s, p50 and p99 µs (dispatch to host)."""
        n = len(feeds["hits"])
        per_event, lat = [], []
        t0 = time.perf_counter()
        for s0 in range(0, n, DISPATCH):
            t = time.perf_counter()
            out = call({k: v[s0:s0 + DISPATCH] for k, v in feeds.items()})
            dt = time.perf_counter() - t
            for i in range(len(out["cps"]["trigger"])):
                per_event.append({k: ({c: a[i] for c, a in v.items()}
                                      if k == "cps" else
                                      v[i, :width[s0 + i]])
                                  for k, v in out.items()})
                lat.append(dt)
        elapsed = time.perf_counter() - t0
        return per_event, {"events_s": n / elapsed,
                           "p50_us": float(np.percentile(lat, 50) * 1e6),
                           "p99_us": float(np.percentile(lat, 99) * 1e6)}

    def buckets_equal(bpipe, results, feeds, label):
        """Every served event bitwise equal to the same BucketedPipeline
        in the plain captured loop and to its plain-substituted
        deployment; the plain loop's rate."""
        width = [bpipe.classify(int(o)) for o in
                 np.count_nonzero(feeds["mask"] > 0, axis=1)]
        plain_ev, rate = bucket_loop(bpipe, feeds, width)
        with substituted(plain_fns):
            sub_ev, _ = bucket_loop(bpipe.run_eager, feeds, width)
        for what, want_ev in (("the plain captured loop", plain_ev),
                              ("the plain-substituted deployment", sub_ev)):
            for i, (got, want) in enumerate(zip(results, want_ev,
                                                strict=True)):
                g_, w_ = dict(leaves(got)), dict(leaves(want))
                bad = sorted(k for k in w_
                             if not np.array_equal(g_.get(k), w_[k]))
                if set(g_) != set(w_) or bad:
                    fail(f"[{label}] event {i} (bucket {width[i]}) differs "
                         f"from {what}: {bad or sorted(set(g_) ^ set(w_))}")
        say(f"[{label}] every event bitwise equal to the same "
            "BucketedPipeline in the plain captured loop and to its "
            "plain-substituted deployment; events per bucket "
            f"{ {int(b): width.count(b) for b in sorted(set(width))} }")
        return rate

    # serve.run with --buckets on the warm-trained default
    bk_report = serve_run(
        "buckets", ["--buckets", *map(str, BUCKETS), "--bucket-microbatch",
                    str(BUCKET_MICROBATCH)], mixed_launches,
        lambda report, label: buckets_equal(
            report.servables[0].pipe, report.served.results[None],
            report.feeds["ccn"], label))
    service_rows["buckets"]["buckets"] = bk_report.buckets
    bpipe = bk_report.servables[0].pipe
    # then events spread over the buckets (with_occupancy), on the same
    # deployment through a fresh service
    oc = generate(with_occupancy(gen_cfg, BUCKETS), 512, seed=7)
    oc_feeds = {"hits": oc["feats"], "mask": oc["mask"]}
    oc_n = len(oc_feeds["hits"])

    def bucket_service():
        return serve.build_service(bk_report.args, bk_report.servables,
                                   **quiet_faults(bk_report.args))
    svc = bucket_service()
    try:
        bcap = svc.capture_summary()
        served = serve.submit_all(svc, {None: oc_feeds})
        svc.drain()
        bsum = svc.stats.summary()
        brows = svc.bucket_summary()
        bcaps = svc.capture_summary()
    finally:
        svc.close()
    released_once_in_order(served, bsum, "buckets occupancy", oc_n)
    lanes_captured_before_traffic(bcaps, "buckets occupancy")
    if bcap != bcaps or len(bcaps) != len(BUCKETS):
        fail(f"[buckets occupancy] captures {bcap} -> {bcaps}")
    if any(r["completed"] != r["submitted"] for r in brows):
        fail(f"[buckets occupancy] buckets {brows}")
    bk_plain = buckets_equal(bpipe, served.results[None], oc_feeds,
                             "buckets occupancy")
    b_launch, b_idle = profiled("buckets occupancy", bucket_service,
                                {None: oc_feeds}, mixed_launches)
    row("buckets occupancy", served, bsum, bk_plain, b_idle, b_launch)
    service_rows["buckets occupancy"]["buckets"] = brows
    # the bucketed service against the padded default on the same events,
    # and the two deployments' plain loops (no service threads)
    oc_routed = {None: oc_feeds}
    oc_width = [bpipe.classify(int(o)) for o in
                np.count_nonzero(oc_feeds["mask"] > 0, axis=1)]
    dflt_pipe = default_report.servables[0].pipe

    def padded_plain():
        _, lat, elapsed = serve.serve_events(dflt_pipe, oc_feeds)
        return {"events_s": oc_n / elapsed,
                "p50_us": float(np.percentile(lat, 50) * 1e6),
                "p99_us": float(np.percentile(lat, 99) * 1e6)}
    phase11["buckets_vs_padded"] = medians("buckets vs padded", {
        "bucketed service": lambda: timed_service(bucket_service,
                                                  oc_routed),
        "padded default service": lambda: timed_service(
            lambda: serve.build_service(
                default_report.args, default_report.servables,
                **quiet_faults(default_report.args)), oc_routed),
        "bucketed plain loop": lambda: bucket_loop(bpipe, oc_feeds,
                                                   oc_width)[1],
        "padded default plain loop": padded_plain})
    phase11["buckets_vs_padded"]["bucket_rows"] = brows

    # (h) the monitor: the default run with --monitor-port 0 and
    # --event-display
    disp_path = OUT / "event_display.json"
    mon_report = serve_run("monitored", ["--monitor-port", "0",
                                         "--event-display", str(disp_path)],
                           mixed_launches)
    live, snap = mon_report.live_snapshot, mon_report.monitor
    results_ = mon_report.served.results[None]
    trig = [bool(r["cps"]["trigger"]) for r in results_]
    if live is None or live["events"] != mon_report.summary["completed"]:
        fail(f"[monitored] /snapshot {live} against completed "
             f"{mon_report.summary['completed']}")
    if snap["trigger_rate"] != sum(trig) / len(trig) or \
            snap["events"] != len(results_):
        fail(f"[monitored] snapshot trigger rate {snap['trigger_rate']} of "
             f"{snap['events']} events, the released results' "
             f"{sum(trig) / len(trig)} of {len(results_)}")
    try:
        shown = json.loads(disp_path.read_text())
    except (OSError, ValueError) as e:
        fail(f"[monitored] the event display file: {e}")
    if shown != mon_report.displays or not shown:
        fail("[monitored] the event display file holds other records than "
             "the run wrote")
    say(f"[monitored] /snapshot events={live['events']} = completed; "
        f"trigger rate {snap['trigger_rate']} = the released results'; "
        f"efficiency {snap['efficiency']}, fake rate {snap['fake_rate']}; "
        f"{len(shown)} display records parsed")
    mon_args = mon_report.args
    mon_truth = {None: mon_report.truth["ccn"]}
    mon_routed = {None: mon_report.feeds["ccn"]}
    phase11["monitor_on_off"] = medians("monitor on vs off", {
        "monitor on": lambda: timed_service(lambda: serve.build_service(
            mon_args, mon_report.servables,
            monitor=serve.monitor_config(mon_args),
            **quiet_faults(mon_args)), mon_routed, mon_truth),
        "monitor off": lambda: timed_service(lambda: serve.build_service(
            mon_args, mon_report.servables, **quiet_faults(mon_args)),
            mon_routed)})
    ReplicaEngine._tap = real_tap
    phase11["monitor_snapshot"] = {k: v for k, v in snap.items()
                                   if k != "serving"}
    (OUT / "phase11.json").write_text(json.dumps(phase11, indent=1,
                                                 default=str))
    (OUT / "service.json").write_text(json.dumps(service_rows, indent=1,
                                                 default=str))
    say(f"phase 11 done at {time.perf_counter() - t_start:.1f}s "
        f"({time.perf_counter() - t11:.1f}s)")

    # 12. training on the card ---------------------------------------------
    t12 = time.perf_counter()
    from repro_torch import configs as arch_configs
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import gnn_common
    from repro_torch.configs import graphsage_reddit as sage_arch
    from repro_torch.core.condensation import condensation_loss
    from repro_torch.data.graphs import NeighborSampler, powerlaw_graph
    from repro_torch.launch import train
    from repro_torch.optim import adamw_init
    from repro_torch.optim.step import CompiledStep, value_and_grad
    training = {"card": card}
    ccn_arch = arch_configs.get_arch("caloclusternet")
    row = f"{ATOL:g} + {RTOL:g}·|want|"

    def tree_diff(a, b):
        """The largest |a - b| over the leaves of two trees."""
        return max(float((x.double() - y.double()).abs().max())
                   for (_, x), (_, y) in zip(ckpt.flatten(a),
                                             ckpt.flatten(b), strict=True))

    def within_row(label, got, want):
        """Every leaf of ``got`` finite and within the float32 row of the
        same leaf of ``want``; returns the largest |err|."""
        worst = 0.0
        for (name, g), (_, w) in zip(ckpt.flatten(got), ckpt.flatten(want),
                                     strict=True):
            g64, w64 = g.detach().double().cpu(), w.detach().double().cpu()
            err = (g64 - w64).abs()
            if not bool(torch.isfinite(g64).all()) or bool(
                    (err > ATOL + RTOL * w64.abs()).any()):
                fail(f"[{label}] {name}: max|err| {err.max().item():.3e} "
                     f"at |want| up to {w64.abs().max().item():.3e}, "
                     f"{int((err > ATOL + RTOL * w64.abs()).sum())} of "
                     f"{err.numel()} outside the float32 row ({row})")
            worst = max(worst, float(err.max()) if err.numel() else 0.0)
        return worst

    def reordered(g, seed):
        """The same graphs with their nodes and edges in another order,
        every index remapped: the same function, other summation orders
        (each node's sum, each batch norm's, each gather's backward)."""
        rng = np.random.default_rng(seed)
        lead = g["node_mask"].ndim - 1
        perm = torch.from_numpy(rng.permutation(g["node_mask"].shape[-1]))
        eperm = torch.from_numpy(rng.permutation(g["edge_mask"].shape[-1]))
        inv, einv = torch.argsort(perm), torch.argsort(eperm)
        out = dict(g, edge_mask=g["edge_mask"].index_select(lead, eperm))
        for k in ("nodes", "positions", "species", "node_mask", "labels",
                  "forces"):
            if k in g:
                out[k] = g[k].index_select(lead, perm)
        ei = g["edge_index"]
        out["edge_index"] = inv[ei.index_select(lead + 1, eperm).long()].to(
            ei.dtype)
        if "triplets" in g:
            out["triplets"] = einv[g["triplets"].long()].to(
                g["triplets"].dtype)
        return out

    def grads_close(label, card_t, cpu_t, truth, more_orders=()):
        """Each leaf of the card's gradients within the float32 row of the
        CPU's; where a leaf is not, its largest distance from the float64
        result at most twice the CPU's float32 distance from it on the
        same leaf plus the row taken against the leaf's largest |value|
        (an entry near 0 of a sum of large terms carries their rounding):
        through 16 layers float32 itself does not hold the row (the CPU's
        float32 gradients leave it against float64, on other leaves than
        the card's), and by how much depends on the order of the sums, so
        the CPU's distance is its largest over the graph's own order and,
        while a leaf is not held, over the gradient trees ``more_orders``
        yields (the CPU in other orders of nodes and edges,
        ``reordered``). Returns the largest |card - cpu|, the number of
        CPU orders taken and each leaf the second rule decided, with both
        distances and the leaf's largest |value|."""
        def f64(tree):
            return [x.detach().double().cpu() for _, x in ckpt.flatten(tree)]
        cpu_runs, extra = [f64(cpu_t)], iter(more_orders)
        worst, widened = 0.0, []
        for i, ((name, g), t64) in enumerate(zip(
                ckpt.flatten(card_t), f64(truth), strict=True)):
            g64, c64 = g.detach().double().cpu(), cpu_runs[0][i]
            if not bool(torch.isfinite(g64).all()):
                fail(f"[{label}] {name}: non-finite gradients")
            err = (g64 - c64).abs()
            worst = max(worst, float(err.max()))
            if bool((err <= ATOL + RTOL * c64.abs()).all()):
                continue
            e_card = float((g64 - t64).abs().max())
            top = float(t64.abs().max())
            e_cpu = max(float((r[i] - t64).abs().max()) for r in cpu_runs)
            while e_card > 2 * e_cpu + ATOL + RTOL * top:
                nxt = next(extra, None)
                if nxt is None:
                    break
                cpu_runs.append(f64(nxt))
                e_cpu = max(e_cpu, float((cpu_runs[-1][i] - t64).abs().max()))
            if e_card > 2 * e_cpu + ATOL + RTOL * top:
                fail(f"[{label}] {name}: max|card - cpu| {err.max():.3e} "
                     f"outside the float32 row, and its max|err| against "
                     f"float64 {e_card:.3e} above twice the CPU's float32 "
                     f"error on the leaf over {len(cpu_runs)} orders "
                     f"{e_cpu:.3e} + {ATOL:g} + {RTOL:g}·{top:.3e} (the "
                     "leaf's largest |value|)")
            widened.append({"leaf": name, "card_vs_f64": e_card,
                            "cpu_f32_vs_f64": e_cpu, "max_abs_f64": top})
        return worst, len(cpu_runs), widened

    def widened_note(widened, orders):
        """The say line's account of ``grads_close``'s second rule."""
        if not widened:
            return "every leaf within the row"
        shown = ", ".join(f"{w['leaf']} {w['card_vs_f64']:.2e} vs "
                          f"{w['cpu_f32_vs_f64']:.2e} at |value| "
                          f"{w['max_abs_f64']:.2e}" for w in widened[:3])
        return (f"{len(widened)} leaves outside the row, each no further "
                "from float64 than twice the CPU's float32 error on the "
                f"leaf (over {orders} orders of nodes and edges) plus the row "
                f"at the leaf's largest |value|: {shown}"
                + (" ..." if len(widened) > 3 else ""))

    def on(tree, device, dtype=None):
        return ckpt.unflatten(tree, iter(
            t.to(device, dtype) if dtype is not None
            and t.is_floating_point() else t.to(device)
            for _, t in ckpt.flatten(tree)))

    @contextmanager
    def float64_aggregate():
        """edge_aggregate's CPU route computing in float64 (its plain
        version computes in float32): the GNNs' float64 gradients."""
        saved = ref.edge_aggregate_ref

        def f64(messages, dst, mask, *, n_nodes, reduce="sum"):
            b_, e_, d_ = messages.shape
            key = dst.long()
            ok = (key >= 0) & (key < n_nodes)
            idx = torch.where(ok, key, 0)
            w = torch.where(ok, mask.double(), 0.0)
            out = torch.zeros((b_, n_nodes, d_), dtype=torch.float64)
            out = out.scatter_add(1, idx[..., None].expand(b_, e_, d_),
                                  messages.double() * w[..., None])
            if reduce == "mean":
                cnt = torch.zeros((b_, n_nodes), dtype=torch.float64
                                  ).scatter_add(1, idx, w)
                out = out / torch.clamp_min(cnt, 1.0)[..., None]
            return out
        ref.edge_aggregate_ref = f64
        try:
            yield
        finally:
            ref.edge_aggregate_ref = saved

    def held_out_loss(cfg_, params, feeds_):
        with torch.no_grad():
            out = ccn.apply(params, feeds_["feats"], feeds_["mask"], cfg_)
            return float(condensation_loss(
                out, {k: feeds_[k] for k in ("object_id", "energy", "cls")},
                feeds_["mask"], k_max=cfg_.k_max)[0])

    def ccn_batch(gen_, n, seed, device=dev):
        return {k: torch.from_numpy(v).to(device)
                for k, v in generate(gen_, n, seed=seed).items()
                if k != "trigger_truth"}

    # (a) the driver: a failure injected at step 30 of 60, resumed from
    # checkpoint 20; then twice without it
    def driver(tag, extra):
        ck = OUT / "ckpt" / tag
        shutil.rmtree(ck, ignore_errors=True)
        buf = io.StringIO()
        with redirect_stdout(buf):
            rep = train.run(["--arch", "caloclusternet", "--steps", "60",
                             "--ckpt-every", "20", *extra,
                             "--ckpt-dir", str(ck)])
        LOG.append(buf.getvalue())
        if rep.device.type != dev.type or not rep.captured:
            fail(f"[train driver {tag}] ran on {rep.device}, captured "
                 f"{rep.captured}")
        losses_ = [v for _, v in rep.losses]
        if not np.isfinite(losses_).all():
            fail(f"[train driver {tag}] non-finite losses {losses_}")
        return rep, ck

    rep_f, ck_f = driver("failure", ["--inject-failure-at", "30"])
    if rep_f.resumes != [(30, 20)] or rep_f.final_step != 60:
        fail(f"[train driver] resumed {rep_f.resumes}, ended at step "
             f"{rep_f.final_step}: want [(30, 20)], 60")
    on_disk = sorted(p.name for p in ck_f.iterdir())
    if rep_f.checkpoints != [20, 40, 60] or on_disk != [
            f"step_{s:08d}" for s in (20, 40, 60)]:
        fail(f"[train driver] checkpoints {rep_f.checkpoints}, on disk "
             f"{on_disk}")
    final = {"p": rep_f.params, "o": rep_f.opt}
    for st in (20, 40, 60):
        try:    # every leaf's crc32 verified
            got, got_step = ckpt.restore(str(ck_f), st, final)
        except (IOError, KeyError) as e:
            fail(f"[train driver] checkpoint {st}: {e}")
        if got_step != st:
            fail(f"[train driver] checkpoint {st} says step {got_step}")
    if tree_diff(got, final) != 0.0:
        fail("[train driver] checkpoint 60 differs from the final state")
    cfg_s = ccn_arch.smoke_config()
    gen_s = Belle2Config(n_crystals=576, grid=(24, 24), n_hits=cfg_s.n_hits,
                         noise_rate=4.0)
    held_s = ccn_batch(gen_s, 1024, HELD_OUT_SEED)
    init_s = train.build_step("caloclusternet", ccn_arch, cfg_s,
                              device=dev)[1](0)
    l_init, l_end = (held_out_loss(cfg_s, p_, held_s)
                     for p_ in (init_s, rep_f.params))
    if not l_end < l_init:
        fail(f"[train driver] held-out loss {l_init:.5f} -> {l_end:.5f} "
             "after 60 steps: not falling")
    fl = [v for _, v in rep_f.losses]
    rep_a, _ = driver("whole a", [])
    rep_b, _ = driver("whole b", [])
    d_fail = tree_diff(rep_f.params, rep_a.params)
    d_spread = tree_diff(rep_a.params, rep_b.params)
    training["driver"] = {
        "resumes": rep_f.resumes, "checkpoints": rep_f.checkpoints,
        "losses": rep_f.losses, "held_out_loss": [l_init, l_end],
        "first10_mean": float(np.mean(fl[:10])),
        "last10_mean": float(np.mean(fl[-10:])),
        "steps_per_s": [r.steps_per_s for r in (rep_f, rep_a, rep_b)],
        "max_param_diff_failure_vs_whole": d_fail,
        "max_param_diff_whole_vs_whole": d_spread}
    say(f"[train driver] caloclusternet smoke config, 60 steps of 16 "
        f"events, captured: failure injected at 30, resumed from 20, "
        f"checkpoints {rep_f.checkpoints} on disk (crc verified); losses "
        f"finite, per-batch mean of the first 10 {np.mean(fl[:10]):.5f}, "
        f"last 10 {np.mean(fl[-10:]):.5f}; held-out loss (1024 events of "
        f"seed {HELD_OUT_SEED}) {l_init:.5f} -> {l_end:.5f}; step-60 "
        f"parameters' max|diff| against an uninterrupted run {d_fail:.3e}, "
        f"between two uninterrupted runs {d_spread:.3e}; "
        f"{rep_a.steps_per_s:.1f} steps/s with host data ({card})")

    # (b) CaloClusterNet at full width (condensation_train's shape)
    cfg_f = ccn_arch.full_config()
    step_f, init_f, _, ocfg_f = train.build_step(
        "caloclusternet", ccn_arch, cfg_f, device=dev)
    batches_f = [ccn_batch(gen_cfg, TRAIN_BATCH, 1000 + i)
                 for i in range(TRAIN_DISTINCT)]
    held_f = ccn_batch(gen_cfg, TRAIN_BATCH, HELD_OUT_SEED)
    p0 = init_f(0)
    o0 = adamw_init(p0, ocfg_f)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_f = torch.cuda.memory_allocated()
    stepper = CompiledStep(step_f, p0, o0, device=dev)
    t = time.perf_counter()
    m = stepper(batches_f[0])
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    f_losses, f_ms = [m["loss"].clone()], []
    for i in range(1, TRAIN_STEPS):
        t = time.perf_counter()
        m = stepper(batches_f[i % TRAIN_DISTINCT])
        torch.cuda.synchronize()
        f_ms.append((time.perf_counter() - t) * 1e3)
        f_losses.append(m["loss"].clone())
    f_losses = [float(x) for x in f_losses]
    peak_f = torch.cuda.max_memory_allocated()
    l0, l1 = (held_out_loss(cfg_f, p_, held_f) for p_ in (p0,
                                                          stepper.params))
    if not np.isfinite(f_losses).all() or not l1 < l0:
        fail(f"[train ccn] losses {f_losses}, held-out {l0} -> {l1}")
    med_ms = float(np.median(f_ms))
    tflops = ccn_arch._flops(cfg_f, TRAIN_BATCH) * 3 / (med_ms * 1e-3) / 1e12
    busy_f, _, wall_f = idle_share(
        lambda: stepper(batches_f[0]),
        f"captured train steps of {TRAIN_BATCH} events", "_train_ccn")
    # captured against eager, teacher-forced from the eager run's state
    pe, oe = init_f(0), adamw_init(init_f(0), ocfg_f)
    ce_err = 0.0
    for i in range(5):
        b_ = batches_f[i % TRAIN_DISTINCT]
        stepper.load(pe, oe)
        mc = stepper(b_)
        pe, oe, me = step_f(pe, oe, b_)
        ce_err = max(ce_err, within_row(
            f"train ccn captured vs eager, step {i + 1}",
            {"loss": mc["loss"], "p": stepper.params, "o": stepper.opt},
            {"loss": me["loss"], "p": pe, "o": oe}))
    # the card against the CPU: one step's loss and gradients at 32
    # events, on a batch whose kNN selections agree on both devices
    cpu = torch.device("cpu")

    def selections(p_, b_):
        """The kNN neighbours of each hit at each GravNet block, along
        this device's forward."""
        return knn_selections(torch, p_, b_["feats"], b_["mask"], cfg_f)

    p_cpu = on(pe, cpu)
    for seed in range(2000, 2020):
        b32 = ccn_batch(gen_cfg, 32, seed)
        b32_cpu = on(b32, cpu)
        if all(torch.equal(a_, c_) for a_, c_ in zip(
                selections(pe, b32), selections(p_cpu, b32_cpu))):
            break
    else:
        fail("[train ccn] no batch of seeds 2000-2019 whose kNN selections "
             "agree on the card and the CPU")

    def ccn_loss(b_):
        def lf(p_):
            out = ccn.apply(p_, b_["feats"], b_["mask"], cfg_f)
            return condensation_loss(
                out, {k: b_[k] for k in ("object_id", "energy", "cls")},
                b_["mask"], k_max=cfg_f.k_max)
        return lf
    (lc, _), gc_ = value_and_grad(ccn_loss(b32), pe)
    (lcpu, _), gcpu = value_and_grad(ccn_loss(b32_cpu), p_cpu)
    cpu_err = within_row("train ccn card vs cpu",
                         {"loss": lc, "grads": gc_},
                         {"loss": lcpu, "grads": gcpu})
    training["ccn_full"] = {
        "config": repr(cfg_f), "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
        "capture_s": capture_s, "losses": f_losses,
        "held_out_loss": [l0, l1], "step_ms": f_ms,
        "steps_per_s": 1e3 / med_ms,
        "events_per_s": TRAIN_BATCH * 1e3 / med_ms, "tflops": tflops,
        "peak_bytes": peak_f, "step_peak_bytes": peak_f - base_f,
        "idle_share": 1 - busy_f / wall_f if busy_f > 0 else None,
        "captured_vs_eager_max_err": ce_err,
        "card_vs_cpu_seed": seed, "card_vs_cpu_max_err": cpu_err}
    say(f"[train ccn] full width ({cfg_f.n_hits} hits, d_hidden "
        f"{cfg_f.d_hidden}) at {TRAIN_BATCH} events a step, one CUDA graph "
        f"(captured in {capture_s:.2f}s): {TRAIN_STEPS} steps, loss "
        f"{f_losses[0]:.5f} -> {f_losses[-1]:.5f}, held-out {l0:.5f} -> "
        f"{l1:.5f}; median {med_ms:.3f} ms a step = {1e3 / med_ms:.1f} "
        f"steps/s, {TRAIN_BATCH * 1e3 / med_ms:.0f} events/s, "
        f"{tflops:.3f} TFLOP/s of the model's FLOPs (_flops x 3); peak "
        f"{peak_f / 2**30:.3f} GiB allocated ({(peak_f - base_f) / 2**30:.3f} "
        "above what was allocated before the capture); captured vs eager "
        "over 5 teacher-forced "
        f"steps max|err| {ce_err:.3e}, card vs CPU (32 events of seed "
        f"{seed}) loss and gradients max|err| {cpu_err:.3e}, both within "
        f"{row} ({card})")

    # (c) the GNNs at their published widths: full_graph_sm's size, and
    # minibatch_lg sampled on a Reddit-sized graph
    gsm = gnn_common.SHAPES["full_graph_sm"]
    g_np = powerlaw_graph(gsm["n"], gsm["e"], d_feat=gsm["d_feat"],
                          n_classes=gsm["classes"], seed=GNN_TRAIN_SEED)
    g_dev = {k: torch.from_numpy(v).to(dev) for k, v in g_np.items()}
    gated_arch = arch_configs.get_arch("gatedgcn")
    sage_cfg = sage_arch.full_config("full_graph_sm")
    sampled_cfg = sage_arch.full_config("minibatch_lg")
    t = time.perf_counter()
    big = powerlaw_graph(REDDIT_NODES, REDDIT_EDGES, d_feat=602,
                         n_classes=41, seed=GNN_TRAIN_SEED)
    sampler = NeighborSampler(big["edge_index"], REDDIT_NODES, big["nodes"],
                              big["labels"], fanouts=sampled_cfg.sample_sizes,
                              seed=GNN_TRAIN_SEED)
    seed_rng = np.random.default_rng(GNN_TRAIN_SEED)
    group_n = gnn_common.GROUPS * gnn_common.SEEDS_PER_GROUP

    def sampled_batch():
        seeds_ = seed_rng.choice(REDDIT_NODES, size=group_n, replace=False)
        return sage_arch.stack_groups(
            [sampler.sample(s_) for s_ in
             seeds_.reshape(gnn_common.GROUPS, -1)], device=dev)
    s_batches = [sampled_batch() for _ in range(SAMPLED_STEPS)]
    s_held = sampled_batch()
    gen_s_s = time.perf_counter() - t
    del big
    gnn_runs = {
        "gatedgcn full_graph_sm": (
            gatedgcn, gated_arch.full_config("full_graph_sm"), {},
            [g_dev] * FULL_GRAPH_STEPS, g_dev, 11),
        "graphsage full_graph_sm": (
            graphsage, sage_cfg, {}, [g_dev] * FULL_GRAPH_STEPS, g_dev, 12),
        "graphsage minibatch_lg": (
            graphsage, sampled_cfg, {"sampled": True}, s_batches, s_held,
            13)}
    steppers, gnn_rows = {}, {}
    for label, (model, gcfg, lkw, gbatches, held, pseed) in \
            gnn_runs.items():
        p0 = on(model.init(torch.Generator().manual_seed(pseed), gcfg), dev)
        o0 = adamw_init(p0, gnn_common.OCFG)

        def lf(p_, b_, model=model, gcfg=gcfg, lkw=lkw):
            loss_, met = model.loss_fn(p_, b_, gcfg, **lkw)
            return loss_.mean(), {k: v.mean() for k, v in met.items()}
        # edge_aggregate at this model's shapes, bitwise against its plain
        # version (one launch of each shape and reduction)
        calls = []

        def rec(*args, **kw):
            calls.append((args, kw))
            return plain_fns["edge_aggregate"](*args, **kw)
        with substituted({"edge_aggregate": rec}), torch.no_grad():
            lf(p0, gbatches[0])
        seen = set()
        for pos, (args, kw) in enumerate(calls):
            key = (tuple(args[0].shape), kw["n_nodes"], kw.get("reduce"))
            if key not in seen:
                seen.add(key)
                check("train gnn", pos, args[0].shape[0], "edge_aggregate",
                      list(args), kw)
        # the card against the CPU: one step's loss and gradients (and
        # the float64 gradients, where float32 cannot hold the row)
        (lc, _), gc_ = value_and_grad(lambda p_: lf(p_, gbatches[0]), p0)
        (lcpu, _), gcpu = value_and_grad(
            lambda p_: lf(p_, on(gbatches[0], cpu)), on(p0, cpu))
        with float64_aggregate():
            _, g64_ = value_and_grad(
                lambda p_: lf(p_, on(gbatches[0], cpu, torch.float64)),
                on(p0, cpu, torch.float64))
        within_row(f"train {label} card vs cpu", {"loss": lc},
                   {"loss": lcpu})
        # the CPU in two more orders of the graph where a leaf needs them
        # (the sampled batch's blocks keep their own)
        more = () if lkw else (
            value_and_grad(lambda p_, k=k: lf(p_, reordered(
                on(gbatches[0], cpu), k)), on(p0, cpu))[1] for k in (1, 2))
        g_err, orders, widened = grads_close(
            f"train {label} card vs cpu", gc_, gcpu, g64_, more)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        st_ = CompiledStep(gnn_common.train_step(model, gcfg, **lkw), p0, o0,
                           device=dev)
        t = time.perf_counter()
        m = st_(gbatches[0])
        torch.cuda.synchronize()
        cap_s = time.perf_counter() - t
        g_losses, g_ms = [m["loss"].clone()], []
        for b_ in gbatches[1:]:
            t = time.perf_counter()
            m = st_(b_)
            torch.cuda.synchronize()
            g_ms.append((time.perf_counter() - t) * 1e3)
            g_losses.append(m["loss"].clone())
        g_losses = [float(x) for x in g_losses]
        with torch.no_grad():
            h0, h1 = (float(lf(p_, held)[0]) for p_ in (p0, st_.params))
        if not np.isfinite(g_losses).all() or not h1 < h0:
            fail(f"[train {label}] losses {g_losses}, evaluated {h0} -> {h1}")
        med = float(np.median(g_ms))
        gnn_rows[label] = {
            "config": repr(gcfg), "steps": len(gbatches),
            "capture_s": cap_s, "losses": g_losses,
            "evaluated_loss": [h0, h1], "step_ms": g_ms,
            "steps_per_s": 1e3 / med,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "step_peak_bytes": torch.cuda.max_memory_allocated() - base,
            "edge_aggregate_per_step": st_.launches.get(
                "edge_aggregate_cuda", 0),
            "card_vs_cpu_max_err": g_err,
            "card_vs_cpu_cpu_orders": orders,
            "card_vs_cpu_widened": widened}
        steppers[label] = (st_, gbatches[0])
        say(f"[train {label}] {len(gbatches)} captured steps (captured in "
            f"{cap_s:.2f}s): loss {g_losses[0]:.5f} -> {g_losses[-1]:.5f}, "
            f"{'held-out sample' if lkw else 'graph'} loss {h0:.5f} -> "
            f"{h1:.5f}; median {med:.3f} ms a step = {1e3 / med:.1f} "
            f"steps/s; peak {gnn_rows[label]['peak_bytes'] / 2**30:.3f} GiB "
            f"allocated ({gnn_rows[label]['step_peak_bytes'] / 2**30:.3f} "
            "above what was allocated before the step's capture); "
            f"{gnn_rows[label]['edge_aggregate_per_step']} edge_aggregate a "
            f"step; card vs CPU: loss within {row}, gradients max|err| "
            f"{g_err:.3e}, {widened_note(widened, orders)} ({card})")

    def gnn_steps():
        for st_, b_ in steppers.values():
            st_(b_)
    _, launches, _ = counted(gnn_steps, gnn_steps, "train gnn")
    path_launches["train gnn"] = launches
    want_launch = dict.fromkeys(wrappers, 0)
    want_launch["edge_aggregate"] = 2 * 16 + 2 + 3
    if launches != want_launch:
        fail(f"[train gnn] launch counts {launches} != {want_launch}")
    training["gnn"] = gnn_rows
    training["gnn_counted_launches"] = launches
    training["sampled_graph"] = {"nodes": REDDIT_NODES, "edges": REDDIT_EDGES,
                                 "host_generation_s": gen_s_s}
    training["phase_s"] = time.perf_counter() - t12
    (OUT / "training.json").write_text(json.dumps(training, indent=1,
                                                  default=str))
    say(f"[train] driver resumed and checkpointed; ccn full width "
        f"{training['ccn_full']['steps_per_s']:.1f} steps/s; gatedgcn "
        f"{gnn_rows['gatedgcn full_graph_sm']['steps_per_s']:.1f}, graphsage "
        f"{gnn_rows['graphsage full_graph_sm']['steps_per_s']:.1f}, sampled "
        f"{gnn_rows['graphsage minibatch_lg']['steps_per_s']:.1f} steps/s; "
        f"one counted step of each GNN: {launches['edge_aggregate']} "
        f"edge_aggregate launches ({card})")
    say(f"phase 12 done at {time.perf_counter() - t_start:.1f}s "
        f"({time.perf_counter() - t12:.1f}s)")

    # 13. the LM transformer and MIND recsys on the card ------------------
    t13 = time.perf_counter()
    counts_before = kops.launch_counts()
    decoded = {}
    lm_rec = lm_and_recsys(torch, np, dev, card, idle_share, decoded)
    if kops.launch_counts() != counts_before:
        fail("phase 13 launched a kernel of the port: the LM and MIND "
             "paths reach none")
    lm_rec["phase_s"] = time.perf_counter() - t13
    (OUT / "lm_recsys.json").write_text(json.dumps(lm_rec, indent=1,
                                                   default=str))
    say(f"phase 13 done at {time.perf_counter() - t_start:.1f}s "
        f"({lm_rec['phase_s']:.1f}s)")

    # 14. DimeNet, NequIP and the molecule step on the card -------------
    t14 = time.perf_counter()
    geo, launches = geometric_gnns(torch, np, dev, card, SimpleNamespace(
        within_row=within_row, grads_close=grads_close, reordered=reordered,
        widened_note=widened_note, on=on,
        float64_aggregate=float64_aggregate, check=check, counted=counted,
        idle_share=idle_share, substituted=substituted, plain_fns=plain_fns,
        wrappers=wrappers))
    path_launches["geometric gnn"] = launches
    geo["phase_s"] = time.perf_counter() - t14
    (OUT / "geometric.json").write_text(json.dumps(geo, indent=1,
                                                   default=str))
    say(f"phase 14 done at {time.perf_counter() - t_start:.1f}s "
        f"({geo['phase_s']:.1f}s)")

    # 15. the multi-device tools on the card --------------------------------
    t15 = time.perf_counter()
    md, launches = multi_device(torch, np, dev, card, SimpleNamespace(
        counted=counted, idle_share=idle_share, wrappers=wrappers,
        reset_counts=reset_counts, read_counts=read_counts,
        decoded=decoded, eager_decode_idle_share={
            "olmo-1b": lm_rec["olmo_full"]["decode_idle_share"],
            "granite-moe-1b-a400m":
                lm_rec["granite_moe_full"]["decode_idle_share"]}))
    decoded.clear()
    path_launches["cells"] = launches
    md["phase_s"] = time.perf_counter() - t15
    (OUT / "cells.json").write_text(json.dumps(md, indent=1, default=str))
    say(f"phase 15 done at {time.perf_counter() - t_start:.1f}s "
        f"({md['phase_s']:.1f}s)")

    # 16. the kernels' last forms --------------------------------------------
    t16 = time.perf_counter()
    forms, launches = epilogue_forms(torch, np, dev, card, SimpleNamespace(
        cfg=cfg, gen_cfg=gen_cfg, check=check, counted=counted,
        substituted=substituted, plain_fns=plain_fns,
        heads_and_cps=heads_and_cps, timer=timer))
    path_launches.update(launches)
    (OUT / "forms.json").write_text(json.dumps(forms, indent=1,
                                               default=str))
    say(f"phase 16 done at {time.perf_counter() - t_start:.1f}s "
        f"({time.perf_counter() - t16:.1f}s)")

    # 17. the bf16 forms -----------------------------------------------------
    bf16_rec = bf16_forms(torch, np, dev, card, SimpleNamespace(
        cfg=cfg, check=check, timer=timer, wrappers=wrappers,
        substituted=substituted, reset_counts=reset_counts,
        read_counts=read_counts, sentinels=sentinels, kernel_rx=kernel_rx))
    path_launches["bf16 executor"] = {
        **dict.fromkeys(wrappers, 0),
        "fused_dense": bf16_rec["executor"]["launches"]}
    (OUT / "bf16.json").write_text(json.dumps(bf16_rec, indent=1,
                                              default=str))
    say(f"phase 17 done at {time.perf_counter() - t_start:.1f}s "
        f"({bf16_rec['phase_s']:.1f}s)")

    # 18. the launch knobs ---------------------------------------------------
    kev = generate(gen_cfg, KNOB_EVENTS, seed=18)
    cev_ = generate(cur_gen, KNOB_EVENTS, seed=18)

    def first(feeds):
        return {k: v[:KNOB_EVENTS] for k, v in feeds.items()}
    kfeeds = {"hits": kev["feats"], "mask": kev["mask"]}
    knob_paths = {
        "mixed default": (pipes["served_trained"], lambda c: deploy(
            params=trained, tuning_cache=c, **paths["served"]), kfeeds),
        "fp": (pipes["fp"], lambda c: deploy(tuning_cache=c, **paths["fp"]),
               kfeeds),
        "mixed fuse_int8=False": (pipes["mixed_no_fuse_int8"], lambda c: deploy(
            tuning_cache=c, **paths["mixed_no_fuse_int8"]), kfeeds),
        "ragged": (pipes["ragged"], lambda c: deploy(
            tuning_cache=c, **paths["ragged"]), first(rg_feeds)),
        "current detector": (cur_pipe, lambda c: serve.build_pipeline(
            cur_cfg, cur_gen, device=dev, tuning_cache=c, platform="cpu"),
            {"hits": cev_["feats"], "mask": cev_["mask"]}),
        **{gname: (pipes[gname], lambda c, gname=gname: serve.MODELS[gname](
            card_args, gnn_cfgs[gname], tuning_cache=c).pipe,
            first(gnn_feeds[gname])) for gname in ("gatedgcn", "graphsage")}}
    knobs = launch_knobs(torch, np, dev, card, SimpleNamespace(
        timer=timer, wrappers=wrappers, plain_fns=plain_fns,
        substituted=substituted, leaves=leaves, knob_paths=knob_paths))
    (OUT / "knobs.json").write_text(json.dumps(knobs, indent=1, default=str))
    say(f"phase 18 done at {time.perf_counter() - t_start:.1f}s "
        f"({knobs['phase_s']:.1f}s)")

    # 19. the design flow's H100 model against the card ------------------
    model_rec = model_against_card(torch, np, dev, card, SimpleNamespace(
        trained=trained, served=pipes["served_trained"], ccn_feeds=ccn_feeds,
        p2=lambda: deploy(params=trained, **paths["mixed"]),
        chunk_launches=chunk_launches))
    (OUT / "model.json").write_text(json.dumps(model_rec, indent=1,
                                               default=str))
    say(f"phase 19 done at {time.perf_counter() - t_start:.1f}s "
        f"({model_rec['phase_s']:.1f}s)")

    # 20. the kernel line and the result -----------------------------------
    # each kernel's numbers per chunk (per launch of the ragged
    # executable) of the path it serves: its launches from that path's
    # run, its times at that path's micro-batch (bins)
    home = {"fused_dense": ["fp"], "gravnet_block": ["fp"],
            "fused_dense_int8": ["served", "served_trained"],
            "gravnet_block_int8": ["served", "served_trained"],
            "gravnet_aggregate": ["mixed_no_fuse_int8", "fp_dp1"],
            "knn_build": ["ragged", "ragged_dp1"],
            "knn_aggregate": ["ragged", "ragged_dp1"],
            "edge_aggregate": ["gatedgcn", "graphsage"],
            "flash_attention": ["attention"]}
    # the service runs count on top (phase 10): the main path's pair from
    # the default run, the routes' and the ragged path's kernels
    home["fused_dense_int8"].append("service default")
    home["gravnet_block_int8"].append("service default")
    # and phase 11's: the bucketed runs and the monitored default
    for run_ in ("service buckets", "service buckets occupancy",
                 "service monitored"):
        home["fused_dense_int8"].append(run_)
        home["gravnet_block_int8"].append(run_)
    home["fused_dense"] += ["service routes", "service ragged"]
    home["edge_aggregate"] += ["service routes", "train gnn",
                               "geometric gnn", "cells"]
    home["knn_build"].append("service ragged")
    home["knn_aggregate"].append("service ragged")
    # and phase 16's no-concat deployment
    home["fused_dense"] += ["no-concat fp", "no-concat ragged"]
    home["gravnet_block"].append("no-concat fp")
    home["fused_dense_int8"].append("no-concat mixed")
    home["gravnet_block_int8"].append("no-concat mixed")
    home["knn_build"].append("no-concat ragged")
    home["knn_aggregate"].append("no-concat ragged")
    # and phase 17's bf16-tagged dense
    home["fused_dense"].append("bf16 executor")
    # the path whose phase-3 checks give a kernel's times: the int8
    # pair's the mixed path at the reference's chunk of 2 events (its
    # launches are the served default's)
    rows_path = {"fused_dense_int8": "mixed", "gravnet_block_int8": "mixed"}
    line = []
    for name, meta in KERNELS.items():
        path = rows_path.get(name, home[name][0])
        mb = pipes[path].microbatch
        rows_ = [r for r in results[name]["per_launch"]
                 if r["path"] == path and r["events"] == mb]
        # a library call's time where it covers every launch of the
        # chunk; torch._int_mm, which covers the int8 product alone,
        # summed over the launches whose shapes it accepts
        lib = [r["library_ms"] for r in rows_ if r["library_ms"] is not None]
        lib_ms = sum(lib) if lib and (len(lib) == len(rows_)
                                      or name == "fused_dense_int8") else None
        lib_label = sorted({r["library"] for r in rows_ if r["library"]})
        if name == "fused_dense_int8":
            lib_label = [f"torch._int_mm, int8 product only (no epilogue), "
                         f"at {len(lib)} of {len(rows_)} launches; it "
                         "refuses K or N not a multiple of 8"]
        if not lib_label:
            lib_label = ["none (no single PyTorch call)"]
        nbytes = sum(r["bytes"] for r in rows_)
        ops: dict[str, float] = {}
        for r in rows_:
            for kind, n in r["ops"].items():
                ops[kind] = ops.get(kind, 0.0) + n
        b_ms, b_by = bound(nbytes, ops)
        n_launch = sum(path_launches[p][name] for p in home[name])
        if n_launch == 0:
            fail(f"{name} was launched no time on its path {home[name]}")
        if name == "fused_dense_int8":
            # each CTA tile's device ms at the mixed path's shapes (phase 18)
            meta = dict(meta, tiles=knobs["int8_tiles"])
        line.append({
            "name": name, **meta, "status": "ported",
            "launches": n_launch,
            "launches_from": {p: path_launches[p][name] for p in home[name]},
            "max_abs_err": results[name]["max_abs_err"],
            "tolerance": ("bitwise" + (
                f" (gelu and silu epilogues: |err| <= {ATOL:g} + "
                f"{RTOL:g}*|plain|, int8 outputs within a step)"
                if name in ("fused_dense", "fused_dense_int8",
                            "gravnet_block", "gravnet_block_int8") else ""))
            if name in BITWISE else (
                f"|err| <= {ATOL:g} + {RTOL:g}*|plain|" + (
                    f" (bf16: {BF16_ATOL:g} + {BF16_RTOL:g}*|plain|)"
                    if name == "flash_attention" else "")),
            "per": (f"one launch of the {path} executable ({len(rows_)} "
                    f"launches, {mb} bins)" if name.startswith("knn") else
                    f"one chunk of the {path} path ({len(rows_)} launches, "
                    f"{mb} events)"),
            "ms": sum(r["ms"] for r in rows_),
            "plain_ms": sum(r["plain_ms"] for r in rows_),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "library": lib_label or None,
            "per_launch": results[name]["per_launch"],
        })
    (OUT / "kernels.json").write_text(json.dumps(line, indent=1))
    (OUT / "gnn_chunks.json").write_text(json.dumps(gnn_chunk_ms, indent=1))
    say(f"done in {time.perf_counter() - t_start:.1f}s")
    _save_log()
    # each launch's row stays in kernels.json; the line keeps the totals
    print(json.dumps({"kernels": [
        {k: v for k, v in e.items() if k != "per_launch"} for e in line]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
