"""Drive the PyTorch port's exclusive-scan path, and the model stack
that consumes it, on one NVIDIA card.

Run from the repository root, on a machine with an H100:

    python3 chip_smoke.py

It builds the kernels from ``src/repro_torch/kernels/csrc`` and prints
one JSON line per phase:

  build    compile every kernel source (one nvcc per source, sm_90a, all
           at once) and load them
  kernels  every kernel instance against its plain PyTorch version (bit
           for bit) at a ragged size: the round kernels at (37, 4099)
           and (37, 4104) (rows unaligned and aligned to 16 bytes), also
           with row tables (peer rows read in place: shifts by 1 and 5,
           an xor permutation, every row -1); the chunked-scan kernels
           at (3, 37, 4099) and at shapes that reach both regimes of
           ``monoid_chunk`` (the look-back at (1, 100 003, 1),
           (3, 50 001, 1), (1, 1000, 1), and 20 runs at (1, 10⁶, 1) that
           must agree; the strip stream at (2, 4099, 37) and (1, 4096,
           8192)), ``affine_chunk`` with a broadcast ``a`` at (3, 37,
           4099) against b of (3, 37, 4099·r), r in {1, 64}; routing at
           (1000, 3, 61), at every cluster size on
           chunk edges, at E = 700, with ids outside [0, E), one expert
           everywhere and unaligned group bases, and 20 runs at (64,
           4096, 4) between calls at other shapes that must agree; then
           each kernel at the shape its path gives it (``affine_chunk``
           also at RWKV6-1.6B's prefill wkv scan, (4, 512, 131 072) with
           the decay broadcast over r = 64, beside the same scan with the
           decay materialised; routing also at
           (1, 4096, 4), (64, 64, 4) and (64, 65 536, 4), at the cluster
           size it picks): kernel, plain and
           library times on the card (CUDA events over calls queued
           behind a sleep, so the host's issue time is not in them)
           beside the least time the card's HBM allows, and the
           kernel's time per call as Python issues it; beside the
           combine, one shift round with the peer row read in place
           against the old gather-then-combine
  table1   ``plan(...).execute(x)`` and ``scan(x, spec)`` over p = 512
           ranks for the paper's algorithms at m in {1, 100, 10 000,
           100 000} int64 under MPI_BXOR, plus a pinned ring, scan_total
           and affine runs; each output against numpy, each stats count
           against the plan, and the kernels' launch counters against the
           IR's ``kernel_launches``; wall times (median, min, max), the
           card's busy time from torch.profiler and its idle share, and
           ``alpha_s`` (seconds per round of 123 at m = 1)
  serve    a ScanService burst of 48 requests over the MoE (payloads from
           ``serve.workloads.moe_dispatch_payload``, qwen2-moe-a2.7b) and
           compression buckets, answers against numpy
  ops      each ``kernels.ops`` entry point once at a real size, checked
           against numpy or a float64 reference
  cp_ssm   ``cp_ssm_scan`` at Jamba-1.5-Large's mamba width (16 384 ×
           16 state floats per token, S = 4096, p = 8 and 64, four carry
           algorithms): h against a float64 recurrence of the whole
           sequence on 8192 sampled columns, rounds and ⊕ against the
           plan, every kernel's launches against the path's
  cp_wkv   ``cp_wkv_scan`` at RWKV6-1.6B's wkv width (32 heads of 64 ×
           64 fp32 states, the decay a broadcast leaf, S = 4096, B = 1,
           p = 8 and 64, four carry algorithms): S_prev against a float64
           recurrence of the whole sequence on 8192 sampled columns,
           rounds and ⊕ against the plan, launches against the path's,
           wall, busy and idle, and the ms of materialising the carry's
           decay to the state's shape for the round kernels
  moe_dispatch  ``dispatch_slots`` at Qwen1.5-MoE-A2.7B's routing (p =
           64 ranks of 4096 tokens, top-4 of 60 experts padded to 64):
           every output equal to numpy, the drop fraction
  composed multi-axis scans through ``scan`` / ``scan_with_total`` on one
           leading rank dimension per axis: (a) ``plan_hierarchical``'s
           xor exscan over 8 x 64 ranks at m in {1, 10 000, 100 000}
           int64, (b) a scan_total add int32 over ("pod", "data") =
           (8, 64) at m = 100 000, (c) an affine exscan over three axes
           (2, 16, 16), 4096 fp32 pairs a rank, (d) a composed plan whose
           inner stage is a segmented ring, at (2, 32) and the smallest
           payload whose plan has one; each row checked and timed as
           table1's, with the device ms of folding its innermost axis
  models   the ported ``Model`` serving through ``launch.serve.serve_loop``
           at full width in bf16, weights from seed 0: RWKV6-1.6B (24
           layers, ranks (1, 1)) and Qwen1.5-MoE-A2.7B (24 layers, 60
           experts padded to 64, top-4, ranks (data 2, model 4)), each
           4 requests of 512 prompt tokens and 32 generated, run twice
           (cold, then reported): prefill ms, decode step p50/p99,
           tok/s, busy and idle of one prefill and one decode step, the
           card's memory, each kernel's launches against the path's,
           the prefill's last-position logits equal to
           ``Model.forward``'s, every logit finite and every token in
           range; for Qwen (its dense layers split over the 4 model
           ranks, share by share) the same serving with the layers
           whole, after it in the same call (prefill ms, step p50/p99,
           busy ms); the first MoE
           layer's ``dispatch_slots``
           (routing, and ``scan_with_total`` on the add round kernels
           over its 8 or 4 groups) on the top_e the path routes at
           prefill (8, 256, 4) and decode (4, 1, 4), card against CPU
           bit for bit; then the SMOKE configs of rwkv6, qwen2_moe (at
           ranks (2, 4)) and jamba in fp32, card against CPU: forward
           logits within atol 3e-4, rtol 3e-3, greedy tokens equal,
           launches against the path's.  Comparisons are kept out of
           the phase's launch counts
  train    the training path (``launch.train``): ``affine_chunk_bwd``,
           the gradient of ``affine_chunk``'s h outputs, against its
           plain version bit for bit (ragged (3, 37, 4099) at r = 1,
           (2, 33, 8192) with the decay broadcast over r = 64, both
           modes, with and without h0, with gY and gH and each alone),
           fp64 gradcheck through ``AffineChunkFn``; then RWKV6-1.6B
           whole in bf16 (fp32 moments, remat), ranks (1, 1), B = 4,
           S = 512, 6 steps, weights from seed 0: step ms (p50, min-max
           over steps 1-5), tok/s, busy and idle of a step and its
           device time by kernel (more steps, untimed), the bytes of
           weights, grads and moments, the peak allocated and the card's
           memory in use, every loss, grad norm and lr, the launches a
           step (48 ``affine_chunk``: 24 forward, 24 remat recomputes; 24
           ``affine_chunk_bwd``), every parameter slice moved by the last
           step; ``affine_chunk_bwd`` on layer 0's operands of one more
           step (4, 512, 131 072), r = 64, bit for bit and timed beside
           its bound; then the smoke rwkv6, jamba and
           qwen2_moe (ranks (2, 4)) in fp32, card against CPU: the loss,
           every gradient leaf and every parameter after one step, and 8
           steps on one batch lowering the loss; and a resume from a
           checkpoint, restored bit for bit.  Comparisons are kept out of
           the phase's launch counts
  spmd     the scan across processes: a ``WorkerPool`` of 8 processes on
           the card, one rank each, over gloo (every message staged
           through pinned host memory, every ⊕ a round kernel): table1's
           xor runs (123, 1doubling, two_op, native at m in {1, 100,
           10 000, 100 000}), a ring at S = 8, halving, a scan_total add
           int32 at m = 100 000 (scan_reduce rounds) and an affine fp32
           exscan of 4096 pairs over ("pod", "data") = (2, 4) (the affine
           butterfly, axis sub-groups), then a pool of 36 (the paper's
           36-node cluster) for 123, 1doubling and two_op at m in {1,
           100}; each run's outputs against numpy (affine also bit for
           bit against ``StackedExecutor``), rank 0's rounds, ⊕ and
           all-gathers against the plan, every process's round-kernel
           launches against the IR and the summed message bytes against
           the schedule's; wall per call (median, min, max of 5, each the
           slowest rank's), ``alpha_s``, staging ms, ``measure_hop`` at 8 B
           and 800 KB, each process's memory, and what gloo does with a
           CUDA tensor in isend/irecv (two processes of their own)
  autotune the planner's online loop (``core/autotune.py``): (a) the
           serve phase's service with an ``AutoTuner`` attached (capacity
           128, a refit every 16 batches, the port's default profile): 16
           warm requests, 48 measured, then more until 3 refits fell due;
           every answer against numpy, one sample a batch (less those
           rejected as foreign recordings), no plan compiled in a batch or
           after warm-up (also across an install), round-kernel launches
           against the IR's; the refits' reasons, drift, residuals and
           fitted constants, p50 / p99 beside the serve phase's. (b) one
           tuner over three services (p in {8, 64, 512}, exclusive add
           int64 of 8 B to 800 KB), started from the JAX package's TPU
           "ici" constants, 240 batches: whether and when it installs, at
           what residual and plans dropped, and auto's picks at table1's
           cells under what it installed beside table1's measured fastest;
           no install above the residual gate, no compile. (c)
           ``launch.train --autotune --autotune-every 2`` on the SMOKE
           rwkv6 for 8 steps: 4 probes and 4 samples, the losses bit for
           bit those without ``--autotune``, probe ms beside step ms. (d)
           8 processes on the card over gloo (staged): ``measure_hops``,
           ``calibrate_dist`` (the dci α, β, γ, residual, fingerprint; its
           store a temporary directory), 5 runs of 123 at 8192 B through
           ``observe_dist`` (the straggler report), ``replan_hierarchical``
           for p in {8, 36} and m in {8, 8192, 1 048 576} B under the
           fitted profile, with and without one rank at 50× the median
  blocks   a block of ranks in each process, on the card over gloo
           (staged): (a) composed (a)'s hierarchical xor exscan over
           (proc, local) = (8, 64), p = 512, at m in {1, 100 000} int64
           as 8 processes of 64 ranks (51.2 MB a process at m = 10⁵):
           outputs against numpy and bit for bit against
           ``StackedExecutor`` (timed in the same run, beside composed
           (a)'s row), process 0's rounds and ⊕ against the plan, each
           process's round-kernel launches against the IR, the crossing
           messages and bytes against ``expected_messages``; wall per call
           (median, min, max of 5), staging ms, each process's memory;
           (b) the ported dist bench's two configs (3 x 4 at 256 KiB, 2 x
           4 at 1 MiB) with its ``--check`` gates; (c) 123, 1doubling and
           a ring (S = 8) over one axis of 4 processes x 8 ranks at m =
           100 000 int64, checked as (a); (d) ``calibrate_dist`` over that
           pool (dci α, β, γ, residual, fingerprint ``procs4x8``) beside
           the one-rank-a-process fit of autotune (d)
  clis     the ported benchmark CLIs and examples, each in this process
           with ``--json`` into a temporary directory, each module's
           launch counts set to 0 just before it: ``round_counts``,
           ``plan_table``, ``autotune_bench``, ``exec_bench`` and
           ``serve_bench`` with ``--check``; the ``run`` harness (round
           counts, plan table, exscan_table1, moe_dispatch,
           ssm_context_parallel); the examples ``quickstart``,
           ``context_parallel_ssm``, ``moe_dispatch_exscan`` and
           ``train_smoke`` (200 steps, then 210 on the same checkpoint
           directory, which must resume from step 200): each module's
           exit code and last line, wall seconds, launches by kernel and
           the numbers of its JSON; a gate that fails, a module that
           raises or one that does not launch the kernels its path runs
           fails the phase.  Inside the harness each module's launches
           are read on their own, and exscan_table1's, moe_dispatch's and
           ssm_context_parallel's must equal what their plans predict for
           their cells' calls (round kernels against the IR, one
           ``moe_routing`` a MoE layer and forward, two ``affine_chunk``
           a prefill); their timed cells' outputs are checked at the
           timed shapes: the MoE logits and aux against the same forward
           with ``--device cpu``, the prefill's h against a float64
           recurrence on every column
  calibrate  ``tune.calibrate`` on the card (p in {8, 64, 512}, m from 8
           to 800 000 bytes): the fitted alpha, beta, gamma and residual,
           and auto's pick under them beside the default's and the
           algorithm table1's and cp_ssm's rows measured fastest; the
           profile is installed for nothing
  cp_train training through the context-parallel scans: (a) the cp
           scans' backward at the cp_wkv cell (p = 8 and 64) and the
           cp_ssm cell (p = 8), decays in [0.99, 1) so that a shard's
           carry reaches the next, carry auto and 123: gradients within 2e-4
           of scale of ``AffineChunkFn``'s over the unsplit sequence on
           the card, the backward's rounds and ⊕ (``collect_stats`` over
           it alone) the plan's, its launches two ``affine_chunk_bwd``
           and the plan's round kernels, forward and backward ms and busy
           beside the sequential backward's; (b) RWKV6-1.6B whole in bf16
           under fsdp_sp at ranks (1, 8), B = 4, S = 512, 6 steps of
           ``make_train_step`` with remat "nothing" and with "dots": step
           ms, busy, idle, peak memory, launches a step against the
           path's, every loss and grad norm finite, the step-0 loss and
           grad norm beside the (1, 1) tp run's from the same seed and
           batch, and fewer matrix products in the backward under "dots";
           (c) the smoke rwkv6 (1, 4) and qwen2_moe (2, 4) under fsdp_sp
           in fp32, card against CPU, as the train phase's; (d)
           ``sparse_gradient_sync`` at p = 8 on the smoke RWKV6's
           gradients (k = 1.0 gives the dense mean and no error; at k =
           0.1 the offsets and their fused plan's rounds) and at full
           width over p = 2 data ranks, each rank's gradient the model's
           on half of one step's batch: ms and the share of ``torch.topk``
  dryrun   the production-mesh dry run (``launch.dryrun``) on the card's
           host, and its trace held to the card: (a) the CLI at
           rwkv6_1_6b train_4k, qwen2_moe_a2_7b decode_32k and
           jamba_1_5_large_398b long_500k on 16 x 16, and qwen2_moe_a2_7b
           decode_32k on 2 x 16 x 16 (no probes), each ``ok``; (b)
           ``lower_cell(...).compile()`` (the step traced on meta tensors)
           of RWKV6-1.6B's train step at (1, 1), B = 4, S = 512, its
           prefill of 4 x 512, and Qwen1.5-MoE-A2.7B's prefill of 4 x 512
           at (2, 4), each a ``ShapeSpec`` of its own, then the step on
           the card from seed 0 (one call to set up, then the measured
           ones): (i) the trace's bound, max(FLOPs / 989e12, bytes /
           3.35e12), at most the call's busy time; (ii) the trace's peak
           within 10 % of ``max_memory_allocated`` over the call; (iii)
           the traced FLOPs within 1 % of ``FlopCounterMode`` over the
           card's call; (iv) each kernel's meta-rule launches equal to the
           card's counters for the call; (c) the ratios, on a line of
           their own

  procs    the scan's consumers over ranks held by processes on the
           card, over gloo (staged): ``WorkerPool.call`` runs
           ``cp_ssm_scan`` at Jamba's width (1 x 4096 tokens of 16 384 x
           16 fp32) and ``cp_wkv_scan`` at RWKV6-1.6B's (32 heads of 64 x
           64), p = 8 as 4 processes of 2 ranks, for auto, 123,
           1doubling and two_op, the forward and the forward and
           backward (whose carry runs the forward's plan on the
           executors' mirrored view), each process drawing its ranks'
           inputs from a seed (``launcher.Draw``) and returning digests of
           its ranks' bits (``launcher.digest``: two sums modulo 2^64 of
           the bit patterns under odd position weights), which must be
           those of the stacked run of the same plan on the same draws
           (run first, kept out of the launch counts, and freed); then
           ``dispatch_slots`` at Qwen1.5-MoE-A2.7B's 64 ranks of 4096
           tokens as 8 processes of 8, every output equal to the stacked
           call's.  Each process's rounds and ⊕ the plan's (twice with
           the backward), its launches the path's (2 ``affine_chunk``, 2
           ``affine_chunk_bwd``, 1 ``moe_routing``) and the IR's round
           kernels, the crossing messages and bytes
           ``expected_messages``'; wall per call (median, min, max of 3)
           beside the stacked one, staging ms, each process's card and
           peak memory; then Qwen1.5-MoE-A2.7B and Llama-3-8B at (1, 4)
           served (bf16, seed 0, 4 x (512 + 32) tokens, full width; over
           gloo on one card at 4 of Qwen's 24 layers and 6 of Llama's
           32, named under ``reduced``, at full depth on four cards)
           with their (data, model) ranks held
           by processes, one rank a process, each holding its e_pad/tp
           experts and its share of the dense layers (its heads, FFN and
           shared-expert columns, vocabulary rows; the row-split
           products all-reduced over "model"), each after the stacked
           ``Model`` at the same ranks (run first and freed; it
           computes the same shards and sums them in the same order, and
           its layers but the MoE FFN take a data shard's rows at a
           time (``Model._rows``), as the
           processes do): Qwen's MoE layer at the prefill and decode
           shapes (y and aux bit for bit the stacked layer's, or within
           bf16's 2^-8 of each row's largest where ``torch.bmm`` alone
           gives other bits at the two batch counts; each process's two
           all-to-alls of the (e_pad·cap, d) buffer, the dispatch scan's
           rounds and ⊕ the plan's, its ``moe_routing`` and round-kernel
           launches the plan's), an all-reduce of a row-split product
           at both shapes alone (every process of a group the same bits),
           then ``serve``: the stacked tokens, every one, the prefill
           logits bit for bit or within 2^-8, prefill ms and decode
           p50/p99 beside the stacked run's, busy and idle of each
           process, its parameter bytes (its share, counted from the
           config) and peak, the all-reduces' calls (the code's count),
           bytes and seconds, the all-gathers' and all-to-alls', each
           kind beside the dry run's price (``roofline.wire_bytes`` over
           ``LINK_BW``), the staging copies; then the FSDP rows: Qwen and
           RWKV6-1.6B at (2, 2) served alike (over gloo on one card at 6
           of Qwen's and 8 of RWKV6's 24 layers, 4 x (512 + 8) tokens;
           on four cards also Llama-3-8B, all at full depth and 4 x (512
           + 32)), each process holding besides its model share its data
           rank's half of every weight's d_model dim (Qwen 7.575 GB,
           RWKV6 0.890, Llama 4.016) and gathering each layer over
           "data" in one all-gather at its use, the experts left sliced
           in the weight-stationary decode (its d-sliced partials
           all-reduced over "data"): the stacked bits as above, each
           process's weight gathers and bytes the code's count
           (``params.fsdp_gathers``), their ms, the prefill's and the
           decode's largest bucket gathered alone (ms, wall, the dry
           run's price), and Jamba SMOKE at (2, 2) (tokens and prefill
           logits bit for bit, every layer kind split over both axes);
           then the mixer rows:
           RWKV6-1.6B at (1, 4) served alike at full width and depth,
           each process its wkv heads and channel-mix columns
           (``cm_wr`` whole), held to the stacked run bit for bit in
           tokens and prefill logits, 49 all-reduces a call, one
           ``affine_chunk`` a layer and prefill a process; on one pool
           of four at (1, 4) Jamba-1.5-Large's Mamba mixer at full width
           (the ``mamba_block`` entry: 4 x 512 prefilled into each
           process's cache share, then 8 decode steps; y, conv and h
           bit for bit the stacked layer's, 2 all-reduces a call, its
           mixer bytes against the whole mixer's) and Jamba SMOKE whole
           (tokens and prefill logits bit for bit); then the training
           rows (``launch.train.train_procs``): RWKV6-1.6B at (2, 2) on
           2 of its 24 layers, full width, bf16, a global batch of 4 x
           512, 2 steps, each process holding, updating and
           checkpointing its share alone, held to the stacked training
           run at (2, 2) on this card (step 0's loss within 1e-2, every
           step's within 2e-2, step 0's gradient norm of each leaf but
           bonus_u within 10 %), each process's collectives a step
           ``params.train_collectives``' and its launches the path's;
           step ms p50 (min-max), busy and idle by process, the
           collectives' ms by kind, parameter, moment and peak GB by
           process; then Jamba SMOKE (fp32) at (2, 2), 3 steps, held as
           on the CPU to the stacked run on the same parameters before
           each step (loss and grad_norm within 1e-5, step 0's
           gradients within 1e-6·max|g| + 1e-4·|g|); then the fsdp_sp
           rows (the sequence split over the model processes, FSDP over
           the whole grid, RWKV6's wkv carry the exscan over the model
           processes in messages): RWKV6-1.6B at (2, 2) on 2 of 24
           layers, 2 steps, held to the stacked fsdp_sp run as the
           training rows are, the carry's rounds and messages its plan's
           at p = tp; Llama-3-8B SMOKE (fp32) at (2, 2), 3 steps, held
           as Jamba SMOKE is; then the decode_ws rows (the weights
           stationary, the activations' d over "data", every row on
           every process): Qwen at (2, 2) on 4 of 24 layers and
           RWKV6-1.6B at (2, 2) on 8, 4 x (512 + 8), and Jamba SMOKE
           (fp32) at (2, 2), each held to the stacked decode_ws twin
           (tokens, logits), each process's collectives to
           ``params.ws_collectives``, beside the FSDP row of the same
           model; the cp scans and the serving rows share one pool of
           four processes (the blocks phase's 4 x 8, kept open)
  cards    the same over NCCL with one process a card, at p = cards x P
           with P = 8 / cards (dispatch at 64 / cards ranks a process),
           plus table 1's xor cell (p = 512, m = 10⁵ int64) as cards x
           512 / cards ranks for 123, 1doubling and two_op against the
           stacked run; no copy staged; ``measure_hop`` at 8 B and 1 MiB
           and ``calibrate_dist`` (the cross-card tier, fingerprint
           ``dist-cuda-nccl-cards<N>-procs<N>x<P>``, installed for
           nothing); on four cards the serving rows (Qwen and
           Llama-3-8B at (1, 4), full width and depth), the FSDP rows
           (Qwen, RWKV6-1.6B and Llama-3-8B at (2, 2), full, and Jamba
           SMOKE at (2, 2)) and the mixer rows (RWKV6-1.6B, the Mamba
           mixer and Jamba SMOKE at (1, 4)) and the training rows
           (RWKV6-1.6B at (2, 2) and (1, 4), full depth, 4 steps;
           Qwen at (2, 2) on 5 of 24 layers and Llama-3-8B at (1, 4) on 8
           of 32, so the stacked run fits one card; Jamba SMOKE at (2,
           2)) and the fsdp_sp rows (RWKV6-1.6B at (1, 4) and (2, 2),
           full depth, and Llama-3-8B at (1, 4) on 8 of 32, 4 steps
           each; one ``Model.forward`` of RWKV6-1.6B at (1, 4) against
           the stacked forward; 8 steps of RWKV6-1.6B at (2, 2) with
           ``--autotune --autotune-every 2``, every process installing
           the same profile at the same steps) and the decode_ws rows
           (Qwen, RWKV6-1.6B and Llama-3-8B at (2, 2), full), no copy
           staged; one pool of four processes for all of it.  With
           fewer than two cards it prints
           ``{"phase": "cards", "ran": false, "cards": 1, ...}`` after
           checking that ``WorkerPool(2, backend="nccl")`` (and with
           ``device="cuda:0"``) raises the pool's own ``ValueError``

then each phase's seconds and the script's (``phase_seconds``; the
spmd, autotune and blocks phases share one pool of eight processes),
the ``kernels`` summary (launches counted over the main path's
phases, table1 to clis, procs, cards, cp_train and dryrun, each with
its counters set to 0 just before it; the processes of spmd, autotune,
blocks, procs and cards count their own), the
card's name and power limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``.
Any failed check raises, so the script exits non-zero, as it does when
a process it started (a pool's child, spawn's resource tracker) is
still there before that last line; it also exits non-zero, printing no
result, when no CUDA card is present or when it is run outside the
repository.

    python3 chip_smoke.py --routing-only | --spmd-only | --train-only
    python3 chip_smoke.py --autotune-only | --blocks-only | --clis-only
    python3 chip_smoke.py --cp-train-only | --dryrun-only
    python3 chip_smoke.py --procs-only | --cards-only | --moe-only | --tp-only
    python3 chip_smoke.py --mixers-only | --fsdp-only | --train-procs-only
    python3 chip_smoke.py --fsdp-sp-only | --decode-ws-only

builds the routing kernel alone and prints its row of the kernels
phase (checked against the plain version at each shape, then timed,
also at every cluster size) and the card's name and power limit; or
builds the kernels and runs the spmd phase, the train phase, the
autotune phase, the blocks phase, the clis phase, the cp_train phase,
the dryrun phase, the procs phase or the cards phase alone (the cards
phase needs two cards or more to run: ``--cards-only`` on four), or
Qwen's serving rows alone (``--moe-only``), the (1, 4) serving rows and
the mixer rows alone (``--tp-only``), the mixer rows alone
(``--mixers-only``), the FSDP rows alone (``--fsdp-only``) or the
training rows alone (``--train-procs-only``; on one card also
``grad_witness``), the fsdp_sp rows alone (``--fsdp-sp-only``) or the
FSDP rows and the decode_ws rows beside them (``--decode-ws-only``),
each over gloo on one card, over NCCL on four
(autotune's parts (a) and (b)
then print no table1 or serve numbers beside their own, (b) timing
table1's cells itself; blocks then prints no composed row or
one-rank-a-process dci fit beside its own).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

SE_SOURCE = "src/repro_torch/kernels/csrc/round_kernels.cu"
TPU_ENGINE = "src/repro/kernels/scan_engine.py"
FP32_PEAK_OPS = 67e12  # H100 SXM, fp32 outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    """Published HBM bytes/s of the card found (NVIDIA data sheets)."""
    return 4.8e12 if "H200" in name else 3.35e12


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, dev, reps: int, warmup: int = 2) -> float:
    """Milliseconds per call when Python issues the calls one after
    another: CUDA events around ``reps`` calls after ``warmup`` (the
    host clock off the card).  Where the host takes longer to issue a
    call than the card to run it, this is the host's rate."""
    for _ in range(warmup):
        fn()
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize(dev)
    return e0.elapsed_time(e1) / reps


SM_HZ = 1.98e9  # H100 SXM boost clock: converts a sleep to cycles


def device_ms(fn, dev, reps: int) -> float:
    """Milliseconds per call on the card alone: the stream first runs a
    sleep kernel long enough for the host to queue all ``reps`` calls
    behind it, so the events time the calls back to back, without the
    host's issue time between them."""
    if dev.type != "cuda":
        return host_ms(fn, dev, reps)
    per_call = host_ms(fn, dev, 3)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((reps * per_call * 3e-3 + 2e-3) * SM_HZ))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize(dev)
    return e0.elapsed_time(e1) / reps


def device_busy_s(fn, dev):
    """Seconds the card spends in kernels and copies during one call of
    ``fn`` (``repro_torch.device.busy_s``); None where the profiler
    records none."""
    from repro_torch import device as device_lib

    return device_lib.busy_s(fn, dev)


def wall_s(fn, dev, reps: int) -> list:
    """Host seconds of ``reps`` calls of ``fn``, each ending in a
    synchronise."""
    times = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        times.append(time.perf_counter() - t0)
    return times


def _leaves(x) -> list:
    if isinstance(x, (tuple, list)):
        return [t for part in x for t in _leaves(part)]
    return [x]


def max_abs_err(got, want) -> float:
    err = 0.0
    for g, w in zip(_leaves(got), _leaves(want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{tuple(g.shape)}/{g.dtype} vs "
                                 f"{tuple(w.shape)}/{w.dtype}")
        d = (g.double() - w.double()).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def identical(got, want) -> bool:
    return all(g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(_leaves(got), _leaves(want)))


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def phase_build() -> dict:
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build, moe_routing as mr
    from repro_torch.kernels import scan_engine as se

    t0 = time.perf_counter()
    sources = sorted(_build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        list(pool.map(_build.compile_source, sources))
    for load in (se._lib, se._chunk_lib, mr._lib):  # load and bind
        load()
    return {"phase": "build", "sources": [s.name for s in sources],
            "seconds": time.perf_counter() - t0, "card": card_info()}


# ---------------------------------------------------------------------------
# kernels: every instance against its plain version, and their times
# ---------------------------------------------------------------------------

OPS = ("add", "mul", "max", "min", "xor", "affine")
DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64,
          torch.bfloat16)


def rand_leaf(rng, dtype, rows, n, dev):
    if dtype in (torch.int32, torch.int64):
        a = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, (rows, n)))
    else:
        a = torch.from_numpy(rng.standard_normal((rows, n)))
    return a.to(device=dev, dtype=dtype)


def rand_operand(rng, op, dtype, rows, n, dev):
    if op == "affine":
        return (rand_leaf(rng, dtype, rows, n, dev),
                rand_leaf(rng, dtype, rows, n, dev))
    return rand_leaf(rng, dtype, rows, n, dev)


def row_tables(p: int, dev) -> dict:
    """Row tables as the executor builds them: shifts by 1 and 5 (any
    negative entry reads zeros), an xor permutation (partners past p
    read zeros), every row -1."""
    r = np.arange(p)
    tabs = {"shift1": r - 1, "shift5": r - 5,
            "xor4": np.where((r ^ 4) < p, r ^ 4, -1),
            "none": np.full(p, -1)}
    return {k: torch.from_numpy(v.astype(np.int32)).to(dev)
            for k, v in tabs.items()}


def check_instances(dev, p: int, n: int) -> int:
    """Every (template, ⊕, dtype) instance bit-identical to its plain
    version at (p, n), with plain operands and with a row-table operand
    (against the plain version on the gathered rows); returns the
    number of comparisons."""
    from repro_torch.kernels import scan_engine as se

    rng = np.random.default_rng(0)
    mask = torch.from_numpy(
        rng.integers(0, 2, p).astype(np.int32)).to(dev)
    tables = row_tables(p, dev)
    checks = 0
    for op in OPS:
        for dt in DTYPES:
            if not se.kernel_serves(op, dt):
                continue
            a, b, c = (rand_operand(rng, op, dt, p, n, dev)
                       for _ in range(3))
            row = rand_operand(rng, op, dt, 1, n, dev)
            pairs = [
                (se.combine(op, a, b), se.combine_plain(op, a, b)),
                (se.exchange(op, a, b, mask),
                 se.exchange_plain(op, a, b, mask)),
            ]
            for else_a in (False, True):
                pairs.append((
                    se.combine(op, a, b, mask=mask, else_a=else_a),
                    se.combine_plain(op, a, b, mask=mask, else_a=else_a)))
            pairs.append((se.combine(op, a, row, mask=mask, else_a=True),
                          se.combine_plain(op, a, row, mask=mask,
                                           else_a=True)))
            for comm in (False, True):
                got = se.scan_reduce(op, a, b, c, mask, commutative=comm)
                want = se.scan_reduce_plain(op, a, b, c, mask,
                                            commutative=comm)
                pairs += list(zip(got, want))
            for src in tables.values():
                ra = se.Rows(a, src)
                ga = se.gather_rows(ra)
                pairs += [
                    (se.combine(op, ra, b, mask=mask),
                     se.combine_plain(op, ga, b, mask=mask)),
                    (se.combine(op, b, ra),
                     se.combine_plain(op, b, ga)),
                    (se.exchange(op, ra, b, mask),
                     se.exchange_plain(op, ga, b, mask))]
                pairs += list(zip(
                    se.scan_reduce(op, ra, b, c, mask, commutative=True),
                    se.scan_reduce_plain(op, ga, b, c, mask,
                                         commutative=True)))
            sync(dev)
            for got, want in pairs:
                if not identical(got, want):
                    raise AssertionError(
                        f"round kernel {op}/{dt} at p={p} n={n} differs "
                        f"from its plain version by "
                        f"{max_abs_err(got, want)}")
                checks += 1
    return checks


def check_chunk_instances(dev, g: int, t: int, d: int, *,
                          ints_only: bool = False,
                          affine: bool = True) -> int:
    """Every chunked-scan instance (each elementwise ⊕ and dtype, the
    affine scan, summary and general forms) bit-identical to its plain
    version at (g, t, d); returns the number of comparisons.
    ``ints_only`` keeps the integer ⊕ (the look-back regime at D = 1,
    where a float's plain version is a row loop of t steps)."""
    from repro_torch.kernels import scan_engine as se

    rng = np.random.default_rng(10)
    checks = 0

    def same(got, want, label):
        nonlocal checks
        sync(dev)
        for gl, wl in zip(got, want):
            if (gl is None) != (wl is None) or (
                    gl is not None and not identical(gl, wl)):
                raise AssertionError(
                    f"chunked-scan kernel {label} at {(g, t, d)} differs "
                    f"from its plain version")
            checks += gl is not None
    for op in OPS[:-1]:
        for dt in DTYPES:
            if not se.kernel_serves(op, dt) or (
                    ints_only and dt.is_floating_point):
                continue
            x = rand_leaf(rng, dt, g * t, d, dev).reshape(g, t, d)
            init = rand_leaf(rng, dt, g, d, dev)
            for kw in ({}, {"init": init, "exclusive": False,
                            "final": True}):
                same(se.monoid_chunk(x, op, **kw),
                     se.monoid_chunk_plain(x, op, **kw), f"{op}/{dt}")
    if not affine:
        return checks
    for dt in (torch.float32, torch.float64):
        a, b = (torch.from_numpy(rng.uniform(0.9, 1.1, (g, t, d)))
                .to(device=dev, dtype=dt) for _ in range(2))
        a0, h0 = (rand_leaf(rng, dt, g, d, dev) for _ in range(2))
        for kw in ({"h0": h0, "h_final": True},
                   {"h_traj": False, "a_final": True, "h_final": True},
                   {"a0": a0, "h0": h0, "exclusive": True, "a_traj": True,
                    "a_final": True, "h_final": True}):
            same(se.affine_chunk(a, b, **kw),
                 se.affine_chunk_plain(a, b, **kw), f"affine/{dt}")
    return checks


def check_broadcast_affine(dev, g: int, t: int, d: int,
                           rs=(1, 64)) -> int:
    """``affine_chunk`` with a broadcast ``a`` of (g, t, d) against b of
    (g, t, d·r), for each r: every output form bit-identical to the
    plain version, and h equal to the run with ``a`` materialised to
    b's shape (the A outputs keep a's shape); returns the number of
    comparisons."""
    from repro_torch.kernels import scan_engine as se

    rng = np.random.default_rng(11)
    checks = 0
    for r in rs:
        for dt in (torch.float32, torch.float64):
            a = torch.from_numpy(rng.uniform(0.9, 1.1, (g, t, d))).to(
                device=dev, dtype=dt)
            b = torch.from_numpy(rng.standard_normal((g, t, d * r))).to(
                device=dev, dtype=dt)
            a0 = torch.from_numpy(rng.uniform(0.9, 1.1, (g, d))).to(
                device=dev, dtype=dt)
            h0 = torch.from_numpy(rng.standard_normal((g, d * r))).to(
                device=dev, dtype=dt)
            for kw in ({"h0": h0, "h_final": True},
                       {"h0": h0, "exclusive": True, "h_final": True},
                       {"h_traj": False, "a_final": True, "h_final": True},
                       {"a0": a0, "h0": h0, "exclusive": True,
                        "a_traj": True, "a_final": True, "h_final": True}):
                got = se.affine_chunk(a, b, **kw)
                want = se.affine_chunk_plain(a, b, **kw)
                full = se.affine_chunk(
                    a.repeat_interleave(r, dim=2), b,
                    **{**kw, "a0": None if "a0" not in kw
                       else a0.repeat_interleave(r, dim=1)})
                sync(dev)
                for gl, wl in zip(got, want):
                    if (gl is None) != (wl is None) or (
                            gl is not None and not identical(gl, wl)):
                        raise AssertionError(
                            f"broadcast affine_chunk r={r} {dt} {kw.keys()}"
                            f" differs from its plain version")
                    checks += gl is not None
                for gl, fl in zip(got[1::2], full[1::2]):
                    if gl is not None and not identical(gl, fl):
                        raise AssertionError(
                            f"broadcast affine_chunk r={r} {dt} differs "
                            f"from the materialised a")
    return checks


# (g, t, d, ints_only) shapes that reach both regimes of monoid_chunk:
# the look-back (integer ⊕ at D = 1) across many tiles with a ragged
# last one, and in one tile; the strip stream at ragged D and at the
# ops path's (4096, 8192)
REGIME_SHAPES = ((1, 100_003, 1, True), (3, 50_001, 1, True),
                 (1, 1000, 1, False), (2, 4099, 37, False),
                 (1, 4096, 8192, False))


def check_regimes(dev, n: int = 10**6, runs: int = 20) -> dict:
    """monoid_chunk at REGIME_SHAPES, bit for bit, and the look-back
    ``runs`` times at (1, n, 1): every output the same, the plain one."""
    from repro_torch.kernels import scan_engine as se

    checks = {}
    for g, t, d, ints_only in REGIME_SHAPES:
        checks[f"{g}x{t}x{d}"] = check_chunk_instances(
            dev, g, t, d, ints_only=ints_only, affine=False)
        torch.cuda.empty_cache()
    x = torch.from_numpy(np.random.default_rng(13).integers(
        -(1 << 40), 1 << 40, (1, n, 1))).to(dev)
    want = se.monoid_chunk_plain(x, "add", final=True)
    for _ in range(runs):
        got = se.monoid_chunk(x, "add", final=True)
        sync(dev)
        if not (identical(got[0], want[0]) and identical(got[1], want[1])):
            raise AssertionError("the look-back scan gave another result "
                                 "on a repeated run")
    return {"shapes": checks, "repeat_runs_identical": runs}


def same_routing(ids, e: int, cluster=None) -> None:
    """One launch of the routing kernel (none on the CPU, which runs the
    plain version), bit-identical to its plain version."""
    from repro_torch.kernels import moe_routing as mr

    before = mr.moe_routing.launches
    got = mr.moe_routing(ids, num_experts=e, _cluster=cluster)
    want = mr.moe_routing_plain(ids, num_experts=e)
    sync(ids.device)
    if mr.moe_routing.launches - before != int(ids.is_cuda):
        raise AssertionError("moe_routing launched other than once")
    if not identical(got, want):
        raise AssertionError(f"moe_routing at {tuple(ids.shape)}, E={e}, "
                             f"cluster={cluster} differs from its plain "
                             f"version")


def check_routing(dev, t: int, k: int, e: int, *, repeats: int = 20) -> dict:
    """The routing kernel bit-identical to its plain version, one launch
    a call: at (t, k) and e experts, one group and three; at every
    cluster size on chunk edges (T·K on, before and past a multiple of
    4·CL, under 4·CL, T = 0); one group at the largest cluster; every id
    one expert; ids outside [0, E); E = 700; group bases off 16 bytes
    (odd T·K, and a view one int32 into its storage); then ``repeats``
    runs at moe_dispatch's shape, each after a call at another shape,
    all giving the plain result."""
    from repro_torch.kernels import moe_routing as mr

    rng = np.random.default_rng(11)

    def ids(shape, n_exp, lo=0, hi=None):
        a = rng.integers(lo, n_exp if hi is None else hi, shape)
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    checks = {}
    for shape in ((t, k), (3, t, k)):
        same_routing(ids(shape, e), e)
    checks["ragged"] = 2
    edges = ((2, 64, 4), (2, 63, 4), (2, 65, 4), (3, 7, 1), (2, 1, 3),
             (2, 0, 4), (1, 4097, 3))
    for cl in mr.CLUSTER_SIZES:
        for shape in edges:
            same_routing(ids(shape, 61), 61, cl)
    checks["chunk_edges"] = len(mr.CLUSTER_SIZES) * len(edges)
    for shape in ((1, 4096, 4), (1, 100_003, 3)):
        same_routing(ids(shape, 64), 64, max(mr.CLUSTER_SIZES))
    checks["one_group_largest_cluster"] = 2
    for cl in (None, 1, 8):
        same_routing(torch.full((4, 4096, 4), 5, dtype=torch.int32,
                                device=dev), 64, cl)
    checks["one_expert"] = 3
    for cl in (None, 1, 4, 8):
        same_routing(ids((3, 1001, 4), 40, -3, 45), 40, cl)
    checks["ids_outside"] = 4
    for shape in ((2, 50, 8), (64, 4096, 4), (1, 4096, 4)):
        same_routing(ids(shape, 700), 700)
    checks["experts_700"] = 3
    for cl in (None, 1, 2, 8):
        same_routing(ids((5, 333, 3), 64), 64, cl)
        flat = ids((1 + 4 * 2048 * 4,), 64)
        same_routing(flat[1:].view(4, 2048, 4), 64, cl)
    checks["unaligned_bases"] = 8
    main = ids((64, 4096, 4), 64)
    want = mr.moe_routing_plain(main, num_experts=64)
    others = [ids(shape, 64) for shape in ((1, 4096, 4), (64, 64, 4),
                                           (3, 999, 2))]
    for i in range(repeats):
        mr.moe_routing(others[i % len(others)], num_experts=64)
        got = mr.moe_routing(main, num_experts=64)
        sync(dev)
        if not identical(got, want):
            raise AssertionError(f"moe_routing gave another result on "
                                 f"repeat {i}")
    checks["repeats_identical"] = repeats
    return checks


def bound(nbytes: int, ops: int, rate: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / rate, ops / FP32_PEAK_OPS
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def measure(name, dev, rate, kernel, plain, library, nbytes, ops,
            reps) -> dict:
    got, want = kernel(), plain()
    sync(dev)
    if not identical(got, want):
        raise AssertionError(f"{name}: kernel differs from plain by "
                             f"{max_abs_err(got, want)}")
    bound_ms, bound_by = bound(nbytes, ops, rate)
    return {
        "max_abs_err": max_abs_err(got, want),
        "ms": device_ms(kernel, dev, reps),
        "plain_ms": device_ms(plain, dev, reps),
        "library_ms": (None if library is None
                       else device_ms(library, dev, reps)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "host_ms": host_ms(kernel, dev, reps),
        "plain_host_ms": host_ms(plain, dev, reps),
    }


def path_kernels(dev, rate, *, p=512, n_int=100_000, n_affine=4096,
                 reps=20) -> dict:
    """Each kernel at the shape the main path gives it (table1's largest
    m for the elementwise instances, the affine runs' n for affine)."""
    from repro_torch.core import schedule as sch
    from repro_torch.kernels import scan_engine as se

    rng = np.random.default_rng(1)
    low = (torch.arange(p, device=dev) & 1).to(torch.int32)  # skip-1 side
    keep = (torch.arange(p, device=dev) >= 1).to(torch.int32)
    shift1 = row_tables(p, dev)["shift1"]
    x64 = [rand_leaf(rng, torch.int64, p, n_int, dev) for _ in range(2)]
    i32 = [rand_leaf(rng, torch.int32, p, n_int, dev) for _ in range(3)]
    aff = [rand_operand(rng, "affine", torch.float32, p, n_affine, dev)
           for _ in range(3)]
    e_int, e_aff = p * n_int, p * n_affine
    out = {}
    out["combine"] = measure(
        "combine xor int64", dev, rate,
        lambda: se.combine("xor", *x64),
        lambda: se.combine_plain("xor", *x64),
        lambda: torch.bitwise_xor(*x64), 3 * e_int * 8, e_int, reps)
    masked = measure(
        "masked combine xor int64", dev, rate,
        lambda: se.combine("xor", *x64, mask=keep),
        lambda: se.combine_plain("xor", *x64, mask=keep),
        None, 3 * e_int * 8 + 4 * p, e_int, reps)
    # one shift round (skip 1, masked) as the executor runs it: the peer
    # row read in place; beside it the old two steps, the _shift_rows
    # copy and then the combine, and the copy alone
    peer = se.Rows(x64[0], shift1)
    shift = measure(
        "shift round xor int64", dev, rate,
        lambda: se.combine("xor", peer, x64[1], mask=keep),
        lambda: se.combine_plain("xor", se.gather_rows(peer), x64[1],
                                 mask=keep),
        None, 3 * e_int * 8 + 8 * p, e_int, reps)
    two_step = device_ms(
        lambda: se.combine("xor", sch._shift_rows(x64[0], 1), x64[1],
                           mask=keep), dev, reps)
    copy_only = device_ms(lambda: sch._shift_rows(x64[0], 1), dev, reps)
    out["combine"].update(masked_ms=masked["ms"],
                          masked_plain_ms=masked["plain_ms"],
                          masked_bound_ms=masked["bound_ms"],
                          shift_round_ms=shift["ms"],
                          shift_round_bound_ms=shift["bound_ms"],
                          shift_round_two_step_ms=two_step,
                          shift_copy_ms=copy_only)
    out["exchange"] = measure(
        "exchange add int64", dev, rate,
        lambda: se.exchange("add", *x64, low),
        lambda: se.exchange_plain("add", *x64, low),
        lambda: torch.add(*x64), 3 * e_int * 8 + 4 * p, e_int, reps)
    out["exchange"]["library"] = "torch.add (r ⊕ w on every rank)"
    out["scan_reduce"] = measure(
        "scan_reduce add int32", dev, rate,
        lambda: se.scan_reduce("add", *i32, low, commutative=True),
        lambda: se.scan_reduce_plain("add", *i32, low, commutative=True),
        None, 5 * e_int * 4 + 4 * p, 1.5 * e_int, reps)
    out["combine_affine"] = measure(
        "combine affine fp32", dev, rate,
        lambda: se.combine("affine", aff[0], aff[1]),
        lambda: se.combine_plain("affine", aff[0], aff[1]),
        None, 6 * e_aff * 4, 3 * e_aff, reps)
    out["exchange_affine"] = measure(
        "exchange affine fp32", dev, rate,
        lambda: se.exchange("affine", aff[0], aff[1], low),
        lambda: se.exchange_plain("affine", aff[0], aff[1], low),
        None, 6 * e_aff * 4 + 4 * p, 3 * e_aff, reps)
    out["scan_reduce_affine"] = measure(
        "scan_reduce affine fp32", dev, rate,
        lambda: se.scan_reduce("affine", *aff, low, commutative=False),
        lambda: se.scan_reduce_plain("affine", *aff, low,
                                     commutative=False),
        None, 10 * e_aff * 4 + 4 * p, 4.5 * e_aff, reps)
    return out


ROUTE_SHAPES = ((1, 4096, 4), (64, 64, 4), (64, 65_536, 4))


def wkv_scan_times(dev, rate, gen, shape, reps) -> dict:
    """RWKV's wkv scan as ``rwkv.wkv_scan_chunked`` launches it: (B, S,
    H·hd·hd) fp32 states with the decay a broadcast (B, S, H·hd) leaf
    (r = hd), exclusive from h0, with the final state; beside it the
    same scan with the decay materialised to the state's shape."""
    from repro_torch.kernels import scan_engine as se

    g, t, d, r = shape
    w = torch.rand((g, t, d // r), generator=gen, device=dev).mul_(0.1) \
        .add_(0.9)
    kv = torch.randn((g, t, d), generator=gen, device=dev)
    s0 = torch.randn((g, d), generator=gen, device=dev)
    kw = {"h0": s0, "exclusive": True, "h_final": True}
    e = g * t * d
    row = measure(
        "affine_chunk wkv broadcast fp32", dev, rate,
        lambda: se.affine_chunk(w, kv, **kw)[1::2],
        lambda: se.affine_chunk_plain(w, kv, **kw)[1::2],
        None, 2 * e * 4 + g * t * (d // r) * 4 + 2 * g * d * 4, 2 * e, reps)
    w_full = w.repeat_interleave(r, dim=2)
    if not identical(se.affine_chunk(w_full, kv, **kw)[1::2],
                     se.affine_chunk(w, kv, **kw)[1::2]):
        raise AssertionError("wkv scan: broadcast and materialised decay "
                             "differ")
    row.update(
        shape=[g, t, d], r=r,
        materialised_ms=device_ms(lambda: se.affine_chunk(w_full, kv, **kw),
                                  dev, reps),
        materialised_bound_ms=bound(3 * e * 4 + 2 * g * d * 4, 2 * e,
                                    rate)[0])
    del w, kv, s0, w_full
    torch.cuda.empty_cache()
    return row


def path_chunk_kernels(dev, rate, *, ex=(4096, 8192), ex_small=10**6,
                       aff=(8, 512, 262_144), wkv=(4, 512, 131_072, 64),
                       route=(64, 4096, 4, 64),
                       route_shapes=ROUTE_SHAPES, route_reps=50,
                       reps=5) -> dict:
    """The chunked-scan and routing kernels at the shapes their paths
    give them: ops.exscan's (T, D) and 1-D vector, cp_ssm's per-rank
    shards at p = 8 (G = p·B, S/p, d_inner·d_state), RWKV6-1.6B's
    prefill wkv scan (B = 4, S = 512, 32 heads of 64 × 64 states, the
    decay broadcast over 64 columns), moe_dispatch's p = 64 ranks of
    4096 tokens, top-4 of 64 padded experts."""
    from repro_torch.kernels import scan_engine as se

    gen = torch.Generator(device=dev).manual_seed(12)
    out = {}
    t, d = ex
    xf = torch.randn((t, d), generator=gen, device=dev)
    ms = measure(
        "monoid_exscan add fp32", dev, rate,
        lambda: se.monoid_exscan(xf, "add"),
        lambda: se.monoid_chunk_plain(xf, "add")[0],
        lambda: torch.cumsum(xf, dim=0), 2 * t * d * 4, t * d, reps)
    xi = torch.randint(-(1 << 62), 1 << 62, (t, d), generator=gen,
                       device=dev)
    xor = measure(
        "monoid_exscan xor int64", dev, rate,
        lambda: se.monoid_exscan(xi, "xor"),
        lambda: se.monoid_chunk_plain(xi, "xor")[0], None,
        2 * t * d * 8, t * d, reps)
    xs = torch.randint(-(1 << 40), 1 << 40, (ex_small, 1), generator=gen,
                       device=dev)
    small = measure(
        "monoid_exscan add int64 small-D", dev, rate,
        lambda: se.monoid_exscan(xs, "add"),
        lambda: se.monoid_chunk_plain(xs, "add")[0],
        lambda: torch.cumsum(xs, dim=0), 2 * ex_small * 8, ex_small, reps)
    del xf, xi, xs
    ms.update(shape=list(ex), library="torch.cumsum (inclusive)",
              regime=se.monoid_chunk_regime("add", torch.float32, d),
              xor_int64={"regime": se.monoid_chunk_regime(
                  "xor", torch.int64, d), **{k: xor[k] for k in (
                      "ms", "plain_ms", "bound_ms", "host_ms")}},
              small_d_int64={"shape": [ex_small, 1],
                             "regime": se.monoid_chunk_regime(
                                 "add", torch.int64, 1),
                             **{k: small[k] for k in (
                                 "ms", "plain_ms", "library_ms",
                                 "bound_ms", "host_ms")}})
    out["monoid_exscan"] = ms

    g, t, d = aff
    a = torch.rand(aff, generator=gen, device=dev).mul_(0.1).add_(0.9)
    b = torch.randn(aff, generator=gen, device=dev)
    h0 = torch.randn((g, d), generator=gen, device=dev)
    e = g * t * d
    scan_t = measure(
        "affine_chunk_scan fp32", dev, rate,
        lambda: se.affine_chunk_scan(a, b, h0),
        lambda: se.affine_chunk_plain(a, b, h0=h0, h_final=True)[1::2],
        None, 3 * e * 4 + 2 * g * d * 4, 2 * e, reps)
    summ = measure(
        "affine_chunk_summary fp32", dev, rate,
        lambda: se.affine_chunk_summary(a, b),
        lambda: se.affine_chunk_plain(a, b, h_traj=False, a_final=True,
                                      h_final=True)[2:],
        None, 2 * e * 4 + 2 * g * d * 4, 3 * e, reps)
    del a, b, h0
    scan_t.update(shape=list(aff), summary={
        k: summ[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "host_ms")})
    scan_t["wkv_broadcast"] = wkv_scan_times(dev, rate, gen, wkv, reps)
    out["affine_chunk"] = scan_t

    out["moe_routing"] = routing_path_times(dev, rate, gen, route,
                                            route_shapes, route_reps)
    return out


def routing_cluster(dev, ids) -> int:
    from repro_torch.kernels import moe_routing as mr

    g, t, k = ids.shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return mr.routing_cluster(g, t * k, sms)


def ms_by_cluster(dev, ids, n_exp: int, reps: int) -> dict:
    """Device ms of moe_routing on ``ids`` at every cluster size."""
    from repro_torch.kernels import moe_routing as mr

    return {str(cl): device_ms(lambda cl=cl: mr.moe_routing(
        ids, num_experts=n_exp, _cluster=cl), dev, reps)
        for cl in mr.CLUSTER_SIZES}


def routing_times(dev, rate, ids, n_exp: int, reps: int, *,
                  sweep: bool) -> dict:
    """moe_routing on ``ids``: checked against its plain version (eight
    groups at a time, so the one-hot stays small), then device and host
    ms beside the byte bound and the cluster size the wrapper picks;
    with ``sweep``, the device ms at every cluster size."""
    from repro_torch.kernels import moe_routing as mr

    g, t, k = ids.shape
    got = mr.moe_routing(ids, num_experts=n_exp)
    for a in range(0, g, 8):
        want = mr.moe_routing_plain(ids[a:a + 8], num_experts=n_exp)
        if not identical((got[0][a:a + 8], got[1][a:a + 8]), want):
            raise AssertionError(f"moe_routing at {(g, t, k)} differs from "
                                 f"its plain version")
    del got
    bound_ms, bound_by = bound(2 * g * t * k * 4 + g * n_exp * 4, g * t * k,
                               rate)
    run = lambda: mr.moe_routing(ids, num_experts=n_exp)  # noqa: E731
    row = {"shape": [g, t, k], "experts": n_exp,
           "ms": device_ms(run, dev, reps), "bound_ms": bound_ms,
           "bound_by": bound_by, "host_ms": host_ms(run, dev, reps),
           "cluster": routing_cluster(dev, ids)}
    if sweep:
        row["ms_by_cluster"] = ms_by_cluster(dev, ids, n_exp, reps)
    return row


def routing_path_times(dev, rate, gen, route, shapes, reps, *,
                       sweep: bool = False) -> dict:
    """The routing row: moe_dispatch's (p, n0, k) and E at ``route`` (the
    kernels line's row: kernel, plain and bound; no PyTorch call computes
    positions, so no library time: ``torch.bincount`` of the group-keyed
    ids, which counts only, is timed beside it), and sub-rows at
    ``shapes`` (the ops phase's one assignment, a serve payload, 16x
    moe_dispatch's tokens); with ``sweep``, every row also times every
    cluster size."""
    from repro_torch.kernels import moe_routing as mr

    g, t, k, n_exp = route
    ids = torch.randint(0, n_exp, (g, t, k), generator=gen, device=dev,
                        dtype=torch.int32)
    keyed = (ids + n_exp * torch.arange(g, device=dev,
                                         dtype=torch.int32)[:, None, None]
             ).flatten()
    rt = measure(
        "moe_routing", dev, rate,
        lambda: mr.moe_routing(ids, num_experts=n_exp),
        lambda: mr.moe_routing_plain(ids, num_experts=n_exp), None,
        2 * g * t * k * 4 + g * n_exp * 4, g * t * k, reps)
    rt.update(shape=[g, t, k], experts=n_exp,
              cluster=routing_cluster(dev, ids),
              counts_only_bincount_ms=device_ms(
                  lambda: torch.bincount(keyed, minlength=g * n_exp), dev,
                  reps))
    if sweep:
        rt["ms_by_cluster"] = ms_by_cluster(dev, ids, n_exp, reps)
    del ids, keyed
    rt["shapes"] = {}
    for g, t, k in shapes:
        sub = torch.randint(0, n_exp, (g, t, k), generator=gen, device=dev,
                            dtype=torch.int32)
        rt["shapes"][f"{g}x{t}x{k}"] = routing_times(dev, rate, sub, n_exp,
                                                     reps, sweep=sweep)
        del sub
        torch.cuda.empty_cache()
    return rt


def phase_kernels(dev, rate, *, ragged=(37, 4099), aligned_n=4104,
                  ragged_g=3, routing=(1000, 3, 61), path=None,
                  chunk_path=None):
    checks = check_instances(dev, *ragged)
    aligned = (ragged[0], aligned_n)
    checks_aligned = check_instances(dev, *aligned)
    chunk_checks = check_chunk_instances(dev, ragged_g, *ragged)
    broadcast_checks = check_broadcast_affine(dev, ragged_g, *ragged)
    regimes = check_regimes(dev)
    routing_checks = check_routing(dev, *routing)
    timed = path_kernels(dev, rate, **(path or {}))
    timed.update(path_chunk_kernels(dev, rate, **(chunk_path or {})))
    line = {"phase": "kernels", "ragged": list(ragged),
            "instances_checked": checks, "aligned": list(aligned),
            "instances_checked_aligned": checks_aligned,
            "chunk_ragged": [ragged_g, *ragged],
            "chunk_instances_checked": chunk_checks,
            "broadcast_affine_checked": broadcast_checks,
            "broadcast_affine_r": [1, 64],
            "chunk_regimes_checked": regimes,
            "routing_ragged": list(routing),
            "routing_checked": routing_checks, "bit_identical": True,
            "timed": timed}
    return line, timed


# ---------------------------------------------------------------------------
# table1: the paper's sweep through the port's entry points
# ---------------------------------------------------------------------------


def exclusive_ref(x: np.ndarray, ufunc) -> np.ndarray:
    out = np.zeros_like(x)
    if x.shape[0] > 1:
        out[1:] = ufunc.accumulate(x[:-1], axis=0)
    return out


def affine_ref(a: np.ndarray, b: np.ndarray):
    """Sequential float64 fold: (exclusive (A, B) per rank, total)."""
    A, B = np.ones(a.shape[1]), np.zeros(a.shape[1])
    ea, eb = np.empty(a.shape), np.empty(a.shape)
    for r in range(a.shape[0]):
        ea[r], eb[r] = A, B
        A, B = a[r] * A, a[r] * B + b[r]
    return (ea, eb), (np.broadcast_to(A, a.shape), np.broadcast_to(B, a.shape))


# float32 composition of up to 512 affine maps, taken in another
# association order than the float64 fold: |err| <= AFFINE_TOL·(1+|ref|)
AFFINE_TOL = 1e-4


def close_affine(got, want) -> float:
    worst = 0.0
    for g, w in zip(got, want):
        g = g.detach().cpu().double().numpy()
        rel = np.abs(g - w) / (1.0 + np.abs(w))
        worst = max(worst, float(rel.max()))
    if worst > AFFINE_TOL:
        raise AssertionError(f"affine scan off the float64 fold by "
                             f"{worst} > {AFFINE_TOL}")
    return worst


def equal_int(got, want: np.ndarray) -> float:
    return equal_np(got.detach().cpu().numpy(), want)


def equal_np(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError("integer scan differs from numpy")
    return 0.0


ROUND_KERNELS = ("combine", "exchange", "scan_reduce")


def run_checked(label, pl, run, check, dev, reps, path_launches=None) -> dict:
    """One checked run of ``pl`` (via ``run``), then ``reps`` timed.
    The round kernels must launch what the IR predicts, and every other
    kernel what ``path_launches`` names (none by default)."""
    from repro_torch.core import monoid as monoid_lib
    from repro_torch.core import schedule as sch
    from repro_torch.kernels import scan_engine as se

    m = monoid_lib.get(pl.spec.monoid)
    ir = pl.schedule().kernel_launches(m.commutative, fused=True)
    before = se.launch_counts()
    with sch.collect_stats() as st:
        out = run()
    sync(dev)
    after = se.launch_counts()
    moved = {k: after[k] - before.get(k, 0) for k in after}
    delta = sum(moved[k] for k in ROUND_KERNELS)
    others = {k: v for k, v in moved.items() if k not in ROUND_KERNELS}
    on_card = dev.type == "cuda"
    want_others = {k: (path_launches or {}).get(k, 0) if on_card else 0
                   for k in others}
    err = check(out)
    if (st.rounds, st.op_applications) != (pl.rounds, pl.op_applications):
        raise AssertionError(
            f"{label}: measured rounds/⊕ {st.rounds}/{st.op_applications}"
            f" != plan {pl.rounds}/{pl.op_applications}")
    if st.kernel_launches != ir or delta != (ir if on_card else 0):
        raise AssertionError(
            f"{label}: launch counters moved {delta}, stats recorded "
            f"{st.kernel_launches}, IR predicts {ir}")
    if others != want_others:
        raise AssertionError(f"{label}: kernels launched {others}, the "
                             f"path predicts {want_others}")
    times = wall_s(run, dev, reps)
    median = statistics.median(times)
    busy = device_busy_s(run, dev)
    row = {"run": label, "algorithm": pl.algorithm,
           "segments": pl.segments, "rounds": st.rounds,
           "ops": st.op_applications, "kernel_launches": ir,
           "launch_delta": delta, "max_err": err,
           "median_s": median, "min_s": min(times), "max_s": max(times),
           "device_busy_s": busy,
           "idle_share": None if busy is None else 1.0 - busy / median}
    if path_launches:
        row["path_launch_delta"] = {k: v for k, v in others.items() if v}
    return row


def phase_table1(dev, *, p=512, ms=(1, 100, 10_000, 100_000),
                 ring=(64, 16 << 20), n_add=100_000, n_affine=4096,
                 reps=5) -> dict:
    from repro_torch.core.scan_api import (
        ScanSpec, plan, scan, scan_with_total)

    rng = np.random.default_rng(2)
    rows = []
    for m in ms:
        xn = rng.integers(-(1 << 62), 1 << 62, (p, m), dtype=np.int64)
        want = exclusive_ref(xn, np.bitwise_xor)
        x = torch.from_numpy(xn).to(dev)
        for algo in ("123", "1doubling", "two_op", "native", "auto"):
            spec = ScanSpec(kind="exclusive", monoid="xor",
                            algorithm=algo)
            pl = plan(spec, p, nbytes=8 * m)
            run = ((lambda x=x, spec=spec: scan(x, spec)) if algo == "auto"
                   else (lambda x=x, pl=pl: pl.execute(x)))
            rows.append(dict(run_checked(
                f"xor/{algo}/m={m}", pl, run,
                lambda out, want=want: equal_int(out, want), dev, reps),
                m=m))
        del x

    p_ring, nbytes = ring
    xn = rng.integers(-(1 << 62), 1 << 62, (p_ring, nbytes // 8),
                      dtype=np.int64)
    want = exclusive_ref(xn, np.bitwise_xor)
    x = torch.from_numpy(xn).to(dev)
    pl = plan(ScanSpec(kind="exclusive", monoid="xor", algorithm="ring",
                       segments=8), p_ring, nbytes=nbytes)
    rows.append(dict(run_checked(
        f"xor/ring/p={p_ring}", pl, lambda: pl.execute(x),
        lambda out: equal_int(out, want), dev, reps), m=nbytes // 8))
    del x, xn, want

    xn = rng.integers(0, 1000, (p, n_add)).astype(np.int32)
    pre = exclusive_ref(xn, np.add)
    tot = np.broadcast_to(xn.sum(axis=0, dtype=np.int32), xn.shape)
    x = torch.from_numpy(xn).to(dev)
    for algo in ("auto", "fused_doubling"):
        pl = plan(ScanSpec(kind="scan_total", monoid="add", algorithm=algo),
                  p, nbytes=4 * n_add)
        spec = ScanSpec(kind="exclusive", monoid="add", algorithm=algo)
        rows.append(dict(run_checked(
            f"add_total/{algo}", pl,
            lambda spec=spec: scan_with_total(x, spec),
            lambda out: equal_int(out[0], pre) + equal_int(out[1], tot),
            dev, reps), m=n_add))
    del x

    an = rng.uniform(0.9, 1.1, (p, n_affine)).astype(np.float32)
    bn = (0.1 * rng.standard_normal((p, n_affine))).astype(np.float32)
    excl, total = affine_ref(an.astype(np.float64), bn.astype(np.float64))
    ab = (torch.from_numpy(an).to(dev), torch.from_numpy(bn).to(dev))
    for kind, algos in (("exclusive", ("auto", "quartering")),
                        ("scan_total", ("auto", "fused_doubling"))):
        for algo in algos:
            spec = ScanSpec(kind=kind, monoid="affine", algorithm=algo)
            pl = plan(spec, p, nbytes=8 * n_affine)
            if kind == "exclusive":
                check = lambda out: close_affine(out, excl)  # noqa: E731
            else:
                check = lambda out: max(  # noqa: E731
                    close_affine(out[0], excl), close_affine(out[1], total))
            run = ((lambda spec=spec: scan(ab, spec)) if algo == "auto"
                   else (lambda pl=pl: pl.execute(ab)))
            rows.append(dict(run_checked(
                f"affine_{kind}/{algo}", pl, run, check, dev, reps),
                m=n_affine))

    a123 = next(r for r in rows if r["run"] == "xor/123/m=1")
    return {"phase": "table1", "p": p, "runs": rows,
            "alpha_s": a123["median_s"] / a123["rounds"]}


# ---------------------------------------------------------------------------
# serve: a burst through the continuous batcher
# ---------------------------------------------------------------------------


def serve_burst(svc, cfg, rng, dev, n: int) -> float:
    """``n`` requests into the serve phase's service (half MoE dispatch
    counts of ``cfg`` into its scan_total bucket, half compression slots
    into its exclusive one), drained; every answer against numpy.
    Returns the drain's wall seconds."""
    from repro_torch.serve import workloads

    p = svc.p
    reqs = []
    for _ in range(n):
        if rng.random() < 0.5:
            counts = workloads.moe_dispatch_payload(cfg, p, rng, device=dev)
            reqs.append((svc.submit(counts, kind="scan_total", now=svc.now),
                         counts))
        else:
            slots = rng.integers(1, 4096, p).astype(np.int32)
            reqs.append((svc.submit(slots, kind="exclusive", now=svc.now),
                         slots))
    t0 = time.perf_counter()
    svc.drain()
    sync(dev)
    seconds = time.perf_counter() - t0
    for req, xn in reqs:
        if req.status != "done":
            raise AssertionError(f"request {req.rid} {req.status}")
        pre = exclusive_ref(xn, np.add)
        if req.bucket.kind == "scan_total":
            equal_int(req.result[0], pre)
            equal_int(req.result[1], np.broadcast_to(
                xn.sum(axis=0, dtype=np.int32), xn.shape))
        else:
            equal_int(req.result, pre)
    return seconds


def phase_serve(dev, *, p=64, n_req=48, warm_req=16, max_batch=8) -> dict:
    from repro_torch import configs
    from repro_torch.core.schedule import StackedExecutor
    from repro_torch.serve import ScanService, workloads

    cfg = configs.get("qwen2-moe-a2.7b")  # 60 experts padded to 64
    moe = workloads.moe_bucket(cfg, name="moe")
    comp = workloads.compression_bucket(name="compression")
    svc = ScanService(p, [moe, comp], max_batch=max_batch,
                      executor=StackedExecutor(dev))
    svc.warmup()
    rng = np.random.default_rng(3)
    serve_burst(svc, cfg, rng, dev, warm_req)  # first launches, unmeasured
    svc.reset_metrics()
    seconds = serve_burst(svc, cfg, rng, dev, n_req)
    mt = svc.metrics
    line = {"phase": "serve", "p": p, "requests": n_req,
            "max_batch": max_batch, "all_correct": True,
            "post_warmup_compiles": svc.post_warmup_compiles,
            "fused_round_win": mt.fused_round_win,
            "mean_occupancy": mt.mean_occupancy,
            "p50_latency_s": mt.latency_percentile(50),
            "p99_latency_s": mt.latency_percentile(99),
            "drain_wall_s": seconds}
    if svc.post_warmup_compiles != 0:
        raise AssertionError(f"{svc.post_warmup_compiles} plans after "
                             f"warmup")
    if not mt.fused_round_win >= 2:
        raise AssertionError(f"fused round win {mt.fused_round_win} < 2")
    return line


# ---------------------------------------------------------------------------
# ops: the kernels' public entry points
# ---------------------------------------------------------------------------

U32 = 2.0 ** -24  # unit roundoff of float32


def check_left_fold(got, x) -> float:
    """An exclusive float32 sum along axis 0 against the float64 one,
    within recursive summation's a-priori bound (Higham §4.2):
    |err_t| <= γ_t·Σ_{i<t}|x_i|, γ_t = t·u/(1 − t·u).  Returns the
    largest |err| as a share of its bound."""
    x64 = x.double()
    ref = torch.cumsum(x64, 0) - x64
    mass = torch.cumsum(x64.abs(), 0) - x64.abs()
    t = torch.arange(x.shape[0], device=x.device,
                     dtype=torch.float64)[:, None]
    bound_ = t * U32 / (1.0 - t * U32) * mass
    err = (got.double() - ref).abs()
    if bool((err > bound_).any()):
        raise AssertionError("float exscan outside the summation bound")
    share = err / bound_.clamp_min(1e-300)
    return float(share.max())


def affine_ref_cols(a, b, cols, h0=None):
    """float64 recurrence h_t = a_t·h_{t-1} + b_t along axis 0 of the
    (T, D) tensors on the columns ``cols``: (h (T, c), A = ∏a (c,))."""
    an = a[:, cols].double().cpu().numpy()
    bn = b[:, cols].double().cpu().numpy()
    h = np.zeros(len(cols)) if h0 is None else \
        h0[cols].double().cpu().numpy()
    A = np.ones(len(cols))
    hs = np.empty_like(an)
    for t in range(an.shape[0]):
        h = an[t] * h + bn[t]
        A = an[t] * A
        hs[t] = h
    return hs, A


def close_rel(got, want) -> float:
    """|got − want| <= AFFINE_TOL·(1 + |want|) for float64 ``want``."""
    g = got.detach().double().cpu().numpy()
    rel = np.abs(g - want) / (1.0 + np.abs(want))
    worst = float(rel.max())
    if worst > AFFINE_TOL:
        raise AssertionError(f"off the float64 reference by {worst} > "
                             f"{AFFINE_TOL}")
    return worst


def routing_ref(ids: np.ndarray, n_exp: int):
    """Positions and counts of (G, N) expert ids, numpy, exact: a
    stable sort by (group, expert) ranks each entry among its peers."""
    g, n = ids.shape
    key = (ids.astype(np.int64) + n_exp * np.arange(g)[:, None]).ravel()
    order = np.argsort(key, kind="stable")
    first = np.searchsorted(key[order], key[order], side="left")
    pos = np.empty(key.size, np.int64)
    pos[order] = np.arange(key.size) - first
    counts = np.bincount(key, minlength=g * n_exp).reshape(g, n_exp)
    return pos.reshape(g, n).astype(np.int32), counts.astype(np.int32)


def expect_launches(label, before, want: dict, dev) -> dict:
    """The kernels' launch counters moved exactly as ``want`` says (on
    the card; the CPU runs the plain versions and launches nothing)."""
    from repro_torch.kernels import scan_engine as se

    after = se.launch_counts()
    moved = {k: after[k] - before.get(k, 0) for k in after}
    on_card = dev.type == "cuda"
    want = {k: want.get(k, 0) if on_card else 0 for k in moved}
    if moved != want:
        raise AssertionError(f"{label}: kernels launched {moved}, the path "
                             f"predicts {want}")
    return {k: v for k, v in moved.items() if v}


def phase_ops(dev, *, t=4096, d=8192, n=10**6, route=(4096, 4, 64),
              cols=1024) -> dict:
    """Each ``kernels.ops`` entry point once, checked: ``exscan`` of a
    (T, D) float32 array and of a 1-D int64 vector, ``ssm_scan`` from
    h0, ``ssm_chunk_summary`` and ``moe_routing``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import scan_engine as se

    gen = torch.Generator(device=dev).manual_seed(20)
    rng = np.random.default_rng(20)
    rows = []

    def call(name, fn, want, check):
        before = se.launch_counts()
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        seconds = time.perf_counter() - t0
        moved = expect_launches(f"ops.{name}", before, want, dev)
        rows.append({"call": name, "seconds": seconds, "launches": moved,
                     "check": check(out)})

    x = torch.randn((t, d), generator=gen, device=dev)
    call("exscan(float32 (T, D))", lambda: ops.exscan(x, device=dev),
         {"monoid_chunk": 1}, lambda out: check_left_fold(out, x))
    vn = rng.integers(-(1 << 40), 1 << 40, n)
    v = torch.from_numpy(vn).to(dev)
    call("exscan(int64 (n,))", lambda: ops.exscan(v, device=dev),
         {"monoid_chunk": 1},
         lambda out: equal_int(out, np.concatenate(
             [[0], np.cumsum(vn)[:-1]])))
    del x, v
    a = torch.rand((t, d), generator=gen, device=dev).mul_(0.1).add_(0.9)
    b = torch.randn((t, d), generator=gen, device=dev)
    h0 = torch.randn((d,), generator=gen, device=dev)
    pick = np.sort(rng.choice(d, cols, replace=False))
    cidx = torch.from_numpy(pick).to(dev)
    hs, _ = affine_ref_cols(a, b, cidx, h0)
    call("ssm_scan", lambda: ops.ssm_scan(a, b, h0, device=dev),
         {"affine_chunk": 1},
         lambda out: max(close_rel(out[0][:, cidx], hs),
                         close_rel(out[1][cidx], hs[-1])))
    h_free, A = affine_ref_cols(a, b, cidx)
    call("ssm_chunk_summary", lambda: ops.ssm_chunk_summary(a, b, device=dev),
         {"affine_chunk": 1},
         lambda out: max(close_rel(out[0][cidx], A),
                         close_rel(out[1][cidx], h_free[-1])))
    del a, b, h0
    tok, k, n_exp = route
    idn = rng.integers(0, n_exp, (tok, k)).astype(np.int32)
    pos_w, cnt_w = routing_ref(idn.reshape(1, -1), n_exp)
    call("moe_routing", lambda: ops.moe_routing(idn, n_exp, device=dev),
         {"moe_routing": 1},
         lambda out: equal_int(out[0], pos_w.reshape(tok, k))
         + equal_int(out[1], cnt_w[0]))
    return {"phase": "ops", "calls": rows}


# ---------------------------------------------------------------------------
# cp_ssm: context-parallel SSM prefill at Jamba-1.5-Large's mamba width
# ---------------------------------------------------------------------------


def phase_cp_ssm(dev, *, ps=(8, 64), seq=4096, bsz=1,
                 state=(16_384, 16), algos=("auto", "123", "1doubling",
                                            "two_op"),
                 cols=8192, reps=5) -> dict:
    """``cp_ssm_scan`` over p ranks of a (B, S) sequence with Jamba's
    d_inner × d_state state per token; h against a float64 recurrence
    of the whole sequence on a fixed sample of columns."""
    from repro_torch.core.scan_api import plan
    from repro_torch.models.context_parallel import _carry_spec, cp_ssm_scan

    if bsz != 1:
        raise ValueError("the column sample reads one sequence (B = 1)")
    d = int(np.prod(state))
    pick = np.sort(np.random.default_rng(30).choice(d, cols, replace=False))
    cidx = torch.from_numpy(pick).to(dev)
    rows = []
    for p in ps:
        shape = (p, bsz, seq // p) + tuple(state)
        gen = torch.Generator(device=dev).manual_seed(31 + p)
        a = torch.rand(shape, generator=gen, device=dev).mul_(0.1).add_(0.9)
        b = torch.randn(shape, generator=gen, device=dev)
        want, _ = affine_ref_cols(a.reshape(seq, d), b.reshape(seq, d), cidx)
        for algo in algos:
            cspec = _carry_spec(None, algo)
            pl = plan(cspec, p, nbytes=2 * bsz * d * 4)
            rows.append(dict(run_checked(
                f"cp_ssm/p={p}/{algo}", pl,
                lambda cspec=cspec: cp_ssm_scan(a, b, spec=cspec),
                lambda out: close_rel(out.reshape(seq, d)[:, cidx], want),
                dev, reps, path_launches={"affine_chunk": 2}),
                p=p, tokens_per_rank=seq // p))
        del a, b
        torch.cuda.empty_cache()
    return {"phase": "cp_ssm", "model": "jamba-1.5-large-398b",
            "seq": seq, "batch": bsz, "state": list(state),
            "state_floats_per_token": d, "cols_checked": cols,
            "runs": rows}


# ---------------------------------------------------------------------------
# cp_wkv: context-parallel RWKV wkv scan at RWKV6-1.6B's width
# ---------------------------------------------------------------------------


def wkv_ref_cols(w, kv, cols, hd: int):
    """float64 exclusive wkv recurrence S_{t-1} along axis 0 of (T, H·hd)
    decays and (T, H·hd·hd) states, on the state columns ``cols``."""
    a = w[:, cols // hd]
    b = kv[:, cols]
    hs, _ = affine_ref_cols(a, b, torch.arange(len(cols), device=a.device))
    return np.concatenate([np.zeros((1, len(cols))), hs[:-1]])


def phase_cp_wkv(dev, *, ps=(8, 64), seq=4096, bsz=1, heads=32, hd=64,
                 algos=("auto", "123", "1doubling", "two_op"), cols=8192,
                 reps=5) -> dict:
    """``cp_wkv_scan`` over p ranks of one (B = 1, S) sequence at
    RWKV6-1.6B's wkv width (32 heads of 64 × 64 fp32 states): S_prev
    against a float64 recurrence of the whole sequence on a fixed
    sample of columns; also the time of materialising the carry's
    decay to the state's shape, which the affine round kernels need."""
    from repro_torch.core.scan_api import plan
    from repro_torch.models.context_parallel import _carry_spec, cp_wkv_scan

    if bsz != 1:
        raise ValueError("the column sample reads one sequence (B = 1)")
    d = heads * hd * hd
    pick = np.sort(np.random.default_rng(32).choice(d, cols, replace=False))
    cidx = torch.from_numpy(pick).to(dev)
    rows = []
    mat_ms = {}
    for p in ps:
        gen = torch.Generator(device=dev).manual_seed(33 + p)
        w = torch.rand((p, bsz, seq // p, heads, hd, 1), generator=gen,
                       device=dev).mul_(0.1).add_(0.9)
        kv = torch.randn((p, bsz, seq // p, heads, hd, hd), generator=gen,
                         device=dev)
        want = wkv_ref_cols(w.reshape(seq, heads * hd), kv.reshape(seq, d),
                            cidx, hd)
        for algo in algos:
            cspec = _carry_spec(None, algo)
            pl = plan(cspec, p, nbytes=2 * bsz * d * 4)
            rows.append(dict(run_checked(
                f"cp_wkv/p={p}/{algo}", pl,
                lambda cspec=cspec: cp_wkv_scan(w, kv, spec=cspec),
                lambda out: close_rel(out.reshape(seq, d)[:, cidx], want),
                dev, reps, path_launches={"affine_chunk": 2}),
                p=p, tokens_per_rank=seq // p))
        w_tot = w[:, :, 0].reshape(p, bsz, heads * hd, 1)
        mat_ms[str(p)] = device_ms(
            lambda: w_tot.expand(p, bsz, heads * hd, hd).reshape(p, bsz, d),
            dev, 20)
        del w, kv, w_tot
        torch.cuda.empty_cache()
    return {"phase": "cp_wkv", "model": "rwkv6-1.6b", "seq": seq,
            "batch": bsz, "heads": heads, "head_dim": hd,
            "state_floats_per_token": d, "cols_checked": cols,
            "w_tot_materialise_ms": mat_ms, "runs": rows}


# ---------------------------------------------------------------------------
# models: the ported Model serving requests at full width
# ---------------------------------------------------------------------------

# bf16 models: the prefill's cache path must give the full forward's
# last-position logits exactly.  The two run the same layers and kernels
# on the same inputs; attention's cached keys are padded to P + G with
# masked zeros, whose products add exact zeros.  Every sound run on the
# H100 read a max |Δ| of 0.0 for both models (PERF.md), and any slip of
# a kv_len, rope offset or scan state moves bf16 logits by ulps or more.
BF16_ATOL, BF16_RTOL = 0.0, 0.0
# fp32 smoke models, card against CPU: the JAX package's own cross-mesh
# tolerance (tests/test_models.py)
FP32_ATOL, FP32_RTOL = 3e-4, 3e-3


@contextlib.contextmanager
def uncounted():
    """Launches made inside (a kernel held against its plain version)
    leave every wrapper's counts as they were: they are not the path's."""
    from repro_torch.kernels import scan_engine as se

    saved = {name: (fn.launches, dict(fn.launches_by_op))
             for name, fn in se.KERNELS.items()}
    try:
        yield
    finally:
        for name, fn in se.KERNELS.items():  # a wrapper first loaded inside
            fn.launches, fn.launches_by_op = saved.get(name, (0, {}))


def dispatch_on_path(cfg, model, params, prompts, tok, prompt: int) -> list:
    """The first MoE layer's dispatch accounting at the shapes the
    serving path gives it: the ``top_e`` that layer routes in one
    prefill of ``prompts`` and one decode step of ``tok`` is recorded,
    and ``dispatch_slots`` on it (the routing kernel and, over more than
    one group, ``scan_with_total`` on the add round kernels) is held on
    the card against the same call on the CPU (plain versions), bit for
    bit.  Outside the path's counts."""
    from repro_torch.kernels import scan_engine as se
    from repro_torch.models import moe as moe_lib

    real = moe_lib.dispatch_slots
    taken, firsts = [], []

    def record(cfg_, top_e, **kw):
        taken.append(top_e.clone())
        return real(cfg_, top_e, **kw)

    rows = []
    with uncounted():
        cache = model.init_cache(prompts.shape[0], prompt + 1)
        moe_lib.dispatch_slots = record
        try:
            for toks, start in ((prompts, 0), (tok, prompt)):
                taken.clear()
                model.serve_step(params, cache, toks, start, last_only=True)
                if not taken:
                    raise AssertionError(f"{cfg.name}: no MoE layer routed")
                firsts.append(taken[0])
        finally:
            moe_lib.dispatch_slots = real
        del cache
        for top_e in firsts:
            before = se.launch_counts()
            on_card = real(cfg, top_e)
            sync(top_e.device)
            launched = _launches_since(before)
            on_host = real(cfg, top_e.cpu())
            names = ("positions", "offsets", "totals", "keep", "slot")
            for name, a, b in zip(names, on_card, on_host):
                if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
                    raise AssertionError(f"{cfg.name}: dispatch {name} at "
                                         f"{tuple(top_e.shape)} differs "
                                         f"between card and CPU")
            groups = top_e.shape[0]
            if top_e.device.type == "cuda" and (
                    launched.get("moe_routing") != 1
                    or (groups > 1) != bool(launched.get("round_kernels"))):
                raise AssertionError(f"{cfg.name}: dispatch over {groups} "
                                     f"groups launched {launched}")
            rows.append({"top_e": list(top_e.shape), "launches": launched,
                         "bit_equal": True})
    return rows


def _model_launches(cfg, model, batch: int, prompt: int, gen: int,
                    forward: int, loops: int = 1) -> dict:
    """The kernel launches ``loops`` serve_loops of (batch, prompt, gen)
    and ``forward`` full forwards of (batch, prompt) make: one affine_chunk
    per RWKV or Mamba layer in each call with S > 1 (decode runs no
    scan kernel), one routing launch per MoE layer in every call, and
    the round kernels of one scan_with_total over the groups per MoE
    layer where there is more than one group."""
    from repro_torch.core.scan_api import ScanSpec, plan
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import params as PD

    pat = cfg.pattern()
    n_scan = sum(s.kind in ("rwkv", "mamba") for s in pat) * cfg.n_repeats
    n_moe = sum(s.use_moe for s in pat) * cfg.n_repeats
    want = {"affine_chunk": n_scan * (loops + forward),
            "moe_routing": n_moe * (loops * gen + forward)}
    rounds = 0
    calls = [(prompt, loops + forward), (1, loops * (gen - 1))]
    for seq, n in calls:
        groups = moe_lib.moe_groups(cfg, batch, seq, model.mesh).n_groups
        if n_moe and groups > 1 and n:
            spec = cfg.scan_spec
            pl = plan(ScanSpec(kind="scan_total", monoid="add",
                               algorithm=spec.algorithm), groups,
                      nbytes=4 * PD.experts_padded(cfg))
            rounds += n * n_moe * pl.schedule().kernel_launches(True,
                                                                fused=True)
    want["round_kernels"] = rounds
    return {k: v for k, v in want.items() if v}


def _launches_since(before: dict) -> dict:
    from repro_torch.kernels import scan_engine as se

    after = se.launch_counts()
    moved = {k: after[k] - before.get(k, 0) for k in after}
    out = {k: v for k, v in moved.items()
           if v and k not in ROUND_KERNELS}
    rounds = sum(moved[k] for k in ROUND_KERNELS)
    if rounds:
        out["round_kernels"] = rounds
    return out


def serve_full(dev, name: str, ranks, *, batch: int, prompt: int, gen: int,
               seed: int) -> dict:
    """``serve_loop`` on the full config ``name`` in bf16 on the card,
    weights from ``seed``, twice (the first, cold, pays the libraries'
    set-up; the second is reported); the prefill's last-position logits against
    ``Model.forward``'s; launches against the path; busy and idle of
    one prefill and one decode step."""
    from repro_torch import configs
    from repro_torch.kernels import scan_engine as se
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models.model import Model
    from repro_torch.serve.metrics import percentile

    cfg = configs.get(name)
    on_card = dev.type == "cuda"
    torch.cuda.empty_cache()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = Model(cfg, ranks, device=dev)
    params = model.init_params(seed)
    sync(dev)
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated(dev) / 1e9 if on_card else None
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab, (batch, prompt)).astype(np.int32)
    before = se.launch_counts()
    cold = serve_loop(model, params, prompts, gen)  # first use: cuBLAS set-up
    res = serve_loop(model, params, prompts, gen)
    if not np.array_equal(cold.tokens, res.tokens):
        raise AssertionError(f"{name}: two greedy runs differ")
    ptoks = torch.from_numpy(prompts).to(dev)
    logits, _ = model.forward(params, ptoks)
    last = logits[:, -1].clone()
    del logits
    sync(dev)
    launches = _launches_since(before)
    want = _model_launches(cfg, model, batch, prompt, gen, forward=1,
                           loops=2)
    if on_card and launches != want:
        raise AssertionError(f"{name}: kernels launched {launches}, the "
                             f"path predicts {want}")
    got = res.prefill_logits
    if not bool(torch.isfinite(got).all()) or \
            not bool(torch.isfinite(last).all()):
        raise AssertionError(f"{name}: non-finite logits")
    diff = (got.float() - last.float()).abs()
    if bool((diff > BF16_ATOL + BF16_RTOL * last.abs()).any()):
        raise AssertionError(f"{name}: prefill logits off the forward's by "
                             f"{float(diff.max())}")
    toks = res.tokens
    if toks.shape != (batch, gen) or toks.min() < 0 or \
            toks.max() >= cfg.vocab:
        raise AssertionError(f"{name}: tokens {toks.shape} out of range")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
    free, total = torch.cuda.mem_get_info(dev) if on_card else (0, 0)
    # one prefill and one decode step again, traced: the card's busy
    # time (both steps rewrite the same cache entries, so they repeat)
    cache = model.init_cache(batch, prompt + gen)
    prefill_busy = device_busy_s(
        lambda: model.serve_step(params, cache, ptoks, 0, last_only=True),
        dev)
    tok = torch.from_numpy(toks[:, :1].copy()).to(dev)
    decode_busy = device_busy_s(
        lambda: model.decode_step(params, cache, tok, prompt), dev)
    dispatch = (dispatch_on_path(cfg, model, params, ptoks, tok, prompt)
                if cfg.n_experts else None)
    p50 = percentile(res.step_s, 50)
    row = {
        "model": cfg.name, "ranks": list(ranks), "dtype": cfg.dtype,
        "params": cfg.param_count(), "layers": cfg.n_layers,
        "batch": batch, "prompt": prompt, "gen": gen,
        "init_s": init_s, "cold_prefill_ms": cold.prefill_s * 1e3,
        "cold_step_p50_ms": percentile(cold.step_s, 50) * 1e3,
        "prefill_ms": res.prefill_s * 1e3,
        "decode_ms": res.decode_s * 1e3,
        "step_p50_ms": p50 * 1e3,
        "step_p99_ms": percentile(res.step_s, 99) * 1e3,
        "tok_per_s": res.tok_per_s(),
        "prefill_busy_ms": None if prefill_busy is None
        else prefill_busy * 1e3,
        "prefill_idle_share": None if prefill_busy is None
        else 1.0 - prefill_busy / res.prefill_s,
        "decode_busy_ms": None if decode_busy is None else decode_busy * 1e3,
        "decode_idle_share": None if decode_busy is None
        else 1.0 - decode_busy / p50,
        "weights_gb": weights_gb, "peak_allocated_gb": peak_gb,
        "card_used_gb": (total - free) / 1e9 if on_card else None,
        "prefill_vs_forward_max_abs": float(diff.max()),
        "tolerance": {"atol": BF16_ATOL, "rtol": BF16_RTOL},
        "launches": launches, "first_tokens": toks[0][:8].tolist(),
        "dispatch_card_vs_cpu": dispatch, "split_cost": None}
    split = model.split if model.shards.stacked else None
    del model, params, cache, res, cold
    torch.cuda.empty_cache()
    if split is not None:
        row["split_cost"] = {"split": dataclasses.asdict(split),
                             **whole_cost(dev, cfg, ranks, prompts, gen,
                                          seed, toks)}
    return row


def whole_cost(dev, cfg, ranks, prompts, gen: int, seed: int,
               split_tokens) -> dict:
    """What serving the split layers share by share costs the stacked
    model: the same serving with the layers whole (a model loaded as for
    training holds its tree whole, ``Model.load_params``), freed before
    it returns and outside the path's counts: ``serve_loop`` cold, then
    the one read, and the busy time of one prefill and one decode step;
    whether its tokens are the split run's."""
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models.model import Model
    from repro_torch.serve.metrics import percentile

    batch, prompt = prompts.shape
    with uncounted():
        model = Model(cfg, ranks, device=dev)
        params = model.init_params(seed, trainable=True)
        serve_loop(model, params, prompts, gen)  # cold
        res = serve_loop(model, params, prompts, gen)
        cache = model.init_cache(batch, prompt + gen)
        ptoks = torch.from_numpy(prompts).to(dev)
        tok = torch.from_numpy(res.tokens[:, :1].copy()).to(dev)
        busy = [device_busy_s(lambda: model.serve_step(
                    params, cache, ptoks, 0, last_only=True), dev),
                device_busy_s(lambda: model.decode_step(
                    params, cache, tok, prompt), dev)]
    out = {"whole_prefill_ms": res.prefill_s * 1e3,
           "whole_step_p50_ms": percentile(res.step_s, 50) * 1e3,
           "whole_step_p99_ms": percentile(res.step_s, 99) * 1e3,
           "whole_prefill_busy_ms": None if busy[0] is None
           else busy[0] * 1e3,
           "whole_decode_busy_ms": None if busy[1] is None
           else busy[1] * 1e3,
           "tokens_equal_split": bool(np.array_equal(res.tokens,
                                                     split_tokens))}
    del model, params, cache, res
    torch.cuda.empty_cache()
    return out


def smoke_on_card(dev, name: str, ranks, *, batch=2, prompt=16, gen=6,
                  seed=0) -> dict:
    """A ``SMOKE`` config in fp32 at ``ranks``: the same weights and
    prompts on the card (kernels) and on the CPU (plain versions):
    forward logits within the fp32 tolerance, greedy tokens equal.
    Outside the path's counts."""
    from repro_torch import configs
    from repro_torch.kernels import scan_engine as se
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models import params as PD
    from repro_torch.models.model import Model

    cfg = configs.get_smoke(name)
    tree = PD.init_params(cfg, seed, "cpu")
    host = Model(cfg, ranks, device="cpu")
    hp = host.load_params(tree)
    card = Model(cfg, ranks, device=dev)
    cp = card.load_params({"top": {k: v.to(dev) for k, v in
                                   tree["top"].items()},
                           "blocks": tuple({k: v.to(dev) for k, v in b.items()}
                                           for b in tree["blocks"])})
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab, (batch, prompt)).astype(np.int32)
    with uncounted():
        before = se.launch_counts()
        want, _ = host.forward(hp, torch.from_numpy(prompts))
        got, _ = card.forward(cp, torch.from_numpy(prompts).to(dev))
        got = got.cpu()
        diff = (got - want).abs()
        if bool((diff > FP32_ATOL + FP32_RTOL * want.abs()).any()):
            raise AssertionError(f"{name} smoke: card logits off the CPU's "
                                 f"by {float(diff.max())}")
        t_card = serve_loop(card, cp, prompts, gen).tokens
        t_host = serve_loop(host, hp, prompts, gen).tokens
        launched = _launches_since(before)
    if not np.array_equal(t_card, t_host):
        raise AssertionError(f"{name} smoke: greedy tokens differ "
                             f"{t_card} vs {t_host}")
    want_launched = _model_launches(cfg, card, batch, prompt, gen, forward=1)
    if dev.type == "cuda" and launched != want_launched:
        raise AssertionError(f"{name} smoke: card launched {launched}, the "
                             f"path predicts {want_launched}")
    return {"model": cfg.name, "dtype": cfg.dtype, "ranks": list(ranks),
            "params": PD.count_params(cfg), "forward_max_abs": float(
                diff.max()), "tolerance": {"atol": FP32_ATOL,
                                           "rtol": FP32_RTOL},
            "launches": launched, "tokens_equal": True}


def phase_models(dev, *, full=(("rwkv6_1_6b", (1, 1)),
                               ("qwen2_moe_a2_7b", (2, 4))),
                 batch=4, prompt=512, gen=32, seed=0,
                 smoke=(("rwkv6_1_6b", (1, 1)), ("qwen2_moe_a2_7b", (2, 4)),
                        ("jamba_1_5_large_398b", (1, 1)))) -> dict:
    """The ported model stack serving requests: RWKV6-1.6B and
    Qwen1.5-MoE-A2.7B whole, in bf16 (4 requests of 512 prompt tokens
    and 32 generated), each MoE layer's dispatch held card against CPU,
    then the smoke configs card against CPU, Qwen at the full run's
    ranks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = [serve_full(dev, name, ranks, batch=batch, prompt=prompt,
                       gen=gen, seed=seed) for name, ranks in full]
    smokes = [smoke_on_card(dev, name, ranks) for name, ranks in smoke]
    return {"phase": "models", "serve": rows, "smoke": smokes,
            "reduced": "jamba-1.5-large-398b at its SMOKE size only (one "
                       "8-layer unit is ~90 GB of bf16 weights)"}


# ---------------------------------------------------------------------------
# train: the training path, the scans' backward kernel, and checkpoints
# ---------------------------------------------------------------------------


def check_affine_bwd(dev, g: int, t: int, d: int, r: int) -> int:
    """``affine_chunk_bwd`` against its plain version at (g, t, d) with
    the decay broadcast over r columns, exclusive and inclusive, with and
    without h0, with gY and gH and each alone: da, db and dh0 bit for bit
    (the plain version adds da's r columns in the kernel's order)."""
    from repro_torch.kernels import scan_engine as se

    gen = torch.Generator(device=dev).manual_seed(d + r)
    a = torch.rand((g, t, d // r), generator=gen, device=dev) * 0.2 + 0.8
    b = torch.randn((g, t, d), generator=gen, device=dev)
    gy = torch.randn((g, t, d), generator=gen, device=dev)
    gh = torch.randn((g, d), generator=gen, device=dev)
    h0 = torch.randn((g, d), generator=gen, device=dev)
    n = 0
    for exclusive in (False, True):
        for init in (None, h0):
            _, h, _, _ = se.affine_chunk(a, b, h0=init, exclusive=exclusive)
            for gY, gH in ((gy, gh), (gy, None), (None, gh)):
                kw = {"h0": init, "exclusive": exclusive}
                got = se.affine_chunk_bwd(a, gY, gH, h, **kw)
                want = se.affine_chunk_bwd_plain(a, gY, gH, h, **kw)
                sync(dev)
                if not identical(got, want):
                    raise AssertionError(
                        f"affine_chunk_bwd ({g}, {t}, {d}) r = {r} "
                        f"exclusive={exclusive} h0={init is not None}: "
                        f"kernel differs from plain by "
                        f"{max_abs_err(got, want)}")
                n += 1
    return n


def bwd_gradcheck(dev) -> int:
    """``torch.autograd.gradcheck`` through ``AffineChunkFn`` on the card
    in fp64 (its backward the kernel), at r = 1 and 64, both modes."""
    from repro_torch.kernels import scan_engine as se

    n = 0
    for r in (1, 64):
        for exclusive in (False, True):
            gen = torch.Generator(device=dev).manual_seed(r + exclusive)
            kw = {"generator": gen, "device": dev, "dtype": torch.float64}
            args = [torch.rand((2, 5, 2), **kw).requires_grad_(),
                    torch.randn((2, 5, 2 * r), **kw).requires_grad_(),
                    torch.randn((2, 2 * r), **kw).requires_grad_()]
            if not torch.autograd.gradcheck(
                    lambda a, b, h0, e=exclusive: se.affine_chunk_h(
                        a, b, h0, exclusive=e), args):
                raise AssertionError(f"gradcheck failed at r = {r}")
            n += 1
    return n


def bwd_path_times(dev, rate, ops: dict, reps: int) -> dict:
    """``affine_chunk_bwd`` on the operands captured from layer 0 of the
    full-width step: checked against its plain version bit for bit, then
    timed.  Bound: bytes, gY, h and db (G·T·D each) and a and da
    (G·T·D/r each), plus the rows read or written where present; the
    ⊕ work (about 4 flops an element) is far below it."""
    from repro_torch.kernels import scan_engine as se

    a, h = ops["a"], ops["h"]
    kw = {"h0": ops["h0"], "exclusive": ops["exclusive"],
          "want_h0": ops["want_h0"]}
    gY, gH = ops["gY"], ops["gH"]
    got = se.affine_chunk_bwd(a, gY, gH, h, **kw)
    want = se.affine_chunk_bwd_plain(a, gY, gH, h, **kw)
    sync(dev)
    if not identical([x for x in got if x is not None],
                     [x for x in want if x is not None]):
        raise AssertionError(f"affine_chunk_bwd on the path's operands: "
                             f"kernel differs from plain")
    err = max_abs_err([x for x in got if x is not None],
                      [x for x in want if x is not None])
    del got, want
    G, T, Da = (a.shape[0], a.shape[1], a.shape[-1]) if a.dim() == 3 \
        else (1, *a.shape)
    D = h.shape[-1]
    isz = h.element_size()
    rows = (gH is not None) + (ops["want_h0"]) + (
        ops["h0"] is not None and not ops["exclusive"])
    nbytes = isz * (3 * G * T * D + 2 * G * T * Da + rows * G * D)
    bound_ms, bound_by = bound(nbytes, 4 * G * T * D, rate)
    run = lambda: se.affine_chunk_bwd(a, gY, gH, h, **kw)  # noqa: E731
    return {"shape": [G, T, D], "r": D // Da,
            "exclusive": ops["exclusive"], "max_abs_err": err,
            "ms": device_ms(run, dev, reps),
            "plain_ms": device_ms(
                lambda: se.affine_chunk_bwd_plain(a, gY, gH, h, **kw), dev,
                2),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "host_ms": host_ms(run, dev, reps)}


@contextlib.contextmanager
def capture_vjp(into: dict):
    """Inside, every backward of ``AffineChunkFn`` leaves its operands in
    ``into`` (the last call's: in a step's backward, layer 0's).  The
    kernel wrapper and its count are untouched."""
    from repro_torch.kernels import scan_engine as se

    real = se._affine_chunk_vjp

    def record(a, h, h0, gY, gH, exclusive, need):
        into.update(a=a.detach(), h=h.detach(),
                    h0=None if h0 is None else h0.detach(), gY=gY, gH=gH,
                    exclusive=exclusive, want_h0=bool(need[2]))
        return real(a, h, h0, gY, gH, exclusive, need)

    se._affine_chunk_vjp = record
    try:
        yield into
    finally:
        se._affine_chunk_vjp = real


def step_breakdown(fn, dev, top: int = 12) -> list:
    """Device ms by kernel name over one call of ``fn`` (torch.profiler,
    its ``key_averages``), the ``top`` largest, after a warm call; empty
    off the card."""
    if dev.type != "cuda":
        return []
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append({"name": e.key[:90], "calls": e.count,
                         "ms": us / 1e3})
    return sorted(rows, key=lambda r: -r["ms"])[:top]


def _tree_bytes(tree) -> int:
    from repro_torch import _tree

    return sum(t.numel() * t.element_size() for t in _tree.leaves(tree))


def train_full(dev, name: str, ranks, *, batch: int, seq: int,
               steps: int, seed: int) -> tuple[dict, dict]:
    """``launch.train.run`` on the full config ``name`` (bf16, fp32
    moments, remat) for ``steps`` steps: every loss, grad norm and lr
    finite; per-step launches as the path predicts (one forward and one
    remat recompute of ``affine_chunk`` and one ``affine_chunk_bwd`` per
    scanning layer); every parameter slice (each repeat's of a stacked
    leaf) moved from its initial value by the last step.  Step 0 runs at
    lr 0 (the warmup starts there, as the reference's), and a leaf whose
    gradient is still 0 at step 1 (RWKV's ``mu_w``, while ``w_decay``,
    zeros at init, has not moved) is listed, not failed.  Layer 0's
    backward operands of one more step, after the timed ones, are
    captured for the kernel row."""
    from repro_torch import _tree
    from repro_torch.kernels import scan_engine as se
    from repro_torch.launch import train as train_lib
    from repro_torch.serve.metrics import percentile

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    snap: dict = {}
    captured: dict = {}
    changed: list = []

    def on_step(step, params, opt, log):
        if step == 0:  # host copies, so the card's peak stays the path's
            snap["before"] = {k: [p.detach().to("cpu", copy=True) for p in
                                  _tree.leaves(params[k])]
                              for k in ("top", "blocks")}
            snap["state_bytes"] = (_tree_bytes(params),
                                   _tree_bytes((opt.mu, opt.nu)))
        if step in (1, steps - 1):
            moved = []
            for k in ("top", "blocks"):
                for path, p, q in zip(_tree.paths(params[k]),
                                      _tree.leaves(params[k]),
                                      snap["before"][k]):
                    # compared on the host: the hook allocates nothing on
                    # the card between timed steps
                    p = p.detach().to("cpu", copy=True)
                    parts = zip(p, q) if k == "blocks" else [(p, q)]
                    moved.append((f"['{k}']{path}", all(
                        not torch.equal(x, y) for x, y in parts)))
            changed.append(moved)

    args = train_lib.parse_args(
        ["--arch", name, "--steps", str(steps), "--batch", str(batch),
         "--seq", str(seq), "--data-mesh", str(ranks[0]), "--model-mesh",
         str(ranks[1]), "--log-every", "1", "--seed", str(seed),
         "--device", str(dev)])
    before = se.launch_counts()
    res = train_lib.run(args, on_step=on_step)
    sync(dev)
    launched = _launches_since(before)
    peak = torch.cuda.max_memory_allocated(dev)
    free, total = torch.cuda.mem_get_info(dev)
    logs = res.logs
    for log in logs:
        for k in ("loss", "grad_norm", "lr"):
            if not np.isfinite(log[k]):
                raise AssertionError(f"{name} train: {k} {log[k]} at step "
                                     f"{log['step']}")
    cfg = res.model.cfg
    n_scan = sum(s.kind in ("rwkv", "mamba") for s in cfg.pattern()) \
        * cfg.n_repeats
    want = {"affine_chunk": 2 * n_scan * steps,
            "affine_chunk_bwd": n_scan * steps}
    if launched != want:
        raise AssertionError(f"{name} train: launched {launched}, the path "
                             f"predicts {want}")
    stuck = [path for path, ok in changed[-1] if not ok]
    if len(changed) != 2 or stuck:
        raise AssertionError(f"{name} train: parameters unchanged by the "
                             f"last step: {stuck}")
    # more steps, outside the timed ones: the card's busy time (two steps:
    # the marker), one step's device time by kernel, and one step that
    # leaves layer 0's backward operands
    step_no = steps
    batch_t = res.batch_of(step_no)

    def one_step():
        return res.step_fn(res.params, res.opt, batch_t, step_no)

    with uncounted():
        busy = device_busy_s(one_step, dev)
        top = step_breakdown(one_step, dev)
        with capture_vjp(captured):
            one_step()
    warm = [log["seconds"] for log in logs[1:]]
    p50 = percentile(warm, 50)
    weights, moments = snap["state_bytes"]
    row = {
        "model": cfg.name, "ranks": list(ranks), "dtype": cfg.dtype,
        "params": cfg.param_count(), "layers": cfg.n_layers,
        "batch": batch, "seq": seq, "steps": steps, "remat": cfg.remat,
        "cold_step_ms": logs[0]["seconds"] * 1e3,
        "step_p50_ms": p50 * 1e3,
        "step_min_ms": min(warm) * 1e3, "step_max_ms": max(warm) * 1e3,
        "tok_per_s": batch * seq / p50,
        "step_busy_ms": None if busy is None else busy * 1e3,
        "step_idle_share": None if busy is None else 1.0 - busy / p50,
        "step_top_kernels": top,
        "weights_gb": weights / 1e9, "grads_gb": weights / 1e9,
        "optimizer_state_gb": moments / 1e9,
        "peak_allocated_gb": peak / 1e9,
        "card_used_gb": (total - free) / 1e9,
        "losses": [log["loss"] for log in logs],
        "grad_norms": [log["grad_norm"] for log in logs],
        "lrs": [log["lr"] for log in logs],
        "launches_per_step": {k: v / steps for k, v in launched.items()},
        "leaves_changed": len(changed[-1]),
        "unchanged_after_step_1": [p for p, ok in changed[0] if not ok]}
    del res, batch_t
    return row, captured


def smoke_train_on_card(dev, name: str, ranks, *, batch=2, seq=32,
                        lr=1e-3, steps=8, **overrides) -> dict:
    """A SMOKE config in fp32 at ``ranks``, the same weights and batch on
    the card and on the CPU: the loss, every gradient leaf (within atol
    · the leaf's largest entry, rtol) and every parameter after one
    ``make_train_step`` (a first step moves an entry by about ±lr, by
    less, as the gradient's rounding says, where |g| is near it: all but
    1 in 1000 within 1e-3·lr, none beyond 2.2·lr); then
    ``steps`` steps on the card on that one batch lower the loss.
    ``overrides`` go to the config.  Outside the path's counts."""
    from repro_torch import _tree
    from repro_torch import configs
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import params as PD
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw_init

    cfg = configs.get_smoke(name, **overrides)
    batch_np = synthetic_batch(cfg, batch, seq, 0)
    host = PD.init_params(cfg, 0, "cpu")
    runs = []
    with uncounted():
        for d in (torch.device("cpu"), dev):
            model = Model(cfg, ranks, device=d)
            params = model.load_params(_tree.tree_map(
                lambda t: t.detach().to(d, copy=True), host), trainable=True)
            tb = {k: torch.from_numpy(v).to(d) for k, v in batch_np.items()}
            loss, _ = model.loss(params, tb)
            grads = torch.autograd.grad(loss, _tree.leaves(params))
            step = make_train_step(cfg, ranks, lr_peak=lr, warmup=1,
                                   total_steps=100, model=model)
            opt = adamw_init(params)
            params, opt, m = step(params, opt, tb, 1)
            runs.append((float(loss.detach()), [g.cpu() for g in grads],
                         [p.detach().to("cpu", copy=True)
                          for p in _tree.leaves(params)],
                         (step, params, opt, tb)))
        (l_cpu, g_cpu, p_cpu, _), (l_card, g_card, p_card, cont) = runs
        if abs(l_card - l_cpu) > FP32_ATOL + FP32_RTOL * abs(l_cpu):
            raise AssertionError(f"{name} smoke train: loss {l_card} on the "
                                 f"card, {l_cpu} on the CPU")
        g_err = 0.0
        for x, y in zip(g_card, g_cpu):
            scale = float(y.abs().max()) or 1.0
            d = (x - y).abs()
            if bool((d > FP32_ATOL * scale + FP32_RTOL * y.abs()).any()):
                raise AssertionError(f"{name} smoke train: a gradient leaf "
                                     f"off the CPU's by {float(d.max())} "
                                     f"(scale {scale})")
            g_err = max(g_err, float(d.max()) / scale)
        dp = [(x - y).abs() / lr for x, y in zip(p_card, p_cpu)]
        p_err = max(float(d.max()) for d in dp)
        p_off = sum(int((d > 1e-3).sum()) for d in dp)
        p_total = sum(d.numel() for d in dp)
        if p_err > 2.2 or p_off > 1e-3 * p_total:
            raise AssertionError(f"{name} smoke train: parameters off the "
                                 f"CPU's by up to {p_err}·lr, {p_off} of "
                                 f"{p_total} beyond 1e-3·lr")
        step, params, opt, tb = cont
        losses = [l_card]
        for i in range(2, steps + 1):
            params, opt, m = step(params, opt, tb, i)
            losses.append(float(m["loss"]))
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{name} smoke train: {steps} steps on one "
                                 f"batch gave losses {losses}")
    return {"model": cfg.name, "ranks": list(ranks), "dtype": cfg.dtype,
            "sharding_strategy": cfg.sharding_strategy,
            "loss_card": l_card, "loss_cpu": l_cpu,
            "grad_max_err_over_scale": g_err,
            "param_max_err_over_lr": p_err,
            "params_beyond_1e-3_lr": [p_off, p_total],
            "tolerance": {"atol_times_leaf_scale": FP32_ATOL,
                          "rtol": FP32_RTOL, "param_max_over_lr": 2.2,
                          "share_beyond_1e-3_lr": 1e-3},
            "losses_one_batch": losses}


def resume_on_card(dev, name: str = "rwkv6_1_6b") -> dict:
    """The driver's checkpoints on the card (SMOKE ``name``): 6 steps
    with ``--ckpt-dir`` (saved on a thread at step 3, and at 6); the
    driver's restore of step 6 into fresh tensors equal to the state
    the run ended with, bit for bit; then a resume to 8 that runs steps
    6 and 7 only, its step 6 loss beside the loss of the state the
    first run ended with on the batch of step 6.  Outside the path's
    counts."""
    import shutil

    from repro_torch import _tree
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.launch import train as train_lib
    from repro_torch.optim import adamw_init

    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    base = ["--arch", name, "--smoke", "--batch", "2", "--seq", "64",
            "--device", str(dev), "--log-every", "100"]
    try:
        with uncounted():
            first = train_lib.run(train_lib.parse_args(
                base + ["--steps", "6", "--ckpt-dir", str(ckpt),
                        "--ckpt-every", "3"]))
            store = CheckpointStore(str(ckpt))
            if store.latest_step() != 6:
                raise AssertionError(f"latest checkpoint "
                                     f"{store.latest_step()}, not 6")
            fresh = first.model.init_params(1, trainable=True)
            state = {"params": fresh, "opt": adamw_init(fresh)}
            train_lib.restore_into(state, store.restore(6, state))
            saved = {"params": first.params, "opt": first.opt}
            same = [torch.equal(x, y) for x, y in
                    zip(_tree.leaves(state), _tree.leaves(saved))]
            if not all(same):
                raise AssertionError(f"{same.count(False)} leaves restored "
                                     f"unequal to the saved state")
            with torch.no_grad():
                want, _ = first.model.loss(first.params, first.batch_of(6))
            want = float(want)
            resumed = train_lib.run(train_lib.parse_args(
                base + ["--steps", "8", "--ckpt-dir", str(ckpt)]))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if resumed.start_step != 6 or len(resumed.logs) != 2:
        raise AssertionError(f"resume ran {len(resumed.logs)} steps from "
                             f"{resumed.start_step}")
    diff = resumed.losses[0] - want
    if abs(diff) > FP32_ATOL + FP32_RTOL * abs(want):
        raise AssertionError(f"resumed step 6 loss off the saved state's "
                             f"by {diff}")
    return {"model": name, "leaves_restored_bit_equal": len(same),
            "resumed_steps": len(resumed.logs),
            "resumed_step6_loss": resumed.losses[0],
            "saved_state_step6_loss": want, "resumed_minus_saved": diff}


def phase_train(dev, *, full=("rwkv6_1_6b", (1, 1)), batch=4, seq=512,
                steps=6, seed=0, reps=10,
                smoke=(("rwkv6_1_6b", (1, 1)),
                       ("jamba_1_5_large_398b", (1, 1)),
                       ("qwen2_moe_a2_7b", (2, 4)))) -> dict:
    """The training path on the card: (a) ``affine_chunk_bwd`` against
    its plain version (ragged r = 1, broadcast r = 64, and the path's own
    operands, captured from layer 0 of the full-width step) and fp64
    gradcheck through ``AffineChunkFn``; (b) ``launch.train`` on
    RWKV6-1.6B whole in bf16; (c) the smoke configs in fp32, card
    against CPU, and the checkpoint resume."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rate = hbm_rate(torch.cuda.get_device_name(0))
    with uncounted():
        checked = {"r1_ragged": check_affine_bwd(dev, 3, 37, 4099, 1),
                   "r64_broadcast": check_affine_bwd(dev, 2, 33, 8192, 64),
                   "gradcheck_fp64": bwd_gradcheck(dev)}
    row, captured = train_full(dev, full[0], full[1], batch=batch,
                               seq=seq, steps=steps, seed=seed)
    with uncounted():
        timed = bwd_path_times(dev, rate, captured, reps)
    captured.clear()
    torch.cuda.empty_cache()
    smokes = [smoke_train_on_card(dev, name, ranks) for name, ranks in smoke]
    resume = resume_on_card(dev)
    return {"phase": "train", "kernel_checks": checked,
            "affine_chunk_bwd": timed, "full": row, "smoke": smokes,
            "resume": resume,
            "reduced": "6 steps; random weights from seed 0; no "
                       "checkpoint at full width (about 17 GB: 3.36 GB "
                       "of bf16 weights and 13.4 GB of moments)"}


# ---------------------------------------------------------------------------
# moe_dispatch: dispatch accounting at Qwen1.5-MoE-A2.7B's routing
# ---------------------------------------------------------------------------


def dispatch_ref(top: np.ndarray, e_pad: int, cap: int):
    """numpy: positions, offsets, totals, keep and slot of (p, n0, k)
    router choices."""
    p, n0, k = top.shape
    flat = top.reshape(p, n0 * k)
    pos, counts = routing_ref(flat, e_pad)
    offsets = np.cumsum(counts, axis=0, dtype=np.int32) - counts
    totals = np.broadcast_to(counts.sum(axis=0, dtype=np.int32), counts.shape)
    gpos = np.take_along_axis(offsets, flat, axis=1) + pos
    keep = (pos < cap) & (gpos < cap * p)
    slot = np.where(keep, flat * cap + pos, e_pad * cap).astype(np.int32)
    return pos.reshape(p, n0, k), offsets, totals, keep, slot


def phase_moe_dispatch(dev, *, p=64, n0=4096, algos=("auto", "123"),
                       reps=5) -> dict:
    from repro_torch import configs
    from repro_torch.core.scan_api import ScanSpec, plan
    from repro_torch.models import params
    from repro_torch.models.moe import dispatch_slots

    cfg = configs.get("qwen2-moe-a2.7b")
    k, e_pad = cfg.top_k, params.experts_padded(cfg)
    gen = torch.Generator(device=dev).manual_seed(40)
    # k distinct experts of the real ones per token
    top = torch.rand((p, n0, cfg.n_experts), generator=gen, device=dev) \
        .topk(k, dim=-1).indices.to(torch.int32).contiguous()
    cap = max(8, int(cfg.capacity_factor * n0 * k / e_pad))
    want = dispatch_ref(top.cpu().numpy(), e_pad, cap)
    names = ("positions", "offsets", "totals", "keep", "slot")

    def check(out):
        for name, got, w in zip(names, out, want):
            g = got.cpu().numpy()
            if g.shape != w.shape or not np.array_equal(g, w):
                raise AssertionError(f"moe_dispatch {name} differs from "
                                     f"numpy")
        return 0.0

    rows = []
    for algo in algos:
        spec = ScanSpec(kind="exclusive", monoid="add", algorithm=algo)
        pl = plan(ScanSpec(kind="scan_total", monoid="add",
                           algorithm=algo), p, nbytes=4 * e_pad)
        rows.append(run_checked(
            f"moe_dispatch/{algo}", pl,
            lambda spec=spec: dispatch_slots(cfg, top, spec=spec), check,
            dev, reps, path_launches={"moe_routing": 1}))
    return {"phase": "moe_dispatch", "model": cfg.name, "p": p,
            "tokens_per_rank": n0, "top_k": k, "experts": cfg.n_experts,
            "experts_padded": e_pad, "capacity": cap,
            "drop_fraction": float(1.0 - want[3].mean()), "runs": rows}


# ---------------------------------------------------------------------------
# composed: multi-axis scans, each run of rounds folded to its axis
# ---------------------------------------------------------------------------

# The JAX package's default (ICI) constants, src/repro/core/scan_api.py:104-
# 106: under the port's own defaults auto never picks a segmented ring for
# a composed inner stage at (2, 32), so row (d) is planned under these.
REF_ALPHA, REF_BETA, REF_GAMMA = 1e-6, 1.0 / 50e9, 2.0 / 819e9


def fold_copy_ms(x, pl, dev) -> tuple[int, float | None]:
    """(runs over an inner axis, device ms of one fold and unfold of the
    payload on the innermost axis): the copies an inner axis costs."""
    from repro_torch import _tree
    from repro_torch.core import schedule as sch

    sched = pl.schedule()
    sizes = tuple(size for _, size in sched.axes)
    inner = {name for name, _ in sched.axes[1:]}
    runs = sum(1 for run in sch._stage_runs(sched.steps)
               if isinstance(run, list) and run[0].axis in inner)
    k = j = len(sizes) - 1
    flat = _tree.tree_map(lambda t: t.reshape((-1,) + tuple(t.shape[k + 1:])),
                          x)
    ms = device_ms(
        lambda: sch._unfold(sch._fold(flat, sizes, j), sizes, j), dev, 20)
    return runs, ms


def phase_composed(dev, *, grid=(8, 64), ms=(1, 10_000, 100_000),
                   n_add=100_000, affine_grid=(2, 16, 16), n_affine=4096,
                   ring_grid=(2, 32), ring_bytes=6_499_752, reps=5) -> dict:
    """Multi-axis scans through ``scan`` and ``scan_with_total`` on one
    leading rank dimension per axis, checked as table1's rows: (a) a
    hierarchical xor exscan over 8 x 64 (``plan_hierarchical``), (b) a
    scan_total add int32 over ("pod", "data") = (8, 64), (c) a three-axis
    affine exscan over (2, 16, 16), (d) a composed plan whose inner stage
    is a segmented ring, at the smallest payload whose plan has one."""
    from repro_torch.core.scan_api import (
        CostModel, ScanSpec, plan, plan_hierarchical, scan, scan_with_total)

    rng = np.random.default_rng(41)
    rows = []

    def row(label, pl, run, check, x):
        out = run_checked(label, pl, run, check, dev, reps)
        runs, copy_ms = fold_copy_ms(x, pl, dev)
        out.update(sub_plans=[[s.algorithm, s.segments]
                              for s in pl.sub_plans],
                   axes=[list(a) for a in pl.schedule().axes],
                   inner_runs=runs, fold_copy_ms=copy_ms)
        rows.append(out)

    p = int(np.prod(grid))
    spec = ScanSpec(kind="exclusive", monoid="xor", algorithm="auto")
    hspec = spec.over(("proc", "local"))
    for m in ms:
        xn = rng.integers(-(1 << 62), 1 << 62, (p, m), dtype=np.int64)
        want = exclusive_ref(xn, np.bitwise_xor)
        x = torch.from_numpy(xn).to(dev).view(grid + (m,))
        pl = plan_hierarchical(spec, p_inter=grid[0], p_intra=grid[1],
                               nbytes=8 * m)
        row(f"hier_xor/m={m}", pl, lambda x=x: scan(x, hspec),
            lambda out, want=want, m=m: equal_int(out.reshape(p, m), want),
            x)
        del x

    xn = rng.integers(0, 1000, (p, n_add)).astype(np.int32)
    pre = exclusive_ref(xn, np.add)
    tot = np.broadcast_to(xn.sum(axis=0, dtype=np.int32), xn.shape)
    x = torch.from_numpy(xn).to(dev).view(grid + (n_add,))
    tspec = ScanSpec(kind="exclusive", monoid="add",
                     axis_name=("pod", "data"))
    pl = plan(tspec.over(tspec.axis_name, kind="scan_total"), grid,
              nbytes=4 * n_add)
    row("pod_data_add_total", pl, lambda: scan_with_total(x, tspec),
        lambda out: equal_int(out[0].reshape(p, n_add), pre)
        + equal_int(out[1].reshape(p, n_add), tot), x)
    del x

    pa = int(np.prod(affine_grid))
    an = rng.uniform(0.9, 1.1, (pa, n_affine)).astype(np.float32)
    bn = (0.1 * rng.standard_normal((pa, n_affine))).astype(np.float32)
    excl, _ = affine_ref(an.astype(np.float64), bn.astype(np.float64))
    ab = tuple(torch.from_numpy(v).to(dev).view(affine_grid + (n_affine,))
               for v in (an, bn))
    aspec = ScanSpec(kind="exclusive", monoid="affine",
                     axis_name=("x", "y", "z"))
    pl = plan(aspec, affine_grid, nbytes=8 * n_affine)
    row("affine_3axis", pl, lambda: scan(ab, aspec),
        lambda out: close_affine(
            tuple(o.reshape(pa, n_affine) for o in out), excl), ab)
    del ab

    ref = CostModel(alpha=REF_ALPHA, beta=REF_BETA, gamma=REF_GAMMA)
    rspec = ScanSpec(kind="exclusive", monoid="xor", axis_name=("a", "b"))
    pl = plan(rspec, ring_grid, nbytes=ring_bytes, cost_model=ref)
    less = plan(rspec, ring_grid, nbytes=ring_bytes - 8, cost_model=ref)
    inner, below = pl.sub_plans[0], less.sub_plans[0]
    if not (inner.algorithm == "ring" and inner.segments > 1) or (
            below.algorithm == "ring" and below.segments > 1):
        raise AssertionError(f"{ring_bytes} bytes is not the smallest "
                             f"payload with a segmented-ring inner stage")
    pr, n = int(np.prod(ring_grid)), ring_bytes // 8
    xn = rng.integers(-(1 << 62), 1 << 62, (pr, n), dtype=np.int64)
    want = exclusive_ref(xn, np.bitwise_xor)
    x = torch.from_numpy(xn).to(dev).view(ring_grid + (n,))
    row("ring_inner", pl, lambda: scan(x, rspec, cost_model=ref),
        lambda out: equal_int(out.reshape(pr, n), want), x)
    del x
    torch.cuda.empty_cache()
    return {"phase": "composed", "runs": rows}


# ---------------------------------------------------------------------------
# spmd: the scan across processes, one rank a process, ⊕ on the card
# ---------------------------------------------------------------------------


def _probe_child(rank: int, store: str, conn) -> None:
    """One of two processes of a raw gloo group: rank 0 isends a CUDA
    tensor, rank 1 irecvs into one; each reports what happened."""
    import datetime

    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=30))
        t = (torch.arange(4, dtype=torch.int64, device="cuda") + 7 if rank == 0
             else torch.zeros(4, dtype=torch.int64, device="cuda"))
        work = dist.isend(t, 1) if rank == 0 else dist.irecv(t, 0)
        work.wait()
        torch.cuda.synchronize()
        ok = t.cpu().tolist() == [7, 8, 9, 10]
        conn.send("completed" if rank == 0 else "delivered the values"
                  if ok else f"completed with wrong values {t.tolist()}")
    except Exception as e:  # noqa: BLE001 - the probe's answer
        conn.send(f"raised {type(e).__name__}: {str(e)[:160]}")


def gloo_device_p2p() -> dict:
    """What gloo does with a CUDA tensor in isend/irecv, read on the card
    in two processes of their own: each rank's answer, or how it ended."""
    import shutil
    import tempfile

    from repro_torch.dist.launcher import stop_resource_tracker

    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="gloo-probe-")
    pipes = [ctx.Pipe() for _ in range(2)]
    procs = [ctx.Process(target=_probe_child,
                         args=(r, tmp + "/store", pipes[r][1]), daemon=True)
             for r in range(2)]
    for proc in procs:
        proc.start()
    # wait for each answer while its process lives: a rank that gloo
    # aborts (SIGABRT) sends none, and waiting on it out to the deadline
    # cost the script up to 90 s
    deadline = time.monotonic() + 90
    answers = {}
    for r, (here, _) in enumerate(pipes):
        while (not here.poll(0.2) and procs[r].is_alive()
               and time.monotonic() < deadline):
            pass
        answers[f"rank{r}"] = here.recv() if here.poll() else None
    for r, proc in enumerate(procs):
        proc.join(10)
        if proc.is_alive():
            proc.kill()
            proc.join(10)
        if answers[f"rank{r}"] is None:
            answers[f"rank{r}"] = f"no answer (exit code {proc.exitcode})"
    shutil.rmtree(tmp, ignore_errors=True)
    if any(proc.is_alive() for proc in procs):
        raise RuntimeError("a gloo probe process outlived SIGKILL")
    stop_resource_tracker()
    return answers


def _add_launches(into: dict, res) -> None:
    """Sum a pool run's launches (each process's, by wrapper and ⊕)
    into ``into``."""
    for ln in res.launches:
        for wrapper, by_op in ln.items():
            dst = into.setdefault(wrapper, {})
            for op, n in by_op.items():
                dst[op] = dst.get(op, 0) + n


# the pools the script starts more than once for one process count and
# backend, kept open between the phases that share them (a pool takes
# 12-17 s to start on the card), each grid a block size of its processes
# (``WorkerPool.p_intra``): over gloo 8 processes for the spmd phase, the
# autotune phase's dci tier and the blocks phase's 8 × 64, and 4 for the
# blocks phase's 4 × 8, the procs phase's cp scans and its serving rows;
# over NCCL 4 (one a card) for the cards phase's cp scans, dispatch, xor
# cell and serving rows
_SHARED: dict = {}
_SHARED_BEFORE: dict = {}  # the card and host memory before each started


def shared_pool(nprocs: int, dev, backend: str = "gloo", *,
                p_intra: int = 1, timeout: float = 600.0):
    """The open pool of ``nprocs`` processes over ``backend`` (gloo: on
    ``dev``; nccl: one a card), started at its first use (``timeout`` is
    its deadline then), its processes holding ``p_intra`` ranks each from
    this request on; with the seconds it took to start (0 when it was
    open)."""
    from repro_torch.dist import WorkerPool

    key = (nprocs, backend)
    t0 = time.perf_counter()
    pool = _SHARED.get(key)
    if pool is None:
        if dev.type == "cuda":
            _SHARED_BEFORE[key] = memory_now(dev)
        pool = WorkerPool(nprocs, backend=backend, timeout=timeout,
                          **({} if backend == "nccl" else {"device": dev}))
        _SHARED[key] = pool
    pool.p_intra = p_intra
    return pool, time.perf_counter() - t0


def shared_before(nprocs: int, backend: str = "gloo") -> dict | None:
    """The card's and host's memory read before the shared pool of
    ``nprocs`` processes started (``pool_memory``'s ``before``)."""
    return _SHARED_BEFORE.get((nprocs, backend))


def close_shared(nprocs: int | None = None) -> None:
    """Close the shared pools (of ``nprocs`` processes; all of them by
    default); then every child of the script must be gone, as after any
    pool."""
    for key in [k for k in _SHARED if nprocs in (None, k[0])]:
        _SHARED.pop(key).close()
    if not _SHARED:
        check_no_children()


def spmd_run(pool, label, pl, x, check, reps, path_launches) -> dict:
    """One run of ``pl`` across the pool: its first repeat checked (the
    outputs by ``check``, process 0's rounds, ⊕ and all-gathers against
    the plan, every process's round-kernel launches against the IR, the
    summed point-to-point messages and bytes, those that cross processes
    where a process holds a block of ranks, against the schedule's),
    then ``reps`` timed; the children's launches of the checked repeat
    are added to ``path_launches``."""
    from repro_torch import _tree
    from repro_torch.core import monoid as monoid_lib
    from repro_torch.core import schedule as sch

    m = monoid_lib.get(pl.spec.monoid)
    sched = pl.schedule()
    ir = sched.kernel_launches(m.commutative, fused=True)
    res = pool.run(sched, x, monoid=m.name, repeats=1 + reps)
    err = check(res.outputs)
    st = res.stats
    if (st["rounds"], st["op_applications"], st["allgathers"]) != (
            pl.rounds, pl.op_applications, pl.allgathers):
        raise AssertionError(f"spmd {label}: rank 0 measured rounds/⊕/"
                             f"all-gathers {st['rounds']}/"
                             f"{st['op_applications']}/{st['allgathers']}, "
                             f"plan {pl.rounds}/{pl.op_applications}/"
                             f"{pl.allgathers}")
    per_rank = [sum(n for wrapper in ROUND_KERNELS
                    for n in ln.get(wrapper, {}).values())
                for ln in res.launches]
    on_card = pool.device.type == "cuda"
    if per_rank != [ir if on_card else 0] * pool.nprocs or any(
            s["kernel_launches"] != ir for s in res.rank_stats):
        raise AssertionError(f"spmd {label}: processes launched {per_rank} "
                             f"round kernels, the IR predicts {ir} each")
    one = _tree.tree_map(lambda a: torch.from_numpy(np.asarray(a)[0]), x)
    want = sch.expected_messages(sched, one, ranks_per_proc=pool.p_intra)
    tr = res.transport
    if (tr["msgs"], tr["bytes"]) != want:
        raise AssertionError(f"spmd {label}: sent {tr['msgs']} messages of "
                             f"{tr['bytes']} bytes, the schedule {want}")
    _add_launches(path_launches, res)
    times = res.seconds[1:]
    median = statistics.median(times)
    staging = statistics.median(res.staging_seconds[1:])
    return {"run": label, "algorithm": pl.algorithm,
            "segments": pl.segments, "rounds": st["rounds"],
            "ops": st["op_applications"], "allgathers": st["allgathers"],
            "kernel_launches_per_rank": ir, "max_err": err,
            "median_s": median, "min_s": min(times), "max_s": max(times),
            "messages": tr["msgs"], "message_bytes": tr["bytes"],
            "gathers": tr["gathers"], "staged_copies": tr["staged_copies"],
            "staging_ms": staging * 1e3,
            "staging_ms_per_round": (staging * 1e3 / st["rounds"]
                                     if st["rounds"] else None)}


def host_available_bytes() -> int:
    meminfo = dict(line.split(":", 1) for line in
                   Path("/proc/meminfo").read_text().splitlines())
    return int(meminfo["MemAvailable"].split()[0]) * 1024


def pool_memory(res, before: dict) -> dict:
    """Device and host memory of the pool's processes after a run, and
    what the pool takes a process: the card's used bytes and the host's
    available bytes against ``before`` (read before it started)."""
    mem = res.memory
    p = len(mem)
    card = max(r["card_used_bytes"] for r in mem)
    host = host_available_bytes()
    return {"allocated_peak_bytes": [r["allocated_peak_bytes"] for r in mem],
            "resident_bytes": [r["resident_bytes"] for r in mem],
            "staging_buffers": [r["staging_buffers"] for r in mem],
            "card_used_bytes": card, "host_available_bytes": host,
            "card_bytes_per_process": (card - before["card"]) / p,
            "host_bytes_per_process": (before["host"] - host) / p}


def memory_now(dev) -> dict:
    free, total = torch.cuda.mem_get_info(dev)
    return {"card": total - free, "host": host_available_bytes()}


def phase_spmd(dev, *, p=8, p_big=36, ms=(1, 100, 10_000, 100_000),
               ring=8, n_add=100_000, grid=(2, 4), n_affine=4096,
               big_ms=(1, 100), reps=5) -> dict:
    """The exclusive scan across ``p`` processes on one card, one rank
    each, over gloo with every message staged through pinned host
    memory and every ⊕ a round kernel: table1's xor runs, a ring, the
    halving block exscan, a scan_total add int32, an affine exscan over
    ("pod", "data") = ``grid`` (its non-commutative butterfly launches
    the affine exchange), then ``p_big`` processes (the paper's 36-node
    cluster) for 123, 1doubling and two_op at ``big_ms``."""
    from repro_torch.core import schedule as sch
    from repro_torch.core.scan_api import ScanSpec, plan
    from repro_torch.dist import WorkerPool

    rng = np.random.default_rng(43)
    probe = gloo_device_p2p()
    child: dict = {}
    rows = []
    before = memory_now(dev) if dev.type == "cuda" else None
    # kept open for the autotune and blocks phases
    pool, start_s = shared_pool(p, dev, timeout=300)
    try:
        for m in ms:
            xn = rng.integers(-(1 << 62), 1 << 62, (p, m), dtype=np.int64)
            want = exclusive_ref(xn, np.bitwise_xor)
            for algo in ("123", "1doubling", "two_op", "native"):
                pl = plan(ScanSpec(kind="exclusive", monoid="xor",
                                   algorithm=algo), p, nbytes=8 * m)
                rows.append(dict(spmd_run(
                    pool, f"xor/{algo}/m={m}", pl, xn,
                    lambda out, want=want: equal_np(out, want), reps,
                    child), m=m))
        m = ms[-1]
        xn = rng.integers(-(1 << 62), 1 << 62, (p, m), dtype=np.int64)
        want = exclusive_ref(xn, np.bitwise_xor)
        for algo, seg in (("ring", ring), ("halving", 1)):
            pl = plan(ScanSpec(kind="exclusive", monoid="xor", algorithm=algo,
                               segments=seg), p, nbytes=8 * m)
            rows.append(dict(spmd_run(
                pool, f"xor/{algo}/m={m}", pl, xn,
                lambda out: equal_np(out, want), reps, child), m=m))
        xn = rng.integers(0, 1000, (p, n_add)).astype(np.int32)
        pre = exclusive_ref(xn, np.add)
        tot = np.broadcast_to(xn.sum(axis=0, dtype=np.int32), xn.shape)
        pl = plan(ScanSpec(kind="scan_total", monoid="add"), p,
                  nbytes=4 * n_add)
        rows.append(dict(spmd_run(
            pool, "add_total", pl, xn,
            lambda out: equal_np(out[0], pre) + equal_np(out[1], tot), reps,
            child), m=n_add))
        an = rng.uniform(0.9, 1.1, (p, n_affine)).astype(np.float32)
        bn = (0.1 * rng.standard_normal((p, n_affine))).astype(np.float32)
        excl, _ = affine_ref(an.astype(np.float64), bn.astype(np.float64))
        pl = plan(ScanSpec(kind="exclusive", monoid="affine",
                           axis_name=("pod", "data")), grid,
                  nbytes=8 * n_affine)
        if not any(st.kind == "exchange" for st in pl.schedule().steps):
            raise AssertionError(f"affine over {grid} runs no butterfly")
        stacked = sch.StackedExecutor(dev).execute(
            pl.schedule(), tuple(torch.from_numpy(v).to(dev)
                                 for v in (an, bn)), "affine")
        stacked = tuple(t.cpu().numpy() for t in stacked)

        def affine_check(out):
            if not all(np.array_equal(o, s) for o, s in zip(out, stacked)):
                raise AssertionError("spmd affine differs from "
                                     "StackedExecutor on the card")
            return close_affine(tuple(torch.from_numpy(o) for o in out), excl)

        affine = dict(spmd_run(pool, f"affine/{grid}", pl, (an, bn),
                               affine_check, reps, child), m=n_affine)
        affine["axes"] = [list(a) for a in pl.schedule().axes]
        rows.append(affine)
        hop = {"8": pool.measure_hop(8, repeats=50),
               "800000": pool.measure_hop(800_000, repeats=20)}
        mem = before and pool_memory(
            pool.run(pl.schedule(), (an, bn), monoid="affine"), before)
    except BaseException:
        close_shared(p)
        raise

    big_rows = []
    before = memory_now(dev) if dev.type == "cuda" else None
    t0 = time.perf_counter()
    big = WorkerPool(p_big, backend="gloo", device=dev, timeout=300)
    big_start_s = time.perf_counter() - t0
    try:
        for m in big_ms:
            xn = rng.integers(-(1 << 62), 1 << 62, (p_big, m), dtype=np.int64)
            want = exclusive_ref(xn, np.bitwise_xor)
            for algo in ("123", "1doubling", "two_op"):
                pl = plan(ScanSpec(kind="exclusive", monoid="xor",
                                   algorithm=algo), p_big, nbytes=8 * m)
                res = dict(spmd_run(
                    big, f"xor/{algo}/m={m}", pl, xn,
                    lambda out, want=want: equal_np(out, want), reps, child),
                    m=m)
                big_rows.append(res)
        big_mem = before and pool_memory(
            big.run(pl.schedule(), xn, monoid="xor"), before)
    finally:
        big.close()
    a123 = next(r for r in rows if r["run"] == "xor/123/m=1")
    b123 = next(r for r in big_rows if r["run"] == "xor/123/m=1")
    return {"phase": "spmd", "backend": "gloo", "device": str(dev),
            "staged": dev.type == "cuda", "gloo_cuda_p2p": probe,
            "p": p, "start_s": start_s, "runs": rows,
            "alpha_s": a123["median_s"] / a123["rounds"],
            "hop_s": hop, "memory": mem,
            "p_big": p_big, "big_start_s": big_start_s, "big_runs": big_rows,
            "big_alpha_s": b123["median_s"] / b123["rounds"],
            "big_memory": big_mem, "child_launches": child}


# ---------------------------------------------------------------------------
# autotune: the planner's online loop on the card
# ---------------------------------------------------------------------------

# The JAX package's default "ici" constants (src/repro/launch/mesh.py:23-29),
# hand-guessed for a TPU's interconnect: the foreign starting point of the
# autotune phase's part (b).  The card's machine has no jax, so they are
# written here.
JAX_TPU_ICI_DEFAULT = {"alpha": 1e-6, "beta": 1.0 / 50e9,
                       "gamma": 2.0 / 819e9}


def round_launches() -> int:
    from repro_torch.kernels import scan_engine as se

    counts = se.launch_counts()
    return sum(counts.get(k, 0) for k in ROUND_KERNELS)


def ir_counting_executor(dev):
    """``StackedExecutor(dev)`` that adds each executed schedule's IR
    round-kernel launches to ``ir_launches``."""
    from repro_torch.core import monoid as monoid_lib
    from repro_torch.core.schedule import StackedExecutor

    ex = StackedExecutor(dev)
    run = ex.execute
    ex.ir_launches = 0

    def execute(sched, x, m):
        ex.ir_launches += sched.kernel_launches(
            monoid_lib.get(m).commutative, fused=True)
        return run(sched, x, m)

    ex.execute = execute
    return ex


def compile_audit(svc) -> dict:
    """Counts ``svc``'s batches and the plan-cache misses of their
    planning (its warmups and re-warms are outside): a service sharing
    the plan cache with others reads their re-warms in its
    ``post_warmup_compiles``, this count reads only its own batches."""
    from repro_torch.core.scan_api import plan_cache_info

    audit = {"batches": 0, "compiles": 0}
    run = svc._run_batch

    def counted(bucket, batch):
        before = plan_cache_info()["misses"]
        out = run(bucket, batch)
        audit["compiles"] += plan_cache_info()["misses"] - before
        audit["batches"] += 1
        return out

    svc._run_batch = counted
    return audit


def refit_trace(tuner) -> list:
    """Logs every refit that falls due (reason not "not_due"): the
    execution it came at, drift, residuals, plans dropped and the fitted
    constants of each tier at the sample floor (refitted from the same
    reservoirs, which the refit does not change)."""
    from repro_torch.core import tune

    log = []
    refit = tuner.maybe_refit

    def traced(**kw):
        res = refit(**kw)
        if res.reason != "not_due":
            fits = {}
            for tier, n in tuner.reservoir_sizes().items():
                if n >= tuner.gate.min_samples:
                    cm, _ = tune.fit_tier(list(tuner.reservoir(tier)))
                    fits[tier] = {"alpha": cm.alpha, "beta": cm.beta,
                                  "gamma": cm.gamma}
            log.append({"execution": tuner.executions, "reason": res.reason,
                        "drift": dict(res.drift),
                        "residuals": dict(res.residuals),
                        "plans_dropped": res.plans_dropped, "fit": fits})
        return res

    tuner.maybe_refit = traced
    return log


def autotune_serve(dev, serve_line, *, p=64, warm_req=16, n_req=48,
                   max_batch=8, burst=4, due=3) -> dict:
    """(a) The serve phase's service with an ``AutoTuner`` (capacity 128,
    a refit every 16 batches) over the port's default profile: 16 warm
    requests, 48 measured, then bursts of ``burst`` until ``due`` refits
    have fallen due."""
    from repro_torch import configs
    from repro_torch.core.autotune import AutoTuner
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serve import ScanService, workloads

    cfg = configs.get("qwen2-moe-a2.7b")
    ex = ir_counting_executor(dev)
    svc = ScanService(p, [workloads.moe_bucket(cfg, name="moe"),
                          workloads.compression_bucket(name="compression")],
                      max_batch=max_batch, executor=ex)
    tuner = AutoTuner(mesh_lib.DEFAULT_PROFILE, capacity=128, refit_every=16,
                      mesh_fingerprint="serve-online")
    svc.attach_autotuner(tuner)
    svc.warmup()
    audit = compile_audit(svc)
    log = refit_trace(tuner)
    rng = np.random.default_rng(3)
    launched0, ir0 = round_launches(), ex.ir_launches
    serve_burst(svc, cfg, rng, dev, warm_req)
    warm_batches = tuner.executions
    svc.reset_metrics()
    drain_s = serve_burst(svc, cfg, rng, dev, n_req)
    mt = svc.metrics
    p50, p99 = mt.latency_percentile(50), mt.latency_percentile(99)
    extra = 0
    while len(log) < due:
        serve_burst(svc, cfg, rng, dev, burst)
        extra += burst
        if extra > 4096:
            raise AssertionError(f"only {len(log)} refits fell due")
    sync(dev)
    launched, ir = round_launches() - launched0, ex.ir_launches - ir0
    if launched != (ir if dev.type == "cuda" else 0):
        raise AssertionError(f"autotune serve: round kernels launched "
                             f"{launched}, the IR {ir}")
    if tuner.executions != audit["batches"] - tuner.rejected:
        raise AssertionError(f"autotune serve: {tuner.executions} samples of "
                             f"{audit['batches']} batches, {tuner.rejected} "
                             f"rejected")
    if audit["compiles"] or svc.post_warmup_compiles:
        raise AssertionError(f"autotune serve: {audit['compiles']} plans in "
                             f"batches, {svc.post_warmup_compiles} after "
                             f"warmup")
    samples = list(tuner.reservoir(tuner.profile.default_tier))
    return {"p": p, "max_batch": max_batch, "warm_requests": warm_req,
            "requests": n_req, "extra_requests": extra,
            "batches": audit["batches"], "samples": tuner.executions,
            "rejected": tuner.rejected, "refits": tuner.refits,
            "installs": tuner.installs, "plans_dropped": tuner.plans_dropped,
            "post_warmup_compiles": svc.post_warmup_compiles,
            "batch_compiles": audit["compiles"],
            "round_launches": launched, "ir_launches": ir,
            "history": [r.reason for r in tuner.history
                        if r.reason != "not_due"],
            "refit_log": log, "last_fit": log[-1]["fit"],
            "sample_ms": [x.seconds * 1e3 for x in samples],
            "warm_batches": warm_batches,
            "fit_after_warm": fit_row(samples[warm_batches:]),
            "p50_latency_s": p50, "p99_latency_s": p99, "drain_wall_s": drain_s,
            "serve_phase_p50_s": serve_line and serve_line["p50_latency_s"],
            "serve_phase_p99_s": serve_line and serve_line["p99_latency_s"],
            "all_correct": True}


def fit_row(samples) -> dict:
    """``tune.fit_tier`` of ``samples``: α, β, γ and the residual."""
    from repro_torch.core import tune

    cm, resid = tune.fit_tier(samples)
    return {"samples": len(samples), "alpha": cm.alpha, "beta": cm.beta,
            "gamma": cm.gamma, "residual": resid}


def table1_fastest(dev, table1, p: int, m: int) -> dict:
    """{algorithm: ms} of table1's xor rows at ``m`` (timed here with
    ``pinned_ms`` when the table1 phase did not run)."""
    from repro_torch.core.scan_api import ScanSpec

    if table1 is not None:
        return fastest(table1["runs"], lambda r: (
            r["run"].split("/")[1] if r["run"].startswith("xor/")
            and r.get("m") == m and "auto" not in r["run"] else None))
    spec = ScanSpec(kind="exclusive", monoid="xor")
    x = torch.randint(-(1 << 62), 1 << 62, (p, m), device=dev)
    out = {a: pinned_ms(spec, a, p, x, dev)
           for a in ("123", "1doubling", "two_op", "native")}
    del x
    return out


def autotune_foreign(dev, table1, *, ps=(8, 64, 512),
                     ms=(1, 100, 10_000, 100_000), ks=(1, 2, 4),
                     batches=240, max_batch=8,
                     table1_cells=(512, (1, 100, 10_000, 100_000))) -> dict:
    """(b) The loop started from the JAX package's TPU constants: one
    ``AutoTuner`` (capacity 128, a refit every 16 batches) attached to
    three services (p in ``ps``, exclusive add int64 buckets of ``ms``
    elements, 8 B to 800 KB), ``batches`` batches of k in ``ks``
    requests over the cycle of (p, m) cells, each answer against numpy;
    then, where it installed, auto's picks at table1's cells."""
    from repro_torch.core.autotune import AutoTuner
    from repro_torch.core.scan_api import CostModel, CostProfile, ScanSpec, plan
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serve import Bucket, ScanService

    foreign = CostProfile(
        tiers=(("ici", CostModel(**JAX_TPU_ICI_DEFAULT)),), source="default",
        default_tier="ici", mesh_fingerprint="jax-package-tpu-default")
    tuner = AutoTuner(foreign, capacity=128, refit_every=16,
                      mesh_fingerprint="serve-online-from-tpu")
    ex = ir_counting_executor(dev)
    services, audits = {}, {}
    for p in ps:
        svc = ScanService(p, [Bucket(kind="exclusive", monoid="add",
                                     shape=(m,), dtype=np.int64)
                              for m in ms],
                          max_batch=max_batch, executor=ex, cost_model=foreign)
        svc.attach_autotuner(tuner)
        svc.warmup()
        services[p], audits[p] = svc, compile_audit(svc)
    log = refit_trace(tuner)
    rng = np.random.default_rng(21)
    cells = [(p, m) for p in ps for m in ms]
    data = {}
    for p, m in cells:
        xn = rng.integers(0, 1 << 40, (p, m), dtype=np.int64)
        data[p, m] = (torch.from_numpy(xn).to(dev),
                      torch.from_numpy(exclusive_ref(xn, np.add)).to(dev))
        del xn
    launched0, ir0 = round_launches(), ex.ir_launches
    samples, seen = [], set()
    t0 = time.perf_counter()
    for n in range(batches):
        p, m = cells[n % len(cells)]
        k = ks[(n // len(cells)) % len(ks)]
        x, want = data[p, m]
        svc = services[p]
        reqs = [svc.submit(x) for _ in range(k)]
        svc.tick()  # one batch: k requests of one bucket
        samples.append((tuner.reservoir("ici")[-1], (p, m, k) not in seen))
        seen.add((p, m, k))
        for req in reqs:
            if req.status != "done" or not torch.equal(req.result, want):
                raise AssertionError(f"autotune foreign: request {req.rid} "
                                     f"at p={p}, m={m} {req.status}, wrong")
    sync(dev)
    seconds = time.perf_counter() - t0
    del data
    launched, ir = round_launches() - launched0, ex.ir_launches - ir0
    n_batches = sum(a["batches"] for a in audits.values())
    if launched != (ir if dev.type == "cuda" else 0):
        raise AssertionError(f"autotune foreign: round kernels launched "
                             f"{launched}, the IR {ir}")
    if n_batches != batches or \
            tuner.executions != n_batches - tuner.rejected:
        raise AssertionError(f"autotune foreign: {tuner.executions} samples "
                             f"of {n_batches} batches, {tuner.rejected} "
                             f"rejected")
    compiles = {p: a["compiles"] for p, a in audits.items()}
    if any(compiles.values()):
        raise AssertionError(f"autotune foreign: plans in batches "
                             f"{compiles}")
    for r in tuner.history:
        if r.installed and max(dict(r.residuals).values()) > \
                tuner.gate.max_residual:
            raise AssertionError(f"autotune foreign: installed at residual "
                                 f"{dict(r.residuals)}")
    spec = ScanSpec(kind="exclusive", monoid="xor", algorithm="auto")
    last_fit = log[-1]["fit"]["ici"] if log and "ici" in log[-1]["fit"] \
        else None
    picks = []
    t1_p, t1_ms = table1_cells
    for m in t1_ms:
        measured = table1_fastest(dev, table1, t1_p, m)
        row = {"cell": f"table1 p={t1_p} m={m}",
               "auto_foreign": plan(spec, t1_p, nbytes=8 * m,
                                    cost_model=foreign).algorithm,
               "auto_port_default": plan(spec, t1_p, nbytes=8 * m,
                                         cost_model=mesh_lib.DEFAULT_PROFILE
                                         ).algorithm,
               "measured_fastest": min(measured, key=measured.get),
               "measured_ms": measured}
        if tuner.installs:
            row["auto_installed"] = plan(spec, t1_p, nbytes=8 * m,
                                         cost_model=tuner.profile).algorithm
        if last_fit is not None:
            row["auto_last_fit"] = plan(spec, t1_p, nbytes=8 * m,
                                        cost_model=CostModel(**last_fit)
                                        ).algorithm
        picks.append(row)
    return {"ps": list(ps), "ms": list(ms), "ks": list(ks),
            "start": {"tier": "ici", **JAX_TPU_ICI_DEFAULT,
                      "source": "the JAX package's default (TPU ICI)"},
            "batches": n_batches, "samples": tuner.executions,
            "rejected": tuner.rejected, "seconds": seconds,
            "refits": tuner.refits, "installs": tuner.installs,
            "plans_dropped": tuner.plans_dropped,
            "history": [r.reason for r in tuner.history
                        if r.reason != "not_due"],
            "refit_log": log,
            "sample_ms": [x.seconds * 1e3 for x, _ in samples],
            "first_of_cell": [first for _, first in samples],
            "fit_without_firsts": fit_row([x for x, first in samples
                                           if not first]),
            "fit_last_window": fit_row([x for x, _ in samples[-128:]]),
            "batch_compiles": compiles,
            "post_warmup_compiles": {p: s.post_warmup_compiles
                                     for p, s in services.items()},
            "round_launches": launched, "ir_launches": ir,
            "final_profile": {n: {"alpha": cm.alpha, "beta": cm.beta,
                                  "gamma": cm.gamma}
                              for n, cm in tuner.profile.tiers},
            "picks": picks, "all_correct": True}


def autotune_train(dev, *, steps=8, every=2) -> dict:
    """(c) ``launch.train.run --autotune --autotune-every 2`` on the SMOKE
    rwkv6, ranks (1, 1), ``steps`` steps; the same run without
    ``--autotune`` (outside the path's counts) must give the same losses
    bit for bit."""
    from repro_torch.launch import train as train_lib

    base = ["--arch", "rwkv6_1_6b", "--smoke", "--steps", str(steps),
            "--batch", "2", "--seq", "32", "--device", str(dev),
            "--log-every", "100"]
    with uncounted():
        plain = train_lib.run(train_lib.parse_args(base))
    tuned = train_lib.run(train_lib.parse_args(
        base + ["--autotune", "--autotune-every", str(every)]))
    tuner = tuned.tuner
    probes = -(-steps // every)
    if tuner.executions != probes or \
            tuner.reservoir_sizes() != {"stacked": probes}:
        raise AssertionError(f"autotune train: {tuner.executions} probes, "
                             f"reservoirs {tuner.reservoir_sizes()}")
    if tuned.losses != plain.losses:
        raise AssertionError(f"autotune train: losses {tuned.losses} with "
                             f"probes, {plain.losses} without")
    samples = list(tuner.reservoir("stacked"))
    return {"model": tuned.model.cfg.name, "steps": steps, "every": every,
            "probes": tuner.executions,
            "probe": {"algorithm": samples[0].algorithm, "p": samples[0].p,
                      "nbytes": samples[0].nbytes},
            "probe_ms": [s.seconds * 1e3 for s in samples],
            "step_ms": [log["seconds"] * 1e3 for log in tuned.logs],
            "step_ms_without": [log["seconds"] * 1e3 for log in plain.logs],
            "losses": tuned.losses, "losses_equal": True,
            "history": [r.reason for r in tuner.history]}


def _factoring(pl) -> list:
    """[p_inter, p_intra] of a plan of ``replan_hierarchical``."""
    if pl.sub_plans:
        return [pl.sub_plans[-1].p, pl.sub_plans[0].p]
    return [1, pl.p] if pl.spec.axis_name == "local" else [pl.p, 1]


def autotune_dci(dev, *, p=8, m=8192, runs=5, replan_ps=(8, 36),
                 replan_ms=(8, 8192, 1_048_576)) -> dict:
    """(d) The dci tier on the card: a ``WorkerPool`` of ``p`` processes
    on the card over gloo (staged), ``measure_hops``, ``calibrate_dist``
    (saved into a temporary store), ``runs`` runs of 123 at ``m`` bytes
    through ``observe_dist``, and ``replan_hierarchical`` under the
    fitted profile, with and without one rank at 50× the median."""
    import shutil
    import tempfile

    from repro_torch.core import tune
    from repro_torch.core.autotune import (
        AutoTuner, StragglerDetector, replan_hierarchical)
    from repro_torch.core.scan_api import ScanSpec, plan

    rng = np.random.default_rng(44)
    child: dict = {}
    # the spmd phase's pool where it ran before (0 s to start), kept open
    # for the blocks phase
    pool, start_s = shared_pool(p, dev, timeout=300)
    try:
        hops = tune.measure_hops(pool)
        t0 = time.perf_counter()
        prof = tune.calibrate_dist(pool)
        calibrate_s = time.perf_counter() - t0
        store = tempfile.mkdtemp(prefix="repro-torch-dci-")
        try:
            saved = os.path.basename(tune.save_profile(prof, store))
            if tune.load_profile(prof.mesh_fingerprint, store) != prof:
                raise AssertionError("the dci profile did not load back")
        finally:
            shutil.rmtree(store, ignore_errors=True)
        tuner = AutoTuner(prof, install=False)
        pl = plan(ScanSpec(kind="exclusive", monoid="add", algorithm="123"),
                  p, nbytes=m)
        sched = pl.schedule()
        ir = sched.kernel_launches(True, fused=True)
        reports, run_s = [], []
        for _ in range(runs):
            xn = rng.integers(0, 1 << 30, (p, m // 8), dtype=np.int64)
            res = pool.run(sched, xn, monoid="add", repeats=3)
            equal_np(res.outputs, exclusive_ref(xn, np.add))
            per_rank = [sum(n for w in ROUND_KERNELS
                            for n in ln.get(w, {}).values())
                        for ln in res.launches]
            if per_rank != [ir if dev.type == "cuda" else 0] * p:
                raise AssertionError(f"autotune dci: processes launched "
                                     f"{per_rank}, the IR {ir} each")
            for ln in res.launches:
                for wrapper, by_op in ln.items():
                    into = child.setdefault(wrapper, {})
                    for op, n in by_op.items():
                        into[op] = into.get(op, 0) + n
            rep = tuner.observe_dist(res, sched, m)
            run_s.append(res.seconds)
            reports.append({"median_s": rep.median,
                            "slow_ranks": list(rep.slow_ranks),
                            "inflation": rep.inflation})
    except BaseException:
        close_shared(p)
        raise

    last = tuner.stragglers.report()
    spec = ScanSpec(kind="exclusive", monoid="add")
    replans = []
    for rp in replan_ps:
        synthetic = StragglerDetector(threshold=1.5, smoothing=1.0).observe(
            [1.0] * (rp - 1) + [50.0])
        for rm in replan_ms:
            for report in (None, synthetic):
                best = replan_hierarchical(spec, rp, nbytes=rm,
                                           cost_model=prof, report=report)
                replans.append({"p": rp, "nbytes": rm,
                                "straggler_x50": report is not None,
                                "factoring": _factoring(best),
                                "algorithm": best.algorithm,
                                "predicted_s": best.cost})
    dci = prof.model("dci")
    return {"p": p, "backend": "gloo", "staged": True, "start_s": start_s,
            "hops": hops, "calibrate_s": calibrate_s,
            "fingerprint": prof.mesh_fingerprint, "saved_as": saved,
            "dci": {"alpha": dci.alpha, "beta": dci.beta, "gamma": dci.gamma},
            "residual": dict(prof.residuals)["dci"],
            "tiers": [n for n, _ in prof.tiers],
            "axis_tiers": [list(a) for a in prof.axis_tiers],
            "runs": {"algorithm": "123", "nbytes": m, "repeats": 3,
                     "seconds": run_s, "reports": reports},
            "straggler_report": {"rank_seconds": list(last.rank_seconds),
                                 "median": last.median,
                                 "slow_ranks": list(last.slow_ranks),
                                 "inflation": last.inflation},
            "dci_samples": tuner.reservoir_sizes().get("dci", 0),
            "replan": replans,
            "child_launches": child}


def phase_autotune(dev, earlier=None) -> dict:
    """The planner's online loop on the card: (a) the serve phase's
    service with a tuner attached, (b) the loop started from the JAX
    package's TPU constants, (c) ``launch.train --autotune``, (d) the dci
    tier across 8 processes.  ``earlier`` holds the lines of the phases
    run before it (table1's rows and serve's latencies are printed
    beside this phase's where they ran).  The installed profile and the
    plan cache are reset after (a)-(c)."""
    from repro_torch.core import scan_api
    from repro_torch.launch import mesh as mesh_lib

    def reset():
        mesh_lib.install_profile(None)
        scan_api.plan_cache_clear()

    earlier = earlier or {}
    try:
        serve = autotune_serve(dev, earlier.get("serve"))
        reset()
        foreign = autotune_foreign(dev, earlier.get("table1"))
        reset()
        train = autotune_train(dev)
    finally:
        reset()
    dci = autotune_dci(dev)
    return {"phase": "autotune", "serve": serve, "foreign": foreign,
            "train": train, "dci": dci,
            "child_launches": dci.pop("child_launches")}


# ---------------------------------------------------------------------------
# blocks: a block of ranks in each process (the hierarchical exscan across
# processes), ⊕ on the card
# ---------------------------------------------------------------------------

def blocks_stacked(dev, pl, xn, reps: int) -> tuple:
    """The stacked executor's output of ``pl`` on ``xn`` and its wall
    seconds (``reps`` calls), kept out of the launch counts: the pool's
    yardstick in the same run."""
    from repro_torch.core import schedule as sch

    x = torch.from_numpy(xn).to(dev)
    ex = sch.StackedExecutor(dev)

    def run():
        return ex.execute(pl.schedule(), x, pl.spec.monoid)

    with uncounted():
        out = run().cpu().numpy()
        times = wall_s(run, dev, reps)
    del x
    return out, times


def blocks_row(pool, label, pl, xn, want, reps, child) -> dict:
    """One xor run of ``pl`` across a block pool, checked by
    :func:`spmd_run` and bit for bit against numpy and the stacked
    executor, with the stacked wall times beside its own."""
    stacked, times = blocks_stacked(pool.device, pl, xn, reps)
    equal_np(stacked, want)

    def check(out):
        if not np.array_equal(out, stacked):
            raise AssertionError(f"blocks {label} differs from "
                                 f"StackedExecutor on the card")
        return equal_np(out, want)

    row = spmd_run(pool, label, pl, xn, check, reps, child)
    row.update(m=xn.shape[1], stacked_median_s=statistics.median(times),
               stacked_min_s=min(times), stacked_max_s=max(times),
               sub_plans=[[s.algorithm, s.segments] for s in pl.sub_plans])
    return row


def phase_blocks(dev, *, grid=(8, 64), ms=(1, 100_000), single=(4, 8),
                 n_single=100_000, ring=8, reps=5, earlier=None) -> dict:
    """Blocks of ranks in each process on one card over gloo (staged):
    (a) composed (a)'s hierarchical xor exscan over (proc, local) =
    ``grid`` as ``grid[0]`` processes of ``grid[1]`` ranks, at ``ms``
    int64; (b) the ported dist bench's two configs with its ``--check``
    gates; (c) single-axis 123, 1doubling and a ring (S = ``ring``) over
    ``single`` = 4 processes × 8 ranks at ``n_single`` int64, where rounds
    mix rows read in place with rows from the previous process; (d)
    ``calibrate_dist`` over that pool.  ``earlier`` holds the lines of the
    phases run before it (composed (a)'s and autotune (d)'s numbers are
    printed beside this phase's where they ran)."""
    from repro_torch.benchmarks import dist_bench
    from repro_torch.core import tune
    from repro_torch.core.scan_api import ScanSpec, plan, plan_hierarchical

    earlier = earlier or {}
    rng = np.random.default_rng(47)
    child: dict = {}
    nprocs, P = grid
    p = nprocs * P
    spec = ScanSpec(kind="exclusive", monoid="xor")
    rows = []
    # the spmd and autotune phases' 8 processes where they ran before
    before = memory_now(dev)
    pool, start_s = shared_pool(nprocs, dev, p_intra=P, timeout=300)
    before = shared_before(nprocs) or before
    try:
        for m in ms:
            xn = rng.integers(-(1 << 62), 1 << 62, (p, m), dtype=np.int64)
            pl = plan_hierarchical(spec, p_inter=nprocs, p_intra=P,
                                   nbytes=8 * m)
            rows.append(blocks_row(pool, f"hier_xor/m={m}", pl, xn,
                                   exclusive_ref(xn, np.bitwise_xor), reps,
                                   child))
        mem = pool_memory(pool.run(pl.schedule(), xn, monoid="xor"), before)
    finally:
        close_shared(nprocs)
    composed = {r["run"]: r for r in
                earlier.get("composed", {}).get("runs", [])}
    for r in rows:
        c = composed.get(r["run"])
        r["composed_stacked"] = None if c is None else {
            k: c[k] for k in ("median_s", "min_s", "max_s", "device_busy_s")}

    bench = []
    for cfg in dist_bench.CONFIGS:
        with uncounted():  # its stacked yardstick runs in this process
            row = dist_bench.run_config(cfg, device=dev, timeout=300)
        if not row["ok"]:
            raise AssertionError(f"blocks dist bench {cfg}: {row}")
        bench.append(row)

    nprocs, P = single
    p = nprocs * P
    single_rows = []
    # kept open for the procs phase's cp scans and serving rows
    pool, _ = shared_pool(nprocs, dev, p_intra=P, timeout=600)
    try:
        xn = rng.integers(-(1 << 62), 1 << 62, (p, n_single), dtype=np.int64)
        want = exclusive_ref(xn, np.bitwise_xor)
        for algo, seg in (("123", 1), ("1doubling", 1), ("ring", ring)):
            pl = plan(ScanSpec(kind="exclusive", monoid="xor", algorithm=algo,
                               segments=seg), p, nbytes=8 * n_single)
            single_rows.append(blocks_row(
                pool, f"xor/{algo}/m={n_single}", pl, xn, want, reps, child))
        t0 = time.perf_counter()
        prof = tune.calibrate_dist(pool)
        calibrate_s = time.perf_counter() - t0
    except BaseException:
        close_shared(nprocs)
        raise
    dci = prof.model("dci")
    one_rank = earlier.get("autotune", {}).get("dci")
    return {"phase": "blocks", "backend": "gloo", "device": str(dev),
            "staged": dev.type == "cuda", "grid": list(grid),
            "start_s": start_s, "runs": rows, "memory": mem,
            "dist_bench": bench, "single": list(single),
            "single_runs": single_rows,
            "calibrate": {
                "fingerprint": prof.mesh_fingerprint,
                "calibrate_s": calibrate_s,
                "dci": {"alpha": dci.alpha, "beta": dci.beta,
                        "gamma": dci.gamma},
                "residual": dict(prof.residuals)["dci"],
                "one_rank_a_process": one_rank and {
                    "dci": one_rank["dci"], "residual": one_rank["residual"],
                    "fingerprint": one_rank["fingerprint"]}},
            "child_launches": child}


# ---------------------------------------------------------------------------
# procs / cards: the scan's consumers over ranks held by processes
# ---------------------------------------------------------------------------

JAMBA_STATE = (16_384, 16)  # d_inner x d_state floats a token
RWKV_HEADS, RWKV_HD = 32, 64
CP_SEQ, CP_P = 4096, 8
CP_ALGOS = ("auto", "123", "1doubling", "two_op")
QWEN = "qwen2-moe-a2.7b"
POOL_TIMEOUT_S = 120  # a request of these pools: a hang ends there


def cp_draw(kind: str, p: int, grad: bool):
    """The cp scan ``kind``'s inputs at its model's width, B = 1, S =
    4096 over p ranks, drawn rank by rank on each device
    (``launcher.Draw``): decays in [0.99, 1), so that a shard's carry
    reaches the next one's gradients, and with ``grad`` the gradient gY
    of the output."""
    from repro_torch.dist.launcher import Draw

    n = CP_SEQ // p
    if kind == "ssm":
        shapes = ((1, n) + JAMBA_STATE,) * 2
    else:
        shapes = ((1, n, RWKV_HEADS, RWKV_HD, 1),
                  (1, n, RWKV_HEADS, RWKV_HD, RWKV_HD))
    kinds = (("uniform", 0.99, 1.0), ("normal",))
    if grad:
        shapes, kinds = shapes + (shapes[1],), kinds + (("normal",),)
    return Draw(shapes=shapes, kinds=kinds, seed=50 if kind == "ssm" else 60)


def cp_fn(kind: str):
    from repro_torch.models import context_parallel as cpl

    return cpl.cp_ssm_scan if kind == "ssm" else cpl.cp_wkv_scan


def cp_stacked(dev, kind: str, algos, reps: int) -> dict:
    """The stacked port on every rank of :func:`cp_draw` on ``dev``, kept
    out of the launch counts: the digests of the drawn inputs, and per
    algorithm the digests of h (the forward) and of (h, da, db) (forward
    and backward) with the wall seconds of each; the card's tensors are
    freed before it returns."""
    from repro_torch.dist.launcher import digest
    from repro_torch.models import context_parallel as cpl

    fn = cp_fn(kind)
    out: dict = {}
    with uncounted():
        a, b, gy = cp_draw(kind, CP_P, True).full(CP_P, dev)
        out["inputs"] = [digest(t) for t in (a, b, gy)]
        xs, ys = a.detach().requires_grad_(), b.detach().requires_grad_()
        for algo in algos:
            spec = cpl._carry_spec(None, algo)

            def fwd(spec=spec):
                return fn(a, b, spec=spec)

            def both(spec=spec):
                h = fn(xs, ys, spec=spec)
                da, db = torch.autograd.grad(h, [xs, ys], gy)
                return h.detach(), da, db

            h = fwd()
            d_fwd = [digest(h)]
            del h
            fwd_s = wall_s(fwd, dev, reps)
            g = both()
            d_both = [digest(t) for t in g]
            del g
            both_s = wall_s(both, dev, reps)
            out[algo] = {"fwd": (d_fwd, fwd_s), "grad": (d_both, both_s)}
        del a, b, gy, xs, ys
    torch.cuda.empty_cache()
    return out


def check_pool_call(label, pool, res, pl, times: int, path: dict,
                    want, per_rank, *, inputs=None, nccl: bool,
                    child: dict) -> dict:
    """One ``WorkerPool.call`` against the stacked run and the plan:
    its outputs (digests or arrays) equal to ``want``, the drawn inputs'
    digests to ``inputs``; every process's rounds and ⊕ ``times`` the
    plan's, its launches ``path`` (by wrapper) and ``times`` the IR's
    round kernels; the crossing messages and bytes ``times``
    ``expected_messages``; nothing staged under nccl, something staged
    where gloo carries a message on the card.  The checked repeat's
    launches are added to ``child``; the row times the rest."""
    from repro_torch.core import schedule as sch

    got = res.outputs if isinstance(res.outputs, tuple) else (res.outputs,)
    if len(got) != len(want) or not all(
            np.shape(g) == np.shape(w) and np.array_equal(g, w)
            for g, w in zip(got, want)):
        raise AssertionError(f"{label}: outputs differ from the stacked "
                             f"run's")
    if inputs is not None and not all(
            np.array_equal(g, w) for g, w in zip(res.inputs, inputs)):
        raise AssertionError(f"{label}: the processes drew other inputs "
                             f"than the stacked run")
    want_st = (times * pl.rounds, times * pl.op_applications)
    got_st = [(st["rounds"], st["op_applications"]) for st in res.rank_stats]
    if got_st != [want_st] * pool.nprocs:
        raise AssertionError(f"{label}: rounds/⊕ by process {got_st}, "
                             f"the plan {want_st} each")
    on_card = pool.device.type == "cuda"  # the CPU runs plain versions
    ir = times * _ir_launches(pl) if on_card else 0
    path = path if on_card else {}
    for k, ln in enumerate(res.launches):
        rounds = sum(n for w in ROUND_KERNELS for n in ln.get(w, {}).values())
        rest = {w: sum(by.values()) for w, by in ln.items()
                if w not in ROUND_KERNELS}
        if rounds != ir or rest != path:
            raise AssertionError(f"{label}: process {k} launched {rounds} "
                                 f"round kernels and {rest}; the path "
                                 f"{ir} and {path}")
    msgs, nbytes = sch.expected_messages(pl.schedule(), per_rank,
                                         ranks_per_proc=pool.p_intra)
    tr = res.transport
    if (tr["msgs"], tr["bytes"]) != (times * msgs, times * nbytes):
        raise AssertionError(f"{label}: sent {tr['msgs']} messages of "
                             f"{tr['bytes']} bytes, the schedule "
                             f"{times * msgs} of {times * nbytes}")
    if nccl and tr["staged_copies"]:
        raise AssertionError(f"{label}: {tr['staged_copies']} copies staged "
                             f"through the host under nccl")
    if not nccl and on_card and msgs and not tr["staged_copies"]:
        raise AssertionError(f"{label}: gloo carried messages on the card "
                             f"without staging")
    _add_launches(child, res)
    times_s = res.seconds[1:]
    return {"run": label, "devices": [m["device"] for m in res.memory],
            "allocated_peak_bytes": [m["allocated_peak_bytes"]
                                     for m in res.memory],
            "algorithm": pl.algorithm, "rounds": pl.rounds,
            "ops": pl.op_applications, "round_launches_per_process": ir,
            "messages": tr["msgs"], "message_bytes": tr["bytes"],
            "staged_copies": tr["staged_copies"],
            "median_s": statistics.median(times_s), "min_s": min(times_s),
            "max_s": max(times_s),
            "staging_ms": statistics.median(res.staging_seconds[1:]) * 1e3}


def cp_pool_rows(pool, kind: str, stacked: dict, algos, reps: int, *,
                 nccl: bool, child: dict) -> list:
    """Each algorithm's forward, then forward and backward, of the cp
    scan ``kind`` across ``pool`` (inputs drawn in the processes,
    outputs as digests), checked by :func:`check_pool_call` against
    ``stacked`` (:func:`cp_stacked`), the stacked wall beside."""
    from repro_torch.core.scan_api import plan
    from repro_torch.models import context_parallel as cpl

    d = int(np.prod(cp_draw(kind, CP_P, False).shapes[1][2:]))
    per_rank = (torch.zeros(1, d), torch.zeros(1, d))
    rows = []
    for algo in algos:
        spec = cpl._carry_spec(None, algo)
        pl = plan(spec, pool.p, nbytes=2 * d * 4)
        for grad in (False, True):
            res = pool.call(f"cp_{kind}_scan", cp_draw(kind, pool.p, grad),
                            spec=spec, grad=grad, digest=True,
                            repeats=1 + reps)
            want, stacked_s = stacked[algo]["grad" if grad else "fwd"]
            path = {"affine_chunk": 2, "affine_chunk_bwd": 2} if grad \
                else {"affine_chunk": 2}
            row = check_pool_call(
                f"cp_{kind}/{'fwd+bwd' if grad else 'fwd'}/{algo}", pool, res,
                pl, 2 if grad else 1, path, want, per_rank,
                inputs=stacked["inputs"][:3 if grad else 2], nccl=nccl,
                child=child)
            row.update(stacked_median_s=statistics.median(stacked_s),
                       stacked_min_s=min(stacked_s))
            rows.append(row)
    return rows


def qwen_routing(dev, p: int, n0: int = 4096):
    """Qwen1.5-MoE-A2.7B's router choices for p ranks of n0 tokens, k
    distinct real experts a token (the moe_dispatch phase's draw)."""
    from repro_torch import configs

    cfg = configs.get(QWEN)
    gen = torch.Generator(device=dev).manual_seed(40)
    top = torch.rand((p, n0, cfg.n_experts), generator=gen, device=dev) \
        .topk(cfg.top_k, dim=-1).indices.to(torch.int32).contiguous()
    return cfg, top


def dispatch_pool_rows(pool, dev, algos, reps: int, *, nccl: bool,
                       child: dict) -> list:
    """``dispatch_slots`` at Qwen1.5-MoE-A2.7B's routing over the pool's
    p ranks, every output equal to the stacked call's on ``dev``."""
    from repro_torch.core.scan_api import ScanSpec, plan
    from repro_torch.models import params
    from repro_torch.models.moe import dispatch_slots

    cfg, top = qwen_routing(dev, pool.p)
    e_pad = params.experts_padded(cfg)
    top_np = top.cpu().numpy()
    rows = []
    for algo in algos:
        spec = ScanSpec(kind="exclusive", monoid="add", algorithm=algo)
        with uncounted():
            want = [t.cpu().numpy() for t in dispatch_slots(cfg, top,
                                                            spec=spec)]
            stacked_s = wall_s(lambda: dispatch_slots(cfg, top, spec=spec),
                               dev, reps)
        pl = plan(ScanSpec(kind="scan_total", monoid="add", algorithm=algo),
                  pool.p, nbytes=4 * e_pad)
        res = pool.call("dispatch_slots", top_np, arch=QWEN, spec=spec,
                        repeats=1 + reps)
        row = check_pool_call(f"dispatch/{algo}", pool, res, pl, 1,
                              {"moe_routing": 1}, want,
                              torch.zeros(e_pad, dtype=torch.int32),
                              nccl=nccl, child=child)
        row.update(stacked_median_s=statistics.median(stacked_s),
                   stacked_min_s=min(stacked_s),
                   drop_fraction=float(1.0 - want[3].mean()))
        rows.append(row)
    del top
    return rows


def consumers(dev, grid, dispatch_grid, *, backend: str, algos,
              dispatch_algos, reps: int, child: dict, hops=None,
              xor_grid=None, keep: bool = False) -> dict:
    """The cp scans (forward, forward and backward) over a pool of
    ``grid`` = (processes, ranks a process), p = 8, and the dispatch
    over ``dispatch_grid``, p = 64, each over ``backend`` (gloo: every
    process on ``dev``; nccl: one a card), against the stacked runs
    on ``dev`` (made first and freed, so the pool has the card);
    with ``hops``, ``measure_hop`` at those sizes and ``calibrate_dist``
    over the cp pool; with ``xor_grid``, table 1's xor cell (p = 512, m
    = 10⁵ int64) over a pool of that grid for 123, 1doubling and
    two_op, bit for bit against the stacked run.  The pools of
    ``grid[0]`` processes are one (:func:`shared_pool`), its processes
    holding each grid's ranks in turn; with ``keep`` it stays open for
    the serving rows (:func:`row_pool`)."""
    from repro_torch.core import tune
    from repro_torch.core.scan_api import ScanSpec, plan
    from repro_torch.dist import WorkerPool

    nccl = backend == "nccl"
    where = dict(device=dev) if not nccl else {}
    n = grid[0]

    def pool_of(nprocs, p_intra):
        """(the pool, whether it is the shared one)."""
        if nprocs == n:
            return shared_pool(n, dev, backend, p_intra=p_intra,
                               timeout=600.0 if keep
                               else POOL_TIMEOUT_S)[0], True
        return WorkerPool(nprocs, p_intra=p_intra, backend=backend,
                          timeout=POOL_TIMEOUT_S, **where), False
    out: dict = {"backend": backend, "grid": list(grid),
                 "dispatch_grid": list(dispatch_grid)}
    t0 = time.perf_counter()
    stacked = {kind: cp_stacked(dev, kind, algos, reps)
               for kind in ("ssm", "wkv")}
    out["stacked_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pool, _ = pool_of(*grid)
    out["start_s"] = time.perf_counter() - t0
    try:
        for kind in ("ssm", "wkv"):
            out[f"cp_{kind}"] = cp_pool_rows(pool, kind, stacked[kind],
                                             algos, reps, nccl=nccl,
                                             child=child)
        if hops:
            out["hop_s"] = {str(n): pool.measure_hop(n, repeats=20)
                            for n in hops}
            t0 = time.perf_counter()
            prof = tune.calibrate_dist(pool)
            dci = prof.model("dci")
            out["calibrate"] = {
                "fingerprint": prof.mesh_fingerprint,
                "calibrate_s": time.perf_counter() - t0,
                "dci": {"alpha": dci.alpha, "beta": dci.beta,
                        "gamma": dci.gamma},
                "residual": dict(prof.residuals)["dci"]}
    except BaseException:
        close_shared(n)
        raise
    del stacked
    pool, shared = pool_of(*dispatch_grid)
    try:
        out["dispatch"] = dispatch_pool_rows(pool, dev, dispatch_algos,
                                             reps, nccl=nccl, child=child)
    except BaseException:
        close_shared(n)
        raise
    finally:
        if not shared:
            pool.close()
    if xor_grid:
        rng = np.random.default_rng(52)
        p, m = xor_grid[0] * xor_grid[1], 100_000
        xn = rng.integers(-(1 << 62), 1 << 62, (p, m), dtype=np.int64)
        want = exclusive_ref(xn, np.bitwise_xor)
        pool, shared = pool_of(*xor_grid)
        try:
            rows = []
            for algo in ("123", "1doubling", "two_op"):
                pl = plan(ScanSpec(kind="exclusive", monoid="xor",
                                   algorithm=algo), p, nbytes=8 * m)
                row = blocks_row(pool, f"xor/{algo}/m={m}", pl, xn, want,
                                 reps, child)
                if nccl and row["staged_copies"]:
                    raise AssertionError(f"xor/{algo}: copies staged "
                                         f"under nccl")
                rows.append(row)
            out["xor"] = rows
        except BaseException:
            close_shared(n)
            raise
        finally:
            if not shared:
                pool.close()
    if not keep:
        close_shared(n)
    return out


# ---------------------------------------------------------------------------
# procs / cards: Qwen1.5-MoE-A2.7B and Llama-3-8B served with their (data,
# model) ranks held by processes, each holding its experts and its share of
# the dense layers
# ---------------------------------------------------------------------------

# the serving rows' requests
MOE_SERVE = {"batch": 4, "prompt": 512, "gen": 32, "seed": 0}
LLAMA = "llama3-8b"
RWKV_FULL = "rwkv6-1.6b"
JAMBA_FULL = "jamba-1.5-large-398b"
# the Mamba mixer row: B requests, a prefill of P positions, n decode steps
MAMBA_ROW = {"batch": 4, "prompt": 512, "decode": 8, "seed": 0}
MAMBA_X_SEED = 74
BF16_REL = 2.0 ** -8  # bf16's relative spacing: the tolerance of a reading
MOE_X_SEED = 70


def moe_x(cfg, S: int) -> np.ndarray:
    """The MoE layer's input, (B, S, d) fp32 from ``MOE_X_SEED``: the
    stacked layer takes it whole, each process its rows."""
    return np.random.default_rng(MOE_X_SEED).standard_normal(
        (MOE_SERVE["batch"], S, cfg.d_model), dtype=np.float32)


def moe_layer_plan(cfg, B: int, S: int, ranks):
    """The dispatch scan's plan of one MoE layer call at (B, S) on the
    (data, model) grid ``ranks`` (``moe.dispatch_plan``); None for one
    group."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe

    return moe.dispatch_plan(cfg, B, S, make_host_mesh(*ranks)).plan


def bmm_reading(dev, cfg, ranks, cap: int) -> dict:
    """The expert GEMM the two runs differ in, alone: ``torch.bmm`` of
    (e, tp·cap, d) rows by (e, d, f) gates at the stacked run's batch
    count e_pad and at a process's e_pad/tp, on the same operands;
    whether the shared batches' outputs have equal bits."""
    from repro_torch.models import params as PD

    e_pad, tp = PD.experts_padded(cfg), ranks[1]
    gen = torch.Generator(device=dev).manual_seed(71)
    t = torch.randn((e_pad, tp * cap, cfg.d_model), generator=gen,
                    device=dev).to(PD.torch_dtype(cfg))
    w = torch.randn((e_pad, cfg.d_model, cfg.moe_d_ff), generator=gen,
                    device=dev).to(PD.torch_dtype(cfg))
    whole = torch.bmm(t, w)
    part = torch.cat([torch.bmm(t[lo:lo + e_pad // tp], w[lo:lo + e_pad // tp])
                      for lo in range(0, e_pad, e_pad // tp)])
    return {"shape": [e_pad, tp * cap, cfg.d_model, cfg.moe_d_ff],
            "batches": [e_pad, e_pad // tp],
            "bits_equal": bool(torch.equal(whole, part)),
            "max_abs": float((whole.float() - part.float()).abs().max())}


def _rel(got, want) -> float:
    """max |got − want| over max |want|, row by row, the largest."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rows = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    scale = np.maximum(np.abs(rows[1]).max(axis=1), 1e-30)
    return float((np.abs(rows[0] - rows[1]).max(axis=1) / scale).max())


def parted(got, want) -> list:
    """Where the served tokens ``got`` are not the stacked run's
    ``want``: each request's first other token, as (request, step)."""
    return [(r, int(np.flatnonzero(got[r] != want[r])[0]))
            for r in range(want.shape[0]) if not np.array_equal(got[r],
                                                                 want[r])]


def serve_stacked(dev, name: str, ranks, over: dict | None = None,
                  gen: int | None = None, layer: bool = True) -> dict:
    """The stacked port of ``name`` (with the config overrides ``over``)
    at ``ranks`` on one card (its split layers computed shard by shard,
    as the processes compute them; its leaves whole over "data"), kept
    out of the launch counts and freed before it returns: ``serve_loop``
    of ``gen`` tokens (default ``MOE_SERVE``'s; cold, then the reported
    warm run) and, for a MoE model with ``layer``, the MoE layer at the
    prefill and decode shapes on the inputs the pool is given."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import prompts_for, serve_loop
    from repro_torch.models import moe
    from repro_torch.models import params as PD
    from repro_torch.models.model import Model
    from repro_torch.serve.metrics import percentile

    cfg = configs.get(name, **(over or {}))
    B, P, G, seed = (MOE_SERVE[k] for k in ("batch", "prompt", "gen",
                                             "seed"))
    G = gen or G
    out: dict = {}
    with uncounted():
        model = Model(cfg, ranks, device=dev)
        params = model.init_params(seed)
        out["param_bytes"] = PD.nbytes(params)
        prompts = prompts_for(cfg, B, P, seed)
        cold = serve_loop(model, params, prompts, G)
        res = serve_loop(model, params, prompts, G)
        if not np.array_equal(cold.tokens, res.tokens):
            raise AssertionError(f"stacked {name} {ranks}: two greedy runs "
                                 f"differ")
        out.update(tokens=res.tokens,
                   prefill_logits=res.prefill_logits.float().cpu().numpy(),
                   prefill_ms=res.prefill_s * 1e3,
                   step_p50_ms=percentile(res.step_s, 50) * 1e3,
                   step_p99_ms=percentile(res.step_s, 99) * 1e3)
        del model, params, res, cold
        torch.cuda.empty_cache()
        if cfg.n_experts and layer:
            p = PD.init_moe_layer(cfg, seed, dev)
            mesh = make_host_mesh(*ranks)
            for S in (P, 1):
                x = torch.from_numpy(moe_x(cfg, S)).to(dev).to(
                    PD.torch_dtype(cfg))
                y, aux, kept = moe._moe_ffn(cfg, p, x, mesh, None, None)
                out[S] = tuple(t.float().cpu().numpy()
                               for t in (y, aux, kept))
            del p, x, y
    torch.cuda.empty_cache()
    return out


def all_reduce_row(pool, cfg, ranks, S: int, reps: int) -> dict:
    """``SPMDExecutor.all_reduce`` over "model" of one process's (B_k, S,
    d) activations in bf16, as a layer's row-split product makes it,
    called alone through the pool after one warm call: its ms (the
    first of 1 + ``reps`` calls, CUDA events under nccl) and the median
    wall of the calls, every process of a group holding the same bits,
    beside the dry run's price (2·(tp − 1)/tp of its bytes over
    ``LINK_BW``)."""
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe

    B, tp = MOE_SERVE["batch"], ranks[1]
    rows = moe.held_rows(B, make_host_mesh(*ranks), 0)
    shape = (rows.stop - rows.start, S, cfg.d_model)
    x = np.random.default_rng(72).standard_normal(
        (pool.nprocs, *shape), dtype=np.float32)
    grid = (("data", ranks[0]), ("model", ranks[1]))
    pool.call("all_reduce", x, axis="model", dtype="bfloat16", mesh=grid)
    res = pool.call("all_reduce", x, axis="model", dtype="bfloat16",
                    mesh=grid, repeats=1 + reps)
    for i in range(ranks[0]):
        group = [np.asarray(res.outputs[i * tp + j]) for j in range(tp)]
        if not all(g.tobytes() == group[0].tobytes() for g in group):
            raise AssertionError(f"all_reduce {ranks} S = {S}: the model "
                                 f"processes of data shard {i} differ")
    tr = res.transport
    nbytes = int(np.prod(shape)) * 2
    return {"shape": list(shape), "bytes": nbytes,
            "calls_per_process": tr["all_reduce"] // pool.nprocs,
            "ms": tr["all_reduce_s"] / tr["all_reduce"] * 1e3,
            "wall_ms": statistics.median(res.seconds) * 1e3,
            "priced_ms": roofline.wire_bytes("all-reduce", nbytes, tp)
            / roofline.LINK_BW * 1e3,
            "bits_equal_in_group": True}


def layer_row(pool, dev, cfg, ranks, stacked, row, launches_ok, *,
              nccl: bool, child: dict, reps: int) -> None:
    """The MoE layer of ``serve_pool_row``'s model over the pool at the
    prefill and decode shapes, into ``row["layer"]``."""
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models import params as PD

    B, P, seed = (MOE_SERVE[k] for k in ("batch", "prompt", "seed"))
    mesh, n = make_host_mesh(*ranks), pool.nprocs
    grid = (("data", ranks[0]), ("model", ranks[1]))
    e_pad, d, tp = PD.experts_padded(cfg), cfg.d_model, ranks[1]
    itemsize = PD.torch_dtype(cfg).itemsize
    label = row["run"]
    bmm = {S: bmm_reading(dev, cfg, ranks, moe.capacity(
        cfg, moe.moe_groups(cfg, B, S, mesh).n0, cfg.top_k)) for S in (P, 1)}
    for S, name in ((P, "prefill"), (1, "decode")):
        kw = dict(arch=cfg.name, ranks=ranks, batch=B, seed=seed,
                  mesh=grid)
        xs = np.stack([moe_x(cfg, S)] * n)
        pool.call("moe_ffn", xs, **kw)
        res = pool.call("moe_ffn", xs, repeats=1 + reps, **kw)
        want_y, want_aux, want_kept = stacked[S]
        got_y, got_aux, got_kept = (np.asarray(t, np.float32)
                                    for t in res.outputs)
        bits = all(np.array_equal(got_y[k], want_y[moe.held_rows(B, mesh, k)])
                   for k in range(n)) and all(
            np.array_equal(a, want_aux) for a in got_aux)
        kept_equal = all(np.array_equal(got_kept[k],
                                        want_kept[moe.held_rows(B, mesh, k)])
                         for k in range(n))
        rel = max(_rel(got_y[k], want_y[moe.held_rows(B, mesh, k)])
                  for k in range(n))
        if not bits and (bmm[S]["bits_equal"] or rel > BF16_REL or
                         not kept_equal):
            raise AssertionError(f"{label}/{name}: the MoE layer differs "
                                 f"from the stacked one by {rel} relative "
                                 f"(kept equal: {kept_equal}; torch.bmm "
                                 f"alone {bmm[S]})")
        gr = moe.moe_groups(cfg, B, S, mesh)
        cap = moe.capacity(cfg, gr.n0, cfg.top_k)
        tr = res.transport
        buf = e_pad * cap * d * itemsize
        if (tr["all_to_all"], tr["all_to_all_bytes"]) != (2 * n, 2 * n * buf):
            raise AssertionError(f"{label}/{name}: {tr['all_to_all']} "
                                 f"all-to-alls of {tr['all_to_all_bytes']} "
                                 f"bytes; the layer makes {2 * n} of "
                                 f"{2 * n * buf}")
        if nccl and tr["staged_copies"]:
            raise AssertionError(f"{label}/{name}: copies staged under nccl")
        pl = moe_layer_plan(cfg, B, S, ranks)
        if {(st["rounds"], st["op_applications"]) for st in res.rank_stats} \
                != {(pl.rounds, pl.op_applications) if pl else (0, 0)}:
            raise AssertionError(f"{label}/{name}: dispatch rounds by "
                                 f"process {res.rank_stats}, the plan "
                                 f"{pl and pl.rounds}")
        launches = launches_ok(res, [(S, 1)])
        _add_launches(child, res)
        a2a_s = tr["all_to_all_s"] / tr["all_to_all"]
        row["layer"][name] = {
            "shape": [B, S, d], "cap": cap, "groups": gr.n_groups,
            "ws": gr.ws, "token_split": gr.token_split,
            "bits_equal": bits, "kept_equal": kept_equal,
            "max_rel_of_row_max": rel, "bmm": bmm[S],
            "dispatch": {"algorithm": pl and pl.algorithm,
                         "rounds": pl and pl.rounds},
            "launches_per_process": launches,
            "all_to_all_calls_per_process": tr["all_to_all"] // n,
            "all_to_all_bytes": buf,
            "all_to_all_ms": a2a_s * 1e3,
            "all_to_all_priced_ms": roofline.wire_bytes(
                "all-to-all", buf, tp) / roofline.LINK_BW * 1e3,
            "all_gather_calls_per_process": tr["all_gather"] // n,
            "all_gather_ms": tr["all_gather_s"] / max(1, tr["all_gather"])
            * 1e3,
            "staged_copies": tr["staged_copies"],
            "staging_ms": tr["staging_s"] * 1e3}


def serve_pool_row(pool, dev, name: str, ranks, stacked: dict, *,
                   nccl: bool, child: dict, reps: int,
                   over: dict | None = None, gen: int | None = None) -> dict:
    """``name`` (Qwen1.5-MoE-A2.7B, Llama-3-8B or RWKV6-1.6B, with the
    config overrides ``over``) over ``pool``'s processes as the (data,
    model) grid ``ranks``, each holding its rows, its experts and its
    share of the dense layers and mixers (``params.plan_split``), held
    to the stacked run ``stacked``.  For a MoE model first the MoE
    layer at the prefill and decode shapes (y and aux bit for bit, or
    within bf16's spacing where ``torch.bmm`` alone gives other bits at
    the two batch counts; each process's collectives their formula, its
    routing and round-kernel launches the plan's); then the all-reduce
    of a row-split product alone at both shapes (:func:`all_reduce_row`);
    then ``serve`` of ``gen`` tokens (default ``MOE_SERVE``'s; the
    stacked tokens, every one; prefill logits bit for bit, or for Qwen
    and Llama within bf16's spacing; each process's ``affine_chunk``
    launches one a RWKV6 layer and prefill), with prefill ms, decode
    p50/p99, busy and idle, each process's parameter and peak bytes (its
    share, counted from the config, less than the whole dense layers),
    the all-reduces' calls (the code's count: ``params.all_reduces`` a
    call), bytes and seconds, the all-gathers and all-to-alls, the
    dispatch scan's rounds and launches, and the staging copies (none
    under nccl).  Over more than one data process (FSDP) also each
    process's all-gathers of its weights over "data" (the code's count,
    ``params.fsdp_gathers`` a call), their bytes and ms, and one layer's
    gather timed alone at the prefill's and the decode's bucket
    (:func:`fsdp_gather_row`)."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import serve_procs
    from repro_torch.models import moe
    from repro_torch.models import params as PD
    from repro_torch.serve.metrics import percentile

    over = over or {}
    cfg = configs.get(name, **over)
    B, P, G, seed = (MOE_SERVE[k] for k in ("batch", "prompt", "gen",
                                             "seed"))
    G = gen or G
    mesh, n, tp = make_host_mesh(*ranks), pool.nprocs, ranks[1]
    on_card = pool.device.type == "cuda"
    short = {QWEN: "qwen", LLAMA: "llama", RWKV_FULL: "rwkv"}[name]
    label = f"{short}/{ranks[0]}x{ranks[1]}/full"
    row: dict = {"run": label, "model": cfg.name, "backend": pool.backend,
                 "devices": [str(x) for x in pool.devices],
                 "width": "full", "layers": cfg.n_layers, "layer": {},
                 "tokens": [B, P, G]}
    if over or G != MOE_SERVE["gen"]:
        row["reduced"] = (f"{cfg.n_layers} of {configs.get(name).n_layers} "
                          f"layers, full width, {B} x ({P} + {G}) tokens: "
                          f"gloo's staged collectives on one card")

    def launches_ok(res, calls):
        """Each process's routing and round-kernel launches: one routing
        launch and the plan's IR a layer call, ``calls`` = [(S, n)]."""
        want_r = sum(c for _, c in calls) if cfg.n_experts else 0
        want_k = 0
        for S, c in calls:
            pl = moe_layer_plan(cfg, B, S, ranks) if cfg.n_experts else None
            want_k += c * (_ir_launches(pl) if pl is not None else 0)
        for k, ln in enumerate(res.launches):
            routed = sum(ln.get("moe_routing", {}).values())
            rounds = sum(v for w in ROUND_KERNELS
                         for v in ln.get(w, {}).values())
            if on_card and (routed, rounds) != (want_r, want_k):
                raise AssertionError(f"{label}: process {k} launched "
                                     f"{routed} routing and {rounds} round "
                                     f"kernels; the plan {want_r} and "
                                     f"{want_k}")
        return {"moe_routing": want_r, "round_kernels": want_k}

    # the MoE layer: the first call warms the groups, the second is read
    if cfg.n_experts:
        layer_row(pool, dev, cfg, ranks, stacked, row, launches_ok,
                  nccl=nccl, child=child, reps=reps)
    row["all_reduce"] = {
        "prefill": all_reduce_row(pool, cfg, ranks, P, reps),
        "decode": all_reduce_row(pool, cfg, ranks, 1, reps)}
    # which calls' MoE grouping is weight-stationary: the experts then
    # stay out of the layers' gathers, and their partials are reduced
    ws = {S: ranks[0] > 1 and bool(cfg.n_experts) and
          moe.moe_groups(cfg, B, S, mesh).ws for S in (P, 1)}
    if ranks[0] > 1:
        row["fsdp_gather_alone"] = {
            kind: fsdp_gather_row(pool, cfg, ranks, ws[S], reps)
            for S, kind in ((P, "prefill"), (1, "decode"))}

    # serving: a prefill and one step warm the shapes, then the run read
    got = serve_procs(pool, arch=name, smoke=False, batch=B,
                      prompt_len=P, gen=G, seed=seed, ranks=ranks,
                      trace=True, warm=True, **over)
    res = got["result"]
    tokens_equal = bool(np.array_equal(got["tokens"], stacked["tokens"]))
    if not tokens_equal:
        raise AssertionError(f"{label}: served tokens differ from the "
                             f"stacked run's, first at (request, step) "
                             f"{parted(got['tokens'], stacked['tokens'])}")
    logits = np.asarray(got["prefill_logits"], np.float32)
    if not np.isfinite(logits).all():
        raise AssertionError(f"{label}: non-finite prefill logits")
    logits_bits = np.array_equal(logits, stacked["prefill_logits"])
    logits_rel = _rel(logits, stacked["prefill_logits"])
    if logits_rel > BF16_REL or (name == RWKV_FULL and not logits_bits):
        raise AssertionError(f"{label}: prefill logits off the stacked "
                             f"run's by {logits_rel} relative")
    n_moe = sum(s.use_moe for s in cfg.pattern()) * cfg.n_repeats
    # the warm prefill and step, the loop's prefill and G - 1 steps,
    # then on the card the busy trace's two prefills and two decode steps
    traced = 2 if on_card else 0
    launches = launches_ok(res, [(P, n_moe * (2 + traced)),
                                 (1, n_moe * (G + traced))])
    # one scan a mixer layer and prefill, on the process's heads
    n_scan = sum(s.kind in ("rwkv", "mamba") for s in cfg.pattern()) \
        * cfg.n_repeats
    for k, ln in enumerate(res.launches):
        scans = sum(ln.get("affine_chunk", {}).values())
        if on_card and scans != n_scan * (2 + traced):
            raise AssertionError(f"{label}: process {k} launched {scans} "
                                 f"affine_chunk; the path "
                                 f"{n_scan * (2 + traced)}")
    if n_scan:
        launches["affine_chunk"] = n_scan * (2 + traced)
    _add_launches(child, res)
    tr = res.transport
    # (S, calls): the warm prefill, the loop's and the traced ones; the
    # warm step, the loop's G - 1 and the traced ones
    by_shape = ((P, 2 + traced), (1, G + traced))
    calls = 2 + G + 2 * traced
    if cfg.n_experts and tr["all_to_all"] != 2 * n * n_moe * calls:
        raise AssertionError(f"{label}: {tr['all_to_all']} all-to-alls, "
                             f"the path {2 * n * n_moe * calls}")
    if nccl and tr["staged_copies"]:
        raise AssertionError(f"{label}: copies staged under nccl")
    held = np.asarray(res.outputs[3])
    want_held = [PD.share_nbytes(cfg, mesh, k) for k in range(n)]
    if [list(h) for h in held.tolist()] != [[w["dense"], w["experts"]]
                                            for w in want_held]:
        raise AssertionError(f"{label}: processes hold {held.tolist()}, "
                             f"their shares {want_held}")
    whole = stacked["param_bytes"]
    dense = held[:, 0]
    if not ((dense * tp * ranks[0] >= whole["dense"])
            & (dense < whole["dense"])).all():
        raise AssertionError(f"{label}: {held[:, 0].tolist()} dense bytes "
                             f"a process of {whole['dense']}")
    split = PD.plan_split(cfg, mesh)
    per_call = PD.all_reduces(cfg, split)
    want_ar = n * sum(c * PD.all_reduces(cfg, split, ws=ws[S])
                      for S, c in by_shape)
    if tr["all_reduce"] != want_ar:
        raise AssertionError(f"{label}: {tr['all_reduce']} all-reduces, "
                             f"the code's {want_ar}")
    gathers = []
    for k, t in enumerate(res.traffic):
        want = [sum(c * PD.fsdp_gathers(cfg, mesh, k, ws=ws[S])[key]
                    for S, c in by_shape) for key in ("calls", "bytes")]
        if [t["fsdp_gather"], t["fsdp_gather_bytes"]] != want:
            raise AssertionError(f"{label}: process {k} gathered "
                                 f"{t['fsdp_gather']} weight buckets of "
                                 f"{t['fsdp_gather_bytes']} bytes over "
                                 f"data; the code's {want}")
        gathers.append({"calls": t["fsdp_gather"],
                        "bytes": t["fsdp_gather_bytes"],
                        "ms": t["fsdp_gather_s"] * 1e3})
    busy = np.asarray(res.outputs[4])
    p50 = percentile(got["step_s"], 50)

    def listed(a):  # NaN (no profiler reading) as null
        return [None if np.isnan(v) else float(v) for v in a]

    row.update({
        "tokens_equal": tokens_equal,
        "prefill_logits_bits_equal": logits_bits,
        "prefill_logits_max_rel_of_row_max": logits_rel,
        "prefill_ms": got["prefill_s"] * 1e3,
        "step_p50_ms": p50 * 1e3,
        "step_p99_ms": percentile(got["step_s"], 99) * 1e3,
        "stacked_prefill_ms": stacked["prefill_ms"],
        "stacked_step_p50_ms": stacked["step_p50_ms"],
        "stacked_step_p99_ms": stacked["step_p99_ms"],
        "prefill_busy_ms": listed(busy[:, 0] * 1e3),
        "prefill_idle_share": listed(1 - busy[:, 0] / got["prefill_s"]),
        "decode_busy_ms": listed(busy[:, 1] * 1e3),
        "decode_idle_share": listed(1 - busy[:, 1] / p50),
        "param_bytes": held.sum(axis=1).tolist(),
        "dense_bytes": held[:, 0].tolist(),
        "expert_bytes": held[:, 1].tolist(),
        "allocated_peak_bytes": [m["allocated_peak_bytes"]
                                 for m in res.memory],
        "dense_bytes_whole": whole["dense"],
        "dispatch_rounds_per_process": res.rank_stats[0]["rounds"],
        "launches_per_process": launches,
        "model_calls": calls,
        "all_reduce_per_call": per_call,
        "all_reduce_per_process": tr["all_reduce"] // n,
        "all_reduce_bytes_per_process": tr["all_reduce_bytes"] // n,
        "all_reduce_s_per_process": tr["all_reduce_s"] / n,
        "all_to_all_per_process": tr["all_to_all"] // n,
        "all_to_all_bytes_per_process": tr["all_to_all_bytes"] // n,
        "all_to_all_s_per_process": tr["all_to_all_s"] / n,
        "all_gather_per_process": tr["all_gather"] // n,
        "all_gather_bytes_per_process": tr["all_gather_bytes"] // n,
        "all_gather_s_per_process": tr["all_gather_s"] / n,
        "fsdp_gather_by_process": gathers,
        "fsdp_gather_per_call": {
            kind: {key: PD.fsdp_gathers(cfg, mesh, 0, ws=ws[S])[key]
                   for key in ("calls", "bytes")}
            for S, kind in ((P, "prefill"), (1, "decode"))},
        "messages": tr["msgs"], "staged_copies": tr["staged_copies"],
        "staging_s": tr["staging_s"]})
    return row


def fsdp_gather_row(pool, cfg, ranks, ws: bool, reps: int) -> dict:
    """One layer's weight gather over "data" alone: the largest bucket a
    process sends in a call (``params.fsdp_gathers``; the experts out of
    it where the call is weight-stationary) as bf16 drawn in each
    process, gathered through the pool's ``all_gather`` entry after one
    warm call: its ms (the first of 1 + ``reps`` calls, CUDA events
    under nccl), the median wall, every row the process's own bits,
    beside the dry run's price ((n_data − 1)/n_data of the gathered
    bytes over ``LINK_BW``)."""
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as PD

    nbytes = max(PD.fsdp_gathers(cfg, make_host_mesh(*ranks), 0,
                                 ws=ws)["buckets"])
    grid = (("data", ranks[0]), ("model", ranks[1]))
    pool.call("all_gather", None, nbytes=nbytes, mesh=grid)
    res = pool.call("all_gather", None, nbytes=nbytes, mesh=grid,
                    repeats=1 + reps)
    if not np.asarray(res.outputs).all():
        raise AssertionError(f"fsdp gather of {nbytes} bytes {ranks}: a "
                             f"row is not its process's")
    tr = res.transport
    return {"bytes": nbytes, "calls_per_process": tr["fsdp_gather"]
            // pool.nprocs,
            "ms": tr["fsdp_gather_s"] / tr["fsdp_gather"] * 1e3,
            "wall_ms": statistics.median(res.seconds) * 1e3,
            "priced_ms": roofline.wire_bytes("all-gather",
                                             nbytes * ranks[0], ranks[0])
            / roofline.LINK_BW * 1e3,
            "bits_equal": True}


@contextlib.contextmanager
def row_pool(dev, backend: str):
    """The serving and mixer rows' pool: four processes over ``backend``
    (gloo: every process on ``dev``; nccl: one a card), each row a
    (data, model) grid of them, one rank a process (the cp scans' pool
    where they ran before, :func:`consumers` with ``keep``); closed, and
    its processes checked gone, after."""
    pool, _ = shared_pool(4, dev, backend, p_intra=1, timeout=600.0)
    try:
        yield pool
    finally:
        close_shared(4)


def serve_rows(pool, dev, rows, *, child: dict, reps: int = 3) -> list:
    """Each (model, (data, model) grid) of ``rows``: the stacked run on
    ``dev`` first and freed, then its row over ``pool``
    (:func:`serve_pool_row`); over gloo at the depth :data:`GLOO_DEPTH`
    and the generated tokens :data:`GLOO_GEN` name."""
    nccl = pool.backend == "nccl"
    out = []
    for name, ranks in rows:
        key = (name, tuple(ranks))
        over = {} if nccl or key not in GLOO_DEPTH \
            else {"n_layers": GLOO_DEPTH[key]}
        gen = None if nccl else GLOO_GEN.get(key)
        t0 = time.perf_counter()
        stacked = serve_stacked(dev, name, ranks, over, gen)
        stacked_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        row = serve_pool_row(pool, dev, name, ranks, stacked, nccl=nccl,
                             child=child, reps=reps, over=over, gen=gen)
        row.update(stacked_s=stacked_s, pool_s=time.perf_counter() - t0)
        emit({"serve_row": row})  # each row as it is done
        out.append(row)
        del stacked
        torch.cuda.empty_cache()
    return out


def mamba_mixer_row(pool, dev, ranks, *, nccl: bool, child: dict,
                    reps: int = 3) -> dict:
    """One Mamba mixer of Jamba-1.5-Large at full width (d 8192, d_inner
    16 384) over ``pool``'s processes as the (data, model) grid
    ``ranks`` (the ``mamba_block`` entry: each process its d_inner/tp
    channels from the seed, its rows of one (B, P + n, d) input, a
    prefill of P positions into its share of the cache, then n decode
    steps), held to the stacked layer on ``dev`` (all tp shares, run
    first, kept out of the launch counts and freed): y, conv and h bit
    for bit; each process's two all-reduces a call (x_proj's, out_proj's)
    and one ``affine_chunk`` (the prefill's scan), its mixer bytes
    against the whole mixer's; wall per call (median of ``reps`` after a
    warm one) beside the stacked layer's, the all-reduces' ms."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models import params as PD
    from repro_torch.models.mamba import init_mamba_cache, mamba_block
    from repro_torch.models.shards import StackedShards

    cfg = configs.get(JAMBA_FULL)
    B, P, n, seed = (MAMBA_ROW[k] for k in ("batch", "prompt", "decode",
                                             "seed"))
    mesh, tp, procs = make_host_mesh(*ranks), ranks[1], pool.nprocs
    label = f"jamba_mamba/{ranks[0]}x{ranks[1]}/full"
    x = np.random.default_rng(MAMBA_X_SEED).standard_normal(
        (B, P + n, cfg.d_model), dtype=np.float32)
    with uncounted():
        whole = PD.init_mamba_mixer(cfg, seed, dev)
        whole_bytes = sum(v.numel() * v.element_size()
                          for v in whole.values())
        p = PD.stack_layer(whole, cfg, mesh, "mamba")
        del whole
        xt = torch.from_numpy(x).to(dev).to(PD.torch_dtype(cfg))
        shards = StackedShards(tp)

        def stacked_run():
            cache = init_mamba_cache(cfg, B, xt.dtype, dev,
                                     d_inner=cfg.d_inner // tp)
            cache = {k: v.expand(tp, *v.shape).contiguous()
                     for k, v in cache.items()}
            ys = [mamba_block(cfg, p, xt[:, :P], cache=cache,
                              shards=shards)[0]]
            for t in range(P, P + n):
                ys.append(mamba_block(cfg, p, xt[:, t:t + 1], cache=cache,
                                      shards=shards)[0])
            return torch.cat(ys, dim=1), cache

        stacked_run()  # cold
        walls = wall_s(stacked_run, dev, reps)
        y, cache = stacked_run()
        want = (y.float().cpu().numpy(), cache["conv"].float().cpu().numpy(),
                cache["h"].cpu().numpy())
        del p, xt, y, cache
    torch.cuda.empty_cache()
    grid = (("data", ranks[0]), ("model", tp))
    kw = dict(arch=JAMBA_FULL, ranks=ranks, prefill=P, seed=seed, mesh=grid)
    xs = np.stack([x] * procs)
    pool.call("mamba_block", xs, **kw)  # warm: the shapes' first use
    res = pool.call("mamba_block", xs, repeats=1 + reps, **kw)
    got_y, got_conv, got_h, held = res.outputs
    bits = {"y": True, "conv": True, "h": True}
    for k in range(procs):
        rows, j = moe.held_rows(B, mesh, k), k % tp
        for key, got, w in (("y", got_y[k], want[0][rows]),
                            ("conv", got_conv[k], want[1][j][rows]),
                            ("h", got_h[k], want[2][j][rows])):
            bits[key] &= got.tobytes() == np.ascontiguousarray(w).tobytes()
    if not all(bits.values()):
        raise AssertionError(f"{label}: not the stacked layer's bits "
                             f"{bits}, y off by {_rel(got_y, want[0])}")
    tr = res.transport
    if tr["all_reduce"] != procs * 2 * (1 + n):
        raise AssertionError(f"{label}: {tr['all_reduce']} all-reduces; "
                             f"the mixer {procs} x 2 x {1 + n}")
    if nccl and tr["staged_copies"]:
        raise AssertionError(f"{label}: copies staged under nccl")
    for k, ln in enumerate(res.launches):
        scans = sum(ln.get("affine_chunk", {}).values())
        if dev.type == "cuda" and scans != 1:
            raise AssertionError(f"{label}: process {k} launched {scans} "
                                 f"affine_chunk; the prefill 1")
    _add_launches(child, res)
    norm = cfg.d_model * PD.torch_dtype(cfg).itemsize
    if (held[:, 0] != (whole_bytes - norm) // tp + norm).any():
        raise AssertionError(f"{label}: processes hold {held[:, 0]} "
                             f"bytes of the mixer's {whole_bytes}")
    return {"run": label, "model": cfg.name, "backend": pool.backend,
            "shape": [B, P, n, cfg.d_model], "d_inner": cfg.d_inner,
            "bits_equal": bits, "mixer_bytes": held[:, 0].tolist(),
            "mixer_bytes_whole": whole_bytes,
            "wall_ms": statistics.median(res.seconds[1:]) * 1e3,
            "stacked_wall_ms": statistics.median(walls) * 1e3,
            "all_reduce_per_call": 2,
            "all_reduce_per_process": tr["all_reduce"] // procs,
            "all_reduce_bytes_per_process": tr["all_reduce_bytes"] // procs,
            "all_reduce_s_per_process": tr["all_reduce_s"] / procs,
            "launches_per_process": {"affine_chunk": 1},
            "allocated_peak_bytes": [m["allocated_peak_bytes"]
                                     for m in res.memory],
            "staged_copies": tr["staged_copies"],
            "staging_s": tr["staging_s"]}


def jamba_smoke_row(pool, dev, ranks, *, child: dict) -> dict:
    """Jamba SMOKE whole (attention, MoE, dense FFN and Mamba, fp32) over
    ``pool``'s processes as ``ranks``, each layer split over "model" (at
    (2, 2) also over "data", FSDP): the stacked model's tokens and
    prefill logits on ``dev`` bit for bit (run first, out of the launch
    counts), one ``affine_chunk`` a Mamba layer and prefill a process,
    the all-reduces and the weights' all-gathers the code's counts."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import prompts_for, serve_loop, serve_procs
    from repro_torch.models import moe
    from repro_torch.models import params as PD
    from repro_torch.models.model import Model

    cfg = configs.get_smoke(JAMBA_FULL)
    B, P, G = 4, 16, 6
    label = f"jamba_smoke/{ranks[0]}x{ranks[1]}"
    with uncounted():
        model = Model(cfg, ranks, device=dev)
        res = serve_loop(model, model.init_params(0),
                         prompts_for(cfg, B, P, 0), G)
        want = res.tokens, res.prefill_logits.float().cpu().numpy()
        del model, res
    got = serve_procs(pool, arch=JAMBA_FULL, smoke=True, batch=B,
                      prompt_len=P, gen=G, seed=0, ranks=ranks)
    logits = np.asarray(got["prefill_logits"], np.float32)
    if not np.array_equal(got["tokens"], want[0]) or \
            logits.tobytes() != want[1].tobytes():
        raise AssertionError(f"{label}: tokens or prefill logits differ "
                             f"from the stacked run's by "
                             f"{_rel(logits, want[1])}")
    r = got["result"]
    mesh = make_host_mesh(*ranks)
    ws = {S: ranks[0] > 1 and moe.moe_groups(cfg, B, S, mesh).ws
          for S in (P, 1)}
    by_shape = ((P, 1), (1, G - 1))
    split = PD.plan_split(cfg, mesh)
    per_call = PD.all_reduces(cfg, split)
    want = pool.nprocs * sum(c * PD.all_reduces(cfg, split, ws=ws[S])
                             for S, c in by_shape)
    if r.transport["all_reduce"] != want:
        raise AssertionError(f"{label}: {r.transport['all_reduce']} "
                             f"all-reduces, the code's {want}")
    for k, t in enumerate(r.traffic):
        want = sum(c * PD.fsdp_gathers(cfg, mesh, k, ws=ws[S])["calls"]
                   for S, c in by_shape)
        if t["fsdp_gather"] != want:
            raise AssertionError(f"{label}: process {k} gathered "
                                 f"{t['fsdp_gather']} weight buckets over "
                                 f"data, the code's {want}")
    n_mamba = sum(s.kind == "mamba" for s in cfg.pattern()) * cfg.n_repeats
    for k, ln in enumerate(r.launches):
        scans = sum(ln.get("affine_chunk", {}).values())
        if dev.type == "cuda" and scans != n_mamba:
            raise AssertionError(f"{label}: process {k} launched {scans} "
                                 f"affine_chunk; the path {n_mamba}")
    _add_launches(child, r)
    return {"run": label, "model": cfg.name, "dtype": cfg.dtype,
            "tokens_equal": True, "prefill_logits_bits_equal": True,
            "all_reduce_per_call": per_call,
            "fsdp_gather_by_process": [t["fsdp_gather"] for t in r.traffic],
            "param_bytes": got["param_bytes"],
            "launches_per_process": {"affine_chunk": n_mamba}}


def mixer_rows(pool, dev, layouts, *, child: dict) -> dict:
    """Over ``pool``: RWKV6-1.6B served at full width and depth with its
    wkv heads and channel mix split over the model processes, at each
    (data, model) grid of ``layouts`` (:func:`serve_rows`); then at
    (1, 4) Jamba-1.5-Large's Mamba mixer at full width
    (:func:`mamba_mixer_row`) and Jamba SMOKE whole
    (:func:`jamba_smoke_row`)."""
    rwkv = serve_rows(pool, dev, [(RWKV_FULL, r) for r in layouts],
                      child=child)
    t0 = time.perf_counter()
    mamba = mamba_mixer_row(pool, dev, (1, 4),
                            nccl=pool.backend == "nccl", child=child)
    emit({"mixer_row": mamba})
    smoke = jamba_smoke_row(pool, dev, (1, 4), child=child)
    return {"rwkv": rwkv, "jamba_mamba": mamba, "jamba_smoke": smoke,
            "jamba_s": time.perf_counter() - t0}


def phase_procs(dev, *, grid=(4, 2), dispatch_grid=(8, 8), algos=CP_ALGOS,
                dispatch_algos=("auto", "123"), reps=3) -> dict:
    """The cp scans and the MoE dispatch offsets over ranks held by
    processes on the one card, over gloo (messages staged through the
    host): ``cp_ssm_scan`` at Jamba's width and ``cp_wkv_scan`` at
    RWKV6-1.6B's, p = 8 as 4 processes of 2 ranks, forward and forward
    and backward, each carry algorithm; ``dispatch_slots`` at
    Qwen1.5-MoE-A2.7B's 64 ranks of 4096 tokens as 8 processes of 8;
    then the serving rows and the mixer rows at (1, 4)."""
    child: dict = {}
    line = consumers(dev, grid, dispatch_grid, backend="gloo", algos=algos,
                     dispatch_algos=dispatch_algos, reps=reps, child=child,
                     keep=grid[0] == 4)
    with row_pool(dev, "gloo") as pool:
        served = serve_rows(pool, dev, SERVE_ROWS, child=child)
        fsdp = fsdp_rows(pool, dev, child=child)
        ws = ws_rows(pool, dev, child=child, fsdp=fsdp["serve"])
        mixers = mixer_rows(pool, dev, ((1, 4),), child=child)
        train = train_rows(pool, dev, child=child)
        fsdp_sp = fsdp_sp_rows(pool, dev, child=child)
    return {"phase": "procs", "device": str(dev),
            "models": {"cp_ssm": "jamba-1.5-large-398b",
                       "cp_wkv": "rwkv6-1.6b", "dispatch": QWEN,
                       "serve": [QWEN, LLAMA, RWKV_FULL],
                       "mixer": JAMBA_FULL, "train": [RWKV_FULL]},
            **line, "serve": served, "fsdp": fsdp, "decode_ws": ws,
            "mixers": mixers,
            "train": train, "fsdp_sp": fsdp_sp, "reduced": REDUCED_GLOO,
            "child_launches": child}


# the serving rows, at full width, each (model, (data, model) grid): four
# gloo processes on one card hold Qwen's 7.58 GB each at (1, 4), Llama's
# 4.02 GB, the stacked run freed before they start
SERVE_ROWS = ((QWEN, (1, 4)), (LLAMA, (1, 4)))
# the FSDP rows: at (2, 2) every weight is split over "data" as well
# (Qwen 7.575 GB a process, RWKV6 0.890, Llama 4.016) and each layer
# gathered at its use; over gloo on one card the first two
FSDP_ROWS = ((QWEN, (2, 2)), (RWKV_FULL, (2, 2)), (LLAMA, (2, 2)))
FSDP_GLOO = FSDP_ROWS[:2]
# over gloo on one card these rows run at this depth and generate this
# many tokens, full width: their staged collectives (all-reduces of 49-109
# ms in prefill, weight gathers of up to 0.3 GB a layer) took about 7.5
# min of the script at full depth (Qwen 4 of 24 and Llama 6 of 32, to
# pay for the fsdp_sp gloo rows: the whole script took 1045 s on one
# card before them)
GLOO_DEPTH = {(QWEN, (1, 4)): 4, (QWEN, (2, 2)): 4, (LLAMA, (1, 4)): 6,
              (RWKV_FULL, (2, 2)): 8}
GLOO_GEN = {(QWEN, (2, 2)): 8, (RWKV_FULL, (2, 2)): 8}
REDUCED_GLOO = (f"over gloo on one card Qwen1.5-MoE-A2.7B serves "
                f"{GLOO_DEPTH[QWEN, (1, 4)]} of 24 layers, Llama-3-8B "
                f"{GLOO_DEPTH[LLAMA, (1, 4)]} of 32 and RWKV6-1.6B at (2, 2) "
                f"{GLOO_DEPTH[RWKV_FULL, (2, 2)]} of 24, full width; the "
                f"(2, 2) rows 4 x (512 + {GLOO_GEN[QWEN, (2, 2)]}) tokens; "
                f"RWKV6-1.6B at (1, 4) full depth; Llama-3-8B at (2, 2) on "
                f"four cards only; Jamba-1.5-Large one Mamba mixer, full "
                f"width, and its SMOKE whole")


def fsdp_rows(pool, dev, *, child: dict) -> dict:
    """The FSDP rows over ``pool``: :data:`FSDP_ROWS` over NCCL, the
    first two over gloo on one card (:func:`serve_rows`), then Jamba
    SMOKE at (2, 2), every layer kind split over both axes
    (:func:`jamba_smoke_row`)."""
    rows = FSDP_ROWS if pool.backend == "nccl" else FSDP_GLOO
    served = serve_rows(pool, dev, rows, child=child)
    smoke = jamba_smoke_row(pool, dev, (2, 2), child=child)
    emit({"fsdp_row": smoke})
    return {"serve": served, "jamba_smoke": smoke}


# decode_ws (weights stationary, the activations' d over "data", the batch
# replicated outside the mixers' cores): the FSDP rows' models at (2, 2),
# over NCCL at full depth (FSDP_ROWS), over gloo on one card at their
# GLOO_DEPTH (FSDP_GLOO), then Jamba SMOKE (2, 2) in fp32
WS = {"sharding_strategy": "decode_ws"}
WS_KINDS = ("all_reduce", "all_gather", "all_to_all", "fsdp_gather",
            "ws_reduce", "ws_gather")


def ws_calls(cfg, mesh, k: int, B: int, by_shape, prefix: int = 0) -> dict:
    """Process k's collectives of serving calls ``by_shape`` ((S, calls):
    prefills with ``last_only``, decode steps at S = 1) under decode_ws,
    by executor kind (``params.ws_collectives``): {kind: [calls,
    bytes]}."""
    from repro_torch.models import params as PD

    out: dict = {}
    for S, n in by_shape:
        for (kind, _), v in PD.ws_collectives(cfg, mesh, k, batch=B,
                                              seq=S).items():
            t = out.setdefault(kind, [0, 0])
            t[0] += n * v["calls"]
            t[1] += n * v["bytes"]
    return out


def ws_pool_row(pool, dev, name: str, ranks, *, child: dict,
                fsdp: dict | None = None, smoke: bool = False) -> dict:
    """``name`` served under decode_ws over ``pool``'s processes as the
    (data, model) grid ``ranks`` (over gloo at :data:`GLOO_DEPTH` and
    :data:`GLOO_GEN`; ``smoke``: its SMOKE whole, fp32, 4 × (16 + 6)),
    held to the stacked decode_ws twin on ``dev`` (run first, out of the
    launch counts): the served tokens equal, every one; the prefill
    logits bit for bit (SMOKE and RWKV6) or within bf16's spacing; each
    process holding its share (``share_nbytes``), gathering no dense
    weight, its collectives by kind ``ws_collectives``' (calls and bytes;
    their ms from the executor's timers), its routing, round-kernel and
    ``affine_chunk`` launches the path's.  Prefill ms, decode p50 and
    p99, busy and idle by process, GB a process (parameters, peak), and,
    where ``fsdp`` (the same model's FSDP row of this run) is given, its
    prefill and decode beside."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import prompts_for, serve_loop, serve_procs
    from repro_torch.models import params as PD
    from repro_torch.models.model import Model
    from repro_torch.serve.metrics import percentile

    nccl = pool.backend == "nccl"
    key = (name, tuple(ranks))
    over = dict(WS)
    if not nccl and not smoke and key in GLOO_DEPTH:
        over["n_layers"] = GLOO_DEPTH[key]
    get = configs.get_smoke if smoke else configs.get
    cfg = get(name, **over)
    if smoke:
        B, P, G = 4, 16, 6
    else:
        B, P, G = (MOE_SERVE[k] for k in ("batch", "prompt", "gen"))
        G = G if nccl else GLOO_GEN.get(key, G)
    mesh, n = make_host_mesh(*ranks), pool.nprocs
    on_card = pool.device.type == "cuda"
    short = {QWEN: "qwen", LLAMA: "llama", RWKV_FULL: "rwkv",
             JAMBA_FULL: "jamba"}[name]
    label = f"ws/{short}/{ranks[0]}x{ranks[1]}/" + \
        ("smoke" if smoke else "full")
    t0 = time.perf_counter()
    if smoke:
        with uncounted():
            model = Model(cfg, ranks, device=dev)
            res = serve_loop(model, model.init_params(0),
                             prompts_for(cfg, B, P, 0), G)
            stacked = {"tokens": res.tokens, "prefill_logits":
                       res.prefill_logits.float().cpu().numpy(),
                       "param_bytes": PD.nbytes(model.params)}
            del model, res
    else:
        stacked = serve_stacked(dev, name, ranks, over, G, layer=False)
    stacked_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = serve_procs(pool, arch=name, smoke=smoke, batch=B, prompt_len=P,
                      gen=G, seed=0, ranks=ranks, trace=not smoke,
                      warm=not smoke, **over)
    pool_s = time.perf_counter() - t0
    res = got["result"]
    if not np.array_equal(got["tokens"], stacked["tokens"]):
        raise AssertionError(f"{label}: served tokens differ from the "
                             f"stacked twin's, first at (request, step) "
                             f"{parted(got['tokens'], stacked['tokens'])}")
    logits = np.asarray(got["prefill_logits"], np.float32)
    if not np.isfinite(logits).all():
        raise AssertionError(f"{label}: non-finite prefill logits")
    bits = logits.tobytes() == stacked["prefill_logits"].tobytes()
    rel = _rel(logits, stacked["prefill_logits"])
    if rel > BF16_REL or ((smoke or name == RWKV_FULL) and not bits):
        raise AssertionError(f"{label}: prefill logits off the stacked "
                             f"twin's by {rel} relative")
    # (S, calls): the warm prefill and step, the loop's prefill and G − 1
    # steps, on the card the busy trace's two prefills and two steps
    traced = 2 if on_card and not smoke else 0
    warm = 0 if smoke else 1
    by_shape = ((P, 1 + warm + traced), (1, G - 1 + warm + traced))
    calls = sum(c for _, c in by_shape)
    n_moe = sum(s.use_moe for s in cfg.pattern()) * cfg.n_repeats
    n_scan = sum(s.kind in ("rwkv", "mamba") for s in cfg.pattern()) \
        * cfg.n_repeats
    want_r = n_moe * calls
    want_k = sum(c * n_moe * (_ir_launches(pl) if pl is not None else 0)
                 for S, c in by_shape
                 for pl in (moe_layer_plan(cfg, B, S, ranks),)) \
        if n_moe else 0
    want_s = n_scan * by_shape[0][1]
    for k, ln in enumerate(res.launches):
        routed = sum(ln.get("moe_routing", {}).values())
        rounds = sum(v for w in ROUND_KERNELS
                     for v in ln.get(w, {}).values())
        scans = sum(ln.get("affine_chunk", {}).values())
        if on_card and (routed, rounds, scans) != (want_r, want_k, want_s):
            raise AssertionError(f"{label}: process {k} launched {routed} "
                                 f"routing, {rounds} round and {scans} "
                                 f"affine_chunk kernels; the path "
                                 f"{(want_r, want_k, want_s)}")
    _add_launches(child, res)
    held = np.asarray(res.outputs[3])
    by_process = []
    for k, t in enumerate(res.traffic):
        share = PD.share_nbytes(cfg, mesh, k)
        if held[k].tolist() != [share["dense"], share["experts"]]:
            raise AssertionError(f"{label}: process {k} holds "
                                 f"{held[k].tolist()}, its share {share}")
        want = ws_calls(cfg, mesh, k, B, by_shape)
        have = {kind: [t[kind], t[kind + "_bytes"]] for kind in WS_KINDS
                if t[kind]}
        if have != {kind: v for kind, v in want.items() if v[0]}:
            raise AssertionError(f"{label}: process {k}'s collectives "
                                 f"{have}; ws_collectives' {want}")
        by_process.append({kind: {"calls": t[kind],
                                  "GB": t[kind + "_bytes"] / 1e9,
                                  "ms": t[kind + "_s"] * 1e3}
                           for kind in WS_KINDS if t[kind]})
    busy = np.asarray(res.outputs[4]) if not smoke else None
    p50 = percentile(got["step_s"], 50)

    def listed(a):  # NaN (no profiler reading) as null
        return [None if np.isnan(v) else float(v) for v in a]

    per_call = {kind: {f"{kk}/{ax}": v for (kk, ax), v in
                       PD.ws_collectives(cfg, mesh, 0, batch=B,
                                         seq=S).items()}
                for S, kind in ((P, "prefill"), (1, "decode"))}
    row = {"run": label, "model": cfg.name, "backend": pool.backend,
           "layers": cfg.n_layers, "dtype": cfg.dtype, "tokens": [B, P, G],
           "tokens_equal": True, "prefill_logits_bits_equal": bits,
           "prefill_logits_max_rel_of_row_max": rel,
           "prefill_ms": got["prefill_s"] * 1e3,
           "step_p50_ms": p50 * 1e3,
           "step_p99_ms": percentile(got["step_s"], 99) * 1e3,
           "model_calls": calls, "collectives_per_call": per_call,
           "collectives_by_process": by_process,
           "weight_gathers_by_process": [t["fsdp_gather"]
                                         for t in res.traffic],
           "param_GB_by_process": [float(h.sum()) / 1e9 for h in held],
           "peak_GB_by_process": [None if m["allocated_peak_bytes"] is None
                                  else m["allocated_peak_bytes"] / 1e9
                                  for m in res.memory],
           "launches_per_process": {"moe_routing": want_r,
                                    "round_kernels": want_k,
                                    "affine_chunk": want_s},
           "staged_copies": res.transport["staged_copies"],
           "stacked_s": stacked_s, "pool_s": pool_s}
    if busy is not None:
        row.update({
            "stacked_prefill_ms": stacked["prefill_ms"],
            "stacked_step_p50_ms": stacked["step_p50_ms"],
            "prefill_busy_ms": listed(busy[:, 0] * 1e3),
            "prefill_idle_share": listed(1 - busy[:, 0] / got["prefill_s"]),
            "decode_busy_ms": listed(busy[:, 1] * 1e3),
            "decode_idle_share": listed(1 - busy[:, 1] / p50)})
    if "n_layers" in over:
        row["reduced"] = (f"{cfg.n_layers} of {configs.get(name).n_layers} "
                          f"layers, full width, {B} x ({P} + {G}) tokens: "
                          f"gloo's staged collectives on one card")
    if fsdp is not None:
        row["fsdp"] = {k: fsdp[k] for k in ("run", "prefill_ms",
                                            "step_p50_ms", "step_p99_ms")}
    if nccl and res.transport["staged_copies"]:
        raise AssertionError(f"{label}: copies staged under nccl")
    emit({"ws_row": row})  # each row as it is done
    del stacked
    torch.cuda.empty_cache()
    return row


def ws_rows(pool, dev, *, child: dict, fsdp=()) -> dict:
    """The decode_ws rows over ``pool``: :data:`FSDP_ROWS` over NCCL,
    :data:`FSDP_GLOO` and Jamba SMOKE (2, 2) over gloo on one card
    (:func:`ws_pool_row`), each beside its FSDP row of ``fsdp`` (this
    run's :func:`fsdp_rows` serving rows)."""
    nccl = pool.backend == "nccl"
    by_run = {r["run"]: r for r in fsdp}
    short = {QWEN: "qwen", LLAMA: "llama", RWKV_FULL: "rwkv"}
    out = {"serve": [ws_pool_row(
        pool, dev, name, ranks, child=child,
        fsdp=by_run.get(f"{short[name]}/{ranks[0]}x{ranks[1]}/full"))
        for name, ranks in (FSDP_ROWS if nccl else FSDP_GLOO)]}
    if not nccl:
        out["jamba_smoke"] = ws_pool_row(pool, dev, JAMBA_FULL, (2, 2),
                                         child=child, smoke=True)
    return out


def phase_ws(dev) -> dict:
    """``--decode-ws-only``: the FSDP rows (:func:`fsdp_rows`), then the
    decode_ws rows beside them (:func:`ws_rows`): over gloo on this
    card, or where four cards are present over NCCL one process a
    card."""
    child: dict = {}
    line = {"phase": "decode_ws", "device": str(dev), "card": card_info()}
    cards = torch.cuda.device_count() >= 4
    with row_pool(dev, "nccl" if cards else "gloo") as pool:
        line["fsdp"] = fsdp_rows(pool, dev, child=child)
        line["decode_ws"] = ws_rows(pool, dev, child=child,
                                    fsdp=line["fsdp"]["serve"])
    if not cards:
        line["reduced"] = REDUCED_GLOO
    return {**line, "child_launches": child}


# training over processes, full width, bf16, seed 0, a global
# batch of 4 rows of 512 tokens: (model, (data, model) grid, layers (None:
# all), steps).  Over gloo on one card RWKV6-1.6B at (2, 2) on 2 of its
# 24 layers, 2 steps (the serving rows before it keep their depth); over
# NCCL on four cards RWKV6-1.6B at full depth and Qwen and
# Llama cut so that the stacked run they are held to fits one card (bf16
# weights and gradients, fp32 moments, AdamW's fp32 temporaries of the
# largest leaf: Qwen at 6 layers ran out of the 80 GB, 68.2 GiB allocated
# when the update asked 4.12 more, with a pool process on the card)
TRAIN = {"batch": 4, "seq": 512, "seed": 0}
TRAIN_GLOO = ((RWKV_FULL, (2, 2), 2, 2),)
TRAIN_NCCL = ((RWKV_FULL, (2, 2), None, 4), (RWKV_FULL, (1, 4), None, 4),
              (QWEN, (2, 2), 5, 4), (LLAMA, (1, 4), 8, 4))
TRAIN_LOSS_TOL = (1e-2, 2e-2)  # step 0's loss, every step's, relative
# step 0's gradient norm of each leaf against the stacked run's, relative:
# a sum over two processes missed (about 1/sqrt(2) of the norm) or
# doubled moves its leaf's norm by about 29 % or 100 %.  RWKV6's bonus_u
# is held in fp32 only (:func:`grad_witness`): at step 0 it is zero, each
# wkv head's first output is 0 and its per-head norm scales that token's
# gradient by 1/sqrt(eps) = 1000 into u alone, and its bf16 gradient is
# rounding's (the JAX package's bf16 gradient is as far off its float64
# one)
LEAF_NORM_RTOL = 1e-1
REDUCED_TRAIN = ("trained over processes at full width, B = 4, S = 512: "
                 "over gloo on one card RWKV6-1.6B at (2, 2) on 2 of its "
                 "24 layers, 2 steps; over NCCL on four cards RWKV6-1.6B "
                 "at (2, 2) and (1, 4) at full depth, 4 steps, "
                 "Qwen1.5-MoE-A2.7B at (2, 2) on 5 of 24 layers and "
                 "Llama-3-8B at (1, 4) on 8 of 32, 4 steps each, so that "
                 "the stacked run each is held to fits one card; Jamba "
                 "SMOKE whole, fp32, (2, 2), 3 steps")


def _train_argv(name, ranks, steps, dev, smoke=False):
    return ["--arch", name, "--steps", str(steps), "--batch",
            str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]), "--seed",
            str(TRAIN["seed"]), "--data-mesh", str(ranks[0]),
            "--model-mesh", str(ranks[1]), "--device", str(dev),
            "--log-every", "1000", *(["--smoke"] if smoke else [])]


def leaf_norms(tree) -> dict:
    """{leaf path: its L2 norm} of a parameter-shaped tree."""
    from repro_torch import _tree
    from repro_torch.models import params as PD

    return {"/".join(map(str, path)): float(torch.norm(g.double()))
            for path, g in zip(PD.leaf_paths(tree), _tree.leaves(tree))}


def train_stacked(dev, name, ranks, over, steps) -> dict:
    """The stacked training run of ``name`` (``over``: config overrides)
    at ``ranks`` on one card, out of the launch counts and freed before
    it returns: each step's loss and grad_norm, the step ms p50, the
    card's peak and step 0's gradient norm by leaf."""
    from repro_torch.launch import train as train_lib
    from repro_torch.serve.metrics import percentile

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    norms = {}

    def first(step, grads):
        if not norms:
            norms.update(leaf_norms(grads))

    with uncounted():
        args = train_lib.parse_args(_train_argv(name, ranks, steps, dev))
        res = train_lib.run(args, quiet=True, over=over, on_grads=first)
        sync(dev)
    logs = res.logs
    out = {"losses": [log["loss"] for log in logs],
           "grad_norms": [log["grad_norm"] for log in logs],
           "step_p50_ms": percentile([log["seconds"] for log in logs[1:]],
                                     50) * 1e3,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "leaf_norms": norms}
    del res, logs
    torch.cuda.empty_cache()
    return out


def check_leaf_norms(label, got: dict, want: dict) -> dict:
    """Step 0's gradient norm of every leaf but bonus_u within
    :data:`LEAF_NORM_RTOL` of the stacked run's; returns the largest gap,
    its leaf, and bonus_u's two norms."""
    gaps = {path: abs(got[path] - w) / w for path, w in want.items()
            if w > 0 and not path.endswith("bonus_u")}
    worst = max(gaps, key=gaps.get)
    if gaps[worst] > LEAF_NORM_RTOL:
        raise AssertionError(f"{label}: step 0's gradient norm of "
                             f"{worst} {got[worst]}, the stacked run's "
                             f"{want[worst]}")
    return {"worst_leaf": worst, "worst_rel": gaps[worst],
            "bonus_u": [[got[p], w] for p, w in want.items()
                        if p.endswith("bonus_u")]}


def check_train_collectives(label, got, cfg, mesh) -> dict:
    """Every process's collectives in each step are
    ``params.train_collectives``' (calls and bytes by kind); returns each
    kind's ms a step by process (the median over the steps after the
    first) and its calls and bytes."""
    from repro_torch.models import params as PD

    out = {}
    for k, steps in enumerate(got["collectives"]):
        want = PD.train_collectives(cfg, mesh, k, batch=TRAIN["batch"],
                                    seq=TRAIN["seq"])
        for i, step in enumerate(steps):
            have = {kind: {"calls": c["calls"], "bytes": c["bytes"]}
                    for kind, c in step.items()}
            if have != want:
                raise AssertionError(f"{label}: process {k} step {i} moved "
                                     f"{have}, train_collectives {want}")
        for kind, c in want.items():
            if not c["calls"]:
                continue
            ms = [st[kind]["s"] * 1e3 for st in steps[1:] or steps]
            row = out.setdefault(kind, {"calls": c["calls"],
                                        "bytes": c["bytes"], "ms": []})
            row["ms"].append(statistics.median(ms))
    return out


def train_pool_row(pool, dev, name, ranks, layers, steps, *,
                   child: dict, strategy: str | None = None) -> dict:
    """One training row: the stacked run at ``ranks`` on this card first
    (:func:`train_stacked`), then ``launch.train.train_procs`` over
    ``pool`` on the same weights, from the seed, and the same batches:
    step 0's loss within 1e-2 of the stacked run's and every step's
    finite and within 2e-2 (bf16 over other summation orders), step 0's
    gradient norm of each leaf (summed over the processes' shares) within
    :data:`LEAF_NORM_RTOL` of the stacked run's, the collectives
    ``params.train_collectives``', the wkv and Mamba scans'
    and the MoE routing's launches the path's; the step ms p50
    (min-max) of the slowest process, each process's busy and idle
    share (one more step under the profiler), the collectives' ms by
    kind, and parameter, moment and peak GB by process.  With
    ``strategy`` (fsdp_sp) the config's sharding strategy: then the
    sequence is split over the model processes, and the wkv carry's
    rounds and messages are held to its plan (:func:`carry_check`)."""
    from repro_torch import configs
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as PD
    from repro_torch.serve.metrics import percentile

    over = {} if layers is None else {"n_layers": layers}
    if strategy is not None:
        over["sharding_strategy"] = strategy
    label = f"train/{name}/{ranks[0]}x{ranks[1]}" + \
        ("" if strategy is None else f"/{strategy}")
    t0 = time.perf_counter()
    stacked = train_stacked(dev, name, ranks, over, steps)
    stacked_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = train_lib.train_procs(pool, _train_argv(name, ranks, steps,
                                                  "cpu"),
                                over=over, trace=True, norms=True)
    pool_s = time.perf_counter() - t0
    losses = [m["loss"] for m in got["metrics"]]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, stacked["losses"])]
    if not (np.isfinite(losses).all() and rel[0] <= TRAIN_LOSS_TOL[0]
            and max(rel) <= TRAIN_LOSS_TOL[1]):
        raise AssertionError(f"{label}: losses {losses}, the stacked run's "
                             f"{stacked['losses']} (relative {rel})")
    cfg = configs.get(name, **over)
    mesh = make_host_mesh(*ranks)
    coll = check_train_collectives(label, got, cfg, mesh)
    norms = check_leaf_norms(label, got["leaf_norms"],
                             stacked["leaf_norms"])
    n_scan = sum(s.kind in ("rwkv", "mamba") for s in cfg.pattern()) \
        * cfg.n_repeats
    n_moe = sum(s.use_moe for s in cfg.pattern()) * cfg.n_repeats
    busy = 2 if pool.device.type == "cuda" else 0  # steps busy_s runs
    done = steps + busy
    r = got["result"]
    # the cp carry: two affine_chunk launches a layer (summaries and
    # rescan) forward and recomputed, two affine_chunk_bwd backward
    cp = 2 if PD.seq_split(cfg, mesh) else 1
    for k, ln in enumerate(r.launches):
        want = {"affine_chunk": 2 * cp * n_scan * done,
                "affine_chunk_bwd": cp * n_scan * done,
                "moe_routing": 2 * n_moe * done}
        have = {w: sum(ln.get(w, {}).values()) for w in want}
        if pool.device.type == "cuda" and have != want:
            raise AssertionError(f"{label}: process {k} launched {have}, "
                                 f"the path {want}")
    _add_launches(child, r)
    warm = got["step_s"][1:] or got["step_s"]
    by_proc = got["step_s_by_process"]
    row = {"run": label, "model": cfg.name, "layers": cfg.n_layers,
           "dtype": cfg.dtype, **TRAIN, "steps": steps,
           "losses": losses, "stacked_losses": stacked["losses"],
           "loss_rel": rel,
           "grad_norms": [m["grad_norm"] for m in got["metrics"]],
           "stacked_grad_norms": stacked["grad_norms"],
           "step_p50_ms": percentile(warm, 50) * 1e3,
           "step_min_ms": min(warm) * 1e3, "step_max_ms": max(warm) * 1e3,
           "stacked_step_p50_ms": stacked["step_p50_ms"],
           "stacked_peak_gb": stacked["peak_gb"],
           "step0_leaf_norms": norms,
           "busy_ms_by_process": [b * 1e3 for b in got["busy_s"]],
           "idle_by_process": [
               1.0 - b / percentile(t[1:] or t, 50)
               for b, t in zip(got["busy_s"], by_proc)],
           "collectives": coll,
           # collect_stats sees the forward's and the backward's rounds;
           # on the card the remat recompute runs on autograd's device
           # thread, outside it (its messages are counted all the same)
           **({"carry": carry_check(label, r, cfg, ranks,
                                    (2 if busy else 3) * done,
                                    3 * (1 + busy))}
              if cp == 2 and n_scan else {}),
           "params_gb": [b["params"] / 1e9 for b in got["bytes"]],
           "moments_gb": [b["moments"] / 1e9 for b in got["bytes"]],
           "peak_gb": [None if b is None else b / 1e9
                       for b in got["peak_bytes"]],
           "stacked_s": stacked_s, "pool_s": pool_s}
    emit({"train_row": row})
    return row


def carry_check(label, res, cfg, ranks, runs: int, sent: int) -> dict:
    """The wkv carry of a run whose sequence is split over the model
    processes (``res``, a ``DistResult``; ``runs`` runs of each layer's
    carry, ``sent`` of them after the executor's last traffic reset,
    which ``train.run`` makes at each step): process 0's rounds are
    ``runs`` × the layers × its plan's at p = tp, and the processes'
    point-to-point messages and bytes ``sent`` × the layers ×
    ``expected_messages`` of that plan laid over the grid (the carry is
    the only point-to-point traffic).  Returns them."""
    from repro_torch.core import schedule as sch
    from repro_torch.core.scan_api import plan
    from repro_torch.models import context_parallel as cpl
    from repro_torch.models.rwkv import HEAD_DIM

    D, tp = ranks
    B_k, width = TRAIN["batch"] // D, cfg.d_model * HEAD_DIM
    pl = plan(cpl._carry_spec(cfg.scan_spec, None), tp,
              nbytes=cpl.carry_nbytes(B_k, width, HEAD_DIM, 4))
    layers = sum(s.kind == "rwkv" for s in cfg.pattern()) * cfg.n_repeats
    one = (torch.zeros(B_k, width), torch.zeros(B_k, width))
    msgs, nbytes = sch.expected_messages(
        sch.on_mesh(pl.schedule(), ("model",),
                    (("data", D), ("model", tp))), one)
    got = {"algorithm": pl.algorithm, "plan_rounds": pl.rounds,
           "rounds": res.stats["rounds"], "msgs": res.transport["msgs"],
           "bytes": res.transport["bytes"]}
    n = sent * layers
    if (got["rounds"], got["msgs"], got["bytes"]) != \
            (runs * layers * pl.rounds, n * msgs, n * nbytes):
        raise AssertionError(f"{label}: the carry ran {got}, its plan "
                             f"{runs} x {layers} x {pl.rounds} rounds and "
                             f"{n} x ({msgs} messages, {nbytes} B)")
    return got


def jamba_train_row(pool, dev, ranks, *, child: dict, name=None,
                    over=None) -> dict:
    """Jamba SMOKE whole (fp32; attention, MoE, dense FFN and Mamba, each
    split) trained 3 steps over ``pool`` as ``ranks``, held as on the
    CPU against the stacked run on this card on the same parameters
    before each step (the processes' own, joined): each step's loss and
    grad_norm within rtol 1e-5, step 0's gradients within 1e-5·max|g| +
    1e-4·|g| (``tests/test_torch_train_procs.py`` says why not 1e-6),
    and how many entries pass 1e-6·max|g| + 1e-4·|g|.  ``name`` and
    ``over`` (config overrides) hold another SMOKE config so."""
    from repro_torch import _tree
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as PD
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    B, S, steps = 4, 16, 3
    name = JAMBA_FULL if name is None else name
    label = f"train/{name}_smoke/{ranks[0]}x{ranks[1]}" + \
        "".join(f"/{v}" for v in (over or {}).values())
    argv = ["--arch", name, "--smoke", "--steps", str(steps),
            "--batch", str(B), "--seq", str(S), "--data-mesh",
            str(ranks[0]), "--model-mesh", str(ranks[1]), "--device", "cpu"]
    got = train_lib.train_procs(pool, argv, grads=True, params=True,
                                over=over)
    cfg = configs.get_smoke(name, **(over or {}))
    mesh = make_host_mesh(*ranks)
    coll = {}
    for k, per in enumerate(got["collectives"]):
        want = PD.train_collectives(cfg, mesh, k, batch=B, seq=S)
        if any({kind: {"calls": c["calls"], "bytes": c["bytes"]}
                for kind, c in st.items()} != want for st in per):
            raise AssertionError(f"{label}: process {k}'s collectives are "
                                 f"not train_collectives'")
        coll = {kind: c["calls"] for kind, c in want.items() if c["calls"]}
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S,
                                  global_batch=B))
    off = total = 0
    worst = {"loss": 0.0, "grad_norm": 0.0, "grad_excess": 0.0}
    with uncounted():
        tree = PD.init_params(cfg, 0, dev)
        for step in range(steps):
            if step:
                shares = [_tree.tree_map(lambda a, i=step - 1: a[i], p)
                          for p in got["params"]]
                tree = PD.join_shares(shares, cfg, mesh)
                tree = _tree.tree_map(lambda t: t.to(dev), tree)
            model = Model(cfg, ranks, device=dev)
            params = model.load_params(tree, trainable=True)
            b = data.batch(step)
            batch = {k: torch.from_numpy(b[k]).to(dev)
                     for k in ("tokens", "labels")}
            loss, _ = model.loss(params, batch)
            grads = torch.autograd.grad(loss, _tree.leaves(params))
            m = got["metrics"][step]
            for key, want in (("loss", float(loss.detach())),
                              ("grad_norm", float(adamw.global_norm(grads)))):
                rel = abs(m[key] - want) / abs(want)
                worst[key] = max(worst[key], rel)
                if rel > 1e-5:
                    raise AssertionError(f"{label}: step {step} {key} "
                                         f"{m[key]}, the stacked run's "
                                         f"{want}")
            if step == 0:
                joined = _tree.leaves(PD.join_shares(got["grads"], cfg,
                                                     mesh))
                for g, w in zip(joined, grads):
                    w = w.detach().double().cpu().numpy()
                    g = g.double().numpy()
                    err = np.abs(g - w) - 1e-4 * np.abs(w)
                    top = np.abs(w).max()
                    worst["grad_excess"] = max(worst["grad_excess"],
                                               float(err.max() / top))
                    off += int((err > 1e-6 * top).sum())
                    total += w.size
            del model, params, grads
    if worst["grad_excess"] > 1e-5:
        raise AssertionError(f"{label}: step 0's gradients {worst} of the "
                             f"leaf's largest past 1e-4·|g|")
    _add_launches(child, got["result"])
    row = {"run": label, "model": cfg.name, "dtype": cfg.dtype,
           "steps": steps, "losses": [m["loss"] for m in got["metrics"]],
           "worst_rel": worst, "grad_entries_past_bar": [off, total],
           "collective_calls_a_step": coll}
    emit({"train_row": row})
    return row


def grad_witness(pool, dev) -> dict:
    """Where RWKV6-1.6B's bf16 step-0 gradients part, at full width, B =
    4, S = 512, seed 0: (a) the stacked run at full depth in fp32 at (1,
    1) and in bf16 at (1, 1), (2, 2) and (1, 4), each bf16 leaf's norm
    and its relative L2 distance from the fp32 gradient (bonus_u's and
    the largest other); (b) the processes over ``pool`` (gloo, this
    card) at (2, 2) in fp32 on 4 layers against the stacked fp32 run at
    (2, 2): every leaf's norm within 1e-3, bonus_u's included, and each
    leaf's largest entry error over its largest entry."""
    from repro_torch import _tree
    from repro_torch import device as device_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as PD

    def paths(tree):
        return ["/".join(map(str, p)) for p in PD.leaf_paths(tree)]

    def grads(ranks, dtype, layers=None):
        """Step 0's gradient tree of the stacked run, in fp32."""
        over = {"dtype": dtype, **({} if layers is None
                                   else {"n_layers": layers})}
        got = []

        def first(step, g):
            got.append(_tree.tree_map(
                lambda t: t.detach().to(torch.float32, copy=True), g))

        with uncounted():
            train_lib.run(train_lib.parse_args(_train_argv(
                RWKV_FULL, ranks, 1, dev)), quiet=True, over=over,
                on_grads=first)
        torch.cuda.empty_cache()
        return got[0]

    def by_path(tree):
        return dict(zip(paths(tree), _tree.leaves(tree)))

    def dist(g, w):
        return float(torch.norm(g - w) / torch.norm(w))

    label = "grad_witness/rwkv6-1.6b"
    ref = by_path(grads((1, 1), "float32"))
    u = [p for p in ref if p.endswith("bonus_u")]
    stacked = {}
    for ranks in ((1, 1), (2, 2), (1, 4)):
        g = by_path(grads(ranks, "bfloat16"))
        others = {p: dist(g[p], ref[p]) for p in ref if p not in u}
        worst = max(others, key=others.get)
        stacked[f"{ranks[0]}x{ranks[1]}"] = {
            "bonus_u_norm": [float(torch.norm(g[p])) for p in u],
            "bonus_u_dist": [dist(g[p], ref[p]) for p in u],
            "worst_other": [worst, others[worst]],
            "median_other": statistics.median(others.values())}
        del g
    fp32 = {"bonus_u_norm": [float(torch.norm(ref[p])) for p in u]}
    del ref
    torch.cuda.empty_cache()
    ranks, over = (2, 2), {"dtype": "float32", "n_layers": 4}
    want = grads(ranks, "float32", layers=4)
    argv = _train_argv(RWKV_FULL, ranks, 1, "cpu")
    got = train_lib.train_procs(pool, argv, over=over, grads=True,
                                norms=True)
    cfg = train_lib.config_of(train_lib.parse_args(argv), over)
    mesh = make_host_mesh(*ranks)
    norms, whole = got["leaf_norms"], leaf_norms(want)
    # a leaf whose stacked gradient is 0 is held to 0 absolutely
    procs = {p: {"norm_rel": abs(norms[p] - w) / (w or 1.0),
                 "max_err": 0.0} for p, w in whole.items()}
    top = {p: float(w.abs().max()) for p, w in by_path(want).items()}
    for k, share in enumerate(got.pop("grads")):
        cut = by_path(PD.shard_params(want, cfg, mesh, k))
        for p, g in by_path(share).items():
            err = float((device_lib.leaf_to_torch(g, dev) - cut[p]).abs()
                        .max()) / (top[p] or 1.0)
            procs[p]["max_err"] = max(procs[p]["max_err"], err)
    worst = max(procs, key=lambda p: procs[p]["norm_rel"])
    if procs[worst]["norm_rel"] > 1e-3:
        raise AssertionError(f"{label}: fp32 over processes, step 0's "
                             f"gradient norm of {worst} "
                             f"{procs[worst]['norm_rel']} off the stacked "
                             f"run's")
    row = {"run": label, "fp32": fp32, "bf16_stacked": stacked,
           "procs_fp32_4_layers": {
               "bonus_u": {p: procs[p] for p in procs
                           if p.endswith("bonus_u")},
               "worst_norm_rel": [worst, procs[worst]["norm_rel"]],
               "worst_max_err": max(v["max_err"] for v in procs.values())}}
    emit({"grad_witness": row})
    return row


def train_rows(pool, dev, *, child: dict) -> dict:
    """The training rows over ``pool``: :data:`TRAIN_NCCL` over NCCL,
    :data:`TRAIN_GLOO` over gloo on one card, then Jamba SMOKE at (2, 2)
    (:func:`jamba_train_row`)."""
    rows = TRAIN_NCCL if pool.backend == "nccl" else TRAIN_GLOO
    out = [train_pool_row(pool, dev, name, ranks, layers, steps,
                          child=child)
           for name, ranks, layers, steps in rows]
    return {"rows": out,
            "jamba_smoke": jamba_train_row(pool, dev, (2, 2), child=child),
            "reduced": REDUCED_TRAIN}


# fsdp_sp over processes (the sequence split over the model processes,
# FSDP over the whole grid), trained at full width, bf16, seed 0, B = 4,
# S = 512, held to the stacked fsdp_sp run as TRAIN's rows are: (model,
# grid, layers (None: all), steps).  Llama-3-8B cut to 8 of 32 layers so
# that the stacked run fits one card; over gloo on one card RWKV6-1.6B
# on 2 of 24 layers, 2 steps
FSDP_SP_NCCL = ((RWKV_FULL, (1, 4), None, 4), (RWKV_FULL, (2, 2), None, 4),
                (LLAMA, (1, 4), 8, 4))
FSDP_SP_GLOO = ((RWKV_FULL, (2, 2), 2, 2),)
# over NCCL: 8 steps of --autotune --autotune-every 2 (RWKV6-1.6B, (2, 2):
# the probe over the data processes), the tuner's gate opened (a refit
# each probe from 2 samples, no drift or residual bar) so that it installs
FSDP_SP_AUTOTUNE = (RWKV_FULL, (2, 2), 8, 2)
REDUCED_FSDP_SP = ("fsdp_sp trained over processes at full width, B = 4, "
                   "S = 512: over NCCL on four cards RWKV6-1.6B at (1, 4) "
                   "and (2, 2) at full depth and Llama-3-8B at (1, 4) on 8 "
                   "of 32 layers, 4 steps each, its --autotune run 8 "
                   "steps; over gloo on one card RWKV6-1.6B at (2, 2) on 2 "
                   "of 24 layers, 2 steps; Llama-3-8B SMOKE whole, fp32, "
                   "(2, 2), 3 steps")


def fsdp_sp_forward_row(pool, dev, *, child: dict) -> dict:
    """One ``Model.forward`` of RWKV6-1.6B under fsdp_sp at (1, 4) over
    ``pool`` (the ``serve`` entry's forward: each process its positions
    of the 4 × 512 prompts) against the stacked fsdp_sp forward on this
    card: the logits bit for bit the stacked forward's (every argmax
    agreeing), as the serving rows over processes are held, two
    ``affine_chunk`` launches a layer a process (the carry's summaries
    and rescan), the carry its plan's; the processes' wall (one cold
    call)."""
    from repro_torch import configs
    from repro_torch.launch.serve import prompts_for
    from repro_torch.models.model import Model

    name, ranks = RWKV_FULL, (1, 4)
    over = {"sharding_strategy": "fsdp_sp"}
    B, S, seed = TRAIN["batch"], TRAIN["seq"], TRAIN["seed"]
    label = f"forward/{name}/{ranks[0]}x{ranks[1]}/fsdp_sp"
    cfg = configs.get(name, **over)
    prompts = prompts_for(cfg, B, S, seed)
    torch.cuda.empty_cache()
    with uncounted():
        model = Model(cfg, ranks, device=dev)
        params = model.init_params(seed)
        want, _ = model.forward(params, torch.as_tensor(prompts,
                                                        device=dev))
        want = want.cpu()
        del model, params
    torch.cuda.empty_cache()
    res = pool.call("serve", None, arch=name, ranks=ranks, batch=B,
                    prompt_len=S, gen=1, seed=seed, forward=True,
                    mesh=(("data", ranks[0]), ("model", ranks[1])), **over)
    logits = res.outputs[0]  # (4, B, S/4, V): process j its positions
    got = torch.from_numpy(np.concatenate(list(logits), axis=1))
    gap = float((got - want).abs().max() / want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    if not (torch.isfinite(got).all()
            and torch.equal(got.float(), want.float())
            and agree == 1.0):
        raise AssertionError(f"{label}: logits not the stacked forward's "
                             f"bit for bit (largest gap {gap} of the "
                             f"largest logit, argmax agreeing {agree})")
    n_scan = cfg.n_layers
    for k, ln in enumerate(res.launches):
        have = sum(ln.get("affine_chunk", {}).values())
        if pool.device.type == "cuda" and have != 2 * n_scan:
            raise AssertionError(f"{label}: process {k} launched {have} "
                                 f"affine_chunk, the path {2 * n_scan}")
    _add_launches(child, res)
    row = {"run": label, "model": cfg.name, "dtype": cfg.dtype, "batch": B,
           "seq": S, "max_gap_rel": gap, "argmax_agree": agree,
           "carry": carry_check(label, res, cfg, ranks, 1, 1),
           "wall_ms": min(res.seconds) * 1e3,
           "collectives": {k: [t.get(k, 0) for t in res.traffic]
                           for k in ("fsdp_gather", "fsdp_gather_bytes",
                                     "seq_shift", "seq_shift_bytes")}}
    emit({"fsdp_sp_row": row})
    return row


def fsdp_sp_autotune_row(pool, dev, *, child: dict) -> dict:
    """``train --backend --autotune`` over ``pool``
    (:data:`FSDP_SP_AUTOTUNE`): every process records the same probe
    seconds and installs the same profile at the same steps; the losses
    finite."""
    from repro_torch.core.autotune import DriftGate
    from repro_torch.launch import train as train_lib

    name, ranks, steps, every = FSDP_SP_AUTOTUNE
    label = f"autotune/{name}/{ranks[0]}x{ranks[1]}/fsdp_sp"
    argv = _train_argv(name, ranks, steps, "cpu") + [
        "--autotune", "--autotune-every", str(every)]
    gate = DriftGate(drift=0.0, max_residual=float("inf"), min_samples=2)
    got = train_lib.train_procs(pool, argv,
                                over={"sharding_strategy": "fsdp_sp"},
                                tuner_kw={"refit_every": 1, "gate": gate})
    tuned = got["autotune"]
    installs = [step for step, t in enumerate(tuned[0])
                if t["installed"] == 1.0]
    losses = [m["loss"] for m in got["metrics"]]
    table = [[list(t.values()) for t in proc] for proc in tuned]
    if not all(np.array_equal(t, table[0], equal_nan=True)
               for t in table[1:]) or not installs \
            or not np.isfinite(losses).all():
        raise AssertionError(f"{label}: installs by process {tuned}, "
                             f"losses {losses}")
    _add_launches(child, got["result"])
    row = {"run": label, "steps": steps, "every": every,
           "installs_at": installs,
           "profiles": [f"{int(t['profile']):012x}" for t in tuned[0]
                        if t["installed"] == 1.0],
           "probe_ms": [t["probe_s"] * 1e3 for t in tuned[0]
                        if np.isfinite(t["probe_s"])],
           "losses": losses,
           "step_ms": [t * 1e3 for t in got["step_s"]]}
    emit({"fsdp_sp_row": row})
    return row


def fsdp_sp_rows(pool, dev, *, child: dict) -> dict:
    """The fsdp_sp rows over ``pool``: :data:`FSDP_SP_NCCL`, the forward
    and the autotune run over NCCL, :data:`FSDP_SP_GLOO` and Llama-3-8B
    SMOKE (fp32, on the stacked run's parameters each step,
    :func:`jamba_train_row`) over gloo on one card.  The autotune run
    comes last: its installs stay in the pool's processes."""
    nccl = pool.backend == "nccl"
    out = {"train": [train_pool_row(pool, dev, name, ranks, layers, steps,
                                    child=child, strategy="fsdp_sp")
                     for name, ranks, layers, steps in
                     (FSDP_SP_NCCL if nccl else FSDP_SP_GLOO)],
           "reduced": REDUCED_FSDP_SP}
    if nccl:
        out["forward"] = fsdp_sp_forward_row(pool, dev, child=child)
        out["autotune"] = fsdp_sp_autotune_row(pool, dev, child=child)
    else:
        out["llama_smoke"] = jamba_train_row(
            pool, dev, (2, 2), child=child, name=LLAMA,
            over={"sharding_strategy": "fsdp_sp"})
    return out


def phase_fsdp_sp(dev) -> dict:
    """``--fsdp-sp-only``: the fsdp_sp rows alone (:func:`fsdp_sp_rows`),
    over gloo on this card, or where four cards are present over NCCL
    one process a card."""
    child: dict = {}
    line = {"phase": "fsdp_sp", "device": str(dev), "card": card_info()}
    cards = torch.cuda.device_count() >= 4
    with row_pool(dev, "nccl" if cards else "gloo") as pool:
        line["fsdp_sp"] = fsdp_sp_rows(pool, dev, child=child)
    return {**line, "child_launches": child}


def phase_train_procs(dev) -> dict:
    """``--train-procs-only``: the training rows alone (:func:`train_rows`):
    over gloo on this card, then :func:`grad_witness`, or where four
    cards are present over NCCL one process a card."""
    child: dict = {}
    line = {"phase": "train_procs", "device": str(dev), "card": card_info()}
    cards = torch.cuda.device_count() >= 4
    with row_pool(dev, "nccl" if cards else "gloo") as pool:
        line["train"] = train_rows(pool, dev, child=child)
        if not cards:
            line["grad_witness"] = grad_witness(pool, dev)
    return {**line, "child_launches": child}


def phase_serve_rows(dev, rows, phase: str, mixers: bool = False,
                     fsdp: bool = False) -> dict:
    """``rows`` of :data:`SERVE_ROWS` alone, with ``fsdp`` the FSDP rows
    (:func:`fsdp_rows`) and with ``mixers`` the mixer rows
    (:func:`mixer_rows`) after them, over gloo on this card, or where
    four cards are present over NCCL one process a card."""
    child: dict = {}
    line = {"phase": phase, "device": str(dev), "card": card_info()}
    cards = torch.cuda.device_count() >= 4
    with row_pool(dev, "nccl" if cards else "gloo") as pool:
        line["cards" if cards else "procs"] = serve_rows(pool, dev, rows,
                                                         child=child)
        if fsdp:
            line["fsdp"] = fsdp_rows(pool, dev, child=child)
        if mixers:
            line["mixers"] = mixer_rows(pool, dev, ((1, 4),), child=child)
    if not cards:
        line["reduced"] = REDUCED_GLOO
    return {**line, "child_launches": child}


def phase_moe(dev) -> dict:
    """``--moe-only``: Qwen's serving rows alone, at (1, 4) and (2, 2)."""
    return phase_serve_rows(dev, [r for r in SERVE_ROWS + FSDP_ROWS[:1]
                                  if r[0] == QWEN], "moe")


def phase_tp(dev) -> dict:
    """``--tp-only``: every serving row alone, the dense layers and the
    mixers split over the model processes: Qwen and Llama-3-8B at (1,
    4), then the mixer rows."""
    return phase_serve_rows(dev, SERVE_ROWS, "tp", mixers=True)


def phase_mixers(dev) -> dict:
    """``--mixers-only``: the mixer rows alone: RWKV6-1.6B served with
    its wkv heads and channel mix split, Jamba's Mamba mixer at full
    width and Jamba SMOKE whole over the model processes."""
    return phase_serve_rows(dev, (), "mixers", mixers=True)


def phase_fsdp(dev) -> dict:
    """``--fsdp-only``: the FSDP rows alone (:func:`fsdp_rows`): over
    gloo on one card Qwen and RWKV6-1.6B at (2, 2), reduced; on four
    cards over NCCL Qwen, RWKV6-1.6B and Llama-3-8B at (2, 2), full."""
    return phase_serve_rows(dev, (), "fsdp", fsdp=True)


def phase_cards(dev, *, algos=CP_ALGOS, dispatch_algos=("auto", "123"),
                reps=3) -> dict:
    """The same over NCCL, one process a card, at p = cards × P with P
    = 8 / cards (the dispatch at 64 / cards, table 1's xor cell at 512
    / cards), no copy staged through the host; ``measure_hop`` at 8 B and
    1 MiB and the cross-card tier fitted.  With fewer than two cards it
    shows the pool refusing two processes on one card and says it did
    not run."""
    from repro_torch.dist import WorkerPool

    cards = torch.cuda.device_count()
    if cards < 2:
        refused = []
        for device in (None, "cuda:0"):  # card k each; both on card 0
            try:
                WorkerPool(2, backend="nccl", device=device, timeout=30)
            except ValueError as e:
                refused.append(str(e))
            else:
                raise AssertionError(f"WorkerPool(2, backend='nccl', "
                                     f"device={device!r}) ran on {cards} "
                                     f"card")
        if not all("nccl wants one card a process" in r for r in refused):
            raise AssertionError(f"another refusal: {refused}")
        check_no_children()
        return {"phase": "cards", "ran": False, "cards": cards,
                "why": "one process a card over NCCL needs two cards",
                "refused": refused}
    if 8 % cards or 64 % cards:
        raise ValueError(f"{cards} cards do not divide p = 8 and 64")
    child: dict = {}
    line = consumers(dev, (cards, 8 // cards), (cards, 64 // cards),
                     backend="nccl", algos=algos,
                     dispatch_algos=dispatch_algos, reps=reps, child=child,
                     hops=(8, 1 << 20), xor_grid=(cards, 512 // cards),
                     keep=cards == 4)
    if cards >= 4:
        with row_pool(dev, "nccl") as pool:
            # training first: its stacked runs on card 0 (Qwen's 66 GB)
            # need the card that pool process 0 shares, before serving
            # leaves that process's allocator holding memory
            line["train"] = train_rows(pool, dev, child=child)
            line["serve"] = serve_rows(pool, dev, SERVE_ROWS, child=child)
            line["fsdp"] = fsdp_rows(pool, dev, child=child)
            line["decode_ws"] = ws_rows(pool, dev, child=child,
                                        fsdp=line["fsdp"]["serve"])
            line["mixers"] = mixer_rows(pool, dev, ((1, 4),), child=child)
            line["fsdp_sp"] = fsdp_sp_rows(pool, dev, child=child)
    else:
        line["serve"] = {"ran": False,
                         "why": f"one process a card for 4 ranks needs four "
                                f"cards, {cards} present"}
    return {"phase": "cards", "ran": True, "cards": cards,
            "card": card_info(), **line, "child_launches": child}


# ---------------------------------------------------------------------------
# clis: the ported benchmark CLIs, the run.py harness and the examples
# ---------------------------------------------------------------------------

# (label, module, arguments, the kernels its run must launch: wrapper
# names, "combine_affine" for the affine instance of the combine).
# train_smoke's llama runs no scan, so it launches none.
CLI_RUNS = (
    ("round_counts", "repro_torch.benchmarks.round_counts", ["--check"], ()),
    ("plan_table", "repro_torch.benchmarks.plan_table", ["--check"], ()),
    ("autotune_bench", "repro_torch.benchmarks.autotune_bench", ["--check"],
     ()),
    ("exec_bench", "repro_torch.benchmarks.exec_bench", ["--check"],
     ("combine", "scan_reduce")),
    ("serve_bench", "repro_torch.benchmarks.serve_bench", ["--check"],
     ("scan_reduce", "moe_routing")),
    ("run", "repro_torch.benchmarks.run", [],
     ("combine", "scan_reduce", "combine_affine", "affine_chunk",
      "moe_routing")),
    ("quickstart", "repro_torch.examples.quickstart", [], ("combine",)),
    ("context_parallel_ssm", "repro_torch.examples.context_parallel_ssm",
     [], ("combine_affine", "affine_chunk")),
    ("moe_dispatch_exscan", "repro_torch.examples.moe_dispatch_exscan", [],
     ("moe_routing", "combine")),
    ("train_smoke", "repro_torch.examples.train_smoke", ["--steps", "200"],
     ()),
    ("train_smoke_resume", "repro_torch.examples.train_smoke",
     ["--steps", "210"], ()),
)

def launches_by_op() -> dict:
    """Every wrapper's launches by op since the counts were last set to
    0: ``{kernel: {op: n}}``."""
    from repro_torch.kernels import scan_engine as se

    return {name: dict(fn.launches_by_op) for name, fn in se.KERNELS.items()}


def launches_by_kernel(by_op: dict) -> dict:
    """``launches_by_op``'s counts by kernel, the round kernels' affine
    instances apart (``combine_affine``, ...)."""
    out = {}
    for name, ops in by_op.items():
        for op, n in ops.items():
            key = name + ("_affine" if op == "affine" and name in
                          ROUND_KERNELS else "")
            out[key] = out.get(key, 0) + n
    return out


def _ir_launches(pl) -> int:
    """The round-kernel launches of one run of ``pl``'s schedule."""
    from repro_torch.core import monoid as monoid_lib

    m = monoid_lib.get(pl.spec.monoid)
    return pl.schedule().kernel_launches(m.commutative, fused=True)


def harness_predicted(dev) -> dict:
    """The launches the ``run`` harness's measured modules must make, from
    each cell's plan and its calls (one untimed, then the timed
    repeats), in ``_launches_since``'s form: ``{module: {kernel: n}}``.
    exscan_table1: the xor plan at p = 8 of each (algorithm, m);
    ssm_context_parallel: two ``affine_chunk`` and the carry's affine
    plan a call; moe_dispatch: the model's path a forward
    (``_model_launches``)."""
    from repro_torch import configs
    from repro_torch.benchmarks import exscan_table1 as t1
    from repro_torch.benchmarks import moe_dispatch as md
    from repro_torch.benchmarks import ssm_context_parallel as cs
    from repro_torch.core.scan_api import ScanSpec, plan
    from repro_torch.models.context_parallel import _carry_spec
    from repro_torch.models.model import Model

    rounds = sum(
        (1 + t1.repeats(m)) * _ir_launches(plan(
            ScanSpec(kind="exclusive", monoid="xor", algorithm=alg),
            t1.P_MEASURED, nbytes=8 * m))
        for alg in t1.ALGS for m in t1.EMS)
    want = {"exscan_table1": {"round_kernels": rounds}}
    calls = 1 + cs.REPS
    rounds = sum(calls * _ir_launches(plan(
        _carry_spec(ScanSpec(kind="exclusive", monoid="affine",
                             algorithm=alg), None),
        cs.P, nbytes=2 * cs.B * cs.D * 4)) for alg in cs.ALGS)
    want["ssm_context_parallel"] = {
        "affine_chunk": 2 * calls * len(cs.ALGS), "round_kernels": rounds}
    moe: dict = {}
    for alg in md.ALGS:
        cfg = configs.get_smoke(
            md.ARCH, scan=ScanSpec(kind="exclusive", algorithm=alg))
        for k, v in _model_launches(cfg, Model(cfg, md.RANKS, dev),
                                    *md.TOKENS, gen=1,
                                    forward=1 + md.REPS, loops=0).items():
            moe[k] = moe.get(k, 0) + v
    want["moe_dispatch"] = moe
    return {mod: {k: v for k, v in w.items() if v}
            for mod, w in want.items()}


def harness_modules(modules: list, per_module: dict, outputs: dict) -> list:
    """The harness's ``(name, fn)`` list, each wrapped to record its own
    launches into
    ``per_module`` (``_launches_since``'s form) and, for the two model
    benches, to keep each timed cell's first output in ``outputs``."""
    from repro_torch.kernels import scan_engine as se

    wrapped = []
    for name, fn in modules:
        keep = name in ("moe_dispatch", "ssm_context_parallel")

        def call(rows, device, name=name, fn=fn, keep=keep):
            before = se.launch_counts()
            try:
                if keep:
                    fn(rows, device=device, outputs=outputs)
                else:
                    fn(rows, device=device)
            finally:
                sync(device)
                per_module[name] = _launches_since(before)
        wrapped.append((name, call))
    return wrapped


def check_harness(dev, per_module: dict, outputs: dict) -> dict:
    """The harness's measured modules: launches against
    ``harness_predicted``, the MoE cells' logits and aux against the
    same forward on the CPU (fp32 tolerance), the prefill cells' h
    against a float64 recurrence on every column.  Raises on a
    mismatch; returns what it compared."""
    from repro_torch.benchmarks import moe_dispatch as md
    from repro_torch.benchmarks import ssm_context_parallel as cs

    want = harness_predicted(dev)
    for mod, w in want.items():
        if per_module.get(mod) != w:
            raise AssertionError(f"run/{mod}: kernels launched "
                                 f"{per_module.get(mod)}, its plans "
                                 f"predict {w}")
    moe_err = {}
    for alg in md.ALGS:
        tokens, logits, aux = outputs[f"moe_forward_p8/{alg}"]
        _, wl, wa = md.forward(alg, tokens, "cpu", reps=1)
        for got, ref in ((logits, wl), (aux, wa)):
            got = got.float().cpu()
            if got.shape != ref.shape or not torch.allclose(
                    got, ref.float(), atol=FP32_ATOL, rtol=FP32_RTOL):
                raise AssertionError(f"run/moe_dispatch/{alg}: card "
                                     f"differs from the CPU forward")
        moe_err[alg] = float((logits.float().cpu() - wl).abs().max())
    a, b = cs.inputs()
    ref, _ = affine_ref_cols(torch.from_numpy(a[0]), torch.from_numpy(b[0]),
                             torch.arange(cs.D))
    ssm_err = {}
    for alg in cs.ALGS:
        h = outputs[f"cp_ssm_prefill_p{cs.P}/{alg}"]
        if tuple(h.shape) != (cs.B, cs.S, cs.D):
            raise AssertionError(f"run/ssm/{alg}: h is {tuple(h.shape)}")
        ssm_err[alg] = close_rel(h[0], ref)
    return {"launches": per_module, "predicted": want,
            "moe_logits_max_abs_err": moe_err,
            "prefill_max_rel_err": ssm_err,
            "moe_tol": [FP32_ATOL, FP32_RTOL], "prefill_tol": AFFINE_TOL}


def run_cli(mod, argv: list, log: Path) -> tuple[int, str]:
    """``mod.main(argv)`` in this process, its output into ``log``: (its
    exit code, the last line it printed).  A ``SystemExit`` is the
    module's exit code; any other exception propagates."""
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        try:
            rc = mod.main(argv)
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
            if not isinstance(e.code, int):
                print(e.code)
    lines = log.read_text().strip().splitlines()
    return rc, lines[-1] if lines else ""


def cli_summary(label: str, js: dict) -> dict:
    """The numbers of a module's JSON that PERF.md reads."""
    rows = js.get("rows", [])
    if label == "run":
        return {k: v for k, v, note in rows
                if note.startswith("us_wallclock")}
    if label == "exec_bench":
        return {f"{r['algorithm']}/{r['mode']}/p{r['p']}":
                [r["kernel_launches"], r["hbm_passes"],
                 r["round_kernel_launches"], r["wall_seconds"] * 1e6]
                for r in rows}
    if label == "serve_bench":
        return {f"{r['phase']}{'' if r['rate'] is None else r['rate']}":
                {k: r.get(k) for k in (
                    "fused_round_win", "mean_occupancy", "completed",
                    "arrival_latency_p50_s", "arrival_latency_p99_s",
                    "latency_p50_s", "latency_p99_s",
                    "post_warmup_compiles")} for r in rows}
    if label == "autotune_bench":
        return {r["scenario"]: {k: r.get(k) for k in (
            "installs", "refits", "plans_dropped", "walltime_ratio")}
            for r in rows}
    return {"rows": len(rows)}


def phase_clis(dev) -> dict:
    """Each ported CLI and example in this process, on the card, with
    ``--json`` into a temporary directory: its exit code and last line,
    wall seconds, kernel launches by name (each module's counts set to 0
    just before it); fails when a gate fails, a module raises, or a
    module does not launch what its path must, or when the harness's
    measured modules fail ``check_harness``."""
    import importlib
    import tempfile
    from unittest import mock

    from repro_torch.kernels import scan_engine as se

    mods, failed = {}, []
    launched_total: dict = {}
    per_module: dict = {}
    outputs: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "train_smoke_ckpt")
        for label, module, args, must in CLI_RUNS:
            mod = importlib.import_module(module)
            argv = list(args)
            if label.startswith("train_smoke"):
                argv += ["--ckpt", ckpt]
            out = getattr(mod, "DEFAULT_JSON", None)  # the benchmarks'
            if out:
                out = Path(tmp) / out
                argv += ["--json", str(out)]
            patch = contextlib.nullcontext()
            if label == "run":  # the harness's modules, each read alone
                wrapped = harness_modules(mod.modules(), per_module, outputs)
                patch = mock.patch.object(mod, "modules", lambda: wrapped)
            se.reset_launch_counts()
            sync(dev)
            t0 = time.perf_counter()
            try:
                with patch:
                    rc, last = run_cli(mod, argv,
                                       Path(tmp) / f"{label}.log")
            except Exception:  # noqa: BLE001 - failed below
                rc, last = 1, traceback.format_exc()[-1500:]
            sync(dev)
            seconds = time.perf_counter() - t0
            by_op = launches_by_op()
            launched = launches_by_kernel(by_op)
            for name, ops in by_op.items():
                into = launched_total.setdefault(name, {})
                for op, n in ops.items():
                    into[op] = into.get(op, 0) + n
            missing = [k for k in must if not launched.get(k)]
            row = {"rc": rc, "last": last[-300:], "seconds": seconds,
                   "launches": launched}
            if out and rc == 0:
                with open(out) as f:
                    js = json.load(f)
                row["summary"] = cli_summary(label, js)
                row["card"] = js["meta"].get("card")
            if module.startswith("repro_torch.examples"):  # short
                row["log"] = (Path(tmp) / f"{label}.log").read_text()[-4000:]
            if label == "train_smoke_resume":
                row["resumed_from_200"] = "resumed from step 200" in \
                    (Path(tmp) / f"{label}.log").read_text()
            if label == "run" and rc == 0:
                try:
                    row["harness"] = check_harness(dev, per_module, outputs)
                except AssertionError as e:
                    rc, last = 1, str(e)
                    row.update(rc=rc, last=last[-300:])
                outputs.clear()
            mods[label] = row
            if rc != 0 or missing or row.get("resumed_from_200") is False:
                failed.append((label, rc, missing, last[-1500:]))
            if label.startswith("train_smoke"):
                torch.cuda.empty_cache()
    se.reset_launch_counts()
    # the modules' launches, summed here since each module's counts
    # were set to 0 before it (the main loop adds them as it adds a
    # pool's processes')
    line = {"phase": "clis", "modules": mods,
            "seconds": sum(r["seconds"] for r in mods.values()),
            "child_launches": launched_total}
    if failed:
        emit(line)
        raise AssertionError(f"clis: {failed}")
    return line


# ---------------------------------------------------------------------------
# calibrate: fit the "stacked" tier on the card, and what auto would pick
# ---------------------------------------------------------------------------


def fastest(runs, label_of) -> dict:
    """{algorithm: median ms} of the rows ``label_of`` selects."""
    out = {}
    for r in runs:
        algo = label_of(r)
        if algo is not None:
            out[algo] = r["median_s"] * 1e3
    return out


def pinned_ms(spec, algo, p, x, dev, reps=3) -> float:
    """Median wall ms of ``spec`` pinned to ``algo`` over p ranks of x,
    after one warm-up call."""
    import dataclasses

    from repro_torch.core.scan_api import plan

    nbytes = sum(t[0].numel() * t.element_size() for t in _leaves(x))
    pl = plan(dataclasses.replace(spec, algorithm=algo), p, nbytes=nbytes)
    pl.execute(x)
    return statistics.median(wall_s(lambda: pl.execute(x), dev, reps)) * 1e3


def phase_calibrate(dev, table1, cp_ssm, *, ps=(8, 64, 512),
                    ms=(8, 800, 80_000, 800_000), repeats=3) -> dict:
    """``tune.calibrate`` on the card over a sweep holding table1's p =
    512 and cp_ssm's p = 64 (m from 8 to 800 000 bytes), then auto's pick
    under the fitted profile beside the default's and the algorithm
    table1's and cp_ssm's rows measured fastest (a pick those rows did
    not run is timed here; the cp_ssm carry's scan is also timed alone
    for each candidate).  Installs nothing."""
    from repro_torch.core import tune
    from repro_torch.core.scan_api import DEFAULT_COST_MODEL, ScanSpec, plan
    from repro_torch.models.context_parallel import _carry_spec

    t0 = time.perf_counter()
    prof = tune.calibrate(simulate=False, ps=ps, ms=ms, repeats=repeats)
    seconds = time.perf_counter() - t0
    cm = prof.model("stacked")
    picks = []
    spec = ScanSpec(kind="exclusive", monoid="xor", algorithm="auto")
    for m in (1, 100, 10_000, 100_000):
        measured = table1_fastest(dev, table1, 512, m)
        best = min(measured, key=measured.get)
        pick = plan(spec, 512, nbytes=8 * m, cost_model=cm).algorithm
        if pick not in measured:
            x = torch.randint(-(1 << 62), 1 << 62, (512, m), device=dev)
            measured[pick] = pinned_ms(spec, pick, 512, x, dev)
            del x
        picks.append({
            "cell": f"table1 p=512 m={m}", "auto_calibrated": pick,
            "auto_default": plan(spec, 512, nbytes=8 * m).algorithm,
            "measured_fastest": best, "measured_ms": measured})
    p, d = 64, int(np.prod(cp_ssm["state"])) * cp_ssm["batch"]
    cspec = _carry_spec(None, "auto")
    measured = fastest(cp_ssm["runs"], lambda r: (
        r["run"].split("/")[2] if r["p"] == p
        and not r["run"].endswith("/auto") else None))
    pick = plan(cspec, p, nbytes=8 * d, cost_model=cm).algorithm
    gen = torch.Generator(device=dev).manual_seed(42)
    carry = (torch.rand((p, d), generator=gen, device=dev) * 0.1 + 0.9,
             torch.randn((p, d), generator=gen, device=dev))
    picks.append({
        "cell": f"cp_ssm carry p={p}", "auto_calibrated": pick,
        "auto_default": plan(cspec, p, nbytes=8 * d).algorithm,
        "measured_fastest": min(measured, key=measured.get),
        "measured_ms": measured,
        "carry_scan_ms": {a: pinned_ms(cspec, a, p, carry, dev)
                          for a in sorted(set(measured) | {pick})}})
    del carry
    return {"phase": "calibrate", "seconds": seconds, "ps": list(ps),
            "ms": list(ms), "repeats": repeats,
            "fingerprint": prof.mesh_fingerprint,
            "alpha": cm.alpha, "beta": cm.beta, "gamma": cm.gamma,
            "residual": dict(prof.residuals)["stacked"],
            "default": {"alpha": DEFAULT_COST_MODEL.alpha,
                        "beta": DEFAULT_COST_MODEL.beta,
                        "gamma": DEFAULT_COST_MODEL.gamma},
            "picks": picks}


# ---------------------------------------------------------------------------
# cp_train: training through the context-parallel scans
# ---------------------------------------------------------------------------

# The cp scans' gradient against the sequential one: 2e-4 of the
# gradient's scale and relative, the JAX package's tolerance for its cp
# carry (tests/test_context_parallel.py); the split scan adds the same
# terms in another order.
CP_GRAD_TOL = 2e-4
# fsdp_sp against tp at step 0 of the bf16 RWKV6-1.6B, from one seed and
# batch: the two differ only in the fp32 wkv scan's order of additions,
# which can move a bf16 rounding of the wkv output by one unit (2^-8)
# here and there; a mean over 2048 tokens and a norm over 1.68 G
# gradients average such flips out
CP_LOSS_RTOL, CP_GNORM_RTOL = 1e-3, 1e-2


def grad_excess(got, want, tol: float = CP_GRAD_TOL) -> float:
    """max |got - want| / max |want| over the leaves; raises where an
    entry is off by more than tol·max|want| + tol·|want|, or where
    either is not finite.  Row chunks, so the temporaries stay small
    beside 4 GB leaves."""
    worst = 0.0
    for g, w in zip(_leaves(got), _leaves(want)):
        if g.shape != w.shape:
            raise AssertionError(f"gradient {tuple(g.shape)} against "
                                 f"{tuple(w.shape)}")
        g2, w2 = g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1)
        if not (bool(torch.isfinite(g2).all())
                and bool(torch.isfinite(w2).all())):
            raise AssertionError("a gradient entry is not finite")
        scale = max(float(w2.abs().max()), 1e-30)
        for i in range(0, g2.shape[0], 64):
            d = (g2[i:i + 64] - w2[i:i + 64]).abs_()
            worst = max(worst, float(d.max()) / scale)
            if bool((d > tol * scale + tol * w2[i:i + 64].abs()).any()):
                raise AssertionError(f"a gradient entry off the sequential "
                                     f"one by {float(d.max())} (scale "
                                     f"{scale})")
    return worst


def cp_backward_rows(dev, kind: str, p: int, x, y, gy, state: int,
                     algos, reps: int) -> list:
    """The cp scan ``kind`` over p ranks of one sequence (x, y of (p, 1,
    S/p, ...)) under each carry algorithm: its gradient against
    ``AffineChunkFn``'s over the unsplit sequence on the card; the
    backward's rounds and ⊕ (``collect_stats`` over the backward alone)
    against the plan; its launches 2 ``affine_chunk_bwd`` and the plan's
    round kernels; forward and backward busy ms beside the sequential
    backward's."""
    from repro_torch.core.scan_api import plan
    from repro_torch.core import schedule as sch
    from repro_torch.kernels import scan_engine as se
    from repro_torch.models import context_parallel as cpl

    fn = cpl.cp_ssm_scan if kind == "ssm" else cpl.cp_wkv_scan
    seq = p * x.shape[2]
    xs = x.detach().requires_grad_()
    ys = y.detach().requires_grad_()
    with uncounted():  # the reference: the unsplit sequence's gradient
        xa = xs.detach().reshape(1, seq, -1).requires_grad_()
        ya = ys.detach().reshape(1, seq, -1).requires_grad_()
        h, _ = se.affine_chunk_h(
            xa, ya, torch.zeros((1, ya.shape[-1]), device=dev),
            exclusive=kind == "wkv", final=False)
        g_seq = gy.reshape(h.shape)

        def seq_bwd():
            return torch.autograd.grad(h, [xa, ya], g_seq, retain_graph=True)

        want = [w.reshape(t.shape) for w, t in zip(seq_bwd(), (xs, ys))]
        seq_ms = device_ms(seq_bwd, dev, reps)
        seq_busy = device_busy_s(seq_bwd, dev)
        del h, xa, ya
    with torch.no_grad():  # how much of a shard's carry reaches its end
        a_tot = xs.reshape(p, seq // p, -1).prod(dim=1)
        carry = [float(a_tot.min()), float(a_tot.max())]
        del a_tot
    rows = []
    for algo in algos:
        cspec = cpl._carry_spec(None, algo)
        pl = plan(cspec, p, nbytes=2 * state * 4)
        out = fn(xs, ys, spec=cspec)

        def bwd(out=out):
            return torch.autograd.grad(out, [xs, ys], gy, retain_graph=True)

        before = se.launch_counts()
        with sch.collect_stats() as st:
            got = bwd()
        sync(dev)
        after = se.launch_counts()
        moved = {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}
        on_card = dev.type == "cuda"  # the CPU runs the plain versions
        want_launch = {"affine_chunk_bwd": 2} if on_card else {}
        ir = _ir_launches(pl) if on_card else 0
        rounds_moved = sum(moved.pop(k, 0) for k in ROUND_KERNELS)
        if (st.rounds, st.op_applications) != (pl.rounds,
                                               pl.op_applications):
            raise AssertionError(
                f"cp_{kind} p={p} {algo} backward: rounds/⊕ "
                f"{st.rounds}/{st.op_applications}, plan "
                f"{pl.rounds}/{pl.op_applications}")
        if moved != want_launch or rounds_moved != ir:
            raise AssertionError(
                f"cp_{kind} p={p} {algo} backward launched {moved} and "
                f"{rounds_moved} round kernels; the path predicts "
                f"{want_launch} and {ir}")
        err = grad_excess(got, want)

        def fwd():
            return fn(xs, ys, spec=cspec)

        # step (i) alone: the launch whose da and db the backward drops
        a3 = xs.detach().reshape(p, seq // p, -1)
        h3, g3 = (t.detach().reshape(p, seq // p, -1) for t in (out, gy))
        with uncounted():
            step_i_ms = device_ms(lambda: se.affine_chunk_bwd(
                a3, g3, None, h3, exclusive=kind == "wkv"), dev, reps)

        rows.append({
            "run": f"cp_{kind}/p={p}/{algo}", "p": p,
            "tokens_per_rank": seq // p, "algorithm": pl.algorithm,
            "rounds": st.rounds, "ops": st.op_applications,
            "round_launches": ir, "bwd_launches": dict(moved),
            "grad_err_over_scale": err, "tolerance": CP_GRAD_TOL,
            "grad_bit_equal": all(torch.equal(g, w)
                                  for g, w in zip(got, want)),
            "shard_decay_min_max": carry,
            "fwd_ms": device_ms(fwd, dev, reps),
            "fwd_busy_ms": _ms(device_busy_s(fwd, dev)),
            "bwd_ms": device_ms(bwd, dev, reps),
            "bwd_busy_ms": _ms(device_busy_s(bwd, dev)),
            "bwd_step_i_ms": step_i_ms,
            "seq_bwd_ms": seq_ms, "seq_bwd_busy_ms": _ms(seq_busy)})
        del out, got
    return rows


def _ms(seconds):
    return None if seconds is None else seconds * 1e3


def cp_backward(dev, *, seq=4096, wkv_ps=(8, 64), heads=32, hd=64,
                ssm_ps=(8,), ssm_state=(16_384, 16), algos=("auto", "123"),
                reps=5) -> dict:
    """(a) the cp scans' backward at the cp_wkv and cp_ssm cells' shapes
    (B = 1, S = 4096), decays in [0.99, 1): a shard of 512 tokens passes
    on about 0.08 of its carry (of 64 tokens, 0.7), so the reverse carry
    moves the gradients (decays of 0.9-1 pass on 1e-12 over 512)."""
    rows = []
    d = heads * hd * hd
    for p in wkv_ps:
        gen = torch.Generator(device=dev).manual_seed(41 + p)
        w = torch.rand((p, 1, seq // p, heads, hd, 1), generator=gen,
                       device=dev).mul_(0.01).add_(0.99)
        kv = torch.randn((p, 1, seq // p, heads, hd, hd), generator=gen,
                         device=dev)
        gy = torch.randn(kv.shape, generator=gen, device=dev)
        rows += cp_backward_rows(dev, "wkv", p, w, kv, gy, d, algos, reps)
        del w, kv, gy
        torch.cuda.empty_cache()
    ds = int(np.prod(ssm_state))
    for p in ssm_ps:
        shape = (p, 1, seq // p) + tuple(ssm_state)
        gen = torch.Generator(device=dev).manual_seed(43 + p)
        a = torch.rand(shape, generator=gen, device=dev).mul_(0.01).add_(0.99)
        b = torch.randn(shape, generator=gen, device=dev)
        gy = torch.randn(shape, generator=gen, device=dev)
        rows += cp_backward_rows(dev, "ssm", p, a, b, gy, ds, algos, reps)
        del a, b, gy
        torch.cuda.empty_cache()
    return {"seq": seq, "batch": 1, "wkv": {"heads": heads, "head_dim": hd,
                                            "ps": list(wkv_ps)},
            "ssm": {"state": list(ssm_state), "ps": list(ssm_ps)},
            "runs": rows}


class CountOps(TorchDispatchMode):
    """Counts the calls of ``ops`` (aten overloads) dispatched inside."""

    def __init__(self, ops):
        super().__init__()
        self.ops, self.n = frozenset(ops), 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in self.ops
        return func(*args, **(kwargs or {}))


def cp_train_run(dev, label: str, ranks, overrides: dict, *, batch: int,
                 seq: int, steps: int, seed: int, lr: float = 3e-3) -> dict:
    """``make_train_step`` on RWKV6-1.6B whole (bf16, fp32 moments, remat)
    for ``steps`` steps: step ms, busy and idle of a step (one more,
    untimed), peak memory, launches a step by kernel, every loss and
    grad norm finite; then, outside the counts, one loss and backward
    with the matrix products of the backward counted."""
    from repro_torch import _tree, configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import scan_engine as se
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import DOTS, Model
    from repro_torch.optim import adamw_init
    from repro_torch.serve.metrics import percentile

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = configs.get("rwkv6_1_6b", **overrides)
    model = Model(cfg, ranks, device=dev)
    params = model.init_params(seed, trainable=True)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, lr_peak=lr, warmup=1, total_steps=steps,
                              model=model)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch))

    def batch_of(step):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(step).items()
                if k in ("tokens", "labels")}

    logs = []
    before = se.launch_counts()
    for step in range(steps):
        b = batch_of(step)
        sync(dev)
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, b, step)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        logs.append((loss, gnorm, time.perf_counter() - t0))
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"cp_train {label}: loss {loss}, grad norm "
                                 f"{gnorm} at step {step}")
    launched = _launches_since(before)
    peak = torch.cuda.max_memory_allocated(dev)
    b = batch_of(steps)
    with uncounted():
        busy = device_busy_s(lambda: step_fn(params, opt, b, steps), dev)
        top = step_breakdown(lambda: step_fn(params, opt, b, steps), dev)
        loss, _ = model.loss(params, b)
        with CountOps(DOTS) as count:
            torch.autograd.grad(loss, _tree.leaves(params))
        del loss
    warm = [t for _, _, t in logs[1:]] or [logs[0][2]]
    p50 = percentile(warm, 50)
    del model, params, opt, step_fn
    torch.cuda.empty_cache()
    return {"label": label, "ranks": list(ranks),
            "sharding_strategy": cfg.sharding_strategy,
            "remat_policy": cfg.remat_policy, "dtype": cfg.dtype,
            "batch": batch, "seq": seq, "steps": steps,
            "cold_step_ms": logs[0][2] * 1e3,
            "step_p50_ms": p50 * 1e3, "step_min_ms": min(warm) * 1e3,
            "step_max_ms": max(warm) * 1e3, "tok_per_s": batch * seq / p50,
            "step_busy_ms": _ms(busy),
            "step_idle_share": None if busy is None else 1.0 - busy / p50,
            "step_top_kernels": top,
            "peak_allocated_gb": peak / 1e9,
            "losses": [x for x, _, _ in logs],
            "grad_norms": [g for _, g, _ in logs],
            "launches_per_step": {k: v / steps for k, v in launched.items()},
            "backward_matrix_products": count.n}


def cp_train_full(dev, *, ranks=(1, 8), batch=4, seq=512, steps=6,
                  seed=0) -> dict:
    """(b) RWKV6-1.6B whole under fsdp_sp at ``ranks`` with remat
    "nothing" and "dots", and step 0 of the (1, 1) tp run from the same
    seed and batch: the losses and grad norms of step 0 within
    CP_LOSS_RTOL / CP_GNORM_RTOL of tp's; "dots"'s backward runs fewer
    matrix products than "nothing"'s; the launches a step are the
    path's: per layer two ``affine_chunk`` in the forward and two in the
    recompute, two ``affine_chunk_bwd``, and three runs of the carry's
    plan (forward, recompute, backward)."""
    from repro_torch import configs
    from repro_torch.core.scan_api import plan
    from repro_torch.models.context_parallel import _carry_spec

    with uncounted():
        tp = cp_train_run(dev, "tp", (1, 1), {}, batch=batch, seq=seq,
                          steps=1, seed=seed)
    runs = [cp_train_run(dev, policy, ranks,
                         {"sharding_strategy": "fsdp_sp",
                          "remat_policy": policy},
                         batch=batch, seq=seq, steps=steps, seed=seed)
            for policy in ("nothing", "dots")]
    cfg = configs.get("rwkv6_1_6b")
    H = cfg.d_model // 64
    pl = plan(_carry_spec(cfg.scan_spec, None), ranks[1],
              nbytes=2 * batch * H * 64 * 64 * 4)
    n = cfg.n_layers
    want = {"affine_chunk": 4 * n, "affine_chunk_bwd": 2 * n,
            "round_kernels": 3 * n * _ir_launches(pl)}
    for r in runs:
        got = r["launches_per_step"]
        # (the CPU runs the plain versions: no launches to count)
        if dev.type == "cuda" and got != want:
            raise AssertionError(f"cp_train {r['label']}: launches a step "
                                 f"{got}, the path predicts {want}")
        for k, tol in (("losses", CP_LOSS_RTOL),
                       ("grad_norms", CP_GNORM_RTOL)):
            a, b = r[k][0], tp[k][0]
            if abs(a - b) > tol * abs(b):
                raise AssertionError(f"cp_train {r['label']}: step-0 {k} "
                                     f"{a}, tp {b}")
    # the fsdp_sp wkv path's copies of a layer's kv into shards and of
    # S_prev back (each 1.07 GB at this shape), timed alone
    from repro_torch.models.rwkv import _join, _split

    with uncounted():
        kv = torch.randn((batch, seq, H, 64, 64), device=dev)
        shards = _split(kv, ranks[1])
        copies = {"split_ms": device_ms(lambda: _split(kv, ranks[1]), dev, 5),
                  "join_ms": device_ms(lambda: _join(shards).contiguous(),
                                       dev, 5),
                  "gb": kv.numel() * 4 / 1e9}
        del kv, shards
    nothing, dots = runs
    if not dots["backward_matrix_products"] < \
            nothing["backward_matrix_products"]:
        raise AssertionError(
            f"cp_train: remat dots ran {dots['backward_matrix_products']} "
            f"matrix products in the backward, nothing "
            f"{nothing['backward_matrix_products']}")
    return {"model": cfg.name, "params": cfg.param_count(),
            "layers": cfg.n_layers, "carry_plan": pl.algorithm,
            "carry_rounds": pl.rounds, "predicted_launches": want,
            "tolerance": {"loss_rtol": CP_LOSS_RTOL,
                          "grad_norm_rtol": CP_GNORM_RTOL},
            "tp_step0": {"loss": tp["losses"][0],
                         "grad_norm": tp["grad_norms"][0],
                         "step_ms": tp["cold_step_ms"],
                         "step_busy_ms": tp["step_busy_ms"],
                         "step_top_kernels": tp["step_top_kernels"],
                         "peak_allocated_gb": tp["peak_allocated_gb"],
                         "backward_matrix_products":
                             tp["backward_matrix_products"]},
            "split_join_copies": copies, "runs": runs}


def sync_smoke(dev, *, p=8, k_small=0.1) -> dict:
    """(d) ``sparse_gradient_sync`` at p = 8 on the SMOKE RWKV6's gradient
    tree (rank r's gradient from the batch of seed r): at k = 1.0 every
    rank gets the dense mean (rtol 1e-6; atol 1e-6 of the leaf's scale,
    the rounding of a sum of p entries that may cancel, atomics in any
    order) and the error is 0; at k = 0.1 the offsets are numpy's
    exclusive cumsum of ``leaf_slot_counts`` and their rounds and ⊕ the
    fused plan's."""
    from repro_torch import _tree, configs
    from repro_torch.core import schedule as sch
    from repro_torch.core.scan_api import plan_fused
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models.model import Model
    from repro_torch.optim import compression as comp

    cfg = configs.get_smoke("rwkv6_1_6b")
    model = Model(cfg, (1, 1), device=dev)
    params = model.init_params(0, trainable=True)
    leaves = _tree.leaves(params)
    per_rank = []
    with uncounted():
        for r in range(p):
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in synthetic_batch(cfg, 2, 32, r).items()}
            loss, _ = model.loss(params, b)
            per_rank.append(torch.autograd.grad(loss, leaves))
    grads = _tree.unflatten(_tree.flatten(params)[1],
                            [torch.stack(g) for g in zip(*per_rank)])
    err0 = comp.init_error_feedback(grads)
    synced, new_err, _ = comp.sparse_gradient_sync(grads, err0,
                                                   k_fraction=1.0)
    worst = 0.0
    for g, s, e in zip(_tree.leaves(grads), _tree.leaves(synced),
                       _tree.leaves(new_err)):
        mean = g.mean(dim=0)
        d = (s - mean).abs()
        if bool((d > 1e-6 * mean.abs() + 1e-6 * float(g.abs().max())).any()) \
                or bool(e.any()):
            raise AssertionError(f"sync at k = 1.0: off the dense mean by "
                                 f"{float(d.max())}, error "
                                 f"{float(e.abs().max())}")
        worst = max(worst, float(d.max()))
    sizes = [g[0].numel() for g in _tree.leaves(grads)]
    counts = comp.leaf_slot_counts(sizes, k_small)
    with sch.collect_stats() as st:
        _, _, stats = comp.sparse_gradient_sync(grads, err0,
                                                k_fraction=k_small)
    got = stats["compact_offsets"].cpu().numpy()
    want = np.stack([np.concatenate([[0], np.cumsum([c] * (p - 1))])
                     for c in counts]).astype(np.int32)
    fp = plan_fused([comp.OFFSETS_SPEC] * len(counts), p, [4] * len(counts))
    if not np.array_equal(got, want) or st.rounds != fp.rounds:
        raise AssertionError(f"sync offsets {got.tolist()} in {st.rounds} "
                             f"rounds; numpy {want.tolist()}, the fused "
                             f"plan {fp.rounds} rounds")
    return {"p": p, "leaves": len(sizes), "k1_max_abs_err": worst,
            "offsets_rounds": st.rounds, "offsets_ops": st.op_applications,
            "fused_plan": fp.describe()}


def sync_full(dev, *, p=2, batch=4, seq=512, k_fraction=0.01, reps=3,
              seed=0) -> dict:
    """(d) ``sparse_gradient_sync`` at RWKV6-1.6B's full width over p = 2
    data ranks: rank r's gradient is the whole model's on its half of one
    step's batch (B = 2 of 4), as fp32 (2, ...) leaves; the sync's ms
    (wall, synchronised) and the share of it that ``torch.topk`` takes;
    every rank's picks at most k a leaf, and the synced gradient the mean
    of the ranks' picks (atol 1e-6 of the leaf's scale)."""
    from repro_torch import _tree, configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model
    from repro_torch.optim import compression as comp

    torch.cuda.empty_cache()
    cfg = configs.get("rwkv6_1_6b")
    model = Model(cfg, (1, 1), device=dev)
    params = model.init_params(seed, trainable=True)
    leaves, treedef = _tree.flatten(params)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch))
    full = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(0).items()
            if k in ("tokens", "labels")}
    stacked = [torch.empty((p, *t.shape), dtype=torch.float32, device=dev)
               for t in leaves]
    half = batch // p
    with uncounted():
        for r in range(p):
            part = {k: v[r * half:(r + 1) * half] for k, v in full.items()}
            loss, _ = model.loss(params, part)
            for dst, g in zip(stacked, torch.autograd.grad(loss, leaves)):
                dst[r].copy_(g)
            del loss
    del model, params, leaves
    torch.cuda.empty_cache()
    grads = _tree.unflatten(treedef, stacked)
    err = comp.init_error_feedback(grads)
    synced, new_err, stats = comp.sparse_gradient_sync(
        grads, err, k_fraction=k_fraction)
    sync(dev)
    sizes = [g[0].numel() for g in stacked]
    ks = comp.leaf_slot_counts(sizes, k_fraction)
    worst = 0.0
    for g, s, e, k in zip(stacked, _tree.leaves(synced),
                          _tree.leaves(new_err), ks):
        mine = g - e  # each rank's picks, zeros elsewhere
        if int((mine != 0).sum(dim=tuple(range(1, g.dim()))).max()) > k:
            raise AssertionError(f"a rank picked more than k = {k}")
        d = (s[0] - mine.sum(dim=0) / p).abs()
        scale = max(float(g.abs().max()), 1e-30)  # a leaf may take no grad
        if float(d.max()) > 1e-6 * scale or not torch.equal(s[0], s[-1]):
            raise AssertionError(f"synced off the mean of the picks by "
                                 f"{float(d.max())} (scale {scale})")
        worst = max(worst, float(d.max()) / scale)
        del mine, d
    del synced, new_err
    times = wall_s(lambda: comp.sparse_gradient_sync(
        grads, err, k_fraction=k_fraction), dev, reps)

    def topk_only():
        for g, k in zip(stacked, ks):
            torch.topk(g.reshape(p, -1).abs(), k, dim=1)

    topk = wall_s(topk_only, dev, reps)
    ms = statistics.median(times) * 1e3
    topk_ms = statistics.median(topk) * 1e3
    out = {"p": p, "k_fraction": k_fraction, "leaves": len(sizes),
           "floats_per_rank": sum(sizes),
           "grads_gb": sum(g.numel() * 4 for g in stacked) / 1e9,
           "sync_ms": ms, "sync_min_ms": min(times) * 1e3,
           "sync_max_ms": max(times) * 1e3, "topk_ms": topk_ms,
           "topk_share": topk_ms / ms,
           "synced_err_over_scale": worst,
           "peak_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "offsets_shape": list(stats["compact_offsets"].shape)}
    del grads, err, stacked, stats
    torch.cuda.empty_cache()
    return out


def phase_cp_train(dev) -> dict:
    """Training through the context-parallel scans: (a) the cp scans'
    backward at the cp cells' shapes; (b) RWKV6-1.6B whole under fsdp_sp
    with remat "nothing" and "dots"; (c) the smoke rwkv6 (1, 4) and
    qwen2_moe (2, 4) under fsdp_sp in fp32, card against CPU; (d)
    ``sparse_gradient_sync``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    backward = cp_backward(dev)
    full = cp_train_full(dev)
    smoke = [smoke_train_on_card(dev, name, ranks,
                                 sharding_strategy="fsdp_sp")
             for name, ranks in (("rwkv6_1_6b", (1, 4)),
                                 ("qwen2_moe_a2_7b", (2, 4)))]
    torch.cuda.reset_peak_memory_stats(dev)
    sparse = {"smoke": sync_smoke(dev), "full": sync_full(dev)}
    return {"phase": "cp_train", "cp_backward": backward, "full": full,
            "smoke": smoke, "sparse_sync": sparse,
            "seconds": time.perf_counter() - t0,
            "reduced": "6 steps at B = 4, S = 512 (the train phase's "
                       "cell) with the sequence split over 8 model ranks "
                       "on one card; random weights from seed 0; the cp "
                       "backward at one layer's scan (B = 1, S = 4096) and "
                       "for cp_ssm at p = 8 only (Jamba's 262 144 floats a "
                       "token: 4.3 GB a leaf, seven of them live); the sync "
                       "at p = 2 data ranks, one step"}


# ---------------------------------------------------------------------------
# dryrun: the production-mesh dry run, and its trace held to the card
# ---------------------------------------------------------------------------

# (a) the dry run's CLI: (arch, shape, extra flags)
DRYRUN_CELLS = (("rwkv6_1_6b", "train_4k", []),
                ("qwen2_moe_a2_7b", "decode_32k", []),
                ("jamba_1_5_large_398b", "long_500k", []),
                ("qwen2_moe_a2_7b", "decode_32k",
                 ["--multi-pod", "--no-probes"]))
# (b) the steps the card runs, each traced at its own size:
# (label, arch, ranks, kind, batch, seq)
DRYRUN_STEPS = (("rwkv6_train", "rwkv6_1_6b", (1, 1), "train", 4, 512),
                ("rwkv6_prefill", "rwkv6_1_6b", (1, 1), "prefill", 4, 512),
                ("qwen_prefill", "qwen2_moe_a2_7b", (2, 4), "prefill", 4,
                 512))
PEAK_TOL = 0.10  # predicted peak against max_memory_allocated
FLOPS_TOL = 0.01  # traced FLOPs against FlopCounterMode on the card


def dryrun_cli(tmp: Path) -> list:
    """``launch.dryrun``'s CLI in this process on the card's host: each of
    ``DRYRUN_CELLS`` must come out ``ok``."""
    from repro_torch.launch import dryrun

    rows = []
    for arch, shape, extra in DRYRUN_CELLS:
        out = tmp / f"{arch}-{shape}{''.join(extra)}.json"
        t0 = time.perf_counter()
        rc, last = run_cli(dryrun, ["--arch", arch, "--shape", shape,
                                    "--json", str(out)] + extra,
                           tmp / f"{arch}-{shape}.log")
        cell = json.loads(out.read_text())[0] if out.exists() else {}
        if rc != 0 or cell.get("status") != "ok":
            raise AssertionError(f"dryrun {arch} {shape} {extra}: rc {rc}, "
                                 f"{cell.get('status')}: {last}")
        mem = cell["memory_analysis"]
        rows.append({"arch": arch, "shape": shape, "mesh": cell["mesh"],
                     "seconds": time.perf_counter() - t0,
                     "compute_s": cell["compute_s"],
                     "memory_s": cell["memory_s"],
                     "collective_s": cell["collective_s"],
                     "dominant": cell["dominant"],
                     "peak_gb": mem["peak_bytes"] / 1e9,
                     "fits_hbm": cell["fits_hbm"],
                     "kernel_launches": cell["kernel_launches"]})
    return rows


def dryrun_step(dev, label, name, ranks, kind, batch, seq, *,
                seed=0) -> dict:
    """One step the card runs, traced by ``lower_cell`` at its size and
    then run: (i) the trace's bound (its stacked FLOPs and bytes over the
    card's peaks: the card runs every rank) at most the call's busy
    time; (ii) the trace's peak within ``PEAK_TOL`` of the card's
    ``max_memory_allocated`` over the call (from before the model was
    built, reset before the call); (iii) the traced FLOPs within
    ``FLOPS_TOL`` of ``FlopCounterMode`` over the card's call; (iv) each
    kernel's meta-rule launches equal to the card's counters over the
    call."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.kernels import scan_engine as se
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw_init

    cfg = configs.get(name)
    spec = steps.ShapeSpec(f"{kind}_b{batch}_s{seq}", kind, seq, batch)
    t0 = time.perf_counter()
    comp = steps.lower_cell(cfg, spec, make_host_mesh(*ranks)).compile()
    trace_s = time.perf_counter() - t0
    compute_s = comp.flops_total / rl.PEAK_FLOPS
    memory_s = comp.bytes_total / rl.HBM_BW

    torch.cuda.empty_cache()
    sync(dev)
    base = torch.cuda.memory_allocated(dev)
    model = Model(cfg, ranks, device=dev)
    train = kind == "train"
    params = model.init_params(seed, trainable=train)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(1, cfg.vocab, (batch, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    if train:
        opt = adamw_init(params)
        batch_in = {"tokens": tokens, "labels": tokens.clone()}
        step = steps.make_train_step(cfg, ranks, model=model)

        def call():
            return step(params, opt, batch_in, 0)
    else:
        cache = model.init_cache(batch, seq)
        step = steps.make_serve_step(cfg, ranks, spec, model=model)

        def call():
            return step(params, cache, tokens, 0)

    call()  # the libraries' set-up
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = se.launch_counts()
    out = call()
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    after = se.launch_counts()
    launched = {k: after[k] - before.get(k, 0) for k in after}
    finite = all(bool(torch.isfinite(t).all()) for t in _leaves(
        out[2]["loss"] if train else out[0]))
    del out
    busy = device_busy_s(call, dev)
    with FlopCounterMode(display=False) as fc:
        call()
        sync(dev)
    card_flops = float(fc.get_total_flops())
    meta = {k: v for k, v in comp.kernel_launches.items() if v}
    card = {k: v for k, v in launched.items() if v}
    row = {"label": label, "arch": name, "ranks": list(ranks),
           "kind": kind, "batch": batch, "seq": seq, "trace_s": trace_s,
           "flops_traced": comp.flops_total, "flops_card": card_flops,
           "flops_ratio": comp.flops_total / card_flops,
           "bytes_traced": comp.bytes_total,
           "compute_s": compute_s, "memory_s": memory_s,
           "busy_s": busy,
           "bound_over_busy": (max(compute_s, memory_s) / busy
                               if busy else None),
           "peak_predicted_gb": comp.peak_bytes_total / 1e9,
           "peak_card_gb": peak / 1e9,
           "peak_ratio": comp.peak_bytes_total / peak,
           "launches_meta": meta, "launches_card": card,
           "finite": finite}
    del params, model, call, step
    torch.cuda.empty_cache()
    emit({"dryrun_check": row})
    if not finite:
        raise AssertionError(f"dryrun/{label}: non-finite output")
    if busy is None or max(compute_s, memory_s) > busy:
        raise AssertionError(f"dryrun/{label}: bound {compute_s:.4g}/"
                             f"{memory_s:.4g} s over busy {busy}")
    if abs(row["peak_ratio"] - 1) > PEAK_TOL:
        raise AssertionError(f"dryrun/{label}: peak {row}")
    if abs(row["flops_ratio"] - 1) > FLOPS_TOL:
        raise AssertionError(f"dryrun/{label}: flops {row}")
    if meta != card:
        raise AssertionError(f"dryrun/{label}: meta launches {meta}, the "
                             f"card's {card}")
    return row


def phase_dryrun(dev) -> dict:
    """The dry run: (a) its CLI on the production meshes; (b) its trace
    of three steps the card runs, held to the card; (c) the ratios."""
    import tempfile

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cli = dryrun_cli(Path(tmp))
    cli_s = time.perf_counter() - t0
    checks = [dryrun_step(dev, *s) for s in DRYRUN_STEPS]
    ratios = {r["label"]: {k: r[k] for k in (
        "bound_over_busy", "peak_ratio", "flops_ratio")} for r in checks}
    print(f"dryrun ratios: {json.dumps(ratios)}", flush=True)
    return {"phase": "dryrun", "cli": cli, "cli_seconds": cli_s,
            "checks": checks, "ratios": ratios,
            "tolerances": {"peak": PEAK_TOL, "flops": FLOPS_TOL},
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# the summary line
# ---------------------------------------------------------------------------

CS_SOURCE = "src/repro_torch/kernels/csrc/chunked_scan.cu"
MR_SOURCE = "src/repro_torch/kernels/csrc/moe_routing.cu"
TPU_ROUTING = "src/repro/kernels/moe_routing.py"

KERNEL_ROWS = (
    # name, wrapper, ⊕ filter (None: all), source, TPU kernel replaced,
    # its Pallas bodies
    ("combine", "combine", "elementwise", SE_SOURCE, f"{TPU_ENGINE}:245",
     "_combine_kernel :245, _masked_combine_kernel :249"),
    ("exchange", "exchange", "elementwise", SE_SOURCE, f"{TPU_ENGINE}:254",
     "_exchange_kernel :254"),
    ("scan_reduce", "scan_reduce", "elementwise", SE_SOURCE,
     f"{TPU_ENGINE}:263", "_scan_reduce_kernel :263"),
    ("combine_affine", "combine", "affine", SE_SOURCE, f"{TPU_ENGINE}:276",
     "_affine_combine_kernel :276, _affine_masked_kernel :282"),
    ("exchange_affine", "exchange", "affine", SE_SOURCE, f"{TPU_ENGINE}:290",
     "_affine_exchange_kernel :290"),
    ("scan_reduce_affine", "scan_reduce", "affine", SE_SOURCE,
     f"{TPU_ENGINE}:300", "_affine_scan_reduce_kernel :300"),
    ("monoid_exscan", "monoid_chunk", None, CS_SOURCE, f"{TPU_ENGINE}:152",
     "_scan_body :109 as monoid_exscan :192"),
    ("affine_chunk", "affine_chunk", None, CS_SOURCE, f"{TPU_ENGINE}:152",
     "_scan_body :109 as affine_chunk_scan :211, affine_chunk_summary "
     ":227"),
    ("moe_routing", "moe_routing", None, MR_SOURCE, f"{TPU_ROUTING}:54",
     "_routing_kernel :26"),
    ("affine_chunk_bwd", "affine_chunk_bwd", None, CS_SOURCE,
     f"{TPU_ENGINE}:152",
     "the gradient of _scan_body :109 as affine_chunk_scan :211 (the JAX "
     "package differentiates its XLA associative_scan instead)"),
)

# Rows no main path can launch, and why.
OFF_PATH = {
    "exchange": "every elementwise ⊕ is commutative, so no round runs the "
                "non-commutative butterfly exchange; checked bit for bit "
                "and timed in the kernels phase only",
}


def kernel_summary(timed: dict, launched: dict) -> list:
    """One row per kernel; ``launched`` holds the main path's launches
    by wrapper and ⊕."""
    rows = []
    for name, wrapper, ops, source, replaces, bodies in KERNEL_ROWS:
        by_op = launched.get(wrapper, {})
        n = sum(v for op, v in by_op.items()
                if ops is None or (op == "affine") == (ops == "affine"))
        t = timed[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "pallas_bodies": bodies,
               "launches": n,
               "max_abs_err": t["max_abs_err"], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"],
               "library_ms": t["library_ms"], "host_ms": t["host_ms"]}
        if name == "affine_chunk_bwd":  # at layer 0 of the train step
            row.update(shape=t["shape"], r=t["r"])
        if "wkv_broadcast" in t:  # affine_chunk at RWKV's prefill scan
            row["wkv_broadcast"] = {k: t["wkv_broadcast"][k] for k in (
                "shape", "r", "ms", "plain_ms", "bound_ms",
                "materialised_ms", "materialised_bound_ms")}
        if name in OFF_PATH:
            row["off_path"] = OFF_PATH[name]
        rows.append(row)
    idle = [r["name"] for r in rows
            if r["launches"] == 0 and r["name"] not in OFF_PATH]
    if idle:
        raise AssertionError(f"main path never launched {idle}")
    return rows


def phase_routing(dev, rate) -> dict:
    """``--routing-only``: the routing kernel built alone, then its row of
    the kernels phase with every cluster size timed."""
    from repro_torch.kernels import moe_routing as mr

    t0 = time.perf_counter()
    mr._lib()
    seconds = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(12)
    return {"phase": "routing", "build_seconds": seconds,
            "moe_routing": routing_path_times(dev, rate, gen,
                                              (64, 4096, 4, 64),
                                              ROUTE_SHAPES, 50, sweep=True)}


def children_left() -> list:
    """This process's children that still exist (zombies included), as
    (pid, command) pairs read from ``/proc``."""
    me, left = os.getpid(), []
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
            cmd = (entry / "cmdline").read_bytes()
        except OSError:
            continue
        if int(stat[stat.rindex(")") + 2:].split()[1]) == me:
            left.append((int(entry.name),
                         cmd.replace(b"\0", b" ").decode(errors="replace")))
    return left


def check_no_children() -> None:
    """Fail unless every process this script started is gone."""
    left = children_left()
    if left:
        raise RuntimeError(f"processes this script started still run: "
                           f"{left}")


def run_counted(phase, dev, launched: dict, lines: dict) -> None:
    """One path of the main path: every count set to 0 just before
    ``phase``, read just after into its line and summed into
    ``launched`` (by kernel and ⊕); the line is kept in ``lines`` and
    printed."""
    from repro_torch.kernels import scan_engine as se

    se.reset_launch_counts()
    t0 = time.perf_counter()
    line = phase(dev)
    line["phase_s"] = time.perf_counter() - t0
    line["launches"] = {}
    for name, fn in se.KERNELS.items():
        for op, n in fn.launches_by_op.items():
            by_op = launched.setdefault(name, {})
            by_op[op] = by_op.get(op, 0) + n
        if fn.launches:
            line["launches"][name] = fn.launches
    # the spmd, autotune and blocks phases' processes count their own,
    # and the clis phase sums its modules' launches
    for name, by_op in line.get("child_launches", {}).items():
        for op, n in by_op.items():
            into = launched.setdefault(name, {})
            into[op] = into.get(op, 0) + n
    lines[line["phase"]] = line
    emit(line)


T0 = time.perf_counter()  # the script's start: its whole time is printed


def main() -> int:
    # the port first: run alone, without the repository, this raises
    from repro_torch.kernels import scan_engine as se

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is present", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rate = hbm_rate(torch.cuda.get_device_name(0))
    if "--routing-only" in sys.argv[1:]:
        emit(phase_routing(dev, rate))
        print(card_info(), flush=True)
        return 0
    if "--spmd-only" in sys.argv[1:]:
        emit(phase_build())
        emit(phase_spmd(dev))
        print(card_info(), flush=True)
        close_shared()
        return 0
    if "--autotune-only" in sys.argv[1:]:
        emit(phase_build())
        se.reset_launch_counts()
        line = phase_autotune(dev)
        line["launches"] = {k: fn.launches for k, fn in se.KERNELS.items()
                            if fn.launches}
        emit(line)
        print(card_info(), flush=True)
        close_shared()
        return 0
    if "--blocks-only" in sys.argv[1:]:
        emit(phase_build())
        se.reset_launch_counts()
        line = phase_blocks(dev)
        line["launches"] = {k: fn.launches for k, fn in se.KERNELS.items()
                            if fn.launches}
        emit(line)
        print(card_info(), flush=True)
        close_shared()
        return 0
    if "--clis-only" in sys.argv[1:]:
        emit(phase_build())
        line = phase_clis(dev)
        emit(line)
        print(card_info(), flush=True)
        close_shared()
        return 0
    for flag, phase in (("--procs-only", phase_procs),
                        ("--cards-only", phase_cards),
                        ("--moe-only", phase_moe),
                        ("--tp-only", phase_tp),
                        ("--mixers-only", phase_mixers),
                        ("--fsdp-only", phase_fsdp),
                        ("--decode-ws-only", phase_ws),
                        ("--train-procs-only", phase_train_procs),
                        ("--fsdp-sp-only", phase_fsdp_sp)):
        if flag in sys.argv[1:]:
            emit(phase_build())
            se.reset_launch_counts()
            line = phase(dev)
            line["launches"] = {k: fn.launches
                                for k, fn in se.KERNELS.items()
                                if fn.launches}
            emit(line)
            print(card_info(), flush=True)
            close_shared()
            return 0
    for flag, phase in (("--train-only", phase_train),
                        ("--cp-train-only", phase_cp_train),
                        ("--dryrun-only", phase_dryrun)):
        if flag in sys.argv[1:]:
            emit(phase_build())
            se.reset_launch_counts()
            line = phase(dev)
            line["launches"] = {k: fn.launches
                                for k, fn in se.KERNELS.items()
                                if fn.launches}
            emit(line)
            print(card_info(), flush=True)
            return 0
    build = phase_build()
    emit(build)
    line, timed = phase_kernels(dev, rate)
    emit(line)
    launched: dict = {}
    lines: dict = {}
    # each path of the main path: counts set to 0 just before, read after
    for phase in (phase_table1, phase_serve, phase_ops, phase_cp_ssm,
                  phase_cp_wkv, phase_moe_dispatch, phase_composed,
                  phase_models, phase_train, phase_spmd,
                  functools.partial(phase_autotune, earlier=lines),
                  functools.partial(phase_blocks, earlier=lines),
                  phase_clis, phase_procs, phase_cards):
        run_counted(phase, dev, launched, lines)
    emit(phase_calibrate(dev, lines["table1"], lines["cp_ssm"]))
    run_counted(phase_cp_train, dev, launched, lines)
    run_counted(phase_dryrun, dev, launched, lines)
    timed["affine_chunk_bwd"] = lines["train"]["affine_chunk_bwd"]
    emit({"phase_seconds": {name: line["phase_s"]
                            for name, line in lines.items()},
          "script_s": time.perf_counter() - T0})
    emit({"kernels": kernel_summary(timed, launched)})
    print(card_info(), flush=True)
    close_shared()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
