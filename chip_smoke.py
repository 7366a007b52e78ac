#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (phc_gnn_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. card: the name and power limit that nvidia-smi reports;
2. build: every CUDA source of the port (phc_gnn_torch/csrc/*.cu) with nvcc,
   one compiler per source, all at once;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main paths' shapes (the CSRs of synthetic_batch(128, 4096, 8192, seed=0),
   D = 200; the batch norms D and E at [4096, 200], [129, 100] and
   [129, 768]; for the pcba
   path, the CSRs of its 128-graph and 512-graph batches at D = 512 and the
   row-blocked batch norm F, G at [4096, 512]) and on adversarial inputs: for the softmax kernels A and B an isolated node, an
   all-masked segment inside the edge array, a segment of 1,100 edges and
   |beta * m| up to ~88 with beta = -2.75 (where the plain segment max is the
   identity -2^100 the kernel must give it exactly; the other entries are
   held to the tolerance); for the segment sum C pcba's sender plan at
   D = 512, width 37 (the scalar instance), an isolated sender, a
   sender of 1,100 edges and a cotangent that is non-zero on masked edges,
   each output bit-equal on a second launch and to the sequential f32 sum
   in edge order (the plain version on the CPU); for A fused into B on
   float32 rows (both variants) the same inputs, width 37 and rows 8 and 4
   bytes off 16-byte alignment (two lanes and one lane a thread), its
   ``out``, ``w`` and ``den`` bit-equal to A then B and ``w`` 0 on the
   padding run; for the softmax backward the same inputs with a random
   cotangent, ``dm`` bit-equal to the plain backward on the card (0 on
   the padding run and masked edges) and ``dbeta`` within TOL_DBETA of the
   plain f32 sum and of a float64 sum of its terms, both bit-equal on a
   second launch;
   for the batch norms D and E, against their plain versions in float64,
   an all-masked and a one-row mask, the size gate's edges [109375, 8] and
   [4096, 213], a ragged width [4096, 203], one row [1, 200], columns at an
   offset of 1e3 with std 0.1, the rows of whole CTAs masked, and two
   launches that must be bit-equal; for the
   row-blocked batch norm F and G (each with its elementwise pass fused in),
   against their plain versions in float64, a ragged [1100, 24] with rows
   128-639 masked, an all-masked and a one-row mask, [32768, 512] (rows
   walked in chunks, x and g past the 50 MB L2), columns at an offset of
   1e3 with std 0.1, and two launches that must be bit-equal; for
   C's forward role (the masked sum aggregation) masked edges inside
   segments, an all-masked segment, an isolated node and a 1,100-edge
   segment, width 37 and rows off 16-byte alignment (the scalar
   instance), bit-equal as the gather backward; for the whitening kernels J, K (and its eval route, the
   Cholesky of the running covariance in its prologue), L (with the T/S/M
   algebra) and M, at [4096, 200] (d = 50) against their plain
   versions in float64, a ragged N = 1,100, d = 49, all-masked and one-row
   masks, a column offset of 1e3 with std 0.1, nearly collinear
   features (where K, L and M, fed the plain version's f32 statistics, are
   also read against float64) and the rows of J's first three CTAs masked,
   L and M in their frozen variants too (the eval whitening's backward),
   and the frozen L with dx (M's frozen dx written from its sweep: its
   dGamma, dbeta bit-equal to the frozen L's, its dx to M's frozen variant
   alone), J, L, the frozen L and the frozen L with dx each one CUDA kernel
   a call, bit-equal on a second launch, with every cluster of their plan
   on the card at once; for H (max
   and min) and I (mean and var) over the flagship's receiver CSR at D =
   200 with ReLU messages, exact ties, the adversarial receivers of A and B (one-edge, all-masked and isolated
   segments) and, for H, |m| >= 1e29: H bit for bit, I within TOL_SUM and
   var 0 exactly on one-edge segments; and the bf16 instances of A, B (both
   variants), A fused into B (both variants), the softmax backward (its
   ``dm`` bit-equal to the plain backward and to the float32 instance's on
   the upcast rows rounded to bf16) and C (both roles, the flagship's and
   pcba's shapes with the eval shape, width 37, bf16 rows off 16-byte
   alignment, the adversarial cases; C's bulk instance, rows staged by the
   TMA's bulk copy, wherever the rows allow it) on bf16 rows against their
   plain versions on the same rows (TOL_MAX, TOL_AGG, TOL_SUM: the
   conversion is exact), C bit-equal to the sequential f32 sum and its two
   instances to each other, the fused kernel's ``out``, ``w`` and ``den``
   bit-equal to A bf16 then B bf16, and every bf16 output bit-equal to
   the float32 instance fed the upcast rows.  Each is timed with CUDA events, eagerly and
   from a CUDA graph, beside its plain version, its bound and, where one
   exists, one PyTorch call that computes the same function; D + E are
   timed at [4096, 512] beside F and G, as data for the size gate between
   them;
4. eval slice: the flagship model (bench.py's config: PHCGNN phm_dim=4, width
   200, 4 x PHMGINEConvSoftmax, soft-attention pooling, (200, 100) -> 1 head)
   at random weights from a seed, with random running stats and betas,
   served through ``train.make_eval_step`` on 3 batches.  The launch
   counters are zeroed just before and read just after: A fused into B
   runs 4 times a batch; A and B alone, the softmax backward and the
   training kernels C, D and E never.  The outputs are held to
   the same model and batches on the CPU, where the kernels' plain versions
   run.  A CUDA batch without its CSR plan must raise.  The forward is timed
   from a CUDA graph and profiled (kernels per forward, device busy time and
   idle share);
5. train slice: the same model trained through ``train.make_train_step``
   (masked L1 plus lr * 0.1 * the PHM weight regularization, Adam after a
   global-norm clip of 2.0, lr 1e-3).  First, with dropout off, one forward
   and backward on the GPU against the same model and batch on the CPU: the
   loss, the output, every parameter's gradient (the CPU run repeated in
   float64 with the same ReLU pattern: a leaf whose f32 error on the CPU
   exceeds TOL_GRAD / COND_GRAD may differ by COND_GRAD times that error, up
   to TOL_GRAD_CAP) and the running stats, then the optimizer's update given
   the same gradients.  Then ten steps with the flagship's dropout on one
   batch, the counters zeroed just before and read just after: per step A
   fused into B, the softmax backward and C run 4 times, D and E 10, A
   and B alone never; the loss stays finite and falls.  A
   CUDA batch without its sender plan must raise.  Last, the step is timed
   and profiled;
6. pcba eval: the molpcba PHC-2 configuration (benchmarks/
   run_script_pcba_phm2.sh over DATASET_DEFAULTS["pcba"], built by
   ``train.trainer.build_model``: phm_dim 2, 7 x PHMConv with sum
   aggregation at width 512, sc_type "first", OGB encoders, a (768, 256) ->
   128 head) at random weights, random running stats, served through
   ``make_eval_step`` on a 512-graph batch (synthetic_batch(512, 16384,
   32768) with 9 atom and 3 bond features); only C's forward role runs, 7
   times.  Held to the CPU path, timed and profiled;
7. pcba train: the eager body of ``train.make_accum_train_step`` over K
   = 4 sub-batches of synthetic_batch(128, 4096, 8192, seed=0..3) with 0/1
   labels of 128 tasks, a share missing (NaN), under the masked BCE, Adam
   after a clip of 2.0, lr 1e-3.  One dropout-free step on the GPU against
   the CPU (loss, outputs, each accumulated gradient with the GPU's ReLU
   pattern replayed, under the rule of 5, running stats, the Adam update
   given equal gradients); then ten steps with the configuration's
   dropout, counters zeroed just before and read just after: per step F, G
   and C's two roles 28 times each, D and E 8; the loss stays finite and
   falls.  Timed and profiled.  Then the step as users call it, one CUDA
   graph of the whole accumulated step: its first call (3 eager warm-ups,
   the capture, one replay) under ``set_sync_debug_mode("error")``, the
   counters zeroed just before and read just after (PCBA_LAUNCHES four
   times); a replay's kernels counted by name in the profiler's trace, F
   and G told from D and E by their grid (28, 28, 8, 8, C 28 in each
   role); the graph timed and profiled beside the eager body, and the peak
   device memory of each; under torch's deterministic algorithms the graph
   held to the eager body at TOL_SCAN (losses, outputs, every parameter,
   running stat and Adam tensor) over 3 calls and one more at half the lr
   with dropout off, over 3 calls with dropout (do the replays draw the
   eager masks?), and over 2 calls with a fully masked sub-batch among the
   four; outside them one graphed call against one eager call within
   TOL_SCAN_ATOMICS, beside two eager calls;
8. quaternion eval: scripts/bench_presets.py's whitening configuration
   (``build("add", "q-batch-norm")``) through the port's
   ``QuaternionSkipConnectAdd``: the flagship's widths with
   ``QuaternionWhiteningNorm`` at the 8 conv sites, the frozen quaternion
   rule, random weights and running stats, on 3 batches: per batch K's
   eval route (the Cholesky folded in) runs 8 times, A fused into B 4.  Held to the CPU path; a CUDA
   graph of the forward replays to the eager output; timed and profiled;
9. quaternion train: one dropout-free step against the CPU as in 5 (a
   softmax beta's gradient, a sum that cancels, is where the float64 rule
   can widen a limit); then ten steps with dropout (per step J, K, L, M 8
   times, the fused softmax, its backward, C 4, D, E 2; the loss falls);
   timed over 30 steps after 5
   warm-ups and profiled;
10. quaternion concat: ``QuaternionSkipConnectConcat`` (``build("concat",
   "q-batch-norm")``: convs of 200/400/400/400 features, pooling and head
   at 400) on one batch against the CPU, and one dropout-free step as in 9;
11. quaternion eval gradient: the add preset's eval forward (running stats
   fixed) differentiated in every parameter on one batch, on the card
   (K's eval route, then the frozen L writing dx at the 8 sites, the
   fused softmax, its backward, C 4) against the CPU under the rule of 5; then in the input encoders'
   tables alone (input attribution: the whitening's Gamma and beta need no
   gradient, so each site runs M's frozen variant alone);
12. PNA eval: the ZINC PHC-4 recipe with ``--aggr_msg pna``
   (benchmarks/run_script_zinc_phm4.sh over DATASET_DEFAULTS["zinc"],
   built by ``build_model`` with ``avg_deg`` from ``degree_histogram`` of
   the flagship batch's graphs: phm_dim 4, width 200, 4 x
   ``PHMPNAConvSimple`` with mean, min, max, std and the identity,
   amplification and attenuation scalers, naive BN, ``sc_type`` "last",
   soft attention, a (128, 64) -> 1 head) on 3 batches: per batch C's
   forward role 4, H 8, I 4.  Held to the CPU path; a CUDA batch without its
   plan must raise; a CUDA graph of the forward replays to the eager output;
   timed and profiled;
13. PNA train: L1 loss, no weight decay, Adam after a clip of 2.0, lr 1e-3;
   one dropout-free step against the CPU as in 5, with the GPU's ReLU
   pattern, its extreme edges (where the min and max send the cotangent)
   and its var > 0 pattern (std's relu) replayed on the CPU; ten steps with
   the recipe's dropout (per step H 8, I 4, C 4 in each role, D and E 6;
   the loss falls); timed over 30 steps after 5 warm-ups and profiled;
14. scan: the scanned steps as CUDA graphs.  First the port's Adam (fused,
   capturable, its lr a device tensor) against torch's fused Adam with a
   float lr over two steps, bit-equal, both at LR itself (the parent's
   update) and at the lr tensor's float32 value.
   The main path: the flagship's ``make_scan_train_steps`` with its
   dropout, its first call (three eager warm-ups on a side stream, the
   capture, 8 replays over 8 batches of one bucket) under
   ``torch.cuda.set_sync_debug_mode("error")``, the counters zeroed just
   before and read just after; that graph timed and profiled; one graphed
   step of it against one eager step from the same weights, outside
   torch's deterministic algorithms, losses and outputs within
   TOL_SCAN_ATOMICS (two eager steps show what the pooling's atomics alone
   move).  Then,
   under the deterministic algorithms, with dropout off: 8 graphed steps
   held to 8 eager ``make_train_step`` calls from the same weights (losses
   and outputs within TOL_SCAN, every parameter, running stat and Adam
   state tensor within TOL_SCAN_STATE, bit-equality counted; an eager rerun
   outside them shows what the atomics move over 8 steps); 4 more steps at
   half the lr on both, beside an eager control at the old lr that must
   land far away; a flagship whose optimizer was built on the CPU before
   the model moved (its lr and state must follow to the card) against one
   built on the card, 2 graphed steps.  With the flagship's dropout: the
   graphed steps against
   eager steps from the same generator seed (do the replays draw the eager
   masks?) and two replays on one batch at lr 0 (their masks must differ).
   Graphed eval (``make_scan_eval_steps``) against ``make_eval_step`` for
   the flagship, the quaternion preset (K's eval route in a graph), PNA (H
   and I) on 3 batches and pcba's 512-graph batch (C's masked role at
   16,384 x 512), within TOL_SCAN.  The quaternion and PNA train steps
   captured (J-M's cluster launches in a graph) and held to 3 eager steps.
   Each eager and graphed step is timed and profiled: ms, kernels a step,
   device busy and idle share, the port's kernels a step counted by name in
   the profile (the counters do not see a replay), and no embedding
   backward or sort.
15. harness: the port's training CLI in-process
   (``cli.common.run_benchmark``: the loader with its native packer and CSR
   plans, prefetch to the card, the Trainer, checkpoints).  The synthetic
   recipe (``DATASET_DEFAULTS["synthetic"]``: the flagship's convs,
   ``scan_chunk`` 16, 4,096 / 512 / 512 graphs, bucket 3,456 / 7,424) for
   3 epochs: the wrappers' counters over the run hold 4 times a step's and
   an eval batch's launches (each graph's 3 warm-ups and capture), epoch
   2's train loop and the evaluation after it are profiled (per step the
   fused softmax, its backward, C 4, D, E 10; per eval batch the fused
   softmax 4, C, D, E none; device busy and idle
   share), the losses finite and falling; each epoch's steps/s, real
   edges/s and host ms (packing, plans, the move to the card, the loop's
   wait, the step's call).  Exact resume: 2 epochs then a resume for 1
   against 3 straight, dropout on, torch's deterministic algorithms on,
   every checkpointed tensor, the scheduler's JSON and every scalars row
   (timings aside) bit-equal.  The molpcba recipe
   (benchmarks/run_script_pcba_phm2.sh's flags, ``grad_accum`` 4) for 1
   epoch on ``data.parity``'s pcba task (6,000 / 800 / 800 graphs, 8 tasks
   with NaN holes): counters 4 times the accumulated step's (F, G, C's two
   roles 28, D, E 8) and an eval batch's (one graph a (K, bucket)), the
   epoch's profile per step, the last group (3 real sub-batches and a
   dummy) held to the eager body over its real sub-batches within
   TOL_GROUP, the graphed step timed.  The ZINC recipe
   (run_script_zinc_phm4.sh's flags) for 3 epochs on the zinc parity task
   under deterministic algorithms (C in both roles, no A or B; epoch 1
   timed, epoch 2 profiled), then ``cli.inference`` restores run 1's best
   export and reproduces ``test_bestval`` bit for bit.
16. bf16 flagship: ``compute_dtype=torch.bfloat16`` at width 200.  One
   dropout-free training forward and backward on the card and on the CPU,
   each in float32 and bf16 from one random state.  Each conv, norm, the
   pooling and the head, fed the CPU bf16 run's own inputs (forward and
   the VJP of a seeded cotangent): the card's bf16 module within
   BF16_MODULE_FACTOR of the CPU bf16 module's distance from the CPU f32
   module (2-norms; the gradients over the input and the leaves that are
   not rounding noise), and the card's f32 modules in their place fail
   that check (the control).  The whole model: the card's bf16 output and
   gradients from its f32 ones within BF16_OWN_BAND of the CPU bf16
   model's distance from the CPU f32 model, the bf16 output's largest
   entry error and the loss within BF16_F32_BOUND of the f32 ones, the
   card's bf16 run against the CPU's within the gross BF16_WHOLE_FACTOR
   of that distance (two bf16 runs whose f32 sums differ in order part by
   nearly as much as bf16 from f32, so an f32 model passes this bound
   too); parameters' gradients float32 and finite, the output float32.  Three
   eager steps with dropout, counted (the fused softmax, its backward and
   C's gather backward in their bf16 instances 4 a step, D and E 10, no
   A, B or float32 C), then the dropout-free bf16 model served on 3 batches (the fused
   softmax 4 a batch, no A or B); the graphed
   steps' first call under ``set_sync_debug_mode("error")``, counted;
   graphed steps held bit-equal to eager ones under the deterministic
   algorithms as in 14; eager and graphed ms, kernels, busy and idle of
   the f32 and the bf16 step in the same process, the graphs timed again in
   turns, and the peak memory of each graph's first call (its own: above
   what was allocated before it, as every peak of 16-18);
17. bf16 pcba: ``make_accum_train_step`` (K = 4, one CUDA graph) in bf16
   and float32: each first call under ``set_sync_debug_mode("error")``, the
   bf16 one counted (C's two roles in their bf16 instances 28 each, the
   sum aggregation's on C's bulk instance by the plan, F, G 28, D, E 8),
   its peak memory; the eval forward of both on the 512-graph
   batch, the bf16 one counted (C's bf16 instance 7, its bulk instance by
   the plan; ``bf16_kernels`` holds the two instances bit-equal at this
   shape); the graphed step timed in turns (f32, bf16, bf16, f32) and
   profiled;
18. remat: the flagship and pcba with ``remat=True`` against
   ``remat=False`` from one random state, under the deterministic
   algorithms with dropout off: one eager forward and backward (loss,
   every gradient and running stat bit-equal, the stats moved, so updated
   once), then 3 graphed steps (``make_scan_train_steps``, or pcba's
   ``make_accum_train_step``: captured with the recompute inside) with
   every parameter, running stat and Adam tensor bit-equal; with dropout
   one eager step counted (the convs' forward kernels twice: the fused
   softmax 8, its backward 4, C 4, D 14, E 10; pcba's C masked 56), and each model's peak memory over an
   eager step and over its graph's first call, its eager and graphed ms;
19. harness bf16: the ZINC recipe through the CLI with ``--compute_dtype
   bf16`` for 2 epochs on the zinc parity task: C's bf16 instances alone
   (counted over each graph's warm-ups and capture), the losses finite and
   falling.
20. halo: the multi-rank paths.  First C's halo role
   (``halo_gather_split_bwd``: the gather backward over a node shard's
   augmented ``[NS + S*H]`` rows, split into the local and the halo
   cotangents) against its plain version on shard 0 of the flagship batch
   cut in 2 and 4 and on pcba's width 512 cut in 2, in f32 and on bf16
   rows (bit-equal to the f32 instance on the upcast rows), and on an empty
   halo, every edge remote and a run of masked edges on the last local
   row; each bit-equal on relaunch and to the sequential f32 sum; timed
   (per call, device from a CUDA graph, bound, one ``index_add_``).  Then
   gloo rank processes (``spawn``) that share the card, each on cuda:0
   with the flagship at full width from one random state, dropout off,
   torch's deterministic algorithms on: the np step on 2 and on 4 node
   shards (rank 0's counters zeroed just before and read just after: A,
   B and the halo role 4, D and E 2 in the head), the dp step with a
   dummy rank, and dp 2 x ep 2; each rank's ReLU pattern is recorded and
   the single-device step on the card replays it, and rank 0's loss, its
   reduced gradients (per leaf), its running stats and its Adam update
   are held to that step, every rank's parameters bit-equal; the ranks'
   step ms (time-sliced on one card: not a scaling number).  Last the
   Trainer (``cli.common.build_trainer`` under the ranks' process group)
   on dp 2 x ep 2 ranks for an epoch of the synthetic recipe, dropout off,
   against the single-device Trainer with ``grad_accum`` 2, which forms
   the same load-weighted groups: the epoch's train loss.  The replicated
   scheme (``PHCGNN.set_edge_axis``, ``parallel.edge_shard``) inside the same
   two starts: on 2 ranks the ep step on 2 edge shards, on 4 dp 2 x ep 2
   and its Trainer, each held as above to the single-device step on the
   composite route (every mask of rank (d, 0) replayed: the nodes are
   replicated), rank 0's counters D and E 10 a step and no A, B or C; the
   np step on 2 shards run again with the card synced before each
   collective and the host clock around it: the collectives' share of a
   rank's step.
21. xla: the flagship at full width on the composite route
   (``PHCGNN(composite=True)``, what ``agg_kernel="xla"`` builds, batches
   without CSR plans).  The graphed steps (``make_scan_train_steps`` over
   8 batches, dropout on), first call under ``set_sync_debug_mode("error")``,
   counted (D and E 10 a step, no A, B or C); one dropout-free step
   against the CPU's composites (the rule of 5) and against the plan route
   on the card (the composite run's ReLU pattern replayed); 3 graphed steps
   against eager ones under the deterministic algorithms as in 14; the
   eval forward on 3 batches against the CPU and the plan route, graphed
   against eager; PNA's eval on the route against the CPU and the plan
   route; then the graphed step and eval on both routes in turns (plan,
   xla, xla, plan): ms, kernels, busy and idle, the port's kernels a step.
22. export: the eval forward through ``phc_gnn_torch.export`` (``torch.export``,
   its kernels ``torch.library`` ops).  The flagship at full width with
   random eval state, exported at the main path's bucket in float32 and
   in bf16: the graph calls the kernels' ops (the fused op 4), no
   ``scatter_reduce`` and the pooling's one ``index_add_``; one exported
   call launches what one eager call launches (the fused kernel 4, no A
   or B), its output bit-equal to the eager
   ``make_eval_step``'s under the deterministic algorithms and, in
   float32, within TOL_SCAN_ATOMICS without them (the pooling's atomics;
   two bf16 eager calls part by ~1e-2 there).  The f32 program
   saved, then loaded and called in a child process that imports only
   ``phc_gnn_torch.export``:
   bit-equal, the fused kernel 4 there, ``phc_gnn_torch.models`` never
   imported.  The quaternion preset, PNA and pcba's 512-graph eval
   exported: their launches those of the eager eval (K's eval route 8,
   the fused softmax 4; C 4, H 8, I
   4; C 7), their outputs bit-equal to it under the deterministic
   algorithms (TOL_SCAN).  The eager eval, the
   exported program and the graphed eval in turns (EXPORT_TURNS): ms a
   batch, kernels, busy, idle; A's and B's eval variant per call through
   their ops and through the bare launch, in turns; and
   ``torch.library.opcheck`` of every kernel op on CUDA inputs at the
   flagship's shapes.
23. convergence: the quat parity task trained whole on the card through
   ``phc_gnn_torch.cli.parity`` (the counterpart of
   scripts/run_convergence_parity.py): the CLI's defaults (CSR plans,
   graphed steps), 40 epochs on the 6,000 / 800 / 800 graphs of
   ``data.parity`` (generator seed 7) from the committed init
   (parity_runs/quat/init_params.pkl), at the committed record's widths
   (96, 3 convs: the parity tasks run at about half the canonical widths).
   The counters over the run hold each graph's warm-ups and capture of a
   step (C in both roles 3, J-M 6, D, E 2) and of an eval batch (C 3, K's
   eval route 6); every train loss, valid loss and valid MAE finite; the
   valid MAE cut by more than CONVERGENCE_GAIN from epoch 0.  The
   endpoints and ``hold``'s misses against the reference's committed half
   are printed beside the reference's, JAX's and the card's committed
   record's, and not held: they move with dropout masks and shuffle order.
24. nccl (run right after halo): the multi-rank steps as CUDA graphs on
   NCCL ranks that share the card (``nccl_rank_main``: each rank names a
   host of its own with ``NCCL_HOSTID``, as NCCL refuses two ranks of one
   host on one GPU, and talks over the socket transport on loopback), in
   two starts: on 2 ranks the np step on 2 node shards, the dp step with
   a dummy rank and the replicated ep step on 2 edge shards; on 4 dp x
   ep in both schemes and the Trainer on dp 2 x ep 2 in both schemes
   (graphed steps and evals), against the single-device Trainer with
   ``grad_accum`` 2.  Each step, from one state: the graphed step against
   the eager step on the same ranks (dropout off, deterministic
   algorithms) bit-equal on 2 and 4 ranks (TOL_NCCL_GRAPH);
   against the single-device step on the card (``hold_halo``, the eager
   ReLU pattern replayed); with dropout, the replays' losses and
   parameters against the eager steps'; one replay's kernels on rank 0,
   from its profile, equal to the eager counters; rank 0's eager and
   graphed ms a step (time-sliced ranks: not a scaling number).
25. sweeps (the last phase): the flagship as the port's sweeps drive it
   (``phc_gnn_torch.cli.scaling``, ``phc_gnn_torch.cli.ablation``, the
   counterparts of scripts/bench_scaling.py and scripts/bench_ablation.py).
   First its kernels at the scaling sweep's 2x, 4x and 8x buckets (8,192,
   16,384 and 32,768 nodes, width 200): A fused into B in both variants
   bit-equal to A then B, the softmax backward (``dm`` bit-equal to the
   plain backward, ``dbeta`` within TOL_DBETA), C's gather backward
   (TOL_SUM against float64, bit-equal to the sequential f32 sum), F and G
   at the conv norms' [N, 200], past the size gate (TOL_BN against
   float64, bit-equal on relaunch).  Then the flagship at the 8x bucket
   (``synthetic_batch(1024, 32768, 65536)``): one dropout-free step
   against the CPU as in 5 (the counters zeroed just before and read just
   after: the fused softmax, its backward and C 4, F and G 8 on the conv
   norms, D and E 2 on the head's, as ``ablation.step_launches`` writes
   them down from the size gate before the run), and 3 graphed steps
   against eager ones under the deterministic algorithms (TOL_SCAN, as in
   14).  Then each of the 13 ablation variants on its batch and route
   (``ablation.build``, ``ablation.batch``): one graphed step against one
   eager step under the deterministic algorithms (TOL_SCAN), its losses
   finite, the counters over the check (its eager steps, the graph's
   warm-ups and capture) equal to ``ablation.variant_launches`` a step.
   No timing: the two commands time.

It prints ``{"slice"}``, ``{"profile"}``, ``{"train"}``,
``{"profile_train"}``, ``{"pcba"}``, ``{"quat"}``, ``{"pna"}``,
``{"scan"}``, ``{"bf16"}``, ``{"remat"}``, ``{"harness"}``,
``{"harness_bf16"}``, ``{"halo"}``, ``{"nccl"}``, ``{"xla"}``, ``{"export"}``,
``{"convergence"}``, ``{"sweeps"}``, ``{"phase_seconds"}`` and
``{"kernels": [...]}``
lines, then, as its last line, ``{"ok": true, "device": {...}}``.  The
kernels line lists the bf16 kernels as kernels of their own
(``<name>_bf16``, counted by the wrappers' ``launches_bf16``): A fused into
B (``segment_softmax_fused_bf16``, with A bf16 and B bf16, which no main
path runs any more, timed beside it under ``parent_pair``) and C's two
roles.  In it,
each kernel's ``launches_by_path`` holds its count from each of the
main-path runs above (``eval``: 3 flagship batches; ``train``: 10 flagship steps;
``pcba_eval``: 1 batch; ``pcba_train``: 10 accumulated steps of the eager
body; ``pcba_graph``: the graphed accumulated step's first call, whose
wrappers count the 3 warm-ups and the capture, not the replay;
``quat_eval``: 3 batches; ``quat_train``: 10 steps; ``quat_concat_eval``: 1
batch; ``quat_eval_grad``: 1 batch; ``quat_eval_attr``: 1 batch;
``pna_eval``: 3 batches; ``pna_train``: 10 steps; ``scan_train``: the
graphed flagship call, whose wrappers count the 3 warm-ups and the capture,
not the replays; ``harness_synthetic``, ``harness_pcba``, ``harness_zinc``:
the three CLI runs of the harness, whose wrappers count each graph's
warm-ups and capture; ``bf16_train``: 3 eager bf16 flagship steps;
``bf16_eval``: 3 bf16 flagship batches served; ``bf16_scan``: the bf16
graphed steps' first call; ``bf16_pcba``: the bf16 accumulated graph's
first call; ``bf16_pcba_eval``: 1 bf16 pcba batch; ``remat_flagship``,
``remat_pcba``: one eager step each with remat; ``harness_bf16``: the bf16 CLI run;
``halo_np2``, ``halo_np4``, ``halo_dp_dummy``, ``halo_dp_ep``: rank 0's
counts over one multi-rank step; ``halo_trainer``: rank 0's over its
Trainer run; ``ep_ep2``, ``ep_dp_ep``, ``ep_trainer``: the same for the
replicated scheme; ``nccl_np2``, ``nccl_dp_dummy``, ``nccl_ep2``,
``nccl_dp_ep``, ``nccl_ep_dp_ep``: rank 0's counts over one eager step
on NCCL ranks; ``nccl_trainer``, ``nccl_ep_trainer``: rank 0's over its
graphed Trainer run (each graph's warm-ups and capture); ``xla_train``:
the composite route's graphed call;
``xla_eval``, ``xla_pna_eval``: 3 batches each; ``export_f32``,
``export_bf16``, ``export_quat``, ``export_pna``, ``export_pcba``: one
call of each exported program; ``convergence``: the quat parity run,
whose wrappers count each graph's warm-ups and capture;
``sweeps_bucket_step``: one step at the 8x bucket; ``sweeps_bucket_scan``
and ``sweeps_<variant>``: the graphed-against-eager checks of the 8x
bucket and of each ablation variant, eager steps, warm-ups and
captures), and ``launches`` is their sum; C's halo role has a row of
its own (``halo_gather_split_bwd``).  Without
a CUDA device it exits non-zero and prints no result.  It imports nothing
of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import math
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM, f32 outside the tensor cores
TOL_MAX = 1e-6              # segment max: order-free, the same f32 products
TOL_AGG = 1e-5              # softmax aggregate: exp ulps, summation order
TOL_DBETA = 1e-5            # the softmax backward's dbeta against the plain
                            # backward's f32 sum and a float64 sum of the
                            # same terms, over the sum of their magnitudes:
                            # E x D signed terms that cancel (the kernel
                            # sums them in float64, the plain version in
                            # f32)
TOL_SUM = 1e-5              # segment sum, per leaf, against a float64 sum:
                            # the kernel's f32 running sum of 1,100 rows
                            # drifts ~1e-6 of the leaf's max; one row
                            # dropped or added reads ~1e-2
TOL_BN = 1e-5               # batch norms: column sums of 4,096 rows, rsqrt
TOL_MODEL = 1e-4            # whole model, GPU vs CPU: 4 layers of f32 GEMMs
TOL_GRAD = 1e-4             # gradients, GPU vs CPU, per leaf: forward and
                            # backward through 4 layers, sums in other orders
TOL_NOISE = 1e-5            # |grad| of a bias a batch norm follows (zero in
                            # exact arithmetic), over the largest gradient
TOL_UPDATE = 1e-5           # Adam update given equal gradients, per leaf
TOL_WBN = 1e-5              # whitening kernels against their plain versions
                            # in float64, per output: column sums of 4,096
                            # rows in f32 through a 4x4 Cholesky
COND_WBN = 4.0              # ... or, where f32 itself cannot reach that
                            # (the offset and collinear inputs), within 4x
                            # the plain version's own f32 error against
                            # float64: the kernels read 0.39-0.51x of it on
                            # the offset, 1.8-2.75x on the collinear input
COND_GRAD = 10.0            # a gradient leaf may differ from the CPU's by
TOL_GRAD_CAP = 1e-3         # 10x the CPU's own f32 error against float64
                            # where that exceeds TOL_GRAD, but by no more
                            # than 1e-3: the quaternion step's softmax beta
                            # (a sum that cancels; CPU f32 error 1.9e-5)
                            # read 2.4-5.5x that error on the GPU over five
                            # runs, the atomics' order differing
TOL_REPLAY = 1e-6            # a CUDA graph's replay against the eager
                            # forward: the same kernels, but the pooling's
                            # index_add_ adds in the order its atomics land
TOL_SCAN_ATOMICS = 1e-5      # one graphed train step against one eager step
                            # outside torch's deterministic algorithms,
                            # losses and outputs normwise: on an H100 two
                            # eager steps part by 9.3e-8 (loss) and 5.7e-7
                            # (outputs), the graph by 0 and 7.3e-7, all the
                            # pooling's atomics; over 10x that margin
TOL_SCAN = 0.0               # graphed steps or evals against eager ones,
                            # losses and outputs normwise, under torch's
                            # deterministic algorithms: the same kernels in
                            # the same order, bit-equal
TOL_SCAN_STATE = 0.0         # ... and per tensor of the state after them
LR_MOVED = 1e-3              # an lr halved for 4 steps moves some state
                            # tensor by more than this, relative to its size
MASKS_DIFFER = 1e-3          # two dropout draws move the outputs by more
SCAN_STEPS = 8               # graphed flagship steps held to eager ones
SCAN_FAMILY_STEPS = 3        # ... quaternion and PNA steps
N_BATCHES = 3
FLAGSHIP = dict(batch_size=128, num_nodes=4096, num_edges=8192)
DIM = 200
LR = 1e-3
WEIGHT_DECAY = 0.1
GRAD_CLIP = 2.0
TRAIN_STEPS = 10
# launches per train step: A fused into B, the softmax backward and C once
# per layer (A and B alone never); D and E once per norm (4 in the convs'
# MLPs, 4 after the convs, 2 in the downstream head)
SOFTMAX_TRAIN = {"segment_softmax_fused": 4, "segment_softmax_backward": 4,
                 "segment_logit_max": 0, "segment_softmax_aggregate": 0}
SOFTMAX_EVAL = {"segment_softmax_fused": 4, "segment_logit_max": 0,
                "segment_softmax_aggregate": 0}
TRAIN_LAUNCHES = {**SOFTMAX_TRAIN, "segment_sum_perm": 4, "bn_forward": 10,
                  "bn_backward": 10}
# the molpcba PHC-2 configuration (benchmarks/run_script_pcba_phm2.sh)
PCBA_DIM = 512
PCBA_LAYERS = 7
PCBA_TASKS = 128
PCBA_K = 4                  # grad_accum
PCBA_FEATS = dict(target_dim=PCBA_TASKS, num_node_feats=9, num_edge_feats=3)
PCBA = dict(batch_size=128, num_nodes=4096, num_edges=8192, **PCBA_FEATS)
PCBA_EVAL = dict(batch_size=512, num_nodes=16384, num_edges=32768,
                 **PCBA_FEATS)
PCBA_STEPS = 10
PCBA_GRAPH_STEPS = 3        # graphed accumulated steps held to the eager body
PCBA_REPLAYS = 5            # replays profiled for the kernels' grids
# the quaternion family with whitening batch norm (scripts/bench_presets.py
# build(family, "q-batch-norm")): per train step J, K, L, M at the 8
# whitening sites (4 in the convs' MLPs, 4 after the convs), the softmax
# (fused forward, backward) and C once per layer, D and E in the head's 2
# norms; per eval batch the running stats' Cholesky and K in one launch at
# the 8 sites, the fused softmax once per layer
QUAT_TRAIN_LAUNCHES = {"wbn_stats": 8, "wbn_transform": 8, "wbn_bwd_sums": 8,
                       "wbn_dx": 8, **SOFTMAX_TRAIN, "segment_sum_perm": 4,
                       "bn_forward": 2, "bn_backward": 2}
QUAT_EVAL_LAUNCHES = {"wbn_transform": 8, **SOFTMAX_EVAL}
QUAT_STEPS = 10
# the eval whitening's backward (fine-tuning with frozen running stats):
# per quaternion batch the eval forward's kernels, then at the 8 sites the
# frozen L writing dx in the same launch, and the softmax backward and C's
# gather backward once per layer
QUAT_EVAL_GRAD_LAUNCHES = {**QUAT_EVAL_LAUNCHES, "wbn_bwd_sums": 8,
                           "segment_softmax_backward": 4,
                           "segment_sum_perm": 4}
# ... and with the gradient in the input encoders alone (attribution), M's
# frozen variant alone at the 8 sites
QUAT_EVAL_ATTR_LAUNCHES = {**QUAT_EVAL_LAUNCHES, "wbn_dx": 8,
                           "segment_softmax_backward": 4,
                           "segment_sum_perm": 4}
# PNA (benchmarks/run_script_zinc_phm4.sh --aggr_msg pna): per layer the mean
# through C's forward role, the min and the max through H, the std through I
PNA_DIM = 200
PNA_LAYERS = 4
PNA_EVAL_LAUNCHES = {"segment_sum_masked": 4, "segment_extreme": 8,
                     "segment_moments": 4}
# ... and per train step C's gather backward once per layer, D and E in the
# 4 norms after the convs and the head's 2
PNA_TRAIN_LAUNCHES = {**PNA_EVAL_LAUNCHES, "segment_sum_perm": 4,
                      "bn_forward": 6, "bn_backward": 6}
PNA_STEPS = 10
# the flags of benchmarks/run_script_zinc_phm4.sh, then --aggr_msg pna, over
# DATASET_DEFAULTS["zinc"]
PNA_SCRIPT = dict(dataset="zinc", phm_dim=4, model_type="add", sc_type="last",
                  aggr_msg="pna", mlp_mp=True, input_embed_dim=PNA_DIM,
                  mp_units=(PNA_DIM,) * PNA_LAYERS, d_units=(128, 64),
                  dropout_mpnn=(0.0,) * PNA_LAYERS, dropout_dn=(0.2, 0.1),
                  batch_size=128, lr=1e-3, patience=20, factor=0.5,
                  min_lr=1e-7, epochs=1000, weightdecay=0.0)
# per accumulated step, K = 4 sub-batches: the sum aggregation (C forward)
# and the gather backward (C backward) once per layer; the blocked norm (F,
# G) after each of the 7 convs ([4096, 2, 256], 8.39 MB, over the 3.5 MB
# gate); D and E in the head's 2 norms
PCBA_LAUNCHES = {"segment_sum_masked": 28, "segment_sum_perm": 28,
                 "bn_forward_blocked": 28, "bn_backward_blocked": 28,
                 "bn_forward": 8, "bn_backward": 8}
PCBA_EVAL_LAUNCHES = {"segment_sum_masked": PCBA_LAYERS}
# compute_dtype=bf16: C reads bf16 messages through its bf16 instances
# (counted apart, "<wrapper>_bf16"), and the softmax aggregation through the
# fused kernel (A's function then B's in one launch) and the backward
# kernel, not A and B, whose bf16 instances stay public and held; the norms
# upcast, so D-G run as in float32
BF16_KERNELS = ("segment_logit_max", "segment_softmax_aggregate",
                "segment_softmax_fused", "segment_softmax_backward",
                "segment_sum_perm", "segment_sum_masked")
BF16_TRAIN_LAUNCHES = {"segment_softmax_fused_bf16": 4,
                       "segment_softmax_backward_bf16": 4,
                       "segment_logit_max_bf16": 0,
                       "segment_softmax_aggregate_bf16": 0,
                       "segment_sum_perm_bf16": 4, "bn_forward": 10,
                       "bn_backward": 10}
BF16_EVAL_LAUNCHES = {"segment_softmax_fused_bf16": 4,
                      "segment_logit_max_bf16": 0,
                      "segment_softmax_aggregate_bf16": 0}
PCBA_BF16_LAUNCHES = {"segment_sum_masked_bf16": 28,
                      "segment_sum_perm_bf16": 28, "bn_forward_blocked": 28,
                      "bn_backward_blocked": 28, "bn_forward": 8,
                      "bn_backward": 8}
# ... and pcba's bf16 eval forward on its 512-graph batch: the sum
# aggregation on C's bulk instance (by the plan, as in the train step)
PCBA_BF16_EVAL_LAUNCHES = {"segment_sum_masked_bf16": PCBA_LAYERS}
BF16_STEPS = 3              # eager bf16 flagship steps counted
BF16_SCAN_STEPS = 4         # graphed bf16 steps held to eager ones
# the flagship's modules held one by one at the CPU bf16 run's own inputs
BF16_MODULES = tuple(n for i in range(4) for n in (f"conv_{i}", f"norm_{i}")
                     ) + ("pooling", "downstream")
BF16_MODULE_FACTOR = 0.25   # a card bf16 module against the CPU's bf16
                            # module, as a share of the CPU bf16 module's
                            # distance from the CPU f32 module (2-norms of
                            # the output and of the gradients)
BF16_OWN_BAND = (0.5, 2.0)  # the card's bf16 model from its f32 model, as a
                            # share of the CPU bf16 model's distance from
                            # the CPU f32 model (output and gradients)
BF16_WHOLE_FACTOR = 1.0     # the card's whole bf16 model from the CPU's, the
                            # same share: a gross bound only (an f32 model
                            # passes it; two bf16 runs part layer by layer)
BF16_F32_BOUND = 0.05       # tests/test_bf16.py: a bf16 output within 5 % of
                            # the f32 one
# remat=True: the backward recomputes each conv, so its forward kernels run
# twice a step: the fused softmax 4 + 4, D 10 + the 4 MLP norms inside the
# convs; pcba's sum aggregation 28 + 28 (its norms sit outside the convs)
REMAT_TRAIN_LAUNCHES = {**SOFTMAX_TRAIN, "segment_softmax_fused": 8,
                        "segment_sum_perm": 4, "bn_forward": 14,
                        "bn_backward": 10}
PCBA_REMAT_LAUNCHES = {**PCBA_LAUNCHES, "segment_sum_masked": 56}
REMAT_STEPS = 3             # graphed steps held bit-equal to remat=False
# the flags of benchmarks/run_script_pcba_phm2.sh over DATASET_DEFAULTS["pcba"]
PCBA_SCRIPT = dict(dataset="pcba", phm_dim=2, model_type="add", aggr_msg="sum",
                   mlp_mp=False, input_embed_dim=PCBA_DIM,
                   mp_units=(PCBA_DIM,) * PCBA_LAYERS, d_units=(768, 256),
                   dropout_mpnn=(0.3,) * PCBA_LAYERS, dropout_dn=(0.4, 0.2),
                   batch_size=128, grad_accum=PCBA_K, max_nodes=4096,
                   max_edges=8192, eval_batch_size=512, lr=1e-3, patience=5,
                   factor=0.75, epochs=150, weightdecay=0.0)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def normwise(got, want, identity=None):
    """(max abs err, max abs err / max(1, max |want|)) over the entries where
    ``want`` is not ``identity`` (the max identity of an empty segment).
    Those must hold ``identity`` exactly in ``got``, or both errors are inf."""
    got, want = got.double(), want.double()
    if identity is not None:
        empty = want == identity
        if not bool((got[empty] == identity).all()):
            return float("inf"), float("inf")
        got, want = got[~empty], want[~empty]
    if want.numel() == 0:
        return 0.0, 0.0
    err = float((got - want).abs().max())
    return err, err / max(1.0, float(want.abs().max()))


def leafwise(got, want):
    """(max abs err, max abs err / max |want|): relative to the tensor's own
    size, for values far below 1.  Where ``want`` is all zero, ``got`` must
    be too, or both errors are inf."""
    got, want = got.double().cpu(), want.double().cpu()
    if not bool(got.isfinite().all()):
        return float("inf"), float("inf")
    err = float((got - want).abs().max()) if want.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    if scale == 0.0:
        return (0.0, 0.0) if err == 0.0 else (float("inf"), float("inf"))
    return err, err / scale


def time_eager(torch, fn, iters: int = 200, warmup: int = 10) -> float:
    """ms per call of ``fn`` as the caller pays it: host launch included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_graph(torch, fn, iters: int = 100, reps: int = 5) -> float:
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA graph,
    replayed; the median of ``reps`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def kernel_wrappers():
    """The launch-counting wrapper of every kernel of the port, A to G with
    C's two roles, J to M (K with its eval route, L and M with their frozen
    variants), H and I, A fused into B and the softmax backward."""
    from phc_gnn_torch.ops import fused_bn
    from phc_gnn_torch.ops import fused_whitening as fw
    from phc_gnn_torch.ops import segment_reduce as sr
    from phc_gnn_torch.ops import segment_softmax as ss
    from phc_gnn_torch.ops import segment_sum as ssum

    return {"segment_logit_max": ss.segment_logit_max,
            "segment_softmax_aggregate": ss.segment_softmax_aggregate,
            "segment_softmax_fused": ss.segment_softmax_fused,
            "segment_softmax_backward": ss.segment_softmax_backward,
            "segment_sum_perm": ssum.segment_sum_perm,
            "segment_sum_masked": ssum.segment_sum_masked,
            "bn_forward": fused_bn.bn_forward,
            "bn_backward": fused_bn.bn_backward,
            "bn_forward_blocked": fused_bn.bn_forward_blocked,
            "bn_backward_blocked": fused_bn.bn_backward_blocked,
            "wbn_stats": fw.wbn_stats,
            "wbn_transform": fw.wbn_transform,
            "wbn_bwd_sums": fw.wbn_bwd_sums,
            "wbn_dx": fw.wbn_dx,
            "segment_extreme": sr.segment_extreme,
            "segment_moments": sr.segment_moments,
            "halo_gather_split_bwd": ssum.halo_gather_split_bwd}


def counter_names() -> list:
    """Every launch counter: the wrappers', then the bf16 instances' of A,
    B and C (``<wrapper>_bf16``)."""
    return list(kernel_wrappers()) + [f"{n}_bf16" for n in BF16_KERNELS]


def reset_launches() -> None:
    for name, wrapper in kernel_wrappers().items():
        wrapper.launches = 0
        if name in BF16_KERNELS:
            wrapper.launches_bf16 = 0


def read_launches() -> dict:
    wrappers = kernel_wrappers()
    out = {name: w.launches for name, w in wrappers.items()}
    out.update({f"{n}_bf16": wrappers[n].launches_bf16 for n in BF16_KERNELS})
    return out


def adversarial_counts(rng, n: int = 64):
    """Edges per node: 1-5, but none for node 3 and 1,100 for node 7."""
    counts = rng.integers(1, 6, size=n)
    counts[3] = 0
    counts[7] = 1100
    return counts


def adversarial_case(torch, dev, d: int):
    """Receiver-sorted CSR segments that stress the identities (see the
    module docstring); 64 nodes, a 40-edge padding tail on the last node."""
    import numpy as np
    from phc_gnn_torch.graph.batch import build_csr_rowptr

    rng = np.random.default_rng(11)
    n = 64
    counts = adversarial_counts(rng, n)
    recv = np.repeat(np.arange(n), counts)
    mask = rng.random(recv.shape[0]) > 0.25
    lo = counts[:11].sum()
    mask[lo:lo + counts[11]] = False
    recv = np.concatenate([recv, np.full(40, n - 1)]).astype(np.int32)
    mask = np.concatenate([mask, np.zeros(40, bool)])
    msgs = rng.uniform(-32.0, 32.0, size=(recv.shape[0], d)).astype(np.float32)
    rowptr = build_csr_rowptr(recv, n, mask)
    return (torch.from_numpy(msgs).to(dev), torch.from_numpy(mask).to(dev),
            torch.tensor(-2.75, device=dev), torch.from_numpy(rowptr).to(dev))


def adversarial_senders(torch, dev, d: int):
    """A sender plan with an isolated sender (3), a sender of 1,100 edges (7),
    masked edges among real ones and a masked tail, and a cotangent that is
    non-zero on every edge; 64 senders."""
    import numpy as np
    from phc_gnn_torch.graph.batch import build_sender_csr

    rng = np.random.default_rng(12)
    n = 64
    senders = rng.permutation(np.repeat(np.arange(n),
                                        adversarial_counts(rng, n)))
    mask = rng.random(senders.shape[0]) > 0.2
    senders = np.concatenate([senders, np.full(40, n - 1)]).astype(np.int32)
    mask = np.concatenate([mask, np.zeros(40, bool)])
    perm, rowptr = build_sender_csr(senders, n, mask)
    g = rng.normal(size=(senders.shape[0], d)).astype(np.float32)
    return (torch.from_numpy(g).to(dev), torch.from_numpy(perm).to(dev),
            torch.from_numpy(rowptr).to(dev))


def check(errs, kname, case, got, want, tol, identity=None, note="",
          own_scale=True):
    """Hold a kernel output to its plain version, relative to the tensor's
    own size, or normwise (``own_scale=False``; ``identity`` marks the empty
    segments of the segment max)."""
    if own_scale:
        abs_err, rel_err = leafwise(got, want)
        how = "rel err (own scale)"
    else:
        abs_err, rel_err = normwise(got, want, identity)
        how = "normwise rel err"
    errs.setdefault(kname, []).append((abs_err, rel_err))
    print(f"kernel {kname} [{case}]: max abs err {abs_err:.3e}, {how} "
          f"{rel_err:.3e} (tolerance {tol:g}{note})", flush=True)
    if not rel_err <= tol:
        fail(f"{kname} disagrees with its plain version on {case}")


def record(torch, name, source, replaces, errs, fn, plain, library, nbytes,
           flops):
    """The timing record of one kernel at the main path's shapes."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    rec = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": None,
        "max_abs_err": max(a for a, _ in errs[name]),
        "max_rel_err": max(r for _, r in errs[name]),
        "ms": time_eager(torch, fn),
        "graph_ms": time_graph(torch, fn),
        "plain_ms": time_eager(torch, plain),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes,
        "library_ms": time_eager(torch, library) if library else None,
        "library_graph_ms": time_graph(torch, library) if library else None,
    }
    for key in ("ms", "graph_ms", "plain_ms", "bound_ms", "library_ms"):
        us = key[:-2] + "us"
        rec[us] = rec[key] * 1e3 if rec[key] is not None else None
    print(f"kernel {name}: {rec['ms'] * 1e3:.2f} us per call, "
          f"{rec['graph_ms'] * 1e3:.2f} us device (CUDA graph), plain "
          f"{rec['plain_ms'] * 1e3:.2f} us, bound {rec['bound_ms'] * 1e3:.2f} us "
          f"({nbytes / 1e6:.2f} MB)"
          + (f", library {rec['library_ms'] * 1e3:.2f} us" if library else ""),
          flush=True)
    return rec


def variant(torch, name, fn, nbytes, what="frozen variant"):
    """Timing of a variant of a kernel: ms per call, device ms from a CUDA
    graph, and its bound on ``nbytes``."""
    rec = {"ms": time_eager(torch, fn), "graph_ms": time_graph(torch, fn),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
    print(f"kernel {name} ({what}): {rec['ms'] * 1e3:.2f} us per call, "
          f"{rec['graph_ms'] * 1e3:.2f} us device, bound "
          f"{rec['bound_ms'] * 1e3:.2f} us", flush=True)
    return rec


def offset_copy(torch, t, k: int):
    """A contiguous copy of ``t`` ``k`` elements past its allocation's base:
    rows off their alignment, which the kernels take with fewer lanes a
    thread (float32 rows 8 bytes off 16: two; 4 bytes off: one; bf16 rows
    2 bytes off 4: one)."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    view = buf[k:].view(t.shape)
    view.copy_(t)
    return view


def csr_receivers(torch, rp, num_edges: int):
    """The receiver of each of ``num_edges`` edges of the CSR ``rp``, the
    padding run past ``rp[-1]`` on the last node (as the batcher emits it):
    the gather index of the plain backward."""
    n = rp.shape[0] - 1
    recv = torch.repeat_interleave(torch.arange(n, device=rp.device),
                                   (rp[1:] - rp[:-1]).long())
    return torch.cat([recv, recv.new_full((num_edges - recv.shape[0],),
                                          n - 1)]).to(torch.int32)


def hold_fused(torch, errs, kname, case, m, k, b, rp):
    """A fused into B on one input: both variants against the plain A then
    B (TOL_AGG), ``w`` 0 past ``rp[-1]``, and whether ``out``, ``w``,
    ``den`` and the eval ``out`` are bit-equal to A then B on the card."""
    from phc_gnn_torch.ops import segment_softmax as ss

    counter = "launches_bf16" if m.dtype == torch.bfloat16 else "launches"
    before = getattr(ss.segment_softmax_fused, counter)
    fused = ss.segment_softmax_fused(m, k, b, rp, emit_w=True)
    fused_nw = ss.segment_softmax_fused(m, k, b, rp)
    torch.cuda.synchronize()
    if getattr(ss.segment_softmax_fused, counter) != before + 2:
        fail(f"{kname} [{case}]: the fused kernel's counter did not move")
    smax = ss.segment_logit_max(m, k, b, rp)
    pair = ss.segment_softmax_aggregate(m, k, b, rp, smax, emit_w=True)
    pair_nw = ss.segment_softmax_aggregate(m, k, b, rp, smax)
    out_ref, w_ref, den_ref = ss.segment_softmax_aggregate_plain(
        m, k, b, rp, ss.segment_logit_max_plain(m, k, b, rp), emit_w=True)
    for what, got, want in (("out", fused[0], out_ref),
                            ("eval out", fused_nw, out_ref),
                            ("w", fused[1], w_ref)):
        check(errs, kname, f"{case}, {what}", got, want, TOL_AGG,
              own_scale=False)
    check(errs, kname, f"{case}, den", fused[2], den_ref, TOL_AGG)
    if not bool((fused[1][int(rp[-1]):] == 0).all()):
        fail(f"{kname} [{case}]: w is not 0 on the padding run")
    return all(map(torch_equal, (*fused, fused_nw), (*pair, pair_nw)))


def hold_softmax_backward(torch, errs, kname, case, m, k, b, rp, g):
    """The backward kernel on one input, fed the fused kernel's ``out``,
    ``w`` and ``den`` and the cotangent ``g``: ``dm`` bit-equal to
    ``segment_softmax_backward_plain`` on the card, 0 on the padding run
    and on masked edges; ``dbeta`` within TOL_DBETA of the plain version's
    f32 sum and of a float64 sum of the same terms; both bit-equal on a
    second launch.  Returns ``dm``."""
    from phc_gnn_torch.ops import segment_softmax as ss

    recv = csr_receivers(torch, rp, m.shape[0])
    out, w, den = ss.segment_softmax_fused(m, k, b, rp, emit_w=True)
    counter = "launches_bf16" if m.dtype == torch.bfloat16 else "launches"
    before = getattr(ss.segment_softmax_backward, counter)
    dm, db = ss.segment_softmax_backward(m, b, w, den, out, g, rp, recv)
    dm2, db2 = ss.segment_softmax_backward(m, b, w, den, out, g, rp, recv)
    torch.cuda.synchronize()
    if getattr(ss.segment_softmax_backward, counter) != before + 2:
        fail(f"{kname} [{case}]: the launch counter did not move")
    want_dm, want_db = ss.segment_softmax_backward_plain(m, b, w, den, out,
                                                         g, recv)
    if dm.dtype != m.dtype or not torch_equal(dm, want_dm):
        err = leafwise(dm.float(), want_dm.float())
        fail(f"{kname} [{case}]: dm differs from the plain backward on the "
             f"card (max abs err {err[0]:.3e}, {err[1]:.3e} of its max)")
    if not (torch_equal(dm, dm2) and torch_equal(db, db2)):
        fail(f"{kname} [{case}]: two launches differ")
    e_seg = int(rp[-1])
    if not (bool((dm[e_seg:] == 0).all()) and bool((dm[~k] == 0).all())):
        fail(f"{kname} [{case}]: dm is not 0 on the padding run or on "
             f"masked edges")
    rl = recv.long()
    md, gd = m.double(), g.double()[rl]
    terms = (w.double() / den.double()[rl]) * md * (
        md * gd - out.double()[rl] * gd)
    scale = float(terms.abs().sum())
    for what, want in (("the plain f32 sum", float(want_db)),
                       ("a float64 sum", float(terms.sum()))):
        abs_err = abs(float(db) - want)
        rel = abs_err / scale if scale else (0.0 if not abs_err else math.inf)
        errs.setdefault(kname, []).append((abs_err, rel))
        print(f"kernel {kname} [{case}]: dbeta {float(db):.9g} against "
              f"{what} {want:.9g}: abs err {abs_err:.3e}, {rel:.3e} of the "
              f"terms' magnitudes {scale:.4g} (tolerance {TOL_DBETA:g})",
              flush=True)
        if not rel <= TOL_DBETA:
            fail(f"{kname} [{case}]: dbeta off {what}")
    print(f"kernel {kname} [{case}]: dm bit-equal to the plain backward on "
          f"the card, 0 on the {m.shape[0] - e_seg} padding rows and the "
          f"masked edges; dm and dbeta bit-equal on relaunch", flush=True)
    return dm


def softmax_kernels(torch, dev, batch, errs):
    """A and B against their plain versions (B's training variant with its
    ``w`` and ``den`` too); A fused into B on float32 rows against them and
    bit-equal to A then B, with four, two and one lanes a thread; the
    backward kernel against the plain backward on the card.  Returns the
    timing records: the fused kernel's, with A's and B's under its
    ``parent_pair`` (no main path runs them), and the backward's."""
    from phc_gnn_torch.ops import segment_softmax as ss

    gen = torch.Generator().manual_seed(0)
    msgs = torch.randn((batch.num_edges, DIM), generator=gen).to(dev)
    main = (msgs, batch.edge_mask, torch.tensor(1.37, device=dev), batch.rowptr)
    cases = {"main": main, "adversarial": adversarial_case(torch, dev, DIM)}
    for name, (m, k, b, rp) in cases.items():
        before = (ss.segment_logit_max.launches,
                  ss.segment_softmax_aggregate.launches)
        smax = ss.segment_logit_max(m, k, b, rp)
        out, w, den = ss.segment_softmax_aggregate(m, k, b, rp, smax,
                                                   emit_w=True)
        out_nw = ss.segment_softmax_aggregate(m, k, b, rp, smax)
        torch.cuda.synchronize()
        if (ss.segment_logit_max.launches != before[0] + 1
                or ss.segment_softmax_aggregate.launches != before[1] + 2):
            fail(f"{name}: the launch counters did not move")
        smax_ref = ss.segment_logit_max_plain(m, k, b, rp)
        out_ref, w_ref, den_ref = ss.segment_softmax_aggregate_plain(
            m, k, b, rp, smax_ref, emit_w=True)
        for tensor in (smax, out, w, out_nw, den):
            if not torch.isfinite(tensor).all():
                fail(f"{name}: non-finite kernel output")
        n_empty = int((smax_ref == ss.NEG).all(dim=1).sum())
        note = (f"; {n_empty} empty or all-masked segments must hold -2^100 "
                f"exactly in the segment max")
        check(errs, "segment_logit_max", name, smax, smax_ref, TOL_MAX,
              identity=ss.NEG, note=note, own_scale=False)
        for what, got, want in (("out", out, out_ref),
                                ("eval out", out_nw, out_ref), ("w", w, w_ref)):
            check(errs, "segment_softmax_aggregate", f"{name}, {what}", got,
                  want, TOL_AGG, own_scale=False)
        check(errs, "segment_softmax_aggregate", f"{name}, den", den, den_ref,
              TOL_AGG, note="; the floor 1e-16 on empty segments")
        if name == "adversarial":
            if not (bool((out[3] == 0).all()) and bool((out[11] == 0).all())):
                fail("isolated or all-masked segment did not give 0")

    m, k, b, rp = main
    cases.update({"d = 37": (m[:, :37].contiguous(), k, b, rp),
                  "rows two lanes": (offset_copy(torch, m, 2), k, b, rp),
                  "rows one lane": (offset_copy(torch, m, 1), k, b, rp)})
    same_bits = {name: hold_fused(torch, errs, "segment_softmax_fused", name,
                                  *case) for name, case in cases.items()}
    print(f"kernel segment_softmax_fused: out, w, den and the eval out "
          f"bit-equal to A then B: {same_bits}", flush=True)
    if not all(same_bits.values()):
        fail("segment_softmax_fused differs from A then B on float32 rows")
    cot = {name: torch.randn((c[3].shape[0] - 1, c[0].shape[1]),
                             generator=gen).to(dev)
           for name, c in cases.items()}
    for name, case in cases.items():
        hold_softmax_backward(torch, errs, "segment_softmax_backward", name,
                              *case, cot[name])

    smax = ss.segment_logit_max(m, k, b, rp)
    n, d = rp.shape[0] - 1, m.shape[1]
    e_seg = int(rp[-1])  # edges inside segments: what these inputs need
    seg = torch.repeat_interleave(torch.arange(n, device=dev),
                                  (rp[1:] - rp[:-1]).long())
    logits = torch.where(k[:e_seg, None], b * m[:e_seg], ss.NEG)
    index = seg[:, None].expand(e_seg, d).contiguous()
    init = torch.full((n, d), ss.NEG, device=dev)

    def library_amax():
        return init.scatter_reduce(0, index, logits, "amax")

    in_bytes = e_seg * d * 4 + e_seg + (n + 1) * 4 + 4
    nd_bytes = n * d * 4
    src = "phc_gnn_torch/csrc/segment_softmax.cu"
    rec_f = record(torch, "segment_softmax_fused", src,
                   "phc_gnn_tpu/ops/stream_scan.py:521", errs,
                   lambda: ss.segment_softmax_fused(m, k, b, rp),
                   lambda: ss.segment_softmax_aggregate_plain(
                       m, k, b, rp, ss.segment_logit_max_plain(m, k, b, rp)),
                   None, in_bytes + nd_bytes, 8 * e_seg * d + n * d)
    rec_f["replaces_too"] = ("phc_gnn_tpu/ops/stream_scan.py:415 (A), :439 "
                             "(B's training variant)")
    rec_f["train_variant"] = variant(
        torch, "segment_softmax_fused",
        lambda: ss.segment_softmax_fused(m, k, b, rp, emit_w=True),
        in_bytes + 2 * nd_bytes + m.shape[0] * d * 4,
        "training variant, w and den")
    rec_f["train_variant"]["replaces"] = "phc_gnn_tpu/ops/stream_scan.py:439"
    # the parent pair in the same call, A then B as graphs of the two calls,
    # and the instances of two lanes and one lane a thread, in turns
    pair_ms = {"eval": [], "train": []}
    lanes_ms = {f"{lanes} lanes": {"eval": [], "train": []}
                for lanes in (4, 2, 1)}
    rows = {"4 lanes": m, "2 lanes": cases["rows two lanes"][0],
            "1 lanes": cases["rows one lane"][0]}
    for turn in range(2):
        for v, emit in (("eval", False), ("train", True)):
            pair_ms[v].append(time_graph(
                torch, lambda: ss.segment_softmax_aggregate(
                    m, k, b, rp, ss.segment_logit_max(m, k, b, rp), emit)))
            for key in (list(rows) if turn == 0 else list(rows)[::-1]):
                lanes_ms[key][v].append(time_graph(
                    torch, lambda: ss.segment_softmax_fused(
                        rows[key], k, b, rp, emit)))
    rec_f["parent_pair_graph_ms"] = pair_ms
    rec_f["lanes_graph_ms"] = lanes_ms
    print(f"kernel segment_softmax_fused: A then B in the same call "
          f"{[round(x * 1e3, 2) for x in pair_ms['eval']]} us device (eval), "
          f"{[round(x * 1e3, 2) for x in pair_ms['train']]} us (training); "
          f"by lanes a thread, device us "
          f"{ {key: {v: [round(x * 1e3, 2) for x in t] for v, t in r.items()} for key, r in lanes_ms.items()} }",
          flush=True)
    rec_a = record(torch, "segment_logit_max", src,
                   "phc_gnn_tpu/ops/stream_scan.py:415", errs,
                   lambda: ss.segment_logit_max(m, k, b, rp),
                   lambda: ss.segment_logit_max_plain(m, k, b, rp),
                   library_amax, in_bytes + nd_bytes, 2 * e_seg * d)
    rec_b = record(torch, "segment_softmax_aggregate", src,
                   "phc_gnn_tpu/ops/stream_scan.py:521", errs,
                   lambda: ss.segment_softmax_aggregate(m, k, b, rp, smax),
                   lambda: ss.segment_softmax_aggregate_plain(m, k, b, rp,
                                                              smax),
                   None, in_bytes + 2 * nd_bytes, 6 * e_seg * d + n * d)
    # the training variant also writes w [E, D] and den [N, D]
    rec_b["train_variant"] = variant(
        torch, "segment_softmax_aggregate",
        lambda: ss.segment_softmax_aggregate(m, k, b, rp, smax, emit_w=True),
        in_bytes + 3 * nd_bytes + m.shape[0] * d * 4, "training variant, w and den")
    rec_b["train_variant"]["replaces"] = "phc_gnn_tpu/ops/stream_scan.py:439"
    # A and B run on no main path now (the fused kernel does their work):
    # their records sit in the fused kernel's, not in the line
    rec_f["parent_pair"] = {"segment_logit_max": rec_a,
                            "segment_softmax_aggregate": rec_b}
    rec_bw = softmax_backward_record(torch, errs, "segment_softmax_backward",
                                     m, k, b, rp, batch.receivers,
                                     cot["main"])
    return [rec_f, rec_bw]


def softmax_backward_record(torch, errs, kname, m, k, b, rp, recv, g):
    """The backward kernel's timing record at the main path's shapes: its
    bound reads ``m`` and ``w`` over the real edges, ``den``, ``g`` and
    ``out``, and writes ``dm`` over every edge; beside it the plain
    backward's device time (what the port ran before; its kernels a call:
    ``tools/time_softmax.py``)."""
    from phc_gnn_torch.ops import segment_softmax as ss

    out, w, den = ss.segment_softmax_fused(m, k, b, rp, emit_w=True)
    n, (e, d) = rp.shape[0] - 1, m.shape
    e_seg = int(rp[-1])
    elem = m.element_size()
    nbytes = (e_seg * d * (elem + 4) + 3 * n * d * 4 + (n + 1) * 4 + 4
              + e * d * elem + 4)
    plain = lambda: ss.segment_softmax_backward_plain(  # noqa: E731
        m, b, w, den, out, g, recv)
    rec = record(torch, kname, "phc_gnn_torch/csrc/segment_softmax.cu",
                 "phc_gnn_tpu/ops/stream_scan.py:794", errs,
                 lambda: ss.segment_softmax_backward(m, b, w, den, out, g,
                                                     rp, recv),
                 plain, None, nbytes, 10 * e_seg * d + n * d)
    rec["replaces_what"] = ("XLA glue of _softmax_agg_streamed_bwd "
                            "(stream_scan.py:794-815), no Pallas kernel")
    rec["plain_graph_ms"] = time_graph(torch, plain)
    print(f"kernel {kname}: the plain backward on the card "
          f"{rec['plain_graph_ms'] * 1e3:.2f} us device (CUDA graph)",
          flush=True)
    return rec


def hold_sequential(torch, kname, case, out, again, plain):
    """C's outputs on one input: a second launch bit-equal, and bit-equal to
    its plain version run in float32 on the CPU, a sequential sum in edge
    order."""
    if not torch.equal(out, again):
        fail(f"{kname}: two launches on {case} differ")
    if not torch.equal(out.cpu(), plain):
        fail(f"{kname}: {case} differs from the sequential f32 sum")
    print(f"kernel {kname} [{case}]: bit-equal on relaunch and to the "
          f"sequential f32 sum in edge order", flush=True)


def segment_sum_kernel(torch, dev, batch, pcba, errs):
    """C against its plain version over the flagship's and pcba's sender
    plans, at width 37 (the scalar instance) and on the adversarial senders;
    returns its timing record, with pcba's [8192 -> 4096, 512] beside it."""
    from phc_gnn_torch.ops import segment_sum as ssum

    gen = torch.Generator().manual_seed(1)
    g = torch.randn((batch.num_edges, DIM), generator=gen).to(dev)  # masked too
    p_g = torch.randn((pcba.num_edges, PCBA_DIM), generator=gen).to(dev)
    cases = {"main": (g, batch.snd_perm, batch.snd_rowptr),
             f"pcba [{pcba.num_edges}, {PCBA_DIM}]": (
                 p_g, pcba.snd_perm, pcba.snd_rowptr),
             "d = 37": (g[:, :37].contiguous(), batch.snd_perm,
                        batch.snd_rowptr),
             "adversarial": adversarial_senders(torch, dev, DIM)}
    for name, (gv, perm, rowptr) in cases.items():
        before = ssum.segment_sum_perm.launches
        out = ssum.segment_sum_perm(gv, perm, rowptr)
        torch.cuda.synchronize()
        if ssum.segment_sum_perm.launches != before + 1:
            fail(f"{name}: the launch counter of segment_sum_perm did not move")
        want = ssum.segment_sum_perm_plain(gv.double(), perm, rowptr)
        check(errs, "segment_sum_perm", name, out, want, TOL_SUM)
        hold_sequential(torch, "segment_sum_perm", name, out,
                        ssum.segment_sum_perm(gv, perm, rowptr),
                        ssum.segment_sum_perm_plain(gv.cpu(), perm.cpu(),
                                                    rowptr.cpu()))
        if name == "adversarial" and not bool((out[3] == 0).all()):
            fail("segment_sum_perm: the isolated sender did not give 0")

    def library_of(gv, b):
        """One index_add_ of the real edges' rows, its bytes and adds."""
        n, d = b.snd_rowptr.shape[0] - 1, gv.shape[1]
        e_real = int(b.snd_rowptr[-1])
        real = b.snd_perm[:e_real].long()
        g_real, s_real = gv[real], b.senders[real].long()
        zeros = torch.zeros((n, d), device=dev)
        nbytes = e_real * d * 4 + e_real * 4 + (n + 1) * 4 + n * d * 4
        return (lambda: zeros.clone().index_add_(0, s_real, g_real)), \
            nbytes, e_real * d

    library, nbytes, flops = library_of(g, batch)
    perm, rowptr = batch.snd_perm, batch.snd_rowptr
    rec = record(torch, "segment_sum_perm", "phc_gnn_torch/csrc/segment_sum.cu",
                 "phc_gnn_tpu/ops/stream_scan.py:373", errs,
                 lambda: ssum.segment_sum_perm(g, perm, rowptr),
                 lambda: ssum.segment_sum_perm_plain(g, perm, rowptr),
                 library, nbytes, flops)
    p_lib, p_bytes, _ = library_of(p_g, pcba)
    p_fn = lambda: ssum.segment_sum_perm(  # noqa: E731
        p_g, pcba.snd_perm, pcba.snd_rowptr)
    rec["pcba_shape"] = {
        "ms": time_eager(torch, p_fn), "graph_ms": time_graph(torch, p_fn),
        "bound_ms": p_bytes / HBM_BYTES_PER_S * 1e3, "bytes": p_bytes,
        "library_graph_ms": time_graph(torch, p_lib)}
    print(f"kernel segment_sum_perm at pcba's shape: "
          f"{rec['pcba_shape']['ms'] * 1e3:.2f} us per call, "
          f"{rec['pcba_shape']['graph_ms'] * 1e3:.2f} us device, bound "
          f"{rec['pcba_shape']['bound_ms'] * 1e3:.2f} us, library "
          f"{rec['pcba_shape']['library_graph_ms'] * 1e3:.2f} us device",
          flush=True)
    return [rec]


def bn_forward_bytes(n: int, d: int) -> int:
    """A batch-norm forward's bytes: x, the mask, scale and bias read, y,
    mean and var written."""
    return 2 * n * d * 4 + n + 4 * d * 4


def bn_backward_bytes(n: int, d: int) -> int:
    """A batch-norm backward's: x, g, the mask, scale, mean and var read,
    dx, dscale and dbias written."""
    return 3 * n * d * 4 + n + 5 * d * 4


def hold_bn_pair(torch, errs, fwd, bwd, fwd_plain, bwd_plain, cases):
    """A batch-norm pair (D and E, or F and G) against its plain versions
    run in float64, the backward fed the forward's own mean and var, on each
    of ``cases`` ({name: ((x, g, scale, bias), mask)}): one launch each way
    moves each counter by one, and a second launch is bit-equal."""
    for name, ((x, g, scale, bias), mask) in cases.items():
        before = (fwd.launches, bwd.launches)
        y, mean, var = fwd(x, mask, scale, bias, 1e-5)
        dx, dscale, dbias = bwd(x, mask, scale, mean, var, 1e-5, g)
        torch.cuda.synchronize()
        if (fwd.launches, bwd.launches) != (before[0] + 1, before[1] + 1):
            fail(f"{name}: the {fwd.__name__}, {bwd.__name__} launch counters "
                 f"did not move by one")
        again = (fwd(x, mask, scale, bias, 1e-5)
                 + bwd(x, mask, scale, mean, var, 1e-5, g))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in
                   zip((y, mean, var, dx, dscale, dbias), again)):
            fail(f"{fwd.__name__}, {bwd.__name__}: two launches on {name} "
                 f"differ")
        ref = fwd_plain(x.double(), mask, scale.double(), bias.double(), 1e-5)
        ref_b = bwd_plain(x.double(), mask, scale.double(), mean.double(),
                          var.double(), 1e-5, g.double())
        f, b = fwd.__name__, bwd.__name__
        for kname, what, got, want in (
                (f, "y", y, ref[0]), (f, "mean", mean, ref[1]),
                (f, "var", var, ref[2]), (b, "dx", dx, ref_b[0]),
                (b, "dscale", dscale, ref_b[1]), (b, "dbias", dbias, ref_b[2])):
            check(errs, kname, f"{name}, {what}", got, want, TOL_BN,
                  note="; against float64, bit-equal on a second launch")


def batch_norm_kernels(torch, dev, batch, errs):
    """D and E against their plain versions run in float64 (E fed D's own
    mean and var, so that each is held alone): the flagship's node mask at
    [4096, 200] and graph mask at [129, 100], pcba's head at [129, 768],
    all-masked and one-row masks, the size gate's edges [109375, 8] (rows
    past one shared-memory chunk) and [4096, 213], a ragged width [4096,
    203], one row [1, 200], columns at an offset of 1e3 with std 0.1, and a
    mask that leaves the rows of whole CTAs masked (the first three of the
    cluster at [4096, 200]).  Two launches on one input must be bit-equal.
    Returns the timing records: [4096, 200], with the head shapes [129, 768]
    and [129, 100] as variants and, as context, torch's unmasked batch norm
    and its backward."""
    from phc_gnn_torch.ops import fused_bn

    gen = torch.Generator().manual_seed(2)

    def inputs(n, d, offset=3.0, std=2.0):
        x = (torch.randn((n, d), generator=gen) * std + offset).to(dev)
        g = torch.randn((n, d), generator=gen).to(dev)
        scale = torch.randn(d, generator=gen).to(dev)
        bias = torch.randn(d, generator=gen).to(dev)
        return x, g, scale, bias

    def only(n, rows):
        mask = torch.zeros(n, dtype=torch.bool, device=dev)
        mask[rows] = True
        return mask

    def live(n, dead=slice(0, 0)):
        mask = torch.rand(n, generator=gen) > 0.25
        mask[dead] = False
        return mask.to(dev)

    main = inputs(4096, DIM)
    head = inputs(129, 100)
    pcba_head = inputs(129, 768)
    rows = fused_bn.bn_plan(4096, DIM).rows_per_cta
    cases = {"main [4096, 200]": (main, batch.node_mask),
             "head [129, 100]": (head, batch.graph_mask),
             "pcba head [129, 768]": (pcba_head, live(129)),
             "all-masked [4096, 200]": (main, only(4096, [])),
             "one-row [129, 100]": (head, only(129, [64])),
             "gate edge [109375, 8]": (inputs(109375, 8), live(109375)),
             "gate edge [4096, 213]": (inputs(4096, 213), live(4096)),
             "ragged width [4096, 203]": (inputs(4096, 203), live(4096)),
             "one row [1, 200]": (inputs(1, DIM), only(1, [0])),
             "offset 1e3, std 0.1 [4096, 200]": (
                 inputs(4096, DIM, 1e3, 0.1), batch.node_mask),
             f"CTAs 0-2 masked [4096, 200] ({rows} rows a CTA)": (
                 main, live(4096, slice(0, 3 * rows)))}
    hold_bn_pair(torch, errs, fused_bn.bn_forward, fused_bn.bn_backward,
                 fused_bn.bn_forward_plain, fused_bn.bn_backward_plain, cases)

    (x, g, scale, bias), mask = main, batch.node_mask
    n, d = x.shape
    plan = fused_bn.bn_plan(n, d)
    print(f"kernel bn_forward, bn_backward at [{n}, {d}]: {plan.grid} CTAs "
          f"in clusters of {plan.cluster}, slabs of {plan.slab_cols} columns, "
          f"{plan.rows_per_cta} rows a CTA", flush=True)
    if plan.grid < 100:
        fail(f"D and E run {plan.grid} CTAs at [{n}, {d}], under 100")
    y, mean, var = fused_bn.bn_forward(x, mask, scale, bias, 1e-5)

    src = "phc_gnn_torch/csrc/fused_bn.cu"
    recs = [
        record(torch, "bn_forward", src, "phc_gnn_tpu/ops/fused_bn.py:50", errs,
               lambda: fused_bn.bn_forward(x, mask, scale, bias, 1e-5),
               lambda: fused_bn.bn_forward_plain(x, mask, scale, bias, 1e-5),
               None, bn_forward_bytes(n, d), 8 * n * d),
        record(torch, "bn_backward", src, "phc_gnn_tpu/ops/fused_bn.py:64",
               errs,
               lambda: fused_bn.bn_backward(x, mask, scale, mean, var, 1e-5, g),
               lambda: fused_bn.bn_backward_plain(x, mask, scale, mean, var,
                                                  1e-5, g),
               None, bn_backward_bytes(n, d), 12 * n * d)]
    for rec in recs:
        rec["plan"] = fused_bn.bn_plan(n, d, 1 + (rec is recs[1]))._asdict()
        rec["head_shapes"] = {}
    for (hx, hg, hs, hb), hm in ((pcba_head, cases["pcba head [129, 768]"][1]),
                                 (head, batch.graph_mask)):
        hn, hd = hx.shape
        _, h_mean, h_var = fused_bn.bn_forward(hx, hm, hs, hb, 1e-5)
        key = f"[{hn}, {hd}]"
        recs[0]["head_shapes"][key] = variant(
            torch, "bn_forward",
            lambda: fused_bn.bn_forward(hx, hm, hs, hb, 1e-5),
            bn_forward_bytes(hn, hd), f"head shape {key}")
        recs[1]["head_shapes"][key] = variant(
            torch, "bn_backward",
            lambda: fused_bn.bn_backward(hx, hm, hs, h_mean, h_var, 1e-5, hg),
            bn_backward_bytes(hn, hd), f"head shape {key}")
    # context, unmasked: torch's batch norm of every row, and its backward
    # (the aten op that autograd calls for it, given the saved statistics);
    # not the masked function, so not the library time
    _, s_mean, s_invstd = torch.ops.aten.native_batch_norm(
        x, scale, bias, None, None, True, 0.1, 1e-5)
    context = {
        "forward": (lambda: torch.nn.functional.batch_norm(
            x, None, None, scale, bias, training=True, eps=1e-5)),
        "backward": (lambda: torch.ops.aten.native_batch_norm_backward(
            g, x, scale, None, None, s_mean, s_invstd, True, 1e-5,
            [True, True, True]))}
    for rec, (what, fn) in zip(recs, context.items()):
        rec["context_unmasked_batch_norm"] = {
            "ms": time_eager(torch, fn), "graph_ms": time_graph(torch, fn)}
        print(f"kernel {rec['name']}: context, unmasked "
              f"torch.nn.functional.batch_norm {what} "
              f"{rec['context_unmasked_batch_norm']['ms'] * 1e3:.2f} us per "
              f"call, {rec['context_unmasked_batch_norm']['graph_ms'] * 1e3:.2f}"
              f" us device", flush=True)
    return recs


def pcba_labels(torch, batch, seed: int):
    """``batch`` with 0/1 labels of the 128 tasks, ~40 % of them missing
    (NaN) as molpcba's are, and NaN on the padding graphs; drawn with numpy
    from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(1000 + seed)
    g = batch.num_graphs
    y = (rng.random((g, PCBA_TASKS)) < 0.3).astype(np.float32)
    y[rng.random(y.shape) < 0.4] = np.nan
    y[~batch.graph_mask.cpu().numpy()] = np.nan
    return batch.replace(y=torch.from_numpy(y).to(batch.graph_mask.device))


def pcba_batch(torch, seed: int, shape: dict):
    """A host pcba batch with its CSR plans and labels."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan

    return pcba_labels(torch, attach_csr_plan(
        synthetic_batch(seed=seed, **shape)), seed)


def blocked_bn_kernels(torch, dev, batch, errs):
    """F and G, each with its elementwise pass fused in, against their plain
    versions run in float64 (G fed F's own mean and var): [4096, 512] with
    the pcba batch's node mask, a ragged [1100, 24] with a random mask and
    with rows 128-639 masked, all-masked at [4096, 512], one-row at [129,
    768], [32768, 512] (each CTA walks its rows in chunks; x and g 67 MB
    each, past the 50 MB L2), columns at an offset of 1e3 with std 0.1, and
    two ragged widths in chunks, [40000, 41] (4-byte copies) and [20000,
    212].  Two launches on one input must be bit-equal.  Returns their timing
    records at [4096, 512], with D and E timed at the same shape beside them
    (the size gate's data)."""
    from phc_gnn_torch.ops import fused_bn

    gen = torch.Generator().manual_seed(3)

    def inputs(n, d, offset=3.0, std=2.0):
        x = (torch.randn((n, d), generator=gen) * std + offset).to(dev)
        g = torch.randn((n, d), generator=gen).to(dev)
        scale = torch.randn(d, generator=gen).to(dev)
        bias = torch.randn(d, generator=gen).to(dev)
        return x, g, scale, bias

    def mask_of(n, kind):
        mask = torch.rand(n, generator=gen) > 0.25
        if kind == "masked blocks":
            mask[128:640] = False
        elif kind == "all-masked":
            mask[:] = False
        elif kind == "one-row":
            mask[:] = False
            mask[64] = True
        return mask.to(dev)

    n_main = batch.num_nodes
    main = inputs(n_main, PCBA_DIM)
    ragged = inputs(1100, 24)
    shape = f"[{n_main}, {PCBA_DIM}]"
    chunked = fused_bn.bn_plan(32768, PCBA_DIM, 2)
    cases = {f"main {shape}": (main, batch.node_mask),
             "ragged [1100, 24]": (ragged, mask_of(1100, "random")),
             "masked blocks [1100, 24]": (ragged, mask_of(1100, "masked blocks")),
             f"all-masked {shape}": (main, mask_of(n_main, "all-masked")),
             "one-row [129, 768]": (inputs(129, 768), mask_of(129, "one-row")),
             f"chunked [32768, {PCBA_DIM}] ({chunked.rows_per_cta} rows a "
             f"CTA, G's chunks of {chunked.chunk_rows})": (
                 inputs(32768, PCBA_DIM), mask_of(32768, "random")),
             f"offset 1e3, std 0.1 {shape}": (
                 inputs(n_main, PCBA_DIM, 1e3, 0.1), batch.node_mask),
             "ragged chunked [40000, 41]": (inputs(40000, 41),
                                            mask_of(40000, "random")),
             "ragged chunked [20000, 212]": (inputs(20000, 212),
                                             mask_of(20000, "random"))}
    hold_bn_pair(torch, errs, fused_bn.bn_forward_blocked,
                 fused_bn.bn_backward_blocked,
                 fused_bn.bn_forward_blocked_plain,
                 fused_bn.bn_backward_blocked_plain, cases)
    del cases

    (x, g, scale, bias), mask = main, batch.node_mask
    n, d = x.shape
    plan = fused_bn.bn_plan(n, d)
    print(f"kernel bn_forward_blocked, bn_backward_blocked at [{n}, {d}]: "
          f"{plan.grid} CTAs in clusters of {plan.cluster}, slabs of "
          f"{plan.slab_cols} columns, {plan.rows_per_cta} rows a CTA",
          flush=True)
    if plan.grid < 100:
        fail(f"F and G run {plan.grid} CTAs at [{n}, {d}], under 100")
    clusters = plan.grid // plan.cluster
    resident = [fused_bn._max_active_clusters(fused_bn.bn_plan(n, d, t), t)
                for t in (1, 2)]
    print(f"kernel bn_forward_blocked, bn_backward_blocked: the card holds "
          f"{resident[0]} and {resident[1]} of their {clusters} clusters at "
          f"once (cudaOccupancyMaxActiveClusters)", flush=True)
    if min(resident) < clusters:
        fail(f"F and G at [{n}, {d}] run their {clusters} clusters in more "
             f"than one wave")
    y, mean, var = fused_bn.bn_forward_blocked(x, mask, scale, bias, 1e-5)
    src = "phc_gnn_torch/csrc/fused_bn.cu"
    xla = "phc_gnn_tpu/ops/fused_bn.py"
    recs = [
        record(torch, "bn_forward_blocked", src, f"{xla}:162", errs,
               lambda: fused_bn.bn_forward_blocked(x, mask, scale, bias, 1e-5),
               lambda: fused_bn.bn_forward_blocked_plain(x, mask, scale, bias,
                                                         1e-5),
               None, bn_forward_bytes(n, d), 8 * n * d),
        record(torch, "bn_backward_blocked", src, f"{xla}:202", errs,
               lambda: fused_bn.bn_backward_blocked(x, mask, scale, mean, var,
                                                    1e-5, g),
               lambda: fused_bn.bn_backward_blocked_plain(
                   x, mask, scale, mean, var, 1e-5, g),
               None, bn_backward_bytes(n, d), 12 * n * d)]
    for rec, tensors, held in zip(recs, (1, 2), resident):
        rec["plan"] = fused_bn.bn_plan(n, d, tensors)._asdict()
        rec["plan"]["resident_clusters"] = held
        rec["replaces_what"] = ("the Pallas kernel and the XLA elementwise "
                                "pass beside it (" + ("y, :283" if tensors == 1
                                                      else "dx, :299") + ")")

    # the same [4096, 512] through the cluster pair D and E, for the size
    # gate between the two families
    gate = {"shape": [n, d],
            "cluster_pair_forward_graph_ms": time_graph(
                torch, lambda: fused_bn.bn_forward(x, mask, scale, bias, 1e-5)),
            "cluster_pair_backward_graph_ms": time_graph(
                torch, lambda: fused_bn.bn_backward(x, mask, scale, mean, var,
                                                    1e-5, g)),
            "blocked_forward_graph_ms": recs[0]["graph_ms"],
            "blocked_backward_graph_ms": recs[1]["graph_ms"]}
    print(f"kernel gate data at [{n}, {d}]: D {gate['cluster_pair_forward_graph_ms'] * 1e3:.2f} us "
          f"vs F {gate['blocked_forward_graph_ms'] * 1e3:.2f} us; "
          f"E {gate['cluster_pair_backward_graph_ms'] * 1e3:.2f} us vs G "
          f"{gate['blocked_backward_graph_ms'] * 1e3:.2f} us (device, CUDA graph)",
          flush=True)
    recs[0]["gate_data"] = gate
    return recs


def segment_sum_masked_kernel(torch, dev, batch, eval_batch, errs):
    """C's forward role against its plain version run in float64, over the
    receiver CSRs of the pcba batch [8192, 512] and the 512-graph eval batch
    [32768, 512], and on the adversarial receivers; returns its timing
    record, with the eval shape beside it."""
    from phc_gnn_torch.ops import segment_sum as ssum

    gen = torch.Generator().manual_seed(4)
    msgs = torch.randn((batch.num_edges, PCBA_DIM), generator=gen).to(dev)
    e_msgs = torch.randn((eval_batch.num_edges, PCBA_DIM), generator=gen).to(dev)
    adv_m, adv_k, _, adv_rp = adversarial_case(torch, dev, PCBA_DIM)
    # rows 4 bytes past a 16-byte boundary take the scalar instance
    offset = torch.empty(msgs.numel() + 1, device=dev)[1:].view(msgs.shape)
    offset.copy_(msgs)
    cases = {f"pcba [{batch.num_edges}, {PCBA_DIM}]": (
                 msgs, batch.edge_mask, batch.rowptr),
             f"eval [{eval_batch.num_edges}, {PCBA_DIM}]": (
                 e_msgs, eval_batch.edge_mask, eval_batch.rowptr),
             "d = 37": (msgs[:, :37].contiguous(), batch.edge_mask,
                        batch.rowptr),
             "rows off 16-byte alignment": (offset, batch.edge_mask,
                                            batch.rowptr),
             "adversarial": (adv_m, adv_k, adv_rp)}
    for name, (m, k, rp) in cases.items():
        before = ssum.segment_sum_masked.launches
        out = ssum.segment_sum_masked(m, k, rp)
        torch.cuda.synchronize()
        if ssum.segment_sum_masked.launches != before + 1:
            fail(f"{name}: the launch counter of segment_sum_masked did not "
                 f"move")
        want = ssum.segment_sum_masked_plain(m.double(), k, rp)
        check(errs, "segment_sum_masked", name, out, want, TOL_SUM)
        hold_sequential(torch, "segment_sum_masked", name, out,
                        ssum.segment_sum_masked(m, k, rp),
                        ssum.segment_sum_masked_plain(m.cpu(), k.cpu(),
                                                      rp.cpu()))
        if name == "adversarial" and not (bool((out[3] == 0).all())
                                          and bool((out[11] == 0).all())):
            fail("segment_sum_masked: an isolated or all-masked segment did "
                 "not give 0")

    def library_of(m, k, rp):
        n = rp.shape[0] - 1
        seg = torch.repeat_interleave(torch.arange(n, device=dev),
                                      (rp[1:] - rp[:-1]).long())
        real = k[:seg.shape[0]].nonzero()[:, 0]
        rows, index = m[real], seg[real]
        zeros = torch.zeros((n, m.shape[1]), device=dev)
        nbytes = (real.shape[0] * m.shape[1] * 4 + int(rp[-1]) + rp.shape[0] * 4
                  + n * m.shape[1] * 4)
        return (lambda: zeros.clone().index_add_(0, index, rows)), nbytes, \
            real.shape[0] * m.shape[1]

    library, nbytes, flops = library_of(msgs, batch.edge_mask, batch.rowptr)
    rec = record(torch, "segment_sum_masked", "phc_gnn_torch/csrc/segment_sum.cu",
                 "phc_gnn_tpu/ops/stream_scan.py:373", errs,
                 lambda: ssum.segment_sum_masked(msgs, batch.edge_mask,
                                                 batch.rowptr),
                 lambda: ssum.segment_sum_masked_plain(msgs, batch.edge_mask,
                                                       batch.rowptr),
                 library, nbytes, flops)
    rec["role"] = "forward of the sum aggregation (_seg_sum_streamed :698)"
    e_lib, e_bytes, _ = library_of(e_msgs, eval_batch.edge_mask,
                                   eval_batch.rowptr)
    e_fn = lambda: ssum.segment_sum_masked(  # noqa: E731
        e_msgs, eval_batch.edge_mask, eval_batch.rowptr)
    rec["eval_shape"] = {
        "ms": time_eager(torch, e_fn), "graph_ms": time_graph(torch, e_fn),
        "bound_ms": e_bytes / HBM_BYTES_PER_S * 1e3, "bytes": e_bytes,
        "library_graph_ms": time_graph(torch, e_lib)}
    print(f"kernel segment_sum_masked at the eval shape: "
          f"{rec['eval_shape']['ms'] * 1e3:.2f} us per call, "
          f"{rec['eval_shape']['graph_ms'] * 1e3:.2f} us device, bound "
          f"{rec['eval_shape']['bound_ms'] * 1e3:.2f} us, library "
          f"{rec['eval_shape']['library_graph_ms'] * 1e3:.2f} us device",
          flush=True)
    return [rec]


def whitening_case(torch, dev, n, d, kind, node_mask=None):
    """``(x, mask, gamma, beta, g)`` for the whitening kernels: x ~ N(0.5,
    1.5^2) with ``node_mask`` or a random mask, or the adversarial ``kind``:
    "all-masked", "one-row", "ctas masked" (the random mask with the rows of
    J's first three CTAs masked), "offset" (every column 1e3 + N(0, 0.1^2)),
    "collinear" (component 1 of features 0-9 is component 0 plus N(0,
    1e-3^2): a covariance within 1e-6 of singular, which eps = 1e-5
    regularises)."""
    gen = torch.Generator().manual_seed(20 + n + d)
    x = torch.randn((n, 4 * d), generator=gen) * 1.5 + 0.5
    mask = (node_mask.cpu() if node_mask is not None
            else torch.rand(n, generator=gen) > 0.2)
    if kind in ("all-masked", "one-row"):
        mask = torch.zeros(n, dtype=torch.bool)
        if kind == "one-row":
            mask[n // 2] = True
    elif kind == "ctas masked":
        from phc_gnn_torch.ops import fused_whitening as fw

        mask[:3 * fw.wbn_plan(n, d, fw.WBN_STATS_SUMS).rows_per_cta] = False
    elif kind == "offset":
        x = 1e3 + torch.randn((n, 4 * d), generator=gen) * 0.1
    elif kind == "collinear":
        x[:, d:d + 10] = x[:, :10] + 1e-3 * torch.randn((n, 10), generator=gen)
    gamma = (torch.randn((4, 4, d), generator=gen) * 0.2
             + 0.5 * torch.eye(4)[..., None])
    beta = torch.randn((4, d), generator=gen) * 0.3
    g = torch.randn((n, 4 * d), generator=gen)
    return [t.to(dev).contiguous() for t in (x, mask, gamma, beta, g)]


def whitening_chain(fw, x, mask, gamma, beta, g, kernels: bool, given=None):
    """J, K, L, M and K's eval route in sequence, through the kernels or
    through the plain versions (in the inputs' dtype), and the frozen
    variants of L and M and the frozen L with dx (the eval whitening's
    backward, J's statistics held fixed): the outputs by name.  With
    ``given`` (J's four outputs from elsewhere), K, L and M read those in
    place of J's."""
    if kernels:
        stats, transform, sums, dx_of, route = (
            fw.wbn_stats, fw.wbn_transform, fw.wbn_bwd_sums, fw.wbn_dx,
            fw.wbn_transform_eval)
    else:
        stats, transform, sums, dx_of, route = (
            fw.wbn_stats_plain, fw.wbn_transform_plain, fw.wbn_bwd_sums_plain,
            fw.wbn_dx_plain, fw.wbn_transform_eval_plain)
    mean, cov, l, cnt = stats(x, mask, 1e-5) if given is None else given
    dgamma, dbeta, mmat, sw = sums(x, g, gamma, mean, l)
    f_dgamma, f_dbeta = sums(x, g, gamma, mean, l, frozen=True)
    w_dgamma, w_dbeta, w_dx = sums(x, g, gamma, mean, l, frozen=True,
                                   with_dx=True)
    y_eval, l_eval = route(x, mean, cov, gamma, beta, 1e-5)
    return {"wbn_stats": {"mean": mean, "cov": cov, "L": l, "cnt": cnt},
            "wbn_transform": {"y": transform(x, mean, l, gamma, beta),
                              "eval y": y_eval, "eval L of cov": l_eval},
            "wbn_bwd_sums": {"dgamma": dgamma, "dbeta": dbeta, "M": mmat,
                             "sum w": sw, "frozen dgamma": f_dgamma,
                             "frozen dbeta": f_dbeta,
                             "frozen with dx, dgamma": w_dgamma,
                             "frozen with dx, dbeta": w_dbeta,
                             "frozen with dx, dx": w_dx},
            "wbn_dx": {"dx": dx_of(x, g, mask, gamma, mean, l, mmat, sw, cnt),
                       "frozen dx": dx_of(x, g, None, gamma, mean, l, None,
                                          None, None, frozen=True)}}


def collinear_split(fw, inputs, want, plain, case):
    """Where the kernels' gap to the f32 plain version arises on a badly
    conditioned input: K, L and M fed the plain version's f32 statistics in
    place of J's, against float64, beside the plain version's own error."""
    fed = whitening_chain(fw, *inputs, kernels=True,
                          given=tuple(plain["wbn_stats"].values()))
    for kname in ("wbn_transform", "wbn_bwd_sums", "wbn_dx"):
        for what, tensor in fed[kname].items():
            err = leafwise(tensor, want[kname][what])[1]
            f32_err = leafwise(plain[kname][what], want[kname][what])[1]
            print(f"kernel {kname} [{case}, {what}] fed the plain version's "
                  f"f32 statistics: rel err (own scale) {err:.3e}, the plain "
                  f"version in f32 {f32_err:.3e} ({err / f32_err:.2f}x)",
                  flush=True)


def whitening_kernels(torch, dev, batch, errs):
    """J, K (with its eval route), L (with the T/S/M algebra) and M against
    their plain versions run in float64 on the same f32 inputs, at the
    quaternion path's [4096, 200] (d = 50) with the flagship's node mask, a
    ragged N = 1,100, d = 49, all-masked and one-row masks, a column offset
    of 1e3 with std 0.1, nearly collinear features and the rows of J's first
    three CTAs masked; J, K and its eval route and L (its three variants)
    bit-equal on a second launch, the eval route's y bit-equal to K's fed
    the factor it returns, the frozen L with dx bit-equal to the frozen L
    and M's frozen variant alone; J, L (each variant) and the eval route
    one CUDA kernel a call each, J's and L's clusters in one wave.  Returns
    the timing records."""
    from phc_gnn_torch.ops import fused_whitening as fw

    n, d = batch.num_nodes, DIM // 4
    plan = fw.wbn_plan(n, d, fw.WBN_STATS_SUMS)
    cases = {f"main [{n}, {4 * d}]": (n, d, "main", batch.node_mask),
             f"ragged [1100, {4 * d}]": (1100, d, "random", None),
             "d = 49 [1100, 196]": (1100, 49, "random", None),
             f"all-masked [{n}, {4 * d}]": (n, d, "all-masked", None),
             "one-row [129, 196]": (129, 49, "one-row", None),
             f"offset 1e3, std 0.1 [{n}, {4 * d}]": (n, d, "offset", None),
             f"collinear [{n}, {4 * d}]": (n, d, "collinear", None),
             f"CTAs 0-2 masked [{n}, {4 * d}] ({plan.rows_per_cta} rows a "
             f"CTA)": (n, d, "ctas masked", None)}
    wrappers = kernel_wrappers()
    # K runs twice in the chain, K and its eval route; L three times, the
    # training variant, the frozen one and the frozen one with dx; M twice,
    # the training variant and the frozen one alone
    calls = {"wbn_stats": 1, "wbn_transform": 2, "wbn_bwd_sums": 3,
             "wbn_dx": 2}
    for case, (cn, cd, kind, node_mask) in cases.items():
        x, mask, gamma, beta, g = whitening_case(torch, dev, cn, cd, kind,
                                                 node_mask)
        before = {k: wrappers[k].launches for k in calls}
        got = whitening_chain(fw, x, mask, gamma, beta, g, kernels=True)
        torch.cuda.synchronize()
        if {k: wrappers[k].launches - before[k] for k in calls} != calls:
            fail(f"{case}: the whitening launch counters did not move")
        mean, cov, l = (got["wbn_stats"][k] for k in ("mean", "cov", "L"))
        l_eval = got["wbn_transform"]["eval L of cov"]
        again = {"wbn_stats": fw.wbn_stats(x, mask, 1e-5),
                 "wbn_transform": (fw.wbn_transform(x, mean, l, gamma, beta),)
                 + fw.wbn_transform_eval(x, mean, cov, gamma, beta, 1e-5),
                 "wbn_transform fed the eval route's factor": (
                     fw.wbn_transform(x, mean, l_eval, gamma, beta),),
                 "wbn_bwd_sums": fw.wbn_bwd_sums(x, g, gamma, mean, l),
                 "frozen wbn_bwd_sums": fw.wbn_bwd_sums(x, g, gamma, mean, l,
                                                        frozen=True),
                 "frozen wbn_bwd_sums with dx": fw.wbn_bwd_sums(
                     x, g, gamma, mean, l, frozen=True, with_dx=True),
                 # the frozen L with dx is the frozen L and M's frozen
                 # variant alone, bit for bit
                 "frozen wbn_bwd_sums with dx against the frozen L and M": (
                     got["wbn_bwd_sums"]["frozen dgamma"],
                     got["wbn_bwd_sums"]["frozen dbeta"],
                     got["wbn_dx"]["frozen dx"])}
        sums = tuple(got["wbn_bwd_sums"].values())
        firsts = {"wbn_stats": tuple(got["wbn_stats"].values()),
                  "wbn_transform": tuple(got["wbn_transform"].values()),
                  "wbn_transform fed the eval route's factor": (
                      got["wbn_transform"]["eval y"],),
                  "wbn_bwd_sums": sums[:4],
                  "frozen wbn_bwd_sums": sums[4:6],
                  "frozen wbn_bwd_sums with dx": sums[6:],
                  "frozen wbn_bwd_sums with dx against the frozen L and M":
                      sums[6:]}
        torch.cuda.synchronize()
        for kname, outs in again.items():
            if not all(torch.equal(a, b) for a, b in zip(firsts[kname], outs)):
                fail(f"{kname}: two launches on {case} differ")
        print(f"kernel wbn_bwd_sums [{case}]: frozen with dx bit-equal to "
              f"the frozen L and M's frozen variant alone, and on a second "
              f"launch", flush=True)
        want = whitening_chain(fw, x.double(), mask, gamma.double(),
                               beta.double(), g.double(), kernels=False)
        plain = whitening_chain(fw, x, mask, gamma, beta, g, kernels=False)
        if float(got["wbn_stats"]["cnt"]) != float(want["wbn_stats"]["cnt"]):
            fail(f"wbn_stats: cnt {float(got['wbn_stats']['cnt'])} on {case}")
        for kname, outs in got.items():
            for what, tensor in outs.items():
                if what == "cnt":
                    continue
                ref = want[kname][what]
                f32_err = leafwise(plain[kname][what], ref)[1]
                check(errs, kname, f"{case}, {what}", tensor, ref,
                      max(TOL_WBN, COND_WBN * f32_err),
                      note=f"; the plain version in f32 reads {f32_err:.3e}")
        if kind == "collinear":
            collinear_split(fw, (x, mask, gamma, beta, g), want, plain, case)

    x, mask, gamma, beta, g = whitening_case(torch, dev, n, d, "main",
                                             batch.node_mask)
    mean, cov, l, cnt = fw.wbn_stats(x, mask, 1e-5)
    dgamma, dbeta, mmat, sw = fw.wbn_bwd_sums(x, g, gamma, mean, l)
    x_bytes, f_bytes = n * 4 * d * 4, d * 4  # [N, 4d] f32; one [d] field
    eye = 1e-5 * torch.eye(4, device=dev)  # the library Cholesky's eps I
    src = "phc_gnn_torch/csrc/fused_whitening.cu"
    pallas = "phc_gnn_tpu/ops/fused_whitening.py"
    recs = [
        record(torch, "wbn_stats", src, f"{pallas}:184", errs,
               lambda: fw.wbn_stats(x, mask, 1e-5),
               lambda: fw.wbn_stats_plain(x, mask, 1e-5), None,
               x_bytes + n + (4 + 16 + 10) * f_bytes + 4, 28 * n * d),
        record(torch, "wbn_transform", src, f"{pallas}:236", errs,
               lambda: fw.wbn_transform(x, mean, l, gamma, beta),
               lambda: fw.wbn_transform_plain(x, mean, l, gamma, beta), None,
               2 * x_bytes + (4 + 10 + 16 + 4) * f_bytes, 56 * n * d),
        record(torch, "wbn_bwd_sums", src, f"{pallas}:253", errs,
               lambda: fw.wbn_bwd_sums(x, g, gamma, mean, l),
               lambda: fw.wbn_bwd_sums_plain(x, g, gamma, mean, l), None,
               2 * x_bytes + (16 + 4 + 10 + 16 + 4 + 16 + 4) * f_bytes,
               40 * n * d),
        record(torch, "wbn_dx", src, f"{pallas}:304", errs,
               lambda: fw.wbn_dx(x, g, mask, gamma, mean, l, mmat, sw, cnt),
               lambda: fw.wbn_dx_plain(x, g, mask, gamma, mean, l, mmat, sw,
                                       cnt), None,
               3 * x_bytes + n + (16 + 4 + 10 + 16 + 4) * f_bytes + 4,
               96 * n * d)]
    recs[1]["also_replaces"] = ("the eval path's Cholesky and inline "
                                "whitening, phc_gnn_tpu/nn/norm.py:331-345")
    recs[2]["also_replaces"] = ("the T/S/M algebra in XLA between L and M, "
                                f"{pallas}:408-412")
    # K's eval route: the running covariance's upper triangle read and its
    # factor written beside K's bytes, one CUDA kernel a call; no PyTorch
    # call computes it, so the Cholesky alone in one call as context
    eval_fn = lambda: fw.wbn_transform_eval(  # noqa: E731
        x, mean, cov, gamma, beta, 1e-5)
    route = variant(torch, "wbn_transform", eval_fn,
                    2 * x_bytes + (4 + 10 + 16 + 4 + 10) * f_bytes,
                    "eval route, the Cholesky folded in")
    route["replaces"] = "phc_gnn_tpu/nn/norm.py:331-345"
    route["context_cholesky_ex_graph_ms"] = time_graph(
        torch, lambda: torch.linalg.cholesky_ex(cov.permute(2, 0, 1) + eye).L)
    prof = kernels_a_call(torch, eval_fn, 1)
    print(f"kernel wbn_transform (eval route): {prof['kernels_per_call']:g} "
          f"CUDA kernel a call; the Cholesky alone in cholesky_ex "
          f"{route['context_cholesky_ex_graph_ms'] * 1e3:.2f} us device",
          flush=True)
    if prof["kernels_per_call"] != 1:
        fail(f"the eval route runs {prof['kernels_per_call']:g} CUDA kernels "
             f"a call, not one")
    recs[1]["eval_route"] = route
    # the frozen variants, the eval whitening's backward: L reads x, g, the
    # mean and L and writes dGamma and dbeta; with dx it reads Gamma too and
    # writes dx; M alone reads g, L and Gamma and writes dx
    recs[2]["frozen_variant"] = variant(
        torch, "wbn_bwd_sums", lambda: fw.wbn_bwd_sums(x, g, gamma, mean, l,
                                                       frozen=True),
        2 * x_bytes + (4 + 10 + 16 + 4) * f_bytes)
    frozen_dx = lambda: fw.wbn_bwd_sums(  # noqa: E731
        x, g, gamma, mean, l, frozen=True, with_dx=True)
    recs[2]["frozen_dx_variant"] = variant(
        torch, "wbn_bwd_sums", frozen_dx,
        3 * x_bytes + (4 + 10 + 16 + 16 + 4) * f_bytes, "frozen, with dx")
    recs[3]["frozen_variant"] = variant(
        torch, "wbn_dx", lambda: fw.wbn_dx(x, g, None, gamma, mean, l, None,
                                           None, None, frozen=True),
        2 * x_bytes + (10 + 16) * f_bytes)
    # J, L and L frozen, without and with dx: one CUDA kernel a call each,
    # all of a plan's clusters on the card at once
    splits = {"wbn_stats": (recs[0], lambda: fw.wbn_stats(x, mask, 1e-5),
                            fw.WBN_STATS_SUMS),
              "wbn_bwd_sums": (recs[2],
                               lambda: fw.wbn_bwd_sums(x, g, gamma, mean, l),
                               fw.WBN_SUMS),
              "wbn_bwd_sums_frozen": (
                  recs[2]["frozen_variant"],
                  lambda: fw.wbn_bwd_sums(x, g, gamma, mean, l, frozen=True),
                  fw.WBN_SUMS),
              "wbn_bwd_sums_frozen_dx": (recs[2]["frozen_dx_variant"],
                                         frozen_dx, fw.WBN_SUMS)}
    for what, (rec, fn, sums) in splits.items():
        prof = kernels_a_call(torch, fn, 1)
        rec["cuda_kernels_us"] = {
            re.search(r"wbn_\w+_kernel", name).group(0): us
            for name, us in prof["top_us"] if "wbn_" in name}
        plan = fw.wbn_plan(n, d, sums)
        rec["plan"] = plan._asdict()
        rec["plan"]["resident_clusters"] = fw._max_active_clusters(plan, what)
        print(f"kernel {what}: {prof['kernels_per_call']:g} CUDA kernel a "
              f"call, {rec['cuda_kernels_us']} (us of device time a call, "
              f"torch.profiler over 20 calls); {plan.grid} CTAs in clusters "
              f"of {plan.cluster}, slabs of {plan.slab} features, "
              f"{plan.rows_per_cta} rows a CTA; the card holds "
              f"{rec['plan']['resident_clusters']} of its "
              f"{plan.grid // plan.cluster} clusters at once", flush=True)
        if prof["kernels_per_call"] != 1 or len(rec["cuda_kernels_us"]) != 1:
            fail(f"{what} runs {prof['kernels_per_call']:g} CUDA kernels a "
                 f"call, not one")
        if rec["plan"]["resident_clusters"] < plan.grid // plan.cluster:
            fail(f"{what} at [{n}, {4 * d}] runs its clusters in more than "
                 f"one wave")
    return recs


def segment_reduce_kernels(torch, dev, batch, errs):
    """H (max and min) and I (mean and var) against their plain versions in
    float64 over the flagship's receiver CSR at D = 200 with the PNA path's
    ReLU messages, on exact ties (halves in [-1.5, 1.5] through a ReLU), on
    the adversarial receivers (an isolated node, a 1,100-edge segment,
    one-edge segments, masked edges inside segments, an all-masked one), and
    H on |m| >= 1e29 (I's squares overflow f32 there, as JAX's do).  H must
    match exactly (a selection); I within TOL_SUM, and var 0 exactly on every
    segment of one real edge.  Returns their timing records."""
    from phc_gnn_torch.ops import segment_reduce as sr
    from phc_gnn_torch.ops import segment_sum as ssum

    gen = torch.Generator().manual_seed(5)
    e, rp, k = batch.num_edges, batch.rowptr, batch.edge_mask
    main = torch.relu(torch.randn((e, DIM), generator=gen)).to(dev)
    ties = torch.relu(torch.randint(-3, 4, (e, DIM), generator=gen) / 2).to(dev)
    huge = torch.randn((e, DIM), generator=gen)
    huge = (torch.sign(huge) * (1e29 + 1e30 * huge.abs())).to(dev)
    adv_m, adv_k, _, adv_rp = adversarial_case(torch, dev, DIM)
    cases = {f"main [{e}, {DIM}]": (main, k, rp, True),
             "ties": (ties, k, rp, True),
             "adversarial": (adv_m, adv_k, adv_rp, True),
             "|m| >= 1e29": (huge, k, rp, False)}
    for case, (m, mk, mrp, moments) in cases.items():
        before = (sr.segment_extreme.launches, sr.segment_moments.launches)
        outs = {what: sr.segment_extreme(m, mk, mrp, minimum=what == "min")
                for what in ("max", "min")}
        mean, var = sr.segment_moments(m, mk, mrp) if moments else (None, None)
        torch.cuda.synchronize()
        if (sr.segment_extreme.launches, sr.segment_moments.launches) != (
                before[0] + 2, before[1] + int(moments)):
            fail(f"{case}: the launch counters of H and I did not move")
        for what, out in outs.items():
            want = sr.segment_extreme_plain(m.double(), mk, mrp,
                                            minimum=what == "min")
            check(errs, "segment_extreme", f"{case}, {what}", out, want, 0.0,
                  note="; a selection: exact")
        if not moments:
            continue
        r_mean, r_var = sr.segment_moments_plain(m.double(), mk, mrp)
        check(errs, "segment_moments", f"{case}, mean", mean, r_mean, TOL_SUM)
        check(errs, "segment_moments", f"{case}, var", var, r_var, TOL_SUM)
        seg = ssum.segment_ids(mrp)
        real = torch.zeros(mrp.shape[0] - 1, device=dev).index_add_(
            0, seg, mk[:seg.shape[0]].float())
        if not bool((var[real == 1] == 0).all()):
            fail(f"segment_moments: a one-edge segment's var is not 0 on "
                 f"{case}")
        if case == "adversarial" and not all(
                bool((t[r] == 0).all()) for t in (mean, var, *outs.values())
                for r in (3, 11)):
            fail("H or I: an isolated or all-masked segment did not give 0")

    n, d = rp.shape[0] - 1, DIM
    seg = ssum.segment_ids(rp)
    real = k[:seg.shape[0]].nonzero()[:, 0]
    rows, index = main[real], seg[real][:, None].expand(-1, d).contiguous()
    e_real, zeros = real.shape[0], torch.zeros((n, d), device=dev)
    stacked = torch.cat([rows, rows * rows], 1)
    zeros2 = torch.zeros((n, 2 * d), device=dev)
    in_bytes = e_real * d * 4 + int(rp[-1]) + (n + 1) * 4
    src = "phc_gnn_torch/csrc/segment_reduce.cu"
    rec_h = record(torch, "segment_extreme", src,
                   "phc_gnn_tpu/ops/stream_scan.py:600", errs,
                   lambda: sr.segment_extreme(main, k, rp),
                   lambda: sr.segment_extreme_plain(main, k, rp),
                   lambda: zeros.scatter_reduce(0, index, rows, "amax",
                                                include_self=False),
                   in_bytes + n * d * 4, e_real * d)
    rec_i = record(torch, "segment_moments", src,
                   "phc_gnn_tpu/ops/stream_scan.py:383", errs,
                   lambda: sr.segment_moments(main, k, rp),
                   lambda: sr.segment_moments_plain(main, k, rp), None,
                   in_bytes + 2 * n * d * 4, 4 * e_real * d + 4 * n * d)
    rec_h["also_replaces"] = ("the min as -max(-m), _seg_extreme_streamed "
                              "phc_gnn_tpu/ops/stream_scan.py:1012")
    rec_i["also_replaces"] = ("the XLA glue of _seg_var_parts, "
                              "phc_gnn_tpu/ops/stream_scan.py:1088-1093")
    # no single PyTorch call computes I's joint sums; one index_add_ of the
    # stacked [m, m^2] as context
    rec_i["context_index_add_stacked_graph_ms"] = time_graph(
        torch, lambda: zeros2.index_add(0, seg[real], stacked))
    print(f"kernel segment_moments: context, one index_add_ of [m, m^2] "
          f"{rec_i['context_index_add_stacked_graph_ms'] * 1e3:.2f} us device",
          flush=True)
    return [rec_h, rec_i]


def bf16_kernels(torch, dev, batch, pcba, pcba_eval, errs):
    """A, B (both variants), A fused into B (both variants) and C (both
    roles, both instances) on bf16 rows against their plain
    versions on the same bf16 rows (which upcast, so the float32
    tolerances hold), at the flagship's and pcba's shapes and on the
    adversarial cases of the float32 checks; each bf16 output also against
    the float32 instance fed the upcast rows (the conversion is exact, so
    the same bits are expected), the fused kernel's ``out``, ``w`` and
    ``den`` against A bf16 then B bf16, and C's two instances (the bulk
    one and the one without it) against each other wherever the rows
    allow the bulk one; the softmax backward on bf16 rows against the plain
    backward (``dm`` bit-equal) and its ``dm`` against the float32
    instance's on the upcast rows rounded to bf16.  Returns the timing
    records of the four bf16 kernels of the main paths (the fused softmax
    with A bf16 and B bf16 timed beside it, the softmax backward, C's two
    roles with both instances), their bounds at the bf16 input bytes."""
    from phc_gnn_torch.ops import segment_softmax as ss
    from phc_gnn_torch.ops import segment_sum as ssum

    gen = torch.Generator().manual_seed(7)
    msgs = torch.randn((batch.num_edges, DIM), generator=gen).to(dev).to(
        torch.bfloat16)
    beta = torch.tensor(1.37, device=dev)
    adv_m, adv_k, adv_b, adv_rp = adversarial_case(torch, dev, DIM)
    same_bits = {}
    cgen = torch.Generator().manual_seed(8)  # the backward's cotangents
    cot = {}
    # rows one element past a 4-byte boundary take one lane a thread
    off16 = offset_copy(torch, msgs, 1)
    cases = {"main": (msgs, batch.edge_mask, beta, batch.rowptr),
             "adversarial": (adv_m.to(torch.bfloat16), adv_k, adv_b, adv_rp),
             "d = 37": (msgs[:, :37].contiguous(), batch.edge_mask, beta,
                        batch.rowptr),
             "rows off alignment": (off16, batch.edge_mask, beta,
                                    batch.rowptr)}
    for name, (m, k, b, rp) in cases.items():
        before = (ss.segment_logit_max.launches_bf16,
                  ss.segment_softmax_aggregate.launches_bf16)
        smax = ss.segment_logit_max(m, k, b, rp)
        out, w, den = ss.segment_softmax_aggregate(m, k, b, rp, smax,
                                                   emit_w=True)
        out_nw = ss.segment_softmax_aggregate(m, k, b, rp, smax)
        torch.cuda.synchronize()
        if (ss.segment_logit_max.launches_bf16 != before[0] + 1
                or ss.segment_softmax_aggregate.launches_bf16
                != before[1] + 2):
            fail(f"bf16 {name}: the bf16 launch counters did not move")
        smax_ref = ss.segment_logit_max_plain(m, k, b, rp)
        out_ref, w_ref, den_ref = ss.segment_softmax_aggregate_plain(
            m, k, b, rp, smax_ref, emit_w=True)
        check(errs, "segment_logit_max_bf16", name, smax, smax_ref, TOL_MAX,
              identity=ss.NEG, own_scale=False)
        for what, got, want in (("out", out, out_ref),
                                ("eval out", out_nw, out_ref), ("w", w, w_ref)):
            check(errs, "segment_softmax_aggregate_bf16", f"{name}, {what}",
                  got, want, TOL_AGG, own_scale=False)
        check(errs, "segment_softmax_aggregate_bf16", f"{name}, den", den,
              den_ref, TOL_AGG)
        up = m.float()
        smax32 = ss.segment_logit_max(up, k, b, rp)
        f32 = ss.segment_softmax_aggregate(up, k, b, rp, smax32, True)
        same_bits[f"A {name}"] = torch_equal(smax, smax32)
        same_bits[f"B {name}"] = all(map(torch_equal, (out, w, den), f32))
        # A fused into B in both variants, against A then B and f32
        same_bits[f"fused {name} = A then B"] = hold_fused(
            torch, errs, "segment_softmax_fused_bf16", name, m, k, b, rp)
        same_bits[f"fused {name} = f32"] = all(map(
            torch_equal, ss.segment_softmax_fused(m, k, b, rp, True), f32))
        # the backward: dm bit-equal to the plain backward, and to the
        # float32 instance's dm on the upcast rows rounded to bf16
        cot[name] = torch.randn((rp.shape[0] - 1, m.shape[1]),
                                generator=cgen).to(dev)
        dm16 = hold_softmax_backward(torch, errs,
                                     "segment_softmax_backward_bf16", name,
                                     m, k, b, rp, cot[name])
        dm32, _ = ss.segment_softmax_backward(
            up, b, f32[1], f32[2], f32[0], cot[name], rp,
            csr_receivers(torch, rp, m.shape[0]))
        same_bits[f"backward {name} = f32"] = torch_equal(
            dm16, dm32.to(torch.bfloat16))

    g = torch.randn((batch.num_edges, DIM), generator=gen).to(dev).to(
        torch.bfloat16)
    p_g = torch.randn((pcba.num_edges, PCBA_DIM), generator=gen).to(dev).to(
        torch.bfloat16)
    adv_g, adv_perm, adv_srp = adversarial_senders(torch, dev, DIM)
    # rows one element past a 16-byte boundary take the scalar instance
    off = offset_copy(torch, g, 1)
    perm_cases = {"main": (g, batch.snd_perm, batch.snd_rowptr),
                  f"pcba [{pcba.num_edges}, {PCBA_DIM}]": (
                      p_g, pcba.snd_perm, pcba.snd_rowptr),
                  "d = 37": (g[:, :37].contiguous(), batch.snd_perm,
                             batch.snd_rowptr),
                  "rows off 16-byte alignment": (off, batch.snd_perm,
                                                 batch.snd_rowptr),
                  "adversarial": (adv_g.to(torch.bfloat16), adv_perm,
                                  adv_srp)}
    pm = torch.randn((pcba.num_edges, PCBA_DIM), generator=gen).to(dev).to(
        torch.bfloat16)
    e_m = torch.randn((pcba_eval.num_edges, PCBA_DIM), generator=gen).to(dev).to(
        torch.bfloat16)
    masked_cases = {f"pcba [{pcba.num_edges}, {PCBA_DIM}]": (
                        pm, pcba.edge_mask, pcba.rowptr),
                    f"eval [{pcba_eval.num_edges}, {PCBA_DIM}]": (
                        e_m, pcba_eval.edge_mask, pcba_eval.rowptr),
                    "flagship": (msgs, batch.edge_mask, batch.rowptr),
                    "d = 37": (pm[:, :37].contiguous(), pcba.edge_mask,
                               pcba.rowptr),
                    "adversarial": (adv_m.to(torch.bfloat16), adv_k, adv_rp)}
    for kname, fn, plain, role_cases in (
            ("segment_sum_perm", ssum.segment_sum_perm,
             ssum.segment_sum_perm_plain, perm_cases),
            ("segment_sum_masked", ssum.segment_sum_masked,
             ssum.segment_sum_masked_plain, masked_cases)):
        for name, (v, idx, rp) in role_cases.items():
            before = fn.launches_bf16
            out = fn(v, idx, rp)
            torch.cuda.synchronize()
            if fn.launches_bf16 != before + 1:
                fail(f"bf16 {name}: the bf16 launch counter of {kname} did "
                     f"not move")
            check(errs, f"{kname}_bf16", name, out,
                  plain(v.double(), idx, rp), TOL_SUM)
            hold_sequential(torch, f"{kname}_bf16", name, out, fn(v, idx, rp),
                            plain(v.cpu(), idx.cpu(), rp.cpu()))
            same_bits[f"C {kname} {name}"] = torch_equal(
                out, fn(v.float(), idx, rp))
            role = kname.rsplit("_", 1)[1]
            if ssum.segment_sum_plan(rp.shape[0] - 1, v.shape[0], v.shape[1],
                                     role == "perm",
                                     v.data_ptr() % 16 == 0, 2, True).bulk:
                both = [ssum.segment_sum_instance(role, v, idx, rp, bulk)
                        for bulk in (True, True, False)]
                same_bits[f"C two instances {kname} {name}"] = all(
                    torch_equal(out, x) for x in both)
    print(f"bf16 kernels: bit-equal to the float32 instance fed the upcast "
          f"rows: {same_bits}", flush=True)
    if not all(same_bits.values()):
        fail("a bf16 instance differs from the float32 instance on the "
             "upcast rows")

    # timings at the main paths' shapes, bounds at the bf16 input bytes
    n, d = batch.rowptr.shape[0] - 1, DIM
    e_seg = int(batch.rowptr[-1])
    seg = torch.repeat_interleave(torch.arange(n, device=dev),
                                  (batch.rowptr[1:] - batch.rowptr[:-1]).long())
    k = batch.edge_mask
    logits = torch.where(k[:e_seg, None], beta * msgs[:e_seg].float(), ss.NEG)
    index = seg[:, None].expand(e_seg, d).contiguous()
    init = torch.full((n, d), ss.NEG, device=dev)
    in_bytes = e_seg * d * 2 + e_seg + (n + 1) * 4 + 4
    nd_bytes = n * d * 4
    smax = ss.segment_logit_max(msgs, k, beta, batch.rowptr)
    src = "phc_gnn_torch/csrc/segment_softmax.cu"
    rp = batch.rowptr
    rec_f = record(torch, "segment_softmax_fused_bf16", src,
                   "phc_gnn_tpu/ops/stream_scan.py:521", errs,
                   lambda: ss.segment_softmax_fused(msgs, k, beta, rp),
                   lambda: ss.segment_softmax_aggregate_plain(
                       msgs, k, beta, rp,
                       ss.segment_logit_max_plain(msgs, k, beta, rp)),
                   None, in_bytes + nd_bytes, 8 * e_seg * d + n * d)
    rec_f["replaces_too"] = ("phc_gnn_tpu/ops/stream_scan.py:415 (A), :439 "
                             "(B's training variant)")
    rec_f["train_variant"] = variant(
        torch, "segment_softmax_fused_bf16",
        lambda: ss.segment_softmax_fused(msgs, k, beta, rp, emit_w=True),
        in_bytes + 2 * nd_bytes + msgs.shape[0] * d * 4,
        "training variant, w and den")
    rec_f["train_variant"]["replaces"] = "phc_gnn_tpu/ops/stream_scan.py:439"
    # the parent pair in the same call: A bf16 then B bf16, as graphs of
    # the two calls
    rec_f["parent_pair_graph_ms"] = {
        "eval": time_graph(torch, lambda: ss.segment_softmax_aggregate(
            msgs, k, beta, rp, ss.segment_logit_max(msgs, k, beta, rp))),
        "train": time_graph(torch, lambda: ss.segment_softmax_aggregate(
            msgs, k, beta, rp, ss.segment_logit_max(msgs, k, beta, rp),
            emit_w=True))}
    print(f"kernel segment_softmax_fused_bf16: A bf16 then B bf16 in the "
          f"same call {rec_f['parent_pair_graph_ms']['eval'] * 1e3:.2f} us "
          f"device (eval), {rec_f['parent_pair_graph_ms']['train'] * 1e3:.2f}"
          f" us (training)", flush=True)
    rec_a = record(torch, "segment_logit_max_bf16", src,
                   "phc_gnn_tpu/ops/stream_scan.py:415", errs,
                   lambda: ss.segment_logit_max(msgs, k, beta, rp),
                   lambda: ss.segment_logit_max_plain(msgs, k, beta, rp),
                   lambda: init.scatter_reduce(0, index, logits, "amax"),
                   in_bytes + nd_bytes, 2 * e_seg * d)
    rec_b = record(torch, "segment_softmax_aggregate_bf16", src,
                   "phc_gnn_tpu/ops/stream_scan.py:521", errs,
                   lambda: ss.segment_softmax_aggregate(msgs, k, beta, rp,
                                                        smax),
                   lambda: ss.segment_softmax_aggregate_plain(msgs, k, beta,
                                                              rp, smax),
                   None, in_bytes + 2 * nd_bytes, 6 * e_seg * d + n * d)
    rec_b["train_variant"] = variant(
        torch, "segment_softmax_aggregate_bf16",
        lambda: ss.segment_softmax_aggregate(msgs, k, beta, rp, smax,
                                             emit_w=True),
        in_bytes + 3 * nd_bytes + msgs.shape[0] * d * 4,
        "training variant, w and den")
    rec_b["train_variant"]["replaces"] = "phc_gnn_tpu/ops/stream_scan.py:439"
    # A bf16 and B bf16 run on no main path now (the fused kernel does their
    # work): their records sit in the fused kernel's, not in the line
    rec_f["parent_pair"] = {"segment_logit_max_bf16": rec_a,
                            "segment_softmax_aggregate_bf16": rec_b}
    rec_bw = softmax_backward_record(
        torch, errs, "segment_softmax_backward_bf16", msgs, k, beta, rp,
        batch.receivers, cot["main"])

    def c_record(kname, fn, plain, v, idx, rp, real_rows, seg_of_real, role):
        """C's bf16 instance: the library call is one ``index_add_`` of the
        real rows, upcast outside the call (a bf16 ``index_add_`` would sum
        in bf16)."""
        n, d = rp.shape[0] - 1, v.shape[1]
        e_real = real_rows.shape[0]
        rows32 = v[real_rows].float()
        zeros = torch.zeros((n, d), device=dev)
        nbytes = e_real * d * 2 + idx.numel() * idx.element_size() \
            + (n + 1) * 4 + n * d * 4
        rec = record(torch, f"{kname}_bf16",
                     "phc_gnn_torch/csrc/segment_sum.cu",
                     "phc_gnn_tpu/ops/stream_scan.py:373", errs,
                     lambda: fn(v, idx, rp), lambda: plain(v, idx, rp),
                     lambda: zeros.clone().index_add_(0, seg_of_real, rows32),
                     nbytes, e_real * d)
        rec["role"] = role
        return rec

    e_real = int(batch.snd_rowptr[-1])
    real = batch.snd_perm[:e_real].long()
    rec_cp = c_record("segment_sum_perm", ssum.segment_sum_perm,
                      ssum.segment_sum_perm_plain, g, batch.snd_perm,
                      batch.snd_rowptr, real, batch.senders[real].long(),
                      "gather backward (_gather_sb_bwd :854), the messages' "
                      "bf16 cotangent")
    p_real = pcba.snd_perm[:int(pcba.snd_rowptr[-1])].long()
    p_lib = torch.zeros((pcba.num_nodes, PCBA_DIM), device=dev)
    p_rows = p_g[p_real].float()
    p_seg = pcba.senders[p_real].long()
    p_fn = lambda: ssum.segment_sum_perm(  # noqa: E731
        p_g, pcba.snd_perm, pcba.snd_rowptr)
    p_bytes = (p_real.shape[0] * PCBA_DIM * 2 + pcba.num_edges * 4
               + (pcba.num_nodes + 1) * 4 + pcba.num_nodes * PCBA_DIM * 4)
    rec_cp["pcba_shape"] = {
        "ms": time_eager(torch, p_fn), "graph_ms": time_graph(torch, p_fn),
        "bound_ms": p_bytes / HBM_BYTES_PER_S * 1e3, "bytes": p_bytes,
        "library_graph_ms": time_graph(
            torch, lambda: p_lib.clone().index_add_(0, p_seg, p_rows))}
    m_seg = torch.repeat_interleave(
        torch.arange(pcba.num_nodes, device=dev),
        (pcba.rowptr[1:] - pcba.rowptr[:-1]).long())
    m_real = pcba.edge_mask[:m_seg.shape[0]].nonzero()[:, 0]
    rec_cm = c_record("segment_sum_masked", ssum.segment_sum_masked,
                      ssum.segment_sum_masked_plain, pm, pcba.edge_mask,
                      pcba.rowptr, m_real, m_seg[m_real],
                      "forward of the sum aggregation (_seg_sum_streamed "
                      ":698) and the mean's sum (:974), bf16 messages")
    e_seg_ids = torch.repeat_interleave(
        torch.arange(pcba_eval.num_nodes, device=dev),
        (pcba_eval.rowptr[1:] - pcba_eval.rowptr[:-1]).long())
    e_real = pcba_eval.edge_mask[:e_seg_ids.shape[0]].nonzero()[:, 0]
    e_rows = e_m[e_real].float()
    e_lib = torch.zeros((pcba_eval.num_nodes, PCBA_DIM), device=dev)
    e_fn = lambda: ssum.segment_sum_masked(  # noqa: E731
        e_m, pcba_eval.edge_mask, pcba_eval.rowptr)
    e_bytes = (e_real.shape[0] * PCBA_DIM * 2 + pcba_eval.num_edges
               + (pcba_eval.num_nodes + 1) * 4
               + pcba_eval.num_nodes * PCBA_DIM * 4)
    rec_cm["eval_shape"] = {
        "ms": time_eager(torch, e_fn), "graph_ms": time_graph(torch, e_fn),
        "bound_ms": e_bytes / HBM_BYTES_PER_S * 1e3, "bytes": e_bytes,
        "library_graph_ms": time_graph(
            torch, lambda: e_lib.clone().index_add_(0, e_seg_ids[e_real],
                                                    e_rows))}
    for rec, shape, key in ((rec_cp, "pcba's", "pcba_shape"),
                            (rec_cm, "the eval", "eval_shape")):
        r = rec[key]
        print(f"kernel {rec['name']} at {shape} shape: {r['ms'] * 1e3:.2f} us "
              f"per call, {r['graph_ms'] * 1e3:.2f} us device, bound "
              f"{r['bound_ms'] * 1e3:.2f} us, library "
              f"{r['library_graph_ms'] * 1e3:.2f} us device", flush=True)
    # C's two instances at each shape: the plan's (above) beside the bulk
    # instance and the one without it, device ms from a CUDA graph
    for rec, role, shapes in (
            (rec_cp, "perm", {"flagship": (g, batch.snd_perm,
                                           batch.snd_rowptr),
                              "pcba": (p_g, pcba.snd_perm,
                                       pcba.snd_rowptr)}),
            (rec_cm, "masked", {"pcba": (pm, pcba.edge_mask, pcba.rowptr),
                                "eval": (e_m, pcba_eval.edge_mask,
                                         pcba_eval.rowptr)})):
        rec["instances_graph_ms"] = {
            shape: {key: time_graph(torch, lambda: ssum.segment_sum_instance(
                role, v, idx, rp, bulk)) for key, bulk in (("bulk", True),
                                                          ("nobulk", False))}
            for shape, (v, idx, rp) in shapes.items()}
        print(f"kernel {rec['name']}: device us of the bulk instance and of "
              f"the one without it: " + str({
                  shape: {k: round(v * 1e3, 2) for k, v in t.items()}
                  for shape, t in rec["instances_graph_ms"].items()}),
              flush=True)
    for rec in (rec_f, rec_a, rec_b, rec_cp, rec_cm):
        rec["bit_equal_to_f32_on_upcast_rows"] = True
    rec_bw["dm_bit_equal_to_f32_on_upcast_rows"] = True
    return [rec_f, rec_bw, rec_cp, rec_cm]


def kernel_phase(torch, dev):
    """Kernels vs plain versions at the main-path and adversarial shapes;
    returns the per-kernel records (launches filled in later)."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan

    batch = attach_csr_plan(synthetic_batch(seed=0, **FLAGSHIP)).to(dev)
    pcba = pcba_batch(torch, 0, PCBA).to(dev)
    pcba_eval = pcba_batch(torch, 0, PCBA_EVAL).to(dev)
    errs: dict = {}
    return (softmax_kernels(torch, dev, batch, errs)
            + segment_sum_kernel(torch, dev, batch, pcba, errs)
            + segment_sum_masked_kernel(torch, dev, pcba, pcba_eval, errs)
            + batch_norm_kernels(torch, dev, batch, errs)
            + blocked_bn_kernels(torch, dev, pcba, errs)
            + whitening_kernels(torch, dev, batch, errs)
            + segment_reduce_kernels(torch, dev, batch, errs)
            + bf16_kernels(torch, dev, batch, pcba, pcba_eval, errs))


def flagship_config(dropout: bool = True) -> dict:
    """bench.py:140-146 at width DIM (``phc_gnn_torch.export``'s, the
    counterpart of ``__graft_entry__.entry()``'s); with ``dropout=False``
    every rate is 0."""
    from phc_gnn_torch.export import flagship_config as config

    return config(DIM, 4, dropout)


def randomize_eval_state(torch, model, seed: int = 1):
    """Random BN running stats (mean ~ N(0, 0.3), var ~ U(0.5, 2)) and the
    convs' betas (~ U(0.5, 2.5)), drawn on the CPU from ``seed``; for the
    whitening norms a random SPD running cov per feature, Gamma 0.5 I +
    N(0, 0.1) and beta ~ N(0, 0.3)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(".mean"):
                buf.copy_(torch.randn(buf.shape, generator=gen) * 0.3)
            elif name.endswith(".var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) * 1.5 + 0.5)
            elif name.endswith(".cov"):
                b = torch.randn((buf.shape[-1], 4, 4), generator=gen)
                spd = b @ b.transpose(1, 2) / 4 + 0.2 * torch.eye(4)
                buf.copy_(spd.permute(1, 2, 0))
        for name, p in model.named_parameters():
            if name.endswith(".beta") and p.ndim == 0:
                p.copy_(torch.rand((), generator=gen) * 2.0 + 0.5)
            elif name.endswith(".beta"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
            elif name.endswith(".gamma"):
                p.add_((torch.randn(p.shape, generator=gen) * 0.1).to(p.device))


def slice_phase(torch, dev):
    """The flagship eval forward through the kernels; returns the launch
    counts of the main-path run."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.models import PHCGNN
    from phc_gnn_torch.train import make_eval_step

    model = PHCGNN(**flagship_config(), seed=0, device=dev)
    randomize_eval_state(torch, model)
    host_batches = [attach_csr_plan(synthetic_batch(seed=s, **FLAGSHIP))
                    for s in range(N_BATCHES)]
    batches = [b.to(dev) for b in host_batches]
    step = make_eval_step(model, device=dev)
    try:
        step(batches[0].replace(rowptr=None))
    except ValueError as exc:
        print(f"slice: a CUDA batch without its CSR plan raises: {exc}",
              flush=True)
    else:
        fail("a CUDA batch without a CSR plan was served without the kernels")

    reset_launches()
    outs = [step(b) for b in batches]
    torch.cuda.synchronize()
    launches = read_launches()
    want = {name: 4 * N_BATCHES if name == "segment_softmax_fused" else 0
            for name in launches}
    print(f"slice: launches on the eval path {launches} (expected {want}: A "
          f"fused into B once per layer, 4 layers x {N_BATCHES} batches; A "
          f"and B alone and the training kernels never)", flush=True)
    if launches != want:
        fail(f"the eval path launched {launches}, not {want}")

    cpu_step = make_eval_step(copy.deepcopy(model).to("cpu"), device="cpu")
    for i, (out, hb) in enumerate(zip(outs, host_batches)):
        if out.shape != (FLAGSHIP["batch_size"] + 1, 1):
            fail(f"batch {i}: output shape {tuple(out.shape)}")
        if not torch.isfinite(out).all():
            fail(f"batch {i}: non-finite output")
        ref = cpu_step(hb)
        abs_err, rel_err = normwise(out.cpu(), ref)
        print(f"slice: batch {i} vs CPU plain path: max abs err {abs_err:.3e}, "
              f"normwise rel err {rel_err:.3e} (tolerance {TOL_MODEL:g}), "
              f"max |out| {float(ref.abs().max()):.3f}", flush=True)
        if not rel_err <= TOL_MODEL:
            fail(f"batch {i}: GPU output disagrees with the CPU path")

    real_edges = host_batches[0].count_edges()
    b0 = batches[0]
    eval_ms, host_ms = time_steps(torch, lambda: step(b0))
    print(f"slice: eval {eval_ms:.3f} ms per batch (CUDA events, median of 30; "
          f"host clock {host_ms:.3f} ms), "
          f"{real_edges / (eval_ms / 1e3):.4g} real edges/s "
          f"({real_edges} real edges)", flush=True)
    print(json.dumps({"slice": {"eval_ms": eval_ms,
                                "eval_host_ms": host_ms,
                                "real_edges": real_edges,
                                "real_edges_per_s": real_edges / (eval_ms / 1e3),
                                "batches": N_BATCHES}}), flush=True)
    graph_eval_ms = time_graph(torch, lambda: step(b0), iters=20)
    prof = device_profile(torch, lambda: step(b0), eval_ms, iters=20)
    print(f"profile: {prof['kernels_per_call']:g} kernels per forward, device "
          f"busy {prof['busy_ms']:.3f} ms of {eval_ms:.3f} ms eager (idle "
          f"{100 * prof['idle_share']:.1f} %), {graph_eval_ms:.3f} ms "
          f"from one CUDA graph", flush=True)
    print(json.dumps({"profile": {
        "graph_eval_ms": graph_eval_ms,
        "kernels_per_forward": prof["kernels_per_call"],
        "device_busy_ms_per_forward": prof["busy_ms"],
        "device_idle_share_eager": prof["idle_share"],
        "top_kernels_us_per_forward": prof["top_us"]}}), flush=True)
    return launches


def time_steps(torch, fn, warmup: int = 5, iters: int = 30):
    """(device ms, host ms) per call of ``fn``: CUDA events around each call
    and the host clock until it is done, medians of ``iters`` calls after
    ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    dev_ms, host_ms = [], []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    return statistics.median(dev_ms), statistics.median(host_ms)


def device_profile(torch, fn, call_ms: float, iters: int = 10) -> dict:
    """Where the time of ``fn`` goes, from torch.profiler over ``iters``
    calls: kernels per call, the device's busy time (sum of kernel
    durations) per call, its idle share of ``call_ms`` (1 - busy / call_ms)
    and the kernels that take the most device time, and the count of each
    kernel name over the ``iters`` calls.  The ranges that
    ``record_function`` marks on the device's timeline (torch's
    ``Optimizer.step`` is one) span kernels and are not counted."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    counts: dict = {}
    n_kernels = 0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation):
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            counts[e.name] = counts.get(e.name, 0) + 1
    if not n_kernels:
        fail("the profiler recorded no device kernels")
    busy_ms = sum(by_name.values()) / 1e3 / iters
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    pair = {k: sum(us for name, us in by_name.items() if f"{k}_kernel" in name)
            / iters for k in ("bn_forward", "bn_backward")}
    return {"kernels_per_call": n_kernels / iters, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / call_ms,
            "top_us": [[name[:90], us / iters] for name, us in top],
            "bn_pair_us": pair, "counts": counts}


def kernels_a_call(torch, fn, expected: int, iters: int = 20,
                   tries: int = 3) -> dict:
    """``device_profile`` of ``fn`` over ``iters`` calls for a count of its
    CUDA kernels a call, which the caller holds to ``expected``.  The
    profiler can drop a kernel's event (a call read 0.95 kernels once), so
    a count below ``expected`` is profiled again, up to ``tries`` times; a
    lost event cannot raise a count, so one above it fails at once."""
    for _ in range(tries):
        prof = device_profile(torch, fn, 1.0, iters=iters)
        if prof["kernels_per_call"] > expected:
            fail(f"{prof['kernels_per_call']:g} CUDA kernels a call, more "
                 f"than {expected}")
        if prof["kernels_per_call"] == expected:
            break
        print(f"profile: {prof['kernels_per_call']:g} CUDA kernels a call, "
              f"below {expected}: an event lost; profiled again", flush=True)
    return prof


def shift_invariant(key: str) -> bool:
    """Biases of the PHM layers that a batch norm follows (the MLPs'
    ``linear1`` and ``linear2``, a ``PHMConv``'s ``transform``, a PNA conv's
    one post layer, the head's hidden layers): their gradient is zero in
    exact arithmetic, as the norm removes any shift."""
    return key.endswith(("transform.linear1.b", "transform.linear2.b",
                         "conv.transform.b", "conv.post_0.b")) or (
        key.startswith("downstream.affine_") and key.endswith(".b")
        and key != "downstream.affine_2.b")


class ReluReplay:
    """ReLU that records its input's sign pattern, or applies a recorded one
    (``torch.where(mask, x, 0)``: relu's value and gradient where the mask
    is relu's own).  Inside ``patched()`` it also stands in for the PNA
    conv's message ReLU, and records or replays which edges attain each min
    and max (where the backward sends the cotangent) and where var > 0 in
    each std (relu's branch there): each is a place where an input within
    rounding of a boundary moves a gradient between devices.  Patterns are
    kept in call order; ``recorded()`` hands them to a replaying copy."""

    def __init__(self, torch, recorded=None):
        self.torch = torch
        self.replay = recorded is not None
        recorded = recorded or {}
        self.masks = recorded.get("relu", [])
        self.hits = recorded.get("hit", [])
        self.var_pos = recorded.get("var", [])
        self.calls = {"relu": 0, "hit": 0, "var": 0}

    def recorded(self):
        return {"relu": [m.cpu() for m in self.masks],
                "hit": [m.cpu() for m in self.hits],
                "var": [m.cpu() for m in self.var_pos]}

    def _next(self, kind, store, like):
        mask = store[self.calls[kind]].to(like.device)
        self.calls[kind] += 1
        return mask

    def __call__(self, x):
        if self.replay:
            return self.torch.where(self._next("relu", self.masks, x), x, 0.0)
        self.masks.append(x.detach() > 0)
        return self.torch.relu(x)

    def extreme(self, msgs, receivers, mask, rowptr, minimum=False):
        """The min or max aggregation, its cotangent sent to the recorded
        extreme edges: ``out + S - S.detach()`` with ``S`` the per-receiver
        sum of those edges' messages, whose gradient is 1 on each of them."""
        from phc_gnn_torch.ops import segment_reduce as sr

        torch = self.torch
        out = sr.segment_extreme_aggregate(msgs, receivers, mask, rowptr,
                                           minimum)
        if not self.replay:
            self.hits.append(mask[:, None] & (
                msgs.detach() == out.detach().index_select(0, receivers)))
            return out
        hit = self._next("hit", self.hits, msgs)
        routed = torch.zeros_like(out).index_add(
            0, receivers.long(), torch.where(hit, msgs, 0.0))
        return out.detach() + (routed - routed.detach())

    def std(self, msgs, receivers, mask, rowptr, counts):
        from phc_gnn_torch.ops import segment_reduce as sr

        var = sr.segment_var_aggregate(msgs, receivers, mask, rowptr, counts)
        if self.replay:
            var = self.torch.where(self._next("var", self.var_pos, var), var,
                                   0.0)
        else:
            self.var_pos.append(var.detach() > 0)
            var = self.torch.relu(var)
        return self.torch.sqrt(var + sr.STD_EPS)

    @contextlib.contextmanager
    def patched(self):
        from unittest import mock

        from phc_gnn_torch.graph import conv
        from phc_gnn_torch.nn.activations import get_activation

        def act(name):
            return self if name == "relu" else get_activation(name)

        with mock.patch.object(conv, "get_activation", act), \
                mock.patch.object(conv, "segment_extreme_aggregate",
                                  self.extreme), \
                mock.patch.object(conv, "segment_std_aggregate", self.std):
            yield

    def install(self, model):
        model.act = self
        model.downstream.act = self
        for i in range(model.num_layers):
            transform = getattr(getattr(model, f"conv_{i}").conv, "transform",
                                None)
            if hasattr(transform, "act"):  # a PHMMLP, not a PHMLinear
                transform.act = self
        return self


def switches(batch, got, own):
    """How many entries of the recorded patterns ``got`` differ from
    ``own``: ReLUs over the real nodes, edges or graphs, extreme edges and
    var signs over all."""
    def real(a):
        for rows in (batch.node_mask, batch.edge_mask, batch.graph_mask):
            if a.shape[0] == rows.shape[0]:
                return rows.cpu()
        return slice(None)

    return {kind: sum(int((a != b)[real(a) if kind == "relu" else
                                   slice(None)].sum())
                      for a, b in zip(got[kind], own[kind]))
            for kind in ("relu", "hit", "var")}


def exact_errors(c_grads, e_grads):
    """The CPU's own f32 error per gradient leaf against ``e_grads``, the
    same run in float64 with the same ReLU pattern."""
    return {k: leafwise(c_grads[k], e_grads[k])[1] for k in c_grads}


def grad_rule(worst):
    """The gradient tolerance and what it granted, for a phase's line."""
    return (f"tolerance {TOL_GRAD:g}, or {COND_GRAD:g}x the CPU's own f32 "
            f"error against float64 up to {TOL_GRAD_CAP:g}: the widest "
            f"limit {worst['grad_widest_tol']:.3e} on "
            f"{worst['grad_widest_tol_leaf']}; the largest error over its "
            f"leaf's limit {worst['grad_over_tol']:.3f}")


def hold_grads(phase, grads, c_grads, f32_err, worst, shift_noise=True):
    """The gradients per leaf: with ``shift_noise`` the biases a norm
    follows to a noise bound; each other leaf to ``max(TOL_GRAD,
    min(TOL_GRAD_CAP, COND_GRAD * f32_err))``, ``f32_err`` the CPU's own
    error on it against float64.  The worst readings go into ``worst``."""
    top = max(float(g.abs().max()) for g in c_grads.values())
    grad_errs, noise = {}, 0.0
    for key, g in grads.items():
        if shift_noise and shift_invariant(key):
            noise = max(noise, float(g.abs().max()) / top,
                        float(c_grads[key].abs().max()) / top)
        else:
            grad_errs[key] = leafwise(g, c_grads[key])[1]
    tol = {k: max(TOL_GRAD, min(TOL_GRAD_CAP, COND_GRAD * f32_err[k]))
           for k in grad_errs}
    worst["grad"] = max(grad_errs.values())
    worst["grad_leaf"] = max(grad_errs, key=grad_errs.get)
    worst["grad_leaf_f32_err"] = f32_err[worst["grad_leaf"]]
    worst["grad_widest_tol_leaf"] = max(tol, key=tol.get)
    worst["grad_widest_tol"] = tol[worst["grad_widest_tol_leaf"]]
    worst["grad_over_tol"] = max(grad_errs[k] / tol[k] for k in grad_errs)
    worst["noise_grad"] = noise
    if not (all(grad_errs[k] <= tol[k] for k in grad_errs)
            and noise <= TOL_NOISE):
        fail(f"{phase}: gradients disagree with the CPU: {worst}")


def hold_to_cpu(torch, dev, phase, grads, c_grads, f32_err, model, cpu_model,
                pre_step, worst):
    """The gradients per leaf (``hold_grads``), the
    running stats of ``model`` against ``cpu_model``, and the Adam update
    given the CPU's gradients on both devices from ``pre_step``, the two
    models' parameters before any update; the worst readings go into
    ``worst``."""
    from phc_gnn_torch.train import make_optimizer

    hold_grads(phase, grads, c_grads, f32_err, worst)
    cpu_bufs = dict(cpu_model.named_buffers())
    worst["running_stats"] = max(leafwise(b, cpu_bufs[k])[1]
                                 for k, b in model.named_buffers())
    if not worst["running_stats"] <= TOL_BN:
        fail(f"{phase}: running stats disagree with the CPU: {worst}")

    gpu_model, c_model = pre_step
    before = {k: p.detach().cpu().clone() for k, p in c_model.named_parameters()}
    opt = make_optimizer(dict(gpu_model.named_parameters()), grad_clip=GRAD_CLIP)
    c_opt = make_optimizer(dict(c_model.named_parameters()), grad_clip=GRAD_CLIP)
    opt.step([c_grads[k].to(dev) for k in opt.params], LR)
    c_opt.step([c_grads[k] for k in c_opt.params], LR)
    torch.cuda.synchronize()
    upd = 0.0
    cpu_params = dict(c_model.named_parameters())
    for key, p in gpu_model.named_parameters():
        want = cpu_params[key].detach().double()
        got = p.detach().cpu().double()
        # each side rounds p - lr * u to f32 once: allow 2 ulp of max |p|
        ulp = float(torch.finfo(torch.float32).eps) * float(want.abs().max())
        step = float((want - before[key].double()).abs().max())
        err = float((got - want).abs().max())
        upd = max(upd, max(0.0, err - 2 * ulp) / step if step > 0 else err)
    worst["update"] = upd
    if not upd <= TOL_UPDATE:
        fail(f"{phase}: the Adam update disagrees with the CPU's: {worst}")


def agreement(torch, dev, host_batch, batch, loss_fn, build=None,
              phase="train", weight_decay=WEIGHT_DECAY, f32_out=None):
    """One forward and backward with dropout off on the GPU and on the CPU,
    from the same weights: the loss, the output, the gradients, the running
    stats; then the Adam update given the CPU's gradients on both.  The
    model is ``build(dropout=False)`` (the flagship by default).  The CPU
    run is repeated in float64 with the same ReLU pattern, and each gradient
    leaf may differ by ``COND_GRAD`` times the CPU's own f32 error on it
    where that exceeds ``TOL_GRAD``, up to ``TOL_GRAD_CAP``.

    The CPU run applies the GPU run's ReLU sign pattern (and, for PNA, its
    extreme edges and var signs, ``ReluReplay``).  A ReLU whose input lies
    within rounding of 0 can switch between the devices, and then one row's
    whole contribution to a weight's gradient moves: a difference of the
    inputs, not of the arithmetic under test.  The switches are counted
    over the real rows and printed.  ``f32_out``, a dict, receives the
    CPU's own f32 error of each gradient leaf."""
    from phc_gnn_torch.models import PHCGNN
    from phc_gnn_torch.train import make_loss_and_grads

    model = (build(dropout=False) if build is not None else
             PHCGNN(**flagship_config(dropout=False), seed=0, device=dev))
    randomize_eval_state(torch, model)
    cpu_model = copy.deepcopy(model).to("cpu")
    exact_model = copy.deepcopy(cpu_model).double()
    # the loss-and-gradient pass updates only the running stats, so the
    # models' parameters stay as they were for the update check
    pre_step = (model, cpu_model)
    own_model = copy.deepcopy(cpu_model)
    own = ReluReplay(torch).install(own_model)
    relu = ReluReplay(torch).install(model)
    with relu.patched():
        loss, out, grads = make_loss_and_grads(model, loss_fn, weight_decay)(
            batch, LR)
    torch.cuda.synchronize()
    pattern = relu.recorded()
    c_relu = ReluReplay(torch, pattern).install(cpu_model)
    with c_relu.patched():
        c_loss, c_out, c_grads = make_loss_and_grads(
            cpu_model, loss_fn, weight_decay)(host_batch, LR)
    e_relu = ReluReplay(torch, pattern).install(exact_model)
    with e_relu.patched():
        _, _, e_grads = make_loss_and_grads(exact_model, loss_fn,
                                            weight_decay)(
            host_batch.replace(y=host_batch.y.double()), LR)
    f32_err = exact_errors(c_grads, e_grads)
    if f32_out is not None:
        f32_out.update(f32_err)
    with torch.no_grad(), own.patched():  # the CPU's own patterns
        own_model(host_batch, training=True)
    moved = switches(host_batch, pattern, own.recorded())
    worst = {"relu_switches_on_real_rows": moved["relu"],
             "extreme_edge_switches": moved["hit"],
             "var_sign_switches": moved["var"]}
    _, worst["loss"] = leafwise(loss, c_loss)
    _, worst["out"] = normwise(out.cpu(), c_out)
    if not (worst["loss"] <= TOL_MODEL and worst["out"] <= TOL_MODEL):
        fail(f"{phase}: loss or output disagrees with the CPU: {worst}")
    hold_to_cpu(torch, dev, phase, grads, c_grads, f32_err, model, cpu_model,
                pre_step, worst)
    print(f"{phase}: one step with dropout off, GPU vs CPU: loss rel err "
          f"{worst['loss']:.3e}, output normwise {worst['out']:.3e} "
          f"(tolerance {TOL_MODEL:g}); with the GPU's ReLU pattern "
          f"({worst['relu_switches_on_real_rows']} ReLUs of real rows, "
          f"{worst['extreme_edge_switches']} extreme edges and "
          f"{worst['var_sign_switches']} var signs switch between the "
          f"devices), gradients per leaf <= {worst['grad']:.3e} "
          f"of the leaf's max on {worst['grad_leaf']} (its CPU f32 error "
          f"{worst['grad_leaf_f32_err']:.3e}; {grad_rule(worst)}); the biases "
          f"a norm follows <= "
          f"{worst['noise_grad']:.3e} of the largest gradient (tolerance "
          f"{TOL_NOISE:g}); "
          f"running stats <= {worst['running_stats']:.3e} (tolerance "
          f"{TOL_BN:g}); Adam update given equal gradients <= "
          f"{worst['update']:.3e} "
          f"(tolerance {TOL_UPDATE:g})", flush=True)
    return worst


def train_phase(torch, dev):
    """The flagship train step through the kernels; returns the launch counts
    of the main-path run."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.models import PHCGNN
    from phc_gnn_torch.train import make_optimizer, make_train_step, masked_l1

    host_batch = attach_csr_plan(synthetic_batch(seed=0, **FLAGSHIP))
    batch = host_batch.to(dev)

    def loss_fn(out, b):
        return masked_l1(out, b.y)

    worst = agreement(torch, dev, host_batch, batch, loss_fn)

    model = PHCGNN(**flagship_config(), seed=0, device=dev)
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=GRAD_CLIP)
    step = make_train_step(model, opt, loss_fn, weight_decay=WEIGHT_DECAY,
                           seed=0, device=dev)
    try:
        step(batch.replace(snd_perm=None, snd_rowptr=None), LR)
    except ValueError as exc:
        print(f"train: a CUDA batch without its sender plan raises: {exc}",
              flush=True)
    else:
        fail("a CUDA training batch without its sender plan was trained "
             "without kernel C")

    reset_launches()
    losses = [step(batch, LR)[0] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = read_launches()
    want = {k: TRAIN_LAUNCHES.get(k, 0) * TRAIN_STEPS for k in launches}
    print(f"train: launches over {TRAIN_STEPS} steps {launches} (expected "
          f"{want})", flush=True)
    if launches != want:
        fail(f"the train path launched {launches}, not {want}")
    losses = [float(x) for x in losses]
    print(f"train: losses over {TRAIN_STEPS} steps with dropout "
          f"{[round(x, 5) for x in losses]}", flush=True)
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not all(x == x and abs(x) < float("inf") for x in losses):
        fail("train: non-finite loss")
    if not last < first:
        fail(f"train: the loss did not fall (mean of the first three steps "
             f"{first:.5f}, of the last three {last:.5f})")

    real_edges = host_batch.count_edges()
    train_ms, host_ms = time_steps(torch, lambda: step(batch, LR))
    print(f"train: {train_ms:.3f} ms per step (CUDA events, median of 30 "
          f"after 5 warm-ups; host clock {host_ms:.3f} ms), "
          f"{real_edges / (train_ms / 1e3):.4g} real edges/s "
          f"({real_edges} real edges)", flush=True)
    print(json.dumps({"train": {
        "step_ms": train_ms, "step_host_ms": host_ms,
        "real_edges": real_edges,
        "real_edges_per_s": real_edges / (train_ms / 1e3),
        "losses": losses, "agreement": worst}}), flush=True)
    prof = device_profile(torch, lambda: step(batch, LR), train_ms)
    print(f"profile_train: {prof['kernels_per_call']:g} kernels per step, "
          f"device busy {prof['busy_ms']:.3f} ms of {train_ms:.3f} ms (idle "
          f"{100 * prof['idle_share']:.1f} %); D, E "
          f"{prof['bn_pair_us']['bn_forward']:.2f}, "
          f"{prof['bn_pair_us']['bn_backward']:.2f} us a step", flush=True)
    print(json.dumps({"profile_train": {
        "kernels_per_step": prof["kernels_per_call"],
        "device_busy_ms_per_step": prof["busy_ms"],
        "device_idle_share": prof["idle_share"],
        "bn_pair_us_per_step": prof["bn_pair_us"],
        "top_kernels_us_per_step": prof["top_us"]}}), flush=True)
    return launches


def pcba_model(torch, dev, dropout: bool = True, compute_dtype: str = "f32",
               remat: bool = False):
    """The pcba model from its configuration through ``build_model``, at
    random weights from seed 0; with ``dropout=False`` every rate is 0; in
    ``compute_dtype`` ("f32" or "bf16", the CLI's flag); with ``remat``
    each conv rematerialized (a model argument without a flag, as in JAX:
    ``PHCGNN`` reads it at each forward).  Returns ``(model, loss_fn,
    cfg)``."""
    from phc_gnn_torch.data import ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS
    from phc_gnn_torch.train.config import DATASET_DEFAULTS, ExperimentConfig
    from phc_gnn_torch.train.trainer import build_loss, build_model

    over = dict(PCBA_SCRIPT, compute_dtype=compute_dtype)
    if not dropout:
        over.update(dropout_mpnn=(0.0,) * PCBA_LAYERS, dropout_dn=(0.0, 0.0))
    cfg = ExperimentConfig(**{**DATASET_DEFAULTS["pcba"], **over})
    if (cfg.sc_type, cfg.loss, cfg.target_dim, cfg.grad_clipping) != (
            "first", "bce", PCBA_TASKS, GRAD_CLIP):
        fail(f"the pcba configuration changed: {cfg}")
    model = build_model(cfg, ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS, seed=0,
                        device=dev)
    model.remat = remat
    return model, build_loss(cfg), cfg


def pcba_eval_phase(torch, dev):
    """The pcba eval forward on a 512-graph batch through C's forward role;
    returns the launch counts of the main-path run and the timings."""
    from phc_gnn_torch.train import make_eval_step

    model, _, _ = pcba_model(torch, dev)
    randomize_eval_state(torch, model)
    host = pcba_batch(torch, 0, PCBA_EVAL)
    batch = host.to(dev)
    step = make_eval_step(model, device=dev)
    try:
        step(batch.replace(rowptr=None))
    except ValueError as exc:
        print(f"pcba: a CUDA batch without its CSR plan raises: {exc}",
              flush=True)
    else:
        fail("a CUDA pcba batch without a CSR plan was served without "
             "kernel C")

    reset_launches()
    out = step(batch)
    torch.cuda.synchronize()
    launches = read_launches()
    want = {k: PCBA_EVAL_LAUNCHES.get(k, 0) for k in launches}
    print(f"pcba: launches on the eval path {launches} (expected {want})",
          flush=True)
    if launches != want:
        fail(f"the pcba eval path launched {launches}, not {want}")
    if out.shape != (PCBA_EVAL["batch_size"] + 1, PCBA_TASKS):
        fail(f"pcba eval: output shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        fail("pcba eval: non-finite output")
    ref = make_eval_step(copy.deepcopy(model).to("cpu"), device="cpu")(host)
    abs_err, rel_err = normwise(out.cpu(), ref)
    print(f"pcba: eval vs CPU plain path: max abs err {abs_err:.3e}, normwise "
          f"rel err {rel_err:.3e} (tolerance {TOL_MODEL:g}), max |out| "
          f"{float(ref.abs().max()):.3f}", flush=True)
    if not rel_err <= TOL_MODEL:
        fail("pcba eval: GPU output disagrees with the CPU path")

    real_edges = host.count_edges()
    eval_ms, host_ms = time_steps(torch, lambda: step(batch))
    graph_ms = time_graph(torch, lambda: step(batch), iters=10)
    prof = device_profile(torch, lambda: step(batch), eval_ms, iters=10)
    info = {"eval_ms": eval_ms, "eval_host_ms": host_ms, "eval_graph_ms": graph_ms,
            "eval_real_edges": real_edges,
            "eval_real_edges_per_s": real_edges / (eval_ms / 1e3),
            "eval_vs_cpu": rel_err,
            "eval_kernels_per_forward": prof["kernels_per_call"],
            "eval_device_busy_ms": prof["busy_ms"],
            "eval_device_idle_share": prof["idle_share"],
            "eval_top_kernels_us": prof["top_us"]}
    print(f"pcba: eval {eval_ms:.3f} ms per 512-graph batch (CUDA events, "
          f"median of 30; host clock {host_ms:.3f} ms), "
          f"{info['eval_real_edges_per_s']:.4g} real edges/s ({real_edges} "
          f"real edges), {graph_ms:.3f} ms from one CUDA graph; "
          f"{prof['kernels_per_call']:g} kernels, device busy "
          f"{prof['busy_ms']:.3f} ms (idle {100 * prof['idle_share']:.1f} %)",
          flush=True)
    return launches, info


def pcba_agreement(torch, dev, host_batches, batches):
    """One dropout-free accumulated step (K = 4) on the GPU and on the CPU
    from the same weights and running stats: the loss, the outputs, the
    accumulated gradients (with the GPU's ReLU pattern replayed), the
    running stats, and the Adam update given the CPU's gradients.  Both run
    the step's eager body: the optimizer's spy and the ReLU recorder read
    tensors as they are computed, which a graph's replay does not redo."""
    from phc_gnn_torch.train import make_optimizer
    from phc_gnn_torch.train.state import _eager_accum_train_step

    model, loss_fn, cfg = pcba_model(torch, dev, dropout=False)
    randomize_eval_state(torch, model)
    cpu_model = copy.deepcopy(model).to("cpu")
    exact_model = copy.deepcopy(cpu_model).double()
    pre_step = (copy.deepcopy(model), copy.deepcopy(cpu_model))
    own_model = copy.deepcopy(cpu_model)
    own = ReluReplay(torch).install(own_model)
    relu = ReluReplay(torch).install(model)

    def accumulate(m, bs, device):
        opt = make_optimizer(dict(m.named_parameters()), grad_clip=GRAD_CLIP)
        seen, real_step = {}, opt.step

        def spy(grads, lr):  # the accumulated gradients, before the clip
            seen.update(zip(opt.params, (g.detach().clone() for g in grads)))
            real_step(grads, lr)

        opt.step = spy
        step = _eager_accum_train_step(m, opt, loss_fn, loss_name=cfg.loss,
                                       device=device)
        loss, outs = step(bs, LR)
        return loss, outs, seen

    loss, outs, grads = accumulate(model, batches, dev)
    torch.cuda.synchronize()
    pattern = relu.recorded()
    masks = pattern["relu"]
    ReluReplay(torch, pattern).install(cpu_model)
    c_loss, c_outs, c_grads = accumulate(cpu_model, host_batches, "cpu")
    ReluReplay(torch, pattern).install(exact_model)
    _, _, e_grads = accumulate(exact_model, [hb.replace(y=hb.y.double())
                                             for hb in host_batches], "cpu")
    f32_err = exact_errors(c_grads, e_grads)
    with torch.no_grad():  # the CPU's own sign pattern, to count switches
        for hb in host_batches:
            own_model(hb, training=True)
    worst = {"relu_switches": sum(int((a != b).sum())
                                  for a, b in zip(masks, own.masks))}
    _, worst["loss"] = leafwise(loss, c_loss)
    _, worst["outs"] = normwise(outs.cpu(), c_outs)
    if not (bool(torch.isfinite(loss)) and worst["loss"] <= TOL_MODEL
            and worst["outs"] <= TOL_MODEL):
        fail(f"pcba train: loss or outputs disagree with the CPU: {worst}")
    hold_to_cpu(torch, dev, "pcba train", grads, c_grads, f32_err, model,
                cpu_model, pre_step, worst)
    print(f"pcba: one accumulated step (K = {len(batches)}) with dropout off, "
          f"GPU vs CPU: loss rel err {worst['loss']:.3e}, outputs normwise "
          f"{worst['outs']:.3e} (tolerance {TOL_MODEL:g}); with the GPU's "
          f"ReLU pattern ({worst['relu_switches']} ReLUs switch between the "
          f"devices), accumulated gradients per leaf <= {worst['grad']:.3e} "
          f"of the leaf's max on {worst['grad_leaf']} (its CPU f32 error "
          f"{worst['grad_leaf_f32_err']:.3e}; {grad_rule(worst)}); the biases "
          f"a norm follows <= "
          f"{worst['noise_grad']:.3e} of the largest gradient (tolerance "
          f"{TOL_NOISE:g}); running stats <= {worst['running_stats']:.3e} "
          f"(tolerance {TOL_BN:g}); Adam update given equal gradients <= "
          f"{worst['update']:.3e} (tolerance {TOL_UPDATE:g})", flush=True)
    return worst


def pcba_train_phase(torch, dev):
    """The pcba accumulated train step's eager body through the kernels
    (on the card ``make_accum_train_step`` replays a CUDA graph of it, whose
    kernels the wrappers' counters do not see: ``pcba_graph_phase``);
    returns the launch counts of the main-path run and the timings."""
    from phc_gnn_torch.train import make_optimizer
    from phc_gnn_torch.train.state import _eager_accum_train_step

    host = [pcba_batch(torch, s, PCBA) for s in range(PCBA_K)]
    batches = [b.to(dev) for b in host]
    worst = pcba_agreement(torch, dev, host, batches)

    model, loss_fn, cfg = pcba_model(torch, dev)
    opt = make_optimizer(dict(model.named_parameters()),
                         grad_clip=cfg.grad_clipping)
    step = _eager_accum_train_step(model, opt, loss_fn,
                                   weight_decay=cfg.weightdecay,
                                   loss_name=cfg.loss, seed=0, device=dev)
    reset_launches()
    losses = [step(batches, cfg.lr)[0] for _ in range(PCBA_STEPS)]
    torch.cuda.synchronize()
    launches = read_launches()
    want = {k: PCBA_LAUNCHES.get(k, 0) * PCBA_STEPS for k in launches}
    print(f"pcba: launches over {PCBA_STEPS} accumulated steps {launches} "
          f"(expected {want})", flush=True)
    if launches != want:
        fail(f"the pcba train path launched {launches}, not {want}")
    losses = [float(x) for x in losses]
    print(f"pcba: losses over {PCBA_STEPS} accumulated steps with dropout "
          f"{[round(x, 5) for x in losses]}", flush=True)
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not all(x == x and abs(x) < float("inf") for x in losses):
        fail("pcba train: non-finite loss")
    if not last < first:
        fail(f"pcba train: the loss did not fall (mean of the first three "
             f"steps {first:.5f}, of the last three {last:.5f})")

    real_edges = sum(b.count_edges() for b in host)
    step_ms, host_ms = time_steps(torch, lambda: step(batches, cfg.lr))
    prof = device_profile(torch, lambda: step(batches, cfg.lr), step_ms)
    info = {"step_ms": step_ms, "step_host_ms": host_ms,
            "real_edges_per_step": real_edges,
            "real_edges_per_s": real_edges / (step_ms / 1e3),
            "losses": losses, "agreement": worst,
            "kernels_per_step": prof["kernels_per_call"],
            "device_busy_ms_per_step": prof["busy_ms"],
            "device_idle_share": prof["idle_share"],
            "top_kernels_us_per_step": prof["top_us"]}
    print(f"pcba: {step_ms:.3f} ms per accumulated step of {PCBA_K} x 128 "
          f"graphs (CUDA events, median of 30 after 5 warm-ups; host clock "
          f"{host_ms:.3f} ms), {info['real_edges_per_s']:.4g} real edges/s "
          f"({real_edges} real edges); {prof['kernels_per_call']:g} kernels "
          f"per step, device busy {prof['busy_ms']:.3f} ms (idle "
          f"{100 * prof['idle_share']:.1f} %)", flush=True)
    return launches, info


def pcba_dummy(torch, seed: int):
    """A host pcba sub-batch fully masked (no real node, edge or graph, no
    label), as the JAX trainer pads the last group of K
    (phc_gnn_tpu/train/state.py:123), with its CSR plans."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan

    b = synthetic_batch(seed=seed, **PCBA)
    return attach_csr_plan(b.replace(
        node_mask=torch.zeros_like(b.node_mask),
        edge_mask=torch.zeros_like(b.edge_mask),
        graph_mask=torch.zeros_like(b.graph_mask),
        y=torch.full_like(b.y, float("nan"))))


def pcba_accum_pair(torch, dev, dropout: bool):
    """Two copies of the pcba model at random running stats, the first
    behind ``make_accum_train_step`` (one CUDA graph on the card), the
    second behind its eager body, each with its own optimizer, generator
    seed 0 both.  Returns the two ``(model, optimizer, step)`` and the
    configuration."""
    from phc_gnn_torch.train import make_accum_train_step, make_optimizer
    from phc_gnn_torch.train.state import _eager_accum_train_step

    model, loss_fn, cfg = pcba_model(torch, dev, dropout)
    randomize_eval_state(torch, model)
    out = []
    for m, make in ((model, make_accum_train_step),
                    (copy.deepcopy(model), _eager_accum_train_step)):
        opt = make_optimizer(dict(m.named_parameters()),
                             grad_clip=cfg.grad_clipping)
        out.append((m, opt, make(m, opt, loss_fn,
                                 weight_decay=cfg.weightdecay,
                                 loss_name=cfg.loss, seed=0, device=dev)))
    return out, cfg


def pcba_graph_check(torch, dev, what, batches, dropout, lrs):
    """``make_accum_train_step``'s graph against its eager body from the
    same weights and generator seed, under ``deterministic``: one call at
    each lr of ``lrs`` on both; the losses and outputs of every call, and
    every parameter, running stat and Adam tensor after them, bit-equal
    expected (the same kernels in the same order)."""
    with deterministic(torch):
        ((model, opt, graphed), (e_model, e_opt, eager)), _ = \
            pcba_accum_pair(torch, dev, dropout)
        got = [graphed(batches, lr) for lr in lrs]
        want = [eager(batches, lr) for lr in lrs]
        torch.cuda.synchronize()
    losses = torch.stack([g[0] for g in got]).cpu()
    e_losses = torch.stack([w[0] for w in want]).cpu()
    outs = torch.stack([g[1] for g in got]).cpu()
    e_outs = torch.stack([w[1] for w in want]).cpu()
    info = {"calls": len(lrs), "lrs": list(lrs),
            "losses": [float(x) for x in losses],
            "loss_err": normwise(losses, e_losses)[1],
            "loss_bit_equal": torch_equal(losses, e_losses),
            "out_err": normwise(outs, e_outs)[1],
            "out_bit_equal": torch_equal(outs, e_outs),
            "optimizer_count": [opt.count, e_opt.count],
            "state": state_diff(train_state(model, opt),
                                train_state(e_model, e_opt))}
    phase = f"pcba graph, {what}"
    if not bool(torch.isfinite(losses).all()):
        fail(f"{phase}: non-finite loss {info['losses']}")
    if opt.count != e_opt.count or opt.count != len(lrs):
        fail(f"{phase}: the optimizer's count {opt.count} after the graphed "
             f"calls, {e_opt.count} after the eager ones")
    st = info["state"]
    hold_scan(phase, info["loss_err"], TOL_SCAN,
              f"losses normwise over {len(lrs)} calls at lr {list(lrs)} "
              f"(bit-equal: {info['loss_bit_equal']})")
    hold_scan(phase, info["out_err"], TOL_SCAN,
              f"outputs [K, G, T] normwise (bit-equal: "
              f"{info['out_bit_equal']})")
    hold_scan(phase, st["max_rel_err"], TOL_SCAN_STATE,
              f"parameters, running stats and Adam state per tensor "
              f"({st['bit_equal']} of {st['tensors']} bit-equal)")
    return info


def pcba_atomics_check(torch, dev, batches):
    """One graphed accumulated step (dropout on) against one call of the
    eager body from the same weights and generator seed, outside
    ``deterministic`` (the pooling's ``index_add_`` adds in the order its
    atomics land): the loss and the outputs within ``TOL_SCAN_ATOMICS``;
    beside it, two eager calls from those weights against each other."""
    from phc_gnn_torch.train.state import _eager_accum_train_step

    from phc_gnn_torch.train.trainer import build_loss

    ((_, _, graphed), (e_model, e_opt, eager)), cfg = pcba_accum_pair(
        torch, dev, True)
    x_model, x_opt = copy.deepcopy((e_model, e_opt))
    control = _eager_accum_train_step(
        x_model, x_opt, build_loss(cfg), weight_decay=cfg.weightdecay,
        loss_name=cfg.loss, seed=0, device=dev)
    loss, outs = graphed(batches, cfg.lr)
    e_loss, e_outs = eager(batches, cfg.lr)
    x_loss, x_outs = control(batches, cfg.lr)
    torch.cuda.synchronize()
    info = {"loss_err": normwise(loss.cpu(), e_loss.cpu())[1],
            "out_err": normwise(outs.cpu(), e_outs.cpu())[1],
            "eager_vs_eager_loss_err": normwise(x_loss.cpu(),
                                                e_loss.cpu())[1],
            "eager_vs_eager_out_err": normwise(x_outs.cpu(),
                                               e_outs.cpu())[1]}
    print(f"pcba graph, no deterministic algorithms, dropout on: two eager "
          f"calls part by {info['eager_vs_eager_loss_err']:.3e} in the loss "
          f"and {info['eager_vs_eager_out_err']:.3e} normwise in the outputs "
          f"(the pooling's atomics)", flush=True)
    hold_scan("pcba graph", info["loss_err"], TOL_SCAN_ATOMICS,
              "one non-deterministic graphed step's loss, relative")
    hold_scan("pcba graph", info["out_err"], TOL_SCAN_ATOMICS,
              "one non-deterministic graphed step's outputs normwise")
    return info


def kernels_by_grid(torch, fn, iters: int) -> dict:
    """CUDA kernels of ``iters`` calls of ``fn`` by (name, grid's x), read
    from the profiler's trace (its kernel events carry the launch's
    grid)."""
    import os
    import tempfile

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    counts: dict = {}
    for ev in events:
        if ev.get("cat") != "kernel":
            continue
        grid = ev.get("args", {}).get("grid")
        key = (ev.get("name", ""), grid[0] if grid else None)
        counts[key] = counts.get(key, 0) + 1
    if not counts:
        fail("the profiler's trace holds no kernel event")
    return counts


def pcba_replay_kernels(torch, fn) -> dict:
    """The port's kernels a replay of the pcba graph, counted by name in
    the profiler's trace, F and G told from D and E (the same kernels) by
    their grid: ``bn_plan`` at the convs' [4096, 512].  Held to
    ``PCBA_LAUNCHES``; a count below it is profiled again (the profiler
    can lose an event), one above it fails at once."""
    from phc_gnn_torch.ops.fused_bn import bn_plan

    rows, feats = PCBA["num_nodes"], PCBA_DIM
    blocked = {"bn_forward": bn_plan(rows, feats, 1).grid,
               "bn_backward": bn_plan(rows, feats, 2).grid}
    want = dict(PCBA_LAUNCHES)
    for _ in range(3):
        counts = kernels_by_grid(torch, fn, PCBA_REPLAYS)
        got = {k: 0.0 for k in want}
        for (name, grid), n in counts.items():
            for wrapper in KERNEL_NAMES:
                if not kernel_of(wrapper, name):
                    continue
                if wrapper in blocked and grid == blocked[wrapper]:
                    wrapper += "_blocked"
                got[wrapper] = got.get(wrapper, 0.0) + n / PCBA_REPLAYS
        over = {k: v for k, v in got.items() if v > want.get(k, 0)}
        if over:
            fail(f"pcba graph: a replay ran {over}, more than {want}")
        if got == want:
            break
        print(f"pcba graph: a replay read {got}, below {want}: an event "
              f"lost; profiled again", flush=True)
    else:
        fail(f"pcba graph: a replay ran {got}, not {want}")
    print(f"pcba graph: the port's kernels a replay, by name and grid (F and "
          f"G on grids of {blocked['bn_forward']} and "
          f"{blocked['bn_backward']} CTAs): {got}", flush=True)
    return got


def pcba_graph_phase(torch, dev):
    """``make_accum_train_step`` as one CUDA graph (module docstring, phase
    7); returns the wrappers' counts of its first call (the warm-ups and
    the capture; a replay is counted by name in the profile) and the
    readings."""
    from phc_gnn_torch.train.state import WARMUP_CALLS

    host = [pcba_batch(torch, s, PCBA) for s in range(PCBA_K)]
    batches = [b.to(dev) for b in host]
    ((_, _, graphed), (_, _, eager)), cfg = pcba_accum_pair(torch, dev, True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eager(batches, cfg.lr)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, outs = graphed(batches, cfg.lr)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = read_launches()
    graph_peak = torch.cuda.max_memory_allocated(dev)
    want = {k: PCBA_LAUNCHES.get(k, 0) * (WARMUP_CALLS + 1)
            for k in launches}
    print(f"pcba graph: the first call of make_accum_train_step ({WARMUP_CALLS}"
          f" eager warm-ups, the capture, one replay) ran under "
          f"set_sync_debug_mode('error'); the wrappers' counters over it "
          f"{launches} (expected {want}); loss {float(loss):.5f}", flush=True)
    if launches != want:
        fail(f"the pcba graph's first call launched {launches}, not {want}")
    if outs.shape != (PCBA_K, PCBA["batch_size"] + 1, PCBA_TASKS):
        fail(f"pcba graph: outputs of shape {tuple(outs.shape)}")
    if not (bool(torch.isfinite(loss)) and bool(torch.isfinite(outs).all())):
        fail("pcba graph: non-finite loss or outputs")

    def call():
        return graphed(batches, cfg.lr)

    info = {"replay_kernels": pcba_replay_kernels(torch, call)}
    # the eager body's time and profile are pcba_train_phase's
    step_ms, host_ms = time_steps(torch, call)
    prof = device_profile(torch, call, step_ms, iters=20)
    real_edges = sum(b.count_edges() for b in host)
    info.update(
        step_ms=step_ms, step_host_ms=host_ms,
        real_edges_per_step=real_edges,
        real_edges_per_s=real_edges / (step_ms / 1e3),
        kernels_per_step=prof["kernels_per_call"],
        device_busy_ms_per_step=prof["busy_ms"],
        device_idle_share=prof["idle_share"],
        top_kernels_us_per_step=prof["top_us"],
        peak_mem_bytes={"graph_first_call": graph_peak,
                        "eager_step": eager_peak},
        reserved_bytes=torch.cuda.memory_reserved(dev))
    print(f"pcba graph: {step_ms:.3f} ms per accumulated step of {PCBA_K} x "
          f"128 graphs from one CUDA graph (CUDA events, median of 30 after "
          f"5; host clock {host_ms:.3f} ms), {info['real_edges_per_s']:.4g} "
          f"real edges/s; {prof['kernels_per_call']:g} kernels per step, "
          f"device busy {prof['busy_ms']:.3f} ms (idle "
          f"{100 * prof['idle_share']:.1f} %); peak device memory "
          f"(max_memory_allocated) {graph_peak / 2**30:.3f} GiB over the "
          f"first call (warm-ups, capture, replay), "
          f"{eager_peak / 2**30:.3f} GiB over one eager step", flush=True)

    info["deterministic"] = pcba_graph_check(
        torch, dev, "dropout off", batches, False,
        (LR,) * PCBA_GRAPH_STEPS + (LR / 2,))
    info["dropout"] = pcba_graph_check(
        torch, dev, "dropout on", batches, True, (LR,) * PCBA_GRAPH_STEPS)
    masked = [batches[0], pcba_dummy(torch, 1).to(dev)] + batches[2:]
    info["masked_sub_batch"] = pcba_graph_check(
        torch, dev, "a fully masked sub-batch, dropout on", masked, True,
        (LR,) * 2)
    info["atomics"] = pcba_atomics_check(torch, dev, batches)
    return launches, info


def quat_model(torch, dev, family: str = "add", dropout: bool = True):
    """scripts/bench_presets.py's ``build(family, "q-batch-norm")`` through
    the port's preset (``QuaternionSkipConnectAdd`` or ``...Concat``: the
    frozen quaternion rule) at random weights from seed 0: the flagship's
    widths and head, whitening at the 8 conv sites, ``sc_type`` "last" (add)
    or "first" (concat, whose convs take 200/400/400/400 features)."""
    from phc_gnn_torch.models import presets

    cfg = flagship_config(dropout)
    del cfg["phm_dim"]
    cfg.update(norm_mp="q-batch-norm", norm_dn="naive-batch-norm",
               sc_type="last" if family == "add" else "first")
    cls = (presets.QuaternionSkipConnectAdd if family == "add"
           else presets.QuaternionSkipConnectConcat)
    return cls(**cfg, seed=0, device=dev)


def eval_vs_cpu(torch, dev, model, host_batches, phase, want_per_batch):
    """The eval forward of ``model`` through the kernels on ``host_batches``:
    the launch counts of the run (``want_per_batch`` each), the outputs
    against the CPU path.  Returns the launches and the step."""
    from phc_gnn_torch.train import make_eval_step

    batches = [b.to(dev) for b in host_batches]
    step = make_eval_step(model, device=dev)
    reset_launches()
    outs = [step(b) for b in batches]
    torch.cuda.synchronize()
    launches = read_launches()
    want = {k: want_per_batch.get(k, 0) * len(batches) for k in launches}
    print(f"{phase}: launches on the eval path over {len(batches)} batches "
          f"{launches} (expected {want})", flush=True)
    if launches != want:
        fail(f"the {phase} eval path launched {launches}, not {want}")
    cpu_step = make_eval_step(copy.deepcopy(model).to("cpu"), device="cpu")
    for i, (out, hb) in enumerate(zip(outs, host_batches)):
        if out.shape != (FLAGSHIP["batch_size"] + 1, 1):
            fail(f"{phase} batch {i}: output shape {tuple(out.shape)}")
        if not torch.isfinite(out).all():
            fail(f"{phase} batch {i}: non-finite output")
        abs_err, rel_err = normwise(out.cpu(), cpu_step(hb))
        print(f"{phase}: batch {i} vs CPU plain path: max abs err "
              f"{abs_err:.3e}, normwise rel err {rel_err:.3e} (tolerance "
              f"{TOL_MODEL:g})", flush=True)
        if not rel_err <= TOL_MODEL:
            fail(f"{phase} batch {i}: GPU output disagrees with the CPU path")
    return launches, step, batches


def graph_replay(torch, fn):
    """The output of ``fn`` captured in a CUDA graph and replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


def quat_eval_phase(torch, dev):
    """The quaternion add preset's eval forward on 3 batches, its launches,
    eval ms, a CUDA-graph replay against the eager output, and a profile;
    returns the launch counts of the main-path run and the timings."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan

    model = quat_model(torch, dev)
    randomize_eval_state(torch, model)
    host = [attach_csr_plan(synthetic_batch(seed=s, **FLAGSHIP))
            for s in range(N_BATCHES)]
    launches, step, batches = eval_vs_cpu(torch, dev, model, host, "quat",
                                          QUAT_EVAL_LAUNCHES)
    return launches, replay_and_time(torch, "quat", step, batches[0],
                                     host[0].count_edges())


def replay_and_time(torch, phase, step, b0, real_edges):
    """A CUDA graph of the eval forward ``step(b0)`` replayed against the
    eager output, then eval ms, ms from one CUDA graph and a profile."""
    eager = step(b0)
    replay_err = normwise(graph_replay(torch, lambda: step(b0)).cpu(),
                          eager.cpu())[1]
    print(f"{phase}: a CUDA graph of the eval forward replays to normwise "
          f"{replay_err:.3e} of the eager output (tolerance {TOL_REPLAY:g})",
          flush=True)
    if not replay_err <= TOL_REPLAY:
        fail(f"{phase}: the CUDA graph replay differs from the eager forward")
    eval_ms, host_ms = time_steps(torch, lambda: step(b0))
    graph_ms = time_graph(torch, lambda: step(b0), iters=20)
    prof = device_profile(torch, lambda: step(b0), eval_ms, iters=20)
    info = {"eval_ms": eval_ms, "eval_host_ms": host_ms,
            "eval_graph_ms": graph_ms, "eval_real_edges": real_edges,
            "eval_real_edges_per_s": real_edges / (eval_ms / 1e3),
            "eval_replay_err": replay_err,
            "eval_kernels_per_forward": prof["kernels_per_call"],
            "eval_device_busy_ms": prof["busy_ms"],
            "eval_device_idle_share": prof["idle_share"],
            "eval_top_kernels_us": prof["top_us"]}
    print(f"{phase}: eval {eval_ms:.3f} ms per batch (CUDA events, median of "
          f"30; host clock {host_ms:.3f} ms), "
          f"{info['eval_real_edges_per_s']:.4g} real edges/s, {graph_ms:.3f} "
          f"ms from one CUDA graph; {prof['kernels_per_call']:g} kernels, "
          f"device busy {prof['busy_ms']:.3f} ms (idle "
          f"{100 * prof['idle_share']:.1f} %)", flush=True)
    return info


def quat_train_phase(torch, dev):
    """The quaternion add preset's train step: one dropout-free step against
    the CPU, ten steps with dropout (launches, the loss falls), step ms and a
    profile; returns the launch counts of the main-path run and the
    timings."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.train import make_optimizer, make_train_step, masked_l1

    host_batch = attach_csr_plan(synthetic_batch(seed=0, **FLAGSHIP))
    batch = host_batch.to(dev)

    def loss_fn(out, b):
        return masked_l1(out, b.y)

    worst = agreement(torch, dev, host_batch, batch, loss_fn,
                      build=lambda dropout: quat_model(torch, dev,
                                                       dropout=dropout),
                      phase="quat train")
    model = quat_model(torch, dev)
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=GRAD_CLIP)
    step = make_train_step(model, opt, loss_fn, weight_decay=WEIGHT_DECAY,
                           seed=0, device=dev)
    return train_and_time(torch, "quat train", lambda: step(batch, LR),
                          QUAT_TRAIN_LAUNCHES, QUAT_STEPS,
                          host_batch.count_edges(), worst)


def train_and_time(torch, phase, step, per_step, n_steps, real_edges, worst):
    """``n_steps`` calls of ``step()`` with the counters zeroed just before
    and read just after (``per_step`` launches each), the loss finite and
    falling, then step ms over 30 steps after 5 warm-ups and a profile;
    returns the launch counts and the timings."""
    reset_launches()
    losses = [step()[0] for _ in range(n_steps)]
    torch.cuda.synchronize()
    launches = read_launches()
    want = {k: per_step.get(k, 0) * n_steps for k in launches}
    print(f"{phase}: launches over {n_steps} steps {launches} (expected "
          f"{want})", flush=True)
    if launches != want:
        fail(f"the {phase} path launched {launches}, not {want}")
    losses = [float(x) for x in losses]
    print(f"{phase}: losses over {n_steps} steps with dropout "
          f"{[round(x, 5) for x in losses]}", flush=True)
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not all(x == x and abs(x) < float("inf") for x in losses):
        fail(f"{phase}: non-finite loss")
    if not last < first:
        fail(f"{phase}: the loss did not fall (mean of the first three "
             f"steps {first:.5f}, of the last three {last:.5f})")
    step_ms, host_ms = time_steps(torch, step)
    prof = device_profile(torch, step, step_ms)
    info = {"step_ms": step_ms, "step_host_ms": host_ms,
            "real_edges_per_s": real_edges / (step_ms / 1e3),
            "losses": losses, "agreement": worst,
            "kernels_per_step": prof["kernels_per_call"],
            "device_busy_ms_per_step": prof["busy_ms"],
            "device_idle_share": prof["idle_share"],
            "bn_pair_us_per_step": prof["bn_pair_us"],
            "top_kernels_us_per_step": prof["top_us"]}
    print(f"{phase}: {step_ms:.3f} ms per step (CUDA events, median of 30 "
          f"after 5 warm-ups; host clock {host_ms:.3f} ms), "
          f"{info['real_edges_per_s']:.4g} real edges/s ({real_edges} real "
          f"edges); {prof['kernels_per_call']:g} kernels per step, device "
          f"busy {prof['busy_ms']:.3f} ms (idle "
          f"{100 * prof['idle_share']:.1f} %); D, E "
          f"{prof['bn_pair_us']['bn_forward']:.2f}, "
          f"{prof['bn_pair_us']['bn_backward']:.2f} us a step", flush=True)
    return launches, info


def quat_concat_phase(torch, dev):
    """The quaternion concat preset: its eval forward on one batch against
    the CPU (the launch counts of that run are returned) and one
    dropout-free step against the CPU."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.train import masked_l1

    host = attach_csr_plan(synthetic_batch(seed=0, **FLAGSHIP))
    model = quat_model(torch, dev, "concat")
    randomize_eval_state(torch, model)
    launches, _, _ = eval_vs_cpu(torch, dev, model, [host], "concat",
                                 QUAT_EVAL_LAUNCHES)
    worst = agreement(torch, dev, host, host.to(dev),
                      lambda out, b: masked_l1(out, b.y),
                      build=lambda dropout: quat_model(torch, dev, "concat",
                                                       dropout=dropout),
                      phase="concat train")
    return launches, {"agreement": worst}


def quat_eval_grad_phase(torch, dev, attribution: bool = False):
    """The eval whitening's backward: the L1 loss of the quaternion add
    preset's eval forward (running stats fixed, as in fine-tuning or input
    attribution) differentiated in every parameter on one batch, on the card
    and on the CPU from the same weights (the GPU's ReLU pattern replayed,
    the CPU run repeated in float64).  With ``attribution``, in the input
    encoders' embedding tables alone, every other parameter frozen: the
    whitening sites then need dx and neither dGamma nor dbeta.  Returns the
    launch counts of the run on the card and the agreement."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.train import masked_l1

    host = attach_csr_plan(synthetic_batch(seed=1, **FLAGSHIP))
    model = quat_model(torch, dev, dropout=False).eval()
    randomize_eval_state(torch, model)
    if attribution:
        for key, p in model.named_parameters():
            p.requires_grad_(key.startswith(("atomencoder.", "bondencoder_")))
    phase = "quat eval attribution" if attribution else "quat eval grad"
    cpu_model = copy.deepcopy(model).to("cpu")
    exact_model = copy.deepcopy(cpu_model).double()

    def grads_of(m, batch):
        params = {k: p for k, p in m.named_parameters() if p.requires_grad}
        loss = masked_l1(m(batch, training=False), batch.y)
        return dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))

    relu = ReluReplay(torch).install(model)
    reset_launches()
    grads = grads_of(model, host.to(dev))
    torch.cuda.synchronize()
    launches = read_launches()
    want = {k: (QUAT_EVAL_ATTR_LAUNCHES if attribution
                else QUAT_EVAL_GRAD_LAUNCHES).get(k, 0) for k in launches}
    print(f"{phase}: {len(grads)} leaves; launches {launches} (expected "
          f"{want})", flush=True)
    if launches != want:
        fail(f"the eval whitening's backward ({phase}) launched {launches}, "
             f"not {want}")
    pattern = relu.recorded()
    ReluReplay(torch, pattern).install(cpu_model)
    c_grads = grads_of(cpu_model, host)
    ReluReplay(torch, pattern).install(exact_model)
    e_grads = grads_of(exact_model, host.replace(y=host.y.double()))
    worst = {}
    hold_grads(phase, grads, c_grads, exact_errors(c_grads, e_grads), worst,
               shift_noise=False)
    print(f"{phase}: the eval forward's gradients, GPU vs CPU with the "
          f"GPU's ReLU pattern: per leaf <= {worst['grad']:.3e} of the leaf's "
          f"max on {worst['grad_leaf']} (its CPU f32 error "
          f"{worst['grad_leaf_f32_err']:.3e}; {grad_rule(worst)})", flush=True)
    return launches, worst


def pna_model(torch, dev, dropout: bool = True):
    """The ZINC PHC-4 recipe with ``--aggr_msg pna`` from its configuration
    through ``build_model``, at random weights from seed 0, its ``avg_deg``
    from the port's ``degree_histogram`` over the 128 graphs of the
    flagship batch; with ``dropout=False`` every rate is 0.  Returns
    ``(model, loss_fn, cfg)``."""
    from phc_gnn_torch.data import (ZINC_ATOM_DIMS, ZINC_BOND_DIMS,
                                    avg_deg_from_histogram, degree_histogram,
                                    synthetic_graphs)
    from phc_gnn_torch.train.config import DATASET_DEFAULTS, ExperimentConfig
    from phc_gnn_torch.train.trainer import build_loss, build_model

    over = dict(PNA_SCRIPT)
    if not dropout:
        over.update(dropout_dn=(0.0, 0.0))
    cfg = ExperimentConfig(**{**DATASET_DEFAULTS["zinc"], **over})
    if (cfg.loss, cfg.grad_clipping, cfg.norm_mp, cfg.pooling) != (
            "l1", GRAD_CLIP, "naive-batch-norm", "softattention"):
        fail(f"the PNA configuration changed: {cfg}")
    avg_deg = avg_deg_from_histogram(degree_histogram(synthetic_graphs(
        FLAGSHIP["batch_size"], seed=0)))
    model = build_model(cfg, ZINC_ATOM_DIMS, ZINC_BOND_DIMS, avg_deg=avg_deg,
                        seed=0, device=dev)
    return model, build_loss(cfg), cfg


def pna_eval_phase(torch, dev):
    """The PNA eval forward on 3 flagship batches through C's forward role,
    H and I: its launches, the outputs against the CPU path, a CUDA-graph
    replay against the eager output, eval ms and a profile; returns the
    launch counts of the main-path run and the timings."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan

    model, _, _ = pna_model(torch, dev)
    randomize_eval_state(torch, model)
    host = [attach_csr_plan(synthetic_batch(seed=s, **FLAGSHIP))
            for s in range(N_BATCHES)]
    launches, step, batches = eval_vs_cpu(torch, dev, model, host, "pna",
                                          PNA_EVAL_LAUNCHES)
    b0 = batches[0]
    try:
        step(b0.replace(rowptr=None))
    except ValueError as exc:
        print(f"pna: a CUDA batch without its CSR plan raises: {exc}",
              flush=True)
    else:
        fail("a CUDA PNA batch without a CSR plan was served without the "
             "kernels")
    return launches, replay_and_time(torch, "pna", step, b0,
                                     host[0].count_edges())


def pna_train_phase(torch, dev):
    """The PNA train step: one dropout-free step against the CPU (the GPU's
    ReLU, extreme-edge and var-sign patterns replayed), ten steps with the
    recipe's dropout (launches, the loss falls), step ms over 30 steps after
    5 warm-ups and a profile; returns the launch counts of the main-path run
    and the timings."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.train import make_optimizer, make_train_step

    host_batch = attach_csr_plan(synthetic_batch(seed=0, **FLAGSHIP))
    batch = host_batch.to(dev)
    model, loss_fn, cfg = pna_model(torch, dev)
    worst = agreement(torch, dev, host_batch, batch, loss_fn,
                      build=lambda dropout: pna_model(torch, dev, dropout)[0],
                      phase="pna train", weight_decay=cfg.weightdecay)
    opt = make_optimizer(dict(model.named_parameters()),
                         grad_clip=cfg.grad_clipping)
    step = make_train_step(model, opt, loss_fn, weight_decay=cfg.weightdecay,
                           seed=0, device=dev)
    return train_and_time(torch, "pna train", lambda: step(batch, cfg.lr),
                          PNA_TRAIN_LAUNCHES, PNA_STEPS,
                          host_batch.count_edges(), worst)


# device kernel names of each wrapper's kernel, for counting the kernels a
# replayed CUDA graph runs (the wrappers' counters do not see a replay)
# (read with the spaces taken out of the demangled names: A, B and C are
# templates on the rows' element type; a wrapper whose instances are kernels
# of other names has a tuple, C on bf16 rows its bulk instance)
KERNEL_NAMES = {"segment_logit_max": "segment_logit_max_kernel<float",
                "segment_softmax_aggregate":
                    "segment_softmax_aggregate_kernel<float",
                "segment_softmax_fused": "segment_softmax_fused_kernel<float",
                "segment_softmax_backward":
                    "segment_softmax_backward_kernel<float",
                "segment_sum_perm": "segment_sum_kernel<float,true",
                "segment_sum_masked": "segment_sum_kernel<float,false",
                "segment_logit_max_bf16":
                    "segment_logit_max_kernel<__nv_bfloat16",
                "segment_softmax_aggregate_bf16":
                    "segment_softmax_aggregate_kernel<__nv_bfloat16",
                "segment_softmax_fused_bf16":
                    "segment_softmax_fused_kernel<__nv_bfloat16",
                "segment_softmax_backward_bf16":
                    "segment_softmax_backward_kernel<__nv_bfloat16",
                "segment_sum_perm_bf16": (
                    "segment_sum_kernel<__nv_bfloat16,true",
                    "segment_sum_bulk_kernel<true"),
                "segment_sum_masked_bf16": (
                    "segment_sum_kernel<__nv_bfloat16,false",
                    "segment_sum_bulk_kernel<false"),
                "bn_forward": "bn_forward_kernel",
                "bn_backward": "bn_backward_kernel",
                "wbn_stats": "wbn_stats_kernel",
                "wbn_transform": "wbn_transform_kernel",
                "wbn_bwd_sums": "wbn_bwd_sums_kernel",
                "wbn_dx": "wbn_dx_kernel",
                "segment_extreme": "segment_extreme_kernel",
                "segment_moments": "segment_moments_kernel"}
# what the embedding lookups' backward ran (before the one-hot encoder),
# in kernel names read in lower case
EMBEDDING_BWD_NAMES = ("embedding", "sort")


def kernel_of(wrapper: str, name: str) -> bool:
    """Whether the device kernel ``name`` is one of ``wrapper``'s
    (``KERNEL_NAMES``)."""
    subs = KERNEL_NAMES[wrapper]
    name = name.replace(" ", "")
    return any(sub in name for sub in
               ((subs,) if isinstance(subs, str) else subs))


def kernel_families(counts: dict, per: int) -> dict:
    """Kernels of each port wrapper in a profile's ``counts``, per call of
    ``per`` steps."""
    return {w: sum(n for name, n in counts.items() if kernel_of(w, name))
            / per for w in KERNEL_NAMES}


def train_state(model, opt) -> dict:
    """Every parameter, buffer and Adam state tensor of a model and its
    optimizer, keyed by name, as CPU copies."""
    state = {f"param {k}": p.detach() for k, p in model.named_parameters()}
    state.update({f"buffer {k}": b for k, b in model.named_buffers()})
    for k, p in opt.params.items():
        for name, t in opt.adam.state[p].items():
            state[f"adam {name} {k}"] = t
    return {k: t.detach().cpu().clone() for k, t in state.items()}


def state_diff(a: dict, b: dict) -> dict:
    """The readings of two ``train_state``s: how many tensors are bit-equal,
    and the largest difference relative to a tensor's own size."""
    equal, worst, worst_key = 0, 0.0, None
    for k, t in a.items():
        if torch_equal(t, b[k]):
            equal += 1
            continue
        err = leafwise(t, b[k])[1]
        if err > worst:
            worst, worst_key = err, k
    return {"bit_equal": equal, "tensors": len(a), "max_rel_err": worst,
            "max_rel_err_at": worst_key}


def torch_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def hold_scan(phase, got, tol, what):
    """A reading ``got`` of graphed steps against eager ones (a normwise or
    per-tensor error), printed with its tolerance; fails above it."""
    print(f"{phase}: {what}: {got} (tolerance {tol:g})", flush=True)
    if not got <= tol:
        fail(f"{phase}: {what} {got} over {tol:g} against the eager steps")


@contextlib.contextmanager
def deterministic(torch):
    """torch's deterministic algorithms for a comparison of graphed and
    eager steps: the pooling's ``index_add_`` then adds in a fixed order
    instead of the order its atomics land, which alone moves two eager runs
    apart (``scan_train_check``'s eager control).  Everything else on the
    path is the same kernels either way."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def scan_models(torch, build, loss_fn, weight_decay, dev, dropout):
    """Two copies of ``build(dropout)`` at random running stats, the first
    behind ``make_scan_train_steps``, the second behind ``make_train_step``
    (seed 0 both), each with its own optimizer."""
    from phc_gnn_torch.train import (make_optimizer, make_scan_train_steps,
                                     make_train_step)

    model = build(dropout)
    randomize_eval_state(torch, model)
    e_model = copy.deepcopy(model)
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=GRAD_CLIP)
    e_opt = make_optimizer(dict(e_model.named_parameters()),
                           grad_clip=GRAD_CLIP)
    steps = make_scan_train_steps(model, opt, loss_fn,
                                  weight_decay=weight_decay, seed=0,
                                  device=dev)
    eager = make_train_step(e_model, e_opt, loss_fn,
                            weight_decay=weight_decay, seed=0, device=dev)
    return (model, opt, steps), (e_model, e_opt, eager)


def run_eager(torch, eager, batches, lr):
    res = [eager(b, lr) for b in batches]
    return (torch.stack([r[0] for r in res]),
            torch.stack([r[1] for r in res]))


def scan_train_check(torch, dev, phase, build, loss_fn, weight_decay, lr,
                     batches):
    """``make_scan_train_steps`` against ``make_train_step`` from the same
    weights with dropout off, both under ``deterministic``:
    ``len(batches)`` graphed steps in one call against as many eager steps,
    bit-equal expected (the same kernels in the same order).  Beside it, the
    same eager steps twice outside ``deterministic``: what the atomics alone
    move.  Returns the readings and the models and steps."""
    from phc_gnn_torch.train import make_optimizer, make_train_step

    base = build(False)
    randomize_eval_state(torch, base)
    x_runs = []
    for _ in range(2):
        m = copy.deepcopy(base)
        o = make_optimizer(dict(m.named_parameters()), grad_clip=GRAD_CLIP)
        run_eager(torch, make_train_step(m, o, loss_fn,
                                         weight_decay=weight_decay, seed=0,
                                         device=dev), batches, lr)
        x_runs.append(train_state(m, o))
    with deterministic(torch):
        (model, opt, steps), (e_model, e_opt, eager) = scan_models(
            torch, build, loss_fn, weight_decay, dev, False)
        losses, outs = steps(batches, lr)
        e_losses, e_outs = run_eager(torch, eager, batches, lr)
        torch.cuda.synchronize()
    info = {"steps": len(batches),
            "losses": [float(x) for x in losses.cpu()],
            "eager_vs_eager_atomics": state_diff(*x_runs),
            "loss_err": normwise(losses.cpu(), e_losses.cpu())[1],
            "loss_bit_equal": torch_equal(losses.cpu(), e_losses.cpu()),
            "out_err": normwise(outs.cpu(), e_outs.cpu())[1],
            "out_bit_equal": torch_equal(outs.cpu(), e_outs.cpu()),
            "optimizer_count": [opt.count, e_opt.count],
            "state": state_diff(train_state(model, opt),
                                train_state(e_model, e_opt))}
    if opt.count != e_opt.count:
        fail(f"{phase}: the optimizer's count {opt.count} after the graphed "
             f"steps, {e_opt.count} after the eager ones")
    st = info["state"]
    print(f"{phase}: {len(batches)} graphed steps in one call against as "
          f"many eager ones, dropout off, torch's deterministic algorithms "
          f"on both (without them two eager runs already part by up to "
          f"{info['eager_vs_eager_atomics']['max_rel_err']:.3e} per tensor: "
          f"the pooling's atomics)", flush=True)
    hold_scan(phase, info["loss_err"], TOL_SCAN,
              f"losses normwise (bit-equal: {info['loss_bit_equal']})")
    hold_scan(phase, info["out_err"], TOL_SCAN,
              f"outputs normwise (bit-equal: {info['out_bit_equal']})")
    hold_scan(phase, st["max_rel_err"], TOL_SCAN_STATE,
              f"parameters, running stats and Adam state per tensor "
              f"({st['bit_equal']} of {st['tensors']} bit-equal)")
    return info, (model, opt, steps, e_model, e_opt, eager)


def scan_atomics_check(torch, dev, build, loss_fn, batch):
    """The main path's graph as it is timed and counted, outside
    ``deterministic`` (the pooling's ``index_add_`` adds in the order its
    atomics land): one graphed step of ``build(True)``, dropout on, against
    one eager step from the same weights and generator seed, losses and
    outputs held at ``TOL_SCAN_ATOMICS``; beside it, what the atomics alone
    move,
    two eager steps from those weights against each other."""
    from phc_gnn_torch.train import make_train_step

    (_, _, steps), (e_model, e_opt, eager) = scan_models(
        torch, build, loss_fn, WEIGHT_DECAY, dev, True)
    x_model, x_opt = copy.deepcopy((e_model, e_opt))
    control = make_train_step(x_model, x_opt, loss_fn,
                              weight_decay=WEIGHT_DECAY, seed=0, device=dev)
    losses, outs = steps([batch], LR)
    e_loss, e_out = eager(batch, LR)
    x_loss, x_out = control(batch, LR)
    torch.cuda.synchronize()
    info = {"loss_err": normwise(losses[0].cpu(), e_loss.cpu())[1],
            "out_err": normwise(outs[0].cpu(), e_out.cpu())[1],
            "eager_vs_eager_loss_err": normwise(x_loss.cpu(),
                                                e_loss.cpu())[1],
            "eager_vs_eager_out_err": normwise(x_out.cpu(), e_out.cpu())[1]}
    print(f"scan flagship, no deterministic algorithms, dropout on: one "
          f"graphed step against one eager step; two eager steps part by "
          f"{info['eager_vs_eager_loss_err']:.3e} in the loss and "
          f"{info['eager_vs_eager_out_err']:.3e} normwise in the outputs "
          f"(the pooling's atomics)", flush=True)
    hold_scan("scan flagship", info["loss_err"], TOL_SCAN_ATOMICS,
              "one non-deterministic graphed step's loss, relative")
    hold_scan("scan flagship", info["out_err"], TOL_SCAN_ATOMICS,
              "one non-deterministic graphed step's outputs normwise")
    return info


def scan_lr_change(torch, dev, phase, loss_fn, lr2, batches, models):
    """An lr changed between two chunks: the graphed steps at ``lr2`` against
    eager steps at ``lr2`` from the same state (under ``deterministic``),
    and an eager control at the old lr, which must land far from both."""
    from phc_gnn_torch.train import make_train_step

    model, opt, steps, e_model, e_opt, eager = models
    c_model, c_opt = copy.deepcopy((e_model, e_opt))
    control = make_train_step(c_model, c_opt, loss_fn,
                              weight_decay=WEIGHT_DECAY, seed=0, device=dev)
    with deterministic(torch):
        losses, _ = steps(batches, lr2)
        e_losses, _ = run_eager(torch, eager, batches, lr2)
        run_eager(torch, control, batches, LR)
        torch.cuda.synchronize()
    got = state_diff(train_state(model, opt), train_state(e_model, e_opt))
    moved = state_diff(train_state(c_model, c_opt),
                       train_state(e_model, e_opt))
    info = {"lr": [LR, lr2], "loss_err": normwise(losses.cpu(),
                                                  e_losses.cpu())[1],
            "state": got, "control_at_old_lr": moved}
    hold_scan(phase, info["loss_err"], TOL_SCAN,
              f"losses normwise after the lr changed from {LR:g} to {lr2:g}")
    hold_scan(phase, got["max_rel_err"], TOL_SCAN_STATE,
              f"state per tensor after the lr change "
              f"({got['bit_equal']} of {got['tensors']} bit-equal)")
    print(f"{phase}: the eager control kept lr {LR:g}: its state differs by "
          f"up to {moved['max_rel_err']:.3e} per tensor (must exceed "
          f"{LR_MOVED:g})", flush=True)
    if not moved["max_rel_err"] > LR_MOVED:
        fail(f"{phase}: the lr change did not move the state apart from the "
             f"old lr's")
    return info


def scan_follow_check(torch, dev, loss_fn, batches):
    """A flagship and its optimizer built on the CPU, then bound to the card
    by ``make_scan_train_steps``: the optimizer's lr and Adam state must
    follow the parameters there (capturable), and its graphed steps equal
    those of a copy whose optimizer was built on the card, under
    ``deterministic``, dropout off."""
    from phc_gnn_torch.models import PHCGNN
    from phc_gnn_torch.train import make_optimizer, make_scan_train_steps

    host = PHCGNN(**flagship_config(False), seed=0, device="cpu")
    h_opt = make_optimizer(dict(host.named_parameters()), grad_clip=GRAD_CLIP)
    card = copy.deepcopy(host).to(dev)
    c_opt = make_optimizer(dict(card.named_parameters()), grad_clip=GRAD_CLIP)
    with deterministic(torch):
        losses = [make_scan_train_steps(m, o, loss_fn,
                                        weight_decay=WEIGHT_DECAY, seed=0,
                                        device=dev)(batches, LR)[0]
                  for m, o in ((host, h_opt), (card, c_opt))]
        torch.cuda.synchronize()
    on_card = all(t.device == dev for t in h_opt.state_tensors())
    got = state_diff(train_state(host, h_opt), train_state(card, c_opt))
    info = {"state_on_card": on_card, "capturable": h_opt.on_device,
            "loss_err": normwise(losses[0].cpu(), losses[1].cpu())[1],
            "state": got}
    print(f"scan flagship: an optimizer built on the CPU before its model "
          f"moved: its lr and state on the card {on_card}, capturable "
          f"{h_opt.on_device}", flush=True)
    if not (on_card and h_opt.on_device):
        fail("scan flagship: the optimizer's state did not follow its "
             "parameters to the card")
    hold_scan("scan flagship", info["loss_err"], TOL_SCAN,
              f"{len(batches)} graphed steps' losses normwise against an "
              f"optimizer built on the card")
    hold_scan("scan flagship", got["max_rel_err"], TOL_SCAN_STATE,
              f"state per tensor against it ({got['bit_equal']} of "
              f"{got['tensors']} bit-equal)")
    return info


def scan_dropout_check(torch, dev, build, loss_fn, batches):
    """With the flagship's dropout, under ``deterministic``: the graphed
    steps against eager steps from the same weights and generator seed (do
    the replays draw the eager masks?), and two replays on one batch at lr 0
    (the weights stay; the masks must differ)."""
    with deterministic(torch):
        (_, _, steps), (_, _, eager) = scan_models(
            torch, build, loss_fn, WEIGHT_DECAY, dev, True)
        losses, outs = steps(batches, LR)
        e_losses, e_outs = run_eager(torch, eager, batches, LR)
        _, twice = steps([batches[0]] * 2, 0.0)
        torch.cuda.synchronize()
    info = {"out_err_vs_eager": normwise(outs.cpu(), e_outs.cpu())[1],
            "outs_bit_equal_to_eager": torch_equal(outs.cpu(), e_outs.cpu()),
            "loss_err_vs_eager": normwise(losses.cpu(), e_losses.cpu())[1],
            "successive_replays_out_diff": normwise(twice[0].cpu(),
                                                    twice[1].cpu())[1]}
    info["masks_reproduce"] = info["out_err_vs_eager"] <= TOL_SCAN
    print(f"scan dropout: graphed steps vs eager from the same generator "
          f"seed: outputs normwise {info['out_err_vs_eager']:.3e} "
          f"(bit-equal: {info['outs_bit_equal_to_eager']}), losses "
          f"{info['loss_err_vs_eager']:.3e}: the replays "
          f"{'draw' if info['masks_reproduce'] else 'do not draw'} the eager "
          f"steps' masks (read at {TOL_SCAN:g}); two successive replays on "
          f"one batch at lr 0 differ by "
          f"{info['successive_replays_out_diff']:.3e} normwise (must exceed "
          f"{MASKS_DIFFER:g})", flush=True)
    if not info["successive_replays_out_diff"] > MASKS_DIFFER:
        fail("scan dropout: two successive replays drew the same masks")
    if not info["masks_reproduce"]:
        fail("scan dropout: the replays did not draw the eager steps' masks")
    return info


def scan_eval_check(torch, dev, phase, model, batches):
    """``make_scan_eval_steps`` against ``make_eval_step`` on ``batches``,
    under ``deterministic``."""
    from phc_gnn_torch.train import make_eval_step, make_scan_eval_steps

    with deterministic(torch):
        eager = make_eval_step(model, device=dev)
        want = torch.stack([eager(b) for b in batches])
        got = make_scan_eval_steps(model, device=dev)(batches)
        torch.cuda.synchronize()
    err = normwise(got.cpu(), want.cpu())[1]
    print(f"{phase}: graphed eval of {len(batches)} batches vs eager: "
          f"normwise {err:.3e} (bit-equal: "
          f"{torch_equal(got.cpu(), want.cpu())}; tolerance {TOL_SCAN:g})",
          flush=True)
    if not (got.shape == want.shape and err <= TOL_SCAN):
        fail(f"{phase}: graphed eval disagrees with the eager forward")
    return err


def time_scan(torch, fn, steps: int, reps: int = 5) -> tuple:
    """(device ms, host ms) per step of ``fn()``, which runs ``steps`` steps:
    CUDA events around the call and the host clock until it is done,
    medians of ``reps`` calls after one."""
    fn()
    torch.cuda.synchronize()
    dev_ms, host_ms = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3 / steps)
        dev_ms.append(start.elapsed_time(end) / steps)
    return statistics.median(dev_ms), statistics.median(host_ms)


def scan_profile(torch, phase, eager_fn, graph_fn, steps: int, kernels):
    """Eager against graphed: ms a step, kernels a step, device busy and idle
    share, the port's kernels a step (from the profile: the counters do not
    see a replay) and whether an embedding backward or a sort ran."""
    out = {}
    for how, fn, per in (("eager", eager_fn, 1), ("graph", graph_fn, steps)):
        ms, host_ms = (time_steps(torch, fn) if per == 1
                       else time_scan(torch, fn, per))
        prof = device_profile(torch, fn, ms * per, iters=max(1, 20 // per))
        calls = max(1, 20 // per) * per
        fam = kernel_families(prof["counts"], calls)
        sorts = {n: c for n, c in prof["counts"].items()
                 if any(k in n.lower() for k in EMBEDDING_BWD_NAMES)}
        out[how] = {"ms": ms, "host_ms": host_ms,
                    "kernels": prof["kernels_per_call"] / per,
                    "busy_ms": prof["busy_ms"] / per,
                    "idle_share": prof["idle_share"],
                    "port_kernels": {k: v for k, v in fam.items() if v},
                    "embedding_bwd_or_sort_kernels": sorts,
                    "top_us": [[n, us / per] for n, us in prof["top_us"]]}
        print(f"{phase} {how}: {ms:.3f} ms a step (host {host_ms:.3f} ms), "
              f"{out[how]['kernels']:g} kernels, device busy "
              f"{out[how]['busy_ms']:.3f} ms (idle "
              f"{100 * prof['idle_share']:.1f} %); the port's kernels a step "
              f"{out[how]['port_kernels']}; embedding backward or sort "
              f"kernels {sorts or 'none'}", flush=True)
        want = kernels if isinstance(kernels, dict) else dict.fromkeys(
            kernels, 1)
        missing = [k for k, n in want.items() if n and not fam.get(k)]
        if missing:
            fail(f"{phase} {how}: no {missing} kernel in the profile")
        extra = [k for k, n in want.items() if not n and fam.get(k)]
        if extra:
            fail(f"{phase} {how}: {extra} kernels in the profile, which "
                 f"this path must not launch")
        if sorts:
            fail(f"{phase} {how}: the profile holds {sorts}")
    return out


def scan_phase(torch, dev):
    """The scanned train and eval steps as CUDA graphs (module docstring,
    phase 14); returns the wrappers' counts of the graphed flagship run and
    the readings."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.models import PHCGNN
    from phc_gnn_torch.train import (make_eval_step, make_scan_eval_steps,
                                     masked_l1)

    host = [attach_csr_plan(synthetic_batch(seed=s, **FLAGSHIP))
            for s in range(SCAN_STEPS)]
    batches = [b.to(dev) for b in host]

    def loss_fn(out, b):
        return masked_l1(out, b.y)

    def flagship(dropout):
        return PHCGNN(**flagship_config(dropout), seed=0, device=dev)

    info = {"adam": adam_bit_equal(torch, dev)}
    # the main path: the flagship's graphed steps as they train, dropout on
    (_, _, steps), (_, _, eager) = scan_models(torch, flagship, loss_fn,
                                               WEIGHT_DECAY, dev, True)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses, _ = steps(batches, LR)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"scan flagship: the first call of make_scan_train_steps (3 eager "
          f"warm-ups, the capture, {SCAN_STEPS} replays) ran under "
          f"set_sync_debug_mode('error'); the wrappers' counters over it "
          f"{launches}; losses {[round(float(x), 5) for x in losses]}",
          flush=True)
    if not bool(torch.isfinite(losses).all()):
        fail("scan flagship: non-finite loss")
    info["flagship_profile"] = scan_profile(
        torch, "scan flagship train", lambda: eager(batches[0], LR),
        lambda: steps(batches, LR), SCAN_STEPS, TRAIN_LAUNCHES)

    info["atomics"] = scan_atomics_check(torch, dev, flagship, loss_fn,
                                         batches[0])
    info["flagship"], models = scan_train_check(
        torch, dev, "scan flagship", flagship, loss_fn, WEIGHT_DECAY, LR,
        batches)
    info["lr_change"] = scan_lr_change(torch, dev, "scan flagship", loss_fn,
                                       LR / 2, batches[:SCAN_STEPS // 2],
                                       models)
    info["follow"] = scan_follow_check(torch, dev, loss_fn, batches[:2])
    info["dropout"] = scan_dropout_check(torch, dev, flagship, loss_fn,
                                         batches)

    evals = batches[:N_BATCHES]
    for name, build in (("flagship", lambda: flagship(True)),
                        ("quat", lambda: quat_model(torch, dev)),
                        ("pna", lambda: pna_model(torch, dev)[0])):
        m = build()
        randomize_eval_state(torch, m)
        info[f"{name}_eval"] = {"err": scan_eval_check(
            torch, dev, f"scan {name} eval", m, evals)}
    served = flagship(True)
    randomize_eval_state(torch, served)
    one = make_eval_step(served, device=dev)
    scan = make_scan_eval_steps(served, device=dev)
    info["flagship_eval"]["profile"] = scan_profile(
        torch, "scan flagship eval", lambda: one(evals[0]),
        lambda: scan(evals), len(evals), SOFTMAX_EVAL)
    pcba, _, _ = pcba_model(torch, dev)
    randomize_eval_state(torch, pcba)
    info["pcba_eval"] = {"err": scan_eval_check(
        torch, dev, "scan pcba eval", pcba,
        [pcba_batch(torch, 0, PCBA_EVAL).to(dev)])}

    _, pna_loss, pna_cfg = pna_model(torch, dev)
    for name, build, fn, wd, lr, want in (
            ("quat", lambda d: quat_model(torch, dev, dropout=d), loss_fn,
             WEIGHT_DECAY, LR, QUAT_TRAIN_LAUNCHES),
            ("pna", lambda d: pna_model(torch, dev, d)[0], pna_loss,
             pna_cfg.weightdecay, pna_cfg.lr, PNA_TRAIN_LAUNCHES)):
        info[name], _ = scan_train_check(
            torch, dev, f"scan {name}", build, fn, wd, lr,
            batches[:SCAN_FAMILY_STEPS])
        (_, _, st), (_, _, ea) = scan_models(torch, build, fn, wd, dev, True)
        info[name]["profile"] = scan_profile(
            torch, f"scan {name} train", lambda: ea(batches[0], lr),
            lambda: st(batches, lr), SCAN_STEPS, want)
    print(json.dumps({"scan": info}), flush=True)
    return launches, info


def rel_dist(a, b) -> float:
    """||a - b|| / ||b|| (2-norms, in float64 on the CPU): the run's overall
    deviation.  The largest entry's error is no measure between two bf16
    runs: one bf16 rounding that flips between the card and the CPU (their
    f32 sums in other orders) moves an entry by a bf16 step, as much as
    bf16 moves it from f32."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm())


def max_dist(a, b) -> float:
    """max |a - b| / max |b|, in float64 on the CPU."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def grad_dist(torch, a: dict, b: dict, f32: dict) -> float:
    """``rel_dist`` of gradients ``a`` against ``b``, all leaves as one
    vector but those whose float32 gradient ``f32`` is rounding noise (at
    most TOL_NOISE of the largest: the biases that a batch norm follows,
    whose bf16 gradients are sums of thousands of roundings)."""
    top = max(float(g.abs().max()) for g in f32.values())
    keep = [k for k, g in f32.items()
            if float(g.abs().max()) > TOL_NOISE * top]
    flat = [torch.cat([x[k].double().cpu().reshape(-1) for k in keep])
            for x in (a, b)]
    return rel_dist(*flat)


@contextlib.contextmanager
def own_peak(torch, dev):
    """The block's own peak device memory: ``max_memory_allocated`` over
    it less what was allocated when it began (the earlier phases' models
    and graph pools), in the dict it yields, as ``bytes``."""
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    yield out
    torch.cuda.synchronize()
    out["bytes"] = torch.cuda.max_memory_allocated(dev) - base


def bf16_flagship(torch, dev, dropout: bool):
    from phc_gnn_torch.models import PHCGNN

    return PHCGNN(**flagship_config(dropout), compute_dtype=torch.bfloat16,
                  seed=0, device=dev)


def to_device(torch, tree, dev, dtype=None):
    """``tree`` (a module's recorded args and kwargs) with its tensors
    detached on ``dev``; with ``dtype``, its bf16 tensors cast to it."""
    from torch.utils._pytree import tree_map

    def move(t):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.detach().to(dev)
        return t.to(dtype) if dtype is not None and t.dtype == torch.bfloat16 \
            else t
    return tree_map(move, tree)


def record_inputs(torch, model, names):
    """Forward hooks that keep the args and kwargs of each module ``names``
    of ``model`` in its next forward, copied to the CPU; (store, handles)."""
    store = {}

    def hook(name):
        def keep(module, args, kwargs, output):
            store[name] = to_device(torch, (args, kwargs), "cpu")
        return keep
    handles = [model.get_submodule(n).register_forward_hook(
        hook(n), with_kwargs=True) for n in names]
    return store, handles


def module_vjp(torch, module, inputs, dev, dtype=None):
    """The training output of ``module`` at its recorded ``inputs`` moved
    to ``dev`` (bf16 tensors cast to ``dtype`` where given), and the VJP of
    a seeded cotangent: (out, {"input": dx, <param>: grad}), on the CPU."""
    args, kwargs = to_device(torch, inputs, dev, dtype)
    x = args[0].requires_grad_(True)
    out = module(x, *args[1:], **kwargs)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    params = {k: p for k, p in module.named_parameters() if p.requires_grad}
    grads = torch.autograd.grad(out, [x, *params.values()],
                                cot.to(dev, out.dtype), allow_unused=True)
    return out.detach().cpu(), {
        k: (torch.zeros_like(v) if g is None else g).detach().cpu()
        for (k, v), g in zip((("input", x), *params.items()), grads)}


def bf16_module_ratios(torch, dev, cpu_vjps, inputs, under_test,
                       dtype=None):
    """Per module of BF16_MODULES at the CPU bf16 run's recorded inputs:
    ``under_test``'s module (on the card, inputs cast to ``dtype`` where
    given, torch's deterministic algorithms on) against the CPU bf16
    model's, as a share of the CPU bf16 module's distance from the CPU f32
    module fed the same inputs upcast (``cpu_vjps[name]``: the two
    ``module_vjp``; 2-norms, the gradients those of the input and the
    parameters but the leaves whose f32 gradient is rounding noise)."""
    ratios = {}
    for name in BF16_MODULES:
        want, wit = cpu_vjps[name]
        with deterministic(torch):
            got = module_vjp(torch, under_test.get_submodule(name),
                             inputs[name], dev, dtype)
        ratios[name] = {
            "out": rel_dist(got[0], want[0]) / max(
                rel_dist(want[0], wit[0]), 1e-30),
            "grads": grad_dist(torch, got[1], want[1], wit[1]) / max(
                grad_dist(torch, want[1], wit[1], wit[1]), 1e-30)}
    return ratios


def bf16_agreement(torch, dev, host_batch, batch, loss_fn):
    """One dropout-free training forward and backward of the flagship from
    one random state in four models: the card's and the CPU's, each in
    float32 and bf16.

    Held, per module of BF16_MODULES fed the CPU bf16 run's own inputs
    (forward and the VJP of a seeded cotangent): the card's bf16 module
    within BF16_MODULE_FACTOR of the CPU bf16 module's distance from the
    CPU f32 module.  The same check with the card's f32 model in the bf16
    model's place (the control) must fail on every module, so the check
    tells a bf16 module from one that skipped its casts.  Whole model: the
    card's bf16 output and gradients from the card's f32 ones within
    BF16_OWN_BAND of the CPU bf16 model's distance from the CPU f32 model
    (the card's run rounds as a bf16 run does), and the card's bf16 output
    and loss within BF16_F32_BOUND of the card's f32 ones.  The whole
    model's card bf16 against CPU bf16 is held only within the gross
    BF16_WHOLE_FACTOR: two bf16 runs whose float32 sums differ in order
    alone move apart by nearly as much as bf16 moves from f32 (each cast
    turns the other's last-bit differences into bf16 steps, layer by
    layer), so an f32 model passes it too."""
    from phc_gnn_torch.models import PHCGNN
    from phc_gnn_torch.train import make_loss_and_grads

    base = PHCGNN(**flagship_config(False), seed=0, device="cpu")
    randomize_eval_state(torch, base)
    state = base.state_dict()
    runs, models = {}, {}
    for where, b in (("card", batch), ("cpu", host_batch)):
        for dtype in ("f32", "bf16"):
            m = PHCGNN(**flagship_config(False), seed=0, device=dev
                       if where == "card" else "cpu",
                       compute_dtype=torch.bfloat16 if dtype == "bf16"
                       else None)
            m.load_state_dict(state)
            models[where, dtype] = m
            store, handles = (record_inputs(torch, m, BF16_MODULES)
                              if (where, dtype) == ("cpu", "bf16")
                              else ({}, []))
            loss, out, grads = make_loss_and_grads(
                m, loss_fn, WEIGHT_DECAY)(b, LR)
            for h in handles:
                h.remove()
            if store:
                inputs = store
            runs[where, dtype] = (loss.cpu(), out.cpu(),
                                  {k: g.cpu() for k, g in grads.items()})
    if any(g.dtype != torch.float32 or not bool(torch.isfinite(g).all())
           for g in runs["card", "bf16"][2].values()):
        fail("bf16 flagship: a gradient is not float32 or not finite")
    if runs["card", "bf16"][1].dtype != torch.float32:
        fail("bf16 flagship: the output is not float32")

    cpu_vjps = {name: (module_vjp(torch, models["cpu", "bf16"].get_submodule(
        name), inputs[name], "cpu"), module_vjp(
            torch, models["cpu", "f32"].get_submodule(name), inputs[name],
            "cpu", torch.float32)) for name in BF16_MODULES}
    info = {"modules": bf16_module_ratios(torch, dev, cpu_vjps, inputs,
                                          models["card", "bf16"]),
            "control_card_f32": bf16_module_ratios(
                torch, dev, cpu_vjps, inputs, models["card", "f32"],
                torch.float32)}
    worst = {w: max(r[w] for r in info["modules"].values())
             for w in ("out", "grads")}
    print(f"bf16 flagship per module (inputs of the CPU bf16 run, a seeded "
          f"cotangent): the card's bf16 module from the CPU's bf16 module as "
          f"a share of the CPU bf16 module's distance from f32, out / grads "
          f"{ {k: (round(v['out'], 4), round(v['grads'], 4)) for k, v in info['modules'].items()} } "
          f"(worst {worst['out']:.4g} / {worst['grads']:.4g}, limit "
          f"{BF16_MODULE_FACTOR:g}); the control, the card's f32 modules in "
          f"their place, "
          f"{ {k: (round(v['out'], 4), round(v['grads'], 4)) for k, v in info['control_card_f32'].items()} }",
          flush=True)
    for name, r in info["modules"].items():
        for what in ("out", "grads"):
            if not r[what] <= BF16_MODULE_FACTOR:
                fail(f"bf16 flagship {name} {what}: the card's bf16 module "
                     f"is {r[what]:.3g} times the CPU bf16 module's own "
                     f"distance from f32 away from the CPU's bf16 module "
                     f"(limit {BF16_MODULE_FACTOR:g})")
    for name, r in info["control_card_f32"].items():
        if r["out"] <= BF16_MODULE_FACTOR and r["grads"] <= BF16_MODULE_FACTOR:
            fail(f"bf16 flagship {name}: the card's f32 module passes the "
                 f"bf16 module check, which so cannot tell bf16 from f32")

    for what, i in (("out", 1), ("loss", 0)):
        c16, p16, p32 = (runs["card", "bf16"][i], runs["cpu", "bf16"][i],
                         runs["cpu", "f32"][i])
        info[what] = {
            "card_bf16_vs_cpu_bf16": rel_dist(c16, p16),
            "witness_cpu_bf16_vs_cpu_f32": rel_dist(p16, p32),
            "card_bf16_vs_card_f32": rel_dist(c16, runs["card", "f32"][i])}
    f32 = runs["cpu", "f32"][2]
    info["grads"] = {
        "card_bf16_vs_cpu_bf16": grad_dist(torch, runs["card", "bf16"][2],
                                           runs["cpu", "bf16"][2], f32),
        "witness_cpu_bf16_vs_cpu_f32": grad_dist(
            torch, runs["cpu", "bf16"][2], f32, f32),
        "card_bf16_vs_card_f32": grad_dist(torch, runs["card", "bf16"][2],
                                           runs["card", "f32"][2], f32)}
    for what in ("out", "loss", "grads"):
        r = info[what]
        wit = max(r["witness_cpu_bf16_vs_cpu_f32"], 1e-30)
        r["own_ratio"] = r["card_bf16_vs_card_f32"] / wit
        r["cpu_ratio"] = r["card_bf16_vs_cpu_bf16"] / wit
        print(f"bf16 flagship {what}, whole model: the card's bf16 run "
              f"{r['card_bf16_vs_card_f32']:.3e} from its f32 run, the CPU's "
              f"{r['witness_cpu_bf16_vs_cpu_f32']:.3e} (ratio "
              f"{r['own_ratio']:.3g}"
              + (f", band {BF16_OWN_BAND}" if what != "loss" else
                 ", not held: a mean whose signed roundings cancel")
              + f"); the card's bf16 run {r['card_bf16_vs_cpu_bf16']:.3e} "
              f"from the CPU's bf16 run (ratio {r['cpu_ratio']:.3g}"
              + (f", gross limit {BF16_WHOLE_FACTOR:g})" if what != "loss"
                 else ", not held)"), flush=True)
    lo, hi = BF16_OWN_BAND
    for what in ("out", "grads"):
        if not info[what]["cpu_ratio"] <= BF16_WHOLE_FACTOR:
            fail(f"bf16 flagship {what}: the card's bf16 run is "
                 f"{info[what]['cpu_ratio']:.3g} times the CPU bf16 run's "
                 f"distance from f32 away from the CPU's bf16 run")
        if not lo <= info[what]["own_ratio"] <= hi:
            fail(f"bf16 flagship {what}: the card's bf16 run is "
                 f"{info[what]['own_ratio']:.3g} times the CPU bf16 run's "
                 f"distance from f32 away from the card's f32 run, outside "
                 f"{BF16_OWN_BAND}")
    if not info["loss"]["card_bf16_vs_card_f32"] <= BF16_F32_BOUND:
        fail("bf16 flagship: the bf16 loss is more than 5 % from the f32 one")
    if not max_dist(runs["card", "bf16"][1],
                    runs["card", "f32"][1]) <= BF16_F32_BOUND:
        fail("bf16 flagship: the bf16 output is more than 5 % from the f32 "
             "one")
    return info


def bf16_phase(torch, dev, f32_profile):
    """16. bf16 flagship: compute_dtype=bf16 at width 200 (module
    docstring); ``f32_profile`` is the scan phase's ``scan_profile`` of the
    f32 flagship's eager and graphed steps, which this phase's bf16 ones
    are read beside; returns the counts of its eager steps and of its
    graphed steps' first call, and the readings (``seconds`` of its
    parts)."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.models import PHCGNN
    from phc_gnn_torch.train import (make_optimizer, make_scan_train_steps,
                                     make_train_step, masked_l1)

    host = [attach_csr_plan(synthetic_batch(seed=s, **FLAGSHIP))
            for s in range(SCAN_STEPS)]
    batches = [b.to(dev) for b in host]

    def loss_fn(out, b):
        return masked_l1(out, b.y)

    clock = [time.perf_counter()]
    seconds = {}

    def lap(name):
        seconds[name] = time.perf_counter() - clock[0]
        clock[0] = time.perf_counter()

    info = {"agreement": bf16_agreement(torch, dev, host[0], batches[0],
                                        loss_fn), "seconds": seconds}
    lap("agreement")
    paths = {}
    model = bf16_flagship(torch, dev, True)
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=GRAD_CLIP)
    step = make_train_step(model, opt, loss_fn, weight_decay=WEIGHT_DECAY,
                           device=dev)
    step(batches[0], LR)
    torch.cuda.synchronize()
    reset_launches()
    losses = [step(b, LR)[0] for b in batches[:BF16_STEPS]]
    torch.cuda.synchronize()
    paths["bf16_train"] = read_launches()
    hold_counters("bf16 flagship eager", paths["bf16_train"],
                  add_counts((BF16_STEPS, BF16_TRAIN_LAUNCHES)))
    if not all(bool(torch.isfinite(x)) for x in losses):
        fail("bf16 flagship: a non-finite loss")
    # the bf16 flagship served: its eval forward on N_BATCHES batches, the
    # fused softmax once a layer, neither A nor B
    from phc_gnn_torch.train import make_eval_step
    served = bf16_flagship(torch, dev, False)
    randomize_eval_state(torch, served)
    serve = make_eval_step(served, device=dev)
    serve(batches[0])
    torch.cuda.synchronize()
    reset_launches()
    evals = [serve(b) for b in batches[:N_BATCHES]]
    torch.cuda.synchronize()
    paths["bf16_eval"] = read_launches()
    hold_counters("bf16 flagship eval", paths["bf16_eval"],
                  add_counts((N_BATCHES, BF16_EVAL_LAUNCHES)))
    if not all(bool(torch.isfinite(x).all()) for x in evals):
        fail("bf16 flagship: a non-finite eval output")
    lap("eager")

    steps = {}
    peaks = {}
    for dtype in ("f32", "bf16"):
        m = PHCGNN(**flagship_config(True), seed=0, device=dev,
                   compute_dtype=torch.bfloat16 if dtype == "bf16" else None)
        e_m = copy.deepcopy(m)
        o = make_optimizer(dict(m.named_parameters()), grad_clip=GRAD_CLIP)
        e_o = make_optimizer(dict(e_m.named_parameters()),
                             grad_clip=GRAD_CLIP)
        steps[dtype] = (make_scan_train_steps(m, o, loss_fn,
                                              weight_decay=WEIGHT_DECAY,
                                              seed=0, device=dev),
                        make_train_step(e_m, e_o, loss_fn,
                                        weight_decay=WEIGHT_DECAY, device=dev))
        reset_launches()
        with own_peak(torch, dev) as peak:
            torch.cuda.set_sync_debug_mode("error")
            try:
                scan_losses, _ = steps[dtype][0](batches, LR)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        peaks[dtype] = peak["bytes"]
        if dtype == "bf16":
            paths["bf16_scan"] = read_launches()
            hold_counters("bf16 flagship graphed", paths["bf16_scan"],
                          add_counts((capture_calls(), BF16_TRAIN_LAUNCHES)))
        if not bool(torch.isfinite(scan_losses).all()):
            fail(f"bf16 flagship: a non-finite graphed loss ({dtype})")
    info["peak_mem_bytes_first_graphed_call"] = peaks
    lap("graphs")
    info["graphed_vs_eager"], _ = scan_train_check(
        torch, dev, "bf16 flagship", lambda d: bf16_flagship(torch, dev, d),
        loss_fn, WEIGHT_DECAY, LR, batches[:BF16_SCAN_STEPS])
    lap("graphed_vs_eager")
    # f32 (the scan phase's reading), then bf16, then each graph again:
    # their time in turns
    info["profile_f32"] = f32_profile
    graph, eager = steps["bf16"]
    info["profile_bf16"] = scan_profile(
        torch, "bf16 phase, bf16 flagship train",
        lambda: eager(batches[0], LR), lambda: graph(batches, LR),
        SCAN_STEPS, BF16_TRAIN_LAUNCHES)
    lap("profile")
    info["graph_ms_again"] = {
        dtype: time_scan(torch, lambda: steps[dtype][0](batches, LR),
                         SCAN_STEPS)[0] for dtype in ("bf16", "f32")}
    print(f"bf16 flagship: graphed step ms, in turns f32 "
          f"{info['profile_f32']['graph']['ms']:.3f}, bf16 "
          f"{info['profile_bf16']['graph']['ms']:.3f}, bf16 "
          f"{info['graph_ms_again']['bf16']:.3f}, f32 "
          f"{info['graph_ms_again']['f32']:.3f}; peak memory of the first "
          f"graphed call {peaks}", flush=True)
    lap("turns")
    return paths, info


def bf16_pcba_phase(torch, dev):
    """17. bf16 pcba: ``make_accum_train_step`` (one CUDA graph, K = 4) in
    bf16 against float32 in turns; then the eval forward of both on the
    512-graph batch (C's bulk instance in bf16, by the plan), its distance
    from the f32 forward printed; returns the
    counts of the bf16 graph's first call and of the bf16 eval forward, and
    the readings."""
    host = [pcba_batch(torch, s, PCBA) for s in range(PCBA_K)]
    batches = [b.to(dev) for b in host]
    from phc_gnn_torch.train import make_accum_train_step, make_optimizer

    graphs, info, launches, lr = {}, {}, None, PCBA_SCRIPT["lr"]
    for dtype in ("f32", "bf16"):
        model, loss_fn, cfg = pcba_model(torch, dev, compute_dtype=dtype)
        opt = make_optimizer(dict(model.named_parameters()),
                             grad_clip=cfg.grad_clipping)
        graphs[dtype] = make_accum_train_step(
            model, opt, loss_fn, weight_decay=cfg.weightdecay,
            loss_name=cfg.loss, seed=0, device=dev)
        reset_launches()
        with own_peak(torch, dev) as peak:
            torch.cuda.set_sync_debug_mode("error")
            try:
                loss, outs = graphs[dtype](batches, lr)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        info[dtype] = {"peak_mem_bytes_first_call": peak["bytes"],
                       "loss": float(loss)}
        if not (bool(torch.isfinite(loss))
                and bool(torch.isfinite(outs).all())):
            fail(f"bf16 pcba: a non-finite loss or output ({dtype})")
        if dtype == "bf16":
            launches = read_launches()
            hold_counters("bf16 pcba graphed", launches,
                          add_counts((capture_calls(), PCBA_BF16_LAUNCHES)))
    from phc_gnn_torch.ops import segment_sum as ssum
    from phc_gnn_torch.train import make_eval_step

    eval_batch = pcba_batch(torch, 0, PCBA_EVAL).to(dev)
    n, e = PCBA_EVAL["num_nodes"], PCBA_EVAL["num_edges"]
    if not ssum.segment_sum_plan(n, e, PCBA_DIM, False, True, 2).bulk:
        fail("bf16 pcba eval: the plan does not take C's bulk instance")
    evals = {}
    for dtype in ("f32", "bf16"):
        served, _, _ = pcba_model(torch, dev, compute_dtype=dtype)
        randomize_eval_state(torch, served)
        serve = make_eval_step(served, device=dev)
        serve(eval_batch)
        torch.cuda.synchronize()
        reset_launches()
        evals[dtype] = serve(eval_batch)
        torch.cuda.synchronize()
        if dtype == "bf16":
            eval_launches = read_launches()
            hold_counters("bf16 pcba eval", eval_launches,
                          add_counts((1, PCBA_BF16_EVAL_LAUNCHES)))
        info[dtype]["eval_ms"] = time_steps(torch,
                                            lambda: serve(eval_batch))[0]
    if not bool(torch.isfinite(evals["bf16"]).all()):
        fail("bf16 pcba eval: a non-finite output")
    info["eval_rel_dist_bf16_vs_f32"] = rel_dist(evals["bf16"], evals["f32"])
    print(f"bf16 pcba eval: ms f32 {info['f32']['eval_ms']:.3f}, bf16 "
          f"{info['bf16']['eval_ms']:.3f}; the bf16 output from the f32 one (2-norm) "
          f"{info['eval_rel_dist_bf16_vs_f32']:.3e}", flush=True)
    for dtype in ("f32", "bf16", "bf16", "f32"):
        ms, host_ms = time_steps(torch, lambda: graphs[dtype](batches, lr))
        info[dtype].setdefault("step_ms", []).append(ms)
    for dtype in ("f32", "bf16"):
        call = lambda: graphs[dtype](batches, lr)  # noqa: E731
        prof = device_profile(torch, call, min(info[dtype]["step_ms"]),
                              iters=10)
        info[dtype].update(kernels_per_step=prof["kernels_per_call"],
                           device_busy_ms_per_step=prof["busy_ms"],
                           device_idle_share=prof["idle_share"],
                           top_kernels_us_per_step=prof["top_us"][:6])
        print(f"bf16 pcba {dtype}: graphed accumulated step ms (in turns) "
              f"{info[dtype]['step_ms']}, {prof['kernels_per_call']:g} "
              f"kernels, device busy {prof['busy_ms']:.3f} ms (idle "
              f"{100 * prof['idle_share']:.1f} %), peak memory of the first "
              f"call {info[dtype]['peak_mem_bytes_first_call'] / 2**30:.3f} "
              f"GiB; top kernels {prof['top_us'][:4]}", flush=True)
    return {"bf16_pcba": launches, "bf16_pcba_eval": eval_launches}, info


def remat_pair(torch, dev, family: str, dropout: bool):
    """(remat=False, remat=True) models of ``family`` from one random state,
    their loss function and lr."""
    if family == "flagship":
        from phc_gnn_torch.models import PHCGNN
        from phc_gnn_torch.train import masked_l1

        models = [PHCGNN(**flagship_config(dropout), remat=r, seed=0,
                         device=dev) for r in (False, True)]
        loss_fn, lr, wd = (lambda out, b: masked_l1(out, b.y)), LR, \
            WEIGHT_DECAY
    else:
        models, loss_fn, cfg = [], None, None
        for r in (False, True):
            m, loss_fn, cfg = pcba_model(torch, dev, dropout, remat=r)
            models.append(m)
        lr, wd = cfg.lr, cfg.weightdecay
    randomize_eval_state(torch, models[0])
    models[1].load_state_dict(models[0].state_dict())
    return models, loss_fn, lr, wd


def remat_phase(torch, dev):
    """18. remat: the flagship and pcba with ``remat=True`` against
    ``remat=False`` (module docstring); returns the counts of the eager
    flagship step and pcba's first graphed call with remat, and the
    readings."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.train import (make_accum_train_step,
                                     make_loss_and_grads, make_optimizer,
                                     make_scan_train_steps, make_train_step)

    flag = [attach_csr_plan(synthetic_batch(seed=s, **FLAGSHIP)).to(dev)
            for s in range(REMAT_STEPS)]
    pcba = [pcba_batch(torch, s, PCBA).to(dev) for s in range(PCBA_K)]
    info, paths = {}, {}
    for family in ("flagship", "pcba"):
        out = info[family] = {}
        # gradients and running stats of one eager forward and backward
        with deterministic(torch):
            (m0, m1), loss_fn, lr, wd = remat_pair(torch, dev, family, False)
            before = {k: b.clone() for k, b in m0.named_buffers()}
            b0 = flag[0] if family == "flagship" else pcba[0]
            r0 = make_loss_and_grads(m0, loss_fn, wd)(b0, lr)
            r1 = make_loss_and_grads(m1, loss_fn, wd)(b0, lr)
            torch.cuda.synchronize()
        grads_equal = all(torch_equal(r0[2][k], r1[2][k]) for k in r0[2])
        stats_equal = all(torch_equal(b, dict(m1.named_buffers())[k])
                          for k, b in m0.named_buffers())
        moved = any(not torch_equal(b, before[k])
                    for k, b in m0.named_buffers())
        out["eager"] = {"loss_bit_equal": torch_equal(r0[0], r1[0]),
                        "grads_bit_equal": grads_equal,
                        "running_stats_bit_equal": stats_equal,
                        "running_stats_moved": moved}
        print(f"remat {family}: one eager forward and backward, remat=True "
              f"against False under deterministic algorithms: "
              f"{out['eager']}", flush=True)
        if not all(out["eager"].values()):
            fail(f"remat {family}: not bit-equal to remat=False (or the "
                 f"running stats did not move): {out['eager']}")
        # graphed steps, bit-equal
        with deterministic(torch):
            (m0, m1), loss_fn, lr, wd = remat_pair(torch, dev, family, False)
            results = []
            for m in (m0, m1):
                o = make_optimizer(dict(m.named_parameters()),
                                   grad_clip=GRAD_CLIP)
                if family == "flagship":
                    st = make_scan_train_steps(m, o, loss_fn, weight_decay=wd,
                                               seed=0, device=dev)
                    losses, outs = st(flag, lr)
                else:
                    st = make_accum_train_step(m, o, loss_fn, weight_decay=wd,
                                               loss_name="bce", seed=0,
                                               device=dev)
                    runs = [st(pcba, lr) for _ in range(REMAT_STEPS)]
                    losses = torch.stack([r[0] for r in runs])
                    outs = torch.stack([r[1] for r in runs])
                torch.cuda.synchronize()
                results.append((losses.cpu(), outs.cpu(), train_state(m, o)))
        st_diff = state_diff(results[0][2], results[1][2])
        out["graphed"] = {"losses_bit_equal": torch_equal(results[0][0],
                                                          results[1][0]),
                          "outputs_bit_equal": torch_equal(results[0][1],
                                                           results[1][1]),
                          "state": st_diff}
        print(f"remat {family}: {REMAT_STEPS} graphed steps, remat=True "
              f"against False under deterministic algorithms: "
              f"{out['graphed']}", flush=True)
        if not (out["graphed"]["losses_bit_equal"]
                and out["graphed"]["outputs_bit_equal"]
                and st_diff["bit_equal"] == st_diff["tensors"]):
            fail(f"remat {family}: the graphed steps are not bit-equal to "
                 f"remat=False")
        # counts, peak memory and step ms, dropout on
        (m0, m1), loss_fn, lr, wd = remat_pair(torch, dev, family, True)
        for name, m in (("remat_off", m0), ("remat_on", m1)):
            o = make_optimizer(dict(m.named_parameters()),
                               grad_clip=GRAD_CLIP)
            if family == "flagship":
                eager = make_train_step(m, o, loss_fn, weight_decay=wd,
                                        device=dev)
                call = lambda: eager(flag[0], lr)  # noqa: E731
            else:
                from phc_gnn_torch.train.state import _eager_accum_train_step
                eager = _eager_accum_train_step(m, o, loss_fn,
                                                weight_decay=wd,
                                                loss_name="bce", device=dev)
                call = lambda: eager(pcba, lr)  # noqa: E731
            call()
            reset_launches()
            with own_peak(torch, dev) as peak:
                call()
            launches = read_launches()
            peak_eager = peak["bytes"]
            if name == "remat_on":
                want = (REMAT_TRAIN_LAUNCHES if family == "flagship"
                        else PCBA_REMAT_LAUNCHES)
                paths[f"remat_{family}"] = launches
                hold_counters(f"remat {family} eager step", launches,
                              add_counts((1, want)))
            eager_ms, _ = time_steps(torch, call, warmup=2, iters=10)
            o2 = make_optimizer(dict(m.named_parameters()),
                                grad_clip=GRAD_CLIP)
            if family == "flagship":
                graph = make_scan_train_steps(m, o2, loss_fn, weight_decay=wd,
                                              seed=0, device=dev)
                gcall = lambda: graph(flag, lr)  # noqa: E731
                per = len(flag)
            else:
                graph = make_accum_train_step(m, o2, loss_fn,
                                              weight_decay=wd,
                                              loss_name="bce", seed=0,
                                              device=dev)
                gcall = lambda: graph(pcba, lr)  # noqa: E731
                per = 1
            with own_peak(torch, dev) as peak:
                gcall()
            peak_graph = peak["bytes"]
            graph_ms, _ = time_scan(torch, gcall, per)
            out[name] = {"peak_mem_bytes_eager_step": peak_eager,
                         "peak_mem_bytes_first_graphed_call": peak_graph,
                         "eager_step_ms": eager_ms, "graph_step_ms": graph_ms}
            print(f"remat {family} {name}: peak memory "
                  f"{peak_eager / 2**30:.3f} GiB over an eager step, {peak_graph / 2**30:.3f} GiB "
                  f"over the graph's first call; eager {eager_ms:.3f} ms, "
                  f"graphed {graph_ms:.3f} ms a step", flush=True)
    return paths, info


def harness_bf16(torch, dev):
    """19. harness bf16: the ZINC recipe through the CLI with
    ``--compute_dtype bf16`` on the zinc parity task for 2 epochs; the
    losses finite and falling, the bf16 instances of C launched."""
    import os
    import tempfile

    from phc_gnn_torch.cli.common import run_benchmark
    from phc_gnn_torch.data.parity import generate_parity_dataset

    with tempfile.TemporaryDirectory(prefix="phc_bf16_") as tmp:
        root = generate_parity_dataset("zinc", os.path.join(tmp, "data"),
                                       seed=0)
        save = os.path.join(tmp, "zinc_bf16")
        reset_launches()
        run_benchmark("zinc", HARNESS_ZINC + [
            "--epochs", "2", "--compute_dtype", "bf16", "--data_root", root,
            "--save_dir", save])
        launches = read_launches()
        rows = scalars(save)
    hold_counters("harness bf16", launches, add_counts(
        (capture_calls(), {f"{k}_bf16" if k.startswith("segment") else k: n
                           for k, n in ZINC_STEP.items()}),
        (capture_calls(), {f"{k}_bf16": n for k, n in ZINC_EVAL.items()})))
    losses = [r["train_loss"] for r in rows]
    if not all(math.isfinite(r[k]) for r in rows
               for k in ("train_loss", "valid_loss", "valid_metric")):
        fail(f"harness bf16: a loss or metric is not finite: {rows}")
    if not losses[-1] < losses[0]:
        fail(f"harness bf16: the train loss did not fall: {losses}")
    print(f"harness bf16: the ZINC recipe with --compute_dtype bf16, train "
          f"losses {losses}, valid {[r['valid_loss'] for r in rows]}",
          flush=True)
    return launches, {"rows": rows, "launches": launches}


def adam_bit_equal(torch, dev):
    """The port's Adam (fused, capturable, the lr a device tensor) against
    torch's fused Adam with a float lr, as the port ran it before: two steps
    from the same parameters and gradients must give bit-equal parameters
    and moments, both at LR itself (the parent's update) and at the lr
    tensor's own value, LR rounded to float32 (as JAX's
    ``jnp.float32(lr)``): the fused kernel computes in float32, so a float
    lr reaches it rounded to that same value."""
    from phc_gnn_torch.train import make_optimizer

    gen = torch.Generator().manual_seed(3)
    shapes = [(4, 50, 50), (200,), (), (100, 50)]
    ps = [torch.randn(s, generator=gen).to(dev).requires_grad_()
          for s in shapes]
    grads = [[torch.randn(s, generator=gen).to(dev) for s in shapes]
             for _ in range(2)]
    opt = make_optimizer({str(i): p for i, p in enumerate(ps)})
    lr32 = float(torch.tensor(LR, dtype=torch.float32))
    refs = {}
    for name, lr in (("lr32", lr32), ("lr", LR)):
        qs = [p.detach().clone().requires_grad_() for p in ps]
        refs[name] = (qs, torch.optim.Adam(qs, lr=lr, eps=1e-8, fused=True))
    for g in grads:
        opt.step(g, LR)
        for qs, ref in refs.values():
            for q, gq in zip(qs, g):
                q.grad = gq.clone()
            ref.step()
    torch.cuda.synchronize()
    out = {}
    for name, (qs, ref) in refs.items():
        pairs = [(p.detach().cpu(), q.detach().cpu()) for p, q in zip(ps, qs)]
        pairs += [(opt.adam.state[p][k].cpu(), ref.state[q][k].cpu())
                  for p, q in zip(ps, qs)
                  for k in ("exp_avg", "exp_avg_sq", "step")]
        out[name] = {
            "bit_equal": all(torch_equal(a, b) for a, b in pairs),
            "params_differing": sum(int((a != b).sum()) for a, b in pairs[
                :len(ps)]),
            "params": sum(p.numel() for p in ps),
            "max_abs_diff": max(float((a - b).abs().max())
                                for a, b in pairs)}
    r32, r = out["lr32"], out["lr"]
    print(f"scan: the port's Adam (fused, capturable, lr a device tensor) vs "
          f"torch's fused Adam with a float lr, two steps (torch "
          f"{torch.__version__}): against lr={LR!r} (the parent's update) "
          f"bit-equal {r['bit_equal']}, {r['params_differing']} of "
          f"{r['params']} parameter elements differ, by up to "
          f"{r['max_abs_diff']:.3e}; against lr={lr32!r} (LR in float32) "
          f"bit-equal {r32['bit_equal']}, {r32['params_differing']} "
          f"differ", flush=True)
    for name, got in out.items():
        if not got["bit_equal"]:
            fail(f"the capturable Adam's update differs from the float-lr "
                 f"Adam's at {name}")
    return out


# ---------------------------------------------------------------- harness

# benchmarks/run_script_pcba_phm2.sh's flags; 1 epoch on data.parity's
# pcba task, whose labels have 8 tasks
HARNESS_PCBA = ["--phm_dim", "2", "--type", "add", "--aggr_msg", "sum",
                "--mlp_mp", "false", "--input_embed_dim", "512",
                "--mp_units", ",".join(["512"] * PCBA_LAYERS),
                "--d_units", "768,256",
                "--dropout_mpnn", ",".join(["0.3"] * PCBA_LAYERS),
                "--dropout_dn", "0.4,0.2", "--batch_size", "128",
                "--grad_accum", str(PCBA_K), "--max_nodes", "4096",
                "--max_edges", "8192", "--eval_batch_size", "512",
                "--lr", "1e-3", "--patience", "5", "--factor", "0.75",
                "--weightdecay", "0.0", "--target_dim", "8", "--epochs", "1"]
# benchmarks/run_script_zinc_phm4.sh's flags on data.parity's zinc, 3 epochs:
# epoch 1 timed as it runs, epoch 2 profiled (a profile slows the replays)
HARNESS_ZINC = ["--phm_dim", "4", "--type", "add", "--sc_type", "last",
                "--aggr_msg", "sum", "--mlp_mp", "true",
                "--input_embed_dim", "200", "--mp_units", "200,200,200,200",
                "--d_units", "128,64", "--dropout_mpnn", "0.0,0.0,0.0,0.0",
                "--dropout_dn", "0.2,0.1", "--batch_size", "128",
                "--lr", "1e-3", "--patience", "20", "--factor", "0.5",
                "--min_lr", "1e-7", "--weightdecay", "0.0", "--epochs", "3"]
HARNESS_EPOCHS = 3          # the synthetic recipe's epochs
HARNESS_PROFILED = 2        # ... the epoch whose train loop is profiled
HARNESS_BUCKET = (3456, 7424)  # its train bucket (JAX's compute_bucket_spec)
SYNTH_STEP = dict(TRAIN_LAUNCHES)
SYNTH_EVAL = dict(SOFTMAX_EVAL)
ZINC_STEP = {"segment_sum_masked": 4, "segment_sum_perm": 4,
             "bn_forward": 10, "bn_backward": 10}
ZINC_EVAL = {"segment_sum_masked": 4}
PROFILE_LOST = 0.02         # a profile may lose a few kernel events (§7)
PROFILE_RECOUNTS = 2        # fresh profiles of the same calls read where a
                            # kernel's count falls short (one read 176 of
                            # 188: a profile loses events, never adds them)
TOL_GROUP = 1e-6            # the dummy-padded group's loss against the
                            # eager body over its real sub-batches: the
                            # pooling's atomics alone part them


def capture_calls() -> int:
    """Calls of a step the wrappers' counters see when a graph is made:
    its eager warm-ups and its capture (a replay launches nothing the
    counters see)."""
    from phc_gnn_torch.train.state import WARMUP_CALLS

    return WARMUP_CALLS + 1


def add_counts(*parts) -> dict:
    """The sum of several launch-count dicts, each times its factor:
    ``add_counts((4, SYNTH_STEP), (4, SYNTH_EVAL))``."""
    out = {name: 0 for name in counter_names()}
    for factor, counts in parts:
        for k, n in counts.items():
            out[k] += factor * n
    return out


def hold_counters(phase, got, want):
    print(f"{phase}: the wrappers' launches over the run (warm-ups and "
          f"captures): {got}", flush=True)
    if got != want:
        fail(f"{phase}: the wrappers launched {got}, not {want}")


def busy_union_ms(torch, prof) -> tuple:
    """(device busy ms as the union of the device events' intervals, the
    port's kernels counted by name, device events) of a finished
    ``torch.profiler`` run: overlapping copies and kernels count once."""
    spans, names = [], {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation):
            spans.append((e.time_range.start, e.time_range.end))
            names[e.name] = names.get(e.name, 0) + 1
    if not spans:
        fail("the profiler recorded no device activity")
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / 1e3, names, len(spans)


@contextlib.contextmanager
def profiled(torch):
    """``torch.profiler`` over the block, the device's activity alone (no
    host op is traced, so the loop and its loader thread run as they
    would); the result dict gets ``wall_ms``, ``busy_ms`` (union),
    ``idle_share``, ``events`` and the kernels by name ``counts`` when the
    block ends."""
    out = {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize()
        out["wall_ms"] = (time.perf_counter() - t0) * 1e3
    out["busy_ms"], out["counts"], out["events"] = busy_union_ms(torch, prof)
    out["idle_share"] = 1.0 - out["busy_ms"] / out["wall_ms"]


def hold_profile(phase, counts, per_step, steps, again=None):
    """The port's kernels in a profile (``kernel_families`` of its counts
    over ``steps`` steps) against ``per_step``: zero where it says none,
    else at most the count and at least 1 - PROFILE_LOST of it.  A lost
    event cannot raise a count, so one above fails at once; where one
    falls short, ``again()`` (a fresh profile of the same calls: its counts
    and steps) is read, up to PROFILE_RECOUNTS times, and each kernel
    keeps its most a step over the profiles."""
    per = {}
    for attempt in range(PROFILE_RECOUNTS + 1):
        if attempt:
            counts, steps = again()
        for name, n in kernel_families(counts, 1).items():
            want = per_step.get(name, 0) * steps
            if n > want:
                fail(f"{phase}: the profile read {n:g} {name} kernels over "
                     f"{steps} steps, more than {want}")
            per[name] = max(per.get(name, 0.0), n / steps)
        short = {k: v for k, v in per.items()
                 if v < per_step.get(k, 0) * (1 - PROFILE_LOST)}
        if not short:
            break
        if again is None or attempt == PROFILE_RECOUNTS:
            fail(f"{phase}: the profiles read {short} kernels a step, not "
                 f"{ {k: per_step[k] for k in short} }")
        print(f"{phase}: the profile read {short} kernels a step, short of "
              f"{ {k: per_step[k] for k in short} }: events lost; profiled "
              f"again", flush=True)
    per = {k: v for k, v in per.items() if v}
    print(f"{phase}: the port's kernels a step, by name in the profile: "
          f"{per}", flush=True)
    return per


def profile_calls(torch, fn, calls: int, steps_a_call: int):
    """``again`` of ``hold_profile``: a fresh profile of ``calls`` calls of
    ``fn``, each ``steps_a_call`` steps (a finished run's graphed step:
    the calls train its model on)."""
    def again():
        with profiled(torch) as prof:
            for _ in range(calls):
                fn()
        return prof["counts"], calls * steps_a_call
    return again


@contextlib.contextmanager
def observe_trainer(torch, profile_epoch=None):
    """Watch every ``Trainer`` built inside the block: each train epoch's
    stats (host seconds, steps, real edges and ``Trainer.epoch_log``'s
    host ms: packing, plans, the move to the card, the loop's wait, the
    step's call), and with ``profile_epoch`` a profile of that epoch's
    train loop and of the evaluation after it; ``again`` below reads a
    fresh profile of the same calls: the epoch's last train step call
    replayed (``rec["last_step"]``) or the evaluation (``eval_again``)."""
    from phc_gnn_torch.train.trainer import Trainer

    rec = {"epochs": [], "train_profile": None, "eval_profile": None}
    train_epoch, evaluate = Trainer._train_epoch, Trainer.evaluate
    pending = []

    def watched_train(self, epoch_seed, lr):
        epoch = len(self.epoch_log)
        if epoch != profile_epoch:
            out = train_epoch(self, epoch_seed, lr)
        else:
            step = self.train_step

            def kept(batches, lr_):  # the epoch's last call, to replay
                rec["last_step"] = (step, batches, lr_)
                return step(batches, lr_)

            self.train_step = kept
            try:
                with profiled(torch) as prof:
                    out = train_epoch(self, epoch_seed, lr)
            finally:
                self.train_step = step
            rec["train_profile"] = dict(prof, steps=out["steps"])
            pending.append(True)
        rec["epochs"].append({"epoch": epoch, **{
            k: v for k, v in out.items() if k != "train_metric"}})
        return out

    def watched_eval(self, batches):
        if not pending:
            return evaluate(self, batches)
        pending.clear()
        batches = list(batches)
        with profiled(torch) as prof:
            out = evaluate(self, batches)
        rec["eval_profile"] = dict(prof, batches=len(batches))
        rec["eval_again"] = profile_calls(
            torch, lambda: evaluate(self, batches), 1, len(batches))
        return out

    Trainer._train_epoch, Trainer.evaluate = watched_train, watched_eval
    try:
        yield rec
    finally:
        Trainer._train_epoch, Trainer.evaluate = train_epoch, evaluate


def replay_again(torch, rec, steps: int):
    """``again`` of ``hold_profile`` for ``observe_trainer``'s profiled
    epoch: its last train step call replayed for about ``steps`` steps."""
    step, batches, lr = rec["last_step"]
    return profile_calls(torch, lambda: step(batches, lr),
                         max(1, round(steps / len(batches))), len(batches))


def scalars(save_dir, run=1) -> list:
    import os

    with open(os.path.join(save_dir, f"run_{run}", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def harness_synthetic(torch, tmp):
    """The synthetic recipe through the CLI: 3 epochs at the flagship's
    convs; counters over the run, the profile of epoch 2's train loop and
    of the evaluation after it, the losses."""
    import os

    from phc_gnn_torch.cli.common import run_benchmark

    from phc_gnn_torch.cli.common import load_splits
    from phc_gnn_torch.data import compute_bucket_spec

    bucket = compute_bucket_spec(load_splits("synthetic", "")[0]["train"],
                                 FLAGSHIP["batch_size"])
    if (bucket.num_nodes, bucket.num_edges) != HARNESS_BUCKET:
        fail(f"harness synthetic: the train bucket is {bucket}, not "
             f"{HARNESS_BUCKET}")
    save = os.path.join(tmp, "synthetic")
    reset_launches()
    with observe_trainer(torch, HARNESS_PROFILED) as rec:
        run_benchmark("synthetic", ["--epochs", str(HARNESS_EPOCHS),
                                    "--save_dir", save])
    launches = read_launches()
    hold_counters("harness synthetic", launches,
                  add_counts((capture_calls(), SYNTH_STEP),
                             (capture_calls(), SYNTH_EVAL)))
    rows = scalars(save)
    if len(rows) != HARNESS_EPOCHS:
        fail(f"harness synthetic: {len(rows)} epochs, not {HARNESS_EPOCHS}")
    for r in rows:
        if not all(math.isfinite(r[k]) for k in ("train_loss", "valid_loss",
                                                 "valid_metric")):
            fail(f"harness synthetic: a loss is not finite: {r}")
    if not rows[2]["train_loss"] < rows[0]["train_loss"]:
        fail(f"harness synthetic: the train loss did not fall: "
             f"{[r['train_loss'] for r in rows]}")
    tp, ep = rec["train_profile"], rec["eval_profile"]
    steps = tp["steps"]
    per_step = hold_profile("harness synthetic train loop", tp["counts"],
                            SYNTH_STEP, steps, replay_again(torch, rec, steps))
    per_batch = hold_profile("harness synthetic eval", ep["counts"],
                             SYNTH_EVAL, ep["batches"], rec["eval_again"])
    epochs = []
    for r, e in zip(rows, rec["epochs"]):
        epochs.append({"epoch": r["epoch"], "wall_s": r["wall_s"],
                       "steps_per_s": r["steps_per_s"],
                       "edges_per_s": r["edges_per_s"],
                       "train_loop_s": e["seconds"], "steps": e["steps"],
                       "real_edges": e["edges"],
                       "ms_per_step": 1e3 * e["seconds"] / e["steps"],
                       "loader_ms_per_batch": e["loader_ms"],
                       "plan_ms_per_batch": e["plan_ms"],
                       "move_ms_per_batch": e["move_ms"],
                       "wait_ms_per_batch": e["wait_ms"],
                       "step_host_ms": e["step_host_ms"],
                       "train_loss": r["train_loss"],
                       "valid_loss": r["valid_loss"]})
        print(f"harness synthetic epoch {r['epoch']}"
              f"{' (graph captures inside)' if r['epoch'] == 0 else ''}: "
              f"{epochs[-1]}", flush=True)
    out = {"epochs": epochs, "launches": launches,
           "train_loop_profiled": {
               "epoch": HARNESS_PROFILED, "steps": steps,
               "wall_ms": tp["wall_ms"], "busy_ms": tp["busy_ms"],
               "idle_share": tp["idle_share"],
               "device_events_per_step": tp["events"] / steps,
               "port_kernels_per_step": per_step},
           "eval_profiled": {"batches": ep["batches"],
                             "wall_ms": ep["wall_ms"],
                             "busy_ms": ep["busy_ms"],
                             "idle_share": ep["idle_share"],
                             "port_kernels_per_batch": per_batch}}
    print(f"harness synthetic: epoch {HARNESS_PROFILED}'s train loop "
          f"{tp['wall_ms']:.3f} ms for {steps} steps, device busy "
          f"{tp['busy_ms']:.3f} ms, idle {tp['idle_share']:.2%}", flush=True)
    return launches, out


def checkpoint_tensors(torch, path) -> dict:
    """Every entry of a saved checkpoint, flattened to ``a/b/c`` keys."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    out = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}/")
        else:
            out[prefix] = tree
    walk(state, "")
    return out


def harness_resume(torch, tmp):
    """2 epochs, then a resume for 1, against 3 epochs straight, dropout
    on, both under torch's deterministic algorithms: every checkpointed
    entry, the scheduler's JSON and every scalars row (timings aside) must
    be bit-equal."""
    import os

    from phc_gnn_torch.cli.common import run_benchmark

    resumed, straight = (os.path.join(tmp, "resumed"),
                         os.path.join(tmp, "straight"))
    with deterministic(torch):
        run_benchmark("synthetic", ["--epochs", "2", "--save_dir", resumed])
        run_benchmark("synthetic", ["--epochs", "3", "--save_dir", resumed,
                                    "--resume"])
        run_benchmark("synthetic", ["--epochs", "3", "--save_dir", straight])
    step = os.path.join("run_1", "ckpt", "step_3.pt")
    got = checkpoint_tensors(torch, os.path.join(resumed, step))
    want = checkpoint_tensors(torch, os.path.join(straight, step))
    if sorted(got) != sorted(want):
        fail("harness resume: the checkpoints hold different entries")
    differ = [k for k, w in want.items()
              if not (torch_equal(got[k], w) if isinstance(w, torch.Tensor)
                      else got[k] == w)]
    if differ:
        fail(f"harness resume: {len(differ)} of {len(want)} checkpoint "
             f"entries differ from the straight run's, e.g. {differ[:5]}")
    for name in ("trainer_state.json", "val_test.json"):
        with open(os.path.join(resumed, "run_1", name)) as f:
            a = json.load(f)
        with open(os.path.join(straight, "run_1", name)) as f:
            b = json.load(f)
        if a != b:
            fail(f"harness resume: {name} differs: {a} against {b}")
    timing = ("wall_s", "steps_per_s", "edges_per_s")
    rows_a, rows_b = scalars(resumed), scalars(straight)
    if [{k: v for k, v in r.items() if k not in timing} for r in rows_a] != \
            [{k: v for k, v in r.items() if k not in timing} for r in rows_b]:
        fail(f"harness resume: the scalars rows differ: {rows_a} against "
             f"{rows_b}")
    n_tensors = sum(isinstance(w, torch.Tensor) for w in want.values())
    print(f"harness resume: 2 + 1 epochs against 3, bit-equal: {n_tensors} "
          f"tensors, the scheduler, {len(rows_a)} scalars rows", flush=True)
    return {"bit_equal_tensors": n_tensors, "entries": len(want),
            "rows": len(rows_a)}


@contextlib.contextmanager
def record_accum_calls(torch):
    """Record the calls of the accumulated steps that ``Trainer`` builds
    inside the block: their count, and for a group padded with a dummy
    (``make_dummy_batch``'s, tagged as made) the state before the call
    (device copies of the parameters, buffers and Adam tensors, Adam's
    count, the generator's state), its batches, lr and loss.  Other calls
    pass through untouched, so the epoch runs as it would."""
    from phc_gnn_torch.train import trainer as tr

    make, dummy = tr.make_accum_train_step, tr.make_dummy_batch
    rec = {"calls": 0}
    dummies = set()

    def tagged_dummy(batch):
        out = dummy(batch)
        dummies.add(id(out))
        return out

    def recording(model, optimizer, loss_fn, **kw):
        step = make(model, optimizer, loss_fn, **kw)
        state = ([p.data for p in model.parameters()] + list(model.buffers())
                 + optimizer.state_tensors())
        rec.update(model=model, opt=optimizer, loss_fn=loss_fn, kw=kw,
                   state=state, step=step)

        def call(batches, lr):
            rec["calls"] += 1
            if not any(id(b) in dummies for b in batches):
                return step(batches, lr)
            rec.update(before=[t.clone() for t in state],
                       count=optimizer.count,
                       generator=step.generator.get_state(),
                       batches=list(batches), lr=lr)
            loss, outs = step(batches, lr)
            rec["loss"] = loss
            return loss, outs

        call.generator = step.generator
        return call

    tr.make_accum_train_step, tr.make_dummy_batch = recording, tagged_dummy
    try:
        yield rec
    finally:
        tr.make_accum_train_step, tr.make_dummy_batch = make, dummy


def harness_pcba(torch, tmp):
    """The molpcba recipe through the CLI on the pcba parity task, 1 epoch:
    counters over the run (one graph a (K, bucket): 4 x the step's), the
    profile of the epoch's train loop (its 3 eager warm-ups, the capture
    and the replays), the dummy-padded last group against the eager body
    over its real sub-batches, the graphed step's ms."""
    import os

    from phc_gnn_torch.cli.common import run_benchmark
    from phc_gnn_torch.data.parity import generate_parity_dataset
    from phc_gnn_torch.train.state import _eager_accum_train_step

    t0 = time.perf_counter()
    root = generate_parity_dataset("pcba", os.path.join(tmp, "data"), seed=0)
    data_s = time.perf_counter() - t0
    save = os.path.join(tmp, "pcba")
    reset_launches()
    with record_accum_calls(torch) as rec, \
            observe_trainer(torch, 0) as obs:
        run_benchmark("pcba", HARNESS_PCBA + ["--data_root", root,
                                              "--save_dir", save])
    launches = read_launches()
    hold_counters("harness pcba", launches,
                  add_counts((capture_calls(), PCBA_LAUNCHES),
                             (capture_calls(), PCBA_EVAL_LAUNCHES)))
    rows = scalars(save)
    if not all(math.isfinite(r[k]) for r in rows
               for k in ("train_loss", "valid_loss", "valid_metric")):
        fail(f"harness pcba: a loss or metric is not finite: {rows}")
    tp = obs["train_profile"]
    calls = rec["calls"] + capture_calls() - 1
    per_step = hold_profile(
        "harness pcba train loop", tp["counts"],
        {"segment_sum_masked": 28, "segment_sum_perm": 28, "bn_forward": 36,
         "bn_backward": 36}, calls,
        profile_calls(torch, lambda: rec["step"](rec["batches"], rec["lr"]),
                      calls, 1))
    # the padded group: 3 real sub-batches and a dummy
    if "batches" not in rec:
        fail("harness pcba: no group was padded with a dummy")
    real = [b for b in rec["batches"] if bool(b.graph_mask.any())]
    if len(real) != PCBA_K - 1:
        fail(f"harness pcba: the last group holds {len(real)} real "
             f"sub-batches, not {PCBA_K - 1}")
    groups = rec["calls"]
    graph_loss = float(rec["loss"])
    torch._foreach_copy_(rec["state"], rec["before"])
    rec["opt"].count = rec["count"]
    eager = _eager_accum_train_step(rec["model"], rec["opt"], rec["loss_fn"],
                                    **rec["kw"])
    eager.generator.set_state(rec["generator"])
    eager_loss = float(eager(real, rec["lr"])[0])
    rel = abs(graph_loss - eager_loss) / abs(eager_loss)
    print(f"harness pcba: the padded last group's loss {graph_loss!r} "
          f"against the eager body over its {len(real)} real sub-batches "
          f"{eager_loss!r}: {rel:.3g} relative (tolerance {TOL_GROUP:g})",
          flush=True)
    if not rel <= TOL_GROUP:
        fail(f"harness pcba: the padded group's loss is {rel:.3g} from the "
             f"eager body's over its real sub-batches")
    # the graphed accumulated step, synced, as the card runs it (the run
    # is over: these calls train the model on)
    step_ms, step_host_ms = time_steps(
        torch, lambda: rec["step"](rec["batches"], rec["lr"]))
    print(f"harness pcba: the graphed accumulated step {step_ms:.3f} ms "
          f"(host {step_host_ms:.3f}); the epoch {rows[0]['steps_per_s']} "
          f"sub-batches/s", flush=True)
    out = {"data_s": data_s, "groups": groups, "launches": launches,
           "rows": rows, "group_loss": graph_loss,
           "group_loss_eager": eager_loss, "group_loss_rel_err": rel,
           "epoch0": obs["epochs"][0], "step_ms": step_ms,
           "step_host_ms": step_host_ms,
           "epoch0_profiled": {
               "wall_ms": tp["wall_ms"], "busy_ms": tp["busy_ms"],
               "idle_share": tp["idle_share"],
               "port_kernels_per_step": per_step},
           "steps_per_s": rows[0]["steps_per_s"],
           "edges_per_s": rows[0]["edges_per_s"]}
    return launches, out


def harness_zinc(torch, tmp):
    """The ZINC recipe through the CLI on the zinc parity task, 3 epochs,
    under torch's deterministic algorithms: C in both roles and no softmax
    kernel (counters over the run), epoch 1's train loop timed, epoch 2's
    profiled; then ``cli.inference`` restores run 1's best export and must
    reproduce ``test_bestval`` bit for bit."""
    import io
    import os

    from phc_gnn_torch.cli import inference
    from phc_gnn_torch.cli.common import run_benchmark
    from phc_gnn_torch.data.parity import generate_parity_dataset

    root = generate_parity_dataset("zinc", os.path.join(tmp, "zinc_data"),
                                   seed=0)
    save = os.path.join(tmp, "zinc")
    argv = HARNESS_ZINC + ["--data_root", root, "--save_dir", save]
    reset_launches()
    with deterministic(torch), observe_trainer(torch, 2) as obs:
        run_benchmark("zinc", argv)
    launches = read_launches()
    hold_counters("harness zinc", launches,
                  add_counts((capture_calls(), ZINC_STEP),
                             (capture_calls(), ZINC_EVAL)))
    rows = scalars(save)
    if not all(math.isfinite(r[k]) for r in rows
               for k in ("train_loss", "valid_loss", "valid_metric")):
        fail(f"harness zinc: a loss or metric is not finite: {rows}")
    tp = obs["train_profile"]
    per_step = hold_profile("harness zinc train loop", tp["counts"],
                            ZINC_STEP, tp["steps"],
                            replay_again(torch, obs, tp["steps"]))
    with open(os.path.join(save, "run_1", "val_test.json")) as f:
        val_test = json.load(f)
    with deterministic(torch), contextlib.redirect_stdout(io.StringIO()):
        result = inference.main(["zinc", "--run", "1"] + argv)
    if result["mae"] != val_test["test_bestval"]:
        fail(f"harness inference: {result['mae']!r} is not test_bestval "
             f"{val_test['test_bestval']!r}")
    print(f"harness inference: the best export's test mae "
          f"{result['mae']!r} == test_bestval, bit for bit", flush=True)
    e1 = obs["epochs"][1]
    out = {"launches": launches, "rows": rows, "val_test": val_test,
           "inference": result,
           "epoch1": {**e1, "ms_per_step": 1e3 * e1["seconds"] / e1["steps"]},
           "train_loop_profiled": {
               "epoch": 2, "steps": tp["steps"], "wall_ms": tp["wall_ms"],
               "busy_ms": tp["busy_ms"], "idle_share": tp["idle_share"],
               "port_kernels_per_step": per_step}}
    print(f"harness zinc: epoch 1 {out['epoch1']}, profiled train loop "
          f"busy {tp['busy_ms']:.3f} of {tp['wall_ms']:.3f} ms", flush=True)
    return launches, out


def harness_phase(torch, dev):
    """15. harness: the port's CLI in-process on the synthetic recipe, an
    exact resume, the molpcba and ZINC recipes on the parity datasets, and
    inference; a ``{"harness"}`` line.  Returns the launches of each run."""
    import tempfile

    paths, harness = {}, {}
    with tempfile.TemporaryDirectory(prefix="phc_harness_") as tmp:
        paths["harness_synthetic"], harness["synthetic"] = harness_synthetic(
            torch, tmp)
        harness["resume"] = harness_resume(torch, tmp)
        paths["harness_pcba"], harness["pcba"] = harness_pcba(torch, tmp)
        paths["harness_zinc"], harness["zinc"] = harness_zinc(torch, tmp)
    print(json.dumps({"harness": harness}), flush=True)
    return paths


# ------------------------------------------------------------------- 20. halo

HALO_SHARDS = (2, 4)
# one np flagship train step on one rank: the fused softmax and its backward
# once a conv, C's halo role as each conv's gather backward (C's gather role
# not at all), and D and E in the head alone (the layers' norms take the
# cross-shard inline formula)
HALO_STEP_LAUNCHES = {**SOFTMAX_TRAIN, "halo_gather_split_bwd": 4,
                      "bn_forward": 2, "bn_backward": 2}
# one replicated flagship train step on one rank: the composites and D and
# E at every norm (each rank normalises all the nodes, on the card)
EP_STEP_LAUNCHES = {"bn_forward": 10, "bn_backward": 10}
HALO_TIMED_STEPS = 5        # a rank's steps timed on the shared card
HALO_PAD_RUN = 1800         # masked edges on the last local row (a batch's
                            # padding tail is about that long)
# the Trainer's epoch: 120-graph batches make 35 of them, so the last dp
# group is padded with a dummy; an lr of 1e-9 leaves the weights where they
# are, so the two runs' losses differ by rounding alone, not by where Adam
# takes two runs whose gradients part in the last bits (at lr 5e-4 the
# epoch's train losses of the two runs part by ~2e-3 on an H100: Adam's
# steps are signs where a gradient is rounding noise, and they compound)
HALO_TRAINER = ["--epochs", "1", "--dropout_mpnn", "0,0,0,0",
                "--dropout_dn", "0,0", "--seed", "0", "--batch_size", "120",
                "--lr", "1e-9"]
TOL_TRAINER = 1e-5          # ... their epoch's train and valid loss


def halo_adversarial(torch, dev, case: str, d: int):
    """A node shard's sender plan over NS = 64 local rows and S * H = 2 * 16
    halo rows, with a cotangent on every edge: ``empty halo`` (every sender
    local, so the halo rows' sums are 0), ``all remote`` (every sender a
    halo row, the local sums 0) or ``padding run`` (real edges, and
    HALO_PAD_RUN masked edges whose sender is the last local row, in one
    run); returns ``(g, perm, rowptr, ns)``."""
    import numpy as np
    from phc_gnn_torch.graph.batch import build_sender_csr

    rng = np.random.default_rng(13)
    ns, rows, e = 64, 96, 600
    lo, hi = {"empty halo": (0, ns), "all remote": (ns, rows),
              "padding run": (0, rows)}[case]
    senders = rng.integers(lo, hi, size=e)
    mask = rng.random(e) > 0.2
    if case == "padding run":
        senders = np.concatenate([senders, np.full(HALO_PAD_RUN, ns - 1)])
        mask = np.concatenate([mask, np.zeros(HALO_PAD_RUN, bool)])
    perm, rowptr = build_sender_csr(senders.astype(np.int32), rows, mask)
    g = rng.normal(size=(senders.shape[0], d)).astype(np.float32)
    return (torch.from_numpy(g).to(dev), torch.from_numpy(perm).to(dev),
            torch.from_numpy(rowptr).to(dev), ns)


def halo_library(torch, dev, g, shard):
    """One ``index_add_`` of the real edges' cotangent rows into the
    augmented rows, its bytes (the cotangent rows, the sender plan, the
    output, each once) and its adds."""
    rows, d = shard.snd_rowptr.shape[0] - 1, g.shape[1]
    e_real = int(shard.snd_rowptr[-1])
    real = shard.snd_perm[:e_real].long()
    g_real, s_real = g[real], shard.senders[real].long()
    zeros = torch.zeros((rows, d), device=dev)
    nbytes = (e_real * d * g.element_size() + e_real * 4 + (rows + 1) * 4
              + rows * d * 4)
    return (lambda: zeros.clone().index_add_(0, s_real, g_real.float())), \
        nbytes, e_real * d


def halo_kernel(torch, dev, errs):
    """C's halo role (``halo_gather_split_bwd``) against its plain version
    on the card: shard 0 of the flagship batch cut in 2 and 4 (the main
    path's shapes), pcba's width 512 in 2, f32 and bf16 (bf16 rows against
    the plain version on the same rows and bit-equal to the f32 instance
    fed the upcast rows, and to C's bulk instance on them), and the
    adversarial plans; each output bit-equal on a second launch and to the
    sequential f32 sum in edge order.  Returns its timing record at the
    flagship's 2-shard shape, with the other shapes beside it (on bf16 rows
    both of C's instances)."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.ops import segment_sum as ssum
    from phc_gnn_torch.parallel import partition_nodes

    kname = "halo_gather_split_bwd"
    wrapper = ssum.halo_gather_split_bwd
    gen = torch.Generator().manual_seed(21)
    shards = {s: partition_nodes(synthetic_batch(seed=0, **FLAGSHIP), s)[0]
              .to(dev) for s in HALO_SHARDS}
    pcba = partition_nodes(pcba_batch(torch, 0, PCBA), 2)[0].to(dev)
    cases = {}
    for s, sh in shards.items():
        g = torch.randn((sh.num_edges, DIM), generator=gen).to(dev)
        cases[f"flagship S={s}"] = (g, sh.snd_perm, sh.snd_rowptr,
                                    sh.num_nodes)
    cases["pcba S=2 [512]"] = (
        torch.randn((pcba.num_edges, PCBA_DIM), generator=gen).to(dev),
        pcba.snd_perm, pcba.snd_rowptr, pcba.num_nodes)
    for case in ("empty halo", "all remote", "padding run"):
        cases[case] = halo_adversarial(torch, dev, case, DIM)
    for name, (g, perm, rowptr, ns) in list(cases.items()):
        for dtype in (torch.float32, torch.bfloat16):
            gv = g.to(dtype)
            label = f"{name}, {'bf16' if dtype == torch.bfloat16 else 'f32'}"
            before = (wrapper.launches, wrapper.launches_bf16)
            dx, dxr = wrapper(gv, perm, rowptr, ns)
            torch.cuda.synchronize()
            if (wrapper.launches, wrapper.launches_bf16) == before:
                fail(f"{kname} {label}: its launch counter did not move")
            out = torch.cat([dx, dxr])
            want = torch.cat(ssum.halo_gather_split_bwd_plain(
                gv.double() if dtype == torch.float32 else gv, perm, rowptr,
                ns))
            check(errs, kname, label, out, want, TOL_SUM)
            hold_sequential(torch, kname, label, out,
                            torch.cat(wrapper(gv, perm, rowptr, ns)),
                            torch.cat(ssum.halo_gather_split_bwd_plain(
                                gv.cpu(), perm.cpu(), rowptr.cpu(), ns)))
            if dtype == torch.bfloat16 and not torch.equal(
                    out, torch.cat(wrapper(gv.float(), perm, rowptr, ns))):
                fail(f"{kname} {label}: differs from the f32 instance on the "
                     f"upcast rows")
            if dtype == torch.bfloat16 and not all(
                    torch.equal(out, ssum.segment_sum_instance(
                        "perm", gv, perm, rowptr, True)) for _ in range(2)):
                fail(f"{kname} {label}: C's bulk instance differs")
            if name == "empty halo" and not bool((dxr == 0).all()):
                fail(f"{kname} {label}: an empty halo row is not 0")
            if name == "all remote" and not bool((dx == 0).all()):
                fail(f"{kname} {label}: a local row without edges is not 0")

    def timing(g, sh):
        library, nbytes, flops = halo_library(torch, dev, g, sh)
        fn = lambda: wrapper(g, sh.snd_perm, sh.snd_rowptr,  # noqa: E731
                             sh.num_nodes)
        plain = lambda: ssum.halo_gather_split_bwd_plain(  # noqa: E731
            g, sh.snd_perm, sh.snd_rowptr, sh.num_nodes)
        return fn, plain, library, nbytes, flops

    g2 = cases["flagship S=2"][0]
    rec = record(torch, kname, "phc_gnn_torch/csrc/segment_sum.cu",
                 "phc_gnn_tpu/ops/stream_scan.py:912", errs,
                 *timing(g2, shards[2]))
    rec["shape"] = {"edges": shards[2].num_edges, "rows":
                    shards[2].snd_rowptr.shape[0] - 1, "d": DIM}
    for label, g, sh in (("S4", cases["flagship S=4"][0], shards[4]),
                         ("bf16", g2.to(torch.bfloat16), shards[2]),
                         ("bf16_S4", cases["flagship S=4"][0].to(
                             torch.bfloat16), shards[4]),
                         ("pcba", cases["pcba S=2 [512]"][0], pcba)):
        fn, _, library, nbytes, _ = timing(g, sh)
        rec[label] = {"ms": time_eager(torch, fn),
                      "graph_ms": time_graph(torch, fn),
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bytes": nbytes,
                      "library_graph_ms": time_graph(torch, library),
                      "rows": sh.snd_rowptr.shape[0] - 1,
                      "edges": sh.num_edges, "d": g.shape[1]}
        if g.dtype == torch.bfloat16:
            rec[label]["instances_graph_ms"] = {
                key: time_graph(torch, lambda: ssum.segment_sum_instance(
                    "perm", g, sh.snd_perm, sh.snd_rowptr, bulk))
                for key, bulk in (("bulk", True), ("nobulk", False))}
        print(f"kernel {kname} at {label}: {rec[label]['ms'] * 1e3:.2f} us "
              f"per call, {rec[label]['graph_ms'] * 1e3:.2f} us device, bound "
              f"{rec[label]['bound_ms'] * 1e3:.2f} us, library "
              f"{rec[label]['library_graph_ms'] * 1e3:.2f} us device"
              + (", C's bulk instance / the one without it " + " / ".join(
                  f"{v * 1e3:.2f}" for v in
                  rec[label]["instances_graph_ms"].values()) + " us device"
                 if "instances_graph_ms" in rec[label] else ""), flush=True)
    return rec


def halo_numpy(tree):
    """Tensors (and dicts and lists of them) as numpy, for the queue."""
    if isinstance(tree, dict):
        return {k: halo_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [halo_numpy(v) for v in tree]
    return tree.detach().cpu().numpy() if hasattr(tree, "detach") else tree


def halo_rank_main(rank, world, port, jobs, out):
    """A rank process of the halo phase: it joins the gloo group over
    ``tcp://localhost:<port>`` and runs each job ``(name, kwargs)``, a
    ``rank_*`` function of this module, in turn; its results go to
    ``out`` as numpy."""
    import traceback

    try:
        import torch
        import torch.distributed as dist
        from phc_gnn_torch.parallel import initialize

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # as in the parent's checks: the pooling's index_add_ in a fixed order
        torch.use_deterministic_algorithms(True, warn_only=True)
        initialize("gloo", f"tcp://localhost:{port}", world, rank)
        try:
            res = [globals()[name](torch, rank, **kw) for name, kw in jobs]
            out.put((rank, halo_numpy(res), None))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported by the parent
        out.put((rank, None, traceback.format_exc()))


def run_halo_ranks(world: int, jobs, timeout: float = 600.0,
                   target=None) -> list:
    """Start ``world`` rank processes (``spawn``), run ``jobs`` on each and
    return their results in rank order; fails with a rank's traceback.
    ``target`` is the rank's entry, ``halo_rank_main`` (gloo) unless
    given."""
    import multiprocessing
    import queue
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=target or halo_rank_main,
                         args=(r, world, port, jobs, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, err = {}, None
    try:
        for _ in procs:
            rank, res, tb = out.get(timeout=timeout)
            if tb is not None:
                err = f"rank {rank} of {world} failed:\n{tb}"
                break
            results[rank] = res
    except queue.Empty:
        err = f"a rank of {world} gave no result in {timeout:.0f} s"
    finally:
        for p in procs:
            p.join(timeout=60 if err is None else 5)
            if p.is_alive():
                p.kill()
                p.join()
    if err is not None:
        fail(f"halo: {err}")
    return [results[r] for r in range(world)]


def halo_batch(torch, seed, shape):
    """The flagship batch of ``seed`` with its plans (a fully masked dummy
    of seed 0's where ``seed`` is None), on the host."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.parallel import make_dummy_batch

    batch = attach_csr_plan(synthetic_batch(
        seed=0 if seed is None else seed, **shape))
    return make_dummy_batch(batch) if seed is None else batch


def time_collectives(torch, step, mine, steps: int, sync) -> dict:
    """``steps`` more train steps with ``torch.distributed``'s
    ``all_reduce`` and ``all_to_all_single`` wrapped: the card synced
    before each call (what the step queued is not the collective's), the
    host clock around it.  Returns the host ms a step in the collectives
    and in the whole step (the syncs included), and the calls a step."""
    import torch.distributed as dist

    real = {"all_reduce": dist.all_reduce,
            "all_to_all_single": dist.all_to_all_single}
    spent = [0.0, 0]

    def wrap(fn):
        def collective(*args, **kw):
            sync()
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[0] += time.perf_counter() - t
                spent[1] += 1
        return collective

    try:
        for name, fn in real.items():
            setattr(dist, name, wrap(fn))
        sync()
        t = time.perf_counter()
        for _ in range(steps):
            step(mine, LR)
        sync()
        total = time.perf_counter() - t
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
    return {"collective_ms": spent[0] * 1e3 / steps,
            "step_ms": total * 1e3 / steps, "calls": spent[1] / steps,
            "share": spent[0] / total}


def rank_step(torch, rank, mesh, state, cfg, seeds, shape, device,
              timed=0, scheme="halo", collectives=False):
    """One train step of the flagship with dropout off on the ``(dp, ep)``
    ``mesh`` from ``state``: rank (d, e) holds shard e of the batch of
    ``seeds[d]`` (None: a dummy), a node shard (``scheme="halo"``) or an
    edge shard (``"replicated"``, the model's edges over ep), the ReLU
    pattern recorded, the wrappers' counters zeroed just before and read
    just after.  Returns the loss, the reduced gradients that reached
    Adam, the running stats and the parameters after the step, the ReLU
    masks, the counts and, after ``timed`` more steps, their host ms a
    step (the card is shared); with ``collectives`` as many steps again
    with the collectives timed (``time_collectives``)."""
    from phc_gnn_torch import parallel as P
    from phc_gnn_torch.models import PHCGNN
    from phc_gnn_torch.train import make_optimizer
    from phc_gnn_torch.train.loss import masked_l1

    dev = torch.device(device)
    dp, ep = mesh
    grid = P.make_mesh(dp, ep, "gloo")
    model = PHCGNN(**cfg, seed=0, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    replicated = scheme == "replicated"
    if ep > 1:
        (model.set_edge_axis if replicated else model.set_node_axis)("ep")
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=GRAD_CLIP)
    seen = {}
    adam_step = opt.step

    def recording_step(grads, lr):
        seen["grads"] = [g.detach().clone() for g in grads]
        adam_step(grads, lr)

    opt.step = recording_step
    d, e = divmod(rank, ep)
    mine = halo_batch(torch, seeds[d], shape)
    if ep > 1:
        mine = (P.edge_shard(mine, ep, e) if replicated
                else P.partition_nodes(mine, ep)[e])
    loss_fn = lambda out, b: masked_l1(out, b.y)  # noqa: E731
    kw = dict(weight_decay=WEIGHT_DECAY, device=dev)
    if replicated:
        step = (P.make_ep_train_step(model, opt, loss_fn, grid, **kw)
                if dp == 1 else P.make_dp_ep_train_step(
                    model, opt, loss_fn, grid, loss_name="l1", **kw))
    else:
        step = (P.make_np_train_step(model, opt, loss_fn, grid, **kw)
                if dp == 1 else P.make_dp_train_step(
                    model, opt, loss_fn, grid, loss_name="l1", **kw)
                if ep == 1 else P.make_dp_np_train_step(
                    model, opt, loss_fn, grid, loss_name="l1", **kw))
    relu = ReluReplay(torch).install(model)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    reset_launches()
    with relu.patched():
        loss, out = step(mine, LR)
    sync()
    launches = read_launches()
    res = {"loss": float(loss), "out": out,
           "grads": dict(zip(opt.params, seen["grads"])),
           "stats": {k: b.clone() for k, b in model.named_buffers()},
           "params": {k: p.detach().clone() for k, p in
                      model.named_parameters()},
           "relu": relu.recorded()["relu"], "launches": launches,
           "rows": mine.num_nodes, "halo_rows":
           0 if mine.halo_send is None else mine.halo_send.numel()}
    if timed:
        times = []
        for _ in range(timed):
            sync()
            t = time.perf_counter()
            step(mine, LR)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
        res["step_ms"] = times
        if collectives:
            res["collectives"] = time_collectives(torch, step, mine, timed,
                                                  sync)
    return res


def rank_trainer(torch, rank, argv, device):
    """The training CLI's Trainer on this rank (``cli.common.build_trainer``
    under the process group: the ``(dp, ep)`` mesh from ``--dp`` ``--ep``),
    run; returns the rows of ``scalars.jsonl`` that rank 0 wrote (None on
    the other ranks) and the counters over the run."""
    from phc_gnn_torch.cli.common import build_trainer, get_parser

    args = get_parser("synthetic").parse_args(argv)
    reset_launches()
    build_trainer("synthetic", args, device=device).run()
    launches = read_launches()
    return {"rows": scalars(args.save_dir) if rank == 0 else None,
            "launches": launches}


def halo_relu(results, mesh, row: int, n_nodes: int, replicated=False):
    """The ReLU masks of dp row ``row`` in the single-device call order: a
    node mask is its shards' masks joined in order (shard s holds the
    nodes [s * NS, (s + 1) * NS)) cut to the batch's rows; a head mask,
    and under the replicated scheme every mask (each rank holds every
    node), is rank (row, 0)'s."""
    import numpy as np
    import torch

    dp, ep = mesh
    ranks = [results[row * ep + e] for e in range(ep)]
    masks = []
    for i, m in enumerate(ranks[0]["relu"]):
        if m.shape[0] == ranks[0]["rows"] and not replicated:
            m = np.concatenate([r["relu"][i] for r in ranks])[:n_nodes]
        masks.append(torch.from_numpy(m))
    return masks


def halo_reference(torch, dev, base, seeds, shape, results, mesh,
                   replicated=False):
    """The single-device flagship step on the card for the real batches of
    ``seeds``, each with its dp row's ReLU pattern (``halo_relu``), from
    ``base``'s state (on the composite route for the replicated scheme),
    combined as the dp reduction combines them: the loss and gradients by
    ``loss_weight``, the running stats by real nodes.  Returns ``(loss,
    grads, stats)``."""
    from phc_gnn_torch.parallel import loss_weight
    from phc_gnn_torch.train import make_loss_and_grads
    from phc_gnn_torch.train.loss import masked_l1

    parts = []
    for row, seed in enumerate(seeds):
        if seed is None:
            continue
        batch = halo_batch(torch, seed, shape).to(dev)
        model = copy.deepcopy(base).set_composite(replicated)
        relu = ReluReplay(torch, {"relu": halo_relu(
            results, mesh, row, batch.num_nodes, replicated)}).install(model)
        with relu.patched():
            loss, _, grads = make_loss_and_grads(
                model, lambda out, b: masked_l1(out, b.y), WEIGHT_DECAY)(
                batch, LR)
        parts.append((loss_weight(batch, "l1"),
                      batch.node_mask.sum(dtype=torch.float32), loss, grads,
                      dict(model.named_buffers())))
    wsum = sum(p[0] for p in parts)
    nsum = sum(p[1] for p in parts)
    loss = sum(p[0] * p[2] for p in parts) / wsum
    grads = {k: sum(p[0] * p[3][k] for p in parts) / wsum for k in parts[0][3]}
    stats = {k: sum(p[1] * p[4][k] for p in parts) / nsum for k in parts[0][4]}
    return loss, grads, stats


def hold_halo(torch, dev, phase, base, results, mesh, seeds, shape,
              replicated=False):
    """A multi-rank step held to the single-device step on the card: every
    rank's parameters bit-equal; rank 0's loss (TOL_MODEL), each reduced
    gradient leaf (TOL_GRAD of the leaf's max; the biases a norm follows
    below TOL_NOISE of the largest gradient), the running stats (TOL_BN)
    against ``halo_reference``; and its Adam update, one fused Adam step
    from the same state and gradients on the card (TOL_UPDATE of the
    step)."""
    import numpy as np
    from phc_gnn_torch.train import make_optimizer

    r0 = results[0]
    for r in results[1:]:
        for k, p in r["params"].items():
            if not np.array_equal(p, r0["params"][k]):
                fail(f"{phase}: the ranks' {k} differ after the step")
    loss, grads, stats = halo_reference(torch, dev, base, seeds, shape,
                                        results, mesh, replicated)
    worst = {}
    _, worst["loss"] = leafwise(torch.tensor(r0["loss"]), loss)
    top = max(float(g.abs().max()) for g in grads.values())
    grad_errs, noise = {}, 0.0
    for k, g in grads.items():
        got = torch.from_numpy(r0["grads"][k])
        if shift_invariant(k):
            noise = max(noise, float(got.abs().max()) / top,
                        float(g.abs().max()) / top)
        else:
            grad_errs[k] = leafwise(got, g)[1]
    worst["grad"] = max(grad_errs.values())
    worst["grad_leaf"] = max(grad_errs, key=grad_errs.get)
    worst["noise_grad"] = noise
    worst["running_stats"] = max(
        leafwise(torch.from_numpy(r0["stats"][k]), s)[1]
        for k, s in stats.items())
    model = copy.deepcopy(base)
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=GRAD_CLIP)
    opt.step([torch.from_numpy(r0["grads"][k]).to(dev) for k in opt.params],
             LR)
    before = dict(base.named_parameters())
    upd, same = 0.0, True
    for k, p in model.named_parameters():
        got = torch.from_numpy(r0["params"][k]).double()
        want = p.detach().cpu().double()
        same = same and torch.equal(got, want)
        step = float((want - before[k].detach().cpu().double()).abs().max())
        err = float((got - want).abs().max())
        upd = max(upd, err / step if step > 0 else err)
    worst["update"], worst["update_bit_equal"] = upd, same
    print(f"{phase}: against the single-device step on the card with the "
          f"ranks' ReLU pattern: loss rel err {worst['loss']:.3e} (tolerance "
          f"{TOL_MODEL:g}), gradients per leaf <= {worst['grad']:.3e} on "
          f"{worst['grad_leaf']} (tolerance {TOL_GRAD:g}), the biases a norm "
          f"follows <= {noise:.3e} of the largest gradient (tolerance "
          f"{TOL_NOISE:g}), running stats <= {worst['running_stats']:.3e} "
          f"(tolerance {TOL_BN:g}); the ranks' Adam update against one Adam "
          f"step on their gradients {upd:.3e} (tolerance {TOL_UPDATE:g}, "
          f"bit-equal: {same}); every rank's parameters bit-equal",
          flush=True)
    if not (worst["loss"] <= TOL_MODEL and worst["grad"] <= TOL_GRAD
            and noise <= TOL_NOISE and worst["running_stats"] <= TOL_BN
            and upd <= TOL_UPDATE):
        fail(f"{phase}: disagrees with the single-device step: {worst}")
    return worst


def hold_trainer(phase, got, want_rows, kernel):
    """A multi-rank Trainer's epoch (rank 0's rows) against the
    single-device Trainer's: train and valid loss within TOL_TRAINER, and
    ``kernel`` launched on rank 0."""
    rows = got["rows"]
    rel = {k: abs(rows[0][k] - want_rows[0][k]) / abs(want_rows[0][k])
           for k in ("train_loss", "valid_loss")}
    print(f"{phase}: the synthetic recipe, 1 epoch ({HALO_TRAINER}), on dp 2 "
          f"x ep 2 ranks: train loss {rows[0]['train_loss']:.7f}, valid "
          f"{rows[0]['valid_loss']:.7f}; the single-device Trainer with "
          f"grad_accum 2: {want_rows[0]['train_loss']:.7f}, "
          f"{want_rows[0]['valid_loss']:.7f} (rel err {rel['train_loss']:.3e}, "
          f"{rel['valid_loss']:.3e}, tolerance {TOL_TRAINER:g}); {kernel} "
          f"launched {got['launches'][kernel]} times on rank 0", flush=True)
    if not (max(rel.values()) <= TOL_TRAINER and got["launches"][kernel] > 0):
        fail(f"{phase}: {rows} against {want_rows}")
    return {"rows": rows, "single_rows": want_rows, "rel_err": rel,
            "launches": got["launches"]}


def halo_phase(torch, dev):
    """20. halo: C's halo role against its plain version, then the
    multi-rank paths on gloo ranks that share the card, in two starts of
    rank processes: on 2 ranks the flagship's np step on 2 shards (and the
    collectives' share of it), the dp step with a dummy rank and the
    replicated scheme's ep step on 2 edge shards; on 4 the np step on 4
    shards, dp x ep in both schemes, and the Trainer on dp 2 x ep 2 in
    both schemes against the single-device Trainer with ``grad_accum`` 2
    (the composite route for the replicated one).  Returns (the launch
    counts of its main-path runs, its kernel record, its summary)."""
    import os
    import tempfile

    from phc_gnn_torch.cli.common import run_benchmark
    from phc_gnn_torch.models import PHCGNN

    seconds = {}
    t = time.perf_counter()
    rec = halo_kernel(torch, dev, {})
    seconds["kernel"] = time.perf_counter() - t
    cfg = flagship_config(dropout=False)
    base = PHCGNN(**cfg, seed=0, device=dev)
    randomize_eval_state(torch, base)
    state = {k: v.detach().cpu().numpy() for k, v in base.state_dict().items()}
    job = dict(state=state, cfg=cfg, shape=FLAGSHIP, device=str(dev))
    summary, paths = {"gloo_on_cuda": "the collectives take the card's "
                      "tensors (no host staging)"}, {}
    want = {k: HALO_STEP_LAUNCHES.get(k, 0) for k in counter_names()}
    want_ep = {k: EP_STEP_LAUNCHES.get(k, 0) for k in counter_names()}

    def hold_ep(res, mesh, seeds, name):
        phase = f"replicated {name}"
        if res[0]["launches"] != want_ep:
            fail(f"{phase}: rank 0 launched {res[0]['launches']}, not "
                 f"{want_ep}")
        paths[f"ep_{name}"] = res[0]["launches"]
        summary[f"ep_{name}"] = hold_halo(torch, dev, phase, base, res, mesh,
                                          seeds, FLAGSHIP, replicated=True)
        summary[f"ep_{name}"]["step_ms"] = res[0]["step_ms"]

    def hold_np(res, s):
        phase = f"halo np S={s}"
        if res[0]["launches"] != want:
            fail(f"{phase}: rank 0 launched {res[0]['launches']}, not {want}")
        paths[f"halo_np{s}"] = res[0]["launches"]
        summary[f"np{s}"] = hold_halo(torch, dev, phase, base, res, (1, s),
                                      [0], FLAGSHIP)
        summary[f"np{s}"]["step_ms"] = res[0]["step_ms"]
        summary[f"np{s}"]["halo_rows"] = res[0]["halo_rows"]
        if "collectives" in res[0]:
            summary[f"np{s}"]["collectives"] = res[0]["collectives"]

    with deterministic(torch), tempfile.TemporaryDirectory(
            prefix="phc_halo_") as tmp:
        t = time.perf_counter()
        res = run_halo_ranks(2, [
            ("rank_step", dict(job, mesh=(1, 2), seeds=[0],
                               timed=HALO_TIMED_STEPS, collectives=True)),
            ("rank_step", dict(job, mesh=(2, 1), seeds=[0, None])),
            ("rank_step", dict(job, mesh=(1, 2), seeds=[0],
                               timed=HALO_TIMED_STEPS,
                               scheme="replicated"))])
        seconds["ranks_2"] = time.perf_counter() - t
        hold_np([r[0] for r in res], 2)
        paths["halo_dp_dummy"] = res[0][1]["launches"]
        summary["dp_dummy"] = hold_halo(
            torch, dev, "halo dp 2, a dummy rank", base, [r[1] for r in res],
            (2, 1), [0, None], FLAGSHIP)
        hold_ep([r[2] for r in res], (1, 2), [0], "ep2")
        argv = HALO_TRAINER + ["--device", dev.type]
        rep_argv = argv + ["--dp", "2", "--ep", "2", "--ep_scheme",
                           "replicated"]
        t = time.perf_counter()
        res = run_halo_ranks(4, [
            ("rank_step", dict(job, mesh=(1, 4), seeds=[0],
                               timed=HALO_TIMED_STEPS)),
            ("rank_step", dict(job, mesh=(2, 2), seeds=[0, 1],
                               timed=HALO_TIMED_STEPS)),
            ("rank_trainer", dict(argv=argv + [
                "--dp", "2", "--ep", "2",
                "--save_dir", os.path.join(tmp, "ranks")], device=str(dev))),
            ("rank_step", dict(job, mesh=(2, 2), seeds=[0, 1],
                               timed=HALO_TIMED_STEPS,
                               scheme="replicated")),
            ("rank_trainer", dict(argv=rep_argv + [
                "--save_dir", os.path.join(tmp, "ep_ranks")],
                device=str(dev)))])
        seconds["ranks_4"] = time.perf_counter() - t
        hold_np([r[0] for r in res], 4)
        steps = [r[1] for r in res]
        paths["halo_dp_ep"] = steps[0]["launches"]
        summary["dp_ep"] = hold_halo(torch, dev, "halo dp 2 x ep 2", base,
                                     steps, (2, 2), [0, 1], FLAGSHIP)
        summary["dp_ep"]["step_ms"] = steps[0]["step_ms"]
        trainer = res[0][2]
        paths["halo_trainer"] = trainer["launches"]
        hold_ep([r[3] for r in res], (2, 2), [0, 1], "dp_ep")
        ep_trainer = res[0][4]
        paths["ep_trainer"] = ep_trainer["launches"]
        t = time.perf_counter()
        single = os.path.join(tmp, "single")
        run_benchmark("synthetic", argv + ["--grad_accum", "2",
                                           "--save_dir", single])
        want_rows = scalars(single)
        single_x = os.path.join(tmp, "single_xla")
        run_benchmark("synthetic", argv + ["--grad_accum", "2", "--agg_kernel",
                                           "xla", "--save_dir", single_x])
        want_x = scalars(single_x)
        seconds["single_trainer"] = time.perf_counter() - t
    summary["trainer"] = hold_trainer("halo trainer", trainer, want_rows,
                                      "halo_gather_split_bwd")
    summary["ep_trainer"] = hold_trainer("replicated trainer", ep_trainer,
                                         want_x, "bn_forward")
    summary["seconds"] = seconds
    summary["step_ms_note"] = ("each rank's host ms a step on one shared "
                               "card: not a scaling number")
    print(f"halo: seconds {seconds}", flush=True)
    return paths, rec, summary


# ------------------------------------------------------------------- 24. nccl

# the environment of a rank that shares the card over NCCL: NCCL refuses two
# ranks of one host on one GPU ("Duplicate GPU detected"), and takes a rank's
# host from NCCL_HOSTID where it is set, so each rank names a host of its
# own; the ranks then talk over NCCL's socket transport on loopback.  The
# heartbeat monitor and its dump check poll rank 0's store, which ends with
# rank 0: both off
NCCL_RANK_ENV = {"NCCL_SOCKET_IFNAME": "lo", "NCCL_IB_DISABLE": "1",
                 "TORCH_NCCL_ENABLE_MONITORING": "0",
                 "TORCH_NCCL_DUMP_ON_TIMEOUT": "0"}
# one dp flagship train step on one rank: the single-device step's kernels
DP_STEP_LAUNCHES = dict(TRAIN_LAUNCHES)
NCCL_TIMED_STEPS = 5        # a rank's eager steps and replays timed
NCCL_PROFILES = 1 + PROFILE_RECOUNTS  # rank 0's profiles of one replay each
NCCL_DROPOUT_STEPS = 2      # steps with dropout, eager and graphed
TOL_NCCL_GRAPH = 0.0        # graphed against eager on the same NCCL ranks:
                            # bit-equal on 2 and on 4 ranks (two H100 runs
                            # read 0.0 at 4, where the reduction's order
                            # could have differed, and did not)


def nccl_rank_main(rank, world, port, jobs, out):
    """A rank process of the nccl phase: it names a host of its own to
    NCCL (``NCCL_HOSTID``) and its transport (``NCCL_RANK_ENV``) in its own
    environment, joins the NCCL group over ``tcp://localhost:<port>`` on
    cuda:0 and runs each job ``(name, kwargs)`` as ``halo_rank_main`` does.
    It ends with ``os._exit`` once its results are sent: tearing down a
    communicator of ranks that share one card hangs."""
    import os
    import traceback

    os.environ.update(NCCL_RANK_ENV, NCCL_HOSTID=f"phc-smoke-rank-{rank}")
    try:
        import torch
        from phc_gnn_torch.parallel import initialize

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.cuda.set_device(0)
        initialize("nccl", f"tcp://localhost:{port}", world, rank)
        res = [globals()[name](torch, rank, **kw) for name, kw in jobs]
        out.put((rank, halo_numpy(res), None))
    except BaseException:  # noqa: BLE001 - reported by the parent
        out.put((rank, None, traceback.format_exc()))
    out.close()
    out.join_thread()
    os._exit(0)


def rank_graphed(torch, rank, mesh, state, cfg, drop_cfg, seeds, shape,
                 scheme="halo", device="cuda:0"):
    """The flagship's step on the ``(dp, ep)`` NCCL ``mesh``, as
    ``rank_step`` lays it out, eager and graphed from one state: the eager
    step runs the same NCCL groups through a copy of the mesh relabelled
    so that ``parallel.dp.graphed_on`` declines it.  With dropout off: the
    eager step (ReLU pattern recorded, the counters zeroed just before and
    read just after), then the graphed step's first call (warm-ups,
    capture, one replay), the state after each; rank 0 profiles
    ``NCCL_PROFILES`` more replays, one each, while every rank replays;
    then ``NCCL_TIMED_STEPS`` eager steps and replays, host clock around
    each, the card synced.  With dropout (``drop_cfg``):
    ``NCCL_DROPOUT_STEPS`` eager steps and graphed steps from the state,
    their losses and parameters.  On the CPU (a rehearsal) the mesh is
    gloo's and both steps are eager."""
    import dataclasses

    from phc_gnn_torch import parallel as P
    from phc_gnn_torch.models import PHCGNN
    from phc_gnn_torch.train import make_optimizer
    from phc_gnn_torch.train.loss import masked_l1

    dev = torch.device(device)
    dp, ep = mesh
    grid = P.make_mesh(dp, ep, "nccl" if dev.type == "cuda" else "gloo")
    eager_grid = dataclasses.replace(grid, backend="eager")
    replicated = scheme == "replicated"
    d, e = divmod(rank, ep)
    mine = halo_batch(torch, seeds[d], shape)
    if ep > 1:
        mine = (P.edge_shard(mine, ep, e) if replicated
                else P.partition_nodes(mine, ep)[e])
    loss_fn = lambda out, b: masked_l1(out, b.y)  # noqa: E731

    def build(config, g):
        model = PHCGNN(**config, seed=0, device="cpu")
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
        if ep > 1:
            (model.set_edge_axis if replicated else model.set_node_axis)("ep")
        opt = make_optimizer(dict(model.named_parameters()),
                             grad_clip=GRAD_CLIP)
        seen, adam_step = {}, opt.step

        def recording_step(grads, lr):
            seen["grads"] = [gr.detach().clone() for gr in grads]
            adam_step(grads, lr)

        opt.step = recording_step
        kw = dict(weight_decay=WEIGHT_DECAY, device=dev)
        if replicated:
            step = (P.make_ep_train_step(model, opt, loss_fn, g, **kw)
                    if dp == 1 else P.make_dp_ep_train_step(
                        model, opt, loss_fn, g, loss_name="l1", **kw))
        else:
            step = (P.make_np_train_step(model, opt, loss_fn, g, **kw)
                    if dp == 1 else P.make_dp_train_step(
                        model, opt, loss_fn, g, loss_name="l1", **kw)
                    if ep == 1 else P.make_dp_np_train_step(
                        model, opt, loss_fn, g, loss_name="l1", **kw))
        return model, opt, step, seen

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def after(model, opt, loss, seen):
        sync()
        # the gradients a graph's replays overwrite: copied
        return {"loss": float(loss),
                "grads": {k: g.clone() for k, g in zip(opt.params,
                                                       seen["grads"])},
                "stats": {k: b.clone() for k, b in model.named_buffers()},
                "params": {k: p.detach().clone() for k, p in
                           model.named_parameters()}}

    def timed(step):
        times = []
        for _ in range(NCCL_TIMED_STEPS):
            sync()
            t = time.perf_counter()
            step(mine, LR)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
        return times

    model, opt, step, seen = build(cfg, eager_grid)
    relu = ReluReplay(torch).install(model)
    sync()
    reset_launches()
    with relu.patched():
        loss, _ = step(mine, LR)
    sync()
    launches = read_launches()
    eager = after(model, opt, loss, seen)
    eager_ms = timed(step)
    model, opt, step, seen = build(cfg, grid)
    loss, _ = step(mine, LR)
    graphed = after(model, opt, loss, seen)
    profiles = []
    for _ in range(NCCL_PROFILES):
        if rank == 0:
            with profiled(torch) as prof:
                step(mine, LR)
            profiles.append(prof["counts"])
        else:
            step(mine, LR)
            sync()
    graphed_ms = timed(step)
    dropout = {}
    for name, g in (("eager", eager_grid), ("graphed", grid)):
        model, opt, step, _ = build(drop_cfg, g)
        losses = [float(step(mine, LR)[0])
                  for _ in range(NCCL_DROPOUT_STEPS)]
        dropout[name] = {"losses": losses, "params": {
            k: p.detach().clone() for k, p in model.named_parameters()}}
    return {"eager": dict(eager, relu=relu.recorded()["relu"],
                          rows=mine.num_nodes),
            "graphed": graphed, "launches": launches, "profiles": profiles,
            "eager_ms": eager_ms, "graphed_ms": graphed_ms,
            "dropout": dropout}


def state_apart(a: dict, b: dict) -> float:
    """The largest difference of two steps' loss, gradients, running stats
    and parameters (numpy, as the ranks return them; those of them that
    ``a`` holds), relative to each tensor's own largest entry; 0.0 where
    every one is bit-equal."""
    import numpy as np

    worst = (abs(a["loss"] - b["loss"]) / max(abs(b["loss"]), 1e-30)
             if "loss" in a else 0.0)
    for part in ("grads", "stats", "params"):
        for k, x in a.get(part, {}).items():
            y = b[part][k]
            if not np.array_equal(x, y):
                worst = max(worst, float(np.abs(x - y).max())
                            / max(float(np.abs(y).max()), 1e-30))
    return worst


def profile_launches(launches: dict) -> dict:
    """An eager step's counters as the profile names its kernels: C's
    halo role launches C's gather kernel (``segment_sum_perm``'s)."""
    out = dict(launches)
    out["segment_sum_perm"] = (out.get("segment_sum_perm", 0)
                               + out.pop("halo_gather_split_bwd", 0))
    return {k: v for k, v in out.items() if v}


def hold_nccl(torch, dev, phase, base, res, mesh, seeds, want, replicated):
    """One graphed NCCL step of ``rank_graphed`` (``res`` in rank order):
    rank 0's eager counters equal ``want``; on every rank the graphed step
    against the eager one (loss, gradients, stats, parameters) bit-equal:
    on 2 ranks a sum of two is order-free, and on 4 NCCL sums in one order
    in and out of a graph (TOL_NCCL_GRAPH); the graphed step against the
    single-device step on the
    card (``hold_halo``, the eager ReLU pattern replayed); with dropout,
    the replays' losses and parameters against the eager steps' (the same
    masks drawn: the same bound); the kernels of one replay on rank 0, read
    from its profiles, equal to the eager counters; rank 0's eager and
    graphed ms a step."""
    import numpy as np

    r0 = res[0]
    if r0["launches"] != want:
        fail(f"{phase}: rank 0's eager step launched {r0['launches']}, not "
             f"{want}")
    tol = TOL_NCCL_GRAPH
    apart = max(state_apart(r["graphed"], r["eager"]) for r in res)
    hold_scan(phase, apart, tol, "graphed against eager on the same NCCL "
              "ranks, dropout off: loss, gradients, stats and parameters, "
              "worst relative to a tensor's largest, over every rank")
    drop = 0.0
    for r in res:
        e, g = r["dropout"]["eager"], r["dropout"]["graphed"]
        drop = max(drop, max(abs(x - y) / abs(y) for x, y in
                             zip(g["losses"], e["losses"])),
                   state_apart({"params": g["params"]},
                               {"params": e["params"]}))
    hold_scan(phase, drop, tol, f"{NCCL_DROPOUT_STEPS} steps with dropout, "
              f"replays against eager steps (the eager masks drawn): "
              f"losses and parameters")
    moved = abs(r0["dropout"]["eager"]["losses"][0]
                - r0["dropout"]["eager"]["losses"][1])
    if not moved > 0:
        fail(f"{phase}: two dropout steps gave one loss")
    graphed = [dict(r["graphed"], relu=r["eager"]["relu"],
                    rows=r["eager"]["rows"]) for r in res]
    summary = hold_halo(torch, dev, f"{phase}, graphed", base, graphed, mesh,
                        seeds, FLAGSHIP, replicated=replicated)
    rounds = iter(r0["profiles"][1:])
    per = hold_profile(f"{phase}, one replay on rank 0",
                       r0["profiles"][0], profile_launches(want), 1,
                       again=lambda: (next(rounds), 1))
    eager_ms = statistics.median(r0["eager_ms"])
    graphed_ms = statistics.median(r0["graphed_ms"])
    print(f"{phase}: rank 0's eager step {eager_ms:.2f} ms, graphed "
          f"{graphed_ms:.2f} ms (medians of {NCCL_TIMED_STEPS}, host clock, "
          f"card synced; {len(res)} ranks time-sliced on one card over a "
          f"loopback socket: not a scaling number)", flush=True)
    summary.update(graphed_vs_eager=apart, graphed_bit_equal=apart == 0.0,
                   dropout_vs_eager=drop, replay_kernels=per,
                   eager_ms=r0["eager_ms"], graphed_ms=r0["graphed_ms"])
    return summary


def run_nccl_single(torch, argv):
    """The single-device Trainer with ``grad_accum`` 2: the rows of its
    ``scalars.jsonl`` (``halo_phase``'s reference, run again where the
    phase runs alone)."""
    import tempfile

    from phc_gnn_torch.cli.common import run_benchmark

    with tempfile.TemporaryDirectory(prefix="phc_nccl_") as tmp:
        run_benchmark("synthetic", argv + ["--grad_accum", "2",
                                           "--save_dir", tmp])
        return scalars(tmp)


def nccl_phase(torch, dev, single_rows=None):
    """24. nccl: the multi-rank steps graphed on NCCL ranks that share the
    card (``nccl_rank_main``), in two starts of rank processes: on 2 ranks
    the np step on 2 shards, the dp step with a dummy rank and the
    replicated ep step on 2 edge shards; on 4 dp x ep in both schemes and
    the Trainer on dp 2 x ep 2 in both schemes (graphed steps and evals),
    against the single-device Trainer with ``grad_accum`` 2
    (``single_rows``: ``halo_phase``'s, else run here).  Each step is held
    by ``hold_nccl``.  Returns (the launch counts of its main-path runs,
    its summary)."""
    import os
    import tempfile

    from phc_gnn_torch.models import PHCGNN

    seconds, paths, summary = {}, {}, {}
    cfg = flagship_config(dropout=False)
    base = PHCGNN(**cfg, seed=0, device=dev)
    randomize_eval_state(torch, base)
    state = {k: v.detach().cpu().numpy() for k, v in base.state_dict().items()}
    job = dict(state=state, cfg=cfg, drop_cfg=flagship_config(dropout=True),
               shape=FLAGSHIP, device=str(dev))
    wants = {name: {k: counts.get(k, 0) for k in counter_names()}
             for name, counts in (("halo", HALO_STEP_LAUNCHES),
                                  ("dp", DP_STEP_LAUNCHES),
                                  ("ep", EP_STEP_LAUNCHES))}

    def hold(name, res, mesh, seeds, want, replicated=False):
        paths[f"nccl_{name}"] = res[0]["launches"]
        summary[name] = hold_nccl(torch, dev, f"nccl {name}", base, res, mesh,
                                  seeds, wants[want], replicated)

    argv = HALO_TRAINER + ["--device", dev.type]
    rep_argv = argv + ["--agg_kernel", "xla"]
    with deterministic(torch), tempfile.TemporaryDirectory(
            prefix="phc_nccl_") as tmp:
        t = time.perf_counter()
        res = run_halo_ranks(2, [
            ("rank_graphed", dict(job, mesh=(1, 2), seeds=[0])),
            ("rank_graphed", dict(job, mesh=(2, 1), seeds=[0, None])),
            ("rank_graphed", dict(job, mesh=(1, 2), seeds=[0],
                                  scheme="replicated"))],
            target=nccl_rank_main)
        seconds["ranks_2"] = time.perf_counter() - t
        hold("np2", [r[0] for r in res], (1, 2), [0], "halo")
        hold("dp_dummy", [r[1] for r in res], (2, 1), [0, None], "dp")
        hold("ep2", [r[2] for r in res], (1, 2), [0], "ep", replicated=True)
        t = time.perf_counter()
        res = run_halo_ranks(4, [
            ("rank_graphed", dict(job, mesh=(2, 2), seeds=[0, 1])),
            ("rank_graphed", dict(job, mesh=(2, 2), seeds=[0, 1],
                                  scheme="replicated")),
            ("rank_trainer", dict(argv=argv + [
                "--dp", "2", "--ep", "2",
                "--save_dir", os.path.join(tmp, "ranks")], device=str(dev))),
            ("rank_trainer", dict(argv=argv + [
                "--dp", "2", "--ep", "2", "--ep_scheme", "replicated",
                "--save_dir", os.path.join(tmp, "ep_ranks")],
                device=str(dev)))],
            target=nccl_rank_main)
        seconds["ranks_4"] = time.perf_counter() - t
        hold("dp_ep", [r[0] for r in res], (2, 2), [0, 1], "halo")
        hold("ep_dp_ep", [r[1] for r in res], (2, 2), [0, 1], "ep",
             replicated=True)
        paths["nccl_trainer"] = res[0][2]["launches"]
        paths["nccl_ep_trainer"] = res[0][3]["launches"]
        t = time.perf_counter()
        want_rows, want_x = single_rows or (run_nccl_single(torch, argv),
                                            run_nccl_single(torch, rep_argv))
        seconds["single_trainer"] = time.perf_counter() - t
    summary["trainer"] = hold_trainer("nccl trainer", res[0][2], want_rows,
                                      "halo_gather_split_bwd")
    summary["ep_trainer"] = hold_trainer("nccl replicated trainer",
                                         res[0][3], want_x, "bn_forward")
    summary["seconds"] = seconds
    summary["step_ms_note"] = ("rank 0's host ms a step, ranks time-sliced "
                               "on one shared card over a loopback socket: "
                               "not a scaling number")
    print(f"nccl: seconds {seconds}", flush=True)
    return paths, summary


# -------------------------------------------------------------------- 21. xla

# one flagship train step on the composite route: no A, B or C (the
# aggregations and the gather's backward run in plain PyTorch), D and E as on
# the plan route; its eval forward and PNA's launch none of the port's kernels
XLA_STEP_LAUNCHES = {"bn_forward": 10, "bn_backward": 10}
XLA_TURNS = ("plan", "xla", "xla", "plan")
XLA_PROFILED_CALLS = 2      # graphed calls profiled a turn


def xla_batches(torch, dev, n: int, plan: bool):
    """The flagship batches of seeds 0..n-1, with their CSR plans for the
    plan route or without (the composite route reads none): ``(host,
    on the card)``."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan

    host = [synthetic_batch(seed=s, **FLAGSHIP) for s in range(n)]
    if plan:
        host = [attach_csr_plan(b) for b in host]
    return host, [b.to(dev) for b in host]


def xla_flagship(torch, dev, dropout: bool):
    """The flagship on the composite route (``agg_kernel="xla"``)."""
    from phc_gnn_torch.models import PHCGNN

    return PHCGNN(**flagship_config(dropout), composite=True, seed=0,
                  device=dev)


def route_agreement(torch, phase, model, batch, plan_batch, loss_fn, f32_err):
    """One dropout-free forward and backward of ``model`` (on the composite
    route) against a copy on the plan route, both on the card: the
    composite run's ReLU pattern replayed on the plan run (a ReLU within
    rounding of 0 can switch between the routes' sums), then the loss and
    the output (TOL_MODEL), every gradient leaf under the rule of 5
    (``hold_grads``: TOL_GRAD of its max, or COND_GRAD times ``f32_err``,
    the CPU's own f32 error of the leaf against float64, up to
    TOL_GRAD_CAP: a softmax beta's gradient is a sum that cancels; the
    biases a norm follows below TOL_NOISE of the largest gradient) and the
    running stats (TOL_BN).  The flagship's softmax takes its max
    detached, so JAX's two tie rules (the composite splits a tied
    extreme's cotangent, the plan route does not) do not meet here."""
    from phc_gnn_torch.train import make_loss_and_grads

    plan = copy.deepcopy(model).set_composite(False)
    relu = ReluReplay(torch).install(model)
    with relu.patched():
        loss, out, grads = make_loss_and_grads(model, loss_fn, WEIGHT_DECAY)(
            batch, LR)
    p_relu = ReluReplay(torch, relu.recorded()).install(plan)
    with p_relu.patched():
        p_loss, p_out, p_grads = make_loss_and_grads(
            plan, loss_fn, WEIGHT_DECAY)(plan_batch, LR)
    torch.cuda.synchronize()
    worst = {}
    _, worst["loss"] = leafwise(loss, p_loss)
    _, worst["out"] = normwise(out.cpu(), p_out.cpu())
    if not (worst["loss"] <= TOL_MODEL and worst["out"] <= TOL_MODEL):
        fail(f"{phase}: loss or output disagrees with the plan route: "
             f"{worst}")
    hold_grads(phase, grads, p_grads, f32_err, worst)
    bufs = dict(plan.named_buffers())
    worst["running_stats"] = max(leafwise(b, bufs[k])[1]
                                 for k, b in model.named_buffers())
    print(f"{phase}: one dropout-free step on the card, composite route "
          f"against the plan route with its ReLU pattern: loss rel err "
          f"{worst['loss']:.3e}, output normwise {worst['out']:.3e} "
          f"(tolerance {TOL_MODEL:g}), gradients per leaf <= "
          f"{worst['grad']:.3e} on {worst['grad_leaf']} (its CPU f32 error "
          f"{worst['grad_leaf_f32_err']:.3e}; {grad_rule(worst)}), the "
          f"biases a norm follows <= {worst['noise_grad']:.3e} of the "
          f"largest gradient (tolerance {TOL_NOISE:g}), running stats <= "
          f"{worst['running_stats']:.3e} (tolerance {TOL_BN:g})", flush=True)
    if not worst["running_stats"] <= TOL_BN:
        fail(f"{phase}: running stats disagree with the plan route: "
             f"{worst}")
    return worst


def eval_against_plan(torch, phase, model, batches, plan_batches):
    """The eval forward of ``model`` (composite route) against a copy on
    the plan route on the card, batch by batch, normwise (TOL_MODEL)."""
    from phc_gnn_torch.train import make_eval_step

    plan = make_eval_step(copy.deepcopy(model).set_composite(False),
                          device=batches[0].senders.device)
    step = make_eval_step(model, device=batches[0].senders.device)
    errs = [normwise(step(b).cpu(), plan(pb).cpu())[1]
            for b, pb in zip(batches, plan_batches)]
    print(f"{phase}: composite route against the plan route on the card, "
          f"normwise per batch {[f'{e:.3e}' for e in errs]} (tolerance "
          f"{TOL_MODEL:g})", flush=True)
    if not max(errs) <= TOL_MODEL:
        fail(f"{phase}: the composite eval disagrees with the plan route")
    return max(errs)


def xla_turns(torch, dev, loss_fn, batches, plan_batches):
    """The flagship's graphed steps (``SCAN_STEPS`` a call) and graphed
    eval (``N_BATCHES`` a call) on the plan route and the composite route
    in one process, in turns (XLA_TURNS), from one random state: ms a step
    or batch (CUDA events, ``time_scan``), and from a profile of
    XLA_PROFILED_CALLS calls the kernels a step, device busy and idle, the
    port's kernels a step by name and the top kernels."""
    from phc_gnn_torch.train import (make_optimizer, make_scan_eval_steps,
                                     make_scan_train_steps)

    base = xla_flagship(torch, dev, True)
    randomize_eval_state(torch, base)
    out = {"plan": [], "xla": []}
    for route in XLA_TURNS:
        model = copy.deepcopy(base).set_composite(route == "xla")
        opt = make_optimizer(dict(model.named_parameters()),
                             grad_clip=GRAD_CLIP)
        steps = make_scan_train_steps(model, opt, loss_fn,
                                      weight_decay=WEIGHT_DECAY, seed=0,
                                      device=dev)
        evals = make_scan_eval_steps(model, device=dev)
        bs = batches if route == "xla" else plan_batches
        rec = {}
        for what, fn, per in (
                ("step", lambda: steps(bs, LR), len(bs)),
                ("eval", lambda: evals(bs[:N_BATCHES]), N_BATCHES)):
            ms, host_ms = time_scan(torch, fn, per)
            prof = device_profile(torch, fn, ms * per,
                                  iters=XLA_PROFILED_CALLS)
            calls = XLA_PROFILED_CALLS * per
            fam = kernel_families(prof["counts"], calls)
            rec[what] = {"ms": ms, "host_ms": host_ms,
                         "kernels": prof["kernels_per_call"] / per,
                         "busy_ms": prof["busy_ms"] / per,
                         "idle_share": prof["idle_share"],
                         "port_kernels": {k: v for k, v in fam.items() if v},
                         "top_us": [[n, us / per] for n, us in
                                    prof["top_us"][:8]]}
            print(f"xla turn {route} {what}: {ms:.3f} ms per {what} (host "
                  f"{host_ms:.3f}), {rec[what]['kernels']:g} kernels, busy "
                  f"{rec[what]['busy_ms']:.3f} ms (idle "
                  f"{100 * prof['idle_share']:.1f} %); the port's kernels a "
                  f"{what} {rec[what]['port_kernels']}", flush=True)
        out[route].append(rec)
        if route == "xla":
            got = rec["step"]["port_kernels"]
            if got != {k: float(v) for k, v in XLA_STEP_LAUNCHES.items()}:
                fail(f"xla turn: the graphed step ran {got} of the port's "
                     f"kernels a step, not {XLA_STEP_LAUNCHES}")
            if rec["eval"]["port_kernels"]:
                fail(f"xla turn: the graphed eval ran "
                     f"{rec['eval']['port_kernels']}")
        del steps, evals, model, opt
    return out


def xla_phase(torch, dev):
    """21. xla: the flagship at full width on the composite route
    (``agg_kernel="xla"``, batches without CSR plans); returns the launch
    counts of its main-path runs and the readings."""
    from phc_gnn_torch.train import (make_optimizer, make_scan_train_steps,
                                     masked_l1)

    def loss_fn(out, b):
        return masked_l1(out, b.y)

    def build(dropout):
        return xla_flagship(torch, dev, dropout)

    host, batches = xla_batches(torch, dev, SCAN_STEPS, plan=False)
    _, plan_batches = xla_batches(torch, dev, SCAN_STEPS, plan=True)
    info, paths = {}, {}
    # the main path: the graphed steps as they train, dropout on
    model = build(True)
    randomize_eval_state(torch, model)
    opt = make_optimizer(dict(model.named_parameters()), grad_clip=GRAD_CLIP)
    steps = make_scan_train_steps(model, opt, loss_fn,
                                  weight_decay=WEIGHT_DECAY, seed=0,
                                  device=dev)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses, _ = steps(batches, LR)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    paths["xla_train"] = read_launches()
    hold_counters("xla flagship graphed steps", paths["xla_train"],
                  add_counts((capture_calls(), XLA_STEP_LAUNCHES)))
    print(f"xla flagship: the first graphed call under "
          f"set_sync_debug_mode('error'), losses "
          f"{[round(float(x), 5) for x in losses]}", flush=True)
    if not bool(torch.isfinite(losses).all()):
        fail("xla flagship: non-finite loss")
    del steps, model, opt
    f32_err = {}
    info["vs_cpu"] = agreement(torch, dev, host[0], batches[0], loss_fn,
                               build=build, phase="xla train vs CPU",
                               f32_out=f32_err)
    m = build(False)
    randomize_eval_state(torch, m)  # the weights agreement's model had
    info["vs_plan"] = route_agreement(torch, "xla train vs plan route", m,
                                      batches[0], plan_batches[0], loss_fn,
                                      f32_err)
    info["scan"], _ = scan_train_check(torch, dev, "xla scan", build,
                                       loss_fn, WEIGHT_DECAY, LR,
                                       batches[:SCAN_FAMILY_STEPS])
    served = build(True)
    randomize_eval_state(torch, served)
    paths["xla_eval"], _, _ = eval_vs_cpu(torch, dev, served,
                                          host[:N_BATCHES], "xla eval", {})
    info["eval_vs_plan"] = eval_against_plan(
        torch, "xla eval", served, batches[:N_BATCHES],
        plan_batches[:N_BATCHES])
    info["eval_scan"] = scan_eval_check(torch, dev, "xla graphed eval",
                                        served, batches[:N_BATCHES])
    pna, _, _ = pna_model(torch, dev)
    randomize_eval_state(torch, pna)
    pna.set_composite(True)
    paths["xla_pna_eval"], _, _ = eval_vs_cpu(
        torch, dev, pna, host[:N_BATCHES], "xla pna eval", {})
    info["pna_eval_vs_plan"] = eval_against_plan(
        torch, "xla pna eval", pna, batches[:N_BATCHES],
        plan_batches[:N_BATCHES])
    info["turns"] = xla_turns(torch, dev, loss_fn, batches, plan_batches)
    print(json.dumps({"xla": info}), flush=True)
    return paths, info


EXPORT_CALLS = {"f32": {"phc_gnn.segment_softmax_fused.default": 4},
                "bf16": {"phc_gnn.segment_softmax_fused.default": 4}}
EXPORT_LAUNCHES = {"f32": {"segment_softmax_fused": 4},
                   "bf16": {"segment_softmax_fused_bf16": 4}}
EXPORT_POOL_INDEX_ADDS = 1  # the soft-attention pooling's, a forward
EXPORT_TURNS = ("eager", "exported", "graphed", "graphed", "exported",
                "eager")
EXPORT_PROFILED = 10         # calls profiled a turn
EXPORT_RECOUNTS = 2          # eager profiled again where exported seems more
# the exported graph's check of its inputs' shapes and dtypes: it launches
# nothing, and eager has no counterpart
EXPORT_ONLY_OPS = ("aten._assert_tensor_metadata.default",)
# the child process that loads the saved program: it imports the export
# module alone (which registers the ops), calls the program under the
# deterministic algorithms and reports its launches of A fused into B
EXPORT_CHILD = """
import json, sys, torch
from phc_gnn_torch import export
from phc_gnn_torch.ops import segment_softmax as ss
program = export.load(sys.argv[1])
args = torch.load(sys.argv[2])
torch.use_deterministic_algorithms(True, warn_only=True)
with torch.inference_mode():
    out = program.module()(*args)
torch.cuda.synchronize()
torch.save(out.cpu(), sys.argv[3])
print(json.dumps({"models_imported": "phc_gnn_torch.models" in sys.modules,
                  "launches": {"segment_softmax_fused":
                                   ss.segment_softmax_fused.launches}}))
"""


def phc_gnn_calls(program) -> dict:
    """The ``phc_gnn::`` ops called in an exported program's graph, with
    their counts, and the count of every ``scatter_reduce`` and
    ``index_add`` (aten) beside them."""
    calls: dict = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and (name.startswith("phc_gnn.") or
                                           "scatter_reduce" in name or
                                           "index_add" in name):
            calls[name] = calls.get(name, 0) + 1
    return calls


def exported_launches(torch, fn) -> dict:
    """The launch counts of one call of ``fn``, zeroed just before and read
    just after, those that are not 0."""
    torch.cuda.synchronize()
    reset_launches()
    fn()
    torch.cuda.synchronize()
    return {k: v for k, v in read_launches().items() if v}


def export_flagship(torch, dev, dtype: str, batch):
    """(a), (b): the flagship at full width with random eval state, in
    ``dtype``, exported at ``batch``'s bucket; its graph's kernel ops, its
    launches a call against the eager forward's and ``EXPORT_LAUNCHES``,
    and its output against the eager ``make_eval_step``: bit-equal under
    the deterministic algorithms, in float32 within TOL_SCAN_ATOMICS
    without them (the pooling's atomics).
    Returns the model, the program, the record and the launch counts."""
    from phc_gnn_torch import export
    from phc_gnn_torch.models import PHCGNN
    from phc_gnn_torch.train import make_eval_step

    model = (bf16_flagship(torch, dev, True) if dtype == "bf16" else
             PHCGNN(**flagship_config(), seed=0, device=dev))
    randomize_eval_state(torch, model)
    t0 = time.perf_counter()
    program = export.export_forward(model, batch)
    seconds = time.perf_counter() - t0
    calls = phc_gnn_calls(program)
    want_calls = {**EXPORT_CALLS[dtype],
                  "aten.index_add_.default": EXPORT_POOL_INDEX_ADDS}
    print(f"export {dtype}: torch.export of the flagship in {seconds:.2f} s; "
          f"its graph calls {calls} (expected {want_calls}: the kernels' ops, "
          f"no scatter_reduce, the pooling's index_add_ alone)", flush=True)
    if calls != want_calls:
        fail(f"export {dtype}: the exported graph calls {calls}, not "
             f"{want_calls}")
    module = program.module()
    args = export.forward_args(batch)
    eager = make_eval_step(model, device=dev)
    with torch.inference_mode():
        got = exported_launches(torch, lambda: module(*args))
        want = exported_launches(torch, lambda: eager(batch))
    print(f"export {dtype}: launches of one exported call {got}, of one "
          f"eager call {want} (expected {EXPORT_LAUNCHES[dtype]})", flush=True)
    if not got == want == EXPORT_LAUNCHES[dtype]:
        fail(f"export {dtype}: the exported forward launched {got}, the eager "
             f"one {want}, not {EXPORT_LAUNCHES[dtype]}")
    with torch.inference_mode():
        with deterministic(torch):
            exact_out = module(*args)
            exact_want = eager(batch)
        loose_out, loose_want = module(*args), eager(batch)
        control = eager(batch)
    torch.cuda.synchronize()
    if exact_out.shape != (FLAGSHIP["batch_size"] + 1, 1) or not bool(
            torch.isfinite(exact_out).all()):
        fail(f"export {dtype}: output {tuple(exact_out.shape)}, or not "
             f"finite")
    bit_equal = torch_equal(exact_out, exact_want)
    loose = normwise(loose_out.cpu(), loose_want.cpu())[1]
    eager_eager = normwise(control.cpu(), loose_want.cpu())[1]
    # bf16 rounds each order of the pooling's atomics apart (two eager
    # calls part by ~1e-2): only float32 is held outside the deterministic
    # algorithms
    tol = TOL_SCAN_ATOMICS if dtype == "f32" else math.inf
    print(f"export {dtype}: exported against eager: bit-equal under the "
          f"deterministic algorithms {bit_equal}; without them normwise "
          f"{loose:.3e} (tolerance {tol:g}: the pooling's atomics; two "
          f"eager calls {eager_eager:.3e})", flush=True)
    if not bit_equal or not loose <= tol:
        fail(f"export {dtype}: the exported forward disagrees with the "
             f"eager one")
    rec = {"export_s": seconds, "graph_calls": calls, "launches": got,
           "bit_equal_deterministic": bit_equal, "normwise_atomics": loose,
           "normwise_eager_eager": eager_eager}
    return model, program, exact_out, rec, got


def export_round_trip(torch, program, args, want):
    """(c): ``save``, then ``load`` and call in a fresh process that imports
    only ``phc_gnn_torch.export``, under the deterministic algorithms: the
    result bit-equal to ``want``, the fused kernel 4 launches there, and
    ``phc_gnn_torch.models`` never imported.  Returns the file's bytes and
    the child's seconds."""
    import os
    import tempfile

    from phc_gnn_torch import export

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.pt2")
        nbytes = export.save(program, path)
        torch.save(args, os.path.join(tmp, "args.pt"))
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", EXPORT_CHILD, path,
             os.path.join(tmp, "args.pt"), os.path.join(tmp, "out.pt")],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
        if child.returncode != 0:
            fail(f"export: the child that loads the program failed:\n"
                 f"{child.stdout}\n{child.stderr}")
        report = json.loads(child.stdout.strip().splitlines()[-1])
        got = torch.load(os.path.join(tmp, "out.pt"))
    bit_equal = torch_equal(got, want.cpu())
    print(f"export: the saved program ({nbytes} bytes) loaded and called in "
          f"a fresh process in {seconds:.1f} s: bit-equal {bit_equal}, "
          f"launches there {report['launches']}, phc_gnn_torch.models "
          f"imported {report['models_imported']}", flush=True)
    if (not bit_equal or report["models_imported"]
            or report["launches"] != EXPORT_LAUNCHES["f32"]):
        fail("export: the loaded program differs, launched otherwise, or "
             "needed phc_gnn_torch.models")
    return nbytes, seconds


def export_families(torch, dev):
    """(d): the quaternion add preset (K's eval route), PNA (C's masked
    role, H, I) and pcba's 512-graph eval (C) exported at their bench
    shapes: each exported call's launches equal the eager call's and the
    family's eval launches, its output within TOL_SCAN of the eager eval
    under the deterministic algorithms.  Returns the launch counts and the
    readings."""
    from phc_gnn_torch import export
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan
    from phc_gnn_torch.train import make_eval_step

    flagship_batch = attach_csr_plan(synthetic_batch(seed=0, **FLAGSHIP))
    cases = (("quat", quat_model(torch, dev), flagship_batch,
              QUAT_EVAL_LAUNCHES),
             ("pna", pna_model(torch, dev)[0], flagship_batch,
              PNA_EVAL_LAUNCHES),
             ("pcba", pcba_model(torch, dev)[0],
              pcba_batch(torch, 0, PCBA_EVAL), PCBA_EVAL_LAUNCHES))
    paths, info = {}, {}
    for name, model, host, per_batch in cases:
        randomize_eval_state(torch, model)
        batch = host.to(dev)
        t0 = time.perf_counter()
        program = export.export_forward(model, batch)
        seconds = time.perf_counter() - t0
        module, args = program.module(), export.forward_args(batch)
        eager = make_eval_step(model, device=dev)
        with torch.inference_mode():
            want = exported_launches(torch, lambda: eager(batch))
            got = exported_launches(torch, lambda: module(*args))
            paths[f"export_{name}"] = read_launches()
            with deterministic(torch):
                out, ref = module(*args), eager(batch)
        torch.cuda.synchronize()
        err = normwise(out.cpu(), ref.cpu())[1]
        info[name] = {"export_s": seconds, "graph_calls":
                      phc_gnn_calls(program), "launches": got,
                      "vs_eager": err}
        print(f"export {name}: exported in {seconds:.2f} s; launches of one "
              f"exported call {got}, of one eager call {want} (expected "
              f"{per_batch}); against the eager eval under the deterministic "
              f"algorithms normwise {err:.3e} (tolerance {TOL_SCAN:g})",
              flush=True)
        if not got == want == {k: v for k, v in per_batch.items() if v}:
            fail(f"export {name}: the exported forward launched {got}, the "
                 f"eager one {want}")
        if not (out.shape == ref.shape and err <= TOL_SCAN):
            fail(f"export {name}: the exported forward disagrees with the "
                 f"eager eval")
        del program, module, model
    return paths, info


def export_turns(torch, dev, model, program, batch):
    """(e): the eager eval, the exported program and the graphed eval
    (``make_scan_eval_steps`` over N_BATCHES copies of the batch) in turns
    (EXPORT_TURNS): ms a batch (CUDA events; the host clock beside), and
    from a profile the kernels a batch, device busy and idle.  Then the
    ops and the kernels a call of the eager and the exported call by name:
    the run fails if the exported call takes an op to the dispatcher more
    often than eager (``ops_a_call``, which loses nothing; but for
    EXPORT_ONLY_OPS), or launches a kernel more often (half a launch a
    call or more), in eager's calls profiled again up to EXPORT_RECOUNTS
    times, as the profiler can lose an event."""
    from phc_gnn_torch import export
    from phc_gnn_torch.train import make_eval_step, make_scan_eval_steps

    module, args = program.module(), export.forward_args(batch)
    eager = make_eval_step(model, device=dev)
    graphed = make_scan_eval_steps(model, device=dev)
    batches = [batch] * N_BATCHES

    def exported():
        with torch.inference_mode():
            return module(*args)

    fns = {"eager": (lambda: eager(batch), 1),
           "exported": (exported, 1),
           "graphed": (lambda: graphed(batches), N_BATCHES)}
    out = {k: [] for k in fns}
    for how in EXPORT_TURNS:
        fn, per = fns[how]
        ms, host_ms = (time_steps(torch, fn) if per == 1
                       else time_scan(torch, fn, per))
        prof = device_profile(torch, fn, ms * per,
                              iters=max(1, EXPORT_PROFILED // per))
        rec = {"ms": ms, "host_ms": host_ms,
               "kernels": prof["kernels_per_call"] / per,
               "busy_ms": prof["busy_ms"] / per,
               "idle_share": prof["idle_share"]}
        out[how].append(rec)
        print(f"export turn {how}: {ms:.3f} ms a batch (host "
              f"{host_ms:.3f}), {rec['kernels']:g} kernels, busy "
              f"{rec['busy_ms']:.3f} ms (idle {100 * rec['idle_share']:.1f} "
              f"%)", flush=True)
    ops = {how: ops_a_call(torch, fns[how][0])
           for how in ("eager", "exported")}
    out["ops_apart"] = {"beyond_eager": dict(ops["exported"] - ops["eager"]),
                        "below_eager": dict(ops["eager"] - ops["exported"])}
    print(f"export: ops a call that the exported call takes to the "
          f"dispatcher more and less often than eager: {out['ops_apart']}",
          flush=True)
    extra = {k: n for k, n in out["ops_apart"]["beyond_eager"].items()
             if k not in EXPORT_ONLY_OPS}
    if extra:
        fail(f"export: the exported call runs ops that the eager call does "
             f"not (a call, beyond eager's): {extra}")
    eager_n, exported_n = (kernel_names_a_call(torch, fns[how][0])
                           for how in ("eager", "exported"))

    def beyond_eager():
        return {k[:90]: [eager_n.get(k, 0.0), n] for k, n in exported_n.items()
                if n - eager_n.get(k, 0.0) >= 0.5}

    # a lost event cannot raise a count: a kernel the exported call seems
    # to launch more often than eager is profiled again in eager's calls
    for _ in range(EXPORT_RECOUNTS):
        if not beyond_eager():
            break
        print(f"export: the exported call seems to launch {beyond_eager()} "
              f"(eager, exported) beyond eager's; eager profiled again",
              flush=True)
        for k, n in kernel_names_a_call(torch, fns["eager"][0]).items():
            eager_n[k] = max(eager_n.get(k, 0.0), n)
    out["kernels_apart"] = {
        k[:90]: [eager_n.get(k, 0.0), exported_n.get(k, 0.0)]
        for k in set(eager_n) | set(exported_n)
        if eager_n.get(k) != exported_n.get(k)}
    print(f"export: kernels a batch that the eager and the exported call "
          f"launch apart (eager, exported): {out['kernels_apart']}",
          flush=True)
    beyond = beyond_eager()
    if beyond:
        fail(f"export: the exported call launches kernels that the eager "
             f"call does not (a batch, eager against exported): {beyond}")
    return out


def ops_a_call(torch, fn) -> collections.Counter:
    """The ops (aten and ``phc_gnn::``) that one call of ``fn`` takes to
    the dispatcher, by name: what it launches, counted on the host, where
    no event is lost."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.counts[str(func)] += 1
            return func(*args, **(kwargs or {}))

    with Ops() as mode:
        fn()
    return mode.counts


def kernel_names_a_call(torch, fn, iters: int = EXPORT_PROFILED,
                        tries: int = 3) -> dict:
    """Each CUDA kernel's launches a call of ``fn``, by name: the most of
    ``tries`` profiles of ``iters`` calls, since the profiler can drop an
    event (a profile once read A at 3.9 launches a call, which launches it
    4 times, another the eager eval's device-to-device copies at 19.2 of
    20) and a lost event cannot raise a count."""
    most: dict = {}
    for _ in range(tries):
        for name, n in device_profile(torch, fn, 1.0,
                                      iters=iters)["counts"].items():
            most[name] = max(most.get(name, 0.0), n / iters)
    return most


def op_overhead(torch, dev, batch):
    """(e): A's and B's eval variant per call through their ops (the public
    wrappers) and through the bare launch the ops call (the wrappers before
    the ops), in turns, at the flagship's shape: the dispatcher's cost."""
    from phc_gnn_torch.ops import segment_softmax as ss

    gen = torch.Generator().manual_seed(0)
    msgs = torch.randn((batch.num_edges, DIM), generator=gen).to(dev)
    args = (msgs, batch.edge_mask, torch.tensor(1.5, device=dev),
            batch.rowptr)
    segmax = ss.segment_logit_max(*args)
    fns = {"A op": lambda: ss.segment_logit_max(*args),
           "A bare": lambda: ss._logit_max_cuda(*args),
           "B op": lambda: ss.segment_softmax_aggregate(*args, segmax),
           "B bare": lambda: ss._aggregate_cuda(*args, segmax, emit_w=False)}
    out = {k: [] for k in fns}
    for k in ("A op", "A bare", "B op", "B bare",
              "B bare", "B op", "A bare", "A op"):
        out[k].append(time_eager(torch, fns[k]) * 1e3)
    print(f"export: per call us, through the op and bare, in turns: {out}",
          flush=True)
    return out


def op_checks(torch, dev, batch):
    """(f): ``torch.library.opcheck`` of every kernel op on CUDA inputs at
    the flagship's shapes (the whitening's at [4096, 200]), its default
    tests: the schema, the autograd registration, the fake implementation
    against the kernel, and the trace under ``aot_dispatch``."""
    gen = torch.Generator().manual_seed(1)
    n, e = batch.num_nodes, batch.num_edges
    msgs = torch.randn((e, DIM), generator=gen).to(dev)
    mask, rowptr = batch.edge_mask, batch.rowptr
    beta = torch.tensor(1.5, device=dev)
    segmax = torch.ops.phc_gnn.segment_logit_max(msgs, mask, beta, rowptr)
    bf16 = msgs.bfloat16()
    # the backward's inputs: the training forward's w, den and out, and a
    # cotangent of out
    fwd, fwd16 = ((w, den, out) for out, w, den in (
        torch.ops.phc_gnn.segment_softmax_fused_train(m, mask, beta, rowptr)
        for m in (msgs, bf16)))
    cot = torch.randn((n, DIM), generator=torch.Generator().manual_seed(2)
                      ).to(dev)
    d = DIM // 4
    x = torch.randn((n, DIM), generator=gen).to(dev)
    b = torch.randn((d, 4, 4), generator=gen)
    cov = (b @ b.transpose(1, 2) / 4 + 0.2 * torch.eye(4)).permute(
        1, 2, 0).contiguous().to(dev)
    gamma = (torch.eye(4)[:, :, None].repeat(1, 1, d)
             + 0.1 * torch.randn((4, 4, d), generator=gen)).to(dev)
    mean, wbeta = (torch.randn((4, d), generator=gen).to(dev)
                   for _ in range(2))
    ops = torch.ops.phc_gnn
    cases = [
        ("segment_logit_max", ops.segment_logit_max, (msgs, mask, beta, rowptr)),
        ("segment_softmax_aggregate", ops.segment_softmax_aggregate,
         (msgs, mask, beta, rowptr, segmax)),
        ("segment_softmax_aggregate_train",
         ops.segment_softmax_aggregate_train, (msgs, mask, beta, rowptr,
                                               segmax)),
        ("segment_softmax_fused", ops.segment_softmax_fused,
         (msgs, mask, beta, rowptr)),
        ("segment_softmax_fused_train", ops.segment_softmax_fused_train,
         (msgs, mask, beta, rowptr)),
        ("segment_softmax_fused bf16", ops.segment_softmax_fused,
         (bf16, mask, beta, rowptr)),
        ("segment_softmax_fused_train bf16", ops.segment_softmax_fused_train,
         (bf16, mask, beta, rowptr)),
        ("segment_softmax_backward", ops.segment_softmax_backward,
         (msgs, beta, *fwd, cot, rowptr, batch.receivers)),
        ("segment_softmax_backward bf16", ops.segment_softmax_backward,
         (bf16, beta, *fwd16, cot, rowptr, batch.receivers)),
        ("segment_sum_masked", ops.segment_sum_masked, (msgs, mask, rowptr)),
        ("segment_sum_masked bf16", ops.segment_sum_masked,
         (bf16, mask, rowptr)),
        ("segment_extreme max", ops.segment_extreme,
         (msgs, mask, rowptr, False)),
        ("segment_extreme min", ops.segment_extreme,
         (msgs, mask, rowptr, True)),
        ("segment_moments", ops.segment_moments, (msgs, mask, rowptr)),
        ("wbn_transform_eval", ops.wbn_transform_eval,
         (x, mean, cov, gamma, wbeta, 1e-5))]
    out = {}
    for name, op, args in cases:
        out[name] = torch.library.opcheck(op, args)
        print(f"export: opcheck {name} on the card: {out[name]}", flush=True)
        if set(out[name].values()) != {"SUCCESS"}:
            fail(f"export: opcheck of {name} on the card: {out[name]}")
    torch.cuda.synchronize()
    return out


def export_phase(torch, dev):
    """22. export: the flagship's eval forward exported with torch.export,
    its kernels called as torch.library ops; returns the launch counts of
    its main-path runs (the exported programs' calls) and the readings."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan

    batch = attach_csr_plan(synthetic_batch(seed=0, **FLAGSHIP)).to(dev)
    paths, info = {}, {}
    model, program, want, info["f32"], paths["export_f32"] = export_flagship(
        torch, dev, "f32", batch)
    _, _, _, info["bf16"], paths["export_bf16"] = export_flagship(
        torch, dev, "bf16", batch)
    from phc_gnn_torch import export

    info["bytes"], info["load_child_s"] = export_round_trip(
        torch, program, export.forward_args(batch), want)
    family_paths, info["families"] = export_families(torch, dev)
    paths.update(family_paths)
    info["turns"] = export_turns(torch, dev, model, program, batch)
    info["op_us"] = op_overhead(torch, dev, batch)
    info["opcheck"] = op_checks(torch, dev, batch)
    print(json.dumps({"export": info}), flush=True)
    return {k: {**dict.fromkeys(counter_names(), 0), **v}
            for k, v in paths.items()}, info


# ------------------------------------------------------------ 23. convergence

CONVERGENCE_TASK = "quat"
CONVERGENCE_GAIN = 4.0      # val[0] / best_val: the committed reference
                            # reads 8.5, JAX 8.7; the endpoints, which move
                            # with dropout masks and shuffle order, are
                            # printed and not held
# one quat parity train step: 3 convs with the sum aggregation and the MLP,
# C's masked role (the aggregation) and its gather role (the backward of
# x[senders]) once a conv, J-M at each conv's two whitening norms (the
# MLP's and the layer's), D and E at the head's two naive norms; an eval
# batch: C's masked role and K's eval route
CONVERGENCE_STEP = {"segment_sum_masked": 3, "segment_sum_perm": 3,
                    "wbn_stats": 6, "wbn_transform": 6, "wbn_bwd_sums": 6,
                    "wbn_dx": 6, "bn_forward": 2, "bn_backward": 2}
CONVERGENCE_EVAL = {"segment_sum_masked": 3, "wbn_transform": 6}


def convergence_phase(torch, dev):
    """23. convergence: the quat parity task trained whole through
    ``phc_gnn_torch.cli.parity`` (40 epochs, the committed init, 6,000 /
    800 / 800 graphs); the counters over the run, every loss and metric
    finite, the validation MAE cut by more than CONVERGENCE_GAIN from epoch
    0; the endpoints and ``hold``'s misses printed beside the reference's,
    JAX's and the card's committed record's, not held.  Returns the run's
    launches and a ``{"convergence"}`` line's fields."""
    import os

    from phc_gnn_torch.cli import parity

    task = CONVERGENCE_TASK
    reset_launches()
    record, rows = parity.run_task(task, dev)
    launches = read_launches()
    hold_counters("convergence", launches,
                  add_counts((capture_calls(), CONVERGENCE_STEP),
                             (capture_calls(), CONVERGENCE_EVAL)))
    epochs = parity.HPARAMS[task]["epochs"]
    if len(rows) != epochs or record["init"] != "committed":
        fail(f"convergence: {len(rows)} epochs from the {record['init']} "
             f"init, not {epochs} from the committed one")
    for r in rows:
        if not all(math.isfinite(r[k]) for k in ("train_loss", "valid_loss",
                                                 "valid_metric")):
            fail(f"convergence: a loss or metric is not finite: {r}")
    port = record["port"]
    gain = port["val_metric"][0] / port["best_val"]
    if not gain > CONVERGENCE_GAIN:
        fail(f"convergence: the validation MAE fell {gain:.3g}x from epoch "
             f"0 (val[0] {port['val_metric'][0]!r}, best {port['best_val']!r}"
             f"), not more than {CONVERGENCE_GAIN:g}x")
    committed = parity.committed_record(task)
    ends = ("best_val", "test_bestval", "test_last")
    card_path = os.path.join(parity.CARD_RECORDS, f"{task}.json")
    card = None
    if os.path.exists(card_path):
        with open(card_path) as f:
            card = json.load(f)["port"]
    out = {"task": task, "init": record["init"], "epochs": len(rows),
           "seconds": port["seconds"], "s_per_epoch": port["s_per_epoch"],
           "card": port["card"], "gain": gain,
           "val_metric": port["val_metric"], "train_loss": port["train_loss"],
           "valid_loss": [r["valid_loss"] for r in rows],
           "steps_per_s": [r["steps_per_s"] for r in rows],
           "port": {k: port[k] for k in ends},
           "reference": {k: committed["reference"][k] for k in ends},
           "jax": {k: committed["ours"][k] for k in ends},
           "card_record": card and {k: card[k] for k in ends + ("card",)},
           "misses": record["misses"], "launches": launches}
    print(f"convergence: {task} {len(rows)} epochs in {port['seconds']:.1f} s"
          f", val MAE {port['val_metric'][0]:.4f} -> best "
          f"{port['best_val']:.4f} ({gain:.2f}x), test@best "
          f"{port['test_bestval']:.4f}; reference {out['reference']}, jax "
          f"{out['jax']}; misses (printed, not held): "
          f"{record['misses'] or 'none'}", flush=True)
    return launches, out


SWEEPS_BUCKET = 3            # scaling.BUCKETS[3]: the 8x bucket, 32,768
                             # nodes, held against the CPU
SWEEPS_KERNEL_BUCKETS = (1, 2, 3)  # the 2x-8x buckets the kernels are held at
SWEEPS_SCAN_STEPS = 3        # graphed steps held to eager ones there


def sweeps_batch(torch, bucket, seed: int = 0):
    """``synthetic_batch`` of a ``scaling.BUCKETS`` entry with its CSR plans,
    on the CPU."""
    from phc_gnn_torch.data import synthetic_batch
    from phc_gnn_torch.graph import attach_csr_plan

    size, nodes, edges, _ = bucket
    return attach_csr_plan(synthetic_batch(size, nodes, edges, seed=seed))


def sweeps_kernels(torch, dev):
    """The flagship's kernels at the 2x-8x buckets of the scaling sweep, as
    its train step feeds them, against their plain versions: A fused into B
    (both variants) on [E, 200] messages over the bucket's receiver CSR,
    bit-equal to A then B; the softmax backward (``dm`` bit-equal to the
    plain backward on the card, ``dbeta`` within TOL_DBETA); C's gather
    backward over the sender plan (TOL_SUM against float64, bit-equal to
    the sequential f32 sum); F and G at the conv norms' [N, 200] with the
    bucket's node mask, past the size gate (TOL_BN against float64,
    bit-equal on relaunch)."""
    from phc_gnn_torch.cli import scaling
    from phc_gnn_torch.ops import fused_bn
    from phc_gnn_torch.ops import segment_sum as ssum

    gen = torch.Generator().manual_seed(7)
    errs: dict = {}
    for i in SWEEPS_KERNEL_BUCKETS:
        b = sweeps_batch(torch, scaling.BUCKETS[i]).to(dev)
        n, e = b.num_nodes, b.num_edges
        case = f"{n} nodes, {e} edges"
        m = torch.randn((e, DIM), generator=gen).to(dev)
        beta = torch.tensor(1.37, device=dev)
        if not hold_fused(torch, errs, "segment_softmax_fused", case, m,
                          b.edge_mask, beta, b.rowptr):
            fail(f"segment_softmax_fused differs from A then B at {case}")
        g = torch.randn((n, DIM), generator=gen).to(dev)
        hold_softmax_backward(torch, errs, "segment_softmax_backward", case,
                              m, b.edge_mask, beta, b.rowptr, g)
        gv = torch.randn((e, DIM), generator=gen).to(dev)
        out = ssum.segment_sum_perm(gv, b.snd_perm, b.snd_rowptr)
        check(errs, "segment_sum_perm", case, out, ssum.segment_sum_perm_plain(
            gv.double(), b.snd_perm, b.snd_rowptr), TOL_SUM)
        hold_sequential(torch, "segment_sum_perm", case, out,
                        ssum.segment_sum_perm(gv, b.snd_perm, b.snd_rowptr),
                        ssum.segment_sum_perm_plain(
                            gv.cpu(), b.snd_perm.cpu(), b.snd_rowptr.cpu()))
        if not n * DIM * 4 > fused_bn.FUSED_BN_VMEM_LIMIT:
            fail(f"[{n}, {DIM}] is under the size gate")
        x = (torch.randn((n, DIM), generator=gen) * 2 + 3).to(dev)
        hold_bn_pair(torch, errs, fused_bn.bn_forward_blocked,
                     fused_bn.bn_backward_blocked,
                     fused_bn.bn_forward_blocked_plain,
                     fused_bn.bn_backward_blocked_plain,
                     {f"[{n}, {DIM}]": ((x, torch.randn(
                         (n, DIM), generator=gen).to(dev),
                         torch.randn(DIM, generator=gen).to(dev),
                         torch.randn(DIM, generator=gen).to(dev)),
                         b.node_mask)})
    return {k: max(r for _, r in v) for k, v in errs.items()}


def sweeps_check(torch, dev, phase, build, batches, per_step):
    """``scan_train_check`` of ``build`` on ``batches`` (graphed against
    eager, dropout off, under ``deterministic``) with the wrappers' counters
    zeroed just before and read just after: its eager steps (two outside
    ``deterministic``, one inside, each a batch) and the graph's warm-ups
    and capture, each one step's ``per_step``.  Returns the counts and the
    check's readings."""
    from phc_gnn_torch.train import masked_l1

    def loss_fn(out, b):
        return masked_l1(out, b.y)

    torch.cuda.synchronize()
    reset_launches()
    info, _ = scan_train_check(torch, dev, phase, build, loss_fn,
                               WEIGHT_DECAY, LR, batches)
    torch.cuda.synchronize()
    launches = read_launches()
    hold_counters(phase, launches, add_counts(
        (3 * len(batches) + capture_calls(), per_step)))
    if not all(math.isfinite(x) for x in info["losses"]):
        fail(f"{phase}: non-finite loss {info['losses']}")
    return launches, info


def sweeps_phase(torch, dev):
    """25. sweeps: the flagship at the scaling sweep's 8x bucket, and every
    variant of the ablation sweep (``phc_gnn_torch.cli.scaling``,
    ``phc_gnn_torch.cli.ablation``), as the two commands drive them;
    returns the launch counts of its runs and a ``{"sweeps"}`` line's
    fields.  No timing: the commands time."""
    from phc_gnn_torch.cli import ablation, scaling
    from phc_gnn_torch.models import PHCGNN
    from phc_gnn_torch.ops import fused_bn
    from phc_gnn_torch.train import masked_l1

    def loss_fn(out, b):
        return masked_l1(out, b.y)

    info, paths = {"kernels_max_rel_err": sweeps_kernels(torch, dev)}, {}
    bucket = scaling.BUCKETS[SWEEPS_BUCKET]
    size, nodes, edges, _ = bucket
    cfg = flagship_config(dropout=False)
    per_step = ablation.step_launches(cfg, "plan", nodes, size + 1)
    info["bucket"] = {"graphs": size, "nodes": nodes, "edges": edges,
                      "expected_per_step": per_step,
                      "conv_norm_plans": [
                          fused_bn.bn_plan(nodes, DIM, t)._asdict()
                          for t in (1, 2)]}
    print(f"sweeps: the flagship at {nodes} nodes, {edges} edges: expected "
          f"launches a step {per_step} (conv norms [{nodes}, {DIM}] past the "
          f"size gate on F and G, plans {info['bucket']['conv_norm_plans']})",
          flush=True)

    def build(dropout):
        return PHCGNN(**flagship_config(dropout), seed=0, device=dev)

    host = sweeps_batch(torch, bucket)
    batch = host.to(dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    info["vs_cpu"] = agreement(torch, dev, host, batch, loss_fn,
                               phase=f"sweeps {nodes} nodes vs CPU")
    info["vs_cpu_s"] = time.perf_counter() - t0
    paths["sweeps_bucket_step"] = read_launches()
    hold_counters("sweeps bucket step", paths["sweeps_bucket_step"],
                  add_counts((1, per_step)))
    batches = [batch] + [sweeps_batch(torch, bucket, s).to(dev)
                         for s in range(1, SWEEPS_SCAN_STEPS)]
    paths["sweeps_bucket_scan"], info["scan"] = sweeps_check(
        torch, dev, f"sweeps {nodes} nodes scan", build, batches, per_step)
    del host, batch, batches

    info["variants"] = {}
    for name in ablation.VARIANTS:
        want = ablation.variant_launches(name, DIM)
        print(f"sweeps {name}: expected launches a step {want}", flush=True)
        b = ablation.batch(name).to(dev)
        paths[f"sweeps_{name}"], info["variants"][name] = sweeps_check(
            torch, dev, f"sweeps {name}",
            lambda dropout, name=name: ablation.build(name, dev, DIM,
                                                      dropout=dropout),
            [b], want)
    return paths, info


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on a GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)

    from phc_gnn_torch.ops import _build

    t0 = time.perf_counter()
    names = sorted(_build.load_all())
    print(f"build: {time.perf_counter() - t0:.1f} s for {names} "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)}, in parallel)", flush=True)

    seconds = {}

    def timed(name, phase, *args, **kwargs):
        t = time.perf_counter()
        out = phase(torch, dev, *args, **kwargs)
        seconds[name] = time.perf_counter() - t
        return out

    records = timed("kernels", kernel_phase)
    paths = {"eval": timed("eval", slice_phase),
             "train": timed("train", train_phase)}
    paths["pcba_eval"], pcba = timed("pcba_eval", pcba_eval_phase)
    paths["pcba_train"], pcba_train = timed("pcba_train", pcba_train_phase)
    pcba.update(pcba_train)
    paths["pcba_graph"], pcba["graph"] = timed("pcba_graph", pcba_graph_phase)
    print(json.dumps({"pcba": pcba}), flush=True)
    paths["quat_eval"], quat = timed("quat_eval", quat_eval_phase)
    paths["quat_train"], quat_train = timed("quat_train", quat_train_phase)
    paths["quat_concat_eval"], concat = timed("quat_concat",
                                              quat_concat_phase)
    paths["quat_eval_grad"], quat["eval_grad"] = timed(
        "quat_eval_grad", quat_eval_grad_phase)
    paths["quat_eval_attr"], quat["eval_attr"] = timed(
        "quat_eval_attr", quat_eval_grad_phase, attribution=True)
    quat.update(quat_train)
    quat["concat"] = concat
    print(json.dumps({"quat": quat}), flush=True)
    paths["pna_eval"], pna = timed("pna_eval", pna_eval_phase)
    paths["pna_train"], pna_train = timed("pna_train", pna_train_phase)
    pna.update(pna_train)
    print(json.dumps({"pna": pna}), flush=True)
    paths["scan_train"], scan = timed("scan", scan_phase)
    bf16_paths, bf16 = timed("bf16", bf16_phase, scan["flagship_profile"])
    paths.update(bf16_paths)
    pcba_paths, bf16["pcba"] = timed("bf16_pcba", bf16_pcba_phase)
    paths.update(pcba_paths)
    print(json.dumps({"bf16": bf16}), flush=True)
    remat_paths, remat = timed("remat", remat_phase)
    paths.update(remat_paths)
    print(json.dumps({"remat": remat}), flush=True)
    paths.update(timed("harness", harness_phase))
    paths["harness_bf16"], harness_b = timed("harness_bf16", harness_bf16)
    print(json.dumps({"harness_bf16": harness_b}), flush=True)
    halo_paths, halo_rec, halo = timed("halo", halo_phase)
    paths.update(halo_paths)
    records.append(halo_rec)
    print(json.dumps({"halo": halo}), flush=True)
    nccl_paths, nccl = timed("nccl", nccl_phase, (
        halo["trainer"]["single_rows"], halo["ep_trainer"]["single_rows"]))
    paths.update(nccl_paths)
    print(json.dumps({"nccl": nccl}), flush=True)
    xla_paths, _ = timed("xla", xla_phase)
    paths.update(xla_paths)
    export_paths, _ = timed("export", export_phase)
    paths.update(export_paths)
    paths["convergence"], convergence = timed("convergence",
                                              convergence_phase)
    print(json.dumps({"convergence": convergence}), flush=True)
    sweeps_paths, sweeps = timed("sweeps", sweeps_phase)
    paths.update(sweeps_paths)
    print(json.dumps({"sweeps": sweeps}), flush=True)
    print(json.dumps({"phase_seconds": seconds}), flush=True)
    for rec in records:
        rec["launches_by_path"] = {p: n[rec["name"]] for p, n in paths.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        if not rec["launches"]:
            fail(f"{rec['name']} was launched no time on the main paths")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
