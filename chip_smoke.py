#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py [--seed 0]

Phases (every check raises, so any failure exits non-zero):

1. The card: ``nvidia-smi`` name and power limit; the CUDA kernels are built
   from ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel)
   and their ``-Xptxas -v`` register report is printed, with the count of
   tensor-core instructions (HMMA) in the block kernel's SASS.
2. Each kernel against its plain PyTorch version on the card, at 65,536^2
   with about 1M nonzeros: values in {f32, bf16, i8, i32} x {SpMV, SpMM B=8,
   B=40 ragged, and B=64 for the block kernel}.  Integer-valued inputs must agree bit for bit; random f32
   at rtol=atol=2e-4 (tests/test_kernels.py's tolerance).  SpMM results must
   be bit-identical across two batch tiles.  The COO kernel also runs a
   matrix whose first window holds 262,144 nonzeros (a full row of 65,536
   and 384 rows of 512), which it splits into pieces.
3. The main path, through ``SparseMatrix.from_parts(...).plan(scheme="auto")
   .compile()``, on three matrices built from ``--seed`` after the recipes of
   ``repro/data/matrices.py`` (integer values in {±1, ±2}; x in {-2..2}, so
   every float32 sum is exact): regular 2,097,152^2 (COO and CSR),
   scale-free 2,097,152^2 (COO), block 1,048,576^2 in (8, 16) blocks (BCOO and
   BCSR).  Each plan answers 16 ``exe(x)`` and 4 ``exe.batch(X)``; every
   answer must equal the kernel's plain version on the card and cuSPARSE
   (``torch.sparse_csr_tensor @ x``, an independent oracle the port never
   calls) bit for bit, and the launch counters must rise by the requests.
4. Times at the main-path shapes (CUDA events, after warm-up) at B = 1, 8
   and 64: the kernel, its plain version, cuSPARSE, and the bound — the
   bytes the product must move (each input once, each output once) over
   3.35 TB/s, or its operations over 67 TFLOP/s (f32, no tensor cores),
   whichever is larger; each block case names the route it took.  Then the
   COO kernel's piece size M swept on the COO plans at B=1, and its two
   passes timed apart by torch.profiler.
5. The ELL kernel against its plain version at 65,536^2 with K = 16 and 48,
   as phase 2.
6. The ELL path at full width, through the ``kernels`` entry point
   ``ell_spmv``: the regular matrix with K=16 and the block matrix read as
   scalar ELL with K=48 (the scale-free matrix is left out: its densest row
   would pad every row to K = 2,097,152).  Answers equal the plain version
   and cuSPARSE bit for bit; kernel, plain and cuSPARSE times and the bound.
7. The partitioned path at full width: each matrix through
   ``SparseMatrix.plan(scheme="auto", devices=["cuda"] * 16).compile()``,
   and on the regular matrix the forced schemes 1d.nnz, 2d.equally-wide and
   2d.variable-sized, 16 ``exe(x)`` and 4 ``exe.batch(X)`` each.  Answers
   equal the single-device kernel and cuSPARSE bit for bit, and the
   launch counters rise by one part-axis launch per request.  Then each
   plan's part-axis launch is held against its per-part plain versions and
   timed next to the single-device kernel.  The 1D ring (torch local kernel
   only) runs at 65,536^2.
8. The serving path at full width (``repro_torch.engine`` /
   ``repro_torch.serve``): the three matrices registered from their
   triplets in one ``SpmvEngine()`` on the card (one part each), wrapped in
   an ``AsyncSpmvService`` with an rt, a standard and a batch tenant.  Per
   matrix 64 concurrent single vectors (coalesced by the batcher into
   SpMMs of the bucket widths 1, 2, 4, 8) and explicit B=4 and B=8 batches,
   every answer bit-equal to cuSPARSE; then a seeded bursty trace of 200
   requests (Zipf 1.1 over the matrices, 300 requests/s, widths 1/4/8,
   5 % expired deadlines) replayed in real time: nothing lost, no error,
   every expired request shed.  Latency p50/p99 and throughput per matrix
   and per class, the load / kernel / retrieve split, the widths served and
   the launches per kernel route.  An engine with ``cache_capacity=1``
   evicts a plan and ``torch.cuda.memory_allocated`` must fall by its
   placed bytes; an engine over 16 parts of the card answers a few
   requests, checked the same way.  The block kernel is timed at the
   batcher's widths B = 2 and 4 (the route it takes, and the tensor-core
   route for comparison, each held bit-equal to its plain version first).
9. A replay at 65,536^2 (the three recipes) with dense oracles on the card
   (``replay(..., oracles=...)``): every completed answer bit-equal.
10. Solver sessions (``exe.iterate``, ``SpmvEngine.solve``,
   ``AsyncSpmvService.solve``), x on the card between steps, with inputs
   from their own generator (seeded from ``--seed``), so phases 1-9 draw
   as before.  (a) Every main-path plan and the three 16-part auto plans of
   phase 7: 3 plain steps bit-equal to 3 host ``exe(x)`` calls, and on the
   regular and block matrices to 3 cuSPARSE products (rows sum |a| <= 32
   and <= 96, so every partial sum stays below 2^24).  (b) Tol mode:
   Jacobi on the regular recipe plus 64 on the diagonal, tol 1e-2, checked
   every 8 steps: converged in a multiple of 8 steps, bit-equal to a numpy
   float32 host loop over ``exe(x)``.  (c) 100-step power sessions on the
   regular COO, scale-free COO and block BCOO plans: per-step us, the cold
   (first) session apart from the warm ones, beside the B=1 kernel ms of
   phase 4 and the host loop's ms per step.  Runs after phase 7.  (d) After
   phase 8, on its engine: per matrix four concurrent 20-step power
   sessions and a burst of 64 single multiplies; multiplies bit-equal to
   cuSPARSE, sessions within 1e-4 of a float64 power loop (cuSPARSE in
   float64), one ``kind="solve"`` record of 20 steps per session, and the
   load / kernel / retrieve split of the multiplies with every thread on
   its own stream.  (e) After phase 9, on its engine and oracles: a replay
   of 120 requests with 30 % six-step power sessions; nothing lost, no
   error, every completed session verified, max |err| <= 1e-4.  Each part
   requires its launches to equal the multiplies plus the sessions' steps.
11. Tuning on the card (``repro_torch.tune``), after phase 10 (d), with
   inputs from its own generator, on phase 13's matrices (phase 3's
   recipes at ``SMALL_ROWS``).  (a) ``plan(scheme="tune")`` with a real
   Measurer (warmup 2, iters 5, trim 1) and a cache file: scale-free at
   B=1, block at B=8, single-device.  One line per
   candidate: ``mean_s`` (exe(x) with both copies, what the tuner ranks),
   ``compile_s`` and the kernel's ms by CUDA events on the program it
   compiled, with its rank by each.  Every planned candidate must be
   measured (a kernel candidate that raises stops the tune; each exception
   is printed),
   the launches must equal the measured calls plus the timing launches,
   and the winner must answer bit-equal to cuSPARSE and to the plain
   version.  (b) The same tunes from the cache file: no miss, no
   measurement, no launch, the same winner.  (c) Scale-free on 16 parts:
   every candidate's load / kernel / retrieve > 0 and its kernel phase no
   shorter than its part-axis launch.  (e) The card memory allocated after
   (a)-(c) equals that before.  (d) ``SpmvEngine(tune=True, tune_after=8)``
   over the scale-free matrix (``TUNE_ENGINE_MATRICES``), a client thread
   multiplying all through: 8 width-1 multiplies give one ``traffic``
   refinement, then width 8 a ``drift`` one; every event measured all the candidates
   it planned, every answer bit-equal to cuSPARSE, and
   launches = multiplies + 4 per measured candidate (warmup 1, iters 3) +
   1 per swap (the winner's warm-up).  (f) The tuner over
   ``paper_large_suite()`` of ``repro_torch.data.matrices`` (22 matrices at
   2048^2), every winner within 2e-4 of the dense product; a correctness
   sweep whose times are host overhead.
12. The multi-process cluster (``repro_torch.cluster``) at 2^17 rows, last,
   after phase 9, with inputs from its own generator: the three recipes
   again (scipy CSR in float32 as the host oracles), a ``ClusterRouter``
   of two engine workers, each its own process with its own CUDA context
   and ``SpmvEngine`` on the one card.  (a) Each matrix registered from
   int32-index triplets on one worker: frame bytes (under the protocol's
   1 GiB cap), the router's wall s, the worker's register s and the card
   memory it took.  (b) Per matrix 8 B=1, 2 B=4 and 2 B=8 multiplies
   through the router, bit-equal to the oracle, their router-clock p50
   beside phase 3's ``exe(x)`` p50 and phase 4's kernel ms; on every
   worker the kernel launches equal the multiplies it served.  (c) The
   block matrix tuned here at B=1 (real Measurer, cache file) and shipped
   as a tune record (0 measurements on the worker, a cache hit, the
   winner's scheme id), and the regular matrix's ``1d.nnz`` CSR plan
   shipped as IR (its scheme id kept); answers bit-equal.  (d) One 20-step
   power session per matrix through ``router.solve`` within 1e-4 of a
   float64 host loop, its steps charged to its placement and launched by
   its worker.  (e) Generator mode: two spawned load processes (no CUDA)
   replay 24 requests (Zipf 1.1 over the three, widths 1/4/8 at
   0.6/0.25/0.15) straight at the workers: 0 mismatched, 0 lost.  (f)
   Router mode on 4 threads over another 120 requests, a worker that
   alone holds a matrix (from the router's placements) killed
   (SIGKILL) after 40 answers: 0 lost, 0 mismatched, every shed
   ``worker_lost``, its own matrices re-homed on the other, which then answers
   every matrix bit-exactly, and within 10 s of the kill the card's free
   bytes (``mem_get_info``, sampled every 20 ms) rise by at least half of
   what the victim took.  The workers' launch counters start at 0 with them; their
   sum before the kill is the cluster path's count.
13. Topology-aware placement (``repro_torch.topo``), right after phase 10
   (a)-(c), on phase 3's recipes at 262,144 / 262,144 / 131,072 rows
   (``SMALL_ROWS``, built for it from ``[seed, 13, 1]``), with inputs from
   its own generator (``[seed, 13]``); integer-valued x throughout.  (a)
   The detector: ``detect_topology()`` and ``detect_topology(["cuda"] *
   16)`` (one flat axis); 16 parts of the regular matrix under the second,
   by ``scheme="auto"`` and ``"2d"``, bit-equal to the flat 16-part auto
   plan, as phase 7 builds it.  (b)
   ``FakeTopology.pim_like((2, 2))`` over ``["cuda"] * 4`` and
   ``pim_like((4, 4))`` over ``["cuda"] * 16``: each matrix through
   ``plan(scheme="2d", topology=)`` and ``plan(topology=)``: the grid
   beside the flat near-square one, the assignment, the transfer the
   model prices (modelled on the preset's declared links, not a time),
   partition s, part-axis kernel ms, bound, cuSPARSE ms and ``exe(x)``
   p50; answers at B=1 and B=8 bit-equal to the single-device kernel and
   cuSPARSE, one part-axis launch per request.  (c) Every assignment of
   ``pim2x2`` on the (2, 2) grid of the block and regular matrices: y
   identical across assignments, ``Mesh.slots`` the ``device_order`` of
   arange(4), kernel ms side by side (the model's assignment is (b)'s
   ``"2d"`` executor, not built twice).  (d) The worst placement's plan IR
   read back with and without the topology: the same ``@`` scheme id and
   answers; the recorded slots with it, flat slots without (as the JAX
   package lays it out).  (e) ``SpmvEngine(devices=["cuda"] * 4,
   topology=pim2x2, tune=True)`` on the block matrix, refined at B=1 over
   four candidates: one per assignment of each of the first two schemes'
   grids, the key's pool ``cuda:4|pim2x2:2x2``, the winner bit-equal,
   launches = warm-up +
   multiplies + 4 per measured candidate + the swap's warm-up; a second
   tune hits the cache: 0 measurements, 0 launches, card memory unchanged
   to the byte.  Its launches are ``launches_by_path[...]["topology"]``.
14. LM serving (``repro_torch.launch.serve.Server``, ``models/``,
   ``sparse/layers.py``) at qwen1.5-0.5b's full width (24 layers, d_model
   1024, d_ff 2816, vocab 151,936; seeded random params), after phase 12, with
   inputs from its own generator (``[seed, 14]``).  (a) Dense, float32,
   TF32 off: ``Server(cfg, 160).generate(prompts (4, 128), 32)`` in range;
   decode(prefill(S)) within 5e-3 of prefill(S+1) (tests/test_archs.py's
   tolerance); a teacher-forced ``forward`` over [prompt, out[:, :-1]]
   gives argmax == out wherever its top-2 margin exceeds 1e-3; a B=1,
   S=4,096 prefill runs the query-chunked attention (one call per layer)
   and agrees with the unchunked path within 1e-3.  (b) Block-sparse
   (``ffn_density=0.5``, (8, 128) blocks), float32: each of the 72 FFN
   projections runs the block kernel against its plain version at B = 4
   and 512, bit-equal on integer-valued bf16 inputs and within 2e-4 on the
   layer's own values; the model's logits (prefill, three decode steps, a
   teacher-forced pass) within 1e-3 of the same model with every block
   weight materialized dense and applied by ``torch.matmul`` (an oracle the
   port never calls), and its greedy tokens equal to the oracle's argmax
   wherever the margin exceeds twice the measured error; one
   ``generate(..., 16)`` launches the block kernel exactly 3 x 24 x 16 =
   1,152 times (``launches_by_path["bcoo_spmv"]["lm_serving"]``).  (c)
   bfloat16, dense and sparse: prefill ms and decode ms a token (CUDA
   events), tokens/s of a generate, and a torch.profiler trace of five
   decode steps (device busy ms, idle share, top kernels); w_gate and
   w_down at B = 1, 4 and 512: the block kernel with its route (and the
   tensor-core route below B = 8), its plain version, ``torch.matmul`` on
   the dense weight and the bound.
15. LM training (``repro_torch.launch.train``, ``launch/steps.py``,
   ``optim/``, ``runtime/``, the sparse FFN's backward), last, with inputs
   from its own generator (``[seed, 15]``).  (a) The backward at full
   width: qwen1.5-0.5b's w_gate (1024 -> 2816) and w_down (2816 -> 1024)
   in (8, 128) blocks, T = 1,024.  The forward runs the block kernel on
   W's stream and grad x on Wᵀ's stream of (128, 8) blocks (its route and
   its block-rows' spread printed): each bit-equal to its plain version
   on integer-valued bf16 and f32 inputs, within 2e-4 on random f32;
   grad x and grad bvalues through autograd (f32, TF32 off) within 1e-4
   of the largest value of autograd through the densified weight (a ``torch.matmul`` oracle the port never
   calls); the forward kernel, the grad x kernel and its plain version,
   the grad bvalues product, the value transpose, ``torch.matmul`` of the
   dense Wᵀ by gy and the bounds, by CUDA events.  (b)
   ``launch.train.main`` on smollm-360m at full width (32 layers, d_model
   960, vocab 49,152), bf16, 30 steps of B=8, S=512: finite losses that
   fall by at least 1.0 (tests/test_system.py's bound); step ms (median
   of the last 20), tokens/s, peak memory and a torch.profiler trace of 3
   steps.  (c) qwen1.5-0.5b dense and with ``ffn_density=0.5`` in (8, 128)
   blocks, bf16, B=4, S=256, 6 steps each through ``TrainLoop``: finite
   losses, the last below the first; every sparse step launches the block
   kernel 3 x 24 x 3 = 216 times (forward, remat recompute, grad x), and
   the last step's count, with the counters set to 0 just before it, is
   ``launches_by_path["bcoo_spmv"]["lm_training"]``; step ms and tokens/s
   of both.  (d) qwen1.5-0.5b at full width cut to 2 layers, sparse, f32:
   one train step on the card against the same step on the CPU (plain
   versions) from the same params: the loss within 1e-5 relative, every
   grad leaf within 1e-4 of its max, updated params within 1e-5 wherever
   |g| > 1e-3 max |g|.  (e) smollm-360m at full width cut to 4 layers:
   train(10) against train(6) + a checkpoint + a fresh loop's
   ``maybe_restore`` + train(4), losses within 1e-5 relative.
16. The MoE family (``models/moe.py``, MLA, MTP's tree) at full width,
   last, with inputs from its own generator (``[seed, 16]``).  (a)
   ``moe_apply`` alone, one layer of mixtral-8x22b (8 experts of 6144 x
   16,384, top-2) and of deepseek-v3 (256 of 7168 x 2048, top-8, one
   shared expert, a random router bias), at T = 512 and T = 4: the expert
   ids equal to a plain ``torch.topk`` recomputation; with ample capacity
   (factor 8) f32 within rtol = atol = 2e-3 of an f32 per-expert oracle
   over the same routing (tests/test_moe_sparse.py's tolerance), bf16
   within 1e-2 of it norm-wise (bf16 rounds the products, the expert
   outputs and the combine's sums); at the configured factor 1.25 the
   slots, dropped assignments and padding efficiency, two bf16 runs
   bit-equal, and CUDA-event ms of the layer and its parts (routing,
   dispatch, expert products, combine) beside the bound.  (b)
   mixtral-8x22b cut to 8 of 56 layers, bf16: ``Server.generate`` B=4,
   prompt 128, 16 tokens, timed as phase 14 (c) times it (prefill ms,
   decode ms a token, tokens/s, a torch.profiler trace of decode), with
   the peak card memory.  (c) mixtral cut to 2 layers, f32, capacity
   factor 8: phase 14 (a)'s decode-vs-prefill and teacher-forced checks.
   (d) deepseek-v3 cut to 4 of 61 layers (its 3 dense MLA layers and one
   MLA + MoE repeat; the MTP block built, not run), bf16, as (b); cut to
   2 layers (1 and 1), f32, as (c); one MLA layer at B=1, S=4,096,
   query-chunked (4 chunks) against unchunked within 1e-3.  (e) deepseek
   with ``ffn_density=0.5`` in (8, 128) blocks: at the 4-layer bf16 cut
   the 9 prefix projections against their plain version at B = 4 and
   512 (bit-equal on integer inputs, within 2e-4 on the layer's values)
   and one generate launching the block kernel 9 x 32 = 288 times
   (``launches_by_path["bcoo_spmv"]["lm_moe"]``); at the 2-layer f32 cut
   (capacity factor 8) phase 14 (b)'s checks against the densified
   ``torch.matmul`` oracle; w_gate (7168 -> 18,432) and w_down at B = 1,
   4 and 512 beside ``torch.matmul`` and the bound.  Every model is freed
   before the next is built.
17. Linear attention (``models/linear_attn.py``: Mamba2, mLSTM, sLSTM; the
   hybrid zamba2-2.7b with its weight-shared attention + MLP block and the
   recurrent xlstm-1.3b) at full width and full depth, last, with inputs
   from its own generator (``[seed, 17]``).  (a) One layer of each kind at
   full width, float32: Mamba2 at zamba2's widths (80 heads of 64, state
   64), mLSTM and sLSTM at xlstm's (4 heads of 512), B=2, S=1,024 (four
   chunks of 256): ``*_apply`` against ``*_decode`` stepped S times from
   the zero state, outputs and final states within rtol = atol = 1e-4 (the
   card's check of the inter-chunk recurrence); whether sLSTM's two paths
   are bit-equal is reported.  (b) zamba2-2.7b (54 layers, 3.15B params)
   and (c) xlstm-1.3b (48 layers, 1.31B), bf16, through ``Server``: B=4,
   prompt 128, 16 tokens, timed as phase 14 (c) times them, with the peak
   card memory; for xlstm also the share of prefill its 6 sLSTM layers'
   per-token loops take.  (d) Both in float32 at full depth: phase 14
   (a)'s decode-vs-prefill (5e-3) and teacher-forced argmax checks.  (e)
   zamba2 with ``ffn_density=0.5`` in (8, 128) blocks, float32: the shared
   FFN's three projections against their plain version at B = 4 and 512
   (integer inputs bit-equal; the layer's values within 2e-4, as bf16 and
   as float32), one generate launching the block kernel 3 x 9 x 32 = 864
   times (``launches_by_path["bcoo_spmv"]["lm_hybrid"]``), the model within
   1e-3 of its densified ``torch.matmul`` oracle; w_gate (2560 -> 10,240)
   and w_down at B = 1, 4 and 512 beside ``torch.matmul`` and the bound.
   (f) One bf16 zamba2 prefill at B=1, S=4,096 (16 chunks a Mamba2 layer,
   the shared block's attention query-chunked): ms and peak memory, the
   recurrent states beside the 9 shared-block KV caches.  Every model is
   freed before the next is built.
18. The encoder-decoder: seamless-m4t-medium (12 encoder + 12 decoder
   layers, d_model 1024, vocab 256,206) at full width and full depth,
   last, with inputs from its own generator (``[seed, 18]``), through
   ``lm.encode`` and ``launch.steps``' prefill / decode / train steps
   (``Server`` takes no frames).  (a) float32, TF32 off: the ``reduced()``
   widths (2 + 2 layers) with ``ffn_density=0.5`` in (8, 16) blocks
   trained one step on the card and on the CPU from the same params and
   batch with frames (loss within 1e-5, each grad leaf within 1e-4 of its
   max, as phase 15 (d); at full width until phase 26 had to be paid for:
   17.5 s of host, the 256,206-row vocabulary's CPU step); at full depth,
   dense, a generate (encode once, prefill, 31 decode steps with the same
   memory), decode(prefill(S)) within 5e-3 of prefill(S+1) and the
   teacher-forced argmax.  (b) bf16, B=4, bf16 frames of 1,024, prompt
   128, 16 tokens: encode, prefill and decode ms, the cross-attention's
   K/V projections of the memory timed apart, a decode step's device
   trace, tokens/s and peak memory; at B=1 ``make_prefill_step(cfg,
   "prefill_32k")`` bit-equal to ``lm.prefill(memory=lm.encode(frames))``.
   (c) ``ffn_density=0.5`` in (8, 128) blocks, float32: the 72 projections
   (36 encoder, 36 decoder) against their plain version at B = 4 and 512,
   one generate launching the block kernel 36 + 36 x 16 = 612 times
   (``launches_by_path["bcoo_spmv"]["lm_enc_dec"]``), the model within
   1e-3 of its densified ``torch.matmul`` oracle.  (d) ``make_train_step``
   on bf16 params, dense and sparse, 6 steps of B=4 x 256 with bf16
   frames: the loss falls; a sparse step launches the block kernel 180
   times (the encoder's 36 projections twice, the rematerialized
   decoder's three times).  (e) A bf16 encode at B=1, S_enc=4,096 (every
   encoder layer query-chunked, non-causal) and a 128-token prefill: ms
   and peak memory.  Then w_gate (1024 -> 4096) and w_down at B = 1, 4
   and 4,096 beside ``torch.matmul`` and the bound.

19. Training the MoE and linear-attention families (``launch.train.
   TrainLoop``, ``launch.steps``, ``optim`` with the update donated,
   ``models/moe.py``, MLA, MTP, ``models/linear_attn.py``), last, with
   inputs from its own generator (``[seed, 19]``).  (a) float32, TF32 off:
   each arch at ``reduced()`` widths (deepseek at its 3 prefix layers,
   MLA query-chunked with each chunk checkpointed; deepseek and zamba2
   with the sparse FFN in (8, 16) blocks) one train step on the card
   against the CPU (phase 15 (d)'s bounds); one full-width layer of each
   kind but the MoE one (deepseek's MLA, Mamba2, mLSTM and sLSTM at B=1, S
   = 256) forward and backward, card against CPU, each grad leaf within
   1e-4 of its max; deepseek's MoE layer alone at full width in bf16 (T = 512,
   capacity factor 8) against an f32 oracle built one routed expert at a
   time, forward and every grad (router, experts, shared expert, x).  (c)
   The block kernel at deepseek's 7168 <-> 18,432 and zamba2's 2560 <->
   10,240 in (8, 128) blocks, T = 1,024 (phase 15 (a)'s checks: forward
   and grad x on Wᵀ's (128, 8) stream bit-equal to the plain version on
   integer inputs, both grads within 1e-4 of the densified oracle, times
   beside the bound and ``torch.matmul``).  (b) bf16 through ``TrainLoop``
   at B=4, S=256 (one GLA chunk): mixtral-8x22b cut to 1 layer,
   deepseek-v3 to its 3 dense MLA prefix layers with the MTP block,
   zamba2-2.7b cut to 6 of 54 layers (1 repeat) and xlstm-1.3b to 8 of
   48 (1 repeat, on 32 x 32 batches), f32
   moments, 10 steps each: the loss falls by at least 1.0; step ms,
   tokens/s, peak memory, a trace (3 steps; 1 for zamba2 and xlstm), the
   bytes the update adds, mixtral's dropped share; sparse deepseek (with
   the reference's int8 moments) and zamba2 3 steps each, launching the
   block kernel 24 and 9 times a step, their projections then bit-equal
   to the plain version through the keys they carry (their last steps' sum is
   ``launches_by_path["bcoo_spmv"]["lm_train_families"]``); mixtral with 2
   microbatches, 3 steps; xlstm cut to 8 layers restarted from a step-1
   checkpoint, its losses bit-equal to an uninterrupted run's.  (d) sparse
   zamba2 at full width cut to 12 layers under remat ``full``, ``dots`` and
   ``none``: loss and grads bit-equal, block-kernel launches 18 / 18 / 12,
   ms, peak and a trace of each.
20. The dry run (``repro_torch.analysis``, ``launch/dryrun.py``,
   ``launch/dryrun_spmv.py``), last, with inputs from its own generator
   (``[seed, 20]``).  (a) ``dryrun_spmv``'s matrix, 2^20 rows of 16
   standard-normal nonzeros over Zipf columns (16,777,216 nnz), as its 1D
   program with impl="cuda" on 256 and on 512 parts of the card: 4
   ``exe(x)`` each, one part-axis launch of the COO kernel apiece (the
   path's count), within 2e-4 of a float64 scipy oracle; the part-axis
   launch within 2e-4 of its plain version; kernel, plain and cuSPARSE
   ms beside the bytes bound; the card's temp bytes (peak over the placed
   matrix) beside the fake count's FLOPs, bytes and temp bytes of the same
   program.  The ring, bucketed first, at 2^14 rows on 256 parts (at 2^20
   its equal-capacity buckets would hold 42.4 GiB): within 2e-4 of the
   oracle and the 1D program, no kernel launched, beside its count.  (b)
   The sparse qwen1.5-0.5b train step cut to 2 layers at full width (f32,
   a (2, 64) batch) counted on the card (the aten ops' FLOPs plus the block
   kernel's reported work; 18 launches, the path's count) and on fake CPU
   tensors: FLOPs within 1 %, any op whose count differs named; the fake
   argument + temp bytes over ``max_memory_allocated`` reported (outside
   0.7-1.3 is a finding, not a failure).  (c) Every LM step timed above
   (phase 14's bf16 qwen prefill and decode, 15's smollm step, 18's
   seamless step, 19's four families) with its ``_model_flops`` at its
   shape, the count's useful ratio (model FLOPs over the step's count on
   fake tensors, taken in a worker process started with the script) and
   its MFU against 989 TFLOP/s; xlstm's also from its params' tree (its
   ``init_params`` leaves, counted on fake tensors); phase 21's gemma2 prefill and decode, llama train step and
   llava prefix prefill too.  No step runs again to be timed.
21. The dense family's last three archs at full width, after phase 19 and
   before phase 20 (which prices its timed steps), with inputs from their
   own generator (``[seed, 21]``); every model freed before the next.  (a)
   llama3.2-1b (16 layers, 1,235,746,816 params) at full depth: phase 14
   (a)'s f32 checks (``Server.generate`` B=4, prompt 128, 16 tokens;
   decode vs prefill 5e-3; teacher-forced argmax), bf16 times as phase 14
   (c), ``ffn_density=0.5`` in (8, 128) blocks as phase 14 (b) (48
   projections against the plain version, 1,536 launches a generate, the
   densified oracle within 1e-3), 10 TrainLoop steps of 4 x 256 whose loss
   falls by at least 1.0.  (b) gemma2-27b (46 layers alternating
   attn_local with a 4,096 window and attn_global, softcaps 50 / 30, a
   tied 256,000-word vocabulary) in bf16 at 12 of its 46 layers through ``Server``
   (times, peak) and one B=1, S=8,192 prefill (query-chunked, timed, its
   peak); cut to 2 layers in f32: phase 14 (a)'s checks, then across the
   window at B=1 decode(prefill(8,192)) within 5e-3 of prefill(8,193) (the
   ring keeps positions 4,096..8,191 and the decode writes slot 0, the
   oldest) and the chunked 8,192-token prefill within 1e-3 of the
   unchunked one; sparse (SiLU FFN, as the reference's) at the f32 cut
   against its plain version and its densified oracle (whose dense FFN is
   given SiLU), and at 12 layers one bf16 generate of 8 tokens launching
   the block kernel 36 times a step, its prefill and decode timed.  (c)
   gemma2 at full width cut to 2 layers (one repeat, a local and a global
   layer), 10 bf16 TrainLoop steps dense (the loss falls by
   at least 1.0; step ms, peak, a trace) and sparse (18 launches a step;
   its first repeat's projections after training bit-equal to the plain
   version); card vs CPU at reduced widths, dense and sparse (phase 15
   (d)'s bounds).  (d) llava-next-34b (60 layers of 7168, the widths of
   llava-v1.6-34b's Yi-34B) at 15 of its 60 layers in bf16, B=1: a 2,880-token stub
   prefix (random patch embeddings) and a 128-token prompt, 16 greedy
   tokens through ``lm.prefill`` (max_len 3,024) and ``make_decode_step``:
   prefill and decode ms, a decode trace, the peak; cut to 2 layers in
   f32: ``make_prefill_step`` / ``make_decode_step`` bit-equal to
   ``lm.prefill`` / ``lm.decode_step`` over the prefix, decode vs prefill
   5e-3, sparse within 1e-3 of its densified oracle and its projections
   against the plain version at B = 4 and 3,008; sparse at 15 layers, one
   prefill (45 launches, T = 3,008 on the tensor cores) timed.  (e) llava
   cut to 2 layers: ``make_train_step`` for 10 bf16 steps of B=1, a fresh
   stub prefix and 256 text tokens each, the loss over the text falling by
   at least 1.0; step ms, peak, a trace; card vs CPU at reduced widths
   with a prefix.  (f) The block kernel at gemma2's w_gate (4608 ->
   36,864) and w_down at B = 1, 4 and 512 and its backward at T = 1,024,
   llava's w_gate and w_down at T = 3,008 (the plain version there in
   column chunks), beside ``torch.matmul`` and the bound.  The path's
   count (``launches_by_path["bcoo_spmv"]["lm_dense_archs"]``) sums
   llama's sparse generate, gemma2's sparse generate and llava's sparse
   prefill at their served depths, and one sparse gemma2 train step.
22. Examples and tools, after phase 21 and before phase 20: every
   ``examples/torch_*.py`` (``torch_train_lm`` once dense and once with
   ``--sparse-ffn``), then ``tools/trace_dump_torch.py`` in replay mode
   (its trace under ``build/phase22/``) and ``tools/check_topo_torch.py``,
   each imported and its ``main`` called in process on the card at its
   defaults, its output under ``build/phase22/<script>.log``.  Each must
   complete with its own assertions held; every SpMV one must launch the
   COO or the block kernel (the cluster example in its workers, by the
   router's per-worker stats), the sparse ``torch_train_lm`` the block
   kernel; every request row of the trace must hold a ``kernel`` span.
   Its launches are ``launches_by_path[...]["examples"]``.

23. The partitioned schemes with one rank per part (``repro_torch.core.
   world`` / ``core.collectives``, a ``ProcessMesh``), after phase 22 and
   before phase 20, with inputs from their own generators (``[seed, 23,
   ...]``).  (a) 4 ranks of one gloo world share the card (transport
   ``shm-host-staged``: the collectives' data copied between the card and
   a shared memory mapping, sums on the card, as for any mesh whose ranks
   share one host; ``ppermute`` over gloo, staged through pinned host
   buffers), each building the same matrices
   and placing only
   its own part: 1D ``rows``, ``nnz-rgrn``, ``nnz`` and the ring on a
   scale-free matrix of 524,288 rows (``PW_ROWS``: about 2^22 nonzeros); 2D
   equally-sized with ``psum``, ``psum_scatter`` and ``global``,
   equally-wide and variable-sized on a regular matrix of 262,144 rows at
   16 a row; 2D equally-sized BCOO on a block matrix of 262,144 rows;
   each through ``SparseMatrix.plan(mesh=<process mesh>, impl="cuda")``
   (the ring: ``plan_from_partitioned``, torch local kernel), one B=1 and
   one B=8 request checked and 5 B=1 requests timed.  Every rank's y and Y
   must be bit-equal (by digest) to the one-process 4-part plan of the
   same scheme on the card, which this process builds meanwhile, and to
   cuSPARSE; each rank's kernel launches must equal its requests.  Per
   scheme: each rank's tile kernel ms (ranks in turn), its plain version,
   cuSPARSE on its tile and its bytes bound; the collectives' ms and bytes
   by kind at B=1 and B=8 (ms over the timed requests, each of which
   waits for the slowest rank); exe(x) p50 beside the card's name and
   power limit.  (b) This process joins a world of one over NCCL and runs the
   same programs at grids (1,) and (1, 1), bit-equal; NCCL's version.  A
   rank that fails or hangs fails the script.  Its launches are
   ``launches_by_path[...]["process_mesh"]``.
28. The engine over that world (``pe_*``), in phase 23's ranks and turn
   after its schemes: every rank opens ``SpmvEngine(world=, impl="cuda")``,
   rank 0 leads it and the others follow (``core/control.py``).  Rank 0
   registers phase 23's three matrices 1D and 2D as the engine plans them
   (every 2D plan fits (4, 1) there), and the regular and block matrices
   again on phase 23's (2, 2) equally-sized grid through ``plan=``
   (``psum_scatter`` and ``psum``: the ranks get x's halves and merge);
   it partitions each once and sends each rank its part, answers one B=1
   and one B=8 request of
   each, times 5 of each width, runs a 20-step power session, refines the
   regular 2D registration with the real ``Measurer`` over 3 candidates,
   times its COO and block tiles alone, and replays 48 requests (Zipf 1.1,
   widths 1 / 4 / 8) through an ``AsyncSpmvService`` with cuSPARSE
   oracles, whose close closes the engine.  Every answer, the session
   and the refined winner's answer must be bit-equal (by digest) to the
   one-process 4-part engine (``devices=[card] * 4``) that this process
   runs meanwhile on the same inputs, itself bit-equal to cuSPARSE; the
   replay must end with 0 lost, 0 errors and every answer bit-exact; each
   rank's launches must equal its requests (calls and session steps); a
   (2, 2) registration must scatter and merge at both widths.
   Rows: multiply p50 at B = 1 and 8 beside phase 23's exe(x) and the
   one-process engine, the bytes a request moves on rank 0 by kind
   (``"scatter"`` the x shards), collective seconds by kind, the register
   split (partition, send, bytes) beside sending the whole matrix, and
   rank 0's COO and block tiles (kernel, plain, cuSPARSE, bound).  Its
   launches are ``launches_by_path[...]["world_engine"]``.
24. The LMs on a process mesh (``phase_lm_mesh``): qwen1.5-0.5b on (1, 4)
   and deepseek-v3 (2 layers) on (2, 2) through ``Server(mesh=)``, 4 gloo
   ranks sharing the card, against the one-process port.
25. Training on the process mesh, in phase 24's ranks and turn after its
   serving paths (``pt_*``), qwen1.5-0.5b at full width: (a) one f32
   ``make_train_step`` step of a 2-layer cut on (1, 4) and (2, 2), dense
   and at ``ffn_density=0.5``, B=4 x 256, against the one-process port on
   the card (loss within 1e-5 relative, each grad block within 1e-4 of
   its leaf's max |g|, each updated param block within 1e-5 of its
   leaf's max |p| where |g| > 1e-3 of the tree's max |g|); (b) 6 bf16 steps at 24
   layers through ``TrainLoop(mesh=)`` on both meshes, dense and sparse,
   on phase 15's batches: the first loss within 1e-2 and the last within
   5 % of phase 15's one-process losses, each rank's collectives a step
   equal to ``analysis.sharded.train_collectives`` and its block-kernel
   launches to 216; (c) the (2, 2) dense run's checkpoint at step 3 read
   back onto every rank's blocks bit for bit, then restored on (1, 4) for
   steps 4-6 within 1e-2 of the (2, 2) run; (d) the block kernel on rank
   0's run of w_gate and w_down, forward and grad x on the run's Wᵀ, T =
   1,024, bit-equal to the plain version on integer-valued bf16, timed
   beside it, its bound and ``torch.matmul``.  Its launches are
   ``launches_by_path["bcoo_spmv"]["lm_mesh_train"]``.
26. The recurrent kinds and the encoder-decoder on the process mesh, in
   the same ranks and turn after phase 25 (``pr_*``), at full width:
   zamba2-2.7b cut to 12 layers on (1, 4) (20 of 80 SSM heads, 8 of 32
   attention heads, 2,560 of 10,240 FFN columns and 8,000 of 32,000 vocab
   rows a rank), bf16 dense and at ``ffn_density=0.5`` through
   ``Server(mesh=)``; xlstm-1.3b cut to 8 layers on (2, 2) (2 of 4 heads
   a rank, 2 rows a data rank) through ``Server(mesh=)``; seamless-m4t-
   medium at full depth on (2, 2) (8 of 16 heads, 2,048 of 4,096 FFN
   columns, 128,103 of 256,206 vocab rows) with B=4 x 1,024 bf16 stub
   frames through ``launch.steps.make_prefill_step`` / ``make_decode_step``,
   dense and sparse; B=4, prompt 128, 8 tokens.  Checks: the f32 cuts
   (zamba2 at 6 layers, xlstm at 8, seamless at 2 + 2) within 1e-5 of max
   |logit| of the one-process port over a prefill of 32 tokens and 3
   decode steps, and at 32 and 128 tokens within twice the control (the
   one-process port's own logits with every weight moved by its dtype's
   epsilon, read in the run: the decays' f32 cumulative sums make these
   logits move by 1e-5 at 128 tokens); the bf16 paths' logits fed the
   one-process port's greedy tokens (teacher forcing), at every position,
   within half their control, and seamless's teacher-forced tokens equal
   to the one-process port's where its margin exceeds 0.045 of the max
   |logit| (twice the largest gap measured on the H100) on at least a
   quarter of the positions; every rank's param bytes, collectives and
   block-kernel launches equal to ``analysis.sharded``'s closed forms, its
   peak at least its params; rank 0's runs of zamba2's shared w_gate / w_down and seamless's w_gate /
   w_down bit-equal to their plain version on integer-valued bf16 at T =
   512 and 4, timed beside it, ``torch.matmul`` and the bound.  Its
   launches are ``launches_by_path["bcoo_spmv"]["lm_mesh_recurrent"]``.

Each path's launch counters are set to 0 just before it runs and read just
after; the partitioned path does so around each plan's requests and sums
the counts, so that the single-device answers it compares with are
launched outside the count; the solver sessions do so around each session.
The serving path does so around each
service's traffic and requires the COO and block launches to equal the
engine's multiplies: the batcher's coalesced batches plus the explicit
batches served (one part-axis launch each).  Prints JSON lines; the line before the last
is ``{"kernels": [...]}`` and the last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import dataclasses
import gc
import json
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
HBM_BYTES_S = 3.35e12  # H100 SXM data sheet
F32_OPS_S = 67e12  # H100 SXM data sheet, float32 without tensor cores
PM12 = np.array([-2, -1, 1, 2], np.float32)

KERNELS = {  # kernel -> (source, TPU kernel it replaces)
    "coo_spmv": ("src/repro_torch/kernels/csrc/coo_spmv.cu",
                 "src/repro/kernels/coo_spmv.py:165"),
    "bcoo_spmv": ("src/repro_torch/kernels/csrc/bcoo_spmv.cu",
                  "src/repro/kernels/bcsr_spmv.py:76"),
    "ell_spmv": ("src/repro_torch/kernels/csrc/ell_spmv.cu",
                 "src/repro/kernels/ell_spmv.py:66"),
}
# the same CUDA kernel also replaces these TPU kernels
ALSO_REPLACES = {"coo_spmv": ["src/repro/kernels/csr_spmv.py:52"]}
KIND = {"coo_spmv": "coo", "bcoo_spmv": "bcoo", "ell_spmv": "ell"}
PARTS = 16  # parts of the partitioned path, all on the one card
MAIN_REQUESTS = 20  # a path's requests: 16 at B=1, then B=8 and 64 twice
PART_REQUESTS = 10  # a partitioned plan's: 8 at B=1, then B=8 and 64 (cut from 20)
# the serving path's tenants, one per SLO class
TENANTS = {"tenant-rt": "rt", "tenant-std": "standard", "tenant-batch": "batch"}
SERVE_WAIT_S = 600  # bound on any one await of the serving phases
SERVE_REPLAY_REQUESTS = 200  # phase 8's replay (cut from 600, then 300, for the script's time)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def emit(obj) -> None:
    """One JSON line; a phase's row also gets ``t_s``, the seconds since the
    script started (where the time goes between the phases' own timers)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------- matrices


def regular_triplets(rng, n: int, k: int = 16):
    """Banded-jitter rows (data/matrices.py:regular_matrix) with k distinct
    columns per row: one jittered offset in each of k strata of the band,
    wrapped around the matrix edge."""
    band = n // 16
    width = 2 * band // k
    offs = -band + np.arange(k) * width + rng.integers(0, width, (n, k))
    cols = (np.arange(n)[:, None] + offs) % n
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    return rows, cols.reshape(-1), rng.choice(PM12, n * k), (n, n)


def scale_free_triplets(rng, n: int, nnz_target: int, alpha: float = 1.6):
    """Zipf row degrees toward ``nnz_target`` capped at n, and Zipf hub
    columns (data/matrices.py:scale_free_matrix).  Rows above 64 nonzeros
    take distinct uniform columns; the rest draw from the hub distribution,
    duplicates in a row merged."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    deg = ranks ** (-alpha)
    deg = np.maximum(1, np.round(deg / deg.sum() * nnz_target)).astype(np.int64)
    deg = np.minimum(deg, n)
    rng.shuffle(deg)
    cdf = np.cumsum(ranks ** (-alpha))
    cdf /= cdf[-1]
    col_ids = rng.permutation(n)
    light = deg <= 64
    rows = np.repeat(np.flatnonzero(light), deg[light])
    cols = col_ids[np.minimum(np.searchsorted(cdf, rng.random(len(rows))), n - 1)]
    keys = [np.unique(rows * n + cols)]
    for r in np.flatnonzero(~light):
        keys.append(r * n + np.sort(rng.choice(n, deg[r], replace=False)))
    keys = np.sort(np.concatenate(keys))
    return keys // n, keys % n, rng.choice(PM12, len(keys)), (n, n)


def block_triplets(rng, n: int, block=(8, 16), per: int = 3):
    """Dense (r, c) blocks, ``per`` in every block-row, at distinct, jittered,
    banded block-columns (data/matrices.py:block_matrix, banded)."""
    r, c = block
    nbr, nbc = n // r, n // c
    band = nbc // 16
    width = 2 * band // per
    offs = -band + np.arange(per) * width + rng.integers(0, width, (nbr, per))
    bc = (np.arange(nbr)[:, None] * nbc // nbr + offs) % nbc  # (nbr, per)
    shape4 = (nbr, per, r, c)
    rows = np.broadcast_to(np.arange(nbr)[:, None, None, None] * r
                           + np.arange(r)[None, None, :, None], shape4)
    cols = np.broadcast_to(bc[:, :, None, None] * c + np.arange(c), shape4)
    nnz = nbr * per * r * c
    return rows.reshape(-1), cols.reshape(-1), rng.choice(PM12, nnz), (n, n)


def random_triplets(rng, n: int, per_row: int, integer: bool):
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    cols = rng.integers(0, n, n * per_row)
    vals = (rng.choice(PM12, n * per_row) if integer
            else rng.standard_normal(n * per_row).astype(np.float32))
    return rows, cols, vals, (n, n)


def heavy_window_triplets(rng, n: int, integer: bool):
    """``random_triplets`` with 16 per row, but the first 512-row window
    holds 262,144 nonzeros: row 0 full (n columns) and rows 1..384 with 512
    distinct columns each (rows 385..511 empty).  The CUDA kernel splits
    that window into pieces.  Random values of a heavy row are scaled by
    1/sqrt(its length), so that its sum has unit spread and the 2e-4
    tolerance holds the kernel, not float32's rounding of a 65,536-term
    sum, to account."""
    rows, cols, vals, shape = random_triplets(rng, n, 16, integer)
    keep = rows >= 512
    heavy_rows = np.concatenate([np.zeros(n, np.int64), np.repeat(np.arange(1, 385), 512)])
    heavy_cols = np.concatenate([np.arange(n)] + [np.sort(rng.choice(n, 512, replace=False))
                                                  for _ in range(384)])
    heavy_vals = (rng.choice(PM12, len(heavy_rows)) if integer
                  else (rng.standard_normal(len(heavy_rows)) / np.sqrt(
                      np.where(heavy_rows == 0, n, 512))).astype(np.float32))
    return (np.concatenate([heavy_rows, rows[keep]]),
            np.concatenate([heavy_cols, cols[keep]]),
            np.concatenate([heavy_vals, vals[keep]]), shape)


def random_block_triplets(rng, n: int, integer: bool, block=(8, 16)):
    """One dense (r, c) block per block-row at a random block-column."""
    r, c = block
    nbr = n // r
    bc = rng.integers(0, n // c, nbr)
    shape4 = (nbr, r, c)
    rows = np.broadcast_to(np.arange(nbr)[:, None, None] * r
                           + np.arange(r)[None, :, None], shape4)
    cols = np.broadcast_to(bc[:, None, None] * c + np.arange(c), shape4)
    size = nbr * r * c
    vals = (rng.choice(PM12, size) if integer
            else rng.standard_normal(size).astype(np.float32))
    return rows.reshape(-1), cols.reshape(-1), vals, (n, n)


# ------------------------------------------------------------- helpers


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
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


def max_err(torch, got, want) -> float:
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def ptxas_summary(log: str) -> list:
    """(kernel with template arguments, "Used ..." line, spill line) for each
    kernel that an ``nvcc -Xptxas -v`` log compiles."""
    names = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16",
             "a": "i8", "s": "i16", "i": "i32"}
    out, entry, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function "
                      r"'\S*?\d+([a-z_]+_kernel)I(\w+?)((?:Li\d+E)*)EEv", line)
        if m:
            ints = re.findall(r"Li(\d+)E", m.group(3))
            entry = " ".join([m.group(1), names.get(m.group(2), m.group(2))] + ints)
        elif "spill" in line and entry:
            spill = line.strip()
        elif "Used" in line and entry:
            out.append((entry, line.split(":", 1)[1].strip(), spill))
            entry = None
    return out


def ptxas_lines(build) -> list:
    """One line per compiled kernel: template arguments, registers, spills."""
    return [f"ptxas {name}[{entry}]: {used}; {spill}"
            for name in build.SOURCES
            for entry, used, spill in ptxas_summary(build.build_log(name))]


def sass_mma_counts(build, name: str) -> dict:
    """Tensor-core instructions (HMMA) per kernel in the SASS of a built
    library, from cuobjdump; {"cuobjdump": "not run: ..."} without it."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    if not os.path.exists(tool):
        return {"cuobjdump": "not run: not found"}
    res = subprocess.run([tool, "-sass", str(build._lib_path(name))],
                         capture_output=True, text=True, timeout=120)
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : \S*?\d+([a-z_]+_kernel)I(\w+?)((?:Li\d+E)*)EEv",
                      line)
        if m:
            args = [m.group(2)] + re.findall(r"Li(\d+)E", m.group(3))
            fn = f"{m.group(1)}<{','.join(args)}>"
        elif fn and re.search(r"\bHMMA\b", line):
            counts[fn] = counts.get(fn, 0) + 1
    return counts


# ------------------------------------------------------------- phases


def phase_kernels(torch, rng, device, n: int, errs: dict, rng64) -> None:
    """Each kernel vs its plain version at 65,536^2 x ~1M nnz.  The block
    kernel's B=64 inputs come from ``rng64``, so that ``rng`` feeds every
    later phase the same matrices whatever cases this phase adds."""
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "i8": torch.int8,
              "i32": torch.int32}
    to_coo = lambda ri, ci, v, s: F.triplets_to_coo(ri, ci, v, s)  # noqa: E731
    makers = {("coo_spmv", "random"): (
                  lambda integer: random_triplets(rng, n, 16, integer), to_coo),
              ("coo_spmv", "heavy-window"): (
                  lambda integer: heavy_window_triplets(rng, n, integer), to_coo),
              ("bcoo_spmv", "random"): (
                  lambda integer: random_block_triplets(rng, n, integer),
                  lambda ri, ci, v, s: F.triplets_to_bcoo(
                      ri, ci, v, s, block=(8, 16)))}
    for (kernel, matrix), (triplets, build) in makers.items():
        cases = [(name, dt, True) for name, dt in dtypes.items()]
        cases.append(("f32-random", torch.float32, False))
        for name, dtype, integer in cases:
            ri, ci, vals, shape = triplets(integer)
            m = build(ri, ci, F.to_tensor(vals, dtype), shape)
            prog = ops.kernel_program(m, device=device)
            nnz, case_err = len(ri), 0.0
            batches = (None, 8, 40) + ((64,) if kernel == "bcoo_spmv" else ())
            for batch in batches:
                xshape = (n,) if batch is None else (n, batch)
                g = rng64 if batch == 64 else rng
                xv = (g.integers(-2, 3, xshape) if integer
                      else g.standard_normal(xshape))
                x = torch.from_numpy(xv).to(device, dtype)
                got, want = prog(x), prog.plain(x)
                torch.cuda.synchronize()
                check(got.dtype == want.dtype and got.shape == want.shape,
                      f"{kernel} {name} B={batch}: {got.dtype}{tuple(got.shape)} "
                      f"vs plain {want.dtype}{tuple(want.shape)}")
                err = max_err(torch, got, want)
                case_err = max(case_err, err)
                if integer:
                    check(torch.equal(got, want),
                          f"{kernel} {name} B={batch}: max |kernel - plain| = {err}")
                else:
                    check(torch.allclose(got, want, rtol=2e-4, atol=2e-4),
                          f"{kernel} {name} B={batch}: max |kernel - plain| = {err}")
                if batch is not None:
                    other = dataclasses.replace(prog, batch_tile=8)
                    check(torch.equal(other(x), got),
                          f"{kernel} {name} B={batch}: batch tiles 8 and 32 differ")
            pieces = {}
            if matrix == "heavy-window":
                pieces = {"window0_chunks": int(prog.plan.window_start[1]),
                          "window0_pieces": int((prog.plan.pieces[:, 0] == 0).sum())}
                check(pieces["window0_pieces"] > 1, f"heavy window not split: {pieces}")
            emit({"phase": "kernel_vs_plain", "kernel": kernel, "matrix": matrix,
                  "values": name, "shape": list(shape), "nnz": nnz, **pieces,
                  "max_abs_err": case_err, "ok": True})
            errs[kernel] = max(errs[kernel], case_err)
            del prog, m
    torch.cuda.empty_cache()


def library_csr(torch, sm, device):
    csr = sm.container("csr")
    nnz = csr.nnz
    return torch.sparse_csr_tensor(csr.rowptr.to(device), csr.colind[:nnz].to(device),
                                   csr.values[:nnz].to(device), size=sm.shape)


def phase_main_path(torch, rng, device, sizes, errs, records) -> None:
    """Serve requests through the public pipeline at real size."""
    from repro_torch.api import SparseMatrix
    from repro_torch.kernels import instrument

    n_reg, n_sf, n_blk = sizes
    cells = [
        ("regular", lambda: regular_triplets(rng, n_reg),
         [(None, "2d.equally-sized.coo.psum_scatter"),
          ("csr", "2d.equally-sized.csr.psum_scatter")]),
        ("scale-free", lambda: scale_free_triplets(rng, n_sf, 8 * n_sf),
         [(None, "1d.nnz.coo.ppermute")]),
        ("block", lambda: block_triplets(rng, n_blk),
         [(None, "2d.equally-sized.bcoo.psum_scatter"),
          ("bcsr", "2d.equally-sized.bcsr.psum_scatter")]),
    ]
    instrument.reset()
    requests = {"coo": 0, "coo.spmm": 0, "bcoo": 0, "bcoo.spmm": 0}
    for name, make, plans in cells:
        t0 = time.perf_counter()
        ri, ci, vals, shape = make()
        sm = SparseMatrix.from_parts(ri, ci, vals, shape)
        del ri, ci, vals
        st = sm.stats
        setup_s = time.perf_counter() - t0
        A = library_csr(torch, sm, device)
        emit({"phase": "matrix", "matrix": name, "shape": list(shape),
              "nnz": st.nnz, "nnz_r_std": st.nnz_r_std, "nnz_r_max": st.nnz_r_max,
              "block_fill": st.block_fill, "setup_s": setup_s})
        for fmt, want_id in plans:
            pln = sm.plan(scheme="auto", fmt=fmt, device=device)
            check(pln.scheme_id == want_id,
                  f"{name}: auto gave {pln.scheme_id}, expected {want_id}")
            print(pln.describe(), flush=True)
            t0 = time.perf_counter()
            exe = pln.compile()
            compile_s = time.perf_counter() - t0
            prog = exe.program
            kernel = "coo_spmv" if prog.kind == "coo" else "bcoo_spmv"
            lat = {1: [], 8: [], 64: []}
            for i in range(MAIN_REQUESTS):
                batch = None if i < MAIN_REQUESTS - 4 else (8, 64)[i % 2]
                xshape = (shape[1],) if batch is None else (shape[1], batch)
                x = rng.integers(-2, 3, xshape).astype(np.float32)
                t0 = time.perf_counter()
                y = exe(x) if batch is None else exe.batch(x)
                lat[batch or 1].append(time.perf_counter() - t0)
                requests[prog.kind] += 1
                requests[prog.kind + ".spmm"] += batch is not None
                check(y.shape == (shape[0],) + xshape[1:] and np.isfinite(y).all(),
                      f"{name}/{pln.fmt}: bad answer shape {y.shape}")
                xd = torch.from_numpy(x).to(device)
                plain = prog.plain(xd).cpu().numpy()
                lib = (A @ xd).cpu().numpy()
                errs[kernel] = max(errs[kernel], float(np.abs(y - plain).max()))
                check(np.array_equal(y, plain),
                      f"{name}/{pln.fmt} request {i}: kernel != plain version")
                check(np.array_equal(y, lib),
                      f"{name}/{pln.fmt} request {i}: kernel != cuSPARSE")
            emit({"phase": "main_path", "matrix": name, "fmt": pln.fmt,
                  "scheme_id": pln.scheme_id, "requests": 20, "compile_s": compile_s,
                  "host_ms_p50": {b: 1e3 * statistics.median(v)
                                  for b, v in lat.items()},
                  "answers": "bit-equal to plain and cuSPARSE"})
            records.append(dict(matrix=name, fmt=pln.fmt, kernel=kernel, exe=exe,
                                prog=prog, A=A, st=st, shape=shape, sm=sm,
                                host_ms=1e3 * statistics.median(lat[1])))
        del sm
    got = {k: instrument.launches(k) for k in requests}
    emit({"phase": "launch_counts", "launches": got, "requests": requests})
    return got, requests


def kernel_route(prog, batch: int) -> str:
    """The route of the block kernel that a program takes at B (COO: one)."""
    if prog.kind != "bcoo":
        return "coo"
    from repro_torch.kernels.bcsr_spmv import block_route

    return block_route(prog.bvalues.dtype, *prog.bvalues.shape[-2:], batch)


def phase_times(torch, rng, device, records) -> dict:
    """Kernel, plain and cuSPARSE times at the main-path shapes."""
    rows = {}
    for rec in records:
        prog, A, st = rec["prog"], rec["A"], rec["st"]
        rows_, cols = rec["shape"]
        for batch in (1, 8, 64):
            xshape = (cols,) if batch == 1 else (cols, batch)
            x = rng.integers(-2, 3, xshape).astype(np.float32)
            x = torch.from_numpy(x).to(device)
            if prog.kind == "coo":
                nbytes = st.nnz * (8 + 4)
            else:
                r, c = prog.bvalues.shape[1:]
                nbytes = prog.nblocks * (r * c * 4 + 4) + (prog.browptr.numel()) * 4
            nbytes += cols * batch * 4 + rows_ * batch * 4
            ops_ = 2 * st.nnz * batch
            by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, ops_ / F32_OPS_S * 1e3
            row = {
                "matrix": rec["matrix"], "fmt": rec["fmt"], "kernel": rec["kernel"],
                "B": batch, "nnz": st.nnz, "route": kernel_route(prog, batch),
                "ms": time_ms(torch, lambda: prog(x), 30),
                "plain_ms": time_ms(torch, lambda: prog.plain(x), 5, warmup=1),
                "library_ms": time_ms(torch, lambda: A @ x, 30),
                "bound_ms": max(by_bytes, by_ops),
                "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                "bytes": nbytes,
            }
            row["roofline_share"] = row["bound_ms"] / row["ms"]
            if batch == 1:
                row["host_exe_ms_p50"] = rec["host_ms"]
            emit({"phase": "times", **row})
            rows[(rec["matrix"], rec["fmt"], batch)] = row
    return rows


def phase_pieces(torch, rng, device, records) -> list:
    """The piece size M of the COO kernel: the single-device COO plans at
    B=1 with pieces of at most M chunks (answers equal at every M), and at
    the default M the device time of its two passes from torch.profiler."""
    from repro_torch.kernels.coo_spmv import PIECE_CHUNKS, coo_spmv, plan_pieces

    rows_out = []
    for rec in records:
        if rec["fmt"] != "coo":
            continue
        prog = rec["prog"]
        x = torch.from_numpy(rng.integers(-2, 3, rec["shape"][1])
                             .astype(np.float32)).to(device)
        want = prog(x)
        for M in (8, 16, 32, 64, 128):
            pieces, splits = plan_pieces(prog.plan.window_start, M)
            plan = dataclasses.replace(prog.plan, pieces=pieces.to(device),
                                       splits=splits.to(device))
            check(torch.equal(coo_spmv(plan, x), want),
                  f"{rec['matrix']}: pieces of {M} chunks change the answer")
            row = {"matrix": rec["matrix"], "M": M, "default": M == PIECE_CHUNKS,
                   "pieces": int((plan.pieces[:, 0] >= 0).sum()),
                   "slots": int(plan.splits.shape[0]),
                   "ms": time_ms(torch, lambda: coo_spmv(plan, x), 30)}
            emit({"phase": "piece_size", **row})
            rows_out.append(row)
        emit({"phase": "coo_passes", "matrix": rec["matrix"],
              **device_split(torch, lambda: prog(x), ("coo_piece_kernel",
                                                      "coo_merge_kernel"))})
    return rows_out


def device_split(torch, fn, names, iters: int = 20) -> dict:
    """Mean device ms per call of each named kernel, from torch.profiler;
    {"profiler": "not measured", ...} when the trace holds no device time."""
    try:
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = dict.fromkeys(names, 0.0)
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            us = getattr(ev, "cuda_time_total", 0.0) if us is None else us
            for name in names:
                if name in ev.key:
                    out[name] += us / 1e3 / iters
        if not any(out.values()):
            return {"profiler": "not measured: no device time in the trace"}
        return {f"{k}_ms": v for k, v in out.items()}
    except Exception as e:  # a measurement only; the checks stand apart
        return {"profiler": f"not measured: {type(e).__name__}: {e}"}


def ell_bound(rows: int, K: int, cols: int, batch: int, vbytes: int = 4,
              abytes: int = 4):
    """(bound ms, bound_by, bytes): the ELL arrays, row_nnz, x and y moved
    once; 2 operations per real slot and column."""
    nbytes = rows * K * (4 + vbytes) + rows * 4 + cols * batch * vbytes \
        + rows * batch * abytes
    ops_ = 2 * rows * K * batch
    by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, ops_ / F32_OPS_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations"), nbytes


def phase_ell_kernel(torch, rng, device, n: int, errs: dict) -> None:
    """The ELL kernel vs its plain version at 65,536^2 with K = 16 and 48."""
    from repro_torch.core import formats as F
    from repro_torch.kernels.ell_spmv import _pack_ell, ell_spmv, ell_spmv_plain

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "i8": torch.int8,
              "i32": torch.int32}
    cases = [(name, dt, True, per) for per in (16, 48)
             for name, dt in dtypes.items()]
    cases += [("f32-random", torch.float32, False, per) for per in (16, 48)]
    for name, dtype, integer, per in cases:
        ri, ci, vals, shape = random_triplets(rng, n, per, integer)
        ri, ci, v = F.coalesce(ri, ci, F.to_tensor(vals, dtype), shape)
        arrs = [t.to(device) for t in _pack_ell(ri, ci, v, n, per)]
        case_err = 0.0
        for batch in (None, 8, 40):
            xshape = (n,) if batch is None else (n, batch)
            xv = (rng.integers(-2, 3, xshape) if integer
                  else rng.standard_normal(xshape))
            x = torch.from_numpy(xv).to(device, dtype)
            got, want = ell_spmv(*arrs, x), ell_spmv_plain(*arrs, x)
            torch.cuda.synchronize()
            check(got.dtype == want.dtype and got.shape == want.shape,
                  f"ell_spmv {name} B={batch}: {got.dtype}{tuple(got.shape)} "
                  f"vs plain {want.dtype}{tuple(want.shape)}")
            err = max_err(torch, got, want)
            case_err = max(case_err, err)
            if integer:
                check(torch.equal(got, want),
                      f"ell_spmv {name} B={batch}: max |kernel - plain| = {err}")
            else:
                check(torch.allclose(got, want, rtol=2e-4, atol=2e-4),
                      f"ell_spmv {name} B={batch}: max |kernel - plain| = {err}")
            if batch is not None:
                check(torch.equal(ell_spmv(*arrs, x, 8), got),
                      f"ell_spmv {name} B={batch}: batch tiles 8 and 32 differ")
        emit({"phase": "kernel_vs_plain", "kernel": "ell_spmv", "values": name,
              "shape": [n, n], "K": int(arrs[0].shape[1]),
              "slots": int(arrs[2].sum()), "max_abs_err": case_err, "ok": True})
        errs["ell_spmv"] = max(errs["ell_spmv"], case_err)
    torch.cuda.empty_cache()


def phase_ell_path(torch, rng, device, records, errs) -> tuple:
    """The ELL path at full width through ``kernels.ell_spmv``."""
    from repro_torch.kernels import ell_spmv, instrument
    from repro_torch.kernels.ell_spmv import _pack_ell, ell_spmv_plain

    by_matrix = {r["matrix"]: r for r in records}
    emit({"phase": "ell_path", "matrix": "scale-free", "skipped": True,
          "why": "its densest row has 2,097,152 nonzeros, so ELL would pad "
                 "every row to K = 2,097,152"})
    cells = []
    for name, K in (("regular", 16), ("block", 48)):
        rec = by_matrix[name]
        rows, cols = rec["shape"]
        t0 = time.perf_counter()
        ri, ci, vals = rec["sm"].coalesced()
        arrs = [t.to(device) for t in _pack_ell(ri, ci, vals, rows, K)]
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        slots = rows * K
        check(int(arrs[2].sum()) == slots == rec["st"].nnz,
              f"ELL {name}: K={K} pads or drops slots")
        cells.append((name, K, rec, arrs, pack_s))
    instrument.reset()
    requests = 0
    for name, K, rec, arrs, pack_s in cells:
        rows, cols = rec["shape"]
        for i in range(10):
            batch = None if i < 8 else 8
            xshape = (cols,) if batch is None else (cols, batch)
            x = torch.from_numpy(rng.integers(-2, 3, xshape).astype(np.float32)
                                 ).to(device)
            y = ell_spmv(*arrs, x)
            requests += 1
            plain, lib = ell_spmv_plain(*arrs, x), rec["A"] @ x
            errs["ell_spmv"] = max(errs["ell_spmv"], max_err(torch, y, plain))
            check(torch.equal(y, plain), f"ELL {name} request {i}: != plain")
            check(torch.equal(y, lib), f"ELL {name} request {i}: != cuSPARSE")
    launches = instrument.launches("ell")
    check(launches == requests, f"ELL launches {launches} != requests {requests}")
    rows_out = {}
    for name, K, rec, arrs, pack_s in cells:
        rows, cols = rec["shape"]
        x = torch.from_numpy(rng.integers(-2, 3, cols).astype(np.float32)
                             ).to(device)
        bound, by, nbytes = ell_bound(rows, K, cols, 1)
        row = {"matrix": name, "K": K, "slots": rows * K, "pack_s": pack_s,
               "ms": time_ms(torch, lambda: ell_spmv(*arrs, x), 30),
               "plain_ms": time_ms(torch, lambda: ell_spmv_plain(*arrs, x), 5,
                                   warmup=1),
               "library_ms": time_ms(torch, lambda: rec["A"] @ x, 30),
               "bound_ms": bound, "bound_by": by, "bytes": nbytes}
        row["roofline_share"] = bound / row["ms"]
        emit({"phase": "ell_times", **row})
        rows_out[name] = row
    emit({"phase": "ell_launch_counts", "launches": launches,
          "requests": requests, "answers": "bit-equal to plain and cuSPARSE"})
    return launches, rows_out


def part_bound(prog, st, batch: int = 1):
    """(bound ms, bound_by): the parts' nonzeros (or blocks), x and the
    per-part y slices moved once."""
    part = prog.mat
    P = part.n_parts
    if part.fmt in ("coo", "csr"):
        nbytes = st.nnz * (8 + 4)
    else:
        r, c = part.block
        nbytes = int(part.nnz.sum()) * (r * c * 4 + 4)
    nbytes += part.shape[1] * batch * 4 + P * part.h_pad * batch * 4
    ops_ = 2 * st.nnz * batch
    by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, ops_ / F32_OPS_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def phase_partitioned(torch, rng, device, records, n_ring: int) -> tuple:
    """The partitioned path: P = 16 parts on the card, one part-axis launch
    per request."""
    from repro_torch.api import SparseMatrix, plan_from_partitioned
    from repro_torch.core import distributed as D
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.partition import partition_1d_coalesced
    from repro_torch.kernels import instrument

    by_matrix = {}
    for r in records:
        by_matrix.setdefault(r["matrix"], r)
    plans = [("regular", dict(scheme="auto")), ("scale-free", dict(scheme="auto")),
             ("block", dict(scheme="auto")), ("regular", dict(scheme="1d.nnz")),
             ("regular", dict(scheme="2d.equally-wide")),
             ("regular", dict(scheme="2d.variable-sized"))]
    built = []
    for name, kw in plans:
        rec = by_matrix[name]
        pln = rec["sm"].plan(devices=[device] * PARTS, **kw)
        exe = pln.compile()
        print(pln.describe(), flush=True)
        built.append((name, pln, exe, rec))
        emit({"phase": "partitioned_plan", "matrix": name, "scheme_id": pln.scheme_id,
              "grid": list(pln.grid), "partition_s": exe.build_seconds,
              "h_pad": exe.part.h_pad, "w_pad": exe.part.w_pad,
              "padding_efficiency": exe.part.padding_efficiency})
    requests = {"coo": 0, "coo.spmm": 0, "bcoo": 0, "bcoo.spmm": 0}
    launches = dict.fromkeys(requests, 0)
    lat = {}
    for name, pln, exe, rec in built:
        kind = "coo" if pln.fmt in ("coo", "csr") else "bcoo"
        shape = rec["shape"]
        xs = [rng.integers(-2, 3, (shape[1],) if i < PART_REQUESTS - 2 else
                           (shape[1], (8, 64)[i % 2])).astype(np.float32)
              for i in range(PART_REQUESTS)]
        # the single-device kernel's answers, launched before this plan's
        # counted requests
        singles = [rec["prog"](torch.from_numpy(x).to(device)) for x in xs]
        lat[(name, pln.scheme_id)] = []
        instrument.reset()
        for i, x in enumerate(xs):
            t0 = time.perf_counter()
            y = exe(x) if x.ndim == 1 else exe.batch(x)
            if x.ndim == 1:
                lat[(name, pln.scheme_id)].append(time.perf_counter() - t0)
            requests[kind] += 1
            requests[kind + ".spmm"] += x.ndim == 2
            check(y.shape == (shape[0],) + x.shape[1:] and np.isfinite(y).all(),
                  f"{name}/{pln.scheme_id}: bad answer shape {y.shape}")
            check(np.array_equal(y, singles[i].cpu().numpy()),
                  f"{name}/{pln.scheme_id} request {i}: != single-device kernel")
            lib = rec["A"] @ torch.from_numpy(x).to(device)
            check(np.array_equal(y, lib.cpu().numpy()),
                  f"{name}/{pln.scheme_id} request {i}: != cuSPARSE")
        for k in launches:
            launches[k] += instrument.launches(k)
        del singles
    emit({"phase": "partitioned_launch_counts", "launches": launches,
          "requests": requests})
    check(launches == requests,
          f"partitioned launch counters {launches} != requests {requests}")

    rows_out = []
    for name, pln, exe, rec in built:
        prog, local = exe.program, exe.program.local
        arrs = D._flat(exe.arrays) if pln.partitioning == "2d" else exe.arrays
        err = 0.0
        for batch in (None, 8):
            xshape = (rec["shape"][1],) if batch is None else (rec["shape"][1],
                                                               batch)
            xb = prog.x_buffer(exe.place(rng.integers(-2, 3, xshape)
                                         .astype(np.float32)))
            got, want = local.raw(arrs, xb), local.plain(arrs, xb)
            torch.cuda.synchronize()
            err = max(err, max_err(torch, got, want))
            check(torch.equal(got, want),
                  f"{name}/{pln.scheme_id} B={batch}: part-axis launch != its "
                  f"per-part plain versions (max err {err})")
        xb = prog.x_buffer(exe.place(rng.integers(-2, 3, rec["shape"][1])
                                     .astype(np.float32)))
        xd = xb[: rec["shape"][1]].contiguous()
        bound, by = part_bound(prog, rec["st"])
        row = {"matrix": name, "scheme_id": pln.scheme_id, "grid": list(pln.grid),
               "kernel": rec["kernel"], "route": kernel_route(rec["prog"], 1),
               "partition_s": exe.build_seconds,
               "exe_ms_p50": 1e3 * statistics.median(lat[(name, pln.scheme_id)]),
               "single_exe_ms_p50": rec["host_ms"],
               "part_ms": time_ms(torch, lambda: local.raw(arrs, xb), 30),
               "single_ms": time_ms(torch, lambda: rec["prog"](xd), 30),
               "part_plain_ms": time_ms(torch, lambda: local.plain(arrs, xb), 3,
                                        warmup=1),
               "library_ms": time_ms(torch, lambda: rec["A"] @ xd, 30),
               "bound_ms": bound, "bound_by": by, "max_abs_err": err}
        emit({"phase": "partitioned_times", **row})
        rows_out.append(row)

    # the 1D ring: torch local kernel only (the reference runs it under xla)
    ri, ci, vals, shape = regular_triplets(rng, n_ring)
    sm = SparseMatrix.from_parts(ri, ci, vals, shape)
    part = partition_1d_coalesced(*sm.triplets(), shape, PARTS, "coo", "nnz")
    part_r, counts = D.bucket_by_source_shard(part, PARTS)
    mesh = make_mesh((PARTS,), ("parts",), [device] * PARTS)
    exe = plan_from_partitioned(part_r, mesh, impl="torch", ring=True,
                                ring_counts=counts, matrix=sm).compile()
    A = library_csr(torch, sm, device)
    instrument.reset()
    t_ring = []
    for i in range(6):
        batch = None if i < 4 else 8
        xshape = (shape[1],) if batch is None else (shape[1], batch)
        x = rng.integers(-2, 3, xshape).astype(np.float32)
        t0 = time.perf_counter()
        y = exe(x)
        t_ring.append(time.perf_counter() - t0)
        check(np.array_equal(y, (A @ torch.from_numpy(x).to(device)).cpu().numpy()),
              f"ring request {i}: != cuSPARSE")
    check(instrument.launches() == 0, "the ring launched a CUDA kernel")
    emit({"phase": "ring", "shape": list(shape), "nnz": sm.nnz,
          "scheme_id": exe.plan.scheme_id, "requests": 6,
          "exe_ms_p50": 1e3 * statistics.median(t_ring),
          "answers": "bit-equal to cuSPARSE"})
    autos = [(name, exe, rec) for (name, pln, exe, rec), (_, kw)
             in zip(built, plans) if kw["scheme"] == "auto"]
    return launches, rows_out, autos


# ------------------------------------------------------------- serving


def pctl(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q)) if values else 0.0


def served_multiplies(svc) -> int:
    """Engine multiplies a service ran: the batcher's coalesced batches plus
    the explicit batches it served (every served request that did not ride
    the batcher)."""
    mb = svc.batcher
    return mb.batches_run + (svc.served - mb.vectors_run)


def check_launches(svc, what: str) -> dict:
    """The COO + block launches since the last reset equal the engine's
    multiplies: one part-axis launch per coalesced or explicit batch."""
    from repro_torch.kernels import instrument

    got = {k: instrument.launches(k) for k in ("coo", "bcoo")}
    want = served_multiplies(svc)
    recorded = sum(bd["requests"] for bd in svc.engine.telemetry.breakdown().values())
    emit({"phase": "serve_launch_counts", "what": what, "launches": got,
          "batches_run": svc.batcher.batches_run,
          "explicit_batches": svc.served - svc.batcher.vectors_run,
          "engine_multiplies": recorded})
    check(sum(got.values()) == want == recorded,
          f"{what}: launches {got} != multiplies {want} (telemetry {recorded})")
    return got


def make_service(engine):
    from repro_torch.serve import AsyncSpmvService, TenantConfig

    return AsyncSpmvService(engine, tenants={
        t: TenantConfig(priority=c) for t, c in TENANTS.items()})


async def bounded(aw):
    return await asyncio.wait_for(aw, SERVE_WAIT_S)


async def direct_requests(torch, svc, name, rec, rng, device, singles: int) -> int:
    """``singles`` concurrent single vectors (tenants in turn) and explicit
    B=4 and B=8 batches, their payloads made beforehand; every answer
    bit-equal to cuSPARSE on the card.  Emits the burst's latencies, its
    throughput and the widths the engine served."""
    cols = rec["shape"][1]
    tenants = list(TENANTS)
    xs = [rng.integers(-2, 3, cols).astype(np.float32) for _ in range(singles)]
    xs += [rng.integers(-2, 3, (cols, b)).astype(np.float32) for b in (4, 8)]

    async def timed(tenant, x):
        t0 = time.perf_counter()
        y = await svc.multiply(tenant, name, x)
        return y, (time.perf_counter() - t0) * 1e3

    since = len(svc.engine.telemetry.records)
    t0 = time.perf_counter()
    done = await bounded(asyncio.gather(*[
        timed(tenants[i % len(tenants)], x) for i, x in enumerate(xs)]))
    wall_s = time.perf_counter() - t0
    lat = [ms for _, ms in done]
    emit({"phase": "serve_direct", "matrix": name, "requests": len(xs),
          "vectors": singles + 12, "wall_s": wall_s,
          "p50_ms": pctl(lat, 50), "p99_ms": pctl(lat, 99),
          "throughput_rps": len(xs) / wall_s,
          "widths": dict(sorted(collections.Counter(
              r.batch for r in svc.engine.telemetry.records[since:]).items()))})
    for i, (x, (y, _)) in enumerate(zip(xs, done)):
        lib = (rec["A"] @ torch.from_numpy(x).to(device)).cpu().numpy()
        check(y.shape == lib.shape and np.array_equal(y, lib),
              f"serving {name} request {i} (B={x.shape[1:] or 1}): != cuSPARSE")
    return len(xs)


def trace_rows(svc, start_mark: float, wall_s: float) -> dict:
    """Latency p50/p99 and throughput per matrix of the completed requests
    traced after ``start_mark`` (a trace's extent: admit to deliver)."""
    from repro_torch.obs import trace_summary

    spans = [s for s in svc.tracer.spans() if s.start_s >= start_mark]
    lat = collections.defaultdict(list)
    for t in trace_summary(spans).values():
        if "deliver" in t["phases"]:
            lat[t["label"].split("/", 1)[1]].append(t["total_s"] * 1e3)
    return {name: {"completed": len(v), "p50_ms": pctl(v, 50),
                   "p99_ms": pctl(v, 99), "throughput_rps": len(v) / wall_s}
            for name, v in lat.items()}


def payload_host_ms(trace, by_matrix) -> None:
    """Host time the replay spends making one payload (``request_vector``,
    on the event loop) per width, next to the trace's arrival span: where
    the payloads take longer than the gaps, the replay fires late."""
    from repro_torch.serve import request_vector

    ms = {}
    for b in sorted({r.batch for r in trace}):
        req = next(r for r in trace if r.batch == b)
        cols = by_matrix[req.name]["shape"][1]
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            request_vector(req, cols, integer=True)
            runs.append((time.perf_counter() - t0) * 1e3)
        ms[b] = statistics.median(runs)
    total_s = sum(ms[r.batch] for r in trace) / 1e3
    emit({"phase": "serve_payload", "host_ms_by_width": ms,
          "trace_payload_s": total_s, "trace_span_s": trace[-1].t})


def width_rows(torch, engine, since: int, block_shape: dict) -> dict:
    """Per matrix: the batch widths the engine served (telemetry records
    from index ``since``), the launches per kernel route they took, and the
    load / kernel / retrieve split of those requests."""
    from repro_torch.kernels.bcsr_spmv import block_route

    out = {}
    for r in engine.telemetry.records[since:]:
        row = out.setdefault(r.name, {"widths": collections.Counter(),
                                      "routes": collections.Counter(),
                                      "load_s": 0.0, "kernel_s": 0.0,
                                      "retrieve_s": 0.0})
        row["widths"][r.batch] += 1
        shape = block_shape.get(r.name)
        route = ("coo" if shape is None
                 else "bcoo." + block_route(torch.float32, *shape, r.batch))
        row["routes"][route] += 1
        for k in ("load_s", "kernel_s", "retrieve_s"):
            row[k] += getattr(r, k)
    for row in out.values():
        total = row["load_s"] + row["kernel_s"] + row["retrieve_s"]
        row["split"] = {k[:-2]: row[k] / total for k in ("load_s", "kernel_s",
                                                         "retrieve_s")}
        row["widths"] = dict(sorted(row["widths"].items()))
        row["routes"] = dict(row["routes"])
    return out


def block_widths(torch, rng, device, rec) -> list:
    """The block kernel at B = 1, 2, 4, 8 on the main-path block program:
    the route ``block_route`` takes, and the tensor-core route at B = 2 and
    4 for comparison (PERF.md's open question), each bit-equal to the plain
    version before it is timed."""
    from repro_torch.kernels.bcsr_spmv import bcoo_spmv_cuda, block_route

    prog, A, st = rec["prog"], rec["A"], rec["st"]
    rows_, cols = rec["shape"]
    r, c = prog.bvalues.shape[1:]
    out = []
    for batch in (1, 2, 4, 8):
        x = torch.from_numpy(rng.integers(-2, 3, (cols, batch)).astype(np.float32)
                             ).to(device)
        x = x[:, 0].contiguous() if batch == 1 else x
        want = prog.plain(x)
        default = block_route(prog.bvalues.dtype, r, c, batch)
        routes = [default] + (["mma"] if batch in (2, 4) else [])
        nbytes = (prog.nblocks * (r * c * 4 + 4) + prog.browptr.numel() * 4
                  + cols * batch * 4 + rows_ * batch * 4)
        ops_ = 2 * st.nnz * batch
        by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, ops_ / F32_OPS_S * 1e3
        for route in routes:
            fn = (lambda: bcoo_spmv_cuda(prog.browptr, prog.bcolind, prog.bvalues,
                                         x, prog.rows, route=route))
            got = fn()
            torch.cuda.synchronize()
            row = {"B": batch, "route": route, "taken_by_engine": route == default,
                   "bit_equal_to_plain": bool(torch.equal(got, want)),
                   "bound_ms": max(by_bytes, by_ops),
                   "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
            if route == default:
                check(row["bit_equal_to_plain"],
                      f"block kernel B={batch} ({route}): != plain version")
            if row["bit_equal_to_plain"]:
                row["ms"] = time_ms(torch, fn, 30)
                row["roofline_share"] = row["bound_ms"] / row["ms"]
            else:
                row["ms"] = "not measured: differs from the plain version"
            if route == default:
                row["plain_ms"] = time_ms(torch, lambda: prog.plain(x), 5, warmup=1)
                row["library_ms"] = time_ms(torch, lambda: A @ x, 30)
            emit({"phase": "block_batcher_widths", **row})
            out.append(row)
    return out


def phase_serving(torch, rng, device, records, seed: int) -> dict:
    """The serving path at full width: engine, batcher, service, replay."""
    from repro_torch.api import SparseMatrix
    from repro_torch.engine import SpmvEngine
    from repro_torch.kernels import instrument
    from repro_torch.obs.tracing import clock as obs_clock
    from repro_torch.serve import WorkloadSpec, generate_trace, replay

    by_matrix = {}
    for r in records:
        by_matrix.setdefault(r["matrix"], r)
    eng = SpmvEngine(cache_capacity=4)  # one part on the card
    for name, rec in by_matrix.items():
        t0 = time.perf_counter()
        entry = eng.register(name, rec["sm"])
        register_s = time.perf_counter() - t0
        cp = eng.plan_for(name)
        check(cp.impl == "cuda" and cp.executor.device.type == device.type,
              f"serving {name}: plan runs {cp.impl} on {cp.executor.device}")
        emit({"phase": "serve_register", "matrix": name, "shape": list(entry.shape),
              "nnz": entry.stats.nnz, "scheme_id": entry.plan.tag,
              "grid": list(entry.plan.grid), "register_s": register_s,
              "placed_bytes": sum(t.numel() * t.element_size()
                                  for t in cp.arrays.values())})
    block_shape = {n: tuple(eng.plan_for(n).part.block) for n in by_matrix
                   if eng.plan_for(n).plan.fmt in ("bcoo", "bcsr")}
    svc = make_service(eng)
    spec = WorkloadSpec(names=tuple(by_matrix), tenants=tuple(TENANTS),
                        n_requests=SERVE_REPLAY_REQUESTS, seed=seed, zipf_alpha=1.1,
                        rate_rps=300.0, arrivals="bursty", infeasible_frac=0.05,
                        integer_values=True, tenant_classes=TENANTS)
    trace = generate_trace(spec)

    async def run():
        svc.start()
        try:
            direct = 0
            for name, rec in by_matrix.items():
                direct += await direct_requests(torch, svc, name, rec, rng, device, 64)
            since, mark = len(eng.telemetry.records), obs_clock()
            report = await bounded(replay(svc, trace, time_scale=1.0,
                                          integer_values=True))
            return direct, since, mark, report
        finally:
            await bounded(svc.aclose())
            svc.batcher.stop(drain=False)

    instrument.reset()
    direct, since, mark, report = asyncio.run(run())
    launches = check_launches(svc, "full-width service")
    n_inf = sum(r.infeasible for r in trace)
    emit({"phase": "serve_replay", "requests": report.requests,
          "completed": report.completed, "rejected": report.rejected,
          "reject_reasons": report.reject_reasons, "errors": report.errors,
          "lost": report.lost, "infeasible": n_inf,
          "infeasible_rejected": report.infeasible_rejected,
          "infeasible_served": report.infeasible_served, "wall_s": report.wall_s,
          "throughput_rps": report.throughput_rps, "latency": report.latency,
          "phases": report.phases, "queue_wait": report.queue_wait,
          "direct_requests": direct})
    check(report.lost == 0 and report.errors == 0,
          f"replay lost {report.lost}, errors {report.errors}")
    check(report.infeasible_rejected == n_inf and report.infeasible_served == 0,
          f"replay shed {report.infeasible_rejected} of {n_inf} expired requests")
    payload_host_ms(trace, by_matrix)
    per_matrix = trace_rows(svc, mark, report.wall_s)
    widths = width_rows(torch, eng, since, block_shape)
    for name in by_matrix:
        emit({"phase": "serve_matrix", "matrix": name, **per_matrix.get(name, {}),
              **widths.get(name, {})})
    for cls, d in sorted(report.per_class.items()):
        emit({"phase": "serve_class", "class": cls,
              "throughput_rps": d["completed"] / report.wall_s, **d})

    # eviction: a plan evicted from a one-plan cache frees its card memory
    ev = SpmvEngine(cache_capacity=1)
    ev.register("block", by_matrix["block"]["sm"], warmup=False)
    evicted = ev.plan_for("block")
    placed = sum(t.numel() * t.element_size() for t in evicted.arrays.values())
    ri, ci, vals, shape = regular_triplets(rng, 1 << 16)
    fourth = SparseMatrix.from_parts(ri, ci, vals, shape)
    probe = SpmvEngine(cache_capacity=1)  # the fourth plan's own allocation
    torch.cuda.synchronize()
    m = torch.cuda.memory_allocated()
    probe.register("fourth", fourth, warmup=False)
    torch.cuda.synchronize()
    alloc_fourth = torch.cuda.memory_allocated() - m
    del probe
    gc.collect()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    ev.register("fourth", fourth, warmup=False)  # evicts the block plan
    torch.cuda.synchronize()
    m1 = torch.cuda.memory_allocated()
    freed = m0 + alloc_fourth - m1
    emit({"phase": "serve_eviction", "evicted_placed_bytes": placed,
          "freed_bytes": freed, "fourth_plan_bytes": alloc_fourth,
          "evictions": ev.cache.stats.evictions})
    check(ev.cache.stats.evictions == 1 and evicted.arrays is None,
          "eviction: the block plan was not evicted")
    check(freed >= placed, f"eviction freed {freed} bytes < placed {placed}")
    del ev, evicted

    # the same service over 16 parts of the card
    e16 = SpmvEngine(devices=[device] * PARTS)
    rec = by_matrix["regular"]
    entry = e16.register("regular", rec["sm"])
    svc16 = make_service(e16)

    async def run16():
        svc16.start()
        try:
            return await direct_requests(torch, svc16, "regular", rec, rng, device, 16)
        finally:
            await bounded(svc16.aclose())
            svc16.batcher.stop(drain=False)

    instrument.reset()
    n16 = asyncio.run(run16())
    launches16 = check_launches(svc16, f"16-part service {entry.plan.tag}")
    emit({"phase": "serve_parts", "matrix": "regular", "scheme_id": entry.plan.tag,
          "grid": list(entry.plan.grid), "requests": n16,
          "widths": dict(sorted(collections.Counter(
              r.batch for r in e16.telemetry.records).items())),
          "answers": "bit-equal to cuSPARSE"})
    del e16, svc16
    block_widths(torch, rng, device, by_matrix["block"])
    return {k: launches[k] + launches16[k] for k in launches}, eng


def phase_serving_oracle(torch, rng, device, n: int, seed: int) -> dict:
    """A replay at n^2 over the three recipes with dense oracles on the
    card: every completed answer bit-equal."""
    from repro_torch.api import SparseMatrix
    from repro_torch.engine import SpmvEngine
    from repro_torch.kernels import instrument
    from repro_torch.serve import WorkloadSpec, generate_trace, replay

    makers = {"regular": lambda: regular_triplets(rng, n),
              "scale-free": lambda: scale_free_triplets(rng, n, 8 * n),
              "block": lambda: block_triplets(rng, n)}
    eng = SpmvEngine(cache_capacity=4)
    svc = make_service(eng)
    oracles = {}
    for name, make in makers.items():
        ri, ci, vals, shape = make()
        sm = SparseMatrix.from_parts(ri, ci, vals, shape)
        svc.register(None, name, sm)
        dense = torch.zeros(shape, dtype=torch.float32, device=device)
        cri, cci, cv = sm.coalesced()
        dense[cri.to(device), cci.to(device)] = cv.to(device)
        oracles[name] = dense
    spec = WorkloadSpec(names=tuple(makers), tenants=tuple(TENANTS),
                        n_requests=120, seed=seed + 1, rate_rps=300.0,
                        arrivals="bursty", infeasible_frac=0.05,
                        integer_values=True, tenant_classes=TENANTS)
    trace = generate_trace(spec)

    async def run():
        svc.start()
        try:
            return await bounded(replay(svc, trace, oracles=oracles, time_scale=0.0,
                                        integer_values=True))
        finally:
            await bounded(svc.aclose())
            svc.batcher.stop(drain=False)

    instrument.reset()
    report = asyncio.run(run())
    launches = check_launches(svc, f"{n}^2 oracle replay")
    emit({"phase": "serve_oracle_replay", "shape": [n, n],
          "requests": report.requests, "completed": report.completed,
          "rejected": report.rejected, "errors": report.errors, "lost": report.lost,
          "verified": report.verified, "bitexact": report.bitexact,
          "max_abs_err": report.max_abs_err, "oracles": "dense, on the card"})
    check(report.lost == 0 and report.errors == 0,
          f"oracle replay lost {report.lost}, errors {report.errors}")
    check(report.bitexact == report.verified == report.completed > 0,
          f"oracle replay: {report.bitexact} bit-exact of {report.verified} "
          f"verified of {report.completed} completed")
    check(report.infeasible_rejected == sum(r.infeasible for r in trace),
          "oracle replay: an expired request was not shed")
    solver = solver_replay(torch, eng, oracles, makers, seed)
    return launches, solver


# ------------------------------------------------------------- solver sessions


def session_launches(engine, since: int) -> int:
    """Launches the engine's requests since telemetry record ``since`` made:
    one per multiply, ``steps`` per solver session (power sessions spend no
    extra multiply on their start)."""
    return sum(r.steps if r.kind == "solve" else 1
               for r in engine.telemetry.records[since:])


def host_power_ms(exe, x0, steps: int = 10) -> float:
    """ms per step of the host loop a session replaces: ``exe(x)`` (x and y
    cross to the card and back) plus the normalization in numpy."""
    x = x0
    t0 = time.perf_counter()
    for _ in range(steps):
        y = exe(x)
        x = y / max(float(np.linalg.norm(y)), 1e-30)
    return (time.perf_counter() - t0) * 1e3 / steps


def phase_solver(torch, rng, device, records, autos, times) -> dict:
    """Phase 10 (a)-(c): solver sessions through ``exe.iterate`` at full
    width on the card — plain parity, tol mode, per-step times."""
    from repro_torch.api import SparseMatrix
    from repro_torch.kernels import instrument

    launches, want = {"coo": 0, "bcoo": 0}, {"coo": 0, "bcoo": 0}

    def counted(kind, steps, fn):
        instrument.reset()
        out = fn()
        for k in launches:
            launches[k] += instrument.launches(k)
        want[kind] += steps
        return out

    # (a) plain, 3 steps: bit-equal to 3 host exe(x) calls (and, where every
    # partial sum stays below 2^24, to 3 cuSPARSE products)
    plans = [(r["matrix"], r["fmt"], r["exe"], r) for r in records]
    plans += [(name, f"{exe.plan.scheme_id} ({PARTS} parts)", exe, rec)
              for name, exe, rec in autos]
    for name, label, exe, rec in plans:
        n = rec["shape"][1]
        kind = "coo" if exe.plan.fmt in ("coo", "csr") else "bcoo"
        x0 = rng.integers(-2, 3, n).astype(np.float32)
        x = x0
        for _ in range(3):
            x = exe(x)
        res = counted(kind, 3, lambda: exe.iterate(x0, steps=3, combine="plain"))
        check(res.steps == 3 and res.x.shape == (n,) and np.isfinite(res.x).all(),
              f"solver {name}/{label}: bad session {res.steps} {res.x.shape}")
        check(np.array_equal(res.x, x),
              f"solver {name}/{label}: 3 plain steps != 3 host exe(x) calls")
        lib = None
        if name in ("regular", "block"):
            xd = torch.from_numpy(x0).to(device)
            for _ in range(3):
                xd = rec["A"] @ xd
            lib = bool(np.array_equal(res.x, xd.cpu().numpy()))
            check(lib, f"solver {name}/{label}: 3 plain steps != 3 cuSPARSE products")
        emit({"phase": "solver_plain", "matrix": name, "plan": label, "steps": 3,
              "equal_host_loop": True, "equal_cusparse": lib,
              "kernel_s": res.kernel_s})

    # (b) tol mode: Jacobi on the regular recipe plus 64 on the diagonal
    n = records[0]["shape"][1]
    ri, ci, vals, shape = regular_triplets(rng, n)
    diag_idx = np.arange(n)
    sm = SparseMatrix.from_parts(np.concatenate([ri, diag_idx]),
                                 np.concatenate([ci, diag_idx]),
                                 np.concatenate([vals, np.full(n, 64, np.float32)]),
                                 shape)
    del ri, ci, vals
    cri, cci, cv = sm.coalesced()
    on = cri == cci
    diag = np.zeros(n, np.float32)
    diag[cri[on].numpy()] = cv[on].numpy()
    check(bool((diag >= 62).all()), "jacobi matrix: a diagonal entry below 62")
    exe = sm.plan(scheme="auto", device=device).compile()
    b = rng.integers(-2, 3, n).astype(np.float32)
    kind = "coo" if exe.plan.fmt in ("coo", "csr") else "bcoo"
    res = exe.iterate(np.zeros(n, np.float32), tol=1e-2, combine="jacobi", b=b,
                      diag=diag, check_every=8, max_steps=200)  # cold, uncounted
    res = counted(kind, res.steps, lambda: exe.iterate(
        np.zeros(n, np.float32), tol=1e-2, combine="jacobi", b=b, diag=diag,
        check_every=8, max_steps=200))
    check(res.converged and res.steps % 8 == 0 and res.steps < 200,
          f"jacobi: converged={res.converged} after {res.steps} steps")
    x = np.zeros(n, np.float32)
    for _ in range(res.steps):
        x = x + (b - exe(x)) / diag
    check(x.dtype == np.float32 and np.array_equal(res.x, x),
          f"jacobi: {res.steps} steps != the numpy float32 host loop")
    emit({"phase": "solver_tol", "matrix": "regular + 64 I", "shape": list(shape),
          "nnz": sm.nnz, "scheme_id": exe.plan.scheme_id, "steps": res.steps,
          "residual": res.residual, "converged": res.converged,
          "per_iter_us": res.per_iter_s * 1e6, "equal_host_loop": True})
    del exe, sm

    # (c) times: 100-step power sessions, cold (first of its loop) and warm
    for rec in records:
        if (rec["matrix"], rec["fmt"]) not in (("regular", "coo"),
                                               ("scale-free", "coo"),
                                               ("block", "bcoo")):
            continue
        exe, n = rec["exe"], rec["shape"][1]
        kind = "coo" if rec["fmt"] == "coo" else "bcoo"
        x0 = rng.integers(-2, 3, n).astype(np.float32)
        sessions = [counted(kind, 100, lambda: exe.iterate(
            x0, steps=100, combine="power")) for _ in range(4)]
        check(sessions[0].compiled and not any(r.compiled for r in sessions[1:]),
              f"solver {rec['matrix']}: the first power session is not the cold one")
        check(all(np.array_equal(r.x, sessions[0].x) for r in sessions)
              and np.isfinite(sessions[0].x).all(),
              f"solver {rec['matrix']}: power sessions disagree")
        warm = [r.per_iter_s * 1e6 for r in sessions[1:]]
        row = {"matrix": rec["matrix"], "fmt": rec["fmt"], "steps": 100,
               "per_iter_us_cold": sessions[0].per_iter_s * 1e6,
               "per_iter_us_warm": statistics.median(warm),
               "per_iter_us_warm_runs": warm,
               "load_ms_warm": sessions[-1].load_s * 1e3,
               "retrieve_ms_warm": sessions[-1].retrieve_s * 1e3,
               "kernel_ms_b1": times[(rec["matrix"], rec["fmt"], 1)]["ms"],
               "host_loop_ms_per_step": host_power_ms(exe, x0)}
        emit({"phase": "solver_times", **row})
    emit({"phase": "solver_launch_counts", "launches": launches,
          "steps": want})
    check(launches == want, f"solver launches {launches} != steps {want}")
    return launches


def phase_solver_service(torch, rng, device, engine, records) -> dict:
    """Phase 10 (d): four concurrent 20-step power sessions per matrix on
    phase 8's engine, under a burst of 64 single multiplies on the same
    matrix; multiplies bit-equal to cuSPARSE, sessions within 1e-4 of a
    float64 power loop (cuSPARSE in float64 on the card)."""
    from repro_torch.kernels import instrument

    by_matrix = {}
    for r in records:
        by_matrix.setdefault(r["matrix"], r)
    svc = make_service(engine)
    tenants = list(TENANTS)
    work = {}
    for name, rec in by_matrix.items():
        cols = rec["shape"][1]
        work[name] = ([rng.standard_normal(cols).astype(np.float32)
                       for _ in range(4)],
                      [rng.integers(-2, 3, cols).astype(np.float32)
                       for _ in range(64)])

    async def run():
        svc.start()
        try:
            out = {}
            for name, (x0s, xs) in work.items():
                coros = [svc.solve(tenants[i % 3], name, x0, steps=20,
                                   combine="power") for i, x0 in enumerate(x0s)]
                coros += [svc.multiply(tenants[i % 3], name, x)
                          for i, x in enumerate(xs)]
                t0 = time.perf_counter()
                done = await bounded(asyncio.gather(*coros))
                out[name] = (done, time.perf_counter() - t0)
            return out
        finally:
            await bounded(svc.aclose())
            svc.batcher.stop(drain=False)

    since = len(engine.telemetry.records)
    instrument.reset()
    out = asyncio.run(run())
    launches = {k: instrument.launches(k) for k in ("coo", "bcoo")}
    recs = engine.telemetry.records[since:]
    expect = session_launches(engine, since)
    emit({"phase": "solver_serve_launch_counts", "launches": launches,
          "multiplies": sum(r.kind == "multiply" for r in recs),
          "session_steps": sum(r.steps for r in recs if r.kind == "solve")})
    check(sum(launches.values()) == expect,
          f"solver service: launches {launches} != multiplies + steps {expect}")
    max_err = 0.0
    for name, (done, wall_s) in out.items():
        rec = by_matrix[name]
        x0s, xs = work[name]
        mine = [r for r in recs if r.name == name]
        solves = [r for r in mine if r.kind == "solve"]
        check(len(solves) == 4 and all(r.steps == 20 for r in solves),
              f"solver service {name}: solve records {[r.steps for r in solves]}")
        for i, (x, y) in enumerate(zip(xs, done[4:])):
            lib = (rec["A"] @ torch.from_numpy(x).to(device)).cpu().numpy()
            check(np.array_equal(y, lib),
                  f"solver service {name} multiply {i}: != cuSPARSE")
        csr = rec["A"]
        A64 = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                      csr.values().double(), size=csr.shape)
        for i, (x0, res) in enumerate(zip(x0s, done[:4])):
            x = torch.from_numpy(x0).to(device, torch.float64)
            for _ in range(20):
                y = A64 @ x
                x = y / max(float(torch.linalg.vector_norm(y)), 1e-30)
            err = float(np.abs(res.x.astype(np.float64) - x.cpu().numpy()).max())
            max_err = max(max_err, err)
            check(res.steps == 20 and err <= 1e-4,
                  f"solver service {name} session {i}: max err {err} vs float64")
        del A64
        muls = [r for r in mine if r.kind == "multiply"]
        split = {k: sum(getattr(r, k + "_s") for r in muls)
                 for k in ("load", "kernel", "retrieve")}
        total = sum(split.values())
        emit({"phase": "solver_serve", "matrix": name, "sessions": 4,
              "multiplies": len(muls), "wall_s": wall_s,
              "widths": dict(sorted(collections.Counter(
                  r.batch for r in muls).items())),
              "multiply_split": {k: v / total for k, v in split.items()},
              "multiply_kernel_ms_mean": split["kernel"] * 1e3 / len(muls),
              "session_per_iter_us": [r.per_iter_s * 1e6 for r in solves],
              "session_ms": [r.total_s * 1e3 for r in solves],
              "sessions_max_abs_err_vs_f64": max_err})
    snap = svc.metrics.snapshot()
    emit({"phase": "solver_serve_metrics",
          "per_iter_us": snap.get("serve.solve.per_iter_us"),
          "e2e_ms": snap.get("serve.solve.e2e_ms")})
    return launches


def solver_replay(torch, eng, oracles, makers, seed: int) -> dict:
    """Phase 10 (e): a replay with 30 % six-step power sessions over phase
    9's engine and dense oracles: every completed session verified."""
    from repro_torch.kernels import instrument
    from repro_torch.serve import WorkloadSpec, generate_trace, replay

    svc = make_service(eng)
    spec = WorkloadSpec(names=tuple(makers), tenants=tuple(TENANTS),
                        n_requests=120, seed=seed + 2, rate_rps=300.0,
                        arrivals="bursty", infeasible_frac=0.05,
                        integer_values=True, tenant_classes=TENANTS,
                        solve_frac=0.3, solve_steps=6, solve_combine="power")
    trace = generate_trace(spec)

    async def run():
        svc.start()
        try:
            return await bounded(replay(svc, trace, oracles=oracles, time_scale=0.0,
                                        integer_values=True))
        finally:
            await bounded(svc.aclose())
            svc.batcher.stop(drain=False)

    since = len(eng.telemetry.records)
    instrument.reset()
    report = asyncio.run(run())
    launches = {k: instrument.launches(k) for k in ("coo", "bcoo")}
    expect = session_launches(eng, since)
    emit({"phase": "solver_oracle_replay", "requests": report.requests,
          "completed": report.completed, "rejected": report.rejected,
          "errors": report.errors, "lost": report.lost,
          "sessions": sum(r.is_solve for r in trace), "solves": report.solves,
          "solve_iters": report.solve_iters,
          "solve_per_iter_us": report.solve_per_iter_us,
          "verified": report.verified, "bitexact": report.bitexact,
          "max_abs_err": report.max_abs_err, "launches": launches,
          "oracles": "dense, on the card"})
    check(report.lost == 0 and report.errors == 0,
          f"solver replay lost {report.lost}, errors {report.errors}")
    check(report.solves > 0 and report.verified == report.completed,
          f"solver replay: {report.verified} verified of {report.completed} "
          f"completed ({report.solves} sessions)")
    check(report.bitexact >= report.completed - report.solves
          and report.max_abs_err <= 1e-4,
          f"solver replay: {report.bitexact} bit-exact, max err {report.max_abs_err}")
    check(sum(launches.values()) == expect,
          f"solver replay: launches {launches} != multiplies + steps {expect}")
    return launches


# ------------------------------------------------------------- tuning


def total_launches(instrument) -> int:
    """Kernel launches of both kernels of the tuning path (the ``.spmm``
    keys count a subset again)."""
    return instrument.launches("coo") + instrument.launches("bcoo")


def add_launches(into: dict, instrument) -> dict:
    for k in into:
        into[k] += instrument.launches(k)
    return into


def kernel_fn(torch, exe, x, device):
    """The compiled program's kernel alone on input ``x``: the single-device
    kernel program, or the part-axis launch of a mesh executor."""
    if not exe.plan.is_distributed:
        prog = exe.program
        xd = torch.as_tensor(x).to(device)
        return lambda: prog(xd)
    from repro_torch.core import distributed as D

    prog, local = exe.program, exe.program.local
    arrs = D._flat(exe.arrays) if exe.plan.partitioning == "2d" else exe.arrays
    xb = prog.x_buffer(exe.place(x))
    return lambda: local.raw(arrs, xb)


def timed_measurer(torch, device):
    """The reference Measurer (warmup 2, iters 5, trim 1) that also times
    each candidate's kernel with CUDA events on the program it compiled,
    before measuring it, and logs every measurement and every exception."""
    from repro_torch.kernels import instrument
    from repro_torch.tune import Measurer

    class Timed(Measurer):
        def __init__(self):
            super().__init__()
            self.log, self.errors, self.timing_launches = [], [], 0

        def measure(self, plan, x):
            try:
                return super().measure(plan, x)
            except Exception as e:
                self.errors.append(f"{plan.scheme_id}: {type(e).__name__}: {e}")
                emit({"phase": "tune_error", "scheme_id": plan.scheme_id,
                      "error": self.errors[-1]})
                raise

        def _time(self, plan, exe, x, compile_s):
            n0 = total_launches(instrument)
            ms = time_ms(torch, kernel_fn(torch, exe, x, device), 20, warmup=2)
            self.timing_launches += total_launches(instrument) - n0
            m = super()._time(plan, exe, x, compile_s)
            self.log.append((m, ms))
            return m

    return Timed()


def winner_check(torch, exe, rec, device, rng, batch, what: str) -> None:
    """The winner's answers on an integer-valued x: bit-equal to cuSPARSE
    and to the plain version of the single-device kernel."""
    cols = rec["shape"][1]
    x = rng.integers(-2, 3, (cols,) if batch is None else (cols, batch)) \
        .astype(np.float32)
    xd = torch.from_numpy(x).to(device)
    y = exe(x)
    check(np.array_equal(y, (rec["A"] @ xd).cpu().numpy()),
          f"{what}: tuned winner != cuSPARSE")
    check(np.array_equal(y, rec["prog"].plain(xd).cpu().numpy()),
          f"{what}: tuned winner != plain version")


def tune_rows(what: dict, pln, timed) -> dict:
    """Emit one line per measured candidate and one for the tune: the
    winner, the analytic pick, and the candidates ranked by ``mean_s``
    (what the tuner ranks by: exe(x) with both copies) and by kernel ms."""
    log = timed.log
    by_mean = sorted(range(len(log)), key=lambda i: log[i][0].mean_s)
    by_kernel = sorted(range(len(log)), key=lambda i: log[i][1])
    for i, (m, ms) in enumerate(log):
        emit({"phase": "tune_candidate", **what, "scheme_id": m.scheme_id,
              "impl": m.impl, "grid": list(m.grid), "fmt": m.fmt,
              "mean_s": m.mean_s, "times_s": list(m.times_s),
              "compile_s": m.compile_s, "phases": m.phases, "kernel_ms": ms,
              "rank_by_mean": by_mean.index(i), "rank_by_kernel": by_kernel.index(i)})
    row = {"phase": "tune", **what, "winner": pln.scheme_id,
           "winner_fmt": pln.fmt, "analytic": pln.measured["baseline_scheme_id"],
           "speedup": pln.measured["speedup"], "measured": len(log),
           "fastest_kernel": log[by_kernel[0]][0].scheme_id,
           "fastest_kernel_fmt": log[by_kernel[0]][0].fmt,
           "rankings_agree": by_mean == by_kernel,
           "winner_fmt_has_fastest_kernel":
               pln.fmt == log[by_kernel[0]][0].fmt}
    emit(row)
    return row


# (a)'s matrices at B=1 (cut for the script's time from all three: the
# regular and block matrices' plans and answers are checked in phases 3, 7,
# 11 (d) and 13 still, the block matrix tuned at B=8 here and at B=1 under
# pim2x2 in phase 13 (e))
TUNE_SINGLE = ("scale-free",)


def phase_tune_single(torch, rng, device, by_matrix, path) -> tuple:
    """Phase 11 (a) and (b): single-device tuning at full width, B=1 on
    ``TUNE_SINGLE`` and B=8 on block, into one cache file; then
    the same tunes again from the file, measuring nothing."""
    from repro_torch.kernels import instrument
    from repro_torch.tune import CandidateGenerator, Tuner, TuningCache

    runs = [(name, None) for name in TUNE_SINGLE] + [("block", 8)]
    launches, rows = {"coo": 0, "bcoo": 0}, []
    for name, batch in runs:
        rec = by_matrix[name]
        sm = rec["sm"]
        planned = CandidateGenerator().plans(sm, device=device)
        timed = timed_measurer(torch, device)
        instrument.reset()
        t0 = time.perf_counter()
        pln = sm.plan(scheme="tune", device=device, batch=batch,
                      tuner=Tuner(measurer=timed, cache=TuningCache(path)))
        wall_s = time.perf_counter() - t0
        n = total_launches(instrument)
        add_launches(launches, instrument)
        what = {"matrix": name, "B": batch or 1}
        row = tune_rows(what, pln, timed)
        row.update(planned=len(planned), wall_s=wall_s, launches=n)
        rows.append(row)
        check(not timed.errors, f"tune {what}: candidates raised {timed.errors}")
        check(len(timed.log) == len(planned) == pln.measured["candidates"],
              f"tune {what}: measured {len(timed.log)} of {len(planned)} planned")
        expect = len(planned) * (timed.warmup + timed.iters) + timed.timing_launches
        check(n == expect, f"tune {what}: {n} launches != measured calls + "
              f"kernel timing {expect}")
        check(not pln.is_distributed and pln.impl == "cuda",
              f"tune {what}: winner {pln.describe()}")
        exe = pln.compile()
        winner_check(torch, exe, rec, device, rng, batch, f"tune {what}")
        exe.release()
        del exe
    # (b) the same tunes from the file: no measurement, no launch
    for row in rows:
        cache, timed = TuningCache(path), timed_measurer(torch, device)
        instrument.reset()
        pln = by_matrix[row["matrix"]]["sm"].plan(
            scheme="tune", device=device, batch=row["B"],
            tuner=Tuner(measurer=timed, cache=cache))
        hit = {"phase": "tune_cache_hit", "matrix": row["matrix"], "B": row["B"],
               "hits": cache.hits, "misses": cache.misses,
               "measured": len(timed.log), "launches": total_launches(instrument),
               "scheme_id": pln.scheme_id, "from_cache": pln.measured["from_cache"]}
        emit(hit)
        check(cache.misses == 0 and cache.hits == 1 and not timed.log
              and hit["launches"] == 0 and pln.measured["from_cache"]
              and pln.scheme_id == row["winner"],
              f"second tune from the cache file measured or changed: {hit}")
    cache = TuningCache(path)  # the tune_cache= route, with its default tuner
    pln = by_matrix["scale-free"]["sm"].plan(scheme="tune", tune_cache=path,
                                             device=device)
    check(pln.measured["from_cache"], "tune_cache= did not read the cache file")
    emit({"phase": "tune_cache_file", "entries": len(cache),
          "keys": sorted(cache.export())})
    return launches, rows


def phase_tune_parts(torch, rng, device, rec, path) -> tuple:
    """Phase 11 (c): tuning on 16 parts of the card (scale-free, whose
    partition is the cheapest): load / kernel / retrieve per candidate, the
    kernel phase no shorter than its part-axis launch by CUDA events."""
    from repro_torch.kernels import instrument
    from repro_torch.tune import CandidateGenerator, Tuner, TuningCache

    sm = rec["sm"]
    planned = CandidateGenerator().plans(sm, devices=[device] * PARTS)
    timed = timed_measurer(torch, device)
    instrument.reset()
    t0 = time.perf_counter()
    pln = sm.plan(scheme="tune", devices=[device] * PARTS,
                  tuner=Tuner(measurer=timed, cache=TuningCache(path)))
    wall_s = time.perf_counter() - t0
    n = total_launches(instrument)
    launches = add_launches({"coo": 0, "bcoo": 0}, instrument)
    what = {"matrix": "scale-free", "B": 1, "parts": PARTS}
    row = tune_rows(what, pln, timed)
    row.update(planned=len(planned), wall_s=wall_s, launches=n)
    check(not timed.errors, f"tune {what}: candidates raised {timed.errors}")
    check(len(timed.log) == len(planned) == pln.measured["candidates"],
          f"tune {what}: measured {len(timed.log)} of {len(planned)} planned")
    check(n == len(planned) * (timed.warmup + timed.iters) + timed.timing_launches,
          f"tune {what}: {n} launches")
    for m, ms in timed.log:
        check(set(m.phases) == {"load", "kernel", "retrieve"}
              and all(v > 0 for v in m.phases.values()),
              f"tune {what} {m.scheme_id}: phases {m.phases}")
        check(m.phases["kernel"] * 1e3 >= ms,
              f"tune {what} {m.scheme_id}: kernel phase "
              f"{m.phases['kernel'] * 1e3} ms < part-axis launch {ms} ms")
    exe = pln.compile()
    winner_check(torch, exe, rec, device, rng, None, f"tune {what}")
    exe.release()
    return launches, row


TUNE_DRIFT = ("scale-free",)  # (d)'s drift refinement (cut from all three for time)
# (d)'s engine: the matrices it serves and tunes, and its tuner's candidate
# cap (cut for the script's time from all three matrices and 8 candidates,
# then 4, then to the scale-free matrix alone)
TUNE_ENGINE_MATRICES = ("scale-free",)
TUNE_ENGINE_CANDIDATES = 3


def phase_tune_engine(torch, rng, device, by_matrix) -> tuple:
    """Phase 11 (d): ``SpmvEngine(tune=True, tune_after=8)`` over
    ``TUNE_ENGINE_MATRICES``, its tuner the engine's default (cuda
    candidates, warmup 1, iters 3) capped at ``TUNE_ENGINE_CANDIDATES``.
    A client thread multiplies all through; the main thread
    serves 8 width-1 multiplies per matrix (one ``traffic`` refinement
    each), then width 8 to ``TUNE_DRIFT`` until it has a ``drift``
    refinement (the others stay at width 1, with none).
    Every answer is bit-equal to cuSPARSE; launches equal the multiplies
    plus each refinement's measured calls and its winner's warm-up."""
    import threading

    from repro_torch.engine import SpmvEngine
    from repro_torch.kernels import instrument
    from repro_torch.tune import CandidateGenerator, Measurer, Tuner

    by_matrix = {name: by_matrix[name] for name in TUNE_ENGINE_MATRICES}
    tuner = Tuner(generator=CandidateGenerator(impls=("cuda",),
                                               max_candidates=TUNE_ENGINE_CANDIDATES),
                  measurer=Measurer(warmup=1, iters=3))
    eng = SpmvEngine(tune=True, tune_after=8, tuner=tuner)
    for name, rec in by_matrix.items():
        eng.register(name, rec["sm"])
    pools = {}  # (matrix, width) -> [(x, cuSPARSE answer)]
    for name, rec in by_matrix.items():
        cols = rec["shape"][1]
        for width in (1, 8):
            xs = [rng.integers(-2, 3, (cols,) if width == 1 else (cols, width))
                  .astype(np.float32) for _ in range(3)]
            pools[(name, width)] = [
                (x, (rec["A"] @ torch.from_numpy(x).to(device)).cpu().numpy())
                for x in xs]
    state = {"width": 1, "errors": [], "served": 0}
    names = list(by_matrix)
    stop = threading.Event()

    def ask(name, i):  # width 8 only to the matrix that drifts
        width = state["width"] if name in TUNE_DRIFT else 1
        x, want = pools[(name, width)][i % 3]
        y = eng.multiply(name, x)
        if not np.array_equal(y, want):
            state["errors"].append(f"{name} width {x.shape[1:] or 1}: != cuSPARSE")

    def client():
        i = 0
        try:
            while not stop.is_set():
                ask(names[i % len(names)], i)
                i += 1
        except Exception as e:  # reported by the check below
            state["errors"].append(f"client: {type(e).__name__}: {e}")

    instrument.reset()
    since = len(eng.telemetry.records)
    thread = threading.Thread(target=client, name="tune-client")
    t0 = time.perf_counter()
    thread.start()
    try:
        for i in range(8):
            for name in by_matrix:
                ask(name, i)
        eng.drain_tuning(timeout=SERVE_WAIT_S)
        traffic_s = time.perf_counter() - t0
        state["width"] = 8
        for i in range(200):
            if all(any(e["name"] == n and e["trigger"] == "drift"
                       for e in eng.tune_events) for n in TUNE_DRIFT):
                break
            for name in by_matrix:
                ask(name, i)
            eng.drain_tuning(timeout=SERVE_WAIT_S)
    finally:
        stop.set()
        thread.join(SERVE_WAIT_S)
    eng.drain_tuning(timeout=SERVE_WAIT_S)
    wall_s = time.perf_counter() - t0
    check(not thread.is_alive(), "tune engine: client thread still running")
    multiplies = len(eng.telemetry.records) - since
    got = total_launches(instrument)
    events = list(eng.tune_events)
    expect = multiplies + sum(e["candidates"] * 4 + e["swapped"] for e in events)
    for e in events:
        emit({"phase": "tune_event", **e})
    emit({"phase": "tune_engine", "multiplies": multiplies, "launches": got,
          "expected_launches": expect, "events": len(events),
          "traffic_s": traffic_s, "wall_s": wall_s,
          "plans": {n: eng.registry.get(n).plan.tag for n in by_matrix},
          "errors": state["errors"][:5]})
    check(not state["errors"], f"tune engine: {state['errors'][:5]}")
    for name in by_matrix:
        mine = [e for e in events if e["name"] == name]
        check(not any("error" in e for e in mine), f"tune engine {name}: {mine}")
        check(all(e["candidates"] == e["planned"] for e in mine),
              f"tune engine {name}: a candidate was planned but not measured: {mine}")
        check(sum(e["trigger"] == "traffic" for e in mine) == 1
              and any(e["trigger"] == "drift" for e in mine) == (name in TUNE_DRIFT),
              f"tune engine {name}: triggers {[e['trigger'] for e in mine]}")
    check(got == expect, f"tune engine: launches {got} != multiplies + "
          f"measurements + warm-ups {expect}")
    del eng
    return add_launches({"coo": 0, "bcoo": 0}, instrument)


def phase_tune_suite(torch, rng, device) -> tuple:
    """Phase 11 (f): the tuner over ``paper_large_suite()`` from the port's
    data module (22 matrices at 2048^2): every winner within 2e-4 of the
    dense product.  A correctness sweep: at this size the times are host
    overhead, not kernel times."""
    from repro_torch.api import SparseMatrix
    from repro_torch.data.matrices import paper_large_suite
    from repro_torch.kernels import instrument

    instrument.reset()
    t0 = time.perf_counter()
    winners, worst = {}, 0.0
    for spec in paper_large_suite():
        a = spec.build()
        pln = SparseMatrix.from_dense(a).plan(scheme="tune", device=device)
        exe = pln.compile()
        x = rng.standard_normal(a.shape[1]).astype(np.float32)
        y, want = exe(x), a.astype(np.float64) @ x
        err = float(np.abs(y - want).max())
        worst = max(worst, err)
        check(np.allclose(y, want, rtol=2e-4, atol=2e-4),
              f"suite {spec.name}: tuned {pln.scheme_id} max err {err}")
        winners[spec.name] = [spec.cls, pln.scheme_id, pln.measured["candidates"]]
        exe.release()
    launches = add_launches({"coo": 0, "bcoo": 0}, instrument)
    emit({"phase": "tune_suite", "matrices": len(winners), "max_abs_err": worst,
          "wall_s": time.perf_counter() - t0, "launches": launches,
          "winners": winners,
          "note": "2048^2 matrices: a correctness sweep; times are host overhead"})
    return launches


def phase_tuning(torch, rng, device, records) -> dict:
    """Phase 11: tuning on the card, (a)-(f); returns the tuning path's
    launches per kernel kind (measurements, kernel timing, engine
    multiplies and refinements, the suite)."""
    import shutil
    import tempfile

    by_matrix = {}
    for r in records:
        by_matrix.setdefault(r["matrix"], r)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tune-", dir=os.path.join(ROOT, "build"))
    path = os.path.join(tmp, "tune.json")
    seconds, parts = {}, []
    try:
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        parts.append(phase_tune_single(torch, rng, device, by_matrix, path)[0])
        seconds["single_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        parts.append(phase_tune_parts(torch, rng, device, by_matrix["scale-free"],
                                      path)[0])
        seconds["parts_s"] = time.perf_counter() - t1
        gc.collect()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        emit({"phase": "tune_memory", "before_bytes": mem0, "after_bytes": mem1})
        check(mem1 == mem0, f"tuning left {mem1 - mem0} bytes on the card")
        t1 = time.perf_counter()
        parts.append(phase_tune_engine(torch, rng, device, by_matrix))
        seconds["engine_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        parts.append(phase_tune_suite(torch, rng, device))
        seconds["suite_s"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: sum(p[k] for p in parts) for k in ("coo", "bcoo")}
    emit({"phase": "tuning_done", "seconds": time.perf_counter() - t0,
          "launches": launches, **seconds})
    return launches


# ------------------------------------------------------------- topology

TOPO_SHAPES = ((2, 2), (4, 4))  # the pim_like presets of phase 13 (b)
# the matrices (b) places under each preset: (4, 4) on the scale-free one
# alone, the cheapest to partition (cut for the script's time from all
# three)
TOPO_MATRICES = {(2, 2): ("regular", "scale-free", "block"), (4, 4): ("scale-free",)}
# phases 11 and 13's matrices: phase 3's recipes at these rows (regular,
# scale-free, block), built for them; on phase 3's 2^21 / 2^21 / 2^20 the
# two phases took 38.9 s and 56.3 s beside an NVIDIA H100 80GB HBM3, most
# of it planning and partitioning on the host
SMALL_ROWS = (1 << 18, 1 << 18, 1 << 17)


def small_records(torch, rng, device) -> tuple:
    """Phases 11 and 13's matrices (phase 3's recipes at ``SMALL_ROWS``),
    as phases 3 and 7 leave theirs: each with its single-device auto plan's
    program, cuSPARSE's CSR, its stats and shape; and the regular matrix's
    auto plan on ``PARTS`` parts of the card (phase 7's flat plan at this
    size)."""
    from repro_torch.api import SparseMatrix

    n_reg, n_sf, n_blk = SMALL_ROWS
    records, autos = [], []
    for name, make in (("regular", lambda: regular_triplets(rng, n_reg)),
                       ("scale-free", lambda: scale_free_triplets(rng, n_sf, 8 * n_sf)),
                       ("block", lambda: block_triplets(rng, n_blk))):
        ri, ci, vals, shape = make()
        sm = SparseMatrix.from_parts(ri, ci, vals, shape)
        del ri, ci, vals
        exe = sm.plan(scheme="auto", device=device).compile()
        prog = exe.program
        rec = dict(matrix=name, fmt=exe.plan.fmt, exe=exe, prog=prog,
                   kernel="coo_spmv" if prog.kind == "coo" else "bcoo_spmv",
                   A=library_csr(torch, sm, device), st=sm.stats, shape=shape, sm=sm)
        records.append(rec)
        if name == "regular":
            flat = sm.plan(scheme="auto", devices=[device.type] * PARTS).compile()
            autos.append((name, flat, rec))
    emit({"phase": "small_matrices", "rows": list(SMALL_ROWS),
          "nnz": [r["st"].nnz for r in records]})
    return records, autos


MODELLED = "modelled on the preset's declared links, not a time on any device"


def topo_requests(torch, rng, device, exe, rec, others=(), n1: int = 6,
                  n8: int = 2) -> tuple:
    """Serve n1 B=1 and n8 B=8 integer-valued requests through ``exe``,
    each bit-equal to the single-device kernel, cuSPARSE and every
    executor of ``others`` (all launched before the counted window).
    Returns (launches, B=1 latencies): one part-axis launch per request."""
    from repro_torch.kernels import instrument

    cols = rec["shape"][1]
    xs = [rng.integers(-2, 3, (cols,) if i < n1 else (cols, 8))
          .astype(np.float32) for i in range(n1 + n8)]
    wants = []
    for x in xs:
        xd = torch.from_numpy(x).to(device)
        want = rec["prog"](xd).cpu().numpy()
        check(np.array_equal(want, (rec["A"] @ xd).cpu().numpy()),
              f"{rec['matrix']}: single-device kernel != cuSPARSE")
        for other in others:
            got = other(x) if x.ndim == 1 else other.batch(x)
            check(np.array_equal(got, want), f"{rec['matrix']} "
                  f"{other.plan.scheme_id}: != single-device kernel")
        wants.append(want)
    kind = "coo" if exe.plan.fmt in ("coo", "csr") else "bcoo"
    lat = []
    instrument.reset()
    for x, want in zip(xs, wants):
        t0 = time.perf_counter()
        y = exe(x) if x.ndim == 1 else exe.batch(x)
        if x.ndim == 1:
            lat.append(time.perf_counter() - t0)
        check(np.array_equal(y, want), f"{rec['matrix']} {exe.plan.scheme_id} "
              f"B={x.shape[1:] or 1}: != single-device kernel and cuSPARSE")
    got = {k: instrument.launches(k) for k in ("coo", "bcoo")}
    want_l = {"coo": 0, "bcoo": 0, kind: len(xs)}
    check(got == want_l, f"{rec['matrix']} {exe.plan.scheme_id}: launches "
          f"{got} != one part-axis launch per request {want_l}")
    return got, lat


def topo_row(torch, rng, device, exe, rec, lat) -> dict:
    """The placed plan's part-axis launch timed at B=1 beside its bound and
    cuSPARSE, with its partition s and exe(x) p50."""
    pln = exe.plan
    cols = rec["shape"][1]
    x = rng.integers(-2, 3, cols).astype(np.float32)
    xd = torch.from_numpy(x).to(device)
    bound, by = part_bound(exe.program, rec["st"])
    ta = pln.topo_assignment
    return {"matrix": rec["matrix"], "scheme_id": pln.scheme_id,
            "grid": list(pln.grid), "kernel": rec["kernel"],
            "assignment": ta and ",".join(
                f"{l}={'*'.join(g) or '-'}"
                for l, g in zip(ta["logical"], ta["physical"])),
            "slots": exe.mesh.slots.reshape(-1).tolist(),
            "modelled_transfer_s": ta and ta["transfer"],
            "modelled_note": MODELLED,
            "partition_s": exe.build_seconds,
            "exe_ms_p50": 1e3 * statistics.median(lat),
            "part_ms": time_ms(torch, kernel_fn(torch, exe, x, device), 30),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(torch, lambda: rec["A"] @ xd, 30)}


def phase_topology(torch, rng, device, records, autos) -> dict:
    """Phase 13: topology-aware placement (``repro_torch.topo``) on the
    card, on phase 3's recipes at ``SMALL_ROWS`` (``small_records``);
    returns its launches."""
    from repro_torch.api import plan_from_ir, resolve_scheme
    from repro_torch.engine import SpmvEngine
    from repro_torch.kernels import instrument
    from repro_torch.topo import (CollectiveCostModel, FakeTopology,
                                  detect_topology)
    from repro_torch.tune import (CandidateGenerator, Measurer, Tuner,
                                  TuningCache, make_key)

    by_matrix = {}
    for r in records:
        by_matrix.setdefault(r["matrix"], r)
    launches = {"coo": 0, "bcoo": 0}

    def count(got):
        for k in launches:
            launches[k] += got[k]

    # (a) the detector: one flat axis; 16 parts of the regular matrix under
    # it answer as phase 7's flat plan
    here, many = detect_topology(), detect_topology([device.type] * PARTS)
    emit({"phase": "topo_detect", "default": [here.name, list(here.axis_sizes)],
          "cuda16": [many.name, list(many.axis_sizes)]})
    check((here.name, here.axis_sizes) == ("cuda:flat", (1,))
          and (many.name, many.axis_sizes) == ("cuda:flat", (PARTS,)),
          f"detector: {here} / {many}")
    rec = by_matrix["regular"]
    flat = next(exe for name, exe, _ in autos if name == "regular")
    for scheme in ("auto", "2d"):
        exe = rec["sm"].plan(scheme=scheme, topology=many).compile()
        got, lat = topo_requests(torch, rng, device, exe, rec, others=(flat,))
        count(got)
        emit({"phase": "topo_detect_plan", "scheme": scheme,
              "scheme_id": exe.plan.scheme_id, "grid": list(exe.plan.grid),
              "flat_scheme_id": flat.plan.scheme_id,
              "flat_grid": list(flat.plan.grid),
              "answers": "bit-equal to phase 7's flat plan, the single-device "
                         "kernel and cuSPARSE"})
        exe.release()

    # (b) the model's picks under the two presets, "2d" and auto
    kept = {}  # pim2x2's "2d" picks of block and regular, for (c)
    for shape2d in TOPO_SHAPES:
        n = shape2d[0] * shape2d[1]
        topo = FakeTopology.pim_like(shape2d, devices=[device.type] * n)
        for name in TOPO_MATRICES[shape2d]:
            rec = by_matrix[name]
            built = {}
            for scheme in ("2d", "auto"):
                fmt = rec["fmt"] if scheme == "2d" else None
                pln = rec["sm"].plan(scheme=scheme, fmt=fmt, topology=topo)
                flat_grid = resolve_scheme(rec["st"], rec["shape"], n, scheme,
                                           fmt=fmt).grid
                key = (pln.scheme_id, pln.grid)
                if key not in built:
                    print(pln.describe(), flush=True)
                    exe = pln.compile()
                    got, lat = topo_requests(torch, rng, device, exe, rec)
                    count(got)
                    built[key] = topo_row(torch, rng, device, exe, rec, lat)
                    if (n, scheme) == (4, "2d") and name != "scale-free":
                        kept[name] = exe
                    else:
                        exe.release()
                emit({"phase": "topo_pick", "topology": topo.name,
                      "scheme": scheme, "flat_grid": list(flat_grid),
                      **built[key]})

    # (c) every assignment of pim2x2 on the (2, 2) grid: y identical, slots
    # the device order of arange(4), kernel ms side by side
    topo = FakeTopology.pim_like((2, 2), devices=[device.type] * 4)
    abstract = FakeTopology.pim_like((2, 2))
    placed = {}
    for name in ("block", "regular"):
        rec = by_matrix[name]
        base = rec["sm"].plan(scheme="2d", fmt=rec["fmt"], grid=(2, 2),
                              topology=topo)
        ranked = CollectiveCostModel(topo).rank(
            base.scheme, rec["shape"], rec["sm"].dtype.itemsize, base.axes)
        check(len(ranked) == 2, f"{name}: assignments {ranked}")
        xs = [rng.integers(-2, 3, rec["shape"][1]).astype(np.float32)
              for _ in range(2)]
        ys, rows = [], []
        for a, price in ranked:
            reuse = kept.get(name)
            if reuse is not None and reuse.plan.scheme_id.endswith("@" + a.tag):
                exe = kept.pop(name)  # (b) built this placement already
            else:
                exe = rec["sm"].plan(scheme="2d", fmt=rec["fmt"], grid=(2, 2),
                                     topology=topo, assignment=a).compile()
            want_slots = abstract.device_order(a, devices=range(4))
            check(exe.mesh.slots.reshape(-1).tolist() == want_slots,
                  f"{name} {a.tag}: slots {exe.mesh.slots} != {want_slots}")
            check(exe.plan.scheme_id.endswith("@" + a.tag),
                  f"{name}: {exe.plan.scheme_id} lacks @{a.tag}")
            got, lat = topo_requests(torch, rng, device, exe, rec, n1=4, n8=1)
            count(got)
            ys.append([exe(x) for x in xs])  # compared, not counted
            row = topo_row(torch, rng, device, exe, rec, lat)
            emit({"phase": "topo_forced", "topology": topo.name, **row})
            rows.append(row)
            if name == "block" and a is ranked[-1][0]:
                placed[name] = exe  # the worst placement: phase 13 (d)
            else:
                exe.release()
        check(all(np.array_equal(u, v) for y in ys[1:] for u, v in zip(ys[0], y)),
              f"{name}: answers differ between assignments")
        ms = [r["part_ms"] for r in rows]
        emit({"phase": "topo_forced_spread", "matrix": name,
              "part_ms": ms, "spread": max(ms) / min(ms) - 1.0,
              "answers": "identical across assignments"})
    for exe in kept.values():
        exe.release()

    # (d) the plan IR: the worst placement of the block matrix, round trip
    exe = placed.pop("block")
    rec = by_matrix["block"]
    ir = json.loads(json.dumps(exe.plan.to_ir()))
    check(ir["topo"] and ir["topo"]["topology"] == "pim2x2", f"IR topo {ir['topo']}")
    x = rng.integers(-2, 3, rec["shape"][1]).astype(np.float32)
    y = exe(x)
    for how, kw in (("with topology", {"topology": topo}), ("without", {})):
        back = plan_from_ir(ir, rec["sm"], device=device,
                            devices=[device] * 4, **kw).compile()
        slots = back.mesh.slots.reshape(-1).tolist()
        want_slots = (exe.mesh.slots.reshape(-1).tolist() if kw
                      else list(range(4)))  # no topology: flat, as JAX lays it
        check(back.plan.scheme_id == exe.plan.scheme_id,
              f"IR {how}: {back.plan.scheme_id} != {exe.plan.scheme_id}")
        check(slots == want_slots, f"IR {how}: slots {slots} != {want_slots}")
        check(back.plan.to_ir()["topo"] == ir["topo"], f"IR {how}: topo lost")
        instrument.reset()
        check(np.array_equal(back(x), y), f"IR {how}: answers differ")
        count({k: instrument.launches(k) for k in launches})
        emit({"phase": "topo_ir", "how": how, "scheme_id": back.plan.scheme_id,
              "slots": slots, "answers": "bit-equal to the placed plan"})
        back.release()
    exe.release()

    # (e) tuning under pim2x2 on the block matrix at B=1
    rec = by_matrix["block"]
    # four candidates: the first two schemes, each under both assignments
    tuner = Tuner(generator=CandidateGenerator(max_candidates=4),
                  measurer=Measurer(warmup=1, iters=3), cache=TuningCache())
    instrument.reset()
    eng = SpmvEngine(devices=[device.type] * 4, topology=topo, tune=True,
                     tuner=tuner)
    eng.register("block", rec["sm"])
    xs = [rng.integers(-2, 3, rec["shape"][1]).astype(np.float32)
          for _ in range(4)]
    for x in xs:
        want = (rec["A"] @ torch.from_numpy(x).to(device)).cpu().numpy()
        check(np.array_equal(eng.multiply("block", x), want),
              "topo engine: != cuSPARSE")
    t0 = time.perf_counter()
    event = eng.refine("block", x=xs[0])
    tune_s = time.perf_counter() - t0
    key = make_key(rec["sm"], devices=eng.devices, impls=tuner.generator.impls,
                   block=eng.block, topology=topo)
    record = tuner.cache.get(key)
    check(record is not None and key.topology == "cuda:4|pim2x2:2x2",
          f"topo tune key {key.encode()}")
    groups = {}
    for c in record["candidates"]:
        sid, _, tag = c["scheme_id"].partition("@")
        groups.setdefault((sid, tuple(c["grid"])), set()).add(tag)
    grid = tuple(eng.registry.get("block").plan.grid)
    complete = []
    for (sid, g), tags in groups.items():
        axes = ("parts",) if sid.startswith("1d") else ("rows", "cols")
        n_alt = len(topo.assignments(g[:1] if sid.startswith("1d") else g, axes))
        complete.append(len(tags) == n_alt)
        emit({"phase": "topo_tune_group", "scheme": sid, "grid": list(g),
              "assignments_measured": sorted(tags), "assignments": n_alt})
    for c in record["candidates"]:
        emit({"phase": "topo_tune_candidate", **c})
    # the generator's cap may cut the last scheme's assignments short
    capped = len(record["candidates"]) >= tuner.generator.max_candidates
    check(complete and all(complete[:-1]) and (complete[-1] or capped),
          f"topo tune: not one candidate per assignment: {groups}")
    y = eng.multiply("block", xs[1])
    got = total_launches(instrument)
    count({k: instrument.launches(k) for k in launches})
    xd = torch.from_numpy(xs[1]).to(device)  # compared, not counted
    check(np.array_equal(y, (rec["A"] @ xd).cpu().numpy())
          and np.array_equal(y, rec["prog"](xd).cpu().numpy()),
          "topo tune: the winner != cuSPARSE / single-device kernel")
    # the registration's warm-up, 5 multiplies, 4 calls per measured
    # candidate (warmup 1, iters 3) and a swap's warm-up
    expect = 1 + 5 + 4 * event["candidates"] + event["swapped"]
    check(event["candidates"] == event["planned"] and got == expect,
          f"topo tune: {event} launches {got} != {expect}")
    gc.collect()
    torch.cuda.synchronize()
    mem0, calls0 = torch.cuda.memory_allocated(), instrument.launches()
    again = tuner.tune(rec["sm"], devices=eng.devices, block=eng.block,
                       hw=eng.hw, topology=topo)
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    emit({"phase": "topo_tune", "key": key.encode(), "event": event,
          "tune_s": tune_s, "winner": eng.registry.get("block").plan.tag,
          "winner_scheme_id": event["winner"], "serving_grid": list(grid),
          "second": {"from_cache": again.from_cache,
                     "measurements": len(again.measurements),
                     "launches": instrument.launches() - calls0,
                     "memory_delta_bytes": mem1 - mem0,
                     "scheme_id": again.best.scheme_id}})
    check(again.from_cache and not again.measurements
          and instrument.launches() == calls0 and mem1 == mem0,
          "topo tune: the second tune measured, launched or kept memory")
    del eng
    emit({"phase": "topology_launches", "launches": launches})
    return launches


# ------------------------------------------------------------- cluster

CLUSTER_NAMES = ("regular", "scale-free", "block")
ORACLE_OF = {"block-tuned": "block", "regular-ir": "regular"}  # phase 12 (c)
CLUSTER_MIX = {1: 0.6, 4: 0.25, 8: 0.15}  # the replays' widths and shares
POWER_STEPS = 20  # steps of each phase-12 session
# cut for the script's time: the matrices at 2^17 rows (2^21, 2^19, then
# 2^18 before; the block matrix is n/2 square) and the generator replay at
# 24 requests (48, 120 before); the chaos replay keeps its 120
CLUSTER_N = 1 << 17
CLUSTER_GENERATOR_REQUESTS = 24


def mem_free(torch) -> int:
    """Free bytes on the card, all processes' contexts counted."""
    return torch.cuda.mem_get_info()[0]


def worker_stats(router) -> dict:
    return {w: s for w, s in router.stats()["workers"].items() if not s.get("lost")}


def kernel_launches(stats: dict) -> int:
    """A worker's launches of the two kernels of the serving path."""
    return stats["launches"].get("coo", 0) + stats["launches"].get("bcoo", 0)


def registrations(stats: dict) -> int:
    return int(stats["metrics"].get("cluster.worker.registered", 0))


def check_worker_launches(before: dict, after: dict, what: str, steps=None) -> dict:
    """Each live worker launched one kernel per multiply it served, one per
    step of the sessions it ran (``steps[w]``: sessions, steps) and one per
    registration (its warm-up): the proof that the workers ran the kernels,
    not their plain versions."""
    out = {}
    for w, st in after.items():
        launched = kernel_launches(st) - kernel_launches(before[w])
        served = st["served"] - before[w]["served"]
        registered = registrations(st) - registrations(before[w])
        sessions = (steps or {}).get(w, (0, 0))
        want = served - sessions[0] + sessions[1] + registered
        out[w] = {"served": served, "launches": launched}
        check(launched == want,
              f"{what}: worker {w} launched {launched} kernels for {served} "
              f"served requests ({sessions[0]} sessions of {sessions[1]} steps) "
              f"and {registered} registrations")
    return out


def csr_oracle(sm):
    """The host oracle: the matrix as scipy CSR in float32."""
    import scipy.sparse as sp

    ri, ci, vals = (t.numpy() for t in sm.coalesced())
    rows, cols = sm.shape
    indptr = np.zeros(rows + 1, np.int64)
    np.cumsum(np.bincount(ri, minlength=rows), out=indptr[1:])
    return sp.csr_matrix((vals.astype(np.float32), ci.astype(np.int32), indptr),
                         shape=(rows, cols))


def power_f64(a, x0, steps: int) -> np.ndarray:
    """float64 power iteration on the host (the sessions' oracle)."""
    a64, x = a.astype(np.float64), x0.astype(np.float64)
    for _ in range(steps):
        y = a64 @ x
        x = y / max(np.linalg.norm(y), 1e-30)
    return x


def cluster_register(torch, router, name, sm, drops, **kw) -> dict:
    """Register ``sm`` as int32-index triplets on one worker; print the
    frame's bytes, the router's wall s, the worker's register s and the
    card memory its placement took (all other processes idle)."""
    import pickle

    from repro_torch.cluster.protocol import HEADER, MAX_FRAME

    free0 = mem_free(torch)
    t0 = time.perf_counter()
    info = router.register(name, sm, replicas=1, **kw)
    wall_s = time.perf_counter() - t0
    drop = free0 - mem_free(torch)
    entry = router.entries[name]
    check(entry.triplets is not None and entry.triplets[0].dtype == np.int32
          and entry.triplets[1].dtype == np.int32,
          f"cluster {name}: not shipped as int32-index triplets")
    frame = HEADER.size + len(pickle.dumps(
        {"verb": "register", **entry.register_fields()},
        protocol=pickle.HIGHEST_PROTOCOL))
    check(frame <= MAX_FRAME, f"cluster {name}: frame {frame} B > {MAX_FRAME}")
    check(info["placements"] == entry.placements and len(entry.placements) == 1,
          f"cluster {name}: placements {info['placements']}")
    drops[info["placements"][0]] += drop
    emit({"phase": "cluster_register", "matrix": name, "source": info["source"],
          "scheme_id": info["scheme_id"], "impl": info["impl"],
          "nnz": len(entry.triplets[0]), "frame_mb": frame / 1e6,
          "router_wall_s": wall_s, "worker_register_s": info["register_s"],
          "placements": info["placements"], "card_bytes": drop})
    return info


def cluster_direct(router, oracles, rng, times) -> None:
    """(b) Per matrix 8 B=1, 2 B=4 and 2 B=8 multiplies through the router,
    each bit-equal to the scipy oracle; launches = served on every worker."""
    before = worker_stats(router)
    fmt = {"regular": "coo", "scale-free": "coo", "block": "bcoo"}
    for name in CLUSTER_NAMES:
        a = oracles[name]
        lat = {}
        for batch, count in ((1, 8), (4, 2), (8, 2)):
            for _ in range(count):
                shape = (a.shape[1],) if batch == 1 else (a.shape[1], batch)
                x = rng.integers(-2, 3, shape).astype(np.float32)
                t0 = time.perf_counter()
                y = router.multiply(name, x)
                lat.setdefault(batch, []).append(time.perf_counter() - t0)
                check(np.array_equal(y, (a @ x).astype(np.float32)),
                      f"cluster {name} B={batch}: answer != scipy oracle")
        t1, t8 = times[(name, fmt[name], 1)], times[(name, fmt[name], 8)]
        emit({"phase": "cluster_direct", "matrix": name,
              "router_ms_p50": {b: 1e3 * statistics.median(v) for b, v in lat.items()},
              "phase3_exe_ms_p50": t1["host_exe_ms_p50"],
              "phase4_kernel_ms": {1: t1["ms"], 8: t8["ms"]},
              "answers": "bit-equal to scipy"})
    got = check_worker_launches(before, worker_stats(router), "direct multiplies")
    emit({"phase": "cluster_direct_launches", "workers": got})


def cluster_plans(torch, router, sms, oracles, rng, device, tmp, drops) -> None:
    """(c) A tune record made in this process and a plan IR, shipped."""
    from repro_torch.tune import CandidateGenerator, Measurer, Tuner, TuningCache

    tuner = Tuner(generator=CandidateGenerator(impls=("cuda",)), measurer=Measurer(),
                  cache=TuningCache(os.path.join(tmp, "tune.json")))
    t0 = time.perf_counter()
    result = tuner.tune(sms["block"], device=device)
    tune_s = time.perf_counter() - t0
    check(result.key.topology == "cuda:1" and not result.from_cache,
          f"cluster tune: key {result.key}, from_cache {result.from_cache}")
    record = {"entries": tuner.cache.export(result.key), "impls": ["cuda"],
              "batch": None, "block": [8, 16]}
    winner = result.best.scheme_id
    del result, tuner
    gc.collect()
    torch.cuda.empty_cache()
    info = cluster_register(torch, router, "block-tuned", sms["block"], drops,
                            tune_record=record)
    emit({"phase": "cluster_tune_record", "tune_s": tune_s, "winner": winner,
          "source": info["source"], "from_cache": info["from_cache"],
          "measurements": info["measurements"], "tune_hits": info["tune_hits"],
          "scheme_id": info["scheme_id"]})
    check(info["source"] == "tune_cache" and info["from_cache"] is True
          and info["measurements"] == 0 and info["tune_hits"] >= 1
          and info["scheme_id"] == winner,
          f"cluster tune record: {info} (parent's winner {winner})")
    ep = sms["regular"].plan(scheme="1d.nnz", fmt="csr", device=device)
    info = cluster_register(torch, router, "regular-ir", sms["regular"], drops,
                            ir=ep.to_ir())
    check(info["source"] == "ir" and info["scheme_id"] == ep.scheme_id,
          f"cluster IR: {info['source']} {info['scheme_id']} != {ep.scheme_id}")
    for name, oracle in (("block-tuned", "block"), ("regular-ir", "regular")):
        a = oracles[oracle]
        for batch in (1, 8):
            shape = (a.shape[1],) if batch == 1 else (a.shape[1], batch)
            x = rng.integers(-2, 3, shape).astype(np.float32)
            check(np.array_equal(router.multiply(name, x), (a @ x).astype(np.float32)),
                  f"cluster {name} B={batch}: answer != scipy oracle")


def cluster_sessions(router, oracles, rng) -> None:
    """(d) One 20-step power session per matrix through ``router.solve``."""
    before = worker_stats(router)
    steps = {}
    for name in CLUSTER_NAMES:
        a = oracles[name]
        x0 = rng.integers(-2, 3, a.shape[1]).astype(np.float32)
        requests = router.entries[name].requests
        t0 = time.perf_counter()
        res = router.solve(name, x0, steps=POWER_STEPS, combine="power")
        wall_s = time.perf_counter() - t0
        err = float(np.abs(res["x"] - power_f64(a, x0, POWER_STEPS)).max())
        check(res["steps"] == POWER_STEPS and err <= 1e-4,
              f"cluster session {name}: {res['steps']} steps, max err {err}")
        check(router.entries[name].requests == requests + POWER_STEPS,
              f"cluster session {name}: steps not charged to its placement")
        n, s = steps.get(res["worker_id"], (0, 0))
        steps[res["worker_id"]] = (n + 1, s + POWER_STEPS)
        emit({"phase": "cluster_session", "matrix": name, "steps": res["steps"],
              "worker": res["worker_id"], "max_abs_err": err, "wall_s": wall_s,
              "worker_s": res["seconds"]})
    got = check_worker_launches(before, worker_stats(router), "sessions", steps)
    emit({"phase": "cluster_session_launches", "workers": got})


def cluster_spec(seed: int, *salt, n_requests: int = 120):
    from repro_torch.serve import WorkloadSpec

    return WorkloadSpec(names=CLUSTER_NAMES, n_requests=n_requests,
                        seed=[seed, 12, *salt],
                        zipf_alpha=1.1, batch_mix=CLUSTER_MIX, integer_values=True)


def cluster_report_row(phase: str, report) -> dict:
    s = report.summary()
    return {"phase": phase, **{k: s[k] for k in (
        "requests", "accepted", "mismatched", "shed", "shed_reasons", "lost",
        "wall_s", "accepted_rps", "per_worker", "failovers", "latency")}}


def cluster_generators(router, oracles, seed: int) -> None:
    """(e) Two spawned load generators straight at the workers' sockets."""
    from repro_torch.cluster.replay import replay_generators
    from repro_torch.serve import generate_trace

    trace = generate_trace(cluster_spec(seed, n_requests=CLUSTER_GENERATOR_REQUESTS))
    before = worker_stats(router)
    report = replay_generators(router, trace, oracles, generators=2, timeout=300.0)
    got = check_worker_launches(before, worker_stats(router), "generator replay")
    emit({**cluster_report_row("cluster_generators", report), "workers": got})
    check(report.accepted + len(report.shed) == len(trace) and report.mismatched == 0
          and report.lost == 0,
          f"generator replay: {report.summary()}")


def cluster_chaos(torch, router, oracles, rng, seed: int, drops) -> None:
    """(f) A router-mode replay on 4 threads; the victim, a worker that
    alone holds at least one matrix (the ring decides which), is killed
    after 40 answers."""
    import threading

    from repro_torch.cluster.replay import replay_cluster
    from repro_torch.serve import generate_trace

    with router._lock:
        alone = sorted({e.placements[0] for e in router.entries.values()
                        if len(e.placements) == 1})
    check(bool(alone), "chaos replay: no worker holds a matrix alone: "
          f"{ {n: e.placements for n, e in router.entries.items()} }")
    victim = alone[0]
    survivor = next((w for w in sorted(router.workers) if w != victim), None)
    check(survivor is not None, f"chaos replay: no worker besides {victim}")
    trace = generate_trace(cluster_spec(seed, 1))
    samples, stop, kill = [], threading.Event(), {}

    def monitor():  # the card's free bytes every 20 ms
        while not stop.is_set():
            samples.append((time.perf_counter(), mem_free(torch)))
            stop.wait(0.02)

    def kill_worker(wid):
        with router._lock:
            kill["exclusive"] = sorted(n for n, e in router.entries.items()
                                       if e.placements == [wid])
        kill["free"], kill["t"] = mem_free(torch), time.perf_counter()
        type(router).kill_worker(router, wid)

    router.kill_worker = kill_worker
    mon = threading.Thread(target=monitor, daemon=True)
    mon.start()
    try:
        report = replay_cluster(router, trace, oracles, threads=4, kill_after=40,
                                kill_worker=victim)
    finally:
        stop.set()
        mon.join(timeout=5)
        del router.kill_worker
    window = [f for t, f in samples if kill["t"] <= t <= kill["t"] + 10]
    rise = max(window, default=kill["free"]) - kill["free"]
    event = next((f for f in router.failovers if f["worker_id"] == victim), None)
    check(event is not None, f"chaos replay: no failover of {victim}: "
          f"{router.failovers}")
    emit({**cluster_report_row("cluster_chaos", report),
          "victim": victim, "exclusive": kill["exclusive"],
          "rehomed": event["rehomed"],
          "failover_stall_ms": 1e3 * max(report.latencies_s),
          "victim_card_bytes": drops[victim], "freed_within_10s_bytes": rise})
    check(report.lost == 0 and report.mismatched == 0
          and {s["reason"] for s in report.shed} <= {"worker_lost"},
          f"chaos replay: {report.summary()}")
    check(report.failovers >= 1 and sorted(event["rehomed"]) == kill["exclusive"]
          and kill["exclusive"], f"chaos replay: rehomed {event}, "
          f"{victim} held {kill['exclusive']} alone")
    check(router.workers[survivor].alive() and not router.workers[victim].alive(),
          "chaos replay: the wrong worker died")
    check(rise >= drops[victim] / 2,
          f"chaos replay: {rise} B freed within 10 s of the kill < half of "
          f"the {drops[victim]} B {victim} took")
    for name, entry in router.entries.items():
        a = oracles[ORACLE_OF.get(name, name)]
        x = rng.integers(-2, 3, a.shape[1]).astype(np.float32)
        check(entry.placements == [survivor]
              and np.array_equal(router.multiply(name, x), (a @ x).astype(np.float32)),
              f"after the kill {name} on {entry.placements}: answer != scipy oracle")


def phase_cluster(torch, rng, device, n: int, seed: int, times) -> dict:
    """Phase 12: the multi-process cluster at full width (see the module
    docstring; the block matrix is n/2 square); returns the workers'
    kernel launches before the kill."""
    import shutil
    import tempfile

    from repro_torch.api import SparseMatrix
    from repro_torch.cluster import ClusterRouter
    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    _build.build_all()  # built in phase 1: the workers only load them
    makers = {"regular": lambda: regular_triplets(rng, n),
              "scale-free": lambda: scale_free_triplets(rng, n, 8 * n),
              "block": lambda: block_triplets(rng, n // 2)}
    sms, oracles = {}, {}
    t0 = time.perf_counter()
    for name, make in makers.items():
        ri, ci, vals, shape = make()
        sms[name] = SparseMatrix.from_parts(ri, ci, vals, shape)
        oracles[name] = csr_oracle(sms[name])
    setup_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip-cluster-")
    free0 = mem_free(torch)
    t0 = time.perf_counter()
    # replication off: each matrix stays on its ring owner, so the kill in
    # (f) re-homes what w0 alone held (tests/test_torch_cluster.py holds
    # popularity replication)
    router = ClusterRouter(workers=2, socket_dir=tmp, connect_timeout=300,
                           replicate_share=1.0)
    try:
        spawn_s = time.perf_counter() - t0
        free1 = mem_free(torch)
        mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
        emit({"phase": "cluster_fleet", "workers": 2, "spawn_s": spawn_s,
              "setup_s": setup_s, "compute_mode": mode, "free_before_bytes": free0,
              "free_after_spawn_bytes": free1})
        drops = {w: (free0 - free1) // 2 for w in router.workers}  # start-up
        for name in CLUSTER_NAMES:
            cluster_register(torch, router, name, sms[name], drops)
        cluster_direct(router, oracles, rng, times)
        cluster_plans(torch, router, sms, oracles, rng, device, tmp, drops)
        del sms
        cluster_sessions(router, oracles, rng)
        cluster_generators(router, oracles, seed)
        launches = {k: 0 for k in ("coo", "bcoo")}
        for st in worker_stats(router).values():
            for k in launches:
                launches[k] += st["launches"].get(k, 0)
        check(all(launches.values()), f"cluster: a kernel never launched: {launches}")
        cluster_chaos(torch, router, oracles, rng, seed, drops)
    finally:
        router.close()
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "cluster_done", "seconds": time.perf_counter() - t_phase,
          "launches": launches, "free_after_close_bytes": mem_free(torch),
          "free_before_bytes": free0})
    return launches


# ------------------------------------------------------------- phase 14: LM

LM_ARCH = "qwen1.5-0.5b"
# 16 tokens a generate (cut from 32 for the script's time)
LM_BATCH, LM_PROMPT, LM_GEN, LM_MAX_LEN = 4, 128, 16, 160
LM_LONG = 4096  # a prefill that takes the query-chunked attention path
BF16_OPS_S = 989e12  # H100 SXM data sheet, bf16 on the tensor cores
LM_LOGIT_TOL = 1e-3  # f32 logits, sums in another order over 24 layers
# the plain block SpMM gathers x as (blocks, c, B) and widens it to f32;
# above this it runs in column chunks (block_plain): gemma2's 82,944 blocks
# at T = 1,024 would gather 43.5 GB, llava's 71,680 at T = 3,008 110 GB
PLAIN_GATHER_BYTES = 40e9


def ffn_dims(cfg) -> dict:
    return {"w_gate": (cfg.d_model, cfg.d_ff), "w_up": (cfg.d_model, cfg.d_ff),
            "w_down": (cfg.d_ff, cfg.d_model)}


def lm_projections(params, cfg):
    """(layer, name, d_in, d_out, layer params) of every sparse projection
    the serving path runs: the prefix blocks', the stacked repeats',
    zamba2's shared block's (layer "shared", run once a repeat) and an
    enc-dec encoder's (layers "enc0", "enc1", ...; run once a request, by
    ``lm.encode``); a block with an MoE FFN or a recurrent block has none;
    the MTP block runs only in the loss."""
    dims = ffn_dims(cfg)
    out = []
    if "encoder" in params:
        mlp = params["encoder"]["blocks"]["mlp"]
        out += [(f"enc{r}", name, *dims[name], {k: v[r] for k, v in mlp[name].items()})
                for r in range(cfg.encoder_layers) for name in dims]
    for i in range(len(cfg.prefix_pattern)):
        mlp = params[f"prefix{i}"].get("mlp")
        if mlp is not None:
            out += [(f"prefix{i}", name, *dims[name], mlp[name]) for name in dims]
    for blk in params["blocks"].values():
        if "mlp" in blk:
            out += [(r, name, *dims[name], {k: v[r] for k, v in blk["mlp"][name].items()})
                    for r in range(cfg.n_repeats) for name in dims]
    if "shared" in params:
        out += [("shared", name, *dims[name], params["shared"]["mlp"][name])
                for name in dims]
    return out


def lm_launches_per_step(params, cfg) -> int:
    """Block-kernel launches of one sparse prefill or decode step: one per
    decoder projection per invocation (the shared block's once a repeat;
    the encoder's run before the prefill, not in it)."""
    shared = cfg.n_repeats * cfg.block_pattern.count("shared_attn")
    return sum(shared if layer == "shared" else 1
               for layer, *_ in lm_projections(params, cfg)
               if not str(layer).startswith("enc"))


def densified(torch, p, d_in: int, d_out: int):
    """W (d_out, d_in) with every block of a sparse projection placed; the
    oracle's weight, built without the kernel or its plain version."""
    nb, r, c = p["bvalues"].shape[-3:]
    lead = p["bvalues"].shape[:-3]
    w = torch.zeros(lead + (d_out // r, d_in // c, r, c), dtype=p["bvalues"].dtype,
                    device=p["bvalues"].device)
    rows, cols = p["browind"].long(), p["bcolind"].long()
    if lead:
        layer = torch.arange(lead[0], device=w.device)[:, None]
        w[layer, rows, cols] = p["bvalues"]
    else:
        w[rows, cols] = p["bvalues"]
    return w.transpose(-3, -2).reshape(lead + (d_out, d_in))


def densified_params(torch, params, cfg):
    """The sparse model's params with each FFN projection a dense
    ``{"w": W.T}`` (the dense SwiGLU's layout), for ``ffn_density=1``; the
    MTP subtree, which serving never reads, left out."""
    dims = ffn_dims(cfg)

    def dense(blk):
        if "mlp" not in blk:
            return blk
        return dict(blk, mlp={
            name: {"w": densified(torch, blk["mlp"][name], *dims[name])
                   .transpose(-1, -2).contiguous()} for name in dims})

    out = {k: dense(v) if k.startswith("prefix") or k == "shared" else v
           for k, v in params.items() if k != "mtp"}
    out["blocks"] = {key: dense(blk) for key, blk in params["blocks"].items()}
    if "encoder" in params:
        out["encoder"] = dict(params["encoder"],
                              blocks=dense(params["encoder"]["blocks"]))
    return out


def teacher_forced(torch, lm, params, cfg, prompts, out, memory=None):
    """Logits at the generated positions of a forward pass over
    [prompt, out[:, :-1]]: position S - 1 + i predicts out[:, i]."""
    full = torch.cat([prompts, out[:, :-1]], dim=1)
    logits, _ = lm.forward(params, full, cfg, memory=memory)
    return logits[:, prompts.shape[1] - 1:].float()


def greedy_agreement(torch, logits, out, margin: float) -> dict:
    """argmax of teacher-forced logits against the generated tokens, at
    every position whose top-2 margin exceeds ``margin``."""
    top = torch.topk(logits, 2, dim=-1).values
    ok = (top[..., 0] - top[..., 1]) > margin
    same = logits.argmax(-1) == out
    return {"positions": int(out.numel()), "checked": int(ok.sum()),
            "agree": int((same & ok).sum()), "agree_all": int(same.sum()),
            "margin": margin}


def lm_bound(nb: int, r: int, c: int, n_brows: int, d_in: int, d_out: int,
             batch: int) -> tuple:
    """(ms, by) the least time of one bf16 block SpMM: values, indices, the
    block-row pointer, x and the f32 y once over HBM, or its multiply-adds
    over the bf16 tensor-core peak."""
    nbytes = nb * (r * c * 2 + 4) + (n_brows + 1) * 4 + d_in * batch * 2 \
        + d_out * batch * 4
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = 2 * nb * r * c * batch / BF16_OPS_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def lm_generate_checks(torch, lm, srv, cfg, rng, device, what: str) -> dict:
    """``srv.generate`` (B=4, prompt 128, 16 tokens) in range; decode(
    prefill(S)) within 5e-3 of prefill(S+1) (tests/test_archs.py's bound);
    a teacher-forced forward's argmax equal to the tokens wherever its
    top-2 margin exceeds 1e-3."""
    prompts = rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    t0 = time.perf_counter()
    out = srv.generate(prompts, LM_GEN)
    gen_s = time.perf_counter() - t0
    check(out.shape == (LM_BATCH, LM_GEN) and out.dtype == np.int32,
          f"{what}: generate gave {out.dtype}{out.shape}")
    check(((0 <= out) & (out < cfg.vocab)).all(), f"{what}: token out of range")
    p, toks = srv.params, torch.from_numpy(prompts).to(device)
    gen = torch.from_numpy(out).to(device)
    with torch.no_grad():
        _, caches = lm.prefill(p, toks, cfg, LM_MAX_LEN)
        got, _ = lm.decode_step(p, gen[:, :1], caches, cfg)
        want, _ = lm.prefill(p, torch.cat([toks, gen[:, :1]], 1), cfg, LM_MAX_LEN)
        step_err = max_err(torch, got, want)
        check(torch.allclose(got, want, rtol=5e-3, atol=5e-3),
              f"{what}: decode(prefill(S)) vs prefill(S+1): {step_err}")
        tf = teacher_forced(torch, lm, p, cfg, toks, gen)
        agree = greedy_agreement(torch, tf, gen, 1e-3)
        check(agree["agree"] == agree["checked"],
              f"{what}: teacher-forced argmax disagrees: {agree}")
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": "float32",
            "generate_shape": list(out.shape), "generate_s": gen_s,
            "decode_vs_prefill_max_err": step_err, "teacher_forced": agree}


def lm_dense_checks(torch, lm, A, Server, cfg, rng, device) -> None:
    """(a) Dense qwen1.5-0.5b in f32 (TF32 off)."""
    srv = Server(cfg, LM_MAX_LEN, device=device, dtype=torch.float32)
    res = lm_generate_checks(torch, lm, srv, cfg, rng, device, "lm dense")
    p = srv.params
    with torch.no_grad():
        # B=1, S=4096: the query-chunked path against the unchunked one
        long = torch.from_numpy(rng.integers(0, cfg.vocab, (1, LM_LONG))
                                .astype(np.int32)).to(device)
        calls, real = [], A._sdpa_qchunked
        A._sdpa_qchunked = lambda *a, **kw: calls.append(1) or real(*a, **kw)
        try:
            t0 = time.perf_counter()
            chunked, _ = lm.prefill(p, long, cfg, LM_LONG)
            torch.cuda.synchronize()
            chunked_s = time.perf_counter() - t0
        finally:
            A._sdpa_qchunked = real
        check(len(calls) == cfg.n_layers,
              f"lm dense: {len(calls)} chunked attention calls, not {cfg.n_layers}")
        threshold = A.CHUNKED_ATTN_THRESHOLD
        A.CHUNKED_ATTN_THRESHOLD = LM_LONG + 1
        try:
            t0 = time.perf_counter()
            unchunked, _ = lm.prefill(p, long, cfg, LM_LONG)
            torch.cuda.synchronize()
            unchunked_s = time.perf_counter() - t0
        finally:
            A.CHUNKED_ATTN_THRESHOLD = threshold
        chunk_err = max_err(torch, chunked, unchunked)
        check(torch.allclose(chunked, unchunked, rtol=LM_LOGIT_TOL, atol=LM_LOGIT_TOL),
              f"lm dense: chunked vs unchunked prefill: {chunk_err}")
    emit({"phase": "lm_dense", **res, "n_params": cfg.n_params,
          "chunked_prefill_S": LM_LONG,
          "chunked_calls": len(calls), "chunked_vs_unchunked_max_err": chunk_err,
          "chunked_s": chunked_s, "unchunked_s": unchunked_s, "ok": True})


def pm12(torch, rng, shape, device, gen=None):
    """Values in {±1, ±2} (f32): from ``rng`` on the host, or drawn on the
    card from ``gen`` (a host draw of one full-width gemma2 projection's
    85M values takes over a second)."""
    if gen is None:
        return torch.from_numpy(rng.choice(PM12, tuple(shape))).to(device)
    idx = torch.randint(0, 4, tuple(shape), generator=gen, device=gen.device)
    return torch.from_numpy(PM12).to(gen.device)[idx]


def block_plain(torch, browind, bcolind, bvalues, x, d_out: int):
    """``bcoo_spmv_plain``, in column chunks where its gather of x (blocks
    x c x B, in f32) would pass ``PLAIN_GATHER_BYTES``: a column's result
    does not depend on the others' (integer inputs stay exact; random
    float sums may round otherwise, within the checks' tolerance)."""
    from repro_torch.kernels.bcsr_spmv import bcoo_spmv_plain

    nb, _, c = bvalues.shape
    col_bytes = nb * c * 4
    B = x.shape[1] if x.ndim == 2 else 1
    if col_bytes * B <= PLAIN_GATHER_BYTES:
        return bcoo_spmv_plain(browind, bcolind, bvalues, x, d_out)
    step = max(1, int(PLAIN_GATHER_BYTES // (2 * col_bytes)))
    return torch.cat([bcoo_spmv_plain(browind, bcolind, bvalues, x[:, i:i + step],
                                      d_out) for i in range(0, B, step)], dim=1)


def lm_projection_kernels(torch, params, cfg, rng, device, f32: bool = False,
                          batches=(LM_BATCH, LM_BATCH * LM_PROMPT),
                          gen=None) -> float:
    """(b) Each sparse projection (72 in qwen1.5-0.5b): its kernel against
    ``bcoo_spmv_plain`` on the card at each of ``batches`` (B = 4 and 512
    unless given); integer-valued bf16
    (blocks in {±1, ±2}, x in {-2..2}: every f32 sum exact) bit-equal, the
    layer's own values (as bf16) with random x within rtol = atol = 2e-4
    (f32 sums in another order); with ``f32`` also the values and x in
    float32 (3xTF32 on the tensor cores).  The inputs are drawn on the card
    from ``gen`` (default: seeded with 14; a host draw of deepseek's prefix
    projections took seconds).  Returns the largest random-input error."""
    from repro_torch.kernels.bcsr_spmv import bcoo_spmv, block_route

    gen = torch.Generator(device=device).manual_seed(14) if gen is None else gen
    worst, n = 0.0, 0
    projections = lm_projections(params, cfg)
    for r, name, d_in, d_out, p in projections:
        ints = pm12(torch, rng, p["bvalues"].shape, device, gen).to(torch.bfloat16)
        vals = {"integer": ints, "random": p["bvalues"].to(torch.bfloat16)}
        if f32:
            vals["random_f32"] = p["bvalues"].float()
        for batch in batches:
            for kind, v in vals.items():
                x = (torch.randint(-2, 3, (d_in, batch), generator=gen, device=device)
                     if kind == "integer" else
                     torch.randn((d_in, batch), generator=gen, device=device))
                x = x.to(v.dtype)
                got = bcoo_spmv(p["browind"], p["bcolind"], v, x, d_out,
                                browptr=p["browptr"])
                want = block_plain(torch, p["browind"], p["bcolind"], v, x, d_out)
                what = (f"lm kernel layer {r} {name} B={batch} {kind} "
                        f"({block_route(v.dtype, 8, 128, batch)} route)")
                check(got.dtype == want.dtype and got.shape == want.shape,
                      f"{what}: {got.dtype}{tuple(got.shape)}")
                if kind == "integer":
                    check(torch.equal(got, want),
                          f"{what}: max |kernel - plain| = {max_err(torch, got, want)}")
                else:
                    err = max_err(torch, got, want)
                    worst = max(worst, err)
                    check(torch.allclose(got, want, rtol=2e-4, atol=2e-4),
                          f"{what}: max |kernel - plain| = {err}")
                n += 1
    emit({"phase": "lm_kernel_vs_plain", "arch": cfg.name,
          "projections": len(projections), "cases": n, "batches": list(batches),
          "random_max_abs_err": worst, "ok": True})
    return worst


@contextlib.contextmanager
def dense_ffn_takes_silu(cfg):
    """The densified oracle runs the dense FFN, which takes tanh-GELU in a
    gemma config; the block-sparse FFN takes SiLU there in both packages
    (``src/repro/sparse/layers.py:105-108``), so for a gemma config the
    oracle's dense FFN is given SiLU while it runs."""
    from repro_torch.models import blocks

    real = blocks.gelu
    if cfg.gemma_norm:
        blocks.gelu = blocks.F.silu
    try:
        yield
    finally:
        blocks.gelu = real


def lm_sparse_checks(torch, lm, instrument, Server, cfg, rng, device,
                     kernels: bool = True, f32: bool = False, gen=None) -> tuple:
    """(b) Block-sparse qwen1.5-0.5b in f32: the kernels per projection
    (unless ``kernels`` is False: phase 16 checks deepseek's at its bf16
    cut, where the plain version's (blocks, 128, 512) gather fits beside
    the model; ``f32`` and ``gen`` as ``lm_projection_kernels``), the model
    against its densified torch.matmul oracle, and the launch count of one
    generate.  Returns (launches, random max err)."""
    srv = Server(cfg, LM_MAX_LEN, device=device, dtype=torch.float32)
    worst = (lm_projection_kernels(torch, srv.params, cfg, rng, device, f32=f32,
                                   gen=gen) if kernels else 0.0)
    per_step = lm_launches_per_step(srv.params, cfg)
    prompts = rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    torch.cuda.synchronize()
    instrument.reset()
    out = srv.generate(prompts, LM_GEN)
    launches = instrument.snapshot()
    want_launches = per_step * LM_GEN
    check(launches.get("bcoo", 0) == want_launches,
          f"lm sparse: {launches} block-kernel launches, not {want_launches}")
    check(launches.get("bcoo.spmm", 0) == want_launches,
          f"lm sparse: every projection is an SpMM (B >= 4): {launches}")
    dense_cfg = dataclasses.replace(cfg, ffn_density=1.0)
    oracle = densified_params(torch, srv.params, cfg)
    toks, gen = (torch.from_numpy(a).to(device) for a in (prompts, out))
    with torch.no_grad(), dense_ffn_takes_silu(cfg):
        instrument.reset()
        got, caches = lm.prefill(srv.params, toks, cfg, LM_MAX_LEN)
        want, ocaches = lm.prefill(oracle, toks, dense_cfg, LM_MAX_LEN)
        errs = {"prefill": max_err(torch, got, want)}
        check(torch.allclose(got, want, rtol=LM_LOGIT_TOL, atol=LM_LOGIT_TOL),
              f"lm sparse: prefill logits vs densified oracle: {errs}")
        for step in range(3):
            got, caches = lm.decode_step(srv.params, gen[:, step:step + 1], caches, cfg)
            want, ocaches = lm.decode_step(oracle, gen[:, step:step + 1], ocaches,
                                           dense_cfg)
            errs[f"decode{step}"] = max_err(torch, got, want)
            check(torch.allclose(got, want, rtol=LM_LOGIT_TOL, atol=LM_LOGIT_TOL),
                  f"lm sparse: decode step {step} vs densified oracle: {errs}")
        check(instrument.launches("bcoo") == per_step * 4,
              f"lm sparse: oracle comparison launches {instrument.snapshot()}")
        tf_sparse = teacher_forced(torch, lm, srv.params, cfg, toks, gen)
        tf_oracle = teacher_forced(torch, lm, oracle, dense_cfg, toks, gen)
        errs["teacher_forced"] = max_err(torch, tf_sparse, tf_oracle)
        check(torch.allclose(tf_sparse, tf_oracle, rtol=LM_LOGIT_TOL,
                             atol=LM_LOGIT_TOL),
              f"lm sparse: teacher-forced logits vs oracle: {errs}")
        # the oracle's greedy choice wherever its top-2 margin exceeds twice
        # the logit error just measured
        agree = greedy_agreement(torch, tf_oracle, gen, 2 * errs["teacher_forced"])
        check(agree["agree"] == agree["checked"],
              f"lm sparse: tokens differ from the oracle's greedy ones: {agree}")
    emit({"phase": "lm_sparse", "arch": cfg.name, "dtype": "float32",
          "ffn_density": cfg.ffn_density, "block": list(cfg.sparse_block),
          "n_params": cfg.n_params, "launches_per_generate": launches,
          "want_launches": want_launches, "oracle_max_abs_err": errs,
          "tolerance": LM_LOGIT_TOL, "greedy_vs_oracle": agree, "ok": True})
    return launches.get("bcoo", 0), worst


def device_trace(torch, step, steps: int = 5) -> dict:
    """torch.profiler over ``steps`` calls of ``step`` (a decode step, a
    train step) after one unprofiled call: host-clock ms a step, the
    device's busy ms a step (the sum of its kernels), its idle share and the
    kernels that take most; {"profiler": "not measured: ..."} when the
    trace holds no device time."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
        kernels = {}
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                us = getattr(ev, "self_device_time_total", None)
                us = ev.self_cuda_time_total if us is None else us
                kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3 / steps
        busy = sum(kernels.values())
        if not busy:
            return {"profiler": "not measured: no device time in the trace"}
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        return {"wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
                "idle_share": max(0.0, 1.0 - busy / wall),
                "kernels_per_step": sum(ev.count for ev in prof.key_averages()
                                        if ev.device_type == DeviceType.CUDA) / steps,
                "top_kernels_ms": [[k[:80], v] for k, v in top]}
    except Exception as e:  # a measurement only; the checks stand apart
        return {"profiler": f"not measured: {type(e).__name__}: {e}"}


def lm_serving_times(torch, lm, Server, cfg, rng, device, srv=None) -> dict:
    """(c) bf16: prefill ms, decode ms per token (CUDA events) and tokens/s
    of a generate (host clock; it ends in a copy to the host), on ``srv``
    or a new bf16 ``Server``."""
    if srv is None:
        srv = Server(cfg, LM_MAX_LEN, device=device)
    prompts = rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    toks = torch.from_numpy(prompts).to(device)
    with torch.no_grad():
        _, caches = lm.prefill(srv.params, toks, cfg, LM_MAX_LEN)
        tok = toks[:, -1:]
        prefill_ms = time_ms(torch, lambda: lm.prefill(srv.params, toks, cfg,
                                                       LM_MAX_LEN), 10)
        # the same slot rewritten each call: the caches are not advanced
        decode_ms = time_ms(torch, lambda: lm.decode_step(srv.params, tok, caches,
                                                          cfg), 20)
        trace = device_trace(torch, lambda: lm.decode_step(srv.params, tok, caches,
                                                           cfg))
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        srv.generate(prompts, LM_GEN)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    row = {"phase": "lm_times", "arch": cfg.name, "dtype": "bfloat16",
           "ffn_density": cfg.ffn_density, "batch": LM_BATCH, "prompt": LM_PROMPT,
           "gen": LM_GEN, "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
           "generate_s": wall, "generate_s_all": walls,
           "tokens_per_s": LM_BATCH * LM_GEN / wall, "decode_trace": trace}
    emit(row)
    del srv, caches
    return row


def lm_projection_times(torch, cfg, rng, device,
                        batches=(1, LM_BATCH, LM_BATCH * LM_PROMPT)) -> list:
    """(c) w_gate (d_model -> d_ff) and w_down of a bf16 layer of ``cfg``
    (qwen1.5-0.5b: 1024 -> 2816; deepseek's prefix: 7168 -> 18,432) at
    each of ``batches`` (B = 1, 4 and 512 unless given): the block kernel
    (its route), its plain version, torch.matmul on the dense weight, and
    the bytes / operations bound; below B = 8 also the tensor-core route
    (``mma_ms``), held against the plain version first."""
    from repro_torch.kernels.bcsr_spmv import bcoo_spmv, bcoo_spmv_cuda, block_route
    from repro_torch.sparse.layers import sparse_linear_init

    gen = torch.Generator(device=device).manual_seed(14)
    rows = []
    for name, d_in, d_out in (("w_gate", cfg.d_model, cfg.d_ff),
                              ("w_down", cfg.d_ff, cfg.d_model)):
        p = sparse_linear_init(gen, d_in, d_out, cfg.ffn_density, cfg.sparse_block)
        w = densified(torch, p, d_in, d_out)
        nb, r, c = p["bvalues"].shape
        for batch in batches:
            x = torch.from_numpy(rng.standard_normal((d_in, batch))).to(
                device, torch.bfloat16)
            bound, by = lm_bound(nb, r, c, d_out // r, d_in, d_out, batch)
            row = {"phase": "lm_projection", "name": name, "d_in": d_in,
                   "d_out": d_out, "B": batch, "blocks": nb,
                   "route": block_route(torch.bfloat16, r, c, batch),
                   "ms": time_ms(torch, lambda: bcoo_spmv(
                       p["browind"], p["bcolind"], p["bvalues"], x, d_out,
                       browptr=p["browptr"]), 50),
                   "plain_ms": time_ms(torch, lambda: block_plain(
                       torch, p["browind"], p["bcolind"], p["bvalues"], x, d_out),
                       10 if nb * c * 4 * batch <= PLAIN_GATHER_BYTES else 2,
                       warmup=1),
                   "library_ms": time_ms(torch, lambda: torch.matmul(w, x), 50),
                   "bound_ms": bound, "bound_by": by}
            row["roofline_share"] = bound / row["ms"]
            if row["route"] != "mma":  # the tensor cores beside the route taken
                run = lambda: bcoo_spmv_cuda(p["browptr"], p["bcolind"],
                                             p["bvalues"], x, d_out, route="mma")
                want = block_plain(torch, p["browind"], p["bcolind"], p["bvalues"],
                                   x, d_out)
                check(torch.allclose(run(), want, rtol=2e-4, atol=2e-4),
                      f"lm {name} B={batch}: mma route vs plain: "
                      f"{max_err(torch, run(), want)}")
                row["mma_ms"] = time_ms(torch, run, 50)
            emit(row)
            rows.append(row)
    return rows


def phase_lm(torch, rng, device) -> dict:
    """Phase 14: LM serving at qwen1.5-0.5b's full width (see the module
    docstring).  Returns the block kernel's launches of one sparse
    generate (the LM serving path's count) and the phase's rows."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import instrument
    from repro_torch.launch.serve import Server
    from repro_torch.models import attention as A
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(LM_ARCH)
    sparse = dataclasses.replace(cfg, ffn_density=0.5)
    check(cfg.n_params == 463_863_808 and sparse.n_params == 360_054_784,
          f"lm: parameter counts {cfg.n_params} / {sparse.n_params}")
    lm_dense_checks(torch, lm, A, Server, cfg, rng, device)
    gc.collect()
    torch.cuda.empty_cache()
    launches, worst = lm_sparse_checks(torch, lm, instrument, Server, sparse, rng,
                                       device)
    gc.collect()
    torch.cuda.empty_cache()
    times = [lm_serving_times(torch, lm, Server, c, rng, device)
             for c in (cfg, sparse)]
    gc.collect()
    torch.cuda.empty_cache()
    proj = lm_projection_times(torch, sparse, rng, device)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "lm_done", "seconds": seconds, "launches": launches,
          "peak_allocated_bytes": torch.cuda.max_memory_allocated()})
    return {"launches": launches, "max_abs_err": worst, "times": times,
            "projections": proj, "seconds": seconds}


# ------------------------------------------------------------- phase 15


TRAIN_ARCH = "smollm-360m"  # launch/train.py's default arch
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 30, 8, 512  # (b), through train.main
# (a) and (c): T = 1,024; 6 steps (10 until phase 28: the steps of phases
# 15 (c), 18 (d) and 25 (b) paid for it)
SPARSE_B, SPARSE_S, SPARSE_STEPS = 4, 256, 6
GRAD_TOL = 1e-4  # f32 grads vs the densified oracle, relative to the max


def rel_err(torch, got, want) -> float:
    """max |got - want| over max |want|."""
    return max_err(torch, got, want) / max(float(want.double().abs().max()), 1e-30)


def timed_loop(torch, TrainLoop, instrument):
    """A TrainLoop subclass that records each step's host-clock ms (the step
    ends in a synchronize) and the block kernel's launches in it."""

    class Timed(TrainLoop):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.step_ms, self.step_launches = [], []
            inner = self.step_fn

            def step(*a):
                n0, t0 = instrument.launches("bcoo"), time.perf_counter()
                out = inner(*a)
                torch.cuda.synchronize()
                self.step_ms.append((time.perf_counter() - t0) * 1e3)
                self.step_launches.append(instrument.launches("bcoo") - n0)
                return out

            self.step_fn = step

    return Timed


def train_backward(torch, cfg, rng, device, draws=None) -> tuple:
    """(a) The sparse FFN's backward at full width: w_gate and w_down of
    qwen1.5-0.5b in (8, 128) blocks, T = 1,024 (the integer-valued blocks
    drawn on the card from ``draws``, as ``pm12``; default seeded with
    215).  Returns (rows, the largest random-input error of the forward and
    grad x against their plain versions)."""
    from repro_torch.kernels.bcsr_spmv import (bcoo_spmv, bcoo_spmv_plain,
                                               block_route, transposed_values)
    from repro_torch.sparse.layers import sparse_linear_apply, sparse_linear_init

    if draws is None:
        draws = torch.Generator(device=device).manual_seed(215)
    T = SPARSE_B * SPARSE_S
    gen = torch.Generator(device=device).manual_seed(15)
    rows, worst = [], 0.0
    for name, d_in, d_out in (("w_gate", cfg.d_model, cfg.d_ff),
                              ("w_down", cfg.d_ff, cfg.d_model)):
        p = sparse_linear_init(gen, d_in, d_out, cfg.ffn_density, cfg.sparse_block,
                               torch.float32)
        nb, r, c = p["bvalues"].shape
        counts = torch.diff(p["t_browptr"]).cpu()
        tkw = dict(browptr=p["t_browptr"])
        fwd = (p["browind"], p["bcolind"])
        # the forward y = W x and grad x = Wᵀ gy through the kernel against
        # their plain versions, at the training path's T
        for dt in (torch.bfloat16, torch.float32):
            ints = pm12(torch, rng, (nb, r, c), device, draws).to(dt)
            xi = torch.from_numpy(rng.integers(-2, 3, (d_in, T))).to(device, dt)
            got = bcoo_spmv(*fwd, ints, xi, d_out, browptr=p["browptr"])
            want = block_plain(torch, *fwd, ints, xi, d_out)
            check(torch.equal(got, want), f"train {name} forward {dt} integer: "
                  f"max |kernel - plain| = {max_err(torch, got, want)}")
            gy = torch.from_numpy(rng.integers(-2, 3, (d_out, T))).to(device, dt)
            tv = transposed_values(ints, p["t_perm"])
            got = bcoo_spmv(p["t_browind"], p["t_bcolind"], tv, gy, d_in, **tkw)
            want = bcoo_spmv_plain(p["t_browind"], p["t_bcolind"], tv, gy, d_in)
            check(torch.equal(got, want), f"train {name} grad x {dt} integer: "
                  f"max |kernel - plain| = {max_err(torch, got, want)}")
        xr = torch.from_numpy(rng.standard_normal((d_in, T))).to(device, torch.float32)
        got = bcoo_spmv(*fwd, p["bvalues"], xr, d_out, browptr=p["browptr"])
        want = block_plain(torch, *fwd, p["bvalues"], xr, d_out)
        err_fwd = max_err(torch, got, want)
        check(torch.allclose(got, want, rtol=2e-4, atol=2e-4),
              f"train {name} forward random f32: max |kernel - plain| = {err_fwd}")
        gy = torch.from_numpy(rng.standard_normal((d_out, T))).to(device, torch.float32)
        tv = transposed_values(p["bvalues"], p["t_perm"])
        got = bcoo_spmv(p["t_browind"], p["t_bcolind"], tv, gy, d_in, **tkw)
        want = bcoo_spmv_plain(p["t_browind"], p["t_bcolind"], tv, gy, d_in)
        err = max_err(torch, got, want)
        worst = max(worst, err, err_fwd)
        check(torch.allclose(got, want, rtol=2e-4, atol=2e-4),
              f"train {name} grad x random f32: max |kernel - plain| = {err}")
        # both grads through autograd against the densified torch.matmul oracle
        x = torch.from_numpy(rng.standard_normal((T, d_in))).to(device, torch.float32)
        gyt = gy.T.contiguous()
        bv = p["bvalues"].clone().requires_grad_()
        xx = x.clone().requires_grad_()
        sparse_linear_apply(dict(p, bvalues=bv), xx, d_out).backward(gyt)
        bo = p["bvalues"].clone().requires_grad_()
        xo = x.clone().requires_grad_()
        w = densified(torch, dict(p, bvalues=bo), d_in, d_out)
        torch.matmul(xo, w.T).backward(gyt)
        oracle = {"grad_x": rel_err(torch, xx.grad, xo.grad),
                  "grad_bvalues": rel_err(torch, bv.grad, bo.grad)}
        check(max(oracle.values()) <= GRAD_TOL,
              f"train {name}: grads vs densified oracle {oracle}")
        # times at the training dtype (bf16 values, f32 gy before its cast)
        vb = p["bvalues"].to(torch.bfloat16)
        tvb = transposed_values(vb, p["t_perm"])
        xb = x.to(torch.bfloat16)
        xtb = xb.T.contiguous()
        gyb = gy.to(torch.bfloat16)
        wb = densified(torch, dict(p, bvalues=vb), d_in, d_out)
        gather = (p["browind"].long(), p["bcolind"].long())

        def grad_values():  # as BlockSpMM.backward: f32 product, then a gather
            g = torch.matmul(gy, xb.float()).view(d_out // r, r, d_in // c, c)
            return g[gather[0], :, gather[1], :].to(torch.bfloat16)

        bound_x, by_x = lm_bound(nb, c, r, d_in // c, d_out, d_in, T)
        # grad bvalues: gy (f32) and x (bf16) read once, the blocks written
        # once; the block-sampled multiply-adds over the bf16 tensor rate
        gv_bytes = d_out * T * 4 + T * d_in * 2 + nb * r * c * 2
        gv_ops = 2 * nb * r * c * T
        bound_v = max(gv_bytes / HBM_BYTES_S, gv_ops / BF16_OPS_S) * 1e3
        row = {
            "phase": "train_backward", "name": name, "d_in": d_in, "d_out": d_out,
            "T": T, "blocks": nb, "block": [r, c], "transposed_block": [c, r],
            "transposed_block_rows": int(counts.numel()),
            "transposed_blocks_per_row": {"min": int(counts.min()),
                                          "max": int(counts.max()),
                                          "mean": float(counts.float().mean())},
            "forward_route": block_route(torch.bfloat16, r, c, T),
            "grad_x_route": block_route(torch.bfloat16, c, r, T),
            "forward_random_max_abs_err": err_fwd,
            "grad_x_random_max_abs_err": err, "oracle_rel_err": oracle,
            "forward_ms": time_ms(torch, lambda: bcoo_spmv(
                p["browind"], p["bcolind"], vb, xtb, d_out,
                browptr=p["browptr"]), 20),
            "grad_x_ms": time_ms(torch, lambda: bcoo_spmv(
                p["t_browind"], p["t_bcolind"], tvb, gyb, d_in, **tkw), 20),
            "grad_x_plain_ms": time_ms(torch, lambda: bcoo_spmv_plain(
                p["t_browind"], p["t_bcolind"], tvb, gyb, d_in), 5, warmup=1),
            "transpose_values_ms": time_ms(torch, lambda: transposed_values(
                vb, p["t_perm"]), 20),
            "grad_bvalues_ms": time_ms(torch, grad_values, 20),
            "library_ms": time_ms(torch, lambda: torch.matmul(wb.T, gyb), 20),
            "grad_x_bound_ms": bound_x, "grad_x_bound_by": by_x,
            "grad_bvalues_bound_ms": bound_v,
            "grad_bvalues_bound_by": ("bytes" if gv_bytes / HBM_BYTES_S
                                      >= gv_ops / BF16_OPS_S else "operations"),
        }
        emit(row)
        rows.append(row)
    return rows, worst


def train_dense_main(torch, T_, instrument) -> dict:
    """(b) smollm-360m at full width through ``launch.train.main``."""
    loops = []
    base = timed_loop(torch, T_.TrainLoop, instrument)

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            loops.append(self)

    real = T_.TrainLoop
    T_.TrainLoop = Recorded
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        losses = T_.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                          "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)])
        run_s = time.perf_counter() - t0
    finally:
        T_.TrainLoop = real
    loop = loops[0]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"train {TRAIN_ARCH}: losses {losses}")
    check(losses[-1] < losses[0] - 1.0,
          f"train {TRAIN_ARCH}: loss fell {losses[0]} -> {losses[-1]}, not by 1.0")
    peak = torch.cuda.max_memory_allocated()
    # the window is taken before the trace: its steps go through the same
    # timed step_fn and would land in step_ms
    step_ms = list(loop.step_ms)
    med = statistics.median(step_ms[-20:])
    batch = loop.stream.batch(loop.step, loop.device)
    trace = device_trace(torch, lambda: loop.step_fn(loop.params, loop.opt, batch),
                         steps=3)
    row = {"phase": "train_dense", "arch": TRAIN_ARCH, "dtype": "bfloat16",
           "n_params": loop.cfg.n_params, "steps": TRAIN_STEPS,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "loss_first": losses[0],
           "loss_last": losses[-1], "losses": losses, "run_s": run_s,
           "step_ms_median_last20": med, "step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med * 1e3,
           "peak_allocated_bytes": peak, "trace_3_steps": trace}
    emit(row)
    return row


def train_sparse_loops(torch, T_, cfg, AdamWConfig, instrument, device) -> dict:
    """(c) qwen1.5-0.5b dense and block-sparse, bf16, 6 steps each through
    TrainLoop.  The block kernel's count of one train step (the last, with
    the counters set to 0 just before it) is the training path's."""
    Timed = timed_loop(torch, T_.TrainLoop, instrument)
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=3, total_steps=SPARSE_STEPS)
    out = {}
    for label, c in (("dense", cfg), ("sparse", dataclasses.replace(cfg,
                                                                   ffn_density=0.5))):
        loop = Timed(c, opt_cfg, seq_len=SPARSE_S, global_batch=SPARSE_B,
                     device=device)
        loop.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = loop.run(SPARSE_STEPS - 1, log_every=0)
        instrument.reset()
        losses += loop.run(SPARSE_STEPS, log_every=0)
        launches = instrument.launches("bcoo")
        check(len(losses) == SPARSE_STEPS and all(np.isfinite(losses))
              and losses[-1] < losses[0], f"train {c.name} {label}: losses {losses}")
        want = 3 * c.n_layers * 3 if label == "sparse" else 0
        check(launches == want and all(n == want for n in loop.step_launches),
              f"train {label}: {launches} block-kernel launches in a step "
              f"({loop.step_launches}), not {want}")
        med = statistics.median(loop.step_ms[1:])
        out[label] = {"phase": "train_qwen", "arch": c.name, "variant": label,
                      "dtype": "bfloat16", "ffn_density": c.ffn_density,
                      "block": list(c.sparse_block), "n_params": c.n_params,
                      "batch": SPARSE_B, "seq": SPARSE_S, "losses": losses,
                      "step_ms": loop.step_ms, "step_ms_median": med,
                      "tokens_per_s": SPARSE_B * SPARSE_S / med * 1e3,
                      "launches_per_step": loop.step_launches,
                      "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
        del loop
        gc.collect()
        torch.cuda.empty_cache()
    out["sparse"]["step_ms_ratio_sparse_to_dense"] = (
        out["sparse"]["step_ms_median"] / out["dense"]["step_ms_median"])
    for row in out.values():
        emit(row)
    return {"launches": out["sparse"]["launches_per_step"][-1], "rows": out}


def train_card_vs_cpu(torch, c, rng, device, phase: str = "train_card_vs_cpu") -> dict:
    """(d) ``c`` (qwen1.5-0.5b at full width cut to 2 layers, block-sparse),
    f32 (TF32 off): one train step on the card (the kernels) against the
    same step on the CPU (the plain versions), from the same params and a
    (2, 64) batch (with f32 frames of the same length for an enc-dec
    ``c``, and a stub f32 prefix of ``c.modality_tokens`` for llava)."""
    from repro_torch.launch.steps import carry_derived, value_and_grad_trainable
    from repro_torch.models import lm
    from repro_torch.models.common import map_params
    from repro_torch.optim import AdamWConfig, apply_updates, init_opt
    from repro_torch.sparse.layers import strip_derived
    from repro_torch.tree import leaves

    params = lm.init_params(torch.Generator().manual_seed(15), c, torch.float32)
    toks = torch.from_numpy(rng.integers(0, c.vocab, (2, 64)).astype(np.int32))
    cpu_batch = {"tokens": toks, "labels": toks}
    if c.encoder_layers:
        cpu_batch["frames"] = torch.from_numpy(
            rng.standard_normal((2, 64, c.d_model)).astype(np.float32))
    if c.modality_tokens:  # llava: a stub prefix the loss does not score
        cpu_batch["prefix_embeds"] = torch.from_numpy(
            rng.standard_normal((2, c.modality_tokens, c.d_model)).astype(np.float32))
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    res = {}
    for dev in ("cpu", device):
        p = map_params(lambda a: a.to(dev), params)
        batch = {k: v.to(dev) for k, v in cpu_batch.items()}
        t0 = time.perf_counter()
        loss, grads = value_and_grad_trainable(lm.loss_fn)(p, batch, c)
        new, _, metrics = apply_updates(strip_derived(p), strip_derived(grads),
                                        init_opt(strip_derived(p), opt_cfg), opt_cfg)
        new = carry_derived(new, p)
        res[str(dev)] = (float(loss), leaves(strip_derived(grads)),
                         leaves(strip_derived(new)), time.perf_counter() - t0)
    (lc, gc_, pc, sc), (lg, gg, pg, sg) = res["cpu"], res[str(device)]
    loss_rel = abs(lg - lc) / abs(lc)
    grad_rel, param_err = 0.0, 0.0
    for a, b, pa, pb in zip(gg, gc_, pg, pc):
        if not b.is_floating_point() or not b.numel():  # an empty stack: no repeats
            continue
        grad_rel = max(grad_rel, rel_err(torch, a.cpu(), b))
        big = b.abs() > 1e-3 * b.abs().max()
        if big.any():
            param_err = max(param_err, max_err(torch, pa.cpu()[big], pb[big]))
    check(loss_rel <= 1e-5, f"{phase}: loss {lg} vs {lc}")
    check(grad_rel <= GRAD_TOL, f"{phase}: grad rel err {grad_rel}")
    check(param_err <= 1e-5, f"{phase}: updated params {param_err}")
    row = {"phase": phase, "arch": c.name, "n_layers": c.n_layers,
           "encoder_layers": c.encoder_layers,
           "ffn_density": c.ffn_density, "dtype": "float32", "tokens": [2, 64],
           "loss_card": lg, "loss_cpu": lc, "loss_rel_err": loss_rel,
           "grad_max_rel_err": grad_rel, "param_max_abs_err": param_err,
           "card_s": sg, "cpu_s": sc, "ok": True}
    emit(row)
    return row


def train_restart(torch, T_, AdamWConfig, device) -> dict:
    """(e) smollm-360m at full width, 4 layers: train(10) against train(6)
    + save + a fresh loop's maybe_restore + train(4)."""
    import tempfile

    from repro_torch.configs import get_config

    c = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=4)
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="train-", dir=os.path.join(ROOT, "build")) as d:
        def fresh(ckpt):
            return T_.TrainLoop(c, opt_cfg, seq_len=128, global_batch=4,
                                ckpt_dir=ckpt, ckpt_every=6, device=device)

        a = fresh(None)
        a.init_state()
        want = a.run(10, log_every=0)
        b = fresh(d)
        b.init_state()
        first = b.run(6, log_every=0)
        del a, b
        t0 = time.perf_counter()
        b2 = fresh(d)
        check(b2.maybe_restore() and b2.step == 6, "train restart: no step-6 checkpoint")
        restore_s = time.perf_counter() - t0
        got = first + b2.run(10, log_every=0)
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(d) for f in fs)
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    check(rel <= 1e-5, f"train restart: {got} vs {want}")
    row = {"phase": "train_restart", "arch": c.name, "n_layers": c.n_layers,
           "losses_uninterrupted": want, "losses_resumed": got, "max_rel_err": rel,
           "restore_s": restore_s, "checkpoint_bytes": ckpt_bytes, "ok": True}
    emit(row)
    return row


def phase_train(torch, rng, device) -> dict:
    """Phase 15: LM training (see the module docstring).  Returns the block
    kernel's launches in one sparse train step (the training path's count),
    the largest grad-x error against the plain version and the rows."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import instrument
    from repro_torch.launch import train as T_
    from repro_torch.optim import AdamWConfig

    t_phase = time.perf_counter()
    qwen = dataclasses.replace(get_config(LM_ARCH), ffn_density=0.5)
    backward, worst = train_backward(torch, qwen, rng, device)
    gc.collect()
    torch.cuda.empty_cache()
    dense = train_dense_main(torch, T_, instrument)
    gc.collect()
    torch.cuda.empty_cache()
    sparse = train_sparse_loops(torch, T_, get_config(LM_ARCH), AdamWConfig,
                                instrument, device)
    card_cpu = train_card_vs_cpu(torch, dataclasses.replace(qwen, n_layers=2), rng,
                                 device)
    gc.collect()
    torch.cuda.empty_cache()
    restart = train_restart(torch, T_, AdamWConfig, device)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "train_done", "seconds": seconds, "launches": sparse["launches"]})
    return {"launches": sparse["launches"], "max_abs_err": worst,
            "backward": backward, "dense": dense, "sparse": sparse["rows"],
            "card_vs_cpu": card_cpu, "restart": restart, "seconds": seconds}


# ------------------------------------------------------------- phase 16: MoE

MOE_ARCHS = ("mixtral-8x22b", "deepseek-v3-671b")
MOE_SERVE_LAYERS = {"mixtral-8x22b": 8, "deepseek-v3-671b": 4}  # bf16 serving cuts
MOE_CHECK_LAYERS = 2  # the f32 cuts
MOE_TOKENS = (LM_BATCH * LM_PROMPT, LM_BATCH)  # T at prefill and at decode
MOE_ORACLE_TOL = 2e-3  # f32 moe_apply vs the f32 oracle (tests/test_moe_sparse.py)
MOE_BF16_TOL = 1e-2  # bf16 moe_apply vs the f32 oracle, ||err|| / ||oracle||
MLA_TOL = 1e-3  # f32 MLA chunked vs unchunked at S = 4,096


def moe_cut(cfg, n_layers: int):
    """``cfg`` cut to ``n_layers``: its first prefix layers, then the
    repeats (deepseek at 4: the 3 dense MLA layers and 1 MLA + MoE repeat;
    at 2: 1 and 1)."""
    pre = min(len(cfg.prefix_pattern), n_layers - len(cfg.block_pattern))
    return dataclasses.replace(cfg, n_layers=n_layers,
                               prefix_pattern=cfg.prefix_pattern[:pre])


def moe_oracle(torch, p, x2d, route, cfg):
    """y (T, d) in f32: for each expert, the tokens the routing sent it
    through its SwiGLU in f32 (weights upcast), weighted by their gates
    and summed back (tests/test_moe_sparse.py's per-token loop, taken
    expert by expert; no capacity), plus the shared experts.  Built from
    plain products, without the port's dispatch or combine."""
    xf = x2d.float()
    y = torch.zeros_like(xf)
    for e in range(cfg.n_experts):
        t, j = torch.nonzero(route.expert == e, as_tuple=True)
        if t.numel():
            xe = xf[t]
            h, u = xe @ p["w_gate"][e].float(), xe @ p["w_up"][e].float()
            ye = (h * torch.sigmoid(h) * u) @ p["w_down"][e].float()
            y.index_add_(0, t, ye * route.weight[t, j][:, None])
    if cfg.n_shared_experts:
        sh = {k: v["w"].float() for k, v in p["shared"].items()}
        h = xf @ sh["w_gate"]
        y += (h * torch.sigmoid(h) * (xf @ sh["w_up"])) @ sh["w_down"]
    return y


def moe_plain_experts(torch, p, x2d, cfg):
    """The router recomputed plainly: ``torch.topk`` of f32 scores (logits,
    or sigmoid affinities plus the bias), ids only."""
    logits = x2d.float() @ p["router"]["w"].to(x2d.dtype).float()
    if cfg.moe_router == "deepseek":
        logits = torch.sigmoid(logits) + p["router_bias"]
    return torch.topk(logits, cfg.moe_top_k, dim=-1).indices


def moe_bound(cfg, T: int, cap: int) -> tuple:
    """(ms, by) of a bf16 layer: the expert weights (the f32 router's
    too), x and y once over HBM (every expert holds slots: cap >= 8), or
    the padded slots' multiply-adds over the bf16 tensor-core peak."""
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    weights = 3 * E * d * f + 3 * d * f * cfg.n_shared_experts + d * E * 2
    nbytes = weights * 2 + 2 * T * d * 2
    ops = 2 * 3 * (E * cap + T * cfg.n_shared_experts) * d * f
    by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, ops / BF16_OPS_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def moe_layer_checks(torch, M, name, rng, device) -> list:
    """(a) One MoE layer of ``name`` at full width: f32 and then bf16
    against the f32 oracle over the same routing at ample capacity; the
    routing against the plain router; drops, padding efficiency, bit
    reproducibility and times at the configured capacity factor."""
    from repro_torch.configs import get_config

    cfg = get_config(name)
    ample = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    gen = torch.Generator(device=device).manual_seed(16)
    p = M.moe_init(gen, cfg, torch.float32)
    if cfg.moe_router == "deepseek":  # zeros at init would leave it untested
        p["router_bias"] = torch.randn(cfg.n_experts, generator=gen,
                                       device=device) * 0.02
    route_fn = M._route_deepseek if cfg.moe_router == "deepseek" else M._route_mixtral
    xs = {T: torch.from_numpy(rng.standard_normal((LM_BATCH, T // LM_BATCH,
                                                   cfg.d_model)).astype(np.float32))
          .to(device) for T in MOE_TOKENS}
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        if dtype == torch.bfloat16:  # leaf by leaf: f32 and bf16 never both whole
            for key in ("w_gate", "w_up", "w_down"):
                p[key] = p[key].to(dtype)
            if "shared" in p:
                p["shared"] = {k: {"w": v["w"].to(dtype)} for k, v in p["shared"].items()}
        for T, x in xs.items():
            x = x.to(dtype)
            x2d = x.reshape(T, cfg.d_model)
            what = f"moe {name} {str(dtype)[6:]} T={T}"
            with torch.no_grad():
                route = route_fn(p, x2d, cfg.moe_top_k)
                plain = moe_plain_experts(torch, p, x2d, cfg)
                check(torch.equal(route.expert.long(), plain),
                      f"{what}: routing differs from the plain router")
                y = M.moe_apply(p, x, ample).reshape(T, cfg.d_model).float()
                want = moe_oracle(torch, p, x2d, route, cfg)
                err = max_err(torch, y, want)
                rel = float((y - want).norm() / want.norm())
                if dtype == torch.float32:
                    check(torch.allclose(y, want, rtol=MOE_ORACLE_TOL,
                                         atol=MOE_ORACLE_TOL),
                          f"{what}: vs the f32 oracle: max |err| {err}")
                else:
                    check(rel <= MOE_BF16_TOL, f"{what}: vs the f32 oracle: "
                          f"relative error {rel} > {MOE_BF16_TOL}")
                row = {"phase": "moe_layer", "arch": name, "dtype": str(dtype)[6:],
                       "T": T, "oracle_max_abs_err": err, "oracle_rel_err": rel,
                       "oracle_scale": float(want.abs().max())}
                if dtype == torch.bfloat16:
                    row.update(moe_capacity_stats(torch, M, p, x, x2d, route, cfg))
                    runs = [M.moe_apply(p, x, cfg) for _ in range(2)]
                    check(torch.equal(runs[0], runs[1]),
                          f"{what}: two runs differ: {max_err(torch, *runs)}")
                    row["bit_equal_runs"] = True
                    row.update(moe_times(torch, M, p, x, x2d, cfg, route_fn))
            emit(row)
            rows.append(row)
    return rows


def moe_capacity_stats(torch, M, p, x, x2d, route, cfg) -> dict:
    """At the configured factor: slots, kept and dropped assignments, and
    the padding efficiency (kept assignments / slots)."""
    T = x2d.shape[0]
    cap = cfg.moe_capacity(T)
    _, meta = M._local_dispatch(x2d, route.expert.reshape(-1),
                                route.weight.reshape(-1), cfg.n_experts, cap)
    kept = int(meta[3].sum())
    return {"capacity_factor": cfg.moe_capacity_factor, "capacity": cap,
            "slots": cfg.n_experts * cap, "assignments": T * cfg.moe_top_k,
            "kept": kept, "dropped": T * cfg.moe_top_k - kept,
            "padding_efficiency": kept / (cfg.n_experts * cap)}


def moe_times(torch, M, p, x, x2d, cfg, route_fn) -> dict:
    """CUDA-event ms of bf16 ``moe_apply`` at the configured factor and of
    its parts (routing, dispatch, the three expert products and SiLU, the
    combine), beside the bound."""
    import torch.nn.functional as F

    T = x2d.shape[0]
    k, E, cap = cfg.moe_top_k, cfg.n_experts, cfg.moe_capacity(T)
    route = route_fn(p, x2d, k)
    eid, gate = route.expert.reshape(-1), route.weight.reshape(-1)
    xbuf, meta = M._local_dispatch(x2d, eid, gate, E, cap)

    def experts():
        h = F.silu(torch.bmm(xbuf, p["w_gate"])) * torch.bmm(xbuf, p["w_up"])
        return torch.bmm(h, p["w_down"])

    ybuf = experts()
    iters = 20 if T > LM_BATCH else 50
    bound, by = moe_bound(cfg, T, cap)
    out = {"ms": time_ms(torch, lambda: M.moe_apply(p, x, cfg), iters),
           "route_ms": time_ms(torch, lambda: route_fn(p, x2d, k), iters),
           "dispatch_ms": time_ms(torch, lambda: M._local_dispatch(
               x2d, eid, gate, E, cap), iters),
           "experts_ms": time_ms(torch, experts, iters),
           "combine_ms": time_ms(torch, lambda: M._local_combine(ybuf, meta, T), iters),
           "bound_ms": bound, "bound_by": by}
    out["roofline_share"] = bound / out["ms"]
    return out


def serving_with_peak(torch, lm, Server, cfg, rng, device, phase: str,
                      srv=None, **extra) -> dict:
    """bf16 ``Server.generate`` as phase 14 (c) times it (on ``srv`` where
    given), with the peak card memory, emitted as ``phase`` (phase 16 (b) /
    (d) at the serving cut, phase 21 at full depth)."""
    torch.cuda.reset_peak_memory_stats()
    row = lm_serving_times(torch, lm, Server, cfg, rng, device, srv=srv)
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
          "n_params": cfg.n_params, "peak_allocated_bytes": peak, **extra})
    gc.collect()
    torch.cuda.empty_cache()
    return dict(row, n_layers=cfg.n_layers, peak_allocated_bytes=peak)


def moe_f32_checks(torch, lm, Server, cfg, rng, device) -> dict:
    """(c) / (d) f32 at the 2-layer cut, capacity factor 8 (exactness needs
    no drops: tests/test_archs.py widens it too): phase 14 (a)'s checks."""
    cfg = dataclasses.replace(moe_cut(cfg, MOE_CHECK_LAYERS), moe_capacity_factor=8.0)
    srv = Server(cfg, LM_MAX_LEN, device=device, dtype=torch.float32)
    res = lm_generate_checks(torch, lm, srv, cfg, rng, device, f"moe {cfg.name} f32")
    emit({"phase": "moe_f32", **res, "n_params": cfg.n_params, "ok": True})
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return res


def mla_chunked_check(torch, A, cfg, rng, device) -> dict:
    """(d) One MLA layer at full width, f32, B=1, S=4,096: the query-chunked
    path (4 chunks of 1,024) against the unchunked one, within 1e-3."""
    gen = torch.Generator(device=device).manual_seed(161)
    p = A.mla_init(gen, cfg, torch.float32)
    x = torch.from_numpy(rng.standard_normal((1, LM_LONG, cfg.d_model))
                         .astype(np.float32)).to(device)
    calls, real = [], A._mla_chunk
    A._mla_chunk = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    with torch.no_grad():
        try:
            t0 = time.perf_counter()
            chunked, _ = A.mla_apply(p, x, cfg)
            torch.cuda.synchronize()
            chunked_s = time.perf_counter() - t0
        finally:
            A._mla_chunk = real
        check(len(calls) == LM_LONG // A.Q_CHUNK,
              f"mla: {len(calls)} chunks, not {LM_LONG // A.Q_CHUNK}")
        threshold = A.CHUNKED_ATTN_THRESHOLD
        A.CHUNKED_ATTN_THRESHOLD = LM_LONG + 1
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            unchunked, _ = A.mla_apply(p, x, cfg)
            torch.cuda.synchronize()
            unchunked_s = time.perf_counter() - t0
        finally:
            A.CHUNKED_ATTN_THRESHOLD = threshold
    err = max_err(torch, chunked, unchunked)
    check(torch.allclose(chunked, unchunked, rtol=MLA_TOL, atol=MLA_TOL),
          f"mla: chunked vs unchunked at S={LM_LONG}: {err}")
    row = {"phase": "mla_chunked", "S": LM_LONG, "chunks": len(calls),
           "max_abs_err": err, "chunked_s": chunked_s, "unchunked_s": unchunked_s,
           "unchunked_peak_bytes": torch.cuda.max_memory_allocated(), "ok": True}
    emit(row)
    return row


def moe_sparse_checks(torch, lm, instrument, Server, cfg, rng, device) -> tuple:
    """(e) deepseek-v3 with ``ffn_density=0.5`` in (8, 128) blocks: at the
    4-layer bf16 cut the 9 prefix projections against their plain version
    and the launches of one generate (9 a step); at the 2-layer f32 cut
    phase 14 (b)'s oracle checks (the 9 held the kernel at its shapes).
    Returns (launches, worst error, rows)."""
    cfg4 = dataclasses.replace(moe_cut(cfg, MOE_SERVE_LAYERS[cfg.name]),
                               ffn_density=0.5)
    srv = Server(cfg4, LM_MAX_LEN, device=device)
    worst = lm_projection_kernels(torch, srv.params, cfg4, rng, device)
    per_step = len(lm_projections(srv.params, cfg4))
    check(per_step == 3 * len(cfg4.prefix_pattern),
          f"moe sparse: {per_step} sparse projections")
    prompts = rng.integers(0, cfg4.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    torch.cuda.synchronize()
    instrument.reset()
    out = srv.generate(prompts, LM_GEN)
    launches = instrument.snapshot()
    check(launches.get("bcoo", 0) == per_step * LM_GEN
          and launches.get("bcoo.spmm", 0) == per_step * LM_GEN,
          f"moe sparse: {launches} block-kernel launches, not {per_step * LM_GEN}")
    check(((0 <= out) & (out < cfg4.vocab)).all(), "moe sparse: token out of range")
    emit({"phase": "moe_sparse_generate", "arch": cfg4.name, "n_layers": cfg4.n_layers,
          "dtype": "bfloat16", "n_params": cfg4.n_params, "per_step": per_step,
          "launches_per_generate": launches})
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    # capacity factor 8: the teacher-forced pass (T = 636) then drops no
    # assignment that the decode steps (T = 4) kept
    cfg2 = dataclasses.replace(moe_cut(cfg, MOE_CHECK_LAYERS), ffn_density=0.5,
                               moe_capacity_factor=8.0)
    lm_sparse_checks(torch, lm, instrument, Server, cfg2, rng, device, kernels=False)
    gc.collect()
    torch.cuda.empty_cache()
    proj = lm_projection_times(torch, cfg4, rng, device)
    return launches.get("bcoo", 0), worst, proj


def phase_moe(torch, rng, device) -> dict:
    """Phase 16: the MoE family at full width (see the module docstring).
    Returns the block kernel's launches in one sparse deepseek generate
    (the path's count), the largest random-input kernel error and the
    rows."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import instrument
    from repro_torch.launch.serve import Server
    from repro_torch.models import attention as A
    from repro_torch.models import lm
    from repro_torch.models import moe as M

    t_phase = time.perf_counter()
    layers = []
    for name in MOE_ARCHS:
        layers += moe_layer_checks(torch, M, name, rng, device)
        gc.collect()
        torch.cuda.empty_cache()
    mixtral, deepseek = (get_config(name) for name in MOE_ARCHS)
    serving = [serving_with_peak(torch, lm, Server, moe_cut(mixtral, MOE_SERVE_LAYERS[
        mixtral.name]), rng, device, "moe_serving")]
    f32 = [moe_f32_checks(torch, lm, Server, mixtral, rng, device)]
    serving.append(serving_with_peak(torch, lm, Server, moe_cut(
        deepseek, MOE_SERVE_LAYERS[deepseek.name]), rng, device, "moe_serving"))
    f32.append(moe_f32_checks(torch, lm, Server, deepseek, rng, device))
    mla = mla_chunked_check(torch, A, deepseek, rng, device)
    gc.collect()
    torch.cuda.empty_cache()
    launches, worst, proj = moe_sparse_checks(torch, lm, instrument, Server, deepseek,
                                              rng, device)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "moe_done", "seconds": seconds, "launches": launches})
    return {"launches": launches, "max_abs_err": worst, "layers": layers,
            "serving": serving, "f32": f32, "mla": mla, "projections": proj,
            "seconds": seconds}


# ------------------------------------------------------------- phase 17

LA_ARCHS = ("zamba2-2.7b", "xlstm-1.3b")
# (a): kind, arch, linear_attn name, inputs.  sLSTM's two paths compute its
# input GEMM at M = B*S and at M = B, which round differently, and its
# recurrence carries the difference (2.3e-4 at S = 1,024 on an H100 80GB
# HBM3): the cell is checked on integer-valued x and input weights (every
# sum exact in f32, whatever the GEMM's order), the random case reported
# with the GEMM's own row difference.  The reference's two paths are
# bit-equal on the CPU, where XLA's dot rounds a row alike at any M
# (tests/test_torch_linear_attn.py).
LA_CASES = (("mamba", "zamba2-2.7b", "mamba2", "random"),
            ("mlstm", "xlstm-1.3b", "mlstm", "random"),
            ("slstm", "xlstm-1.3b", "slstm", "integer"),
            ("slstm", "xlstm-1.3b", "slstm", "random"))
LA_LAYER_SHAPE = (2, 1024)  # (a): B, S; four chunks of 256
LA_STEP_TOL = 1e-4  # (a): f32 chunked vs stepped, outputs and final states
LA_CHUNK = 256  # mamba2_apply / mlstm_apply's default chunk
LA_LONG = 4096  # (f): one B=1 prefill, 16 chunks


def free_card(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def la_layer_checks(torch, LA, rng, device) -> list:
    """(a) One full-width layer of each kind in f32: ``*_apply`` (chunked;
    sLSTM's per-token loop) against ``*_decode`` stepped S times from the
    zero state, the outputs and every leaf of the final state (sLSTM on
    random inputs reported, not checked: see ``LA_CASES``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import init_cache

    B, S = LA_LAYER_SHAPE
    rows = []
    for kind, arch, name, data in LA_CASES:
        cfg = get_config(arch)
        gen = torch.Generator(device=device).manual_seed(17)
        p = getattr(LA, f"{name}_init")(gen, cfg, torch.float32)
        apply, decode = getattr(LA, f"{name}_apply"), getattr(LA, f"{name}_decode")
        if data == "integer":  # x in {-2..2}, w_in in {±1, ±2} / 64
            x = rng.integers(-2, 3, (B, S, cfg.d_model)).astype(np.float32)
            w = rng.choice(PM12, tuple(p["w_in"]["w"].shape)) / 64
            p["w_in"]["w"] = torch.from_numpy(w.astype(np.float32)).to(device)
        else:
            x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        x = torch.from_numpy(x).to(device)
        checked = not (kind == "slstm" and data == "random")
        what = f"linear attn {kind} {data} B={B} S={S}"
        with torch.no_grad():
            y, state = apply(p, x, cfg)
            st = init_cache(cfg, kind, B, S, device=device)
            ys = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(S):
                yi, st = decode(p, x[:, i:i + 1], st, cfg)
                ys.append(yi)
            torch.cuda.synchronize()
            decode_ms = (time.perf_counter() - t0) * 1e3 / S
            stepped = torch.cat(ys, dim=1)
            apply_ms = time_ms(torch, lambda: apply(p, x, cfg), 3, warmup=1)
        errs = {"y": max_err(torch, y, stepped)}
        check(not checked or torch.allclose(y, stepped, rtol=LA_STEP_TOL,
                                            atol=LA_STEP_TOL),
              f"{what}: chunked vs stepped outputs: {errs}")
        for field, a, b in zip(state._fields, state, st):
            errs[field] = max_err(torch, a, b)
            check(not checked or torch.allclose(a, b, rtol=LA_STEP_TOL,
                                                atol=LA_STEP_TOL),
                  f"{what}: chunked vs stepped final {field}: {errs}")
        if not checked:  # the input GEMM at M = B*S against M = B, row by row
            with torch.no_grad():
                rows_ = torch.cat([LA.dense_apply(p["w_in"], x[:, t:t + 1])
                                   for t in range(S)], 1)
                errs["pre_gemm"] = max_err(torch, rows_, LA.dense_apply(p["w_in"], x))
            del rows_
        row = {"phase": "la_layer", "kind": kind, "arch": arch, "dtype": "float32",
               "inputs": data, "checked": checked, "B": B, "S": S,
               "chunks": None if kind == "slstm" else S // min(LA_CHUNK, S),
               "max_abs_err": errs, "tolerance": LA_STEP_TOL,
               "y_scale": float(stepped.abs().max()),
               "bit_equal": bool(torch.equal(y, stepped) and all(
                   torch.equal(a, b) for a, b in zip(state, st))),
               "apply_ms": apply_ms, "decode_host_ms_per_token": decode_ms,
               "ok": True}
        emit(row)
        rows.append(row)
        del p, x, y, state, st, ys, stepped
        free_card(torch)
    return rows


def la_serving(torch, lm, LA, Server, cfg, rng, device) -> dict:
    """(b) / (c) bf16 at full depth, as phase 14 (c) times it, with the
    peak card memory; for an arch with sLSTM blocks the share of prefill
    their per-token loops take (one layer's ``slstm_apply`` at the prefill
    shape, times the sLSTM layers, over the prefill ms)."""
    torch.cuda.reset_peak_memory_stats()
    row = lm_serving_times(torch, lm, Server, cfg, rng, device)
    out = dict(row, n_layers=cfg.n_layers, n_params=cfg.n_params,
               peak_allocated_bytes=torch.cuda.max_memory_allocated())
    free_card(torch)
    n_slstm = cfg.n_repeats * cfg.block_pattern.count("slstm")
    if n_slstm:
        gen = torch.Generator(device=device).manual_seed(172)
        p = LA.slstm_init(gen, cfg)
        x = torch.from_numpy(rng.standard_normal((LM_BATCH, LM_PROMPT, cfg.d_model))
                             .astype(np.float32)).to(device, torch.bfloat16)
        with torch.no_grad():
            one = time_ms(torch, lambda: LA.slstm_apply(p, x, cfg), 5, warmup=1)
        out.update(slstm_layers=n_slstm, slstm_layer_prefill_ms=one,
                   slstm_share_of_prefill=one * n_slstm / row["prefill_ms"])
        del p, x
    emit({"phase": "la_serving", "arch": cfg.name, "n_layers": cfg.n_layers,
          "n_params": cfg.n_params,
          "peak_allocated_bytes": out["peak_allocated_bytes"],
          **{k: v for k, v in out.items() if k.startswith("slstm")}})
    free_card(torch)
    return out


def la_f32_checks(torch, lm, Server, cfg, rng, device) -> dict:
    """(d) f32 at full depth: phase 14 (a)'s checks."""
    srv = Server(cfg, LM_MAX_LEN, device=device, dtype=torch.float32)
    res = lm_generate_checks(torch, lm, srv, cfg, rng, device, f"la {cfg.name} f32")
    emit({"phase": "la_f32", **res, "n_params": cfg.n_params, "ok": True})
    del srv
    free_card(torch)
    return res


def state_bytes(caches, attention: bool) -> int:
    """Bytes of the stacked attention caches (``attention``) or of the
    recurrent states."""
    total = 0
    for c in caches.blocks.values():
        if hasattr(c, "length") == attention:
            tensors = c[:-1] if attention else c
            total += sum(t.numel() * t.element_size() for t in tensors)
    return total


def la_long_prefill(torch, lm, Server, cfg, rng, device) -> dict:
    """(f) One bf16 prefill at B=1, S=4,096: 16 chunks of 256 in every
    Mamba2 layer, the shared block's attention query-chunked; ms, peak
    memory, and the caches it leaves (O(1) states, 9 growing KV caches)."""
    srv = Server(cfg, LA_LONG, device=device)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, LA_LONG))
                            .astype(np.int32)).to(device)
    params_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits, caches = lm.prefill(srv.params, toks, cfg, LA_LONG)
        check(bool(torch.isfinite(logits).all()) and logits.shape == (1, cfg.vocab),
              f"la long prefill: logits {tuple(logits.shape)} not finite")
        peak = torch.cuda.max_memory_allocated()
        kv, states = state_bytes(caches, True), state_bytes(caches, False)
        del caches
        ms = time_ms(torch, lambda: lm.prefill(srv.params, toks, cfg, LA_LONG), 3,
                     warmup=1)
    row = {"phase": "la_long_prefill", "arch": cfg.name, "dtype": "bfloat16",
           "B": 1, "S": LA_LONG, "chunks": LA_LONG // LA_CHUNK, "ms": ms,
           "tokens_per_s": LA_LONG / ms * 1e3, "params_bytes": params_bytes,
           "peak_allocated_bytes": peak, "kv_cache_bytes": kv,
           "recurrent_state_bytes": states, "ok": True}
    emit(row)
    del srv
    free_card(torch)
    return row


def phase_linear_attn(torch, rng, device) -> dict:
    """Phase 17: linear attention at full width and full depth (see the
    module docstring).  Returns the block kernel's launches in one sparse
    zamba2 generate (the path's count), the largest random-input kernel
    error and the rows."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import instrument
    from repro_torch.launch.serve import Server
    from repro_torch.models import linear_attn as LA
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    zamba2, xlstm = (get_config(name) for name in LA_ARCHS)
    sparse = dataclasses.replace(zamba2, ffn_density=0.5)
    check(zamba2.n_params == 3_145_113_600 and xlstm.n_params == 1_310_982_144
          and sparse.n_params == 3_105_792_000,
          f"la: parameter counts {zamba2.n_params} / {xlstm.n_params} / "
          f"{sparse.n_params}")
    layers = la_layer_checks(torch, LA, rng, device)
    serving = [la_serving(torch, lm, LA, Server, cfg, rng, device)
               for cfg in (zamba2, xlstm)]
    f32 = [la_f32_checks(torch, lm, Server, cfg, rng, device) for cfg in (zamba2, xlstm)]
    launches, worst = lm_sparse_checks(torch, lm, instrument, Server, sparse, rng,
                                       device, f32=True)
    want = 3 * zamba2.n_repeats * LM_GEN
    check(launches == want, f"la sparse: {launches} block-kernel launches, not {want}")
    free_card(torch)
    proj = lm_projection_times(torch, sparse, rng, device)
    free_card(torch)
    long = la_long_prefill(torch, lm, Server, zamba2, rng, device)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "linear_attn_done", "seconds": seconds, "launches": launches})
    return {"launches": launches, "max_abs_err": worst, "layers": layers,
            "serving": serving, "f32": f32, "projections": proj, "long": long,
            "seconds": seconds}


# ------------------------------------------------------------- phase 18: enc-dec

ED_ARCH = "seamless-m4t-medium"
ED_PARAMS, ED_SPARSE_PARAMS = 715_339_776, 564_344_832  # its cfg.n_params
ED_ENC = 1024  # (b), (c): S_enc, the frames of each request
ED_LONG = 4096  # (e): a B=1 encode on the query-chunked non-causal path
ED_MAX_LEN = 32768  # (b): prefill_32k's seq_len, the B=1 step's caches


def ed_uncounted(cfg) -> int:
    """Float params that ``cfg.n_params`` leaves out: the encoder's
    ``in_proj`` and every norm (final, encoder, two an encoder layer, three
    a decoder layer)."""
    d = cfg.d_model
    return d * d + d * (2 + 2 * cfg.encoder_layers + 3 * cfg.n_layers)


def ed_inputs(torch, rng, cfg, batch: int, s_enc: int, device, dtype):
    """(prompts (batch, LM_PROMPT) int32, frames (batch, s_enc, d) in
    ``dtype``) on ``device``: the text prompt and its stub frame
    embeddings."""
    prompts = rng.integers(0, cfg.vocab, (batch, LM_PROMPT)).astype(np.int32)
    frames = rng.standard_normal((batch, s_enc, cfg.d_model)).astype(np.float32)
    return (torch.from_numpy(prompts).to(device),
            torch.from_numpy(frames).to(device, dtype))


def ed_generate(torch, lm, steps, params, cfg, prompts, frames):
    """Greedy generation of LM_GEN tokens as an enc-dec server runs it:
    ``lm.encode`` once, ``lm.prefill(memory=)`` into LM_MAX_LEN caches,
    then LM_GEN - 1 calls of ``steps.make_decode_step``'s function.
    Returns (tokens (B, LM_GEN) int32 on the device, memory)."""
    decode = steps.make_decode_step(cfg, "decode_32k")
    with torch.no_grad():
        memory = lm.encode(params, frames, cfg)
        logits, caches = lm.prefill(params, prompts, cfg, LM_MAX_LEN, memory=memory)
        toks = [torch.argmax(logits, -1)[:, None].to(torch.int32)]
        for _ in range(1, LM_GEN):
            logits, caches = decode(params, {"token": toks[-1], "caches": caches,
                                             "memory": memory})
            toks.append(torch.argmax(logits, -1)[:, None].to(torch.int32))
    return torch.cat(toks, dim=1), memory


def ed_params(torch, lm, cfg, seed: int, device, dtype=None):
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        return (lm.init_params(gen, cfg) if dtype is None
                else lm.init_params(gen, cfg, dtype))


def ed_f32_checks(torch, lm, steps, cfg, rng, device) -> dict:
    """(a) Dense seamless at full width and depth in f32 (TF32 off): the
    tree's size, a generate, decode(prefill(S)) within 5e-3 of
    prefill(S+1) with the same memory (tests/test_archs.py's bound), and a
    teacher-forced argmax equal to the tokens wherever its top-2 margin
    exceeds 1e-3."""
    from repro_torch.tree import leaves

    params = ed_params(torch, lm, cfg, 18, device, torch.float32)
    numel = sum(a.numel() for a in leaves(params) if a.is_floating_point())
    check(numel == cfg.n_params + ed_uncounted(cfg),
          f"ed f32: {numel} float params, not n_params + {ed_uncounted(cfg)}")
    prompts, frames = ed_inputs(torch, rng, cfg, LM_BATCH, ED_ENC, device,
                                torch.float32)
    t0 = time.perf_counter()
    out, memory = ed_generate(torch, lm, steps, params, cfg, prompts, frames)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(tuple(out.shape) == (LM_BATCH, LM_GEN) and bool(
        ((0 <= out) & (out < cfg.vocab)).all()), f"ed f32: generate gave {out.shape}")
    check(memory.dtype == torch.float32
          and tuple(memory.shape) == (LM_BATCH, ED_ENC, cfg.d_model),
          f"ed f32: memory {memory.dtype}{tuple(memory.shape)}")
    with torch.no_grad():
        _, caches = lm.prefill(params, prompts, cfg, LM_MAX_LEN, memory=memory)
        got, _ = lm.decode_step(params, out[:, :1], caches, cfg, memory=memory)
        want, _ = lm.prefill(params, torch.cat([prompts, out[:, :1]], 1), cfg,
                             LM_MAX_LEN, memory=memory)
        step_err = max_err(torch, got, want)
        check(torch.allclose(got, want, rtol=5e-3, atol=5e-3),
              f"ed f32: decode(prefill(S)) vs prefill(S+1): {step_err}")
        tf = teacher_forced(torch, lm, params, cfg, prompts, out, memory)
        agree = greedy_agreement(torch, tf, out, 1e-3)
        check(agree["agree"] == agree["checked"],
              f"ed f32: teacher-forced argmax disagrees: {agree}")
    row = {"phase": "ed_f32", "arch": cfg.name, "n_layers": cfg.n_layers,
           "encoder_layers": cfg.encoder_layers, "dtype": "float32",
           "n_params": cfg.n_params, "float_params": numel, "s_enc": ED_ENC,
           "generate_shape": list(out.shape), "generate_s": gen_s,
           "decode_vs_prefill_max_err": step_err, "teacher_forced": agree,
           "ok": True}
    emit(row)
    return row


def ed_serving(torch, lm, steps, cfg, rng, device) -> tuple:
    """(b) bf16 at full width and depth, B=4 with bf16 frames of 1,024:
    encode, prefill and decode ms (CUDA events; the cross-attention's K/V
    projections of the memory timed apart), a decode step's device trace,
    tokens/s of a generate (host clock, ending in a copy to the host) and
    the peak memory; at B=1 ``make_prefill_step(cfg, "prefill_32k")`` bit
    for bit ``lm.prefill(memory=lm.encode(frames))`` at max_len 32,768.
    Returns (row, the params, kept for (e))."""
    from repro_torch.models.common import dense_apply, map_params

    torch.cuda.reset_peak_memory_stats()
    params = ed_params(torch, lm, cfg, 181, device)
    prompts, frames = ed_inputs(torch, rng, cfg, LM_BATCH, ED_ENC, device,
                                torch.bfloat16)
    decode = steps.make_decode_step(cfg, "decode_32k")
    with torch.no_grad():
        memory = lm.encode(params, frames, cfg)
        check(memory.dtype == torch.bfloat16, f"ed serving: memory {memory.dtype}")
        _, caches = lm.prefill(params, prompts, cfg, LM_MAX_LEN, memory=memory)
        batch = {"token": prompts[:, -1:], "caches": caches, "memory": memory}
        encode_ms = time_ms(torch, lambda: lm.encode(params, frames, cfg), 10)
        prefill_ms = time_ms(torch, lambda: lm.prefill(
            params, prompts, cfg, LM_MAX_LEN, memory=memory), 10)
        # the same slot rewritten each call: the caches are not advanced
        decode_ms = time_ms(torch, lambda: decode(params, batch), 20)
        x0 = map_params(lambda a: a[0], params["blocks"]["b0"]["xattn"])
        cross_kv_ms = time_ms(torch, lambda: (dense_apply(x0["wk"], memory),
                                              dense_apply(x0["wv"], memory)), 20)
        trace = device_trace(torch, lambda: decode(params, batch))
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out, _ = ed_generate(torch, lm, steps, params, cfg, prompts, frames)
        out.cpu()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    peak = torch.cuda.max_memory_allocated()
    del caches, batch, memory
    p1, f1 = ed_inputs(torch, rng, cfg, 1, ED_ENC, device, torch.bfloat16)
    with torch.no_grad():
        got, gcaches = steps.make_prefill_step(cfg, "prefill_32k")(
            params, {"tokens": p1, "frames": f1})
        cache_bytes = sum(t.numel() * t.element_size()
                          for c in gcaches.blocks.values() for t in c[:-1])
        del gcaches
        want, _ = lm.prefill(params, p1, cfg, ED_MAX_LEN,
                             memory=lm.encode(params, f1, cfg))
    check(torch.equal(got, want),
          f"ed serving: make_prefill_step vs encode + prefill: {max_err(torch, got, want)}")
    n_cross = cfg.n_repeats
    row = {"phase": "ed_serving", "arch": cfg.name, "dtype": "bfloat16",
           "n_layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
           "batch": LM_BATCH, "s_enc": ED_ENC, "prompt": LM_PROMPT, "gen": LM_GEN,
           "encode_ms": encode_ms, "prefill_ms": prefill_ms,
           "decode_ms_per_token": decode_ms,
           "cross_kv_ms_per_layer": cross_kv_ms,
           "cross_kv_share_of_decode": cross_kv_ms * n_cross / decode_ms,
           "generate_s": wall, "generate_s_all": walls,
           "tokens_per_s": LM_BATCH * LM_GEN / wall, "decode_trace": trace,
           "peak_allocated_bytes": peak, "prefill_step_bit_equal": True,
           "prefill_step_max_len": ED_MAX_LEN, "prefill_step_cache_bytes": cache_bytes}
    emit(row)
    return row, params


def ed_long_encode(torch, lm, A, params, cfg, rng, device) -> dict:
    """(e) One bf16 encode at B=1, S_enc=4,096 (every encoder layer
    query-chunked and non-causal) and a 128-token prefill over its
    memory: ms and peak memory."""
    prompts, frames = ed_inputs(torch, rng, cfg, 1, ED_LONG, device, torch.bfloat16)
    calls, real = [], A._sdpa_qchunked
    A._sdpa_qchunked = lambda *a, **kw: calls.append(kw["causal"]) or real(*a, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with torch.no_grad():
            memory = lm.encode(params, frames, cfg)
            logits, _ = lm.prefill(params, prompts, cfg, LM_MAX_LEN, memory=memory)
    finally:
        A._sdpa_qchunked = real
    peak = torch.cuda.max_memory_allocated()
    check(calls == [False] * cfg.encoder_layers,
          f"ed long: chunked attention calls {calls}, not {cfg.encoder_layers} "
          f"non-causal")
    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (1, cfg.vocab),
          f"ed long: logits {tuple(logits.shape)} not finite")
    with torch.no_grad():
        encode_ms = time_ms(torch, lambda: lm.encode(params, frames, cfg), 3, warmup=1)
        prefill_ms = time_ms(torch, lambda: lm.prefill(
            params, prompts, cfg, LM_MAX_LEN, memory=memory), 5, warmup=1)
    row = {"phase": "ed_long_encode", "arch": cfg.name, "dtype": "bfloat16",
           "B": 1, "s_enc": ED_LONG, "chunked_calls": len(calls),
           "encode_ms": encode_ms, "prefill_ms": prefill_ms, "prompt": LM_PROMPT,
           "frames_per_s": ED_LONG / encode_ms * 1e3,
           "peak_allocated_bytes": peak, "ok": True}
    emit(row)
    return row


def ed_sparse_checks(torch, lm, steps, instrument, cfg, rng, device) -> tuple:
    """(c) Block-sparse seamless at full width and depth in f32: each of
    the 72 projections against its plain version (as phase 14 (b)), the
    block kernel's launches of one generate (every encoder projection
    once, every decoder projection at the prefill and at each decode
    step), and the model (encode, prefill, 3 decode steps, a
    teacher-forced forward) against its densified torch.matmul oracle.
    Returns (launches, the largest random-input kernel error, row)."""
    params = ed_params(torch, lm, cfg, 182, device, torch.float32)
    projections = lm_projections(params, cfg)
    check(len(projections) == 3 * (cfg.encoder_layers + cfg.n_layers),
          f"ed sparse: {len(projections)} sparse projections")
    worst = lm_projection_kernels(torch, params, cfg, rng, device, f32=True)
    per_step = lm_launches_per_step(params, cfg)
    want_launches = 3 * cfg.encoder_layers + per_step * LM_GEN
    prompts, frames = ed_inputs(torch, rng, cfg, LM_BATCH, ED_ENC, device,
                                torch.float32)
    torch.cuda.synchronize()
    instrument.reset()
    out, memory = ed_generate(torch, lm, steps, params, cfg, prompts, frames)
    torch.cuda.synchronize()
    launches = instrument.snapshot()
    check(launches.get("bcoo", 0) == want_launches,
          f"ed sparse: {launches} block-kernel launches, not {want_launches}")
    check(launches.get("bcoo.spmm", 0) == want_launches,
          f"ed sparse: every projection is an SpMM (B >= 4): {launches}")
    dense_cfg = dataclasses.replace(cfg, ffn_density=1.0)
    oracle = densified_params(torch, params, cfg)
    tol = dict(rtol=LM_LOGIT_TOL, atol=LM_LOGIT_TOL)
    with torch.no_grad():
        omem = lm.encode(oracle, frames, dense_cfg)
        errs = {"encode": max_err(torch, memory, omem)}
        check(torch.allclose(memory, omem, **tol),
              f"ed sparse: memory vs densified oracle: {errs}")
        instrument.reset()
        got, caches = lm.prefill(params, prompts, cfg, LM_MAX_LEN, memory=memory)
        want, ocaches = lm.prefill(oracle, prompts, dense_cfg, LM_MAX_LEN, memory=omem)
        errs["prefill"] = max_err(torch, got, want)
        check(torch.allclose(got, want, **tol),
              f"ed sparse: prefill logits vs densified oracle: {errs}")
        for step in range(3):
            tok = out[:, step:step + 1]
            got, caches = lm.decode_step(params, tok, caches, cfg, memory=memory)
            want, ocaches = lm.decode_step(oracle, tok, ocaches, dense_cfg, memory=omem)
            errs[f"decode{step}"] = max_err(torch, got, want)
            check(torch.allclose(got, want, **tol),
                  f"ed sparse: decode step {step} vs densified oracle: {errs}")
        check(instrument.launches("bcoo") == per_step * 4,
              f"ed sparse: oracle comparison launches {instrument.snapshot()}")
        tf_sparse = teacher_forced(torch, lm, params, cfg, prompts, out, memory)
        tf_oracle = teacher_forced(torch, lm, oracle, dense_cfg, prompts, out, omem)
        errs["teacher_forced"] = max_err(torch, tf_sparse, tf_oracle)
        check(torch.allclose(tf_sparse, tf_oracle, **tol),
              f"ed sparse: teacher-forced logits vs oracle: {errs}")
        # the oracle's greedy choice wherever its top-2 margin exceeds twice
        # the logit error just measured
        agree = greedy_agreement(torch, tf_oracle, out, 2 * errs["teacher_forced"])
        check(agree["agree"] == agree["checked"],
              f"ed sparse: tokens differ from the oracle's greedy ones: {agree}")
    row = {"phase": "ed_sparse", "arch": cfg.name, "dtype": "float32",
           "ffn_density": cfg.ffn_density, "block": list(cfg.sparse_block),
           "blocks_per_projection": int(projections[0][4]["bvalues"].shape[0]),
           "n_params": cfg.n_params, "projections": len(projections),
           "launches_per_generate": launches, "want_launches": want_launches,
           "oracle_max_abs_err": errs, "tolerance": LM_LOGIT_TOL,
           "greedy_vs_oracle": agree, "ok": True}
    emit(row)
    return launches.get("bcoo", 0), worst, row


def ed_training(torch, lm, steps, instrument, cfg, device) -> dict:
    """(d) ``steps.make_train_step`` at full width and depth, bf16 params,
    phase 15's AdamW (peak 1e-3, 3 warm-up steps) and shape (B=4, S=256):
    dense and block-sparse, SPARSE_STEPS steps each on ``TokenStream``
    batches with bf16 frames (4, 256, 1,024), as ``input_specs`` gives
    them.  A sparse step launches the block kernel twice a projection in
    the encoder (forward, grad x; the reference does not rematerialize
    it) and three times in the decoder (forward, recompute, grad x)."""
    from repro_torch.data.tokens import TokenStream
    from repro_torch.optim import AdamWConfig, init_opt
    from repro_torch.sparse.layers import strip_derived

    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=3, total_steps=SPARSE_STEPS)
    stream = TokenStream(cfg.vocab, SPARSE_S, SPARSE_B, seed=18)
    out = {}
    for label, c in (("dense", cfg), ("sparse", dataclasses.replace(cfg,
                                                                   ffn_density=0.5))):
        params = ed_params(torch, lm, c, 183, device)
        opt = init_opt(strip_derived(params), opt_cfg)
        step = steps.make_train_step(c, opt_cfg)
        fgen = torch.Generator(device=device).manual_seed(184)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, step_launches = [], [], []
        for i in range(SPARSE_STEPS):
            batch = dict(stream.batch(i, device))
            batch["frames"] = torch.randn((SPARSE_B, SPARSE_S, c.d_model), generator=fgen,
                                          device=device).to(torch.bfloat16)
            torch.cuda.synchronize()
            instrument.reset()
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            step_launches.append(instrument.launches("bcoo"))
        want = (2 * 3 * c.encoder_layers + 3 * 3 * c.n_layers
                if label == "sparse" else 0)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"ed train {label}: losses {losses}")
        check(all(n == want for n in step_launches),
              f"ed train {label}: block-kernel launches a step {step_launches}, "
              f"not {want}")
        med = statistics.median(step_ms[1:])
        out[label] = {"phase": "ed_train", "arch": c.name, "variant": label,
                      "dtype": "bfloat16", "ffn_density": c.ffn_density,
                      "n_params": c.n_params, "batch": SPARSE_B, "seq": SPARSE_S,
                      "frames": [SPARSE_B, SPARSE_S, c.d_model], "losses": losses,
                      "step_ms": step_ms, "step_ms_median": med,
                      "tokens_per_s": SPARSE_B * SPARSE_S / med * 1e3,
                      "launches_per_step": step_launches, "want_launches": want,
                      "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
        del params, opt, step
        free_card(torch)
    out["sparse"]["step_ms_ratio_sparse_to_dense"] = (
        out["sparse"]["step_ms_median"] / out["dense"]["step_ms_median"])
    for row in out.values():
        emit(row)
    return out


def phase_enc_dec(torch, rng, device) -> dict:
    """Phase 18: the encoder-decoder (see the module docstring).  Returns
    the block kernel's launches in one sparse generate (the path's count),
    the largest random-input kernel error and the rows."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import instrument
    from repro_torch.launch import steps
    from repro_torch.models import attention as A
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    cfg = get_config(ED_ARCH)
    sparse = dataclasses.replace(cfg, ffn_density=0.5)
    check(cfg.n_params == ED_PARAMS and sparse.n_params == ED_SPARSE_PARAMS,
          f"ed: parameter counts {cfg.n_params} / {sparse.n_params}")
    card_cpu = train_card_vs_cpu(
        torch, dataclasses.replace(cfg.reduced(), ffn_density=0.5, sparse_block=(8, 16)),
        rng, device, phase="ed_card_vs_cpu")
    free_card(torch)
    launches, worst, sparse_row = ed_sparse_checks(torch, lm, steps, instrument,
                                                   sparse, rng, device)
    free_card(torch)
    f32 = ed_f32_checks(torch, lm, steps, cfg, rng, device)
    free_card(torch)
    serving, params = ed_serving(torch, lm, steps, cfg, rng, device)
    long = ed_long_encode(torch, lm, A, params, cfg, rng, device)
    del params
    free_card(torch)
    train = ed_training(torch, lm, steps, instrument, cfg, device)
    proj = lm_projection_times(torch, sparse, rng, device,
                               batches=(1, LM_BATCH, LM_BATCH * ED_ENC))
    free_card(torch)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "enc_dec_done", "seconds": seconds, "launches": launches})
    return {"launches": launches, "max_abs_err": worst, "card_vs_cpu": card_cpu,
            "sparse": sparse_row, "f32": f32, "serving": serving, "long": long,
            "train": train, "projections": proj, "seconds": seconds}


# ------------------------------------------------ phase 19: training the families

TF_ARCHS = ("mixtral-8x22b", "deepseek-v3-671b", "zamba2-2.7b", "xlstm-1.3b")
# layers kept (the rest full); zamba2 at 6 of 54 (1 of its 9 repeats) and
# xlstm at 8 of 48 (1 of 6) pay for phases 23 and 24 (at full depth their
# 10 + 3 and 10 steps took 21.3 s and 22.2 s on an H100 80GB HBM3, 700 W;
# 12 and 24 layers in PR 29)
TF_CUT = {"mixtral-8x22b": 1, "deepseek-v3-671b": 3, "zamba2-2.7b": 6,
          "xlstm-1.3b": 8}
TF_SPARSE = ("deepseek-v3-671b", "zamba2-2.7b")  # their dense FFNs on the block kernel
TF_STEPS, TF_BATCH, TF_SEQ = 10, 4, 256  # S = 256: one GLA chunk, 256 sLSTM steps
# xlstm's steps are host-bound on sLSTM's per-token loop (6.75 s a step at
# 4 x 256, 160k kernels, on an H100): its batches are 32 x 32, the same
# 1,024 tokens in an eighth of the loop's steps (16 x 64 before, cut for
# the script's time)
TF_SHAPE = {"xlstm-1.3b": (32, 32)}
# profiled steps a model: 3, or 1 where a step launches 15k-160k kernels
# (the trace's post-processing outweighs the steps)
TF_TRACED = {"zamba2-2.7b": 1, "xlstm-1.3b": 1}


def tf_shape(cfg) -> tuple:
    """(B, S) of ``cfg``'s training batches."""
    return TF_SHAPE.get(cfg.name, (TF_BATCH, TF_SEQ))
TF_SPARSE_STEPS = TF_MB_STEPS = 3  # the sparse runs; mixtral with 2 microbatches
TF_ROUTER_T = 512  # (a): deepseek's MoE layer alone, bf16
TF_BF16_GRAD_TOL = 2e-2  # bf16 MoE grads vs the f32 oracle, norm-wise
TF_RESTART_LAYERS = 8  # (b): xlstm at full width, one repeat (7 mLSTM + 1 sLSTM)


def tf_cfg(name, **changes):
    """``name`` at full width, cut to ``TF_CUT`` layers where the card
    forces it (deepseek at 3: its dense MLA prefix layers, no MoE repeat;
    the MTP block built and trained) or the script's time does (zamba2)."""
    from repro_torch.configs import get_config

    cfg = get_config(name)
    if name in TF_CUT:
        cfg = dataclasses.replace(cfg, n_layers=TF_CUT[name])
    return dataclasses.replace(cfg, **changes)


# deepseek's MLA + MTP stack diverged at 1e-3 * 960 / d_model = 1.34e-4
# (16.0 -> 20.6 in 10 steps; at 1e-3 16.0 -> 26.1 -> 146) and fell 16.0 ->
# 12.0 at 2e-5 (on an H100 80GB HBM3, 700 W)
TF_LR = {"deepseek-v3-671b": 2e-5}


def tf_opt(cfg, steps: int, int8: bool = False):
    """Phase 15's AdamW (3 warm-up steps) with its peak, 1e-3 at smollm's
    d_model 960, scaled by 960 / d_model (Adam moves every weight by about
    lr at once, so a d-wide product moves d times as far), or ``TF_LR``'s;
    ``int8`` moments as the reference's dryrun configures them for
    deepseek."""
    from repro_torch.optim import AdamWConfig

    lr = TF_LR.get(cfg.name, 1e-3 * 960 / cfg.d_model)
    return AdamWConfig(lr_peak=lr, warmup_steps=3, total_steps=steps,
                       quantized_m=int8, quantized_v=int8)


def tf_launches_per_step(cfg) -> int:
    """Block-kernel launches of one sparse train step: 3 projections a
    dense FFN, each run forward and grad x, and once more in the backward's
    recompute where the reference rematerializes (the scanned repeats, not
    the prefix, not the MTP block); zamba2's shared FFN once a repeat."""
    if cfg.ffn_density >= 1:
        return 0
    no_ffn = ("moe", "mla_moe", "mamba", "mlstm", "slstm")
    prefix = sum(k not in no_ffn for k in cfg.prefix_pattern) + cfg.mtp_depth
    repeated = cfg.n_repeats * sum(k not in no_ffn for k in cfg.block_pattern)
    return 3 * (2 * prefix + 3 * repeated)


def layer_value_and_grads(torch, apply, p, x, wy):
    """<y, wy> + 1e-3 times the sum of the returned states, the sum of its
    terms' magnitudes (its scale: the random weights cancel), and its grads
    with respect to every float leaf of ``p`` and to x."""
    from repro_torch.models.common import map_params
    from repro_torch.tree import leaves

    pl = map_params(lambda a: a.detach().requires_grad_()
                    if a.is_floating_point() else a, p)
    xl = x.detach().requires_grad_()
    y, states = apply(pl, xl)
    loss = (y.float() * wy).sum() + 1e-3 * sum(s.float().sum() for s in states)
    scale = float((y.detach().float() * wy).abs().sum()
                  + 1e-3 * sum(s.detach().float().abs().sum() for s in states))
    wrt = [a for a in leaves(pl) if a.requires_grad] + [xl]
    return loss.detach(), scale, torch.autograd.grad(loss, wrt, allow_unused=True)


def tf_layer_grads(torch, rng, device) -> list:
    """(a) One full-width layer of each kind, f32, forward and backward on
    the card against the CPU from the same params and inputs: deepseek's
    MLA and a Mamba2, an mLSTM and an sLSTM layer (B=1, S=256); the loss
    within 1e-5 of its terms' magnitudes, each grad leaf within 1e-4 of
    its max.  (mixtral's 2.4B-element MoE layer left this list to pay for
    phase 26: 11.7 s, most of it the layer's copy to the host and its
    backward there; the MoE backward stays held card against CPU at
    reduced width, and against ``jax.grad`` on the CPU.)"""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    from repro_torch.models import linear_attn as LA
    from repro_torch.models.common import map_params

    cases = (("mla", "deepseek-v3-671b", 1, 256), ("mamba2", "zamba2-2.7b", 1, 256),
             ("mlstm", "xlstm-1.3b", 1, 256), ("slstm", "xlstm-1.3b", 1, 256))
    rows = []
    for kind, arch, B, S in cases:
        cfg = get_config(arch)
        gen = torch.Generator(device=device).manual_seed(19)
        if kind == "mla":
            p = A.mla_init(gen, cfg, torch.float32)

            def apply(p, x, cfg=cfg):
                return A.mla_apply(p, x, cfg)[0], ()
        else:
            p = getattr(LA, f"{kind}_init")(gen, cfg, torch.float32)

            def apply(p, x, fn=getattr(LA, f"{kind}_apply"), cfg=cfg):
                y, state = fn(p, x, cfg)
                return y, tuple(state)
        x = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                             .astype(np.float32))
        wy = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                              .astype(np.float32))
        t0 = time.perf_counter()
        lg, _, gg = layer_value_and_grads(torch, apply, p, x.to(device),
                                          wy.to(device))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        p = map_params(lambda a: a.cpu(), p)
        t0 = time.perf_counter()
        lc, scale, gc_ = layer_value_and_grads(torch, apply, p, x, wy)
        cpu_s = time.perf_counter() - t0
        loss_rel = abs(float(lg) - float(lc)) / scale
        # leaf by leaf on the card, in f32
        grad_rel = max(float((a - b.to(device)).abs().max() / b.abs().max())
                       for a, b in zip(gg, gc_))
        what = f"train families {kind} layer ({arch})"
        check(loss_rel <= 1e-5, f"{what}: loss {float(lg)} vs {float(lc)}")
        check(grad_rel <= GRAD_TOL, f"{what}: grad rel err {grad_rel}")
        row = {"phase": "tf_layer", "kind": kind, "arch": arch, "dtype": "float32",
               "B": B, "S": S, "loss_err_over_scale": loss_rel, "grad_max_rel_err": grad_rel,
               "card_s": card_s, "cpu_s": cpu_s, "ok": True}
        emit(row)
        rows.append(row)
        del p, gg, gc_
        free_card(torch)
    return rows


def tf_router_check(torch, rng, device) -> dict:
    """(a) deepseek's MoE layer alone at full width in bf16 (256 experts of
    7168 x 2048, top-8, sigmoid affinities with a random bias, one shared
    expert), T = 512 at ample capacity (factor 8: nothing dropped),
    forward and backward against an f32 oracle built one routed expert at
    a time: the plain router's ids, gates from f32 affinities normalized
    over the selection, each expert's SwiGLU on its tokens and its
    backward, then the gates' backward into the router.  y within
    MOE_BF16_TOL and every grad within TF_BF16_GRAD_TOL of the oracle,
    norm-wise (bf16 rounds the products and the sums); grad x and the
    router's grad of a second backward bit-equal or not, reported."""
    from repro_torch.models import moe as M
    from repro_torch.models.common import map_params

    cfg = tf_cfg("deepseek-v3-671b", moe_capacity_factor=8.0)
    E, d, T, k = cfg.n_experts, cfg.d_model, TF_ROUTER_T, cfg.moe_top_k
    gen = torch.Generator(device=device).manual_seed(191)
    p = M.moe_init(gen, cfg, torch.bfloat16)
    p["router_bias"] = torch.randn(E, generator=gen, device=device) * 0.02
    x = torch.from_numpy(rng.standard_normal((LM_BATCH, T // LM_BATCH, d))
                         .astype(np.float32)).to(device, torch.bfloat16)
    wy = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32)).to(device)
    keys = ["x", "router", "w_gate", "w_up", "w_down"] + [
        f"shared.{n}" for n in ("w_gate", "w_up", "w_down")]

    def port(names=keys):  # y and the grads of ``names``
        pl = map_params(lambda a: a.detach().requires_grad_(), p)
        xl = x.detach().requires_grad_()
        y = M.moe_apply(pl, xl, cfg).reshape(T, d)
        leaf = dict(zip(keys, [xl, pl["router"]["w"], pl["w_gate"], pl["w_up"],
                               pl["w_down"]] + [pl["shared"][n]["w"] for n in
                                                ("w_gate", "w_up", "w_down")]))
        return y.detach(), dict(zip(names, torch.autograd.grad(
            (y.float() * wy).sum(), [leaf[n] for n in names])))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, g = port()
    torch.cuda.synchronize()
    port_s = time.perf_counter() - t0
    # the oracle, in f32
    t0 = time.perf_counter()
    x2d = x.reshape(T, d)
    xr = x2d.float().requires_grad_()
    wr = p["router"]["w"].detach().requires_grad_()
    logits = xr @ wr.to(x.dtype).float()  # the router weight at x's dtype
    ids = moe_plain_experts(torch, p, x2d, cfg)
    cap = cfg.moe_capacity(T)
    load = int(torch.bincount(ids.reshape(-1), minlength=E).max())
    check(load <= cap, f"router check: an expert got {load} > {cap} slots")
    aff = torch.sigmoid(logits)
    sel = torch.gather(aff, -1, ids)
    gates = sel / sel.sum(-1, keepdim=True)
    xf, gate_c = x2d.float(), gates.detach()
    ggate = torch.zeros_like(gate_c)
    gx = torch.zeros_like(xf)
    want_y = torch.zeros_like(xf)
    sq = {key: [0.0, 0.0] for key in keys}  # sum of squared errors and of squares

    def acc(key, got, want):
        sq[key][0] += float((got.float() - want).double().pow(2).sum())
        sq[key][1] += float(want.double().pow(2).sum())

    def swiglu_grads(xe, ws, gy):
        ws = [w.float().requires_grad_() for w in ws]
        xe = xe.detach().requires_grad_()
        h = xe @ ws[0]
        ye = (h * torch.sigmoid(h) * (xe @ ws[1])) @ ws[2]
        grads = torch.autograd.grad(ye, [xe] + ws, gy)
        return ye.detach(), grads

    for e in range(E):
        t, j = torch.nonzero(ids == e, as_tuple=True)
        if not t.numel():
            for n in ("w_gate", "w_up", "w_down"):
                check(not g[n][e].any(), f"router check: expert {e} has no tokens "
                      f"but a {n} grad")
            continue
        gw = gate_c[t, j][:, None]
        ye, (gxe, *gws) = swiglu_grads(
            xf[t], [p[n][e] for n in ("w_gate", "w_up", "w_down")], wy[t] * gw)
        want_y.index_add_(0, t, ye * gw)
        gx.index_add_(0, t, gxe)
        ggate[t, j] = (ye * wy[t]).sum(-1)
        for n, gw_ in zip(("w_gate", "w_up", "w_down"), gws):
            acc(n, g[n][e], gw_)
    ys, (gxs, *gws) = swiglu_grads(
        xf, [p["shared"][n]["w"] for n in ("w_gate", "w_up", "w_down")], wy)
    want_y += ys
    gx += gxs
    for n, gw_ in zip(("w_gate", "w_up", "w_down"), gws):
        acc(f"shared.{n}", g[f"shared.{n}"], gw_)
    gxr, gwr = torch.autograd.grad(gates, [xr, wr], ggate)
    acc("x", g["x"].reshape(T, d), gx + gxr)
    acc("router", g["router"], gwr)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    y_rel = float((y.float() - want_y).norm() / want_y.norm())
    grad_rel = {key: (e2 / max(w2, 1e-300)) ** 0.5 for key, (e2, w2) in sq.items()}
    check(y_rel <= MOE_BF16_TOL, f"router check: y vs the f32 oracle {y_rel}")
    check(max(grad_rel.values()) <= TF_BF16_GRAD_TOL,
          f"router check: grads vs the f32 oracle {grad_rel}")
    del y, want_y, gx, gxr
    again = port(("x", "router"))[1]
    bit_equal = {key: bool(torch.equal(again[key], g[key])) for key in again}
    row = {"phase": "tf_router", "arch": cfg.name, "dtype": "bfloat16", "T": T,
           "capacity_factor": cfg.moe_capacity_factor, "slots": cap,
           "max_expert_load": load, "y_rel_err": y_rel, "grad_rel_err": grad_rel,
           "backward_bit_equal_runs": bit_equal, "port_s": port_s,
           "oracle_s": oracle_s, "ok": True}
    emit(row)
    del p, g, again
    free_card(torch)
    return row


def tf_loop(torch, T_, instrument, microbatches: int = 1):
    """The timed TrainLoop; with ``microbatches`` > 1 its step is
    ``make_train_step(..., microbatches)`` (the reference's ``_microbatches``
    for mixtral's train_4k cell), set through Python: ``main`` has no flag
    for it, as the reference's has none."""
    from repro_torch.launch.steps import make_train_step

    base = T_.TrainLoop
    if microbatches > 1:
        class Microbatched(T_.TrainLoop):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.step_fn = make_train_step(self.cfg, self.opt_cfg, microbatches,
                                               donate=True)
        base = Microbatched
    return timed_loop(torch, base, instrument)


def tf_dropped(torch, lm, loop) -> dict:
    """The MoE layers' assignments and the share the capacity dropped, in
    one forward of the next batch (T = B x S tokens a call, factor 1.25):
    ``_local_dispatch``'s ``keep`` counted through a wrapper."""
    from repro_torch.models import moe as M

    counts, real = [0, 0], M._local_dispatch

    def counted(*a, **kw):
        out = real(*a, **kw)
        keep = out[1][3]
        counts[0] += keep.numel()
        counts[1] += int(keep.sum())
        return out

    M._local_dispatch = counted
    try:
        with torch.no_grad():
            lm.loss_fn(loop.params, loop.stream.batch(loop.step, loop.device), loop.cfg)
    finally:
        M._local_dispatch = real
    return {"assignments": counts[0], "kept": counts[1],
            "dropped_share": 1 - counts[1] / max(counts[0], 1),
            "capacity_factor": loop.cfg.moe_capacity_factor}


def tf_update_bytes(torch, lm, loop) -> dict:
    """Card bytes the AdamW update adds above the state and the grads (its
    float32 temporaries, one leaf at a time with donation), and the peak
    of the value-and-grad alone."""
    from repro_torch.launch.steps import value_and_grad_trainable
    from repro_torch.optim import apply_updates
    from repro_torch.sparse.layers import strip_derived

    batch = loop.stream.batch(loop.step, loop.device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, grads = value_and_grad_trainable(lm.loss_fn)(loop.params, batch, loop.cfg)
    torch.cuda.synchronize()
    vag_peak = torch.cuda.max_memory_allocated()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    apply_updates(strip_derived(loop.params), strip_derived(grads), loop.opt,
                  loop.opt_cfg, donate=True)
    torch.cuda.synchronize()
    out = {"state_bytes": base, "value_and_grad_peak_bytes": vag_peak,
           "grads_bytes": before - base,
           "update_extra_bytes": torch.cuda.max_memory_allocated() - before}
    del grads
    return out


def tf_derived_check(torch, params, cfg, rng, device, repeats=None, gen=None) -> int:
    """After the updates of a sparse run: every sparse projection (the MTP
    block's too; of the first ``repeats`` repeats where given) through the
    kernel with the port-only keys its params
    carry (``browptr``, Wᵀ's stream) against ``bcoo_spmv_plain`` on the
    reference's index arrays, forward and transposed, integer-valued at B
    = 4 (the blocks drawn on the card from ``gen`` where given): bit-equal,
    so ``carry_derived`` kept every key in step.  Returns the projections
    checked."""
    from repro_torch.kernels.bcsr_spmv import (bcoo_spmv, bcoo_spmv_plain,
                                               transposed_values)

    dims = ffn_dims(cfg)
    projections = [(name, p) for r, name, _, _, p in lm_projections(params, cfg)
                   if repeats is None or r in range(repeats)]
    if "mtp" in params:
        projections += [(name, params["mtp"]["block"]["mlp"][name]) for name in dims]
    for name, p in projections:
        d_in, d_out = dims[name]
        ints = pm12(torch, rng, p["bvalues"].shape, device, gen).to(torch.bfloat16)
        for (ri, ci, v, rows, ptr), n_in in (
                ((p["browind"], p["bcolind"], ints, d_out, p["browptr"]), d_in),
                ((p["t_browind"], p["t_bcolind"], transposed_values(ints, p["t_perm"]),
                  d_in, p["t_browptr"]), d_out)):
            x = torch.from_numpy(rng.integers(-2, 3, (n_in, LM_BATCH))).to(
                device, torch.bfloat16)
            got = bcoo_spmv(ri, ci, v, x, rows, browptr=ptr)
            check(torch.equal(got, bcoo_spmv_plain(ri, ci, v, x, rows)),
                  f"train families {cfg.name}: {name} after training differs "
                  f"from the plain version")
    return len(projections)


def tf_train(torch, T_, lm, instrument, name, c, device, steps: int,
             variant: str = "dense", microbatches: int = 1, trace: bool = True,
             int8: bool = False, phase: str = "tf_train",
             derived_repeats=None) -> dict:
    """(b) ``c`` in bf16 through TrainLoop from a seeded init on
    ``TokenStream`` batches of ``tf_shape``: losses, step ms (median of
    the untraced steps after the first), tokens/s, peak memory, the block
    kernel's launches in every step (the last counted with the counters
    set to 0 just before it); a sparse run's projections against the plain
    version after its updates (of its first ``derived_repeats`` repeats
    where given, drawn on the card), an MoE run's dropped share; then
    ``TF_TRACED`` steps under the profiler and the update's own bytes; the
    row is emitted as ``phase``."""
    free_card(torch)
    leftover = torch.cuda.memory_allocated()  # what earlier work left on the card
    Timed = tf_loop(torch, T_, instrument, microbatches)
    B, S = tf_shape(c)
    t_run = time.perf_counter()
    loop = Timed(c, tf_opt(c, steps, int8), seq_len=S, global_batch=B, device=device)
    t0 = time.perf_counter()
    loop.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses = loop.run(steps - 1, log_every=0)
    instrument.reset()
    losses += loop.run(steps, log_every=0)
    launches = instrument.launches("bcoo")
    peak = torch.cuda.max_memory_allocated()
    want = tf_launches_per_step(c)
    what = f"train families {name} {variant}"
    check(len(losses) == steps and all(np.isfinite(losses)), f"{what}: losses {losses}")
    check(launches == want and all(n == want for n in loop.step_launches),
          f"{what}: block-kernel launches a step {loop.step_launches}, not {want}")
    med = statistics.median(loop.step_ms[1:])
    checked = 0
    if c.ffn_density < 1:
        # the blocks drawn on the card: on the host, deepseek's 12
        # projections' 0.8G values took about 9 s beside an H100
        card = torch.Generator(device=device).manual_seed(c.n_layers)
        checked = tf_derived_check(torch, loop.params, c,
                                   np.random.default_rng(c.n_layers), device,
                                   derived_repeats, card)
    row = {"phase": phase, "arch": name, "variant": variant,
           "microbatches": microbatches, "n_layers": c.n_layers,
           "n_params": c.n_params, "dtype": "bfloat16",
           "quantized_moments": loop.opt_cfg.quantized_m,
           "lr_peak": loop.opt_cfg.lr_peak, "batch": B,
           "seq": S, "init_s": init_s, "losses": losses,
           "loss_drop": losses[0] - losses[-1], "step_ms": loop.step_ms,
           "step_ms_median": med, "tokens_per_s": B * S / med * 1e3,
           "launches_per_step": loop.step_launches, "want_launches": want,
           "allocated_before_bytes": leftover, "peak_allocated_bytes": peak,
           "projections_checked_after_training": checked}
    if "moe" in c.block_pattern:
        row["moe_dispatch"] = tf_dropped(torch, lm, loop)
    if trace:
        batch = loop.stream.batch(loop.step, loop.device)
        traced = TF_TRACED.get(name, 3)
        row["trace"] = dict(device_trace(
            torch, lambda: loop.step_fn(loop.params, loop.opt, batch), steps=traced),
            steps=traced)
        row.update(tf_update_bytes(torch, lm, loop))
    row["seconds"] = time.perf_counter() - t_run
    emit(row)
    del loop
    free_card(torch)
    return row


def tf_restart(torch, T_, device) -> dict:
    """(b) xlstm-1.3b at full width, one repeat (8 layers): 3 steps
    uninterrupted against 1 step + a checkpoint + a fresh loop's
    ``maybe_restore`` + 2 steps; the losses bit-equal."""
    import tempfile

    c = tf_cfg("xlstm-1.3b", n_layers=TF_RESTART_LAYERS)
    opt_cfg = tf_opt(c, 3)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="train-", dir=os.path.join(ROOT, "build")) as d:
        def fresh(ckpt, every=1):
            return T_.TrainLoop(c, opt_cfg, seq_len=tf_shape(c)[1],
                                global_batch=tf_shape(c)[0],
                                ckpt_dir=ckpt, ckpt_every=every, device=device)

        a = fresh(None)
        a.init_state()
        want = a.run(3, log_every=0)
        del a
        b = fresh(d)
        b.init_state()
        first = b.run(1, log_every=0)
        del b
        t0 = time.perf_counter()
        b2 = fresh(d, every=TF_STEPS)  # no second checkpoint
        check(b2.maybe_restore() and b2.step == 1, "tf restart: no step-1 checkpoint")
        restore_s = time.perf_counter() - t0
        got = first + b2.run(3, log_every=0)
        del b2
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(d) for f in fs)
    check(got == want, f"tf restart: {got} vs {want}")
    row = {"phase": "tf_restart", "arch": c.name, "n_layers": c.n_layers,
           "losses_uninterrupted": want, "losses_resumed": got, "bit_equal": True,
           "restore_s": restore_s, "checkpoint_bytes": ckpt_bytes, "ok": True}
    emit(row)
    free_card(torch)
    return row


TF_REMAT_LAYERS = 12  # (d): zamba2 at full width, 2 repeats


def tf_remat(torch, lm, instrument, device) -> list:
    """(d) zamba2-2.7b at full width cut to TF_REMAT_LAYERS (2 repeats of 5
    Mamba2 layers and the shared block), sparse, bf16: the loss's value and
    grads under remat ``full``, ``dots`` and ``none`` bit-equal; for each
    the value-and-grad's ms (the second of 2 calls), peak memory, block-kernel
    launches and kernels a call under the profiler."""
    from repro_torch.launch.steps import value_and_grad_trainable
    from repro_torch.data.tokens import TokenStream
    from repro_torch.tree import leaves

    base = tf_cfg("zamba2-2.7b", ffn_density=0.5, n_layers=TF_REMAT_LAYERS)
    gen = torch.Generator(device=device).manual_seed(192)
    with torch.no_grad():
        params = lm.init_params(gen, base)
    batch = TokenStream(base.vocab, TF_SEQ, TF_BATCH, 19).batch(0, device)
    vag = value_and_grad_trainable(lm.loss_fn)
    rows, first = [], None
    for mode in ("full", "dots", "none"):
        c = dataclasses.replace(base, remat=mode)
        torch.cuda.synchronize()
        free_card(torch)
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        instrument.reset()
        loss, grads = vag(params, batch, c)
        torch.cuda.synchronize()
        launches = instrument.launches("bcoo")
        peak = torch.cuda.max_memory_allocated() - base_bytes
        g = leaves(grads)
        del grads
        if first is None:
            first = (loss, g)
            same = True
        else:
            same = bool(torch.equal(loss, first[0])
                        and all(torch.equal(a, b) for a, b in zip(g, first[1])))
            del g
        check(same, f"tf remat {mode}: loss or grads differ from full's")
        ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vag(params, batch, c)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        want = (2 if mode == "none" else 3) * 3 * base.n_repeats
        check(launches == want, f"tf remat {mode}: {launches} block-kernel "
              f"launches, not {want}")
        row = {"phase": "tf_remat", "arch": base.name, "remat": mode,
               "dtype": "bfloat16", "batch": TF_BATCH, "seq": TF_SEQ,
               "loss": float(loss), "bit_equal_to_full": same,
               "value_and_grad_ms": statistics.median(ms[1:]),
               "peak_above_params_bytes": peak, "block_launches": launches,
               "trace": device_trace(torch, lambda: vag(params, batch, c), steps=1)}
        emit(row)
        rows.append(row)
    del params, first
    free_card(torch)
    return rows


def phase_train_families(torch, rng, device) -> dict:
    """Phase 19: training the MoE and linear-attention families (see the
    module docstring).  Returns the block kernel's launches in one sparse
    deepseek step plus one sparse zamba2 step (the path's count), the
    largest random-input kernel error and the rows."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import instrument
    from repro_torch.launch import train as T_
    from repro_torch.models import attention as A
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    parts_s = {}
    card_cpu = []
    for name in TF_ARCHS:  # (a) reduced widths: one f32 step, card vs CPU
        c = get_config(name).reduced()
        c = dataclasses.replace(c, n_layers=min(c.n_layers, TF_CUT.get(name, 99)))
        if name in TF_SPARSE:
            c = dataclasses.replace(c, ffn_density=0.5, sparse_block=(8, 16))
        # deepseek's 64 tokens take MLA's query-chunked path, each chunk
        # checkpointed, as the reference's jax.checkpoint
        chunked = (A.CHUNKED_ATTN_THRESHOLD, A.Q_CHUNK)
        if name == "deepseek-v3-671b":
            A.CHUNKED_ATTN_THRESHOLD, A.Q_CHUNK = 64, 16
        try:
            card_cpu.append(train_card_vs_cpu(torch, c, rng, device,
                                              phase="tf_card_vs_cpu"))
        finally:
            A.CHUNKED_ATTN_THRESHOLD, A.Q_CHUNK = chunked
    free_card(torch)
    parts_s["card_vs_cpu"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    layers = tf_layer_grads(torch, rng, device)
    parts_s["layers"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    router = tf_router_check(torch, rng, device)
    parts_s["router"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # (c) the block kernel at the new shapes: forward and grad x against the
    # plain version, both grads against the densified oracle, times
    backward, worst = [], 0.0
    for name in TF_SPARSE:
        rows_, err = train_backward(torch, tf_cfg(name, ffn_density=0.5), rng, device)
        backward += rows_
        worst = max(worst, err)
        free_card(torch)
    parts_s["kernels"] = time.perf_counter() - t0
    # (b) training, 10 steps each; the sparse runs' last steps are the path's
    train, launches = {}, 0
    for name in TF_ARCHS:
        row = tf_train(torch, T_, lm, instrument, name, tf_cfg(name), device, TF_STEPS)
        check(row["loss_drop"] >= 1.0, f"train families {name}: loss fell "
              f"{row['losses'][0]} -> {row['losses'][-1]}, not by 1.0")
        train[name] = row
        if name in TF_SPARSE:  # deepseek's with the reference's int8 moments
            int8 = name == "deepseek-v3-671b"
            sparse = tf_train(torch, T_, lm, instrument, name,
                              tf_cfg(name, ffn_density=0.5), device, TF_SPARSE_STEPS,
                              variant="sparse, int8 moments" if int8 else "sparse",
                              trace=False, int8=int8)
            train[name + ":sparse"] = sparse
            launches += sparse["launches_per_step"][-1]
    train["mixtral-8x22b:microbatches"] = tf_train(
        torch, T_, lm, instrument, "mixtral-8x22b", tf_cfg("mixtral-8x22b"), device,
        TF_MB_STEPS, variant="2 microbatches", microbatches=2, trace=False)
    t0 = time.perf_counter()
    restart = tf_restart(torch, T_, device)
    parts_s["restart"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    remat = tf_remat(torch, lm, instrument, device)
    parts_s["remat"] = time.perf_counter() - t0
    parts_s["train"] = sum(row["seconds"] for row in train.values())
    seconds = time.perf_counter() - t_phase
    emit({"phase": "train_families_done", "seconds": seconds, "parts_s": parts_s,
          "launches": launches})
    return {"launches": launches, "max_abs_err": worst, "card_vs_cpu": card_cpu,
            "layers": layers, "router": router, "backward": backward, "train": train,
            "restart": restart, "remat": remat, "seconds": seconds}


# ------------------------------------ phase 21: the dense family's last archs

DA_ARCHS = ("llama3.2-1b", "gemma2-27b", "llava-next-34b")
# ArchConfig.n_params, dense and at ffn_density=0.5
DA_PARAMS = {"llama3.2-1b": (1_235_746_816, 833_093_632),
             "gemma2-27b": (27_226_275_840, 15_505_293_312),
             "llava-next-34b": (34_388_049_920, 21_175_992_320)}
# the published model whose widths each config has: llava-next-34b's
# registry string names llava-v1.6-mistral-7b (32 layers of 4096); its
# widths are llava-v1.6-34b's Yi-34B language model (ROADMAP.md §3)
DA_SOURCE = {"llama3.2-1b": "hf:meta-llama/Llama-3.2-1B",
             "gemma2-27b": "arXiv:2408.00118 (hf:google/gemma-2-27b)",
             "llava-next-34b": "hf:llava-hf/llava-v1.6-34b-hf (Yi-34B language model)"}
DA_CHECK_LAYERS = 2  # the f32 cuts: gemma2's one attn_local and one attn_global
DA_WINDOW_S = 8192  # (b): a B=1 prefill of two of gemma2's 4,096-token windows
DA_SPARSE_GEN = 8  # (b): tokens of the full-depth sparse gemma2 generate
# (c), (e): layers kept to train at full width.  12 bytes a param (bf16
# params and grads, f32 moments) give gemma2 at 6 layers (3 repeats)
# 54.9 GB, at 8 68.5 GB before the clip's f32 copy of the 4.7 GB tied
# embedding and about 5 GB of (4, 256, 256,000) logits: at 8 it ran out of
# memory on an NVIDIA H100 80GB HBM3 (700 W) in that copy; llava at 6 51.2
# GB, at 8 64.6 GB before its (1, 56, 3,136, 3,136) f32 scores (2.2 GB a
# copy, several live in the backward).  Both train at 2 (gemma2's one
# repeat) to pay for phase 23: at 6 the three runs took 37.7 s on an
# H100 80GB HBM3, 700 W
DA_TRAIN_LAYERS = 2
DA_LLAVA_B, DA_LLAVA_TEXT = 1, 256  # (e): llava's batch, text tokens after the prefix
# (b), (d): layers served, at full width (46 and 60 at first, then 24 and
# 30; cut to pay for phases 24 and 25: gemma2's 6 of its 23 local / global
# repeats)
DA_SERVE_LAYERS = {"gemma2-27b": 12, "llava-next-34b": 15}


def da_counts(cfg, sparse) -> None:
    want = DA_PARAMS[cfg.name]
    check((int(cfg.n_params), int(sparse.n_params)) == want,
          f"dense archs {cfg.name}: parameter counts {cfg.n_params} / "
          f"{sparse.n_params}, not {want}")


def da_f32(torch, lm, Server, cfg, rng, device) -> tuple:
    """f32 (TF32 off): phase 14 (a)'s generate, decode-vs-prefill and
    teacher-forced checks.  Returns (row, server)."""
    srv = Server(cfg, LM_MAX_LEN, device=device, dtype=torch.float32)
    res = lm_generate_checks(torch, lm, srv, cfg, rng, device,
                             f"dense archs {cfg.name} f32")
    emit({"phase": "da_f32", **res, "n_params": cfg.n_params, "ok": True})
    return res, srv


def da_llama(torch, lm, T_, Server, instrument, rng, device) -> dict:
    """(a) llama3.2-1b at full depth: f32 checks, bf16 times, the sparse
    model's kernels, oracle and launches, 10 TrainLoop steps."""
    from repro_torch.configs import get_config

    cfg = get_config("llama3.2-1b")
    sparse = dataclasses.replace(cfg, ffn_density=0.5)
    da_counts(cfg, sparse)
    f32, srv = da_f32(torch, lm, Server, cfg, rng, device)
    del srv
    free_card(torch)
    times = serving_with_peak(torch, lm, Server, cfg, rng, device, "da_serving",
                              source=DA_SOURCE[cfg.name])
    free_card(torch)
    gen = torch.Generator(device=device).manual_seed(211)
    launches, worst = lm_sparse_checks(torch, lm, instrument, Server, sparse, rng,
                                       device, gen=gen)
    free_card(torch)
    train = tf_train(torch, T_, lm, instrument, cfg.name, cfg, device, TF_STEPS,
                     phase="da_train")
    check(train["loss_drop"] >= 1.0, f"dense archs {cfg.name}: loss fell "
          f"{train['losses'][0]} -> {train['losses'][-1]}, not by 1.0")
    return {"launches": launches, "max_abs_err": worst, "f32": f32,
            "times": times, "train": train}


def da_window_checks(torch, lm, A, params, cfg, rng, device) -> dict:
    """(b) gemma2 across its window, f32, B=1: decode(prefill(8,192)) within
    5e-3 of prefill(8,193): the local layers' ring keeps positions
    4,096..8,191 and the decode writes slot 8,192 % 4,096 = 0, the oldest,
    so the ring lines up with the positions; the query-chunked 8,192-token
    prefill (8 chunks a layer) within 1e-3 of the unchunked one."""
    S = DA_WINDOW_S
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S + 1))
                            .astype(np.int32)).to(device)
    what = f"dense archs {cfg.name} window"
    calls, real = [], A._sdpa_qchunked
    with torch.no_grad():
        A._sdpa_qchunked = lambda *a, **kw: calls.append(1) or real(*a, **kw)
        try:
            t0 = time.perf_counter()
            chunked, caches = lm.prefill(params, toks[:, :S], cfg, S + 1)
            torch.cuda.synchronize()
            chunked_s = time.perf_counter() - t0
        finally:
            A._sdpa_qchunked = real
        check(len(calls) == cfg.n_layers,
              f"{what}: {len(calls)} chunked attention calls, not {cfg.n_layers}")
        rings = [c.k.shape[2] for c in caches.blocks.values()]
        check(rings == [cfg.sliding_window, S + 1],
              f"{what}: cache capacities {rings}")
        got, _ = lm.decode_step(params, toks[:, S:], caches, cfg)
        del caches
        # 8,193 positions are no multiple of Q_CHUNK: the unchunked path
        want, _ = lm.prefill(params, toks, cfg, S + 1)
        step_err = max_err(torch, got, want)
        check(torch.allclose(got, want, rtol=5e-3, atol=5e-3),
              f"{what}: decode(prefill({S})) vs prefill({S + 1}): {step_err}")
        threshold = A.CHUNKED_ATTN_THRESHOLD
        A.CHUNKED_ATTN_THRESHOLD = S + 1
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            unchunked, _ = lm.prefill(params, toks[:, :S], cfg, S + 1)
            torch.cuda.synchronize()
            unchunked_s = time.perf_counter() - t0
            unchunked_peak = torch.cuda.max_memory_allocated()
        finally:
            A.CHUNKED_ATTN_THRESHOLD = threshold
        chunk_err = max_err(torch, chunked, unchunked)
        check(torch.allclose(chunked, unchunked, rtol=LM_LOGIT_TOL, atol=LM_LOGIT_TOL),
              f"{what}: chunked vs unchunked prefill: {chunk_err}")
    row = {"phase": "da_window", "arch": cfg.name, "n_layers": cfg.n_layers,
           "dtype": "float32", "S": S, "window": cfg.sliding_window,
           "ring_slot_of_decode": S % cfg.sliding_window,
           "decode_vs_prefill_max_err": step_err, "chunked_calls": len(calls),
           "chunked_vs_unchunked_max_err": chunk_err, "tolerance": LM_LOGIT_TOL,
           "chunked_s": chunked_s, "unchunked_s": unchunked_s,
           "unchunked_peak_bytes": unchunked_peak, "ok": True}
    emit(row)
    return row


def da_sparse_generate(torch, lm, Server, instrument, cfg, rng, device) -> dict:
    """(b) Sparse gemma2 at the served depth, bf16: one ``generate`` of
    ``DA_SPARSE_GEN`` tokens launching the block kernel once per
    projection per step (the path's count), then the prefill and a decode
    step timed."""
    srv = Server(cfg, LM_MAX_LEN, device=device)
    per_step = lm_launches_per_step(srv.params, cfg)
    check(per_step == 3 * cfg.n_layers, f"dense archs sparse: {per_step} projections")
    prompts = rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    torch.cuda.synchronize()
    instrument.reset()
    t0 = time.perf_counter()
    out = srv.generate(prompts, DA_SPARSE_GEN)
    gen_s = time.perf_counter() - t0
    launches = instrument.snapshot()
    want = per_step * DA_SPARSE_GEN
    check(launches.get("bcoo", 0) == want and launches.get("bcoo.spmm", 0) == want,
          f"dense archs {cfg.name} sparse: {launches} block-kernel launches, "
          f"not {want}")
    check(((0 <= out) & (out < cfg.vocab)).all(), "dense archs sparse: token range")
    toks = torch.from_numpy(prompts).to(device)
    with torch.no_grad():
        _, caches = lm.prefill(srv.params, toks, cfg, LM_MAX_LEN)
        tok = toks[:, -1:]
        prefill_ms = time_ms(torch, lambda: lm.prefill(srv.params, toks, cfg,
                                                       LM_MAX_LEN), 2, warmup=0)
        # the same slot rewritten each call: the caches are not advanced
        decode_ms = time_ms(torch, lambda: lm.decode_step(srv.params, tok, caches,
                                                          cfg), 3, warmup=1)
    row = {"phase": "da_sparse_generate", "arch": cfg.name, "n_layers": cfg.n_layers,
           "dtype": "bfloat16", "n_params": cfg.n_params, "per_step": per_step,
           "gen": DA_SPARSE_GEN, "launches_per_generate": launches,
           "generate_s": gen_s, "prefill_ms": prefill_ms,
           "decode_ms_per_token": decode_ms,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    emit(row)
    del srv, caches
    free_card(torch)
    return row


def da_gemma2_serving(torch, lm, A, Server, instrument, rng, device) -> dict:
    """(b) gemma2-27b: bf16 at ``DA_SERVE_LAYERS`` (times, a B=1 S=8,192
    prefill), the f32 2-layer checks and the window's, sparse at the f32
    cut (kernels, oracle) and at the served depth (launches, times)."""
    from repro_torch.configs import get_config

    cfg = get_config("gemma2-27b")
    sparse = dataclasses.replace(cfg, ffn_density=0.5)
    da_counts(cfg, sparse)
    served = dataclasses.replace(cfg, n_layers=DA_SERVE_LAYERS[cfg.name])
    free_card(torch)
    srv = Server(served, LM_MAX_LEN, device=device)
    times = serving_with_peak(torch, lm, Server, served, rng, device, "da_serving",
                              srv=srv, source=DA_SOURCE[cfg.name])
    # B=1, S=8,192 at the served depth: the query-chunked path in every layer
    long = torch.from_numpy(rng.integers(0, cfg.vocab, (1, DA_WINDOW_S))
                            .astype(np.int32)).to(device)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():  # one call: each layer's 8 query chunks take seconds
        long_ms = time_ms(torch, lambda: lm.prefill(srv.params, long, served,
                                                    DA_WINDOW_S), 1, warmup=0)
    long_row = {"phase": "da_long_prefill", "arch": cfg.name, "dtype": "bfloat16",
                "n_layers": served.n_layers, "B": 1, "S": DA_WINDOW_S, "ms": long_ms,
                "tokens_per_s": DA_WINDOW_S / long_ms * 1e3,
                "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    emit(long_row)
    del srv
    free_card(torch)
    cut = dataclasses.replace(cfg, n_layers=DA_CHECK_LAYERS)
    f32, srv = da_f32(torch, lm, Server, cut, rng, device)
    window = da_window_checks(torch, lm, A, srv.params, cut, rng, device)
    del srv
    free_card(torch)
    gen = torch.Generator(device=device).manual_seed(212)
    _, worst = lm_sparse_checks(torch, lm, instrument, Server,
                                dataclasses.replace(sparse, n_layers=DA_CHECK_LAYERS),
                                rng, device, gen=gen)
    free_card(torch)
    sparse_row = da_sparse_generate(
        torch, lm, Server, instrument,
        dataclasses.replace(sparse, n_layers=DA_SERVE_LAYERS[cfg.name]), rng, device)
    return {"times": times, "long_prefill": long_row, "f32": f32, "window": window,
            "sparse": sparse_row, "max_abs_err": worst,
            "launches": sparse_row["launches_per_generate"].get("bcoo", 0)}


def da_gemma2_training(torch, lm, T_, instrument, rng, device) -> dict:
    """(c) gemma2-27b at full width cut to ``DA_TRAIN_LAYERS`` (one local,
    global repeat): 10 bf16 TrainLoop steps dense and at
    ``ffn_density=0.5``; card vs CPU at reduced widths (dense, and sparse
    in (8, 16) blocks), f32."""
    from repro_torch.configs import get_config

    cfg = get_config("gemma2-27b")
    cut = dataclasses.replace(cfg, n_layers=DA_TRAIN_LAYERS)
    dense = tf_train(torch, T_, lm, instrument, cfg.name, cut, device, TF_STEPS,
                     phase="da_train")
    check(dense["loss_drop"] >= 1.0, f"dense archs {cfg.name} training: loss "
          f"fell {dense['losses'][0]} -> {dense['losses'][-1]}, not by 1.0")
    sparse = tf_train(torch, T_, lm, instrument, cfg.name,
                      dataclasses.replace(cut, ffn_density=0.5), device, TF_STEPS,
                      variant="sparse", trace=False, phase="da_train",
                      derived_repeats=1)
    red = cfg.reduced()
    card_cpu = [train_card_vs_cpu(torch, c, rng, device, phase="da_card_vs_cpu")
                for c in (red, dataclasses.replace(red, ffn_density=0.5,
                                                   sparse_block=(8, 16)))]
    return {"dense": dense, "sparse": sparse, "card_vs_cpu": card_cpu,
            "launches": sparse["launches_per_step"][-1]}


def da_prefix(torch, cfg, batch: int, device, dtype, seed: int):
    """llava's stub image prefix (the registry's: no vision tower): (B,
    2,880, d) standard-normal patch embeddings drawn on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((batch, cfg.modality_tokens, cfg.d_model), generator=gen,
                       device=device).to(dtype)


def da_generate(torch, lm, steps, params, cfg, toks, prefix, max_len: int,
                n_tokens: int):
    """Greedy tokens after a prefix: ``lm.prefill`` (``make_prefill_step``
    would size its caches at prefill_32k's 32,768), then ``make_decode_step``."""
    decode = steps.make_decode_step(cfg, "decode_32k")
    logits, caches = lm.prefill(params, toks, cfg, max_len, prefix_embeds=prefix)
    out = [torch.argmax(logits, -1)[:, None].to(torch.int32)]
    for _ in range(1, n_tokens):
        logits, caches = decode(params, {"token": out[-1], "caches": caches})
        out.append(torch.argmax(logits, -1)[:, None].to(torch.int32))
    return torch.cat(out, dim=1)


def da_llava_checks(torch, lm, steps, instrument, cfg, rng, device) -> tuple:
    """(d) llava at the f32 2-layer cut with a stub prefix, B=1: the step
    builders bit-equal to ``lm.prefill`` / ``lm.decode_step``, decode vs
    prefill within 5e-3; sparse within 1e-3 of its densified oracle over
    the prefill and 3 decode steps, its projections against the plain
    version at B = 4 and 3,008.  Returns (rows, random max err)."""
    from repro_torch.configs.base import SHAPES

    P = cfg.modality_tokens
    cut = dataclasses.replace(cfg, n_layers=DA_CHECK_LAYERS)
    pe = da_prefix(torch, cut, 1, device, torch.float32, 215)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, LM_PROMPT + 1))
                            .astype(np.int32)).to(device)
    prompt, nxt = toks[:, :-1], toks[:, -1:]
    max_len = P + LM_PROMPT + LM_GEN
    what = f"dense archs {cfg.name}"
    params = lm.init_params(torch.Generator(device=device).manual_seed(0), cut,
                            torch.float32)
    with torch.no_grad():
        sl, sc = steps.make_prefill_step(cut, "prefill_32k")(
            params, {"tokens": prompt, "prefix_embeds": pe})
        dl, dc = lm.prefill(params, prompt, cut, SHAPES["prefill_32k"]["seq_len"],
                            prefix_embeds=pe)
        check(torch.equal(sl, dl), f"{what}: make_prefill_step != lm.prefill")
        sg, _ = steps.make_decode_step(cut, "decode_32k")(
            params, {"token": nxt, "caches": sc})
        dg, _ = lm.decode_step(params, nxt, dc, cut)
        check(torch.equal(sg, dg), f"{what}: make_decode_step != lm.decode_step")
        del sc, dc
        want, _ = lm.prefill(params, toks, cut, max_len, prefix_embeds=pe)
        step_err = max_err(torch, dg, want)
        check(torch.allclose(dg, want, rtol=5e-3, atol=5e-3),
              f"{what}: decode(prefill) vs prefill, after the prefix: {step_err}")
    dense_row = {"phase": "da_prefix_f32", "arch": cfg.name, "n_layers": cut.n_layers,
                 "dtype": "float32", "prefix": P, "prompt": LM_PROMPT,
                 "step_builders_bit_equal": True,
                 "prefill_step_max_len": SHAPES["prefill_32k"]["seq_len"],
                 "decode_vs_prefill_max_err": step_err, "ok": True}
    emit(dense_row)
    del params
    free_card(torch)
    # sparse at the cut against its densified torch.matmul oracle
    sc_cfg = dataclasses.replace(cut, ffn_density=0.5)
    params = lm.init_params(torch.Generator(device=device).manual_seed(0), sc_cfg,
                            torch.float32)
    oracle = densified_params(torch, params, sc_cfg)
    dense_cfg = dataclasses.replace(sc_cfg, ffn_density=1.0)
    per_step = lm_launches_per_step(params, sc_cfg)
    errs = {}
    with torch.no_grad():
        instrument.reset()
        got, caches = lm.prefill(params, prompt, sc_cfg, max_len, prefix_embeds=pe)
        want, ocaches = lm.prefill(oracle, prompt, dense_cfg, max_len,
                                   prefix_embeds=pe)
        errs["prefill"] = max_err(torch, got, want)
        tok = nxt
        for step in range(3):
            got, caches = lm.decode_step(params, tok, caches, sc_cfg)
            want, ocaches = lm.decode_step(oracle, tok, ocaches, dense_cfg)
            errs[f"decode{step}"] = max_err(torch, got, want)
            tok = torch.argmax(want, -1)[:, None].to(torch.int32)
        launches = instrument.launches("bcoo")
    check(max(errs.values()) <= LM_LOGIT_TOL,
          f"{what} sparse: vs the densified oracle {errs}")
    check(launches == per_step * 4, f"{what} sparse: {launches} launches, "
          f"not {per_step * 4}")
    del oracle, caches, ocaches
    gen = torch.Generator(device=device).manual_seed(213)
    worst = lm_projection_kernels(torch, params, sc_cfg, rng, device,
                                  batches=(LM_BATCH, P + LM_PROMPT), gen=gen)
    sparse_row = {"phase": "da_prefix_sparse", "arch": cfg.name,
                  "n_layers": sc_cfg.n_layers, "dtype": "float32",
                  "ffn_density": sc_cfg.ffn_density, "oracle_max_abs_err": errs,
                  "tolerance": LM_LOGIT_TOL, "launches": launches, "ok": True}
    emit(sparse_row)
    del params
    free_card(torch)
    return [dense_row, sparse_row], worst


def da_llava_serving(torch, lm, steps, instrument, rng, device) -> dict:
    """(d) llava-next-34b at ``DA_SERVE_LAYERS``, bf16, B=1: the 2,880-token stub
    prefix and a 128-token prompt (3,008 positions, under
    CHUNKED_ATTN_THRESHOLD: full scores in every layer), 32 greedy tokens
    through ``lm.prefill`` and ``make_decode_step``; times, a decode trace
    and the peak; the f32 cut's checks; sparse at the served depth, one
    prefill's launches (T = 3,008 on the tensor cores) and time."""
    from repro_torch.configs import get_config

    full = get_config("llava-next-34b")
    da_counts(full, dataclasses.replace(full, ffn_density=0.5))
    cfg = dataclasses.replace(full, n_layers=DA_SERVE_LAYERS[full.name])
    sparse = dataclasses.replace(cfg, ffn_density=0.5)
    P = cfg.modality_tokens
    max_len = P + LM_PROMPT + LM_GEN
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    pe = da_prefix(torch, cfg, 1, device, torch.bfloat16, 214)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, LM_PROMPT))
                            .astype(np.int32)).to(device)
    with torch.no_grad():
        t0 = time.perf_counter()
        out = da_generate(torch, lm, steps, params, cfg, toks, pe, max_len, LM_GEN)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        check(out.shape == (1, LM_GEN) and bool(((0 <= out) & (out < cfg.vocab)).all()),
              f"dense archs {cfg.name}: generate gave {tuple(out.shape)}")
        decode = steps.make_decode_step(cfg, "decode_32k")
        _, caches = lm.prefill(params, toks, cfg, max_len, prefix_embeds=pe)
        batch = {"token": toks[:, -1:], "caches": caches}
        # warm: the generate's prefill ran the same shapes
        prefill_ms = time_ms(torch, lambda: lm.prefill(params, toks, cfg, max_len,
                                                       prefix_embeds=pe), 2, warmup=0)
        # the same slot rewritten each call: the caches are not advanced
        decode_ms = time_ms(torch, lambda: decode(params, batch), 10)
        trace = device_trace(torch, lambda: decode(params, batch))
    row = {"phase": "da_prefix_serving", "arch": cfg.name, "source": DA_SOURCE[cfg.name],
           "n_layers": cfg.n_layers, "n_params": cfg.n_params, "dtype": "bfloat16",
           "batch": 1, "prefix": P, "prompt": LM_PROMPT, "gen": LM_GEN,
           "max_len": max_len, "prefill_ms": prefill_ms,
           "decode_ms_per_token": decode_ms, "generate_s": gen_s,
           "tokens_per_s": LM_GEN / gen_s, "decode_trace": trace,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    emit(row)
    del params, caches, batch
    free_card(torch)
    checks, worst = da_llava_checks(torch, lm, steps, instrument, full, rng, device)
    # sparse at the served depth: one prefill over the prefix, T = 3,008
    params = lm.init_params(torch.Generator(device=device).manual_seed(0), sparse)
    per_step = lm_launches_per_step(params, sparse)
    with torch.no_grad():  # the counted call, timed by CUDA events (seconds long)
        instrument.reset()
        sparse_ms = time_ms(torch, lambda: lm.prefill(params, toks, sparse, max_len,
                                                      prefix_embeds=pe), 1, warmup=0)
        launches = instrument.snapshot()
        check(launches.get("bcoo", 0) == per_step == 3 * cfg.n_layers
              and launches.get("bcoo.spmm", 0) == per_step,
              f"dense archs {cfg.name} sparse prefill: {launches}, not {per_step}")
    sparse_row = {"phase": "da_prefix_sparse_prefill", "arch": cfg.name,
                  "n_layers": cfg.n_layers, "n_params": sparse.n_params,
                  "dtype": "bfloat16", "T": P + LM_PROMPT, "launches": launches,
                  "prefill_ms": sparse_ms, "dense_prefill_ms": prefill_ms}
    emit(sparse_row)
    del params
    free_card(torch)
    return {"serving": row, "checks": checks, "sparse": sparse_row,
            "max_abs_err": worst, "launches": launches.get("bcoo", 0)}


def da_llava_training(torch, lm, steps, rng, device) -> dict:
    """(e) llava-next-34b at full width cut to ``DA_TRAIN_LAYERS``:
    ``make_train_step`` (the update donated, as TrainLoop's) for 10 bf16
    steps of B=1, a fresh 2,880-token stub prefix and 256 TokenStream text
    tokens each; the loss over the text falls by at least 1.0; step ms,
    peak, a one-step trace; card vs CPU at reduced widths with a prefix."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.optim import init_opt
    from repro_torch.sparse.layers import strip_derived

    cfg = get_config("llava-next-34b")
    cut = dataclasses.replace(cfg, n_layers=DA_TRAIN_LAYERS)
    free_card(torch)
    leftover = torch.cuda.memory_allocated()
    params = lm.init_params(torch.Generator(device=device).manual_seed(0), cut)
    opt_cfg = tf_opt(cut, TF_STEPS)
    opt = init_opt(strip_derived(params), opt_cfg)
    step = steps.make_train_step(cut, opt_cfg, donate=True)
    stream = TokenStream(cut.vocab, DA_LLAVA_TEXT, DA_LLAVA_B, 0)
    gen = torch.Generator(device=device).manual_seed(217)

    def batch(i):
        return dict(stream.batch(i, device),
                    prefix_embeds=torch.randn((DA_LLAVA_B, cut.modality_tokens,
                                               cut.d_model), generator=gen,
                                              device=device).to(torch.bfloat16))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for i in range(TF_STEPS):
        b = batch(i)
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, b)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    what = f"dense archs {cfg.name} training"
    check(all(np.isfinite(losses)), f"{what}: losses {losses}")
    check(losses[0] - losses[-1] >= 1.0,
          f"{what}: loss fell {losses[0]} -> {losses[-1]}, not by 1.0")
    b = batch(TF_STEPS)
    trace = dict(device_trace(torch, lambda: step(params, opt, b), steps=1), steps=1)
    med = statistics.median(step_ms[1:])
    T = DA_LLAVA_B * (cut.modality_tokens + DA_LLAVA_TEXT)
    row = {"phase": "da_prefix_train", "arch": cfg.name, "n_layers": cut.n_layers,
           "n_params": cut.n_params, "dtype": "bfloat16", "batch": DA_LLAVA_B,
           "prefix": cut.modality_tokens, "text": DA_LLAVA_TEXT,
           "lr_peak": opt_cfg.lr_peak, "losses": losses,
           "loss_drop": losses[0] - losses[-1], "step_ms": step_ms,
           "step_ms_median": med, "positions_per_s": T / med * 1e3,
           "text_tokens_per_s": DA_LLAVA_B * DA_LLAVA_TEXT / med * 1e3,
           "allocated_before_bytes": leftover, "peak_allocated_bytes": peak,
           "trace": trace}
    emit(row)
    del params, opt, b
    free_card(torch)
    red = dataclasses.replace(cfg.reduced(), n_layers=DA_CHECK_LAYERS)
    card_cpu = train_card_vs_cpu(torch, red, rng, device, phase="da_card_vs_cpu")
    return {"train": row, "card_vs_cpu": card_cpu}


def da_kernel_times(torch, rng, device) -> tuple:
    """(f) The block kernel at the new shapes: gemma2's w_gate (4608 ->
    36,864) and w_down at B = 1, 4 and 512, its backward at T = 1,024
    (grad x on Wᵀ's (128, 8) blocks), llava's w_gate (7168 -> 20,480) and
    w_down at T = 3,008; each beside its plain version, ``torch.matmul``
    and the bound.  Returns (rows, backward rows, random max err)."""
    from repro_torch.configs import get_config

    gemma = dataclasses.replace(get_config("gemma2-27b"), ffn_density=0.5)
    rows = lm_projection_times(torch, gemma, rng, device)
    free_card(torch)
    backward, worst = train_backward(torch, gemma, rng, device,
                                     torch.Generator(device=device).manual_seed(216))
    free_card(torch)
    llava = dataclasses.replace(get_config("llava-next-34b"), ffn_density=0.5)
    rows += lm_projection_times(torch, llava, rng, device,
                                batches=(llava.modality_tokens + LM_PROMPT,))
    free_card(torch)
    return rows, backward, worst


def phase_dense_archs(torch, rng, device) -> dict:
    """Phase 21: the dense family's last three archs (see the module
    docstring).  Returns the block kernel's launches in the path's counted
    runs (llama's sparse generate, gemma2's full-depth sparse generate,
    llava's full-depth sparse prefill, one sparse gemma2 train step), the
    largest random-input kernel error and the rows."""
    from repro_torch.kernels import instrument
    from repro_torch.launch import steps
    from repro_torch.launch import train as T_
    from repro_torch.launch.serve import Server
    from repro_torch.models import attention as A
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    parts_s, out = {}, {}
    for key, run in (
            ("llama", lambda: da_llama(torch, lm, T_, Server, instrument, rng, device)),
            ("gemma2_serving", lambda: da_gemma2_serving(torch, lm, A, Server,
                                                         instrument, rng, device)),
            ("gemma2_training", lambda: da_gemma2_training(torch, lm, T_, instrument,
                                                           rng, device)),
            ("llava_serving", lambda: da_llava_serving(torch, lm, steps, instrument,
                                                       rng, device)),
            ("llava_training", lambda: da_llava_training(torch, lm, steps, rng,
                                                         device)),
            ("kernels", lambda: da_kernel_times(torch, rng, device))):
        t0 = time.perf_counter()
        out[key] = run()
        parts_s[key] = time.perf_counter() - t0
        free_card(torch)
    projections, backward, kernel_err = out["kernels"]
    launches = {"llama_generate": out["llama"]["launches"],
                "gemma2_generate": out["gemma2_serving"]["launches"],
                "llava_prefill": out["llava_serving"]["launches"],
                "gemma2_train_step": out["gemma2_training"]["launches"]}
    worst = max(out["llama"]["max_abs_err"], out["gemma2_serving"]["max_abs_err"],
                out["llava_serving"]["max_abs_err"], kernel_err)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "dense_archs_done", "seconds": seconds, "parts_s": parts_s,
          "launches": launches})
    return {"launches": sum(launches.values()), "launches_by_run": launches,
            "max_abs_err": worst, "projections": projections, "backward": backward,
            "seconds": seconds, **{k: v for k, v in out.items() if k != "kernels"}}


# ---------------------------------------------- phase 22: examples and tools
# (script, argv, kernel kinds of which one at least must launch); each runs
# in process at its defaults, on the card
EX_RUNS = (
    ("examples/torch_quickstart.py", [], ("coo", "bcoo")),
    ("examples/torch_spmv_end_to_end.py", [], ("coo", "bcoo")),
    ("examples/torch_engine_quickstart.py", [], ("coo", "bcoo")),
    ("examples/torch_solver_quickstart.py", [], ("coo", "bcoo")),
    ("examples/torch_serve_quickstart.py", [], ("coo", "bcoo")),
    ("examples/torch_slo_quickstart.py", [], ("coo", "bcoo")),
    ("examples/torch_topo_quickstart.py", [], ("coo", "bcoo")),
    ("examples/torch_cluster_quickstart.py", [], ("coo", "bcoo")),
    ("examples/torch_serve_lm.py", [], ()),
    ("examples/torch_train_lm.py", [], ()),
    ("examples/torch_train_lm.py", ["--sparse-ffn"], ("bcoo",)),
    ("tools/trace_dump_torch.py", None, ("coo", "bcoo")),  # argv: its --out
    ("tools/check_topo_torch.py", [], ("coo", "bcoo")),
)


def load_script(rel: str):
    """Import a script of the checkout by its path (its main not run)."""
    import importlib.util

    name = "_phase22_" + os.path.splitext(os.path.basename(rel))[0]
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def trace_kernel_rows(path: str) -> tuple:
    """(request rows, rows without a ``kernel`` span) of a Chrome trace."""
    with open(path, encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    rows = {}
    for ev in events:
        if ev.get("ph") == "X":
            rows.setdefault(ev["tid"], set()).add(ev["name"])
    return len(rows), sum("kernel" not in names for names in rows.values())


def phase_examples(torch, device) -> dict:
    """Phase 22: every ``examples/torch_*.py`` and the tools
    ``trace_dump_torch`` (replay mode) and ``check_topo_torch``, in process
    on the card at their defaults.  Each must complete with its assertions
    held, and each SpMV one launch a kernel (the cluster's in its workers,
    read from the router's stats before it closed); the sparse
    ``torch_train_lm`` the block kernel.  Each script's output goes to
    ``build/phase22/<script>.log``; its row holds the last line.  Returns
    the path's launches per kind, the rows and the seconds."""
    import contextlib
    import io

    from repro_torch.kernels import instrument

    out_dir = os.path.join(ROOT, "build", "phase22")
    os.makedirs(out_dir, exist_ok=True)
    t_phase = time.perf_counter()
    launches, rows = {"coo": 0, "bcoo": 0}, []
    for rel, argv, need in EX_RUNS:
        name = os.path.splitext(os.path.basename(rel))[0]
        tag = name + "".join(a.replace("--", ".") for a in argv or [])
        trace_path = os.path.join(out_dir, "serve_trace.json")
        if argv is None:
            argv = ["--out", trace_path]
        if device.type != "cuda":  # a rehearsal on the host
            argv = argv + ["--device", device.type]
        mod = load_script(rel)
        log = io.StringIO()
        instrument.reset()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(log):
                result = mod.main(argv)
        finally:  # the output of a script that raised is kept too
            with open(os.path.join(out_dir, tag + ".log"), "w",
                      encoding="utf-8") as fh:
                fh.write(log.getvalue())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = {k: instrument.launches(k) for k in launches}
        row = {"phase": "example", "script": rel, "argv": argv, "seconds": seconds}
        if name.startswith("check_") or name.startswith("trace_"):
            check(result == 0, f"{rel} {argv} exited {result}: {log.getvalue()[-2000:]}")
        if name == "torch_cluster_quickstart":  # launched in the worker processes
            got = {k: sum(st["launches"].get(k, 0) for st in result["workers"].values()
                          if not st.get("lost")) for k in launches}
            row["served"] = result["served"]
        if name == "trace_dump_torch":
            n_rows, no_kernel = trace_kernel_rows(trace_path)
            row.update(trace_rows=n_rows, rows_without_kernel=no_kernel)
            check(n_rows > 0 and no_kernel == 0,
                  f"trace dump: {no_kernel} of {n_rows} request rows hold no kernel span")
        if name == "torch_train_lm":
            row["losses"] = [result["losses"][0], result["losses"][-1]]
            check(all(np.isfinite(result["losses"])), f"{tag}: losses {result['losses']}")
        row.update(launches=got, last_line=log.getvalue().strip().splitlines()[-1])
        emit(row)
        rows.append(row)
        if need:
            check(sum(got[k] for k in need) > 0,
                  f"{tag}: no launch of {' or '.join(need)} ({got})")
        for k in launches:
            launches[k] += got[k]
        del mod, result
        free_card(torch)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "examples_done", "seconds": seconds, "launches": launches})
    return {"launches": launches, "rows": rows, "seconds": seconds}


# ------------------------------------------------------- phase 20: the dry run
# (a) the SpMV dry run's matrix (launch/dryrun_spmv.py): 2^20 rows of 16
# standard-normal nonzeros over Zipf columns, on 256 and 512 parts of the
# card.  The ring's equal-capacity buckets would hold 42.4 GiB at 2^20
# rows on 256 parts (shard 0 takes about 88 % of a part's nonzeros; its
# count, dryrun_spmv), so the ring runs at 2^14 rows: its 256^2 steps, not
# its rows, set its time
DR_ROWS, DR_NNZ_ROW, DR_PARTS = 1 << 20, 16, (256, 512)
DR_RING_ROWS, DR_RING_PARTS = 1 << 14, 256
# ------------------------------------------------------------- process mesh

PW_RANKS = 4  # phase 23: ranks of one gloo world, all on the one card
PW_TIMED = 5  # exe(x) calls timed a scheme, after its two checked requests
PW_BATCH = 8
PW_MATRICES = ("scale-free", "regular", "block")
# (name, matrix, scheme, fmt, merge, ring)
PW_SCHEMES = (
    ("1d-rows", "scale-free", "1d.rows", "coo", None, False),
    ("1d-nnz-rgrn", "scale-free", "1d.nnz-rgrn", "coo", None, False),
    ("1d-nnz", "scale-free", "1d.nnz", "coo", None, False),
    ("ring", "scale-free", "1d.nnz", "coo", None, True),
    ("2d-es-psum", "regular", "2d.equally-sized", "coo", "psum", False),
    ("2d-es-psum_scatter", "regular", "2d.equally-sized", "coo", "psum_scatter",
     False),
    ("2d-es-global", "regular", "2d.equally-sized", "coo", "global", False),
    ("2d-ew", "regular", "2d.equally-wide", "coo", None, False),
    ("2d-vs", "regular", "2d.variable-sized", "coo", None, False),
    ("2d-es-bcoo", "block", "2d.equally-sized", "bcoo", None, False),
)
# halved from 2^21 / 2^20 / 2^20 to pay for phase 24, and again to
# pay for phase 25 (the ranks' host setup and the parent's references
# scale with the rows)
PW_ROWS = {"scale-free": 1 << 19, "regular": 1 << 18, "block": 1 << 18}
PW_TURN_TIMEOUT_S = 480  # a rank's wait for the parent's turn file


def pw_triplets(name: str, seed: int):
    """Phase 23's matrices (phase 3's recipes at phase 23's sizes), from
    their own generators: every rank and the parent draw the same."""
    rng = np.random.default_rng([seed, 23, PW_MATRICES.index(name)])
    n = PW_ROWS[name]
    if name == "scale-free":
        return scale_free_triplets(rng, n, 8 * n)
    if name == "regular":
        return regular_triplets(rng, n)
    return block_triplets(rng, n)


def pw_inputs(seed: int, k: int, cols: int):
    """Scheme k's x (cols,) and X (cols, PW_BATCH), integer-valued f32."""
    rng = np.random.default_rng([seed, 23, 100 + k])
    return (rng.integers(-2, 3, cols).astype(np.float32),
            rng.integers(-2, 3, (cols, PW_BATCH)).astype(np.float32))


def pw_digest(y) -> str:
    import hashlib

    y = np.ascontiguousarray(y)
    return f"{y.dtype}{y.shape}:" + hashlib.sha256(y.tobytes()).hexdigest()


def pw_plans(sms: dict, meshes: dict, impl: str):
    """(name, matrix name, ExecutionPlan) of every phase-23 scheme, each
    through ``SparseMatrix.plan`` on ``meshes["1d"]`` or ``meshes["2d"]``
    (the ring through ``plan_from_partitioned`` over its bucketed
    partition).  The three merges of one equally-sized partition share
    it."""
    from repro_torch.api import plan_from_partitioned
    from repro_torch.core import distributed as D
    from repro_torch.core.partition import partition_1d_coalesced

    parts, out = {}, []
    mesh_of = meshes.__getitem__
    for name, mat, scheme, fmt, merge, ring in PW_SCHEMES:
        sm = sms[mat]
        key = (mat, scheme, fmt)
        if ring:  # bucketed from the 1D plan's partition of the same scheme
            mesh = mesh_of("1d")
            P = mesh.devices.size
            if key not in parts:
                parts[key] = partition_1d_coalesced(
                    *sm.triplets(), sm.shape, P, fmt, scheme.split(".", 1)[1])
            part_r, counts = D.bucket_by_source_shard(parts[key], P)
            out.append((name, mat, plan_from_partitioned(
                part_r, mesh, impl="torch", ring=True, ring_counts=counts,
                matrix=sm)))
            continue
        pln = sm.plan(scheme=scheme, fmt=fmt, merge=merge,
                      mesh=mesh_of(scheme[:2]), impl=impl)
        if key in parts:
            pln.part = parts[key]
        else:
            parts[key] = pln.part = pln._partition()
        out.append((name, mat, pln))
    return out


def pw_tile(torch, exe, x_full):
    """This rank's tile as a cuSPARSE CSR matrix and the x it reads (its
    kernel's input), for the rank's kernel, plain and library times."""
    from repro_torch.core import distributed as D

    prog, part = exe.program, exe.part
    view = exe.arrays
    if exe.plan.partitioning == "1d":
        xin = x_full
    else:  # variable-sized slices the whole x, the others their shard
        xin = prog.tile_x(x_full if part.scheme == "2d.variable-sized"
                          else exe._shard(x_full))
    flat = D._flat(view) if exe.plan.partitioning == "2d" else view
    n = int(flat["nnz"][0])
    ri, ci = flat["rowind"][0, :n].long(), flat["colind"][0, :n].long()
    vals = flat["values"][0, :n]
    if part.fmt in ("bcoo", "bcsr"):
        r, c = part.block
        ri = (ri[:, None, None] * r + torch.arange(r, device=ri.device)[:, None]
              ).expand(n, r, c).reshape(-1)
        ci = (ci[:, None, None] * c + torch.arange(c, device=ci.device)
              ).expand(n, r, c).reshape(-1)
        vals = vals.reshape(-1)
    A = torch.sparse_coo_tensor(torch.stack([ri, ci]), vals.float(),
                                (part.h_pad, xin.shape[0])).coalesce().to_sparse_csr()
    return flat, xin, A, n


def pw_rank_bound(part, n: int, x_len: int, batch: int) -> tuple:
    """(bound ms, bound_by) of one rank's tile: its n nonzeros (or blocks)
    with their indices, the x it reads and its y slice, each moved once, or
    its 2 flops a nonzero at 67 TFLOP/s."""
    if part.fmt in ("coo", "csr"):
        nbytes, nnz = n * (8 + 4), n
    else:
        r, c = part.block
        nbytes, nnz = n * (r * c * 4 + 8), n * r * c
    nbytes += (x_len + part.h_pad) * batch * 4
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = 2 * nnz * batch / F32_OPS_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def pw_matrices(seed: int) -> dict:
    from repro_torch.api import SparseMatrix

    sms = {}
    for mat in PW_MATRICES:
        ri, ci, vals, shape = pw_triplets(mat, seed)
        sms[mat] = SparseMatrix.from_parts(ri, ci, vals, shape)
    return sms


def pw_wait_turn(go: str, timeout: float) -> float:
    """Block until the parent posts ``go`` (its file holds "go", or
    "abort" where the parent failed); returns the seconds waited."""
    t0 = time.perf_counter()
    while True:
        if os.path.exists(go):
            with open(go) as f:
                word = f.read()
            if word == "abort":
                raise RuntimeError("the parent process failed before the "
                                   "ranks' turn on the card")
            if word == "go":
                return time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"no turn on the card within {timeout:.0f} s")
        time.sleep(0.05)


def pw_post_turn(go: str, word: str) -> None:
    with open(go + ".tmp", "w") as f:
        f.write(word)
    os.replace(go + ".tmp", go)


def pw_rank(world, seed: int, timed: int, sms=None, go=None,
            engine: bool = False) -> dict:
    """One rank of phase 23: every scheme through ``SparseMatrix.plan`` on
    a process mesh of the world, this rank's part on its device (the
    matrices built from ``seed``, or ``sms``).  The matrices and plans are
    built on the host; where ``go`` is a path, the ranks then wait for the
    parent's turn file before they touch the card, so nothing else runs
    there while they are counted and timed.  Returns the digests of its
    answers, its launches, its collectives' bytes and seconds by kind, its
    exe(x) latencies and, in a world of more than one, its tile's kernel,
    plain and cuSPARSE ms.  With ``engine``, phase 28 follows in the same
    world (:func:`pe_rank`)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.mesh import AXES_2D, AXIS_1D, world_mesh
    from repro_torch.kernels import instrument

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    P = world.size
    if P > 1:  # the ranks and the parent share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // P))
    R = int(np.sqrt(P))
    meshes = {"1d": world_mesh(world, (P,), (AXIS_1D,)),
              "2d": world_mesh(world, (R, P // R), AXES_2D)}
    sms = pw_matrices(seed) if sms is None else sms
    plans = pw_plans(sms, meshes, "cuda")  # every rank partitions the whole
    out = {"rank": world.rank, "transport": meshes["1d"].collectives.transport,
           "device": str(world.device), "setup_s": time.perf_counter() - t0,
           "wait_s": 0.0, "schemes": {}}
    if go is not None:
        out["wait_s"] = pw_wait_turn(go, PW_TURN_TIMEOUT_S)
        dist.barrier()
    t_card = time.perf_counter()
    for k, (name, mat, pln) in enumerate(plans):
        t1 = time.perf_counter()
        exe = pln.compile()
        compile_s = time.perf_counter() - t1
        kind = "coo" if pln.fmt in ("coo", "csr") else "bcoo"
        x, X = pw_inputs(seed, k, sms[mat].shape[1])
        coll = exe.collectives
        instrument.reset()
        dist.barrier()  # the ranks' compiles end apart: start together
        coll.reset()
        y = exe(x)
        b1 = coll.snapshot()
        coll.reset()
        Y = exe.batch(X)
        b8 = coll.snapshot()
        coll.reset()
        lat = []
        for _ in range(timed):
            dist.barrier()
            t1 = time.perf_counter()
            exe(x)
            lat.append(time.perf_counter() - t1)
        warm = coll.snapshot()  # the timed calls': a rank waits for the others too
        launches = instrument.launches(kind)
        row = {"scheme_id": pln.scheme_id, "grid": list(pln.grid),
               "coords": list(exe.mesh.coords), "compile_s": compile_s,
               "y": pw_digest(y), "Y": pw_digest(Y), "requests": 2 + timed,
               "launches": launches, "kernel": None if pln.ring else kind,
               "coll_b1": b1, "coll_b8": b8,
               "coll_ms": {k: 1e3 * v / timed for k, v in warm["seconds"].items()},
               "exe_ms": [1e3 * t for t in lat]}
        if not pln.ring and P > 1:
            # the rank's tile alone, one rank at a time on the shared card
            xd = torch.zeros(exe.x_pad, device=exe.device)
            xd[: len(x)] = torch.from_numpy(x).to(exe.device)
            flat, xin, A, n = pw_tile(torch, exe, xd)
            local = exe.program.local
            for r in range(P):
                if r == world.rank:
                    got = local.raw(flat, xin)
                    want = local.plain(flat, xin)
                    torch.cuda.synchronize()
                    row["kernel_equals_plain"] = bool(torch.equal(got, want))
                    row["kernel_ms"] = time_ms(torch, lambda: local.raw(flat, xin), 20)
                    row["plain_ms"] = time_ms(torch, lambda: local.plain(flat, xin),
                                              3, warmup=1)
                    row["library_ms"] = time_ms(torch, lambda: A @ xin, 10)
                    row["bound_ms"], row["bound_by"] = pw_rank_bound(
                        exe.part, n, xin.shape[0], 1)
                    row["tile_nnz"] = n
                dist.barrier()
        out["schemes"][name] = row
        del exe
        torch.cuda.empty_cache()
    if world.backend == "nccl":
        out["nccl_version"] = ".".join(map(str, torch.cuda.nccl.version()))
    out["card_s"] = time.perf_counter() - t_card
    if engine:
        out["engine"] = pe_rank(torch, world, seed, sms)
    out["total_s"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------------------
# phase 28: the engine, its tuner, sessions and the service over phase 23's
# world (rank 0 leads SpmvEngine(world=), the other ranks follow)
# ------------------------------------------------------------------------

# (name, matrix, partitioning, forced (fmt, merge) or None): each matrix
# registered 1D and 2D as the engine fits it (every 2D fit is (4, 1) at
# these shapes: C = 1, no merge), and two forced through plan= onto phase
# 23's (2, 2) equally-sized grid, so the ranks merge their partial rows
PE_REGS = tuple((f"{m}.{p}", m, p, None) for m in PW_MATRICES
                for p in ("1d", "2d")) + (
    ("regular.2x2", "regular", "2d", ("coo", "psum_scatter")),
    ("block.2x2", "block", "2d", ("bcoo", "psum")))
PE_MERGES = {"psum_scatter": "reduce-scatter", "psum": "all-reduce"}
PE_TIMED = 5  # multiplies timed a registration and width, after its checked two
PE_SESSION = ("scale-free.1d", 20)  # (registration, power steps)
PE_REFINE = "regular.2d"  # refined with the real Measurer
PE_CANDIDATES = 3
PE_REPLAY = 48  # requests of the service's replay
PE_MIX = {1: 0.6, 4: 0.25, 8: 0.15}
PE_TILES = ("scale-free.1d", "block.2d")  # rank 0's COO and block tiles


def pe_plan(forced):
    """The adaptive.Plan of a forced registration: 2D equally-sized on
    (2, 2) in ``forced`` = (fmt, merge); None lets the engine plan."""
    from repro_torch.core.adaptive import Plan

    if forced is None:
        return None
    return Plan("2d", "equally-sized", forced[0], forced[1], (2, 2),
                "phase 23's (2, 2) grid")


def pe_inputs(seed: int, k: int, cols: int):
    """Registration k's x (cols,) and X (cols, PW_BATCH), integer-valued."""
    rng = np.random.default_rng([seed, 28, k])
    return (rng.integers(-2, 3, cols).astype(np.float32),
            rng.integers(-2, 3, (cols, PW_BATCH)).astype(np.float32))


def pe_x0(seed: int, n: int):
    return np.random.default_rng([seed, 28, 99]).integers(1, 4, n).astype(np.float32)


def pe_timed(eng, name: str, x, n: int) -> list:
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        eng.multiply(name, x)
        lat.append(1e3 * (time.perf_counter() - t0))
    return lat


def pe_delta(coll, before: dict) -> dict:
    """The bytes a request moved on this rank, by kind (``coll`` counts)."""
    after = coll.snapshot()["bytes"]
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def pe_references(torch, sms: dict, device, seed: int, libs: dict) -> dict:
    """The parent's one-process 4-part engine (``devices=[card] * 4``) on
    phase 28's registrations and inputs: digests at B = 1 and 8, each
    checked against cuSPARSE, multiply p50s, and the power session's."""
    from repro_torch.engine import SpmvEngine

    t0 = time.perf_counter()
    eng = SpmvEngine(devices=[device] * PW_RANKS, impl="cuda",
                     cache_capacity=len(PE_REGS))
    refs = {}
    for k, (name, mat, part, forced) in enumerate(PE_REGS):
        eng.register(name, sms[mat], partitioning=part, plan=pe_plan(forced))
        x, X = pe_inputs(seed, k, sms[mat].shape[1])
        y, Y = eng.multiply(name, x), eng.multiply(name, X)
        lib_y = (libs[mat] @ torch.from_numpy(x).to(device)).cpu().numpy()
        lib_Y = (libs[mat] @ torch.from_numpy(X).to(device)).cpu().numpy()
        check(np.array_equal(y, lib_y) and np.array_equal(Y, lib_Y),
              f"world engine {name}: the one-process 4-part engine != cuSPARSE")
        check(not eng.plan_for(name).mesh.is_process,
              f"world engine {name}: devices= made a process mesh")
        refs[name] = {"scheme_id": eng.registry.get(name).plan.tag,
                      "grid": list(eng.registry.get(name).plan.grid),
                      "y": pw_digest(y), "Y": pw_digest(Y),
                      "ms_b1": statistics.median(pe_timed(eng, name, x, PE_TIMED)),
                      "ms_b8": statistics.median(pe_timed(eng, name, X, PE_TIMED))}
    name, steps = PE_SESSION
    n = sms[name.split(".")[0]].shape[0]
    r = eng.solve(name, pe_x0(seed, n), steps=steps, combine="power")
    refs["session"] = {"x": pw_digest(r.x), "steps": r.steps}
    eng.close()
    refs["seconds"] = time.perf_counter() - t0
    return refs


def pe_tile(torch, exe, x, name: str) -> dict:
    """Rank 0's tile of ``exe`` alone: its kernel, plain and cuSPARSE ms
    and its bound (phase 23's measures)."""
    xd = torch.zeros(exe.x_pad, device=exe.device)
    xd[: len(x)] = torch.from_numpy(x).to(exe.device)
    flat, xin, A, n = pw_tile(torch, exe, xd)
    local = exe.program.local
    got, want = local.raw(flat, xin), local.plain(flat, xin)
    torch.cuda.synchronize()
    bound, by = pw_rank_bound(exe.part, n, xin.shape[0], 1)
    return {"registration": name, "kernel": local.scalar and "coo_spmv" or "bcoo_spmv",
            "equals_plain": bool(torch.equal(got, want)),
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "kernel_ms": time_ms(torch, lambda: local.raw(flat, xin), 20),
            "plain_ms": time_ms(torch, lambda: local.plain(flat, xin), 3, warmup=1),
            "library_ms": time_ms(torch, lambda: A @ xin, 10),
            "bound_ms": bound, "bound_by": by, "tile_nnz": n}


def pe_lead(torch, eng, world, seed: int, sms: dict) -> dict:
    """Rank 0 of phase 28: registrations answered at B = 1 and 8 and timed,
    the power session and a refinement with the real Measurer, every one
    led through the world's control channel."""
    from repro_torch.tune import CandidateGenerator, Measurer, Tuner

    out, inputs = {"regs": {}}, {}
    for k, (name, mat, part, forced) in enumerate(PE_REGS):
        t0 = time.perf_counter()
        entry = eng.register(name, sms[mat], partitioning=part,
                             plan=pe_plan(forced))
        register_s = time.perf_counter() - t0
        exe = eng.plan_for(name).executor
        check(exe.mesh.is_process and exe.control is not None,
              f"world engine {name}: not led over the world's process mesh")
        x, X = pe_inputs(seed, k, sms[mat].shape[1])
        inputs[name] = x
        coll = exe.collectives
        before = coll.snapshot()["bytes"]
        y = eng.multiply(name, x)
        b1 = pe_delta(coll, before)
        before = coll.snapshot()["bytes"]
        Y = eng.multiply(name, X)
        b8 = pe_delta(coll, before)
        out["regs"][name] = {
            "scheme_id": entry.plan.tag, "grid": list(entry.plan.grid),
            "y": pw_digest(y), "Y": pw_digest(Y), "register_s": register_s,
            "build_split": exe.build_split, "nnz": sms[mat].nnz,
            "bytes_b1": b1, "bytes_b8": b8,
            "ms_b1": pe_timed(eng, name, x, PE_TIMED),
            "ms_b8": pe_timed(eng, name, X, PE_TIMED),
            "coll_s": eng.telemetry.collectives(name)}
    name, steps = PE_SESSION
    n = sms[name.split(".")[0]].shape[0]
    t0 = time.perf_counter()
    r = eng.solve(name, pe_x0(seed, n), steps=steps, combine="power")
    out["session"] = {"x": pw_digest(r.x), "steps": r.steps,
                      "seconds": time.perf_counter() - t0}
    eng._tuner = Tuner(generator=CandidateGenerator(max_candidates=PE_CANDIDATES),
                       measurer=Measurer(warmup=1, iters=3))
    t0 = time.perf_counter()
    ev = eng.refine(PE_REFINE, x=inputs[PE_REFINE])
    out["refine"] = {k: ev[k] for k in ("incumbent", "winner", "winner_impl",
                                        "incumbent_s", "winner_s", "swapped",
                                        "candidates")}
    out["refine"]["seconds"] = time.perf_counter() - t0
    out["refine"]["y"] = pw_digest(eng.multiply(PE_REFINE, inputs[PE_REFINE]))
    out["refine"]["process"] = eng.plan_for(PE_REFINE).mesh.is_process

    return out


def pe_replay(torch, eng, world, seed: int, sms: dict) -> dict:
    """Rank 0 of phase 28: the service's replay of PE_REPLAY requests over
    the 1D registrations, cuSPARSE the oracles; the service's close closes
    the engine (and releases the ranks that follow)."""
    from repro_torch.serve import AsyncSpmvService, WorkloadSpec, generate_trace, replay

    names = tuple(n for n, _, p, _ in PE_REGS if p == "1d")
    spec = WorkloadSpec(names=names, tenants=("t0", "t1"), n_requests=PE_REPLAY,
                        seed=seed, zipf_alpha=1.1, rate_rps=200.0,
                        batch_mix=PE_MIX, integer_values=True)
    oracles = {n: library_csr(torch, sms[n.split(".")[0]], world.device)
               for n in names}
    svc = AsyncSpmvService(eng, workers=3)

    async def run():
        async with svc:
            return await bounded(replay(svc, generate_trace(spec), oracles=oracles,
                                        integer_values=True))

    rep = asyncio.run(run())
    return {"requests": rep.requests, "completed": rep.completed,
            "lost": rep.lost, "errors": rep.errors, "rejected": rep.rejected,
            "verified": rep.verified, "bitexact": rep.bitexact,
            "latency": rep.latency, "wall_s": rep.wall_s,
            "throughput_rps": rep.throughput_rps,
            "engine_closed": world.control.closed}


def pe_rank(torch, world, seed: int, sms: dict) -> dict:
    """One rank of phase 28, in phase 23's world after its schemes: every
    rank opens ``SpmvEngine(world=, impl="cuda")``; rank 0 leads
    (:func:`pe_lead`), the others follow until it closes the engine.
    Returns the rank's launches and the requests it ran (calls, and the
    session's steps), and on rank 0 what it led and its tile times."""
    import torch.distributed as dist

    from repro_torch.engine import SpmvEngine
    from repro_torch.kernels import instrument

    dist.barrier()
    t0 = time.perf_counter()
    instrument.reset()
    eng = SpmvEngine(world=world, impl="cuda", cache_capacity=len(PE_REGS) + 2)
    ctl = world.control
    out = {"rank": world.rank, "open_s": time.perf_counter() - t0}
    if world.rank != 0:
        out["commands"] = eng.follow()
        out["requests"] = ctl.served["call"] + ctl.session_steps
    else:
        try:
            out.update(pe_lead(torch, eng, world, seed, sms))
            # rank 0's tiles timed alone (the others idle in follow()),
            # their launches kept out of the path's count
            counted = {k: instrument.launches(k) for k in ("coo", "bcoo")}
            out["tiles"] = [pe_tile(torch, eng.plan_for(n).executor,
                                    pe_inputs(seed, [r[0] for r in PE_REGS].index(n),
                                              sms[n.split(".")[0]].shape[1])[0], n)
                            for n in PE_TILES]
            instrument.reset()
            out["replay"] = pe_replay(torch, eng, world, seed, sms)
            out["requests"] = ctl.sent["call"] + ctl.session_steps
            out["launches"] = {k: counted[k] + instrument.launches(k)
                               for k in counted}
            out["sent_bytes"] = dict(ctl.sent_bytes)
        finally:
            eng.close()
    out.setdefault("launches", {k: instrument.launches(k) for k in ("coo", "bcoo")})
    out["seconds"] = time.perf_counter() - t0
    del eng
    torch.cuda.empty_cache()
    return out


def pe_checks(torch, ranks: list, refs: dict, pw_rows: dict, card: str) -> dict:
    """Phase 28's checks and rows, in the parent, from the ranks' results
    and its one-process engine's references."""
    lead = ranks[0]["engine"]
    launches = {"coo": 0, "bcoo": 0}
    for r in ranks:
        e = r["engine"]
        got = e["launches"]["coo"] + e["launches"]["bcoo"]
        check(got == e["requests"],
              f"world engine: rank {e['rank']} launched {got} kernels for "
              f"{e['requests']} requests")
        for k in launches:
            launches[k] += e["launches"][k]
    for name, _, _, forced in PE_REGS:
        got, ref = lead["regs"][name], refs[name]
        check(got["scheme_id"] == ref["scheme_id"] and got["grid"] == ref["grid"],
              f"world engine {name}: planned {got['scheme_id']} on {got['grid']}, "
              f"the one-process engine {ref['scheme_id']} on {ref['grid']}")
        if forced is not None:  # the ranks scatter x's halves and merge
            merge = PE_MERGES[forced[1]]
            check(got["grid"] == [2, 2] and all(
                b.get("scatter", 0) > 0 and b.get(merge, 0) > 0
                for b in (got["bytes_b1"], got["bytes_b8"])),
                f"world engine {name}: on {got['grid']}, no scatter or "
                f"{merge} ({got['bytes_b1']}, {got['bytes_b8']})")
        check(got["y"] == ref["y"] and got["Y"] == ref["Y"],
              f"world engine {name}: y != the one-process engine and cuSPARSE")
        split = got["build_split"]
        # the same matrix's scheme on the same grid (phase 23's 2D is (2, 2))
        same = [row for row in pw_rows if row["scheme_id"] == got["scheme_id"]
                and row["nnz"] == got["nnz"] and (
                    got["scheme_id"].startswith("1d") or got["grid"] == [2, 2])]
        emit({"phase": "world_engine", "registration": name,
              "scheme_id": got["scheme_id"], "grid": got["grid"], "nnz": got["nnz"],
              "register_s": got["register_s"], "build_split": split,
              # design B (send the matrix, every rank partitions): its bytes,
              # and its host time at this run's partition time and send rate
              "send_matrix_bytes": (PW_RANKS - 1) * got["nnz"] * 12,
              "send_matrix_host_s_est": split["partition_s"] + (
                  (PW_RANKS - 1) * got["nnz"] * 12 * split["send_s"]
                  / max(split["sent_bytes"], 1)),
              "multiply_ms_p50_b1": statistics.median(got["ms_b1"]),
              "multiply_ms_p50_b8": statistics.median(got["ms_b8"]),
              "one_process_ms_p50_b1": ref["ms_b1"],
              "one_process_ms_p50_b8": ref["ms_b8"],
              "exe_ms_p50_phase23": (same[0]["exe_ms_p50"] if same else None),
              "bytes_b1": got["bytes_b1"], "bytes_b8": got["bytes_b8"],
              "collective_s": got["coll_s"], "card": card})
    check({k: lead["session"][k] for k in ("x", "steps")} == refs["session"],
          f"world engine: the {PE_SESSION[1]}-step power session != the "
          f"one-process engine's ({lead['session']} vs {refs['session']})")
    ref_y = refs[PE_REFINE]["y"]
    check(lead["refine"]["y"] == ref_y and lead["refine"]["process"],
          f"world engine: the refined {PE_REFINE} ({lead['refine']['winner']}) "
          "!= the one-process engine")
    rep = lead["replay"]
    check(rep["lost"] == 0 and rep["errors"] == 0
          and rep["bitexact"] == rep["completed"] == rep["requests"]
          and rep["engine_closed"], f"world engine replay: {rep}")
    for t in lead["tiles"]:
        check(t["equals_plain"], f"world engine {t['registration']}: rank 0's "
              "tile kernel != its plain version")
    emit({"phase": "world_engine_done", "session": lead["session"],
          "refine": lead["refine"], "replay": rep, "tiles": lead["tiles"],
          "launches": launches, "sent_bytes": lead["sent_bytes"],
          "rank_seconds": [r["engine"]["seconds"] for r in ranks],
          "rank_open_s": [r["engine"]["open_s"] for r in ranks],
          "reference_s": refs["seconds"], "card": card})
    return {"launches": launches, "tiles": lead["tiles"],
            "seconds": max(r["engine"]["seconds"] for r in ranks)}


def phase_process_mesh(torch, seed: int, device) -> dict:
    """Phase 23: the partitioned schemes with one rank per part.

    The card is used by one path at a time: while the 4 gloo ranks build
    their matrices and plans on the host, this process builds the
    one-process plans they answer to and then runs (b), its own world of
    one over NCCL; only then does it post the ranks' turn, and it touches
    the card no more until they are done.  Each path's launch counts and
    times are its own."""
    from concurrent.futures import ThreadPoolExecutor

    import tempfile

    from repro_torch.core.mesh import AXES_2D, AXIS_1D, make_mesh
    from repro_torch.core.world import close_world, init_world, spawn

    t_start = time.perf_counter()
    pool = ThreadPoolExecutor(1)
    tmp = tempfile.mkdtemp(prefix="phase23_")
    go = os.path.join(tmp, "turn")
    turn = "abort"
    try:
        card = f"cuda:{device.index or 0}" if device.type == "cuda" else "cpu"
        gloo = pool.submit(spawn, pw_rank, PW_RANKS, "gloo", card,
                           (seed, PW_TIMED, None, go, True), 600)
        sms, refs = pw_matrices(seed), {}
        meshes = {"1d": make_mesh((PW_RANKS,), (AXIS_1D,), [device] * PW_RANKS),
                  "2d": make_mesh((2, 2), AXES_2D, [device] * PW_RANKS)}
        libs = {mat: library_csr(torch, sm, device) for mat, sm in sms.items()}
        for k, (name, mat, pln) in enumerate(pw_plans(sms, meshes, "cuda")):
            exe = pln.compile()
            x, X = pw_inputs(seed, k, sms[mat].shape[1])
            y, Y = exe(x), exe.batch(X)
            lib_y = (libs[mat] @ torch.from_numpy(x).to(device)).cpu().numpy()
            lib_Y = (libs[mat] @ torch.from_numpy(X).to(device)).cpu().numpy()
            check(np.array_equal(y, lib_y) and np.array_equal(Y, lib_Y),
                  f"process mesh {name}: the one-process 4-part plan != cuSPARSE")
            refs[name] = {"scheme_id": pln.scheme_id, "y": pw_digest(y),
                          "Y": pw_digest(Y), "nnz": sms[mat].nnz,
                          "shape": list(sms[mat].shape)}
            del exe
        pe_refs = pe_references(torch, sms, device, seed, libs)  # phase 28's
        del libs
        free_card(torch)
        ref_s = time.perf_counter() - t_start
        # (b) this process as the one rank of an NCCL world, after the
        # references and before the gloo ranks' turn
        t0 = time.perf_counter()
        world = init_world("nccl", 0, 1, os.path.join(tmp, "store"), device=card)
        try:
            solo = pw_rank(world, seed, 1, sms)
        finally:
            close_world()
        nccl_s = time.perf_counter() - t0
        del sms
        free_card(torch)
        turn = "go"
        t_turn = time.perf_counter()
    finally:
        pw_post_turn(go, turn)  # "abort": the ranks fail at their turn
        if turn != "go":
            pool.shutdown(wait=True)
            shutil.rmtree(tmp, ignore_errors=True)
    try:
        ranks = gloo.result()
        ranks_s = time.perf_counter() - t_turn
    finally:
        pool.shutdown(wait=True)
        shutil.rmtree(tmp, ignore_errors=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    launches = {"coo": 0, "bcoo": 0}
    rows = []
    for name, *_ in PW_SCHEMES:
        ref = refs[name]
        per = [r["schemes"][name] for r in ranks]
        for r, row in zip(ranks, per):
            check(row["y"] == ref["y"] and row["Y"] == ref["Y"],
                  f"process mesh {name}: rank {r['rank']}'s y != the one-process "
                  "4-part plan and cuSPARSE")
            check(row["scheme_id"] == ref["scheme_id"],
                  f"process mesh {name}: rank {r['rank']} planned "
                  f"{row['scheme_id']}, the one-process plan {ref['scheme_id']}")
            want = 0 if row["kernel"] is None else row["requests"]
            check(row["launches"] == want,
                  f"process mesh {name}: rank {r['rank']} launched "
                  f"{row['launches']} kernels for {row['requests']} requests")
            if row["kernel"] is not None:
                launches[row["kernel"]] += row["launches"]
                check(row["kernel_equals_plain"],
                      f"process mesh {name}: rank {r['rank']}'s kernel != its "
                      "plain version")
        one = solo["schemes"][name]
        check(one["y"] == ref["y"] and one["Y"] == ref["Y"],
              f"process mesh {name}: NCCL at world size 1 != cuSPARSE")
        want = 0 if one["kernel"] is None else one["requests"]
        check(one["launches"] == want,
              f"process mesh {name}: NCCL's rank launched {one['launches']} "
              f"kernels for {one['requests']} requests")
        exe_ms = [t for row in per for t in row["exe_ms"]]
        rec = {"phase": "process_mesh", "scheme": name,
               "scheme_id": ref["scheme_id"], "matrix_shape": ref["shape"],
               "nnz": ref["nnz"], "transport": ranks[0]["transport"],
               "ranks": PW_RANKS, "exe_ms_p50": statistics.median(exe_ms),
               "card": card,
               "rank_rows": [{k: row.get(k) for k in (
                   "coords", "tile_nnz", "kernel_ms", "plain_ms", "library_ms",
                   "bound_ms", "bound_by", "launches", "requests", "compile_s")}
                   | {"coll_ms": row["coll_ms"],
                      "coll_bytes_b1": row["coll_b1"]["bytes"],
                      "coll_bytes_b8": row["coll_b8"]["bytes"]}
                   for row in per],
               "nccl_world_1": {"grid": one["grid"], "launches": one["launches"],
                                "exe_ms": one["exe_ms"]},
               "answers": "every rank bit-equal to the one-process plan and "
                          "cuSPARSE, B=1 and B=8; NCCL at world size 1 too"}
        emit(rec)
        rows.append(rec)
    engine = pe_checks(torch, ranks, pe_refs, rows, card)
    seconds = time.perf_counter() - t_start
    emit({"phase": "process_mesh_done", "seconds": seconds,
          "world_engine_s": engine["seconds"],
          "reference_s": ref_s, "nccl_world_1_s": nccl_s,
          "gloo_turn_s": ranks_s,
          "rank_setup_s": [r["setup_s"] for r in ranks],
          "rank_wait_s": [r["wait_s"] for r in ranks],
          "rank_card_s": [r["card_s"] for r in ranks],
          "rank_total_s": [r["total_s"] for r in ranks],
          "nccl_version": solo.get("nccl_version"), "launches": launches,
          "card": card})
    return {"seconds": seconds, "launches": launches, "rows": rows,
            "engine": engine}


# ------------------------------------------------------------------------
# phase 24: the LMs over a process mesh (4 gloo ranks on the card)
# ------------------------------------------------------------------------

PM_RANKS = 4
PM_QWEN_MESH, PM_DS_MESH = (1, 4), (2, 2)
PM_DS_ARCH = "deepseek-v3-671b"
# tokens a generate (qwen's 32 until phase 28: cut to pay for it)
PM_GEN = {"qwen": 16, "deepseek": 8}
PM_F32_LAYERS = 2  # the f32 cut of qwen held against the one-process port
PM_LOGIT_TOL = 1e-5  # of max |logit|: f32, 2 layers, sums in another order
PM_MARGIN = 1e-3  # f32 greedy tokens compared where the top-2 margin exceeds it
PM_BF16_MARGIN = 0.02  # bf16: where it exceeds this share of the max |logit|
# a token check compares at least this share of its positions (past the
# margin), so that it cannot pass comparing nothing
PM_MIN_CHECKED = 0.25
PM_TURN_TIMEOUT_S = 300
PM_TIMED = 10  # launches of a rank's slice timed, one rank at a time


def pm_configs() -> dict:
    """The configs phase 24 runs: qwen1.5-0.5b at full width and depth, dense
    and sparse; its f32 cuts; deepseek-v3 at full width cut to 2 layers (1
    dense MLA prefix layer with its sparse FFN, 1 MLA + MoE repeat; MTP
    built), ffn_density 0.5."""
    from repro_torch.configs import get_config

    qwen = get_config(LM_ARCH)
    sparse = dataclasses.replace(qwen, ffn_density=0.5)
    ds = dataclasses.replace(moe_cut(get_config(PM_DS_ARCH), 2), ffn_density=0.5)
    return {"qwen_dense": qwen, "qwen_sparse": sparse,
            "qwen_dense_f32": dataclasses.replace(qwen, n_layers=PM_F32_LAYERS),
            "qwen_sparse_f32": dataclasses.replace(sparse, n_layers=PM_F32_LAYERS),
            "deepseek": ds}


def pm_inputs(seed: int, cfg, gen: int):
    """(prompts (B, S) int32, teacher tokens (gen, B, 1) int32) of a path."""
    rng = np.random.default_rng([seed, 24, cfg.n_layers, cfg.vocab])
    prompts = rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, (gen, LM_BATCH, 1)).astype(np.int32)
    return prompts, steps


def pm_greedy(torch, lm, params, cfg, prompts, n: int, max_len: int) -> tuple:
    """Greedy tokens (B, n) of the one-process port and each position's
    top-2 logit margin (f32 params: absolute; bf16: as a share of the
    position's max |logit|), its prefill and decode steps run as Server
    runs them."""
    toks = torch.from_numpy(prompts).to(params["embed"]["emb"].device)
    out, margins = [], []
    with torch.no_grad():
        logits, caches = lm.prefill(params, toks, cfg, max_len)
        for i in range(n):
            lf = logits.float()
            top = torch.topk(lf, 2, dim=-1).values
            margin = top[:, 0] - top[:, 1]
            if logits.dtype != torch.float32:
                margin = margin / lf.abs().amax(-1)
            margins.append(margin.cpu().numpy())
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            out.append(tok.cpu().numpy())
            if i + 1 < n:
                logits, caches = lm.decode_step(params, tok, caches, cfg)
    return np.concatenate(out, 1), np.stack(margins, 1)


def pm_teacher(torch, lm, params, cfg, prompts, steps, max_len: int) -> list:
    """Logits (f32 numpy) of a prefill and of decode steps fed ``steps``."""
    device = params["embed"]["emb"].device
    with torch.no_grad():
        return pr_teacher(torch, (lambda t: lm.prefill(params, t, cfg, max_len),
                                  lambda t, c: lm.decode_step(params, t, c, cfg)),
                          prompts, steps, device)


def pm_token_agreement(got, want, margins, margin: float) -> dict:
    """Tokens of a mesh run against the one-process port's, position by
    position while every earlier position agreed, where the one-process
    top-2 margin exceeds ``margin`` (a row stops at its first position
    below it: past it the two runs may feed different tokens)."""
    checked = agree = 0
    for b in range(want.shape[0]):
        for i in range(want.shape[1]):
            if margins[b, i] <= margin:
                break
            checked += 1
            if got[b, i] != want[b, i]:
                break
            agree += 1
    return {"checked": checked, "agree": agree, "positions": int(want.size),
            "margin": margin}


def pm_references(torch, seed: int, device, ref: dict) -> dict:
    """The one-process port's answers, before the ranks take the card:
    each path's greedy tokens and margins and the f32 cuts' logits, into
    ``ref``."""
    from repro_torch.launch.serve import Server
    from repro_torch.models import lm
    from repro_torch.models import moe as M

    cfgs, info = pm_configs(), {}
    for key in ("qwen_dense", "qwen_sparse", "deepseek"):
        cfg = cfgs[key]
        gen = PM_GEN["deepseek" if key == "deepseek" else "qwen"]
        prompts, _ = pm_inputs(seed, cfg, gen)
        with M.dispatch_log() as log:
            srv = Server(cfg, LM_PROMPT + gen, device=device)
            toks, margins = pm_greedy(torch, lm, srv.params, cfg, prompts, gen,
                                      LM_PROMPT + gen)
        ref[f"{key}|tokens"], ref[f"{key}|margins"] = toks, margins
        info[key] = {"dropped": sum(r["dropped"] for r in log)}
        del srv
        free_card(torch)
    for key in ("qwen_dense_f32", "qwen_sparse_f32"):
        cfg = cfgs[key]
        prompts, steps = pm_inputs(seed, cfg, 3)
        srv = Server(cfg, LM_PROMPT + 4, device=device, dtype=torch.float32)
        for i, lg in enumerate(pm_teacher(torch, lm, srv.params, cfg, prompts, steps,
                                          LM_PROMPT + 4)):
            ref[f"{key}|logits{i}"] = lg
        toks, margins = pm_greedy(torch, lm, srv.params, cfg, prompts, 4,
                                  LM_PROMPT + 4)
        ref[f"{key}|tokens"], ref[f"{key}|margins"] = toks, margins
        del srv
        free_card(torch)
    return info


def pm_time_generate(torch, srv, prompts, gen: int, coll, instrument) -> dict:
    """Server.generate once short (warm-up, its MoE drops logged: the
    prefill is the counted run's), then the counted run: ``gen`` tokens,
    counts reset before it, its prefill and decode steps timed by
    ``generate(timings=)``."""
    import torch.distributed as dist

    from repro_torch.models import moe as M

    with M.dispatch_log() as log:
        srv.generate(prompts, 2)
    dist.barrier()
    instrument.reset()
    coll.reset()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    out = srv.generate(prompts, gen, timings=timings)
    snap = coll.snapshot()
    total_s = timings["prefill_s"] + timings["decode_s"]
    return {"tokens": out, "dropped": sum(r["dropped"] for r in log),
            "prefill_ms": 1e3 * timings["prefill_s"],
            "decode_ms_per_token": 1e3 * timings["decode_s"] / max(gen - 1, 1),
            "tokens_per_s": LM_BATCH * gen / total_s, "generate_s": total_s,
            "launches": instrument.launches("bcoo"),
            "coll_calls": snap["calls"], "coll_bytes": snap["bytes"],
            "coll_ms": {k: 1e3 * v for k, v in snap["seconds"].items()},
            "peak_allocated_bytes": torch.cuda.max_memory_allocated()}


def pm_decode_agreement(torch, srv, prompts, ref_tokens, ref_margins) -> dict:
    """The mesh's decode steps fed the one-process port's tokens (teacher
    forcing, so every position sees the one-process run's inputs, whatever
    an earlier position's argmax was), their argmax against the
    one-process tokens where its margin exceeds PM_BF16_MARGIN of the max
    |logit|, and the assignments the decode steps dropped.  deepseek's MoE
    is its last layer, so no cache depends on the prefill's drops (which
    differ by design, G = 2 against 1): the decode steps see the same
    inputs in both runs."""
    from repro_torch.core import sharding as SH
    from repro_torch.models import lm
    from repro_torch.models import moe as M

    toks = torch.from_numpy(prompts).to(srv.device)
    B, n = ref_tokens.shape
    checked = agree = 0
    with torch.no_grad(), SH.set_mesh(srv.mesh):
        _, caches = lm.prefill(srv.params, toks, srv.cfg, srv.max_len)
        with M.dispatch_log() as log:
            for i in range(1, n):
                tok = torch.from_numpy(ref_tokens[:, i - 1:i].copy()).to(srv.device)
                logits, caches = lm.decode_step(srv.params, tok, caches, srv.cfg)
                with SH.batch_scope(B):
                    pred = SH.batch_unshard(torch.argmax(logits, -1)).cpu().numpy()
                ok = ref_margins[:, i] > PM_BF16_MARGIN
                checked += int(ok.sum())
                agree += int((ok & (pred == ref_tokens[:, i])).sum())
    return {"checked": checked, "agree": agree, "positions": B * (n - 1),
            "margin": PM_BF16_MARGIN, "decode_dropped": sum(r["dropped"] for r in log),
            "teacher_forced": True}


def pm_param_bytes(params) -> int:
    from repro_torch.sparse.layers import strip_derived
    from repro_torch.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(strip_derived(params)))


def pm_serve(torch, world, key: str, seed: int, ref) -> dict:
    """One serving path on this rank: Server(mesh=) of the path's config,
    its generate timed and counted, its tokens against the one-process
    port's."""
    import torch.distributed as dist

    from repro_torch.core import sharding as SH
    from repro_torch.kernels import instrument
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import Server

    cfg = pm_configs()[key]
    arch = "deepseek" if key == "deepseek" else "qwen"
    shape = PM_DS_MESH if arch == "deepseek" else PM_QWEN_MESH
    gen = PM_GEN[arch]
    mesh = make_local_mesh(shape[1], world=world)
    t0 = time.perf_counter()
    srv = Server(cfg, LM_PROMPT + gen, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts, _ = pm_inputs(seed, cfg, gen)
    row = pm_time_generate(torch, srv, prompts, gen, SH.collectives(mesh), instrument)
    row.update(key=key, arch=cfg.name, mesh=list(shape), coords=list(mesh.coords),
               transport=SH.collectives(mesh).transport,
               pinned=getattr(SH.collectives(mesh), "pinned", None),
               n_layers=cfg.n_layers, init_s=init_s,
               param_bytes=pm_param_bytes(srv.params))
    row["tokens_vs_one_process"] = pm_decode_agreement(
        torch, srv, prompts, ref[f"{key}|tokens"], ref[f"{key}|margins"])
    del srv
    free_card(torch)
    dist.barrier()
    return row


def pm_f32(torch, world, key: str, seed: int, ref) -> dict:
    """The f32 2-layer cut on (1, 4): each rank's prefill and decode logits
    against the one-process port's, and its greedy tokens."""
    import torch.distributed as dist

    from repro_torch.core import sharding as SH
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import Server
    from repro_torch.models import lm

    cfg = pm_configs()[key]
    mesh = make_local_mesh(PM_QWEN_MESH[1], world=world)
    srv = Server(cfg, LM_PROMPT + 4, mesh=mesh, dtype=torch.float32)
    prompts, steps = pm_inputs(seed, cfg, 3)
    with SH.set_mesh(mesh):
        got = pm_teacher(torch, lm, srv.params, cfg, prompts, steps, LM_PROMPT + 4)
    err = max(float(np.abs(g - ref[f"{key}|logits{i}"]).max()
                    / np.abs(ref[f"{key}|logits{i}"]).max())
              for i, g in enumerate(got))
    toks = srv.generate(prompts, 4)
    del srv
    free_card(torch)
    dist.barrier()
    return {"key": key, "rel_err": err,
            "tokens": pm_token_agreement(toks, ref[f"{key}|tokens"],
                                         ref[f"{key}|margins"], PM_MARGIN)}


def pm_slices(torch, world, seed: int) -> dict:
    """This rank's runs of qwen's three sparse projections (layer 0 of the
    sparse model), on integer-valued values and x at T = 4 and 512, bf16:
    the rank's kernel through ``sparse_linear_apply`` on the mesh (its run,
    then the all-gather) bit-equal to the plain version of the whole
    stream; then, one rank at a time, its run's kernel, plain version and
    ``torch.matmul`` on its dense rows timed."""
    import torch.distributed as dist

    from repro_torch.core import sharding as SH
    from repro_torch.kernels import instrument
    from repro_torch.kernels.bcsr_spmv import bcoo_spmv, bcoo_spmv_plain
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sparse.layers import (_balanced_pattern, sparse_linear_apply,
                                           stream_layout, with_run)

    cfg = pm_configs()["qwen_sparse"]
    mesh = make_local_mesh(PM_QWEN_MESH[1], world=world)
    device = mesh.device
    r, c = cfg.sparse_block
    rng = np.random.default_rng([seed, 24, world.rank])
    gen = np.random.default_rng([seed, 24, 99])  # the same on every rank
    out = {"equal": True, "rows": []}
    for name, (d_in, d_out) in ffn_dims(cfg).items():
        browind, bcolind = _balanced_pattern(d_out // r, d_in // c, cfg.ffn_density)
        nb = len(browind)
        full = {"browind": torch.from_numpy(browind).to(device),
                "bcolind": torch.from_numpy(bcolind).to(device),
                "bvalues": torch.from_numpy(gen.integers(-3, 4, (nb, r, c))
                                            .astype(np.float32)).to(device, torch.bfloat16)}
        nb_l = nb // mesh.devices.shape[1]
        m = mesh.coords[1]
        run = {k: v[m * nb_l:(m + 1) * nb_l] for k, v in full.items()}
        rows, lo, merge = stream_layout(nb_l, d_in, d_out, (r, c), cfg.ffn_density, mesh)
        local = with_run(run, d_in, d_out, cfg.ffn_density, mesh)
        for T in MOE_TOKENS[::-1]:
            x = torch.from_numpy(gen.integers(-3, 4, (T, d_in)).astype(np.float32)
                                 ).to(device, torch.bfloat16)
            with SH.set_mesh(mesh):
                y = sparse_linear_apply(local, x, d_out)
            want = bcoo_spmv_plain(full["browind"], full["bcolind"], full["bvalues"],
                                   x.T.contiguous(), d_out).to(torch.bfloat16).T
            out["equal"] &= bool(torch.equal(y, want))
            xt = x.T.contiguous()
            lb = (local["browind"] - lo).contiguous()
            dense = densified(torch, {"browind": lb, "bcolind": local["bcolind"],
                                      "bvalues": local["bvalues"]}, d_in, rows * r)
            row = {"name": name, "T": T, "nb": nb_l, "block_rows": rows,
                   "merge": merge}
            for rank in range(world.size):
                if rank == world.rank:
                    kern = lambda: bcoo_spmv(lb, local["bcolind"], local["bvalues"], xt,
                                             rows * r, browptr=local["browptr"])
                    torch.cuda.synchronize()
                    got, plain = kern(), bcoo_spmv_plain(lb, local["bcolind"],
                                                          local["bvalues"], xt, rows * r)
                    torch.cuda.synchronize()
                    row["kernel_equals_plain"] = bool(torch.equal(got, plain))
                    row["max_abs_err"] = max_err(torch, got, plain)
                    instrument.reset()
                    row["ms"] = time_ms(torch, kern, PM_TIMED)
                    row["timed_launches"] = instrument.launches("bcoo")
                    row["plain_ms"] = time_ms(torch, lambda: bcoo_spmv_plain(
                        lb, local["bcolind"], local["bvalues"], xt, rows * r), 2,
                        warmup=1)
                    row["library_ms"] = time_ms(torch, lambda: dense @ xt, PM_TIMED)
                    row["bound_ms"], row["bound_by"] = lm_bound(
                        nb_l, r, c, rows, d_in, rows * r, T)
                dist.barrier()
            out["rows"].append(row)
            del dense
        free_card(torch)
    return out


def pm_rank(world, seed: int, go: str, ref_path: str, phases=(24, 25, 26, 27)) -> dict:
    """One rank of phases 24-27: waits for the parent's turn, then runs
    every path of ``phases`` on its device, one path at a time for all
    ranks."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    if world.size > 1:  # the ranks and the parent share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world.size))
    from repro_torch.kernels import _build  # noqa: F401  (the built sources)
    if world.device.type == "cuda":
        # the rank's CUDA context, cuBLAS handle and the init's and the
        # model's kernels loaded while the parent runs its references (a
        # reduced model's init and prefill): loaded in the ranks' turns of
        # the first path's seeded init, they took 11.2 s of it (PERF.md
        # section 4)
        from repro_torch.configs import get_config
        from repro_torch.models import lm

        small = get_config(LM_ARCH).reduced()
        with torch.no_grad():
            gen = torch.Generator(device=world.device).manual_seed(0)
            params = lm.init_params(gen, small)
            toks = torch.zeros((1, 8), dtype=torch.int32, device=world.device)
            float(lm.prefill(params, toks, small, 8)[0].float().sum())
        del params, toks
    out = {"rank": world.rank, "setup_s": time.perf_counter() - t0}
    out["wait_s"] = pw_wait_turn(go, PM_TURN_TIMEOUT_S)
    dist.barrier()
    with np.load(ref_path) as z:
        ref = dict(z)
    t_card = time.perf_counter()

    def step(name, fn, *args):
        """Run one path; rank 0 prints its seconds and this process's card
        memory before it (a failed path still leaves the earlier lines)."""
        reserved = torch.cuda.memory_reserved() if torch.cuda.is_available() else 0
        t1 = time.perf_counter()
        res = fn(torch, world, *args)
        if world.rank == 0:
            emit({"phase": "lm_mesh_progress", "path": name,
                  "seconds": time.perf_counter() - t1, "reserved_before": reserved})
        return res

    if 24 in phases:
        out["serve"] = [step(key, pm_serve, key, seed, ref)
                        for key in ("qwen_dense", "qwen_sparse", "deepseek")]
        out["f32"] = [step(key, pm_f32, key, seed, ref)
                      for key in ("qwen_dense_f32", "qwen_sparse_f32")]
        out["slices"] = step("slices", pm_slices, seed)
    if 25 in phases:
        t_train = time.perf_counter()
        out["train"] = step("train", pt_train, seed, os.path.dirname(go))
        out["train_s"] = time.perf_counter() - t_train
    if 26 in phases:
        out["rec"] = step("recurrent", pr_paths, seed, ref)
    if 27 in phases:
        out["trainrec"] = step("train recurrent", pq_paths, seed, ref,
                               os.path.dirname(go))
    out["card_s"] = time.perf_counter() - t_card
    out["total_s"] = time.perf_counter() - t0
    return out


def pm_closed_forms(key: str) -> dict:
    """A path's closed forms: param bytes, block-kernel launches and the
    collectives of its counted generate (lm's, plus Server's per-token
    all-gather of the (B, 1) int32 tokens where the batch is split)."""
    from repro_torch.analysis import sharded as SHD

    cfg = pm_configs()[key]
    arch = "deepseek" if key == "deepseek" else "qwen"
    shape = PM_DS_MESH if arch == "deepseek" else PM_QWEN_MESH
    gen = PM_GEN[arch]
    coll = SHD.serve_collectives(cfg, shape, LM_BATCH, LM_PROMPT, gen - 1, 2)
    if shape[0] > 1 and LM_BATCH % shape[0] == 0:
        coll["calls"]["all-gather"] += gen
        coll["bytes"]["all-gather"] += gen * LM_BATCH * 4
    return {"param_bytes": SHD.param_bytes(cfg, shape),
            "launches": SHD.block_kernel_launches(cfg, gen), "coll": coll}


# ---------------- phase 26: the recurrent kinds and the enc-dec on the mesh

PR_MESH = {"zamba2": (1, 4), "xlstm": (2, 2), "seamless": (2, 2)}
PR_GEN = 8  # tokens a generate
PR_STEPS = 3  # f32 decode steps held against the one-process port
# the f32 cuts' prompts: PM_LOGIT_TOL holds at the first.  Mamba2's and
# mLSTM's decays enter as an f32 cumulative sum over the prompt, so an ulp
# of difference in a projection (a split product, a psum) moves the logits
# in proportion to its length (PERF.md section 6): at LM_PROMPT the bound
# is the control's
PR_F32_PROMPTS = (32, LM_PROMPT)
# a path's control: the one-process port's own logits with every weight
# moved by its dtype's machine epsilon (``pr_nudged``), against its logits,
# fed the same tokens: what a change of rounding alone moves them by, read
# in this run.  The mesh's logits stray from the one-process port's by at
# most this multiple of it: in f32 (measured on the H100: 0.72-1.48 of
# it, PERF.md section 6), and in bf16 at every position of the
# teacher-forced run, where an epsilon is a larger change than the mesh's
# (0.22-0.31 of it on the H100; 0.14-0.37 on the CPU at reduced width)
PR_F32_CONTROL_X = 2.0
PR_BF16_CONTROL_X = 0.5
# bf16 tokens fed the one-process port's (teacher forcing) are compared
# where its top-2 margin exceeds twice the largest gap between the two
# runs' logits measured on the H100 (seamless 2.24 % of a position's max
# |logit|).  zamba2's and xlstm's gaps (10.5 %, 7.8 %) are larger than
# half their top-2 margins at random weights (at most 18.7 %, 13.9 %):
# their tokens are not compared, their logits are
PR_TOKEN_MARGIN = {"seamless": 0.045}
PR_ENC = 1024  # stub frames a row (seamless)
# the step builders' shape (caches of LM_PROMPT + PR_GEN positions), an
# entry this script adds to the port's SHAPES
PR_SHAPE = "chip_smoke_mesh_prefill"
PR_PATHS = ("zamba2_dense", "zamba2_sparse", "xlstm", "seamless_dense",
            "seamless_sparse")
PR_F32 = ("zamba2_f32", "xlstm_f32", "seamless_f32")
# rank 0's runs of the block kernel timed: (path, projections)
PR_RUNS = (("zamba2_sparse", ("w_gate", "w_down")),
           ("seamless_sparse", ("w_gate", "w_down")))


def pr_configs() -> dict:
    """Phase 26's configs, all at full width: zamba2-2.7b cut to 12 of 54
    layers (2 repeats: 10 Mamba2 blocks, the shared block invoked twice),
    dense and at ``ffn_density=0.5`` in (8, 128) blocks, its f32 cut at 6
    (one repeat, sparse); xlstm-1.3b cut to 8 of 48 (7 mLSTM + 1 sLSTM),
    bf16 and f32; seamless-m4t-medium at full depth (12 + 12), dense and
    sparse, its f32 cut at 2 + 2 (sparse)."""
    from repro_torch.configs import get_config

    def sparse(c):
        return dataclasses.replace(c, ffn_density=0.5)

    z = dataclasses.replace(get_config("zamba2-2.7b"), n_layers=12)
    x = dataclasses.replace(get_config("xlstm-1.3b"), n_layers=8)
    s = get_config("seamless-m4t-medium")
    return {"zamba2_dense": z, "zamba2_sparse": sparse(z),
            "zamba2_f32": sparse(dataclasses.replace(z, n_layers=6)),
            "xlstm": x, "xlstm_f32": x,
            "seamless_dense": s, "seamless_sparse": sparse(s),
            "seamless_f32": sparse(dataclasses.replace(s, n_layers=2,
                                                       encoder_layers=2))}


def pr_arch(key: str) -> str:
    return key.split("_")[0]


def pr_inputs(seed: int, cfg, prompt: int = LM_PROMPT) -> tuple:
    """(prompts (B, prompt) int32, teacher tokens (PR_STEPS, B, 1) int32,
    stub frames (B, PR_ENC, d) f32 or None) of a path."""
    rng = np.random.default_rng([seed, 26, cfg.n_layers, cfg.vocab, prompt])
    prompts = rng.integers(0, cfg.vocab, (LM_BATCH, prompt)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, (PR_STEPS, LM_BATCH, 1)).astype(np.int32)
    frames = None
    if cfg.encoder_layers:
        frames = rng.standard_normal((LM_BATCH, PR_ENC, cfg.d_model)).astype(np.float32)
    return prompts, steps, frames


def pr_params(torch, cfg, dtype, device, mesh=None):
    """The seeded params (seed 0, as ``Server``'s) on one device, or this
    rank's blocks of them on a mesh (``launch.serve.mesh_params``, what
    ``Server(mesh=)`` holds; the encoder-decoder has no Server)."""
    from repro_torch.launch.serve import mesh_params
    from repro_torch.models import lm

    if mesh is None:
        gen = torch.Generator(device=device).manual_seed(0)
        return lm.init_params(gen, cfg, dtype)
    return mesh_params(cfg, mesh, dtype)


def pr_steps(torch, params, cfg, frames, dtype, device) -> tuple:
    """(prefill(tokens), decode(token, caches)) of a path, called under the
    ambient mesh: ``lm.prefill`` / ``lm.decode_step``, or for the
    encoder-decoder the step builders (``make_prefill_step`` encodes the
    frames; the decode steps read the memory of one ``lm.encode``, on a
    mesh the rank's rows of it), which this call encodes."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import steps as ST
    from repro_torch.models import lm

    max_len = LM_PROMPT + PR_GEN
    if not cfg.encoder_layers:
        return (lambda t: lm.prefill(params, t, cfg, max_len),
                lambda t, c: lm.decode_step(params, t, c, cfg))
    SHAPES.setdefault(PR_SHAPE, dict(seq_len=max_len, global_batch=LM_BATCH,
                                     kind="prefill"))
    fr = torch.from_numpy(frames).to(device, dtype)
    memory = lm.encode(params, fr, cfg)
    pre = ST.make_prefill_step(cfg, PR_SHAPE)
    dec = ST.make_decode_step(cfg, PR_SHAPE)
    return (lambda t: pre(params, {"tokens": t, "frames": fr}),
            lambda t, c: dec(params, {"token": t, "caches": c, "memory": memory}))


def pr_greedy(torch, fns, prompts, n: int, device) -> tuple:
    """Greedy tokens (B, n) of a path's (prefill, decode) on one device, as
    ``Server.generate`` runs them, each position's top-2 margin as a share
    of its max |logit| (B, n), and each position's logits (f32 numpy)."""
    toks = torch.from_numpy(prompts).to(device)
    out, margins, logits_np = [], [], []
    logits, caches = fns[0](toks)
    for i in range(n):
        lf = logits.float()
        top = torch.topk(lf, 2, dim=-1).values
        margins.append(((top[:, 0] - top[:, 1]) / lf.abs().amax(-1)).cpu().numpy())
        logits_np.append(lf.cpu().numpy())
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out.append(tok)
        if i + 1 < n:
            logits, caches = fns[1](tok, caches)
    return torch.cat(out, dim=1).cpu().numpy(), np.stack(margins, 1), logits_np


def pr_teacher(torch, fns, prompts, steps, device) -> list:
    """Logits (f32 numpy, the rank's rows on a mesh) of a prefill and of
    decode steps fed ``steps``."""
    logits, caches = fns[0](torch.from_numpy(prompts).to(device))
    out = [logits.float().cpu().numpy()]
    for s in steps:
        logits, caches = fns[1](torch.from_numpy(s).to(device), caches)
        out.append(logits.float().cpu().numpy())
    return out


def pr_fed(tokens) -> np.ndarray:
    """The decode steps' inputs (gen - 1, B, 1) that reproduce greedy
    ``tokens`` (B, gen): each step is fed the token before it."""
    return tokens.T[:-1, :, None].copy()


def pr_nudged(torch, params, seed: int):
    """``params`` with every floating leaf moved by its dtype's machine
    epsilon, relative, up or down at random (seeded): a change of rounding
    alone, the input of a control."""
    from repro_torch.tree import tree_map

    gens = {}

    def nudge(t):
        if not t.is_floating_point():
            return t
        if t.device not in gens:
            gens[t.device] = torch.Generator(device=t.device).manual_seed(seed)
        sign = torch.randint(0, 2, t.shape, generator=gens[t.device], device=t.device)
        eps = torch.finfo(t.dtype).eps
        return (t.float() * (1 + eps * (2 * sign - 1))).to(t.dtype)

    return tree_map(nudge, params)


def pr_gaps(got: list, want: list) -> np.ndarray:
    """|got - want| over each position's max |want|, its largest entry,
    (rows, positions)."""
    return np.stack([np.abs(g - w).max(-1) / np.abs(w).max(-1)
                     for g, w in zip(got, want)], 1)


def pr_rel_err(got: list, want: list, rows=slice(None)) -> float:
    """The largest |got - want[rows]| over the max |want| of all rows."""
    return max(float(np.abs(g - w[rows]).max() / np.abs(w).max())
               for g, w in zip(got, want))


def pr_rows(mesh, shape) -> slice:
    """This rank's rows of the global batch (all of them where "data" does
    not split it)."""
    if shape[0] > 1 and LM_BATCH % shape[0] == 0:
        B = LM_BATCH // shape[0]
        return slice(mesh.coords[0] * B, (mesh.coords[0] + 1) * B)
    return slice(0, LM_BATCH)


def pr_references(torch, seed: int, device, ref: dict) -> dict:
    """The one-process port's answers on the card, into ``ref``: each bf16
    path's greedy tokens, their margins and logits, and its control (the
    gaps, position by position, of its nudged weights' logits fed the same
    tokens); each f32 cut's teacher-forced logits at each of
    ``PR_F32_PROMPTS`` and its control's error there; returns each
    reference's seconds."""
    cfgs, seconds = pr_configs(), {}
    for key in PR_PATHS + PR_F32:
        t0 = time.perf_counter()
        cfg = cfgs[key]
        dtype = torch.float32 if key in PR_F32 else torch.bfloat16
        with torch.no_grad():
            params = pr_params(torch, cfg, dtype, device)
            nudged = pr_nudged(torch, params, seed)
            if key in PR_F32:
                for S in PR_F32_PROMPTS:
                    prompts, steps, frames = pr_inputs(seed, cfg, S)
                    want = pr_teacher(torch, pr_steps(torch, params, cfg, frames, dtype,
                                                      device), prompts, steps, device)
                    ref.update({f"{key}|{S}|logits{i}": lg for i, lg in enumerate(want)})
                    fns = pr_steps(torch, nudged, cfg, frames, dtype, device)
                    ref[f"{key}|{S}|control"] = pr_rel_err(
                        pr_teacher(torch, fns, prompts, steps, device), want)
            else:
                prompts, _, frames = pr_inputs(seed, cfg)
                fns = pr_steps(torch, params, cfg, frames, dtype, device)
                toks, ref[f"{key}|margins"], want = pr_greedy(torch, fns, prompts,
                                                               PR_GEN, device)
                ref[f"{key}|tokens"] = toks
                ref.update({f"{key}|logits{i}": lg for i, lg in enumerate(want)})
                fns = pr_steps(torch, nudged, cfg, frames, dtype, device)
                ref[f"{key}|control"] = pr_gaps(
                    pr_teacher(torch, fns, prompts, pr_fed(toks), device), want)
            del params, nudged, fns
        free_card(torch)
        seconds[key] = time.perf_counter() - t0
    return seconds


def pr_token_agreement(got, want, margins, margin: float) -> dict:
    """Teacher-forced tokens against the one-process port's at every
    position where its top-2 margin exceeds ``margin`` (every position saw
    the one-process run's inputs)."""
    ok = margins > margin
    return {"checked": int(ok.sum()), "agree": int((ok & (got == want)).sum()),
            "positions": int(want.size), "margin": margin}


def pr_serve(torch, world, key: str, seed: int, ref) -> dict:
    """One bf16 path on this rank, counted and timed: ``Server(mesh=).
    generate`` (zamba2, xlstm), or the step builders (seamless, its two
    encoder passes in the prefill) fed the one-process port's tokens; then
    the rank's logits fed those tokens (teacher forcing: every position
    sees the one-process run's inputs) against the one-process port's and
    its control, position by position."""
    import torch.distributed as dist

    from repro_torch.core import sharding as SH
    from repro_torch.kernels import instrument
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import Server

    cfg = pr_configs()[key]
    shape = PR_MESH[pr_arch(key)]
    mesh = make_local_mesh(shape[1], world=world)
    coll = SH.collectives(mesh)
    prompts, _, frames = pr_inputs(seed, cfg)
    fed = pr_fed(ref[f"{key}|tokens"])
    t0 = time.perf_counter()
    srv = None
    if cfg.encoder_layers:
        params = pr_params(torch, cfg, torch.bfloat16, mesh.device, mesh)
    else:
        srv = Server(cfg, LM_PROMPT + PR_GEN, mesh=mesh)
        params = srv.params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    dist.barrier()
    instrument.reset()
    coll.reset()
    torch.cuda.reset_peak_memory_stats()
    timings, toks = {}, None
    if srv is not None:
        toks = srv.generate(prompts, PR_GEN, timings=timings)
    else:
        t1 = time.perf_counter()
        with torch.no_grad(), SH.set_mesh(mesh):
            fns = pr_steps(torch, params, cfg, frames, torch.bfloat16, mesh.device)
            first = [None]

            def prefill(t):
                out = fns[0](t)
                torch.cuda.synchronize()
                first[0] = time.perf_counter()
                return out

            got = pr_teacher(torch, (prefill, fns[1]), prompts, fed, mesh.device)
        torch.cuda.synchronize()
        timings = {"prefill_s": first[0] - t1, "decode_s": time.perf_counter() - first[0]}
    snap = coll.snapshot()
    launches = instrument.launches("bcoo")
    peak = torch.cuda.max_memory_allocated()
    if srv is not None:
        with torch.no_grad(), SH.set_mesh(mesh):
            fns = pr_steps(torch, params, cfg, None, torch.bfloat16, mesh.device)
            got = pr_teacher(torch, fns, prompts, fed, mesh.device)
    rows = pr_rows(mesh, shape)
    gaps = pr_gaps(got, [ref[f"{key}|logits{i}"][rows] for i in range(PR_GEN)])
    control = ref[f"{key}|control"][rows]
    margins, want = ref[f"{key}|margins"][rows], ref[f"{key}|tokens"][rows]
    tf = np.stack([g.argmax(-1) for g in got], 1).astype(np.int32)
    limit = PR_TOKEN_MARGIN.get(pr_arch(key))
    row = {"key": key, "arch": cfg.name, "mesh": list(shape), "coords": list(mesh.coords),
           "n_layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
           "init_s": init_s, "tokens": toks, "teacher_tokens": tf,
           "rows": [rows.start, rows.stop],
           "prefill_ms": 1e3 * timings["prefill_s"],
           "decode_ms_per_token": 1e3 * timings["decode_s"] / (PR_GEN - 1),
           "launches": launches,
           "coll_calls": snap["calls"], "coll_bytes": snap["bytes"],
           "coll_ms": {k: 1e3 * v for k, v in snap["seconds"].items()},
           "peak_allocated_bytes": peak,
           "param_bytes": pm_param_bytes(params), "transport": coll.transport,
           "gap": float(gaps.max()), "control": float(control.max()),
           "gaps": gaps.tolist(), "controls": control.tolist(),
           "margins": margins.tolist(),
           "tokens_vs_one_process": None if limit is None else
           pr_token_agreement(tf, want, margins, limit)}
    del srv, params, fns
    free_card(torch)
    dist.barrier()
    return row


def pr_f32(torch, world, key: str, seed: int, ref) -> dict:
    """An f32 cut on its mesh: each rank's prefill and decode logits (its
    rows) against the one-process port's, and that port's control, at each
    of ``PR_F32_PROMPTS``."""
    import torch.distributed as dist

    from repro_torch.core import sharding as SH
    from repro_torch.launch.mesh import make_local_mesh

    cfg = pr_configs()[key]
    shape = PR_MESH[pr_arch(key)]
    mesh = make_local_mesh(shape[1], world=world)
    params = pr_params(torch, cfg, torch.float32, mesh.device, mesh)
    rows = pr_rows(mesh, shape)
    errs, controls = {}, {}
    for S in PR_F32_PROMPTS:
        prompts, steps, frames = pr_inputs(seed, cfg, S)
        with torch.no_grad(), SH.set_mesh(mesh):
            fns = pr_steps(torch, params, cfg, frames, torch.float32, mesh.device)
            got = pr_teacher(torch, fns, prompts, steps, mesh.device)
        errs[S] = pr_rel_err(got, [ref[f"{key}|{S}|logits{i}"] for i in range(len(got))],
                             rows)
        controls[S] = float(ref[f"{key}|{S}|control"])
        del fns
    del params
    free_card(torch)
    dist.barrier()
    return {"key": key, "rel_err": errs, "control": controls,
            "coords": list(mesh.coords)}


def pr_runs(torch, world, seed: int) -> dict:
    """Rank 0's runs of zamba2's shared w_gate / w_down on (1, 4) and
    seamless's w_gate / w_down on (2, 2), integer-valued bf16 at T = 512
    and 4: every rank's sharded projection (its run, then the all-gather)
    bit-equal to the plain version of the whole stream; rank 0's kernel on
    its run bit-equal to the run's plain version, timed beside it,
    ``torch.matmul`` on the run's dense rows and its bound."""
    import torch.distributed as dist

    from repro_torch.core import sharding as SH
    from repro_torch.kernels import instrument
    from repro_torch.kernels.bcsr_spmv import bcoo_spmv, bcoo_spmv_plain
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sparse.layers import (_balanced_pattern, sparse_linear_apply,
                                           stream_layout, with_run)

    out = {"equal": True, "rows": []}
    gen = np.random.default_rng([seed, 26, 99])  # the same on every rank
    for key, names in PR_RUNS:
        cfg = pr_configs()[key]
        mesh = make_local_mesh(PR_MESH[pr_arch(key)][1], world=world)
        device = mesh.device
        r, c = cfg.sparse_block
        for name in names:
            d_in, d_out = ffn_dims(cfg)[name]
            browind, bcolind = _balanced_pattern(d_out // r, d_in // c, cfg.ffn_density)
            nb = len(browind)
            full = {"browind": torch.from_numpy(browind).to(device),
                    "bcolind": torch.from_numpy(bcolind).to(device),
                    "bvalues": torch.from_numpy(gen.integers(-3, 4, (nb, r, c))
                                                .astype(np.float32)).to(device, torch.bfloat16)}
            nb_l = nb // mesh.devices.shape[1]
            m = mesh.coords[1]
            run = {k: v[m * nb_l:(m + 1) * nb_l] for k, v in full.items()}
            rows, lo, merge = stream_layout(nb_l, d_in, d_out, (r, c), cfg.ffn_density,
                                            mesh)
            local = with_run(run, d_in, d_out, cfg.ffn_density, mesh)
            for T in MOE_TOKENS:
                x = torch.from_numpy(gen.integers(-3, 4, (T, d_in)).astype(np.float32)
                                     ).to(device, torch.bfloat16)
                with SH.set_mesh(mesh):
                    y = sparse_linear_apply(local, x, d_out)
                want = bcoo_spmv_plain(full["browind"], full["bcolind"],
                                       full["bvalues"], x.T.contiguous(),
                                       d_out).to(torch.bfloat16).T
                out["equal"] &= bool(torch.equal(y, want))
                row = {"key": key, "name": name, "T": T, "nb": nb_l,
                       "block_rows": rows, "merge": merge}
                if world.rank == 0:
                    xt = x.T.contiguous()
                    lb = (local["browind"] - lo).contiguous()
                    dense = densified(torch, {"browind": lb, "bcolind": local["bcolind"],
                                              "bvalues": local["bvalues"]}, d_in, rows * r)
                    kern = lambda: bcoo_spmv(lb, local["bcolind"], local["bvalues"], xt,
                                             rows * r, browptr=local["browptr"])
                    got = kern()
                    plain = bcoo_spmv_plain(lb, local["bcolind"], local["bvalues"], xt,
                                            rows * r)
                    row["kernel_equals_plain"] = bool(torch.equal(got, plain))
                    row["max_abs_err"] = max_err(torch, got, plain)
                    instrument.reset()
                    row["ms"] = time_ms(torch, kern, PM_TIMED)
                    row["timed_launches"] = instrument.launches("bcoo")
                    row["plain_ms"] = time_ms(torch, lambda: bcoo_spmv_plain(
                        lb, local["bcolind"], local["bvalues"], xt, rows * r), 2,
                        warmup=1)
                    row["library_ms"] = time_ms(torch, lambda: dense @ xt, PM_TIMED)
                    row["bound_ms"], row["bound_by"] = lm_bound(
                        nb_l, r, c, rows, d_in, rows * r, T)
                    del dense
                    out["rows"].append(row)
                dist.barrier()
            free_card(torch)
    return out


def pr_paths(torch, world, seed: int, ref) -> dict:
    """Phase 26 on this rank: the bf16 paths, the f32 cuts, then rank 0's
    runs of the block kernel."""
    t0 = time.perf_counter()
    out = {"serve": [pr_serve(torch, world, key, seed, ref) for key in PR_PATHS],
           "f32": [pr_f32(torch, world, key, seed, ref) for key in PR_F32],
           "runs": pr_runs(torch, world, seed)}
    out["seconds"] = time.perf_counter() - t0
    return out


def pr_closed_forms(key: str) -> dict:
    """A bf16 path's closed forms: param bytes, block-kernel launches and
    the collectives of its counted run: a prefill and PR_GEN - 1 decode
    steps, plus ``Server.generate``'s all-gather of the (B, 1) int32 tokens
    a token where the batch is split, or for the encoder-decoder its two
    encoder passes (the prefill step's and the decode memory's)."""
    from repro_torch.analysis import sharded as SHD

    cfg = pr_configs()[key]
    shape = PR_MESH[pr_arch(key)]
    coll = SHD.serve_collectives(cfg, shape, LM_BATCH, LM_PROMPT, PR_GEN - 1, 2,
                                 S_mem=PR_ENC)
    launches = SHD.block_kernel_launches(cfg, PR_GEN)
    if cfg.encoder_layers:
        enc = SHD.encode_collectives(cfg, shape, LM_BATCH, PR_ENC, 2)
        for part in ("calls", "bytes"):
            for kind, n in enc[part].items():
                coll[part][kind] += 2 * n
        launches += 2 * SHD.encode_block_kernel_launches(cfg)
    elif shape[0] > 1 and LM_BATCH % shape[0] == 0:
        coll["calls"]["all-gather"] += PR_GEN
        coll["bytes"]["all-gather"] += PR_GEN * LM_BATCH * 4
    return {"param_bytes": SHD.param_bytes(cfg, shape), "launches": launches,
            "coll": coll}


def pr_checks(torch, ranks, info: dict, card: str) -> dict:
    """Phase 26's rows and checks (every row emitted before any check)."""
    rows, fails, launches = [], [], 0

    def need(cond, msg):
        if not cond:
            fails.append(msg)

    for i, key in enumerate(PR_PATHS):
        want = pr_closed_forms(key)
        per = [r["rec"]["serve"][i] for r in ranks]
        for row in per:
            who = f"recurrent mesh {key}: rank at {row['coords']}"
            need(row["param_bytes"] == want["param_bytes"],
                 f"{who} holds {row['param_bytes']} param bytes, the specs "
                 f"{want['param_bytes']}")
            need(row["launches"] == want["launches"],
                 f"{who} launched {row['launches']} block kernels, closed form "
                 f"{want['launches']}")
            need(row["coll_calls"] == want["coll"]["calls"]
                 and row["coll_bytes"] == want["coll"]["bytes"],
                 f"{who} collectives {row['coll_calls']} / {row['coll_bytes']} != "
                 f"closed form {want['coll']}")
            need(row["peak_allocated_bytes"] >= row["param_bytes"],
                 f"{who}: peak below its params")
            if row["tokens"] is not None:  # Server.generate: the whole batch
                need(np.array_equal(row["tokens"], per[0]["tokens"]),
                     f"{who}'s tokens differ from rank 0's")
            for other in per:  # a data rank's rows: the same on its model ranks
                if other["rows"] == row["rows"]:
                    need(np.array_equal(row["teacher_tokens"], other["teacher_tokens"]),
                         f"{who}'s teacher-forced tokens differ from the rank at "
                         f"{other['coords']}'s")
            need(row["gap"] <= PR_BF16_CONTROL_X * row["control"],
                 f"{who}: logits {row['gap']:.3g} of a position's max |logit| from "
                 f"the one-process port's, over {PR_BF16_CONTROL_X}x its control "
                 f"{row['control']:.3g}")
            agree = row["tokens_vs_one_process"]
            if agree is not None:
                need(agree["agree"] == agree["checked"],
                     f"{who}: teacher-forced tokens differ from the one-process "
                     f"port where its margin exceeds {agree['margin']:.3g} of the "
                     f"max |logit|: {agree}")
            launches += row["launches"]
        if PR_TOKEN_MARGIN.get(pr_arch(key)) is not None:
            # over the whole batch: each data rank's rows once
            batch = {tuple(row["rows"]): row["tokens_vs_one_process"] for row in per}
            checked = sum(a["checked"] for a in batch.values())
            positions = sum(a["positions"] for a in batch.values())
            need(checked >= PM_MIN_CHECKED * positions,
                 f"recurrent mesh {key}: {checked} of {positions} positions past "
                 f"the margin, under {PM_MIN_CHECKED:.0%}")
        rows.append({"phase": "recurrent_mesh", "path": key, "arch": per[0]["arch"],
                     "mesh": per[0]["mesh"], "n_layers": per[0]["n_layers"],
                     "encoder_layers": per[0]["encoder_layers"],
                     "transport": per[0]["transport"], "card": card,
                     "reference_s": info["seconds"].get(key),
                     "closed_form": {"param_bytes": want["param_bytes"],
                                     "launches": want["launches"], **want["coll"]},
                     "ranks": [{k: v for k, v in row.items()
                                if k not in ("tokens", "teacher_tokens")}
                               for row in per]})
    for i, key in enumerate(PR_F32):
        per = [r["rec"]["f32"][i] for r in ranks]
        worst = {S: max(row["rel_err"][S] for row in per) for S in PR_F32_PROMPTS}
        control = per[0]["control"]
        S = PR_F32_PROMPTS[0]
        need(worst[S] <= PM_LOGIT_TOL, f"recurrent mesh {key}: logits {worst[S]:.3g} "
             f"of max |logit| from the one-process port at a {S}-token prompt "
             f"(bound {PM_LOGIT_TOL})")
        for S in PR_F32_PROMPTS:
            need(worst[S] <= PR_F32_CONTROL_X * control[S],
                 f"recurrent mesh {key}: logits {worst[S]:.3g} of max |logit| from "
                 f"the one-process port at a {S}-token prompt, over "
                 f"{PR_F32_CONTROL_X}x its control {control[S]:.3g}")
        rows.append({"phase": "recurrent_mesh_f32", "path": key,
                     "rel_err_by_prompt": worst, "control_by_prompt": control,
                     "bound": PM_LOGIT_TOL, "bound_prompt": PR_F32_PROMPTS[0],
                     "control_x": PR_F32_CONTROL_X,
                     "reference_s": info["seconds"].get(key), "card": card})
    runs = [r["rec"]["runs"] for r in ranks]
    for r, s in zip(ranks, runs):
        need(s["equal"], f"recurrent mesh: rank {r['rank']}'s sharded projections "
             "!= the plain version of the whole stream")
    for row in runs[0]["rows"]:
        need(row["kernel_equals_plain"], f"recurrent mesh: rank 0's run kernel "
             f"!= its plain version ({row['key']} {row['name']} T={row['T']})")
        need(row["timed_launches"] == PM_TIMED + 3,
             f"recurrent mesh: rank 0 timed {row['timed_launches']} launches")
    rows.append({"phase": "recurrent_mesh_runs", "card": card, "rows": runs[0]["rows"]})
    seconds = max(r["rec"]["seconds"] for r in ranks)
    rows.append({"phase": "recurrent_mesh_done", "launches": launches,
                 "ranks_s": seconds, "reference_s": sum(info["seconds"].values()),
                 "card": card})
    for row in rows:
        emit(row)
    for msg in fails:
        check(False, msg)
    return {"launches": launches,
            "max_abs_err": max(row["max_abs_err"] for row in runs[0]["rows"]),
            "seconds": seconds + sum(info["seconds"].values())}


def phase_lm_mesh(torch, seed: int, device, train_ref: dict | None = None,
                  phases=(24, 25, 26, 27), families_ref: dict | None = None) -> dict:
    """Phase 24: qwen1.5-0.5b on a (1, 4) process mesh and deepseek-v3 (2
    layers) on a (2, 2) one, 4 ranks of a gloo world on the one card, the
    collectives' data copied between the card and a shared memory mapping,
    as a mesh whose ranks share one host does (transport
    ``shm-host-staged``; over gloo's sockets each collective takes
    milliseconds, PERF.md section 5).  The ranks start on the host while
    this process runs the one-process references; it frees the card, posts
    their turn, and touches the card no more until they are done.

    Phase 25 (training on the mesh, ``pt_*``) runs in the same ranks and
    the same turn, after the serving paths; ``train_ref`` holds phase 15's
    one-process qwen losses (dense and sparse), which this process computes
    in its reference time where it is None.  Phase 26 (the recurrent kinds
    and the encoder-decoder, ``pr_*``) runs after it, its references
    beside phase 24's.  Phase 27 (training them, ``pq_*``) runs last;
    ``families_ref`` holds phase 19's one-process zamba2 and xlstm losses,
    which this process computes in its reference time where it is None.
    ``phases`` picks which of the four run (a script that runs one of them
    alone)."""
    from concurrent.futures import ThreadPoolExecutor

    import tempfile

    from repro_torch.core.world import spawn

    t_start = time.perf_counter()
    pool = ThreadPoolExecutor(1)
    tmp = tempfile.mkdtemp(prefix="phase24_")
    go, ref_path = os.path.join(tmp, "turn"), os.path.join(tmp, "ref.npz")
    turn = "abort"
    info, rec_info, trec_info, ref = {}, {}, {}, {}
    try:
        card = f"cuda:{device.index or 0}" if device.type == "cuda" else "cpu"
        ranks_f = pool.submit(spawn, pm_rank, PM_RANKS, "gloo", card,
                              (seed, go, ref_path, tuple(phases)), 900)
        if 24 in phases:
            info = pm_references(torch, seed, device, ref)
            free_card(torch)
        if 25 in phases and train_ref is None:
            train_ref = pt_references(torch, device)
        if 26 in phases:
            rec_info["seconds"] = pr_references(torch, seed, device, ref)
        if 27 in phases:
            if families_ref is None:
                t0 = time.perf_counter()
                families_ref = pq_families_references(torch, device)
                trec_info["families"] = time.perf_counter() - t0
            trec_info.update(pq_references(torch, seed, device, ref, tmp))
        np.savez(ref_path, **ref)
        ref_s = time.perf_counter() - t_start
        emit({"phase": "lm_mesh_references", "seconds": ref_s,
              "recurrent_reference_s": rec_info.get("seconds"),
              "train_recurrent_reference_s": trec_info,
              "allocated": torch.cuda.memory_allocated(),
              "reserved": torch.cuda.memory_reserved()})
        turn = "go"
        t_turn = time.perf_counter()
    finally:
        pw_post_turn(go, turn)  # "abort": the ranks fail at their turn
        if turn != "go":
            pool.shutdown(wait=True)
            shutil.rmtree(tmp, ignore_errors=True)
    try:
        ranks = ranks_f.result()
        ranks_s = time.perf_counter() - t_turn
    finally:
        pool.shutdown(wait=True)
        shutil.rmtree(tmp, ignore_errors=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = {"launches": 0, "max_abs_err": 0.0, "train_launches": 0,
           "train_seconds": 0.0, "rec_launches": 0, "rec_seconds": 0.0,
           "trec_launches": 0, "trec_seconds": 0.0}
    if 24 in phases:
        out.update(pm_checks(torch, ranks, info, card))
    if 25 in phases:
        train = pt_checks(torch, ranks, train_ref, card)
        out["max_abs_err"] = max(out["max_abs_err"], train["max_abs_err"])
        out["train_launches"] = train["launches"]
        out["train_seconds"] = max(r["train_s"] for r in ranks)
        emit({"phase": "train_mesh_done", "seconds": out["train_seconds"],
              "launches": train["launches"], "card": card})
    if 26 in phases:
        rec = pr_checks(torch, ranks, rec_info, card)
        out["max_abs_err"] = max(out["max_abs_err"], rec["max_abs_err"])
        out["rec_launches"], out["rec_seconds"] = rec["launches"], rec["seconds"]
    if 27 in phases:
        trec = pq_checks(torch, ranks, trec_info, families_ref, ref, card)
        out["max_abs_err"] = max(out["max_abs_err"], trec["max_abs_err"])
        out["trec_launches"], out["trec_seconds"] = trec["launches"], trec["seconds"]
    seconds = time.perf_counter() - t_start
    emit({"phase": "lm_mesh_done", "seconds": seconds, "reference_s": ref_s,
          "ranks_s": ranks_s, "rank_setup_s": [r["setup_s"] for r in ranks],
          "rank_wait_s": [r["wait_s"] for r in ranks],
          "rank_card_s": [r["card_s"] for r in ranks], "launches": out["launches"],
          "card": card})
    out["seconds"] = seconds
    return out


def pm_checks(torch, ranks, info: dict, card: str) -> dict:
    """Phase 24's rows and checks; returns its launches and the largest
    error of its runs of the block kernel."""
    launches = 0
    for i, key in enumerate(("qwen_dense", "qwen_sparse", "deepseek")):
        want = pm_closed_forms(key)
        per = [r["serve"][i] for r in ranks]
        for row in per:
            who = f"lm mesh {key}: rank at {row['coords']}"
            check(row["param_bytes"] == want["param_bytes"],
                  f"{who} holds {row['param_bytes']} param bytes, the specs "
                  f"{want['param_bytes']}")
            check(row["launches"] == want["launches"],
                  f"{who} launched {row['launches']} block kernels, closed form "
                  f"{want['launches']}")
            check(row["coll_calls"] == want["coll"]["calls"]
                  and row["coll_bytes"] == want["coll"]["bytes"],
                  f"{who} collectives {row['coll_calls']} / {row['coll_bytes']} != "
                  f"closed form {want['coll']}")
            check(np.array_equal(row["tokens"], per[0]["tokens"]),
                  f"{who}'s tokens differ from rank 0's")
            check(row["peak_allocated_bytes"] >= row["param_bytes"],
                  f"{who}: peak below its params")
            agree = row["tokens_vs_one_process"]
            check(agree["agree"] == agree["checked"]
                  and agree["decode_dropped"] == 0,
                  f"{who}: tokens differ from the one-process port where its "
                  f"margin exceeds {PM_BF16_MARGIN} of the max |logit|: {agree}")
            check(agree["checked"] >= PM_MIN_CHECKED * agree["positions"],
                  f"{who}: {agree['checked']} of {agree['positions']} positions "
                  f"past the margin, under {PM_MIN_CHECKED:.0%}")
            launches += row["launches"]
        emit({"phase": "lm_mesh", "path": key, "arch": per[0]["arch"],
              "mesh": per[0]["mesh"], "n_layers": per[0]["n_layers"],
              "transport": per[0]["transport"], "card": card,
              "closed_form": {"param_bytes": want["param_bytes"],
                              "launches": want["launches"], **want["coll"]},
              "one_process_dropped": info.get(key, {}).get("dropped"),
              "ranks": [{k: v for k, v in row.items() if k != "tokens"}
                        for row in per]})
    for i, key in enumerate(("qwen_dense_f32", "qwen_sparse_f32")):
        per = [r["f32"][i] for r in ranks]
        worst = max(row["rel_err"] for row in per)
        check(worst <= PM_LOGIT_TOL,
              f"lm mesh {key}: logits {worst:.3g} of max |logit| from the "
              f"one-process port (bound {PM_LOGIT_TOL})")
        for row in per:
            t = row["tokens"]
            check(t["agree"] == t["checked"],
                  f"lm mesh {key}: greedy tokens differ where the margin exceeds "
                  f"{PM_MARGIN}: {t}")
            check(t["checked"] >= PM_MIN_CHECKED * t["positions"],
                  f"lm mesh {key}: {t['checked']} of {t['positions']} greedy "
                  f"tokens past the margin, under {PM_MIN_CHECKED:.0%}")
        emit({"phase": "lm_mesh_f32", "path": key, "rel_err": worst,
              "bound": PM_LOGIT_TOL, "tokens": [row["tokens"] for row in per],
              "card": card})
    slices = [r["slices"] for r in ranks]
    for r, s in zip(ranks, slices):
        check(s["equal"], f"lm mesh: rank {r['rank']}'s sharded projections != the "
              "plain version of the whole stream")
        for row in s["rows"]:
            check(row["kernel_equals_plain"],
                  f"lm mesh: rank {r['rank']}'s run kernel != its plain version")
            check(row["timed_launches"] == PM_TIMED + 3,
                  f"lm mesh: rank {r['rank']} timed {row['timed_launches']} launches")
    emit({"phase": "lm_mesh_slices", "arch": LM_ARCH, "card": card,
          "rows": [dict(row, rank=r["rank"]) for r, s in zip(ranks, slices)
                   for row in s["rows"]]})
    err = max(row["max_abs_err"] for s in slices for row in s["rows"])
    return {"launches": launches, "max_abs_err": err}


DR_TOL = 2e-4  # random f32: the reference's tolerance (tests/test_kernels.py)
DR_FLOP_TOL = 0.01  # (b): the card's count of a step against the fake count
DR_MEM_RANGE = (0.7, 1.3)  # (b): fake / card peak outside it is a finding
# (c): every timed LM step, as its phase ran it: key -> (arch, kind, B,
# S).  The counts run on fake tensors in a worker process started with the
# script, so they overlap the card's phases
DR_LM_ROWS = {
    "qwen_prefill": (LM_ARCH, "prefill", LM_BATCH, LM_PROMPT),
    # the decode step reads caches of LM_MAX_LEN slots
    "qwen_decode": (LM_ARCH, "decode", LM_BATCH, LM_MAX_LEN),
    "smollm_train": (TRAIN_ARCH, "train", TRAIN_BATCH, TRAIN_SEQ),
    "seamless_train": (ED_ARCH, "train", SPARSE_B, SPARSE_S),
    **{f"{name}_train": (name, "train", *TF_SHAPE.get(name, (TF_BATCH, TF_SEQ)))
       for name in TF_ARCHS},
    # phase 21's, each at the depth it ran (DA_SERVE_LAYERS): llava's
    # prefill over the 2,880-token prefix and the prompt (seq_len counts
    # both)
    "gemma2_prefill": ("gemma2-27b", "prefill", LM_BATCH, LM_PROMPT),
    "gemma2_decode": ("gemma2-27b", "decode", LM_BATCH, LM_MAX_LEN),
    "llama_train": ("llama3.2-1b", "train", TF_BATCH, TF_SEQ),
    "llava_prefill": ("llava-next-34b", "prefill", 1, 2880 + LM_PROMPT),
}


def dr_lm_counts() -> dict:
    """(c)'s counts, in the worker process: each row's step counted on fake
    CPU tensors (``launch/dryrun.py``'s ``count_cell``, sLSTM's loop stepped
    once plus ``slstm_scan_correction``), with its ``_model_flops``.  A
    row's shape is entered in this process's ``SHAPES`` under its key."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # host counts only
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.analysis import roofline as R
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import lm
    from repro_torch.tree import leaves

    out = {}
    for key, (arch, kind, B, S) in DR_LM_ROWS.items():
        cfg = tf_cfg(arch)  # phase 19's cuts
        if kind != "train" and arch in DA_SERVE_LAYERS:  # phase 21 serves them cut
            cfg = dataclasses.replace(cfg, n_layers=DA_SERVE_LAYERS[arch])
        SHAPES[key] = dict(seq_len=S, global_batch=B, kind=kind)
        c = DR.count_cell(cfg, key)
        corr = R.slstm_scan_correction(cfg, key)
        out[key] = {"counted_flops": c.flops + corr, "slstm_correction": corr,
                    "counted_bytes": c.bytes, "argument_bytes": c.argument_bytes,
                    "temp_bytes": c.temp_bytes, "count_s": c.seconds,
                    "model_flops": R._model_flops(cfg, S, B, kind),
                    "n_params": cfg.n_params, "n_layers": cfg.n_layers,
                    # the init_params tree's size (xlstm's is 0.73 of its
                    # n_params, in the reference too)
                    "tree_params": sum(a.numel() for a in
                                       leaves(lm.abstract_params(cfg)))}
    return out


def dr_f64_oracle(mat):
    """The matrix as scipy CSR in float64 (global rows), the host oracle."""
    import scipy.sparse as sp

    P = mat.n_parts
    nnz = mat.nnz.cpu().numpy()
    rows = np.concatenate([mat.rowind[p, :nnz[p]].cpu().numpy().astype(np.int64)
                           + int(mat.row_start[p]) for p in range(P)])
    cols = np.concatenate([mat.colind[p, :nnz[p]].cpu().numpy() for p in range(P)])
    vals = np.concatenate([mat.values[p, :nnz[p]].cpu().numpy() for p in range(P)])
    return sp.csr_matrix((vals.astype(np.float64), (rows, cols)), shape=mat.shape)


def dr_spmv_parts(torch, rng, device, parts: int) -> dict:
    """(a) One part count: the 1D program with impl="cuda" (one part-axis
    launch of the COO kernel a request) on the card, against its plain
    version and a float64 oracle; kernel, plain and cuSPARSE ms beside the
    bound; the card's temp bytes beside the fake count's."""
    from repro_torch.api import plan_from_partitioned
    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels import instrument
    from repro_torch.launch import dryrun_spmv as DS

    t0 = time.perf_counter()
    mat = DS.synth_partition_1d(DR_ROWS, DR_ROWS, DR_NNZ_ROW, parts, device="cpu")
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fake = DS.count_1d(mat, make_mesh((parts,), ("data",), ["cpu"] * parts))
    count_s = time.perf_counter() - t0
    a64 = dr_f64_oracle(mat)
    free_card(torch)
    before = torch.cuda.memory_allocated()
    exe = plan_from_partitioned(mat, make_mesh((parts,), ("data",), [device] * parts),
                                impl="cuda").compile()
    placed = torch.cuda.memory_allocated() - before
    prog, local, arrs = exe.program, exe.program.local, exe.arrays
    nnz = DR_ROWS * DR_NNZ_ROW
    xs = [rng.standard_normal(DR_ROWS).astype(np.float32) for _ in range(4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    instrument.reset()
    ys = [exe(x) for x in xs]  # the path: one part-axis launch each
    launches = instrument.launches("coo")
    check(launches == len(xs), f"dryrun spmv {parts}: {launches} COO launches for "
          f"{len(xs)} requests")
    temp = torch.cuda.max_memory_allocated() - resident
    err64 = 0.0
    for x, y in zip(xs, ys):
        want = a64 @ x.astype(np.float64)
        check(y.shape == (DR_ROWS,) and np.isfinite(y).all(),
              f"dryrun spmv {parts}: answer shape {y.shape}")
        check(np.allclose(y, want, rtol=DR_TOL, atol=DR_TOL),
              f"dryrun spmv {parts}: != float64 oracle, max err "
              f"{np.abs(y - want).max()}")
        err64 = max(err64, float(np.abs(y - want).max()))
    xb = prog.x_buffer(exe.place(xs[0]))
    got, plain = local.raw(arrs, xb), local.plain(arrs, xb)
    torch.cuda.synchronize()
    err = max_err(torch, got, plain)
    check(torch.allclose(got, plain, rtol=DR_TOL, atol=DR_TOL),
          f"dryrun spmv {parts}: part-axis launch != its plain version ({err})")
    rows = torch.from_numpy(a64.indptr.astype(np.int32)).to(device)
    lib = torch.sparse_csr_tensor(rows, torch.from_numpy(a64.indices.astype(np.int32))
                                  .to(device),
                                  torch.from_numpy(a64.data.astype(np.float32))
                                  .to(device), size=mat.shape)
    xd = xb[:DR_ROWS].contiguous()
    nbytes = nnz * 12 + DR_ROWS * 4 + parts * mat.h_pad * 4
    by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, 2 * nnz / F32_OPS_S * 1e3
    row = {"phase": "dryrun_spmv", "program": "1d", "impl": "cuda", "parts": parts,
           "rows": DR_ROWS, "nnz": nnz, "requests": len(xs), "launches": launches,
           "ms": time_ms(torch, lambda: local.raw(arrs, xb), 30),
           "plain_ms": time_ms(torch, lambda: local.plain(arrs, xb), 3, warmup=1),
           "library_ms": time_ms(torch, lambda: lib @ xd, 30),
           "bound_ms": max(by_bytes, by_ops),
           "bound_by": "bytes" if by_bytes >= by_ops else "operations",
           "max_abs_err": err, "max_abs_err_f64": err64,
           "placed_bytes": placed, "card_temp_bytes": temp,
           "fake": {"flops": fake.flops, "bytes": fake.bytes,
                    "argument_bytes": fake.argument_bytes,
                    "temp_bytes": fake.temp_bytes, "count_s": count_s},
           # scipy sums the duplicate (row, column) entries Zipf columns
           # give: cuSPARSE multiplies fewer nonzeros
           "library_nnz": int(a64.nnz),
           "card_flops": 2 * nnz, "card_bytes": nbytes, "synth_s": synth_s,
           "compile_s": exe.build_seconds}
    row["roofline_share"] = row["bound_ms"] / row["ms"]
    check(fake.flops == 2 * nnz, f"dryrun spmv {parts}: fake count {fake.flops} "
          f"FLOPs, not 2 nnz = {2 * nnz}")
    emit(row)
    del exe, arrs, lib, got, plain
    free_card(torch)
    return row


def dr_spmv_ring(torch, rng, device) -> dict:
    """(a) The ring at 2^14 rows on 256 parts, bucketed first
    (``bucket_by_source_shard``), against the 1D program and a float64
    oracle; its count from its steps on fake tensors beside the card."""
    from repro_torch.api import plan_from_partitioned
    from repro_torch.core import distributed as D
    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels import instrument
    from repro_torch.launch import dryrun_spmv as DS

    P = DR_RING_PARTS
    mat = DS.synth_partition_1d(DR_RING_ROWS, DR_RING_ROWS, DR_NNZ_ROW, P,
                                device="cpu")
    fake = DS.count_1d(mat, make_mesh((P,), ("data",), ["cpu"] * P), ring=True)
    a64 = dr_f64_oracle(mat)
    t0 = time.perf_counter()
    part_r, counts = D.bucket_by_source_shard(mat, P)
    bucket_s = time.perf_counter() - t0
    free_card(torch)
    mesh = make_mesh((P,), ("data",), [device] * P)
    ring = plan_from_partitioned(part_r, mesh, ring=True, ring_counts=counts).compile()
    one = plan_from_partitioned(mat, mesh, impl="cuda").compile()
    x = rng.standard_normal(DR_RING_ROWS).astype(np.float32)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    instrument.reset()
    t0 = time.perf_counter()
    y = ring(x)
    ring_s = time.perf_counter() - t0
    check(instrument.launches() == 0, "dryrun ring: the ring launched a kernel")
    temp = torch.cuda.max_memory_allocated() - resident
    want, y1 = a64 @ x.astype(np.float64), one(x)
    check(np.allclose(y, want, rtol=DR_TOL, atol=DR_TOL),
          f"dryrun ring: != float64 oracle ({np.abs(y - want).max()})")
    check(np.allclose(y, y1, rtol=DR_TOL, atol=DR_TOL),
          f"dryrun ring: != the 1D program ({np.abs(y - y1).max()})")
    row = {"phase": "dryrun_ring", "parts": P, "rows": DR_RING_ROWS,
           "nnz": DR_RING_ROWS * DR_NNZ_ROW, "bucket_capacity": part_r.capacity,
           "shard0_share": float(counts[:, 0].sum() / counts.sum()),
           "bucket_s": bucket_s, "exe_s": ring_s,
           "max_abs_err_f64": float(np.abs(y - want).max()),
           "max_abs_err_1d": float(np.abs(y - y1).max()),
           "card_temp_bytes": temp, "placed_bytes": resident,
           "fake": {"bytes": fake.bytes, "argument_bytes": fake.argument_bytes,
                    "temp_bytes": fake.temp_bytes, "ops": fake.ops}}
    emit(row)
    del ring, one
    free_card(torch)
    return row


def dr_step_count(torch, device) -> tuple:
    """(b) The sparse qwen1.5-0.5b train step cut to 2 layers at full width
    (f32, phase 15 (d)'s batch) counted on the card (the aten ops'
    FLOPs plus the block kernel's reported work) and on fake CPU tensors
    (the plain versions): FLOPs within 1 %, op by op; the fake argument +
    temp bytes beside ``max_memory_allocated``.  Returns the row and the
    block kernel's launches in the card's step."""
    from repro_torch.analysis.count import counting, fake_mode, fake_tree
    from repro_torch.configs import get_config
    from repro_torch.kernels import instrument
    from repro_torch.launch import steps as S
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, init_opt
    from repro_torch.sparse.layers import strip_derived

    c = dataclasses.replace(get_config(LM_ARCH), ffn_density=0.5, n_layers=2)
    free_card(torch)
    leftover = torch.cuda.memory_allocated()
    params = lm.init_params(torch.Generator(device=device).manual_seed(20), c,
                            torch.float32)
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    opt = init_opt(strip_derived(params), opt_cfg)
    g = torch.Generator(device=device).manual_seed(21)
    toks = torch.randint(0, c.vocab, (2, 64), generator=g, device=device,
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    step = S.make_train_step(c, opt_cfg)
    mode = fake_mode()
    fargs = fake_tree((params, opt, batch), mode)
    with mode, counting(*fargs) as fake:
        step(*fargs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    instrument.reset()
    with counting(params, opt, batch) as card:
        step(params, opt, batch)
    torch.cuda.synchronize()
    launches = instrument.launches("bcoo")
    peak = torch.cuda.max_memory_allocated() - leftover
    want_launches = 3 * 3 * c.n_layers  # forward, recompute, grad x
    check(launches == want_launches, f"dryrun step: {launches} block-kernel "
          f"launches, not {want_launches}")
    ops = sorted(set(card.flops_by_op) | set(fake.flops_by_op))
    differ = {k: [card.flops_by_op[k], fake.flops_by_op[k]] for k in ops
              if card.flops_by_op[k] != fake.flops_by_op[k]}
    rel = abs(card.flops - fake.flops) / fake.flops
    # the issue's form: FlopCounterMode over the plain version on the host
    plain_total = fake.flops - fake.kernel_flops + fake.plain_flops
    rel_plain = abs(card.flops - plain_total) / plain_total
    ratio = (fake.argument_bytes + fake.temp_bytes) / peak
    row = {"phase": "dryrun_step", "arch": LM_ARCH, "n_layers": c.n_layers,
           "ffn_density": c.ffn_density, "dtype": "float32", "tokens": [2, 64],
           "card_flops": card.flops, "card_kernel_flops": card.kernel_flops,
           "card_aten_flops": card.flops - card.kernel_flops,
           "fake_flops": fake.flops, "fake_kernel_flops": fake.kernel_flops,
           "fake_plain_flops": fake.plain_flops, "flops_rel_diff": rel,
           "plain_total_flops": plain_total, "plain_rel_diff": rel_plain,
           "flops_by_op_differ": differ, "card_bytes": card.bytes,
           "fake_bytes": fake.bytes, "fake_argument_bytes": fake.argument_bytes,
           "fake_temp_bytes": fake.temp_bytes, "card_count_temp_bytes":
           card.temp_bytes, "card_peak_bytes": peak,
           "fake_over_card_memory": ratio,
           "memory_in_range": DR_MEM_RANGE[0] <= ratio <= DR_MEM_RANGE[1],
           "launches": launches, "fake_count_s": fake.seconds,
           "card_count_s": card.seconds}
    emit(row)
    check(rel <= DR_FLOP_TOL, f"dryrun step: card FLOPs {card.flops} vs fake "
          f"{fake.flops} ({rel:.3%}); by op {differ}")
    check(rel_plain <= DR_FLOP_TOL, f"dryrun step: card FLOPs {card.flops} vs "
          f"FlopCounterMode over the plain version {plain_total} ({rel_plain:.3%})")
    del params, opt, batch, fargs
    free_card(torch)
    return row, launches


def dr_mfu(times: dict, counts: dict) -> list:
    """(c) Each timed LM row's model FLOPs, the count's useful ratio and
    its MFU against the bf16 peak; xlstm's also from its params' tree."""
    rows = []
    for key, seconds in times.items():
        k = counts[key]
        mf = k["model_flops"]
        row = {"phase": "dryrun_mfu", "row": key, "measured_ms": seconds * 1e3,
               "model_flops": mf, "counted_flops": k["counted_flops"],
               "useful_ratio": mf / k["counted_flops"],
               "compute_bound_ms": mf / BF16_OPS_S * 1e3,
               "mfu": mf / (seconds * BF16_OPS_S), **k}
        if key.startswith("xlstm"):
            arch, kind, B, S = DR_LM_ROWS[key]
            tokens = B * S if kind != "decode" else B
            mult = 6.0 if kind == "train" else 2.0
            mf_tree = mf - mult * (k["n_params"] - k["tree_params"]) * tokens
            row.update(model_flops_tree=mf_tree, mfu_tree=mf_tree /
                       (seconds * BF16_OPS_S))
        emit(row)
        rows.append(row)
    return rows



def dr_times(lm_run, train_run, ed_run, tf_run, da_run) -> dict:
    """(c) The seconds each timed LM step took in its phase of this run."""
    dense = lm_run["times"][0]  # phase 14 (c): bf16, dense
    gemma = da_run["gemma2_serving"]["times"]  # phase 21 (b): bf16, full depth
    out = {"qwen_prefill": dense["prefill_ms"] / 1e3,
           "qwen_decode": dense["decode_ms_per_token"] / 1e3,
           "smollm_train": train_run["dense"]["step_ms_median_last20"] / 1e3,
           "seamless_train": ed_run["train"]["dense"]["step_ms_median"] / 1e3,
           "gemma2_prefill": gemma["prefill_ms"] / 1e3,
           "gemma2_decode": gemma["decode_ms_per_token"] / 1e3,
           "llama_train": da_run["llama"]["train"]["step_ms_median"] / 1e3,
           "llava_prefill": da_run["llava_serving"]["serving"]["prefill_ms"] / 1e3}
    for name in TF_ARCHS:
        out[f"{name}_train"] = tf_run["train"][name]["step_ms_median"] / 1e3
    return out


def phase_dryrun(torch, rng, device, counts_future, times: dict) -> dict:
    """Phase 20: the dry run (see the module docstring).  Returns the COO
    kernel's launches in (a), the block kernel's in (b), the COO kernel's
    row for the kernels line and the rows."""
    t_phase = time.perf_counter()
    parts = [dr_spmv_parts(torch, rng, device, P) for P in DR_PARTS]
    ring = dr_spmv_ring(torch, rng, device)
    step, bcoo_launches = dr_step_count(torch, device)
    t0 = time.perf_counter()
    counts = counts_future.get(timeout=600)
    wait_s = time.perf_counter() - t0
    mfu = dr_mfu(times, counts)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "dryrun_done", "seconds": seconds, "counts_wait_s": wait_s})
    return {"coo_launches": sum(r["launches"] for r in parts),
            "bcoo_launches": bcoo_launches,
            "max_abs_err": max(r["max_abs_err"] for r in parts),
            "parts": parts, "ring": ring, "step": step, "mfu": mfu,
            "seconds": seconds}


# ------------------------------------------- phase 25: training on the mesh

PT_MESHES = ((1, 4), (2, 2))
PT_F32_LAYERS = 2  # the f32 cut held against the one-process port on the card
PT_LOSS_TOL = 1e-5  # relative: f32, 2 layers, sums in another order
PT_GRAD_TOL = 1e-4  # of a leaf's max |g|
PT_PARAM_TOL = 1e-5  # of a leaf's max |p|, where |g| > PT_GRAD_FLOOR · the tree's max |g|
PT_GRAD_FLOOR = 1e-3  # AdamW's first step moves a param by about ±lr·sign(g)
PT_FIRST_TOL, PT_LAST_TOL = 1e-2, 0.05  # bf16, 24 layers: relative to one process
PT_RESUME_TOL = 1e-2  # (1, 4) resumed from (2, 2)'s checkpoint, relative
PT_CKPT_AT = 3  # 5 until phase 25 was cut to 6 steps


def pt_configs() -> dict:
    """qwen1.5-0.5b at full width: bf16 at full depth and its f32 2-layer
    cut, dense and with ``ffn_density=0.5`` in (8, 128) blocks."""
    from repro_torch.configs import get_config

    qwen = get_config(LM_ARCH)
    sparse = dataclasses.replace(qwen, ffn_density=0.5)
    return {"dense": qwen, "sparse": sparse,
            "dense_f32": dataclasses.replace(qwen, n_layers=PT_F32_LAYERS),
            "sparse_f32": dataclasses.replace(sparse, n_layers=PT_F32_LAYERS)}


def pt_opt_cfg():
    """Phase 15's optimizer for qwen (its losses are (b)'s reference)."""
    from repro_torch.optim import AdamWConfig

    return AdamWConfig(lr_peak=1e-3, warmup_steps=3, total_steps=SPARSE_STEPS)


def pt_blocks(torch, tree, shs, how):
    """``how(leaf)`` of every leaf of ``tree``, cut to this rank's block."""
    from repro_torch.tree import leaves

    return [sh.local(how(t)).clone() for t, sh in zip(leaves(tree), shs)]


def pt_f32(torch, world, key: str, shape, seed: int) -> dict:
    """(a) One ``make_train_step`` step of the f32 2-layer cut on ``shape``
    against the one-process port on the card from the same params and
    batch, which every rank computes first and cuts to its blocks: the
    loss, each grad block (the batch-axis sums taken) and each updated
    param block."""
    import torch.distributed as dist

    from repro_torch.core import sharding as SH
    from repro_torch.core.mesh import make_process_mesh
    from repro_torch.launch import steps as S
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, apply_updates, init_opt
    from repro_torch.runtime.elastic import shard_tree
    from repro_torch.sparse.layers import strip_derived, with_derived
    from repro_torch.tree import leaves

    cfg = pt_configs()[key]
    mesh = make_process_mesh(world, shape, ("data", "model"))
    device = mesh.device
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng([seed, 25])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (SPARSE_B, SPARSE_S))
                            .astype(np.int32)).to(device)
    batch = {"tokens": toks, "labels": toks}
    vag = S.value_and_grad_trainable(lm.loss_fn)
    sh = S.mesh_param_shardings(cfg, mesh)
    shs = leaves(sh, is_leaf=lambda x: hasattr(x, "spec"))
    full = lm.init_params(torch.Generator(device=device).manual_seed(25), cfg,
                          torch.float32)
    params = with_derived(shard_tree(strip_derived(full), sh), cfg, mesh)
    loss1, g1 = vag(full, batch, cfg)
    g1 = strip_derived(g1)
    new1, _, _ = apply_updates(strip_derived(full), g1,
                               init_opt(strip_derived(full), opt_cfg), opt_cfg)
    g_max = [float(g.abs().max()) if g.is_floating_point() and g.numel() else 0.0
             for g in leaves(g1)]
    p_max = [float(p.abs().max()) if p.is_floating_point() and p.numel() else 0.0
             for p in leaves(new1)]
    # AdamW's first step moves a param by about ±lr·sign(g): where g is at
    # rounding level against the tree's largest (a key bias's, zero but for
    # rounding: softmax ignores a shift shared by a row's scores), its sign
    # and so the param say nothing
    floor = PT_GRAD_FLOOR * max(g_max)
    g_ref = pt_blocks(torch, g1, shs, lambda t: t)
    big = pt_blocks(torch, g1, shs, lambda t: t.abs() > floor
                    if t.is_floating_point() and t.numel() else t != t)
    p_ref = pt_blocks(torch, new1, shs, lambda t: t)
    del full, g1, new1
    free_card(torch)
    with SH.set_mesh(mesh):
        loss, grads = S.loss_and_grads(params, batch, cfg)
        new, _, metrics = S.make_train_step(cfg, opt_cfg)(
            params, init_opt(strip_derived(params), opt_cfg), batch)
    g_err = p_err = 0.0
    worst = None
    for g, want, m in zip(leaves(grads), g_ref, g_max):
        if g.is_floating_point() and m:
            g_err = max(g_err, float((g - want).abs().max()) / m)
    for i, (p, want, keep) in enumerate(zip(leaves(strip_derived(new)), p_ref, big)):
        if not p.is_floating_point():
            p_err = max(p_err, float(not torch.equal(p, want)))
        elif keep.any():
            diff = torch.where(keep, (p - want).abs(), torch.zeros_like(p))
            e = float(diff.max()) / p_max[i]
            if e > p_err:
                j = int(diff.argmax())
                g = leaves(grads)[i]
                p_err, worst = e, {
                    "leaf": i, "shape": list(p.shape), "max_abs_p": p_max[i],
                    "p": float(p.reshape(-1)[j]), "p_one_process": float(
                        want.reshape(-1)[j]), "g": float(g.reshape(-1)[j]),
                    "g_one_process": float(g_ref[i].reshape(-1)[j]),
                    "max_abs_g": g_max[i]}
    out = {"key": key, "mesh": list(shape), "coords": list(mesh.coords),
           "loss": float(loss), "step_loss": float(metrics["loss"]),
           "one_process_loss": float(loss1),
           "loss_rel_err": abs(float(loss) - float(loss1)) / abs(float(loss1)),
           "grad_rel_err": g_err, "param_rel_err": p_err, "param_worst": worst}
    del params, grads, new, g_ref, p_ref, big
    free_card(torch)
    dist.barrier()
    return out


def pt_timed_loop(torch, TrainLoop, instrument, coll):
    """A TrainLoop that records each step's host ms (ending in a
    synchronize), block-kernel launches and collectives."""

    class Timed(TrainLoop):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.step_ms, self.step_launches, self.step_coll = [], [], []
            inner = self.step_fn

            def step(*a):
                n0, t0 = instrument.launches("bcoo"), time.perf_counter()
                coll.reset()
                out = inner(*a)
                torch.cuda.synchronize()
                self.step_ms.append((time.perf_counter() - t0) * 1e3)
                self.step_launches.append(instrument.launches("bcoo") - n0)
                self.step_coll.append(coll.snapshot())
                return out

            self.step_fn = step
            self.save_s = []

        def save(self):
            t0 = time.perf_counter()
            super().save()
            self.save_s.append(time.perf_counter() - t0)

    return Timed


def pt_ckpt_equal(torch, loop) -> bool:
    """The checkpoint just written, read back onto this rank's blocks, is
    its state bit for bit: over the ranks, the gathered state."""
    from repro_torch.runtime import restore_checkpoint
    from repro_torch.sparse.layers import strip_derived
    from repro_torch.tree import leaves

    live = (strip_derived(loop.params), loop.opt)
    back, step = restore_checkpoint(loop.ckpt_dir, live, device=loop.device,
                                    shardings=(loop.p_sh, loop.o_sh))
    return step == loop.step and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(leaves(back), leaves(live)))


def pt_loop(torch, world, key: str, cfg, opt_cfg, shape, batch: tuple, stop: int,
            ckpt: str | None = None, ckpt_at: int = PT_CKPT_AT,
            resume: bool = False) -> dict:
    """``TrainLoop(mesh=)`` of ``cfg`` (bf16, seeded) on ``TokenStream``
    batches of ``batch`` = (B, S) to step ``stop``, every step counted (its
    collectives, block-kernel launches and host ms ending in a
    synchronize).  With ``ckpt``: write a checkpoint at ``ckpt_at`` and read
    it back onto the rank's blocks, or (``resume``) restore it and run on
    from it.  Phase 25 (b) and (c), phase 27 (b)."""
    import torch.distributed as dist

    from repro_torch.core import sharding as SH
    from repro_torch.core.mesh import make_process_mesh
    from repro_torch.kernels import instrument
    from repro_torch.launch.train import TrainLoop

    mesh = make_process_mesh(world, shape, ("data", "model"))
    coll = SH.collectives(mesh)
    Loop = pt_timed_loop(torch, TrainLoop, instrument, coll)
    B, S = batch
    loop = Loop(cfg, opt_cfg, mesh=mesh, seq_len=S, global_batch=B, ckpt_dir=ckpt,
                ckpt_every=ckpt_at if ckpt and not resume else 10 ** 9)
    t0 = time.perf_counter()
    if resume:
        check(loop.maybe_restore() and loop.step == ckpt_at,
              f"mesh loop {key} {shape}: no checkpoint at step {ckpt_at}")
    else:
        loop.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, saved = [], None
    if ckpt and not resume:
        losses += loop.run(ckpt_at, log_every=0)
        t1 = time.perf_counter()
        saved = pt_ckpt_equal(torch, loop)
        saved_s = time.perf_counter() - t1
        loop.ckpt_every = 10 ** 9
    losses += loop.run(stop, log_every=0)
    med = statistics.median(loop.step_ms[1:]) if len(loop.step_ms) > 1 \
        else loop.step_ms[0]
    row = {"key": key, "mesh": list(shape), "coords": list(mesh.coords),
           "transport": coll.transport, "pinned": getattr(coll, "pinned", None),
           "resumed": resume, "first_step": ckpt_at if resume else 0,
           "losses": losses, "init_s": init_s, "step_ms": loop.step_ms,
           "step_ms_median": med, "tokens_per_s": B * S / med * 1e3,
           "launches": loop.step_launches,
           "coll_calls": [s["calls"] for s in loop.step_coll],
           "coll_bytes": [s["bytes"] for s in loop.step_coll],
           "coll_ms": {k: 1e3 * v for k, v in loop.step_coll[-1]["seconds"].items()},
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "param_bytes": pm_param_bytes(loop.params)}
    if saved is not None:
        row.update(ckpt_equal=saved, ckpt_check_s=saved_s, save_s=loop.save_s)
    del loop
    free_card(torch)
    dist.barrier()
    return row


def pt_kernel(torch, world, seed: int, cfg=None, model_parallel: int = PT_MESHES[0][1],
              tag: int = 25) -> dict:
    """(d) The block kernel on rank 0's run of the sparse qwen's w_gate and
    w_down (``cfg``'s: phase 27 passes zamba2's shared FFN) on (1, 4),
    T = SPARSE_B · SPARSE_S = 1,024, integer-valued bf16:
    the forward on the run and grad x on the run's Wᵀ stream (its block-
    columns counted from the run's first block-row), each bit-equal to the
    plain version, timed beside it and ``torch.matmul`` on the run's dense
    rows (forward) or their transpose (grad x)."""
    import torch.distributed as dist

    from repro_torch.kernels import instrument
    from repro_torch.kernels.bcsr_spmv import (bcoo_spmv, bcoo_spmv_plain,
                                               transposed_values)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sparse.layers import (_balanced_pattern, stream_layout,
                                           with_run, with_transpose)

    cfg = pt_configs()["sparse"] if cfg is None else cfg
    mesh = make_local_mesh(model_parallel, world=world)
    rows_out = []
    if mesh.rank == 0:
        device, T = mesh.device, SPARSE_B * SPARSE_S
        r, c = cfg.sparse_block
        gen = np.random.default_rng([seed, tag, 4])
        for name in ("w_gate", "w_down"):
            d_in, d_out = ffn_dims(cfg)[name]
            browind, bcolind = _balanced_pattern(d_out // r, d_in // c, cfg.ffn_density)
            nb_l = len(browind) // model_parallel
            run = {"browind": torch.from_numpy(browind[:nb_l]).to(device),
                   "bcolind": torch.from_numpy(bcolind[:nb_l]).to(device),
                   "bvalues": torch.from_numpy(gen.integers(-3, 4, (nb_l, r, c))
                                               .astype(np.float32)).to(device,
                                                                       torch.bfloat16)}
            rows, lo, merge = stream_layout(nb_l, d_in, d_out, (r, c),
                                            cfg.ffn_density, mesh)
            local = with_transpose(with_run(run, d_in, d_out, cfg.ffn_density, mesh),
                                   d_in, lo)
            lb = (local["browind"] - lo).contiguous()
            tv = transposed_values(local["bvalues"], local["t_perm"])
            xt = torch.from_numpy(gen.integers(-3, 4, (d_in, T)).astype(np.float32)
                                  ).to(device, torch.bfloat16)
            gy = torch.from_numpy(gen.integers(-3, 4, (rows * r, T)).astype(np.float32)
                                  ).to(device, torch.bfloat16)
            dense = densified(torch, {"browind": lb, "bcolind": local["bcolind"],
                                      "bvalues": local["bvalues"]}, d_in, rows * r)
            cases = {
                "forward": (lambda: bcoo_spmv(lb, local["bcolind"], local["bvalues"], xt,
                                              rows * r, browptr=local["browptr"]),
                            lambda: bcoo_spmv_plain(lb, local["bcolind"],
                                                    local["bvalues"], xt, rows * r),
                            lambda: dense @ xt,
                            lm_bound(nb_l, r, c, rows, d_in, rows * r, T)),
                "grad_x": (lambda: bcoo_spmv(local["t_browind"], local["t_bcolind"], tv,
                                             gy, d_in, browptr=local["t_browptr"]),
                           lambda: bcoo_spmv_plain(local["t_browind"],
                                                   local["t_bcolind"], tv, gy, d_in),
                           lambda: dense.T @ gy,
                           lm_bound(nb_l, c, r, d_in // c, rows * r, d_in, T)),
            }
            for what, (kern, plain, lib, (bound, by)) in cases.items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                instrument.reset()
                ms = time_ms(torch, kern, PM_TIMED)
                rows_out.append({
                    "name": name, "pass": what, "T": T, "nb": nb_l, "block_rows": rows,
                    "first_block_row": lo, "merge": merge,
                    "kernel_equals_plain": bool(torch.equal(got, want)),
                    "max_abs_err": max_err(torch, got, want), "ms": ms,
                    "timed_launches": instrument.launches("bcoo"),
                    "plain_ms": time_ms(torch, plain, 2, warmup=1),
                    "library_ms": time_ms(torch, lib, PM_TIMED),
                    "bound_ms": bound, "bound_by": by})
            del dense, xt, gy, tv, local, run
        free_card(torch)
    dist.barrier()
    return {"rows": rows_out}


def pt_train(torch, world, seed: int, ckpt_root: str) -> dict:
    """Phase 25 on this rank: (a), (b) with (c), (d), one path at a time
    for all ranks (every path frees the card before the next); rank 0
    prints each path's seconds."""

    def path(name, fn, *args, **kw):
        t0 = time.perf_counter()
        res = fn(torch, world, *args, **kw)
        if world.rank == 0:
            emit({"phase": "train_mesh_progress", "path": name,
                  "seconds": time.perf_counter() - t0})
        return res

    out = {"f32": [path(f"f32 {key} {shape}", pt_f32, key, shape, seed)
                   for shape in PT_MESHES for key in ("dense_f32", "sparse_f32")]}
    ckpt = os.path.join(ckpt_root, "phase25_ckpt")
    runs = (("dense", PT_MESHES[1], ckpt, False), ("dense", PT_MESHES[0], ckpt, True),
            ("dense", PT_MESHES[0], None, False), ("sparse", PT_MESHES[0], None, False),
            ("sparse", PT_MESHES[1], None, False))
    out["loops"] = [path(f"loop {key} {shape}{' resumed' if resume else ''}", pt_loop,
                         key, pt_configs()[key], pt_opt_cfg(), shape,
                         (SPARSE_B, SPARSE_S), SPARSE_STEPS, ckpt=c, resume=resume)
                    for key, shape, c, resume in runs]
    out["kernel"] = path("kernel", pt_kernel, seed)
    return out


def pt_references(torch, device) -> dict:
    """(b)'s one-process reference where phase 15 did not run in this
    process: phase 15's qwen loops (the same seeds, batches and optimizer),
    dense and sparse, ``SPARSE_STEPS`` losses each."""
    from repro_torch.launch.train import TrainLoop

    out = {}
    for key in ("dense", "sparse"):
        loop = TrainLoop(pt_configs()[key], pt_opt_cfg(), seq_len=SPARSE_S,
                         global_batch=SPARSE_B, device=device)
        loop.init_state()
        out[key] = loop.run(SPARSE_STEPS, log_every=0)
        del loop
        free_card(torch)
    return out


def pt_checks(torch, ranks, ref_losses: dict, card: str) -> dict:
    """Phase 25's rows, every one emitted before any is checked; returns
    its block-kernel launches on the main path and the kernel's largest
    error."""
    from repro_torch.analysis import sharded as SHD

    cfgs = pt_configs()
    f32 = [[r["train"]["f32"][i] for r in ranks]
           for i in range(len(ranks[0]["train"]["f32"]))]
    loops = [[r["train"]["loops"][i] for r in ranks]
             for i in range(len(ranks[0]["train"]["loops"]))]
    krows = ranks[0]["train"]["kernel"]["rows"]
    for per in f32:
        emit({"phase": "train_mesh_f32", "key": per[0]["key"], "mesh": per[0]["mesh"],
              "n_layers": PT_F32_LAYERS, "batch": SPARSE_B, "seq": SPARSE_S,
              "loss_rel_err": max(r["loss_rel_err"] for r in per),
              "grad_rel_err": max(r["grad_rel_err"] for r in per),
              "param_rel_err": max(r["param_rel_err"] for r in per),
              "bounds": [PT_LOSS_TOL, PT_GRAD_TOL, PT_PARAM_TOL],
              "ranks": per, "card": card})
    closed = []
    for per in loops:
        row0 = per[0]
        cfg = cfgs[row0["key"]]
        want = SHD.train_collectives(cfg, tuple(row0["mesh"]), SPARSE_B, SPARSE_S,
                                     cfg.remat)
        want_l = SHD.train_block_kernel_launches(cfg)
        closed.append((want, want_l))
        emit({"phase": "train_mesh", "key": row0["key"], "arch": cfg.name,
              "mesh": row0["mesh"], "n_layers": cfg.n_layers, "dtype": "bfloat16",
              "batch": SPARSE_B, "seq": SPARSE_S, "transport": row0["transport"],
              "resumed": row0["resumed"], "losses": row0["losses"],
              "one_process_losses": ref_losses[row0["key"]],
              "closed_form": {"launches": want_l, **want},
              "step_ms_median": max(r["step_ms_median"] for r in per),
              "tokens_per_s": min(r["tokens_per_s"] for r in per),
              "ranks": [{k: v for k, v in r.items() if k not in ("coll_calls",
                                                                 "coll_bytes")}
                        for r in per], "card": card})
    emit({"phase": "train_mesh_kernel", "arch": LM_ARCH, "mesh": list(PT_MESHES[0]),
          "rank": 0, "rows": krows, "card": card})
    for per in f32:
        for row in per:
            who = f"train mesh f32 {row['key']} {row['mesh']} at {row['coords']}"
            check(row["loss_rel_err"] <= PT_LOSS_TOL,
                  f"{who}: loss {row['loss']} vs one process {row['one_process_loss']}")
            check(row["grad_rel_err"] <= PT_GRAD_TOL,
                  f"{who}: grads {row['grad_rel_err']:.3g} of max |g|")
            check(row["param_rel_err"] <= PT_PARAM_TOL,
                  f"{who}: params {row['param_rel_err']:.3g} of the leaf's max |p|: "
                  f"{row['param_worst']}")
    launches = 0
    for per, (want, want_l) in zip(loops, closed):
        row0 = per[0]
        ref = ref_losses[row0["key"]]
        for row in per:
            who = f"train mesh {row['key']} {row['mesh']} at {row['coords']}"
            got = row["losses"]
            check(len(got) == (SPARSE_STEPS - PT_CKPT_AT if row["resumed"]
                               else SPARSE_STEPS) and all(np.isfinite(got)),
                  f"{who}: losses {got}")
            check(got == row0["losses"], f"{who}: losses differ from rank 0's")
            if not row["resumed"]:
                check(abs(got[0] - ref[0]) <= PT_FIRST_TOL * abs(ref[0]),
                      f"{who}: first loss {got[0]} vs one process {ref[0]}")
            check(abs(got[-1] - ref[-1]) <= PT_LAST_TOL * abs(ref[-1]),
                  f"{who}: last loss {got[-1]} vs one process {ref[-1]}")
            check(all(c == want["calls"] for c in row["coll_calls"])
                  and all(b == want["bytes"] for b in row["coll_bytes"]),
                  f"{who}: collectives a step {row['coll_calls']} / "
                  f"{row['coll_bytes']} != closed form {want}")
            check(all(n == want_l for n in row["launches"]),
                  f"{who}: block-kernel launches a step {row['launches']}, "
                  f"closed form {want_l}")
            if "ckpt_equal" in row:
                check(row["ckpt_equal"], f"{who}: the checkpoint at step "
                      f"{PT_CKPT_AT} != the ranks' state")
            launches += row["launches"][-1]
    dense22, resumed = loops[0][0], loops[1][0]
    check(all(abs(a - b) <= PT_RESUME_TOL * abs(b) for a, b in
              zip(resumed["losses"], dense22["losses"][PT_CKPT_AT:])),
          f"train mesh: (1, 4) resumed {resumed['losses']} vs (2, 2) "
          f"{dense22['losses'][PT_CKPT_AT:]}")
    for row in krows:
        check(row["kernel_equals_plain"], f"train mesh kernel {row['name']} "
              f"{row['pass']}: != the plain version")
        check(row["timed_launches"] == PM_TIMED + 3,
              f"train mesh kernel {row['name']} {row['pass']}: timed "
              f"{row['timed_launches']} launches")
    return {"launches": launches,
            "max_abs_err": max(row["max_abs_err"] for row in krows)}


# ------- phase 27: training the recurrent kinds and the enc-dec on the mesh

PQ_MESH = {"zamba2": (1, 4), "xlstm": (2, 2), "seamless": (2, 2)}
PQ_F32 = ("zamba2_f32", "xlstm_f32", "seamless_f32")
# (a): one f32 step a path at B = 4, S = 32 (and 32 stub frames a row for
# seamless): PERF.md section 7 says why not longer (the decays' f32 sums
# turn an ulp into 1e-5 of a logit at 128 tokens)
PQ_B, PQ_S = 4, 32
# (a)'s limits, phase 25's: the loss relative, each grad block of its leaf's
# max |g|, each param block of its leaf's max |p| where |g| > PT_GRAD_FLOOR
# of the tree's max |g|.  A reading whose control (the one-process step
# from the weights moved by an epsilon, ``pr_nudged``) is past its limit
# is held to PR_F32_CONTROL_X times the control, and the row says the
# limit was not met (xlstm's grads: PERF.md section 6)
PQ_BOUNDS = {"loss": PT_LOSS_TOL, "grads": PT_GRAD_TOL, "params": PT_PARAM_TOL}
PQ_ED_LAYERS = 4  # (b): seamless cut to 4 + 4 layers, phase 18's batches
PQ_ED_STEPS = 3
PQ_RESUME_MESH = (2, 2)  # (b): zamba2's dense run resumes here from (1, 4)'s checkpoint
PQ_CKPT_AT = 5  # (b): the checkpoint's step, resumed for steps 6 to TF_STEPS


def pq_configs() -> dict:
    """Phase 27's configs, all at full width: the f32 cuts of phase 26
    (zamba2 at 6 layers sparse, xlstm at 8, seamless at 2 + 2 sparse);
    phase 19's bf16 zamba2 (6 layers, dense and sparse) and xlstm (8);
    seamless cut to 4 + 4 layers, dense and sparse."""
    from repro_torch.configs import get_config

    s = dataclasses.replace(get_config("seamless-m4t-medium"), n_layers=PQ_ED_LAYERS,
                            encoder_layers=PQ_ED_LAYERS)
    rec = pr_configs()
    out = {key: rec[key] for key in PQ_F32}
    out.update({"zamba2_dense": tf_cfg("zamba2-2.7b"),
                "zamba2_sparse": tf_cfg("zamba2-2.7b", ffn_density=0.5),
                "xlstm": tf_cfg("xlstm-1.3b"), "seamless_dense": s,
                "seamless_sparse": dataclasses.replace(s, ffn_density=0.5)})
    return out


def pq_opt_cfg():
    """(a)'s AdamW, as phase 25's f32 steps."""
    from repro_torch.optim import AdamWConfig

    return AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)


def pq_batch(torch, cfg, seed: int, device) -> dict:
    """(a)'s global batch: tokens (the labels too) and seamless's f32 stub
    frames, (B, S) and (B, S, d)."""
    rng = np.random.default_rng([seed, 27, cfg.n_layers, cfg.vocab])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (PQ_B, PQ_S)).astype(np.int32))
    batch = {"tokens": toks.to(device), "labels": toks.to(device)}
    if cfg.encoder_layers:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (PQ_B, PQ_S, cfg.d_model)).astype(np.float32)).to(device)
    return batch


def pq_ed_batches(torch, cfg, device) -> list:
    """(b)'s seamless batches: phase 18's first PQ_ED_STEPS (``TokenStream``
    seed 18, B = 4 x 256, bf16 frames (4, 256, 1,024) from seed 184)."""
    from repro_torch.data.tokens import TokenStream

    stream = TokenStream(cfg.vocab, SPARSE_S, SPARSE_B, seed=18)
    fgen = torch.Generator(device=device).manual_seed(184)
    out = []
    for i in range(PQ_ED_STEPS):
        batch = dict(stream.batch(i, device))
        batch["frames"] = torch.randn((SPARSE_B, SPARSE_S, cfg.d_model), generator=fgen,
                                      device=device).to(torch.bfloat16)
        out.append(batch)
    return out


def pq_ed_opt_cfg():
    """Phase 18's AdamW."""
    from repro_torch.optim import AdamWConfig

    return AdamWConfig(lr_peak=1e-3, warmup_steps=3, total_steps=SPARSE_STEPS)


def pq_one_step(torch, params, batch, cfg) -> tuple:
    """(loss, grads, updated params) of one one-process f32 step (the
    reference's trees, the port-only keys stripped)."""
    from repro_torch.launch import steps as S
    from repro_torch.optim import apply_updates, init_opt
    from repro_torch.sparse.layers import strip_derived

    opt_cfg = pq_opt_cfg()
    loss, grads = S.loss_and_grads(params, batch, cfg)
    base = strip_derived(params)
    new, _, _ = apply_updates(base, grads, init_opt(base, opt_cfg), opt_cfg)
    return float(loss), grads, new


def pq_names(tree, prefix: str = "") -> list:
    """The paths of a param tree's leaves, in ``repro_torch.tree`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in pq_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def pq_errors(torch, loss, grads, new, ref_loss, ref_g, ref_p, g_max, p_max, floor,
              names) -> tuple:
    """A step against the one-process one: the loss's relative error, each
    grad leaf's (or block's) largest error over the leaf's max |g|, each
    param's over the leaf's max |p| where the reference |g| > ``floor``
    (the lists are the trees' leaves, blocks or whole, in one order);
    and the leaves (``names``) where the grads and params err most.  The
    per-leaf errors stay on the device until one read at the end."""
    errs = {"grads": [], "params": []}
    for g, want, m, name in zip(grads, ref_g, g_max, names):
        if g.is_floating_point() and m:
            errs["grads"].append((name, (g.float() - want.float()).abs().max() / m))
    for p, want, g, m, name in zip(new, ref_p, ref_g, p_max, names):
        if not p.is_floating_point():
            errs["params"].append((name, (p != want).any().float()))
        elif m:
            keep = g.abs() > floor  # 0 where no element is kept
            diff = (p.float() - want.float()).abs() * keep
            errs["params"].append((name, diff.max() / m))
    out = {"loss": abs(loss - ref_loss) / abs(ref_loss)}
    worst = {}
    for k, pairs in errs.items():
        vals = torch.stack([e.float() for _, e in pairs]).tolist() if pairs else []
        i = int(np.argmax(vals)) if vals else None
        out[k] = float(vals[i]) if vals else 0.0
        worst[k] = pairs[i][0] if vals and vals[i] > 0 else None
    return out, worst


def pq_references(torch, seed: int, device, ref: dict, root: str) -> dict:
    """Phase 27's one-process answers on the card, into ``ref`` and under
    ``root``: (a) each f32 cut's step from the seeded init (seed 0, as
    ``mesh_params``'): its loss, each leaf's max |g| and |p|, its grads
    and updated params written as a checkpoint for the ranks to read their
    blocks from, and its control (the same step from the weights moved by
    an epsilon, ``pr_nudged``) against it; (b) seamless's 4 + 4-layer bf16
    steps, dense and sparse.  Returns each part's seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch import steps as S
    from repro_torch.models import lm
    from repro_torch.optim import init_opt
    from repro_torch.runtime import save_checkpoint
    from repro_torch.sparse.layers import strip_derived
    from repro_torch.tree import leaves

    cfgs, seconds = pq_configs(), {}
    # each path's checkpoint written beside the later paths' steps (its
    # tensors held until then)
    writer, writes = ThreadPoolExecutor(1), []
    for key in PQ_F32:
        t0 = time.perf_counter()
        cfg = cfgs[key]
        batch = pq_batch(torch, cfg, seed, device)
        params = lm.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                                torch.float32)
        loss, g, new = pq_one_step(torch, params, batch, cfg)
        writes.append(writer.submit(save_checkpoint,
                                    os.path.join(root, f"phase27_{key}"), 0, (g, new)))
        g_l, p_l = leaves(g), leaves(new)
        g_max = [float(t.abs().max()) if t.is_floating_point() and t.numel() else 0.0
                 for t in g_l]
        p_max = [float(t.abs().max()) if t.is_floating_point() and t.numel() else 0.0
                 for t in p_l]
        floor = PT_GRAD_FLOOR * max(g_max)
        ref.update({f"{key}|loss": loss, f"{key}|g_max": np.array(g_max),
                    f"{key}|p_max": np.array(p_max), f"{key}|floor": floor})
        nudged = pr_nudged(torch, params, seed)
        del params
        c_loss, c_g, c_new = pq_one_step(torch, nudged, batch, cfg)
        control, worst = pq_errors(torch, c_loss, leaves(c_g), leaves(c_new), loss, g_l,
                                   p_l, g_max, p_max, floor, pq_names(g))
        ref.update({f"{key}|control|{k}": v for k, v in control.items()})
        ref.update({f"{key}|control_leaf|{k}": str(v) for k, v in worst.items()})
        del nudged, g, new, c_g, c_new, g_l, p_l
        free_card(torch)
        seconds[key] = time.perf_counter() - t0
    for key in ("seamless_dense", "seamless_sparse"):
        t0 = time.perf_counter()
        cfg = cfgs[key]
        params = ed_params(torch, lm, cfg, 0, device)
        opt_cfg = pq_ed_opt_cfg()
        opt = init_opt(strip_derived(params), opt_cfg)
        step = S.make_train_step(cfg, opt_cfg)
        losses = []
        for batch in pq_ed_batches(torch, cfg, device):
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
        ref[f"{key}|losses"] = np.array(losses)
        del params, opt
        free_card(torch)
        seconds[key] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for w in writes:
        w.result()
    writer.shutdown()
    seconds["writes_left"] = time.perf_counter() - t0
    return seconds


def pq_families_references(torch, device) -> dict:
    """(b)'s zamba2 and xlstm references where phase 19 did not run in this
    process: its loops (the same seeds, batches and optimizer) on one
    device, dense zamba2 for TF_STEPS steps, sparse for TF_SPARSE_STEPS,
    xlstm for TF_STEPS."""
    from repro_torch.launch.train import TrainLoop

    out = {}
    for key, steps_ in (("zamba2_dense", TF_STEPS), ("zamba2_sparse", TF_SPARSE_STEPS),
                        ("xlstm", TF_STEPS)):
        cfg = pq_configs()[key]
        B, S = tf_shape(cfg)
        loop = TrainLoop(cfg, tf_opt(cfg, steps_), seq_len=S, global_batch=B,
                         device=device)
        loop.init_state()
        out[key] = loop.run(steps_, log_every=0)
        del loop
        free_card(torch)
    return out


def pq_params(torch, cfg, mesh, dtype):
    """This rank's blocks of the seeded params (seed 0, as ``mesh_params``'
    seeded init): every rank draws the whole tree at once and keeps its
    blocks, the same values as ``seeded_blocks``' turns (which keep one
    full tree at a time on a shared card, for the full-depth models)."""
    from repro_torch.launch.serve import mesh_params
    from repro_torch.models import lm

    full = lm.init_params(torch.Generator(device=mesh.device).manual_seed(0), cfg,
                          dtype)
    return mesh_params(cfg, mesh, dtype, params=full)


def pq_f32(torch, world, key: str, seed: int, ref, root: str) -> dict:
    """(a) One ``make_train_step`` step of an f32 cut on its mesh, counted
    (collectives, block-kernel launches, peak): the loss and each grad
    block it computes (``launch.steps.loss_and_grads`` captured in it) and
    each updated param block against the one-process step's, whose blocks
    the rank reads from the parent's checkpoint."""
    import torch.distributed as dist

    from repro_torch.core import sharding as SH
    from repro_torch.kernels import instrument
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import init_opt
    from repro_torch.runtime import restore_checkpoint
    from repro_torch.sparse.layers import strip_derived
    from repro_torch.tree import leaves

    cfg = pq_configs()[key]
    shape = PQ_MESH[pr_arch(key)]
    mesh = make_local_mesh(shape[1], world=world)
    coll = SH.collectives(mesh)
    t0 = time.perf_counter()
    params = pq_params(torch, cfg, mesh, torch.float32)
    batch = pq_batch(torch, cfg, seed, mesh.device)
    opt_cfg = pq_opt_cfg()
    torch.cuda.synchronize()
    seconds = {"init": time.perf_counter() - t0}
    step = S.make_train_step(cfg, opt_cfg)
    inner, seen = S.loss_and_grads, {}

    def captured(*args):  # the step's own loss and grads (it does not donate)
        seen["loss"], seen["grads"] = inner(*args)
        return seen["loss"], seen["grads"]

    opt = init_opt(strip_derived(params), opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    coll.reset()
    instrument.reset()
    S.loss_and_grads = captured
    try:
        t0 = time.perf_counter()
        with SH.set_mesh(mesh):
            new, _, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        S.loss_and_grads = inner
    launches = instrument.launches("bcoo")
    counted = coll.snapshot()
    loss, grads = seen["loss"], seen["grads"]
    peak = torch.cuda.max_memory_allocated()
    sh = S.mesh_param_shardings(cfg, mesh)
    new = strip_derived(new)
    del params, opt
    seconds["step"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (g_ref, p_ref), _ = restore_checkpoint(os.path.join(root, f"phase27_{key}"),
                                           (grads, new), device=mesh.device,
                                           shardings=(sh, sh))
    seconds["restore"] = time.perf_counter() - t0
    errs, worst = pq_errors(torch, float(loss), leaves(grads), leaves(new),
                            float(ref[f"{key}|loss"]), leaves(g_ref), leaves(p_ref),
                            ref[f"{key}|g_max"].tolist(), ref[f"{key}|p_max"].tolist(),
                            float(ref[f"{key}|floor"]), pq_names(grads))
    out = {"key": key, "mesh": list(shape), "coords": list(mesh.coords),
           "loss": float(loss), "step_loss": float(metrics["loss"]),
           "one_process_loss": float(ref[f"{key}|loss"]), "rel_err": errs,
           "worst_leaf": worst, "seconds": seconds,
           "control": {k: float(ref[f"{key}|control|{k}"]) for k in errs},
           "control_leaf": {k: str(ref[f"{key}|control_leaf|{k}"]) for k in worst},
           "step_ms": step_ms, "launches": launches, "coll_calls": counted["calls"],
           "coll_bytes": counted["bytes"], "peak_allocated_bytes": peak,
           "param_bytes": pm_param_bytes(new)}
    del grads, new, g_ref, p_ref
    free_card(torch)
    dist.barrier()
    if world.rank == 0:  # every rank has read its blocks
        shutil.rmtree(os.path.join(root, f"phase27_{key}"), ignore_errors=True)
    return out


def pq_ed(torch, world, key: str) -> dict:
    """(b) seamless cut to 4 + 4 layers through ``make_train_step`` on (2,
    2): phase 18's batches, with bf16 frames, from the seeded init, each
    step counted as ``pt_loop``'s."""
    import torch.distributed as dist

    from repro_torch.core import sharding as SH
    from repro_torch.kernels import instrument
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import init_opt
    from repro_torch.sparse.layers import strip_derived

    cfg = pq_configs()[key]
    shape = PQ_MESH["seamless"]
    mesh = make_local_mesh(shape[1], world=world)
    coll = SH.collectives(mesh)
    t0 = time.perf_counter()
    params = pq_params(torch, cfg, mesh, torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    opt_cfg = pq_ed_opt_cfg()
    opt = init_opt(strip_derived(params), opt_cfg)
    step = S.make_train_step(cfg, opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, launches, counted = [], [], [], []
    with SH.set_mesh(mesh):
        for batch in pq_ed_batches(torch, cfg, mesh.device):
            torch.cuda.synchronize()
            coll.reset()
            instrument.reset()
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(instrument.launches("bcoo"))
            counted.append(coll.snapshot())
    med = statistics.median(step_ms[1:])
    row = {"key": key, "mesh": list(shape), "coords": list(mesh.coords),
           "transport": coll.transport, "resumed": False, "first_step": 0,
           "losses": losses, "init_s": init_s, "step_ms": step_ms,
           "step_ms_median": med,
           "launches": launches,
           "coll_calls": [c["calls"] for c in counted],
           "coll_bytes": [c["bytes"] for c in counted],
           "coll_ms": {k: 1e3 * v for k, v in counted[-1]["seconds"].items()},
           "tokens_per_s": SPARSE_B * SPARSE_S / med * 1e3,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "param_bytes": pm_param_bytes(params)}
    del params, opt, step
    free_card(torch)
    dist.barrier()
    return row


def pq_paths(torch, world, seed: int, ref, root: str) -> dict:
    """Phase 27 on this rank: (a) the f32 steps, (b) the bf16 runs (zamba2
    dense to its checkpoint on (1, 4) and on from it on (2, 2); zamba2
    sparse; xlstm; seamless dense and sparse), (c) rank 0's runs of
    zamba2's shared FFN; rank 0 prints each path's seconds."""

    def path(name, fn, *args, **kw):
        t0 = time.perf_counter()
        res = fn(torch, world, *args, **kw)
        if world.rank == 0:
            emit({"phase": "train_recurrent_mesh_progress", "path": name,
                  "seconds": time.perf_counter() - t0})
        return res

    t0 = time.perf_counter()
    out = {"f32": [path(f"f32 {key}", pq_f32, key, seed, ref, root) for key in PQ_F32]}
    ckpt = os.path.join(root, "phase27_ckpt")
    z = PQ_MESH["zamba2"]
    # phase 19's bf16 runs: its seeded init, batches and optimizer
    runs = (("zamba2_dense", z, PQ_CKPT_AT, ckpt, False),
            ("zamba2_dense", PQ_RESUME_MESH, TF_STEPS, ckpt, True),
            ("zamba2_sparse", z, TF_SPARSE_STEPS, None, False),
            ("xlstm", PQ_MESH["xlstm"], TF_STEPS, None, False))
    cfgs = pq_configs()
    out["loops"] = [path(f"loop {key} {shape}{' resumed' if resume else ''}", pt_loop,
                         key, cfgs[key], tf_opt(cfgs[key], TF_SPARSE_STEPS if key ==
                                                "zamba2_sparse" else TF_STEPS),
                         shape, tf_shape(cfgs[key]), n, ckpt=c, ckpt_at=PQ_CKPT_AT,
                         resume=resume)
                    for key, shape, n, c, resume in runs]
    if world.rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    out["loops"] += [path(f"steps {key}", pq_ed, key)
                     for key in ("seamless_dense", "seamless_sparse")]
    out["kernel"] = path("kernel", pt_kernel, seed, pq_configs()["zamba2_sparse"],
                         PQ_MESH["zamba2"][1], 27)
    out["seconds"] = time.perf_counter() - t0
    return out


def pq_closed_forms(torch, key: str, shape, B: int, S: int, itemsize: int,
                    S_mem: int) -> dict:
    """A path's closed forms: the collectives and block-kernel launches of
    one step over (B, S) (and S_mem frames a row), its param bytes."""
    from repro_torch.analysis import sharded as SHD

    cfg = pq_configs()[key]
    dtype = {2: torch.bfloat16, 4: torch.float32}[itemsize]
    coll = SHD.train_collectives(cfg, tuple(shape), B, S, cfg.remat, itemsize=itemsize,
                                 S_mem=S_mem if cfg.encoder_layers else 0)
    return {"coll": coll, "launches": SHD.train_block_kernel_launches(cfg),
            "param_bytes": SHD.param_bytes(cfg, tuple(shape), dtype)}


def pq_checks(torch, ranks, info: dict, fam_ref: dict, ref: dict, card: str) -> dict:
    """Phase 27's rows and checks (every row emitted before any check)."""
    rows, fails = [], []

    def need(cond, msg):
        if not cond:
            fails.append(msg)

    res = [r["trainrec"] for r in ranks]
    for i, key in enumerate(PQ_F32):
        per = [r["f32"][i] for r in res]
        want = pq_closed_forms(torch, key, per[0]["mesh"], PQ_B, PQ_S, 4, PQ_S)
        worst = {k: max(row["rel_err"][k] for row in per) for k in per[0]["rel_err"]}
        met = {k: worst[k] <= PQ_BOUNDS[k] for k in PQ_BOUNDS}
        for row in per:
            who = f"train recurrent mesh f32 {key} at {row['coords']}"
            for k, bound in PQ_BOUNDS.items():
                e, ctl = row["rel_err"][k], row["control"][k]
                # the limit, or where rounding alone (the control) moves the
                # reading past it, PR_F32_CONTROL_X times the control
                gate = PR_F32_CONTROL_X * ctl if ctl > bound else bound
                need(e <= gate, f"{who}: {k} {e:.3g} (limit {bound}, control "
                     f"{ctl:.3g}, gate {gate:.3g}; worst leaf {row['worst_leaf']})")
            need(row["coll_calls"] == want["coll"]["calls"]
                 and row["coll_bytes"] == want["coll"]["bytes"],
                 f"{who}: collectives {row['coll_calls']} / {row['coll_bytes']} != "
                 f"closed form {want['coll']}")
            need(row["launches"] == want["launches"], f"{who}: {row['launches']} "
                 f"block-kernel launches, closed form {want['launches']}")
            need(row["param_bytes"] == want["param_bytes"],
                 f"{who}: {row['param_bytes']} param bytes, the specs {want['param_bytes']}")
            need(row["peak_allocated_bytes"] >= row["param_bytes"],
                 f"{who}: peak below its params")
        rows.append({"phase": "train_recurrent_mesh_f32", "key": key,
                     "mesh": per[0]["mesh"], "batch": PQ_B, "seq": PQ_S,
                     "rel_err": worst, "control": per[0]["control"],
                     "control_leaf": per[0]["control_leaf"], "bounds": PQ_BOUNDS,
                     "limit_met": met, "control_x": PR_F32_CONTROL_X,
                     "closed_form": {"launches": want["launches"], **want["coll"]},
                     "reference_s": info.get(key), "ranks": per, "card": card})
    launches = 0
    loops = [[r["loops"][i] for r in res] for i in range(len(res[0]["loops"]))]
    for per in loops:
        row0 = per[0]
        key = row0["key"]
        cfg = pq_configs()[key]
        B, S = (SPARSE_B, SPARSE_S) if cfg.encoder_layers else tf_shape(cfg)
        want = pq_closed_forms(torch, key, row0["mesh"], B, S, 2, SPARSE_S)
        one = (ref[f"{key}|losses"].tolist() if cfg.encoder_layers else fam_ref[key])
        one = one[row0["first_step"]:row0["first_step"] + len(row0["losses"])]
        for row in per:
            who = f"train recurrent mesh {key} {row['mesh']} at {row['coords']}"
            got = row["losses"]
            need(len(got) == len(one) and all(np.isfinite(got)), f"{who}: losses {got}")
            need(got == row0["losses"], f"{who}: losses differ from rank 0's")
            if not row["resumed"]:
                need(abs(got[0] - one[0]) <= PT_FIRST_TOL * abs(one[0]),
                     f"{who}: first loss {got[0]} vs one process {one[0]}")
            need(abs(got[-1] - one[-1]) <= PT_LAST_TOL * abs(one[-1]),
                 f"{who}: last loss {got[-1]} vs one process {one[-1]}")
            need(all(c == want["coll"]["calls"] for c in row["coll_calls"])
                 and all(b == want["coll"]["bytes"] for b in row["coll_bytes"]),
                 f"{who}: collectives a step {row['coll_calls']} / {row['coll_bytes']} "
                 f"!= closed form {want['coll']}")
            need(all(n == want["launches"] for n in row["launches"]),
                 f"{who}: block-kernel launches a step {row['launches']}, closed form "
                 f"{want['launches']}")
            need(row["param_bytes"] == want["param_bytes"],
                 f"{who}: {row['param_bytes']} param bytes, the specs {want['param_bytes']}")
            need(row["peak_allocated_bytes"] >= row["param_bytes"],
                 f"{who}: peak below its params")
            if "ckpt_equal" in row:
                need(row["ckpt_equal"], f"{who}: the checkpoint at step {PQ_CKPT_AT} "
                     "!= the ranks' state")
            launches += row["launches"][-1]
        rows.append({"phase": "train_recurrent_mesh", "key": key, "arch": cfg.name,
                     "mesh": row0["mesh"], "n_layers": cfg.n_layers,
                     "encoder_layers": cfg.encoder_layers, "dtype": "bfloat16",
                     "batch": B, "seq": S, "transport": row0["transport"],
                     "resumed": row0["resumed"], "losses": row0["losses"],
                     "one_process_losses": one,
                     "closed_form": {"launches": want["launches"], **want["coll"]},
                     "step_ms_median": max(r["step_ms_median"] for r in per),
                     "tokens_per_s": min(r["tokens_per_s"] for r in per),
                     "reference_s": info.get(key),
                     "ranks": [{k: v for k, v in r.items()
                                if k not in ("coll_calls", "coll_bytes")} for r in per],
                     "card": card})
    krows = res[0]["kernel"]["rows"]
    for row in krows:
        need(row["kernel_equals_plain"], f"train recurrent mesh kernel {row['name']} "
             f"{row['pass']}: != the plain version")
        need(row["timed_launches"] == PM_TIMED + 3, f"train recurrent mesh kernel "
             f"{row['name']} {row['pass']}: timed {row['timed_launches']} launches")
    rows.append({"phase": "train_recurrent_mesh_kernel", "arch": "zamba2-2.7b",
                 "mesh": list(PQ_MESH["zamba2"]), "rank": 0, "rows": krows, "card": card})
    seconds = max(r["seconds"] for r in res)
    rows.append({"phase": "train_recurrent_mesh_done", "launches": launches,
                 "ranks_s": seconds, "reference_s": sum(info.values()), "card": card})
    for row in rows:
        emit(row)
    for msg in fails:
        check(False, msg)
    return {"launches": launches,
            "max_abs_err": max(row["max_abs_err"] for row in krows),
            "seconds": seconds + sum(info.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels import _build, instrument  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: repro_torch not found beside this script: {e}",
              file=sys.stderr)
        return 2
    # (c)'s counts run on the host in a worker while the card's phases run
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        return run(args, torch, pool.apply_async(dr_lm_counts))
    finally:
        pool.terminate()
        pool.join()


def run(args, torch, counts_future) -> int:
    """Every phase, in order (see the module docstring)."""
    from repro_torch.kernels import _build, instrument  # noqa: F401

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 in the oracles
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    for line in ptxas_lines(_build):
        print(line)
    hmma = sass_mma_counts(_build, "bcoo_spmv")
    emit({"phase": "sass", "kernel": "bcoo_spmv", "hmma": hmma})
    if "cuobjdump" not in hmma:  # both f32 tensor-core kernels issue mma
        for kern in ("bcoo_mma_kernel<f,", "bcoo_mma_reg_kernel<f,"):
            check(any(n.startswith(kern) for n in hmma),
                  f"no HMMA in {kern}...>: {hmma}")
    emit({"phase": "build", "seconds": build_s, "kernels": list(_build.SOURCES)})

    errs = {k: 0.0 for k in KERNELS}
    phase_kernels(torch, rng, device, 1 << 16, errs,
                  np.random.default_rng([args.seed, 64]))
    records = []
    launches, requests = phase_main_path(
        torch, rng, device, (1 << 21, 1 << 21, 1 << 20), errs, records)
    check(launches == requests, f"launch counters {launches} != requests {requests}")
    times = phase_times(torch, rng, device, records)
    phase_pieces(torch, rng, device, records)
    phase_ell_kernel(torch, rng, device, 1 << 16, errs)
    ell_launches, ell_times = phase_ell_path(torch, rng, device, records, errs)
    part_launches, part_rows, autos = phase_partitioned(torch, rng, device,
                                                        records, 1 << 16)
    rng10 = np.random.default_rng([args.seed, 10])  # phases 1-9 draw as before
    t10 = time.perf_counter()
    solver_launches = phase_solver(torch, rng10, device, records, autos, times)
    solver_s = time.perf_counter() - t10
    t13 = time.perf_counter()
    small, small_autos = small_records(torch, np.random.default_rng([args.seed, 13, 1]),
                                       device)
    topo_launches = phase_topology(torch, np.random.default_rng([args.seed, 13]),
                                   device, small, small_autos)
    del small_autos
    topology_s = time.perf_counter() - t13
    del autos
    gc.collect()
    serve_launches_, eng = phase_serving(torch, rng, device, records, args.seed)
    t10 = time.perf_counter()
    solver_serve = phase_solver_service(torch, rng10, device, eng, records)
    solver_s += time.perf_counter() - t10
    del eng
    gc.collect()
    t11 = time.perf_counter()
    tune_launches = phase_tuning(torch, np.random.default_rng([args.seed, 11]),
                                 device, small)
    del small
    tuning_s = time.perf_counter() - t11
    records.clear()  # free the main path's plans for the dense oracles
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "memory", "allocated_bytes": torch.cuda.memory_allocated()})
    oracle_launches, solver_replay_ = phase_serving_oracle(
        torch, rng, device, 1 << 16, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    cluster_launches = phase_cluster(torch, np.random.default_rng([args.seed, 12]),
                                     device, CLUSTER_N, args.seed, times)
    cluster_s = time.perf_counter() - t12
    gc.collect()
    torch.cuda.empty_cache()
    lm_run = phase_lm(torch, np.random.default_rng([args.seed, 14]), device)
    gc.collect()
    torch.cuda.empty_cache()
    train_run = phase_train(torch, np.random.default_rng([args.seed, 15]), device)
    gc.collect()
    torch.cuda.empty_cache()
    moe_run = phase_moe(torch, np.random.default_rng([args.seed, 16]), device)
    free_card(torch)
    la_run = phase_linear_attn(torch, np.random.default_rng([args.seed, 17]), device)
    free_card(torch)
    ed_run = phase_enc_dec(torch, np.random.default_rng([args.seed, 18]), device)
    free_card(torch)
    tf_run = phase_train_families(torch, np.random.default_rng([args.seed, 19]), device)
    free_card(torch)
    da_run = phase_dense_archs(torch, np.random.default_rng([args.seed, 21]), device)
    free_card(torch)
    ex_run = phase_examples(torch, device)
    free_card(torch)
    pw_run = phase_process_mesh(torch, args.seed, device)
    free_card(torch)
    tf_losses = {key: tf_run["train"][name]["losses"] for key, name in (
        ("zamba2_dense", "zamba2-2.7b"), ("zamba2_sparse", "zamba2-2.7b:sparse"),
        ("xlstm", "xlstm-1.3b"))}
    pm_run = phase_lm_mesh(torch, args.seed, device, train_ref={
        key: train_run["sparse"][key]["losses"] for key in ("dense", "sparse")},
        families_ref=tf_losses)
    free_card(torch)
    dr_run = phase_dryrun(torch, np.random.default_rng([args.seed, 20]), device,
                          counts_future,
                          dr_times(lm_run, train_run, ed_run, tf_run, da_run))

    by_path = {
        kernel: {"single_device": launches[kind],
                 "partitioned": part_launches[kind],
                 "serving": serve_launches_[kind] + oracle_launches[kind],
                 "solver": (solver_launches[kind] + solver_serve[kind]
                            + solver_replay_[kind]),
                 "tuning": tune_launches[kind],
                 "cluster": cluster_launches[kind],
                 "topology": topo_launches[kind]}
        for kernel, kind in (("coo_spmv", "coo"), ("bcoo_spmv", "bcoo"))
    }
    by_path["bcoo_spmv"]["lm_serving"] = lm_run["launches"]
    by_path["bcoo_spmv"]["lm_training"] = train_run["launches"]
    by_path["bcoo_spmv"]["lm_moe"] = moe_run["launches"]
    by_path["bcoo_spmv"]["lm_hybrid"] = la_run["launches"]
    by_path["bcoo_spmv"]["lm_enc_dec"] = ed_run["launches"]
    by_path["bcoo_spmv"]["lm_train_families"] = tf_run["launches"]
    by_path["bcoo_spmv"]["lm_dense_archs"] = da_run["launches"]
    by_path["coo_spmv"]["examples"] = ex_run["launches"]["coo"]
    by_path["bcoo_spmv"]["examples"] = ex_run["launches"]["bcoo"]
    by_path["coo_spmv"]["process_mesh"] = pw_run["launches"]["coo"]
    by_path["bcoo_spmv"]["process_mesh"] = pw_run["launches"]["bcoo"]
    by_path["coo_spmv"]["world_engine"] = pw_run["engine"]["launches"]["coo"]
    by_path["bcoo_spmv"]["world_engine"] = pw_run["engine"]["launches"]["bcoo"]
    by_path["bcoo_spmv"]["lm_mesh"] = pm_run["launches"]
    by_path["bcoo_spmv"]["lm_mesh_train"] = pm_run["train_launches"]
    by_path["bcoo_spmv"]["lm_mesh_recurrent"] = pm_run["rec_launches"]
    by_path["bcoo_spmv"]["lm_mesh_train_recurrent"] = pm_run["trec_launches"]
    by_path["coo_spmv"]["dryrun"] = dr_run["coo_launches"]
    by_path["bcoo_spmv"]["dryrun"] = dr_run["bcoo_launches"]
    by_path["ell_spmv"] = {"ell": ell_launches}
    main_shape = {"coo_spmv": ("regular", "coo", 1), "bcoo_spmv": ("block", "bcoo", 1)}
    times["ell_spmv"] = ell_times["regular"]
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = times[main_shape.get(name, name)]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "also_replaces": ALSO_REPLACES.get(name, []),
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": max([errs[name]] + ([dr_run["max_abs_err"]]
                                               if name == "coo_spmv" else [])
                               + [t["max_abs_err"] for t in pw_run["engine"]["tiles"]
                                  if t["kernel"] == name]
                               + ([lm_run["max_abs_err"],
                                                train_run["max_abs_err"],
                                                moe_run["max_abs_err"],
                                                la_run["max_abs_err"],
                                                ed_run["max_abs_err"],
                                                tf_run["max_abs_err"],
                                                da_run["max_abs_err"],
                                                pm_run["max_abs_err"]]
                                               if name == "bcoo_spmv" else [])),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "solver_phase_s": solver_s, "tuning_phase_s": tuning_s,
          "cluster_phase_s": cluster_s, "topology_phase_s": topology_s,
          "lm_phase_s": lm_run["seconds"], "train_phase_s": train_run["seconds"],
          "moe_phase_s": moe_run["seconds"],
          "linear_attn_phase_s": la_run["seconds"],
          "enc_dec_phase_s": ed_run["seconds"],
          "train_families_phase_s": tf_run["seconds"],
          "dense_archs_phase_s": da_run["seconds"],
          "examples_phase_s": ex_run["seconds"],
          "process_mesh_phase_s": pw_run["seconds"],
          "world_engine_phase_s": pw_run["engine"]["seconds"],
          "lm_mesh_phase_s": pm_run["seconds"],
          "lm_mesh_train_phase_s": pm_run["train_seconds"],
          "lm_mesh_recurrent_phase_s": pm_run["rec_seconds"],
          "lm_mesh_train_recurrent_phase_s": pm_run["trec_seconds"],
          "dryrun_phase_s": dr_run["seconds"],
          "card": card})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
