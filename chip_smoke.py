#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the root of a checkout

The paths, each driven with the launch counts set to zero just before it and
read just after (the stencil paths through ``repro_torch``'s spec -> plan ->
solver):

  - the paper's Table-1 experiment — the 5-point Laplace Jacobi solve on a
    64x64 grid with bc=1, rtol=1e-6 and check_every=20, run to convergence —
    through K1-K3, plus the sizes at which the card does real work
    (phases 3-6);
  - the paper's Fig-6 experiment — the 7-point Laplace Jacobi solve on a
    (Z, X, Y) = (10, 64, 64) grid, same settings — and the paper's full
    problem, 50,000 such grids (2048 M elements), through K4 (phases 8-9);
  - the paper's dense-layer encoding (Algorithm 1) on the Table-1 grid,
    65,536 instances, through K5 (phase 10);
  - the LM substrate's serve path at qwen3-0.6b's full width (28 layers,
    random weights from a seed): batched prefill through K7, once a layer,
    then greedy decode, as ``python -m repro_torch.launch.serve --arch
    qwen3-0.6b --batch 4 --prompt-len 2048 --tokens 32`` runs it
    (phases 13-14);
  - its training path at the same width: bf16 train steps off fp32 masters
    with layer groups under checkpoint, the chunked cross-entropy and
    AdamW, attention through K7 (twice a layer: forward and recompute) and
    the backward kernels K8/K9 (once a layer), as ``python -m
    repro_torch.launch.train --arch qwen3-0.6b --global-batch 4 --seq-len
    2048 --steps 5`` runs it (phases 17-18);
  - the stencil serving tier: the measured autotuner, the multigrid
    V-cycle, and the coalescing engine over the bucketed plan cache, as
    ``repro_torch.serve.ServingEngine`` serves it (phases 20-22);
  - the ssm and hybrid LM families at full width and depth (mamba2-370m:
    48 Mamba2 layers, no attention, none of K1-K9; zamba2-1.2b: 38 Mamba2
    layers and one shared attention block applied after each of its six
    groups, K7 six times a forward at head_dim 64 and K8/K9 six times a
    backward), served and trained as ``launch.serve`` and ``launch.train``
    run them (phases 24-26);
  - the moe LM family (qwen3-moe-30b-a3b: 128 experts, top 8, attention
    GQA 8; moonshot-v1-16b-a3b: 64 experts, top 6, two shared experts,
    MHA 16), served at full width and depth (48 layers, 61.1 and 57.8 GB
    of bf16 weights, K7 once a layer in a prefill) and trained at full
    width cut to 4 layers (K7 twice a layer, K8/K9 once), through
    ``launch.serve`` and ``launch.train`` (phases 27-29);
  - the vlm family (qwen2-vl-2b: 28 layers, 1.78 B parameters, M-RoPE, GQA
    6) and the encdec family (whisper-tiny: 4 encoder and 4 decoder
    layers, 69 M parameters), served and trained at full width and depth
    through ``launch.serve`` and ``launch.train``: K7 once a qwen2-vl layer
    in a forward, and in whisper once an encoder layer (non-causal, 1500
    frames) and twice a decoder layer (causal self-attention and the
    non-causal cross-attention on the 1500 frames), K8/K9 once each in a
    backward (phases 30-32);
  - the dense family's last archs (glm4-9b: 40 layers, GQA 16 on 2 kv
    heads; phi3-medium-14b: 40 layers, GQA 4 on 10; nemotron-4-15b: 32
    layers, GQA 6 on 8, squared ReLU in an ungated MLP), served at full
    width and depth (18.8, 29.3 and 31.3 GB of bf16 weights, K7 once a
    layer in a prefill) and trained at full width cut in depth (K7 twice
    a layer, K8/K9 once), through ``launch.serve`` and ``launch.train``
    (phases 33-34);
  - the training runtime's checkpoint and restart: qwen3-0.6b at full
    width through ``python -m repro_torch.launch.train`` with
    ``--checkpoint-every 2 --fail-at-step 3``, then restarted, then run
    uninterrupted (phase 35);
  - halo distribution on a tile mesh (every tile on the one card): the
    Table-1 solve through ``solve(backend="halo", mesh=make_mesh((2,
    2)))``, and an 8192x8192 grid, per-cell taps and the autotuner's halo
    sweep over 2x4 (phase 36);
  - LM distribution on a 2x4 ("data", "model") mesh, every shard on the
    one card, one process driving the 8 (``parallel/sharding.py``'s
    ``Sharder``; the sharded ``prefill``, ``decode_step``, train step and
    ``launch.serve``/``launch.train`` with ``sharder=``): qwen3-0.6b on
    the tp profile at full width and depth (K7/K8/K9 on each shard's 4 q
    heads), glm4-9b's kv_seq-sharded decode cache, phi3-medium-14b on the
    sp profile (K7/K8/K9 on sequence shards at their kv_offset), and
    qwen3-0.6b through ``parallel.pipeline.gpipe`` (phase 37);
  - every other LM family on that mesh through its shard program
    (``StackedModel.sharded``), at full width cut in depth
    (``FAM_DEPTH``): qwen3-moe-30b-a3b's and moonshot-v1-16b-a3b's expert
    parallelism served, mamba2-370m's and zamba2-1.2b's head sharding and
    qwen2-vl-2b on the sp profile served and trained, whisper-tiny on sp
    served whole (phase 38);
  - the differentiable solve, ``repro_torch.core.implicit_solve`` on the
    card's default plan cache (its backward one solve with the transposed
    operator; ``F.conv2d`` and shifted adds, none of K1-K9), and the
    learned-stencil family training through ``make_train_step`` at full
    width (32x32, 20 AdamW steps at batch 8) (phase 23).

Phases, one JSON line each:

  1. the card and the build: nvidia-smi's name and power limit, torch and
     CUDA versions, then every ``csrc/*.cu`` compiled with nvcc;
  2. each kernel against its plain PyTorch version on the card (K1
     stencil2d; K2 trapezoid, its stream kernel and the tile kernel before
     it by name; K3 resident, its register kernel, the cta kernel and the
     one-CTA kernel before both by name; K4 stencil3d: fp32 within 1e-5
     and bf16 within
     2e-2 absolute; past the kernels' former limits, the 49-tap 2D and
     343-tap 3D radius-3 boxes through K1, K2 and K4, K2 at fuse 64 at
     radius 1 and 2, and resident grids past one CTA up to the JAX
     package's 8 MiB (169x169, 512x512, 1024x2048 at fuse 1, 8 and 512)
     through the grid-wide kernel, fp32 to 0.0; K5 dense_stencil_matmul,
     a GEMM on the tensor cores whose sums run in another order than its
     plain version's library product: each element within 1e-4 + 1e-4 *
     |plain| in fp32, 2e-2 + 1e-2 * |plain| in bf16, about one bf16 ulp
     plus the summation order; the fp32 route's split kernel bit-equal to
     ``split_bf16x3``; fp32 K5 within 2^-20 of |x| . |W| from
     ``dense_stencil_split_plain``, the same six piece products in plain
     PyTorch; and fp32 K5's designed cases of tests/_torch_dense_cases.py,
     ``perm_exact`` to 0.0 and ``w_pieces`` within 2 fp32 ulps);
  3. the Table-1 solve through cuda_fused, cuda, conv and reference (7960
     iterations on the CPU; within one 20-iteration chunk here), each solved
     twice and the second timed, then the same number of fixed iterations
     in one resident pass;
  4. a heterogeneous 1024x1024 solve through K1, against the plain version;
  5. full size: an 8192x8192 fp32 grid, 1024 iterations through cuda_fused
     (trapezoid, fuse 16) and 64 through cuda at fuse 1, and a resident
     plan of 512 iterations on a 1024x1024 grid (one pass of the
     grid-wide kernel) against its plain version;
  6. a batch of 1024 Table-1 instances in one Solver call;
  7. K1-K3 timed: launches on their path (phases 3-6), errors, and times
     of each kernel, its plain version and a library call, the kernels'
     read from CUDA-graph replays (device time without the host's gaps
     between launches), with the eager times beside them; K2 at 8192x8192
     fuse 1 and 16 and at the Table-1 launch (which the shape sends to the
     register kernel; its row is named for that kernel and counts the
     Table-1 solve's own launches) and K3 at 7960 steps each beside the
     kernels it replaced, asked for by name; phase 6's launch (1024
     Table-1 grids, fuse 4) through each kernel; the grid-wide resident
     kernel at 1024x1024 fuse 512 (its cooperative launch replays in a
     graph) beside the stream kernel's passes on the same request;
  8. Fig 6 through cuda, conv, conv3d_native and reference (620 iterations
     on the CPU: exactly that, with the CPU's residual, through cuda and
     reference; within one chunk through the cuDNN paths), and a
     heterogeneous Fig-6 solve (640 on the CPU);
  9. the paper's full problem, 50,000 Fig-6 grids in fp32, and one
     256x512x512 grid, 20 iterations each through cuda (K4), held against
     the plain version on a slice of the batch;
 10. the dense row of Table 1 (64x64, N=4096, 7 iterations) through
     ``ops.dense_jacobi_kernel`` on 65,536 instances, held against one
     ``jacobi2d`` call (fuse 1, which the shape sends to K3's register
     kernel) on the whole batch to 1e-5 absolute: past gridDim.z's 65,535
     the wrapper launches the batch in slices (two launches an
     iteration); fp32 K5 splits x and W each iteration (two split
     launches);
 11. K4 and K5 timed at those shapes by CUDA-graph replay, against their
     bounds, their plain versions, and F.conv3d, the channels-trick
     F.conv2d and torch.matmul (TF32 off); K4 also with its cell kernel
     asked for by name (the kernel of every K4 launch before the streaming
     one), and on 1, 16 and 32 Fig-6 grids with the kernel the shape picks
     and each of the two by name; fp32 K5's bound is 2 S N^2 at the bf16
     tensor-core rate, its six products' time at that rate beside it; K5
     also held against its plain
     version at the dense path's shape in fp32 and bf16, timed in bf16
     beside its plain version and torch.matmul in bf16, its split pass
     timed on its own, and
     fp32 K5 and torch.matmul held to an fp64 product with random W (max
     |y - y64| / (|x| . |W|), at most 2^-20 for K5); the HGMMA
     instructions of each K5 instance (none fails) and its ptxas report (a
     spill fails);
 12. K6 (flash_attention) and K7 (flash_fwd) against their plain versions
     (bf16 runs the tensor-core kernel, fp32 the SIMT one): MHA, GQA 2:1 on
     a ragged 96, MQA, non-causal, cross lengths with kv_offset=128,
     head_dim 16/32/64/128, fp32 and bf16, the serve prefill's shape (4
     x 2048, 16 heads, 8 kv heads, hd 128, bf16) and zamba2-1.2b's (4 x
     2048, 32 heads, MHA, hd 64, bf16), the moe archs' (4 x 2048, GQA 8:
     32 heads on 4; MHA 16; hd 128, bf16), a ragged cross-attention
     without the mask (40 on 150) and a non-causal GQA-6 self-attention
     over three tiles (fp32 and bf16), qwen2-vl's (4 x 2048, GQA 6, hd 128,
     causal), whisper's encoder (16 x 1500, MHA 6, hd 64, non-causal) and
     cross-attention (16 x 224 on 1500, non-causal), the dense archs'
     (4 x 2048, hd 128, causal: glm4 32 heads on 2, phi3 40 on 10,
     nemotron 48 on 8) in bf16, and
     ``p_rounding``, built
     so that a kernel that does not round p to v's type before p . v misses
     by about 0.026; out per element within 2e-5 in fp32 and 2e-3 + 1.6e-2
     * |plain| in bf16 (two bf16 ulps), lse within 1e-5 of its max-abs;
     beside it, as a diagnostic, the serve shape against the plain version
     at the bf16 kernel's own 128 x 128 tiles;
 13. the serve path in fp32 at full width, batch 2, a 1000-token prompt
     (ragged against every block), 16 greedy tokens, attn_impl "flash"
     against "xla": the last prefill hidden within 1e-4 of its max-abs, K7
     launched once a layer and no other kernel, the tokens of both runs
     (a disagreement fails only where the xla run's top-2 logit margin
     there exceeds 1e-3 of its max-abs logit);
 14. the main path: ``launch.serve.serve`` in bf16, batch 4, 2048-token
     prompts, 32 tokens (prefill ms and tokens/s, decode ms/token, peak
     memory, K7 launches), then one more prefill and LM_PROFILE_TOKENS
     decode steps of the same model under torch.profiler: device ms by
     kernel and the device's idle share;
 15. K6 and K7 timed by CUDA-graph replay at the serve shape (and K7 at
     zamba2's, at qwen3-moe's GQA 8, at qwen2-vl's and whisper's
     encoder and cross shapes and at the dense archs' GQA 16, 4 and 6)
     beside their
     bound, their plain version and F.scaled_dot_product_attention (the
     library yardstick, timed here only; the port never calls it); the
     HGMMA instructions of each bf16 instance (``cuobjdump -sass`` of the
     built library: none fails) and its ptxas report (a spill fails);
 16. K8 (flash_bwd_dq) and K9 (flash_bwd_dkv) against their plain versions
     (bf16 runs the tensor-core kernels, fp32 the SIMT ones), o and lse
     from K7: the cases of tests/_torch_flash_cases.py (``FLASH_CASES``:
     those of phase 12 and the training shape, qwen2-vl's, whisper's and
     the dense archs')
     in fp32 and bf16, zamba2's and the moe archs' shapes in bf16 (K9
     folding a group of 8; at the moe, qwen2-vl and whisper shapes dq's
     and dk's bf16 bounds allow one flipped rounding of ds,
     ``ds_flip_atol``),
     ``ds_rounding``, built so that a K8 that does not round ds to k's type
     misses by 16 times the bound, and ``dv_p_rounding``, built so that a
     K9 that rounds p before p^T . do misses by 86 times; dq, dk, dv per
     element within 2e-5 + 1e-5 * |plain| in fp32 and K6/K7's bf16 bound;
     and a rerun of the bf16 kernels at the training shape, bit-equal (no
     atomics);
 17. the loss and gradients of an fp32 train step at full width, batch 2,
     1000 tokens (ragged against every tile), attn_impl "flash" against
     "xla" from the same weights and batch: loss within 1e-5 relative,
     every parameter's grad within 1e-4 of its max-abs, K7 launched 56
     times and K8/K9 28 each, and nothing on the xla step;
 18. the main path: ``launch.train.train`` in bf16, 4 x 2048 tokens, 5
     steps (ms a step and tokens/s over steps 2-5, peak memory, per-step
     loss and grad norm, all finite, K7/K8/K9 launched 56/28/28 times a
     step), then one more step of a fresh model under torch.profiler:
     device ms by kernel and the device's idle share;
 19. K8 and K9 timed by CUDA-graph replay at the training shape (and at
     zamba2's, qwen3-moe's, qwen2-vl's, whisper's and the dense archs')
     in bf16
     beside their bounds, their plain versions and the backward of
     F.scaled_dot_product_attention (the library yardstick, timed with
     torch.autograd.grad; the port never calls it); the HGMMA instructions
     of each bf16 instance (none fails) and its ptxas report (a spill
     fails);
 20. the autotuner: ``autotune_cell`` on Table 1 (64x64, 32 iterations),
     the heterogeneous 1024x1024, 8192x8192 (16) and Fig 6 (10x64x64):
     every legal candidate measured (none failing, none interpreted), µs an
     iteration each, the lookup under this card's name returning the
     fastest, and the JAX package's CPU table winning no cell here;
 21. multigrid V-cycles, bc 1 from zeros: Table 1 and the heterogeneous
     65x65 at rtol 1e-5 (13 and 5 cycles, BENCH_stencil.json's rows) and
     1e-6 (18 and 6, the CPU's), each against the reference backend on the
     card (the same cycles, fields within 1e-6), then 4097x4097 through K2
     (11 levels) and 257^3 through K4 at rtol 1e-6: cycles, levels, work
     units, wall and residual;
 22. the serving engine over one PlanCache: 256 Jacobi requests (64, 60,
     56 and 48 square at bc 1 and 0.5, each with its own source: eight
     groups on one 64x64 bucket entry), 16 ``cuda_fused`` requests (an
     exact entry, K3's register kernel) and 4 multigrid requests on
     1025x1025, all at once: solves/s, p50/p99 latency, mean batch and the
     cache's stats; every result against its request solved on its own
     shape, 3 cache misses and no rebuild or dropped probe candidate, and
     coalesced solves/s at least 5x cold-serial (a fresh cache a request).
The line after phase 22 lists the kernels phases 20-22 launched.
 23. the differentiable solve on the default cache (``adjoint_phase``):
     JAX's adjoint benchmark cell (heterogeneous 64x64 from seed 0, a
     random source, 200 fixed iterations through ``conv``): forward and
     value-and-grad ms (CUDA events, median of 7 after a warm-up), their
     ratio, the backend the bucket ran, the device operations a solve
     launches and the device's idle share under torch.profiler; a solve of
     the same spec converged to rtol 1e-6: the gradients of <r, x*> in its
     fields, source and scalar bc within 1e-4 of the largest entry of the
     CPU port's, and within JAX's TOL (rtol 1e-3, atol 2e-3) of
     fourth-order central differences at eps 1e-2 of the exact float64
     fixed point (a direct solve) on 8 cells of each, x0's gradient
     exactly 0; 1024 Table-1 instances (bc 1) sharing one field stack,
     each with its own source, forward and gradient wall and solves/s; and
     ``get_config("learned-stencil")`` trained 20 steps through
     ``make_train_step`` (examples/learned_stencil.py's hidden-kappa data
     at batch 8, AdamW at lr 1e-2): losses, ms a step, iterations a solve,
     the last loss below the first; no K1-K9 launch.
 24. mamba2-370m and zamba2-1.2b served as ``launch.serve.serve`` runs
     them: bf16, batch 4, 2048-token prompts, 32 greedy tokens (prefill ms
     and tokens/s, decode ms/token, peak memory, launches: none for
     mamba2, K7 six a prefill for zamba2), then one more prefill and
     decode under torch.profiler: device ms by kernel and the idle share;
 25. fp32 at full width: (a) batch 2, a 1000-token prompt (ragged against
     the 256-token SSD chunk), 16 greedy tokens, each decode step's
     logits within 2e-4 (mamba2) and 3e-3 (zamba2) of their max-abs from
     the train-mode forward's over the prompt and the tokens so far (the
     comment at ``SSM_DECODE_RTOL`` says why), and the first step again
     from a wrong cache (the conv halo reversed; zamba2's attention cache
     one place short) past that bound; (b) zamba2's flash against xla as
     phase 13 (prefill hidden within 3e-3, tokens where the top-2 margin
     passes 3e-3); (c) the card against the CPU port on a depth-cut model
     of the same weights (mamba2 2 layers, zamba2 one group, its shared
     block and the tail: 8 layers), batch 2 x 300 tokens, prefill hidden
     within 1e-4;
 26. bf16 training as ``launch.train.train`` runs it, 3 steps at 4 x 2048
     tokens (ms a step and tokens/s over steps 2-3, peak memory, every
     loss and grad norm finite; zamba2 K7/K8/K9 12/6/6 a step, mamba2
     none).
 27. qwen3-moe-30b-a3b and moonshot-v1-16b-a3b served as
     ``launch.serve.serve`` runs them at full width and depth: bf16, batch
     4, 2048-token prompts, 32 greedy tokens (prefill ms and tokens/s,
     decode ms/token, peak memory; the build's peak past the model, within
     one layer slice's fp32 draw; K7 48 a prefill, none in decode), then
     one more prefill and decode under torch.profiler: device ms by
     operation class and the idle share;
 28. fp32 at full width, depth cuts: (a) 4 layers, batch 2, a 1024-token
     prompt, 16 greedy tokens, each decode step's logits against the
     train-mode forward over the tokens so far, with one group a call and
     a capacity of the whole group (``tests/_torch_moe_cases.
     no_drop_config``: decode's group of B then routes as the forward's,
     and no token count has to divide 1024), and the first step again from
     a cache one place short and with the first token's two slots' gates
     swapped, which must fail it; (b) the prefill hidden, flash against
     xla, at the config's own 1024-token groups; (c) the card against the
     CPU port, 2 layers, 2 x 512 tokens; (d) einsum against scatter
     dispatch on one layer at the configs' capacity factor (slots drop),
     the output and the gradients of <out, r> + aux.  Each bound comes
     from tests/_torch_moe_noise.py --card (``MOE_*_RTOL``);
 29. bf16 training as ``launch.train.train`` runs it, 4 layers (the cut
     that leaves the 16 B a parameter of the train state inside the
     card), 3 steps at 4 x 2048 tokens (ms a step and tokens/s over steps
     2-3, peak memory, the aux loss per layer, every loss and grad norm
     finite; K7/K8/K9 8/4/4 a step).
 30. qwen2-vl-2b at full width and depth (``vlm_encdec_phases``): served
     in bf16 as ``launch.serve.serve`` runs it, 4 prompts of 2048 tokens
     whose first 1024 positions are vision embeddings drawn from the seed,
     with Qwen2-VL's M-RoPE ids for a 32 x 32 patch grid (vision token i at
     (0, i // 32, i % 32), text token j at 32 + j on all three channels),
     32 greedy tokens (K7 28 a prefill, none in decode); a profiled
     prefill and decode by operation class; then 5 bf16 train steps of 4
     x 2048 through ``launch.train.train`` on vision embeddings and grid
     ids drawn the same way (the launcher's zero stub, JAX's, overflows
     the gradients at this depth: ROADMAP §3) (K7/K8/K9 56/28/28 a step,
     every loss and grad norm finite);
 31. whisper-tiny the same way: batch 16, 1500 frames drawn from the seed,
     a 224-token decoder prompt, 32 greedy tokens (max_len 257; K7 12 a
     prefill), a profiled prefill and decode, 5 train steps of 16 x 448
     decoder tokens over 1500 drawn frames (K7/K8/K9 24/12/12 a step);
 32. fp32 checks: (a) decode against the train-mode forward, qwen2-vl at
     4 layers (2 x 1100 tokens, 1024 of them vision, 16 steps; the
     forward carries the grid ids and then kv_len on every channel, JAX's
     decode rule) and whisper at one encoder and one decoder layer (2 x
     224 on 1500 frames, 16 steps; deeper, its random model is chaotic in
     fp32, ``VE_FP32_CUT``), and the first step again with a fault
     planted, which must fail it: qwen2-vl's M-RoPE sections swapped in
     the prefill, whisper's cross-attention run causal in the forward and
     its encoder's sinusoid one position late in the prefill; (b) the
     prefill hidden, flash against xla; (c) the card against the CPU at a
     smaller cut.  Each bound comes from tests/_torch_vlm_encdec_noise.py
     --card (``VE_*_RTOL``).
 33. glm4-9b, phi3-medium-14b and nemotron-4-15b (``dense_ft_phases``):
     each first held in fp32 against the CPU port on 2 layers of the same
     weights (2 x 128 tokens, the prefill hidden within 3e-4, 6e-4 and
     4e-6 of its max-abs, bounds from tests/_torch_dense_noise.py --card),
     then
     served in bf16 at full width and depth as ``launch.serve.serve``
     runs it, batch 4, 2048-token prompts, 32 greedy tokens (prefill ms
     and tokens/s, decode ms/token, peak memory; K7 once a layer a
     prefill, none in decode), and one more prefill and decode profiled
     by operation class;
 34. each trained in bf16 as ``launch.train.train`` runs it, 3 steps at 4
     x 2048 tokens, at the depth ``DENSE_TRAIN_DEPTH`` gives (glm4 and
     phi3 4 layers, nemotron 1: its embed and head are 3.15 B of the 16 B
     a parameter the train state takes), K7/K8/K9 2/1/1 a layer a step;
 35. qwen3-0.6b at full width, bf16, 4 x 2048, 4 steps through
     ``launch.train.main``: checkpointed every 2 steps and killed by
     ``--fail-at-step 3`` (it must raise ``InjectedFailure``), restarted
     (it must resume from step 2), then run uninterrupted into a second
     directory; the final losses and every array of the two last
     checkpoints (params, m and v, 9.02 GB each; a digest of the params)
     bit-equal, the seconds and bytes of each save and restore recorded,
     the free disk checked first.
 36. halo distribution on a tile mesh, every tile on cuda:0
     (``halo_phase``; plain PyTorch, none of K1-K9 may launch): (a) Table 1
     over 2x2 through ``solve(backend="halo")``, the iteration count and
     the field bit-equal to the ``reference`` solve's, the wall ms and the
     fuse picked; (b) 8192x8192 fp32 over 2x4 (4096x2048 tiles), 64 steps
     through ``make_plan(backend="halo")`` at fuse 1 and 16, each bit-equal
     to ``reference``, with ms an iteration, exchanges, bytes and device
     operations an exchange beside phase 7's K2 stream kernel on the same
     grid; (c) per-cell taps on 1024x1024 over 2x4, fuse 4, 64 steps,
     bit-equal to ``reference``; (d) ``autotune_halo_cell`` on the scaling
     bench's fuse-sweep cell, 128x256 over 2x4, µs an iteration at fuse 1,
     2, 4 and 8; (e) phase 6's 1024 Table-1 grids over a 2x2x2 ("batch",
     "data", "model") mesh through ``make_halo_runner(...,
     batch_axis="batch")``, 2000 steps at fuse 20, bit-equal to
     ``reference``.  Under 120 s.
 37. LM distribution on a 2x4 ("data", "model") mesh, every shard on
     cuda:0 (``lm_distribution_phase``): K7-K9 first held against their
     plain versions at every shard shape the paths launch (bf16 and fp32
     tp shards of qwen3-0.6b, glm4-9b's tp shard, phi3-medium-14b's four
     sp shards at kv_offset 0-1536, a pipeline microbatch; fp32 at
     qwen3-0.6b's whole shape too) and timed beside SDPA (a boolean mask
     at an offset); (a) qwen3-0.6b, tp, full width and depth: fp32
     prefill and decode logits and a train step's loss and grads,
     sharded against unsharded within 3 times the unsharded run's
     distance from float64 (xla, the ``.float()`` points widened); bf16
     served (4 x 2048, 8 tokens) and trained one step, sharded and
     unsharded, timed, the sharded prefill, decode and step profiled;
     (b) glm4-9b, tp, bf16 at full depth: prefill and 8 decode steps at
     max_len 2112 (model 4 divides it: the cache shards on kv_seq), the
     logits within 3 times the unsharded run's distance from an fp32 run
     of the same weights, and never tighter than 3e-2; (c)
     phi3-medium-14b, sp: the bf16 prefill at full depth and the loss and
     grads of 4 layers, each within that bound of the unsharded run, then
     one sharded step timed; (d) qwen3-0.6b through ``gpipe`` (4 stages
     of 7 layers, 4 microbatches), fp32 loss and grads against the
     unpipelined step (phase 17's bounds).  K7 8 a layer on a sharded
     path (16 in a train step), K8/K9 8; 4 a layer through the pipeline.
 38. every other LM family on phase 37's mesh, every shard on cuda:0
     (``families_distribution_phase``): K7-K9 first held against their
     plain versions at the new shard shapes (qwen3-moe's tp shards of its
     8 x 4096 prefill and its 4-layer step, moonshot's, zamba2's shared
     attention's, qwen2-vl's four sp shards, whisper's decoder self and
     cross shards and its encoder whole on each shard; fp32 at the fp32
     checks' shapes) and timed beside SDPA; (a) qwen3-moe-30b-a3b, tp:
     fp32 at 2 layers (8 x 4096: the MoE groups split over data), the
     sharded prefill and decode logits and a step's loss and grads within
     DIST_X times the unsharded run's distance from float64, the first
     MoE layer's routing the same on every shard of a data row and as
     unsharded but at fp32 ties; bf16 at 12 of 48 layers (FAM_DEPTH),
     prefill 8 x 4096 and 4 decode tokens sharded and unsharded,
     the logits within DIST_BF16_RATIO of the unsharded run's distance
     from an fp32 run (a layer in fp32 at a time), each layer's tokens
     routed otherwise, the experts' device ms and the combine's adds; a
     4-layer bf16 step sharded and unsharded, the loss within DIST_X of
     the unsharded's distance from fp32; (b) moonshot-v1-16b-a3b, tp, the
     scatter dispatch, served at 12 layers as (a); (c) mamba2-370m (4
     layers) and zamba2-1.2b (7), tp, (d) qwen2-vl-2b (4), sp, with drawn
     vision embeddings on grid ids:
     served and one step each, held as (a) against fp32 copies; (e)
     whisper-tiny, sp, whole, batch 16 on 1500 drawn frames, served, and
     fp32 at 1 + 1 layers against float64.  Each run's sharded and
     unsharded ms, peak GB and the sharded decode step's idle share.  K7
     8 a layer a shard on every path with attention (16 in a step),
     K8/K9 8.  About 100 s at the former depths (12, 12, 12, 14, 14).
The inventory line lists K1-K9 and K5's split kernel, and K7-K9 again at
zamba2's shape, at qwen3-moe's GQA-8 shape, at qwen2-vl's GQA-6 shape, at
whisper's encoder and cross shapes, at glm4-9b's, phi3-medium-14b's and
nemotron-4-15b's (GQA 16, 4 and 6) and at phases 37's and 38's shard
shapes, with their launches on those archs' serve and train paths.
 39. the launch tooling (``launch_tooling_phase``): the smoke dry-run
     cells run for real on all 256 shards against the meta dry run's
     counts, three full-width CLI cells against ``LT_CLI_COUNTS``, and
     mamba2-370m and zamba2-1.2b under state_over_data, each bf16 token
     held by DIST_BF16_RATIO (module constants' comment).
 40. the stencil tiers counted (``stencil_counts_phase``, run after phase
     11): Table 1 through ``auto`` to convergence (K3), 1024x1024 per-cell
     taps (K1), 8192x8192 at fuse 16 (K2), one K4 sweep of 50,000 Fig-6
     grids and the dense row on 65,536 instances (K5 fp32), each counted
     by ``launch.hlo_cost`` on the card equal to ``meta`` exactly, its
     launches those of the uncounted run, its result equal to it and held
     to its plain version as its phase holds it.  Under 30 s.
 41. the JAX package's last public API on the card (``api_phase``, with
     ``device=None``, so on cuda, each part held against its CPU run):
     (a) ``stencil_apply(causal_conv1d_spec([0.1, 0.2, 0.3, 0.4]), ...,
     backend="auto", bc=1.5, iters=2)`` on 1024 grids of 65,536 cells,
     within TOL; (b) ``dense_jacobi_with_bc`` at Table 1's 64x64 (the
     4096x4096 matrix) for 7 iterations, the paper's dense limit, within
     TOL; (c) Table 1's 7960 steps through ``stencil_apply(...,
     tuned=<TUNED_stencil_cuda.json, loaded>)``: the table's schedule,
     K3 launched, bit-equal to ``reference``; with ``tuned=None`` the
     roofline's pick, bit-equal too.  Neither (a) nor (b) launches a
     kernel.  Under 60 s.

Any failed check raises and the script exits nonzero.  The last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits nonzero
before printing any result.
"""
import contextlib
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data-sheet rates (fp32 outside the tensor cores; dense bf16 on
# them; HBM3).
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# K5: (absolute, relative to |plain|) per element, per dtype.
GEMM_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-2)}
# fp32 K5 runs six bf16 products of the same size on the tensor cores: its
# bound counts the one product the function needs, at the bf16 rate, and
# the time of all six at that rate stands beside it.
K5_PRODUCTS = 6
TABLE1 = dict(bc=1.0, rtol=1e-6, check_every=20, max_iters=20_000)
TABLE1_ITERS = 7960  # the JAX package's and the port's count on the CPU
HET_GRID = (1024, 1024)   # phase 4
BIG_GRID = (8192, 8192)   # phase 5: 256 MiB a sweep, far past the 50 MB L2
BATCH = 1024              # phase 6
# Phase 2: resident grids past one CTA (up to the JAX package's 8 MiB) and
# their fuse depths; phase 5: the resident plan through the grid-wide kernel.
RESIDENT_GRIDS = (((169, 169), (1, 8, 512)), ((512, 512), (1, 8, 512)),
                  ((1024, 2048), (1, 8, 512)))
RESIDENT_BIG = (1024, 1024)
RESIDENT_BIG_ITERS = 512
FIG6 = dict(rtol=1e-6, check_every=20, max_iters=10_000)
FIG6_GRID = (10, 64, 64)  # (Z, X, Y): repro_torch/configs/jacobi.py's Fig 6
FIG6_ITERS = 620          # the JAX package's and the port's count on the CPU
FIG6_RESIDUAL = 1.4074293721932918e-04  # the CPU's, through cuda/reference
HET3D_ITERS = 640
PAPER_BATCH = 50_000      # phase 9: 2048 M elements, 8.19 GB in fp32
DEEP_GRID = (256, 512, 512)   # phase 9: one grid, 256 MiB
ITERS_3D = 20             # phase 9
K4_SMALL_BATCHES = (1, 16, 32)   # phase 11: Fig-6 grids, K4's two kernels
CHECK_SLICE = 256         # phase 9: instances held against the plain version
DENSE_BATCH = 65_536      # phase 10: Table-1 dense row instances
DENSE_ITERS = 7           # phase 10: repro_torch/configs/jacobi.py's dense row
LM_ARCH = "qwen3-0.6b"     # phases 12-15, full width (28 layers)
LM_SHAPE = (4, 2048, 16, 8, 128)   # (B, S, H, KV, hd): the serve prefill's
LM_FP32 = (2, 1000, 16)   # phase 13: batch, prompt (ragged), tokens
LM_SERVE = (4, 2048, 32)  # phase 14: the main path
LM_PROFILE_TOKENS = 2     # phase 14: decode steps under the profiler
# K6/K7: out per element (atol, rtol): fp32 JAX's own test bound
# (tests/test_flash_attention.py:31); bf16 two bf16 ulps (2**-7 relative
# each) plus 2e-3 for elements near 0, where the kernel's 64-key tiles round
# p against other running maxima than the plain version's blocks.  lse
# relative to its max-abs.
FLASH_TOL = {"float32": (2e-5, 0.0), "bfloat16": (2e-3, 1.6e-2)}
LSE_RTOL = 1e-5
# K8/K9: dq, dk, dv per element (atol, rtol): fp32 K6/K7's 2e-5 plus 1e-5
# relative (gradients reach 10 at the training shape); bf16 K6/K7's bound.
FLASH_BWD_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (2e-3, 1.6e-2)}
BWD_KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")
LM_TRAIN = (4, 2048, 5)   # phase 18, the main path: batch, seq_len, steps
# Phases 24-26, the ssm and hybrid families at full width and depth.
SSM_ARCHS = ("mamba2-370m", "zamba2-1.2b")
SSM_SERVE = (4, 2048, 8)   # phase 24: batch, prompt, tokens (bf16)
# Phase 24: decode steps under the profiler (about 3000 device operations
# a step; the profiler's bookkeeping of 32 steps took about a minute).
SSM_PROFILE_TOKENS = 2
SSM_FP32 = (2, 1000, 16)   # phase 25 (a, b): prompt ragged against 256
# Phase 25, relative to the max-abs; the readings are tests/_torch_ssm_noise.py
# --card's at (a)'s size (PERF.md §6).  In float64 decode and forward
# agree to 1e-13 (mamba2) and 2e-12 (zamba2), so fp32 leaves only rounding,
# and each fp32 run lies within 5.1e-5 (mamba2) and 1.22e-3 (zamba2) of the
# float64 forward: the random models' gain is high (2**-24 of noise on
# zamba2's embeddings moves its logits by 2.6e-5).  Two such runs may differ
# by twice that, so (a) holds decode against forward to 2e-4 and 3e-3.  A
# wrong cache moves the first decode step's logits by 1.04-1.41 of max-abs
# (the conv halo zeroed or reversed, the SSD state read before its update),
# and zamba2's attention cache filled one place short by 1.05e-2; (a) reruns
# the first step from a reversed halo (and for zamba2 from the short cache)
# and requires each past its tolerance.  (b) zamba2's prefill hidden, flash
# against xla, and the top-2 margin past which the two runs' tokens must
# agree: the same 3e-3.  (c) the prefill hidden, the card against the CPU:
# 1e-4 (read 1.2e-6 and 4.9e-5).
SSM_DECODE_RTOL = {"mamba2-370m": 2e-4, "zamba2-1.2b": 3e-3}
ZAMBA_FLASH_RTOL = 3e-3
SSM_CPU_RTOL = 1e-4
SSM_CPU = (2, 300)         # phase 25 (c): batch, prompt (two SSD chunks)
# Phase 25 (c)'s depth cut: two Mamba2 layers; zamba2 one group of six, its
# shared block and the two-layer tail.
SSM_CPU_DEPTH = {"mamba2-370m": 2, "zamba2-1.2b": 8}
SSM_TRAIN = (4, 2048, 3)   # phase 26: batch, seq_len, steps (bf16)
# zamba2-1.2b's shared attention at the serve and training shape: (B, S, H,
# KV, hd), MHA at head_dim 64 (phases 12, 15, 16, 19).
HYBRID_SHAPE = (4, 2048, 32, 32, 64)
# Phases 27-29, the moe family at full width (serving also at full depth).
MOE_ARCHS = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")
MOE_SERVE = (4, 2048, 8)    # phase 27: batch, prompt, tokens (bf16)
MOE_PROFILE_TOKENS = 1      # phase 27: decode steps under the profiler
MOE_FP32 = (2, 1024, 16)    # phase 28 (a, b): batch, prompt, tokens
MOE_FP32_DEPTH = 4          # phase 28 (a, b): layers at full width
MOE_CPU = (2, 512)          # phase 28 (c): batch, prompt
MOE_CPU_DEPTH = 2
MOE_DISPATCH = (2, 1024)    # phase 28 (d): one layer, batch x tokens
MOE_TRAIN = (4, 2048, 3)    # phase 29: batch, seq_len, steps (bf16)
MOE_TRAIN_DEPTH = 4         # phase 29: 16 B a parameter (fp32 masters, m,
# v, a bf16 compute copy, bf16 grads): 49.8 and 48.4 GB at four layers,
# 69.8 GB before activations at six.
# Phase 28's bounds, relative to the max-abs: twice the larger distance
# of an fp32 run from a float64 run of the same weights and inputs at
# these sizes (two fp32 runs may part by twice it), rounded up to one
# digit; the readings are tests/_torch_moe_noise.py --card's on an H100
# 80GB HBM3 at 700 W (PERF.md §6).  The router runs in fp32 in every
# model, so even float64 decode and forward part by 9.4e-5 and 1.2e-4.
# (a) decode against forward: the fp32 forward lies up to 8.2e-4
# (qwen3-moe) and 1.15e-2 (moonshot, where the float64 run routes one
# token otherwise: the fp32 decode and forward, 2.6e-4 apart there, both
# lie 1.1e-2 from it) from the float64 forward; fp32 readings 8.3e-4 and
# 6.1e-4, the planted faults 1.04-1.42.  (b) flash against xla: each
# within 1.04e-4 and 4.0e-4 of float64 xla.  (c) card against CPU: within
# 2.5e-6 and 7.0e-6.  (d) einsum against scatter, output and worst
# gradient: each within 1.5e-6/2.2e-6 and 1.5e-6/2.7e-6 of float64 einsum.
MOE_DECODE_RTOL = {"qwen3-moe-30b-a3b": 2e-3, "moonshot-v1-16b-a3b": 3e-2}
MOE_FLASH_RTOL = {"qwen3-moe-30b-a3b": 3e-4, "moonshot-v1-16b-a3b": 8e-4}
MOE_CPU_RTOL = {"qwen3-moe-30b-a3b": 5e-6, "moonshot-v1-16b-a3b": 2e-5}
MOE_DISPATCH_RTOL = {"qwen3-moe-30b-a3b": (4e-6, 5e-6),
                     "moonshot-v1-16b-a3b": (3e-6, 6e-6)}
# The moe archs' attention at the serve and training shape (B, S, H, KV,
# hd): qwen3-moe GQA 8 (32 query heads on 4 kv heads), moonshot MHA 16.
MOE_SHAPES = {"qwen3-moe-30b-a3b": (4, 2048, 32, 4, 128),
              "moonshot-v1-16b-a3b": (4, 2048, 16, 16, 128)}
# Phases 30-32, the vlm and encdec families at full width and depth.
VLM_ARCH = "qwen2-vl-2b"
ENCDEC_ARCH = "whisper-tiny"
VLM_SERVE = (4, 2048, 8)    # phase 30: batch, prompt, tokens (bf16)
VLM_GRID_W = 32             # phase 30: the 1024 vision tokens, 32 x 32
VLM_TRAIN = (4, 2048, 3)    # phase 30: batch, seq_len, steps (bf16)
ENC_SERVE = (16, 224, 8)    # phase 31: batch, decoder prompt, tokens
ENC_TRAIN = (16, 448, 3)    # phase 31: batch, decoder tokens, steps
VE_PROFILE_TOKENS = 2       # phases 30-31: decode steps under the profiler
# Phase 32 (fp32): (a, b) batch, prompt, tokens at a depth cut; (c) batch,
# prompt, vision tokens and grid width (or None) at a smaller cut, card
# against CPU.  whisper-tiny is cut to one encoder and one decoder layer:
# its random model is chaotic in fp32 at depth (non-causal scores of std
# about 100 over 1500 frames, so near-ties flip), each fp32 run lying 0.10
# to 0.26 of max-abs from a float64 one at 4 + 4 layers, 4.5e-3 after two
# encoder layers and 8e-5 after one (PERF.md §6, PR 25).
VE_FP32 = {VLM_ARCH: (2, 1100, 16), ENCDEC_ARCH: (2, 224, 16)}
VE_FP32_CUT = {VLM_ARCH: {"n_layers": 4},
               ENCDEC_ARCH: {"n_enc_layers": 1, "n_layers": 1}}
VE_CPU = {VLM_ARCH: (2, 300, 256, 16), ENCDEC_ARCH: (2, 64, None, None)}
VE_CPU_CUT = {VLM_ARCH: {"n_layers": 2},
              ENCDEC_ARCH: {"n_enc_layers": 1, "n_layers": 1}}
# Phase 32's bounds, relative to the max-abs: twice the larger distance of
# an fp32 run from a float64 run of the same weights and inputs at these
# sizes, rounded up to one digit; the readings are
# tests/_torch_vlm_encdec_noise.py --card's on an H100 80GB HBM3 at 700 W
# (PERF.md §6, PR 25), where float64 decode and forward agree to 6.4e-13
# and 6.9e-14.  (a) decode against forward: the fp32 decode and forward
# logits lie up to 4.3e-4 (qwen2-vl) and 3.8e-4 (whisper) from the float64
# forward's; fp32 readings 6.5e-5 and 1.7e-5, the planted faults 0.75 to
# 1.18.  (b) flash against xla: each within 8.2e-5 and 1.6e-4 of float64
# xla.  (c) card against CPU: within 2.0e-6 and 5.9e-5.
VE_DECODE_RTOL = {VLM_ARCH: 9e-4, ENCDEC_ARCH: 8e-4}
VE_FLASH_RTOL = {VLM_ARCH: 2e-4, ENCDEC_ARCH: 4e-4}
VE_CPU_RTOL = {VLM_ARCH: 5e-6, ENCDEC_ARCH: 2e-4}
# The two families' attention at the serve and training shapes, cases of
# tests/_torch_flash_cases.FLASH_CASES (phases 12, 15, 16, 19): qwen2-vl's
# GQA 6, causal; whisper's encoder (1500 frames, non-causal) and its
# cross-attention (224 decoder tokens on 1500 frames, non-causal).
VE_CASES = ("vlm_shape", "whisper_encoder", "whisper_cross")
# Phases 33-35: the dense family's last three archs, then a restart.
DENSE_ARCHS = ("glm4-9b", "phi3-medium-14b", "nemotron-4-15b")
DENSE_SERVE = (4, 2048, 8)    # phase 33: batch, prompt, tokens (bf16)
DENSE_PROFILE_TOKENS = 2      # phase 33: decode steps under the profiler
DENSE_CPU = (2, 128)          # phase 33: batch, prompt of the fp32 check
DENSE_CPU_DEPTH = 2           # phase 33: layers of the fp32 check
# Card against the CPU port in fp32 on the same weights (max-abs relative):
# twice the larger fp32 run's distance from a float64 run of the same
# weights (the port's fp32 points widened) at these sizes, rounded up to
# one digit, from tests/_torch_dense_noise.py --card: glm4 1.47e-4 and
# phi3 2.88e-4 (both fp32 runs, card and CPU, as far), nemotron 1.85e-6.
DENSE_CPU_RTOL = {"glm4-9b": 3e-4, "phi3-medium-14b": 6e-4,
                  "nemotron-4-15b": 4e-6}
DENSE_TRAIN = (4, 2048, 3)    # phase 34: batch, seq_len, steps (bf16)
# Phase 34's depth cuts: the train state is 16 B a parameter (fp32 masters,
# m and v, a bf16 compute copy and its bf16 gradients).  nemotron-4-15b's
# untied 256,000-row embed and head alone are 3.15 B parameters; at 2
# layers its step ran out of the card's memory (a 5.86 GiB fp32 LM head on
# 70.3 GB held), so it trains 1 layer.
DENSE_TRAIN_DEPTH = {"glm4-9b": 4, "phi3-medium-14b": 4,
                     "nemotron-4-15b": 1}
RESTART_ARCH = "qwen3-0.6b"   # phase 35, at full width
RESTART = (4, 2048, 4, 2, 3)  # batch, seq_len, steps, checkpoint every, fail
# Phase 36, halo distribution on a tile mesh (every tile on the one card):
HALO_T1_MESH = (2, 2)          # (a) Table 1 (benchmarks/table1_2d.py:111-115)
HALO_BIG_MESH = (2, 4)         # (b) BIG_GRID in 4096x2048 tiles
HALO_BIG_ITERS = 64
HALO_BIG_FUSES = (1, 16)
HALO_VAR_GRID = (1024, 1024)   # (c) per-cell taps on HALO_BIG_MESH
HALO_VAR_FUSE = 4
# (d) the scaling bench's fuse-sweep cell (benchmarks/scaling_bench.py:105)
HALO_TUNE_GRID = (128, 256)
HALO_TUNE_ITERS = 32
HALO_SECONDS = 120             # the phase's budget
HALO_BATCH_MESH = ((2, 2, 2), ("batch", "data", "model"))  # (e)
HALO_BATCH_FUSE = 20           # (e): 100 exchanges of 20-deep halos
HALO_BATCH_ITERS = 2000        # (e): a quarter of Table 1's 7960
# Phase 40, the stencil tiers counted: its budget.
STENCIL_COUNT_SECONDS = 30
# Phase 41, the last public API: (a)'s grids and cells, its budget.
API_CONV = (1024, 65_536)
API_SECONDS = 60
# Phase 37: LM distribution on a data x model mesh, every shard on cuda:0.
DIST_MESH = (2, 4)               # ("data", "model")
DIST_ARCH = "qwen3-0.6b"         # (a) tp, full width and depth
DIST_SERVE = (4, 2048, 8)        # (a) batch, prompt, decode tokens
DIST_FP32_DECODE = 2             # (a) fp32 decode steps held to float64
DIST_GLM = (4, 2048, 8, 2112)    # (b) batch, prompt, tokens, max_len: model
                                 # 4 divides 2112, so the cache shards
DIST_PHI = (4, 2048)             # (c) sp prefill batch, prompt
DIST_PHI_DEPTH = 4               # (c) the train step's cut (phase 34's)
DIST_PIPE = (4, 4, 4, 2048)      # (d) stages, microbatches, batch, seq
# (a) a sharded fp32 run lies within DIST_X times the unsharded fp32 run's
# distance from a float64 run of the same weights (xla, the port's .float()
# points widened): two fp32 runs that sum in other orders each lie about
# that far from float64; (b) and (c) hold fp32 the same way at DIST_CUT
# layers.  bf16 at full depth: these random models are chaotic there (a
# bf16 run's logits lie about half their max-abs from an fp32 run of the
# same weights, PERF.md §6, PR 28), so a sharded bf16 run's logits and
# grads must lie no farther from the fp32 run than DIST_BF16_RATIO times
# the unsharded bf16 run's, and its loss within DIST_X times the
# unsharded's distance.  Logits relative to the reference's max-abs, grads
# by the worst leaf (fp32) or over every leaf (bf16).
DIST_X = 3
DIST_CUT = 4                     # (b), (c): layers of the fp32 checks
DIST_BF16_RATIO = 1.5
# (d) the pipelined step against the unpipelined one, fp32: phase 17's
# flash-against-xla bounds (loss relative, each grad's max-abs relative).
DIST_PIPE_RTOL = (1e-5, 1e-4)
# Phase 38: every other LM family on DIST_MESH, every shard on cuda:0,
# held by DIST_X (fp32 against float64) and DIST_BF16_RATIO (bf16 at
# depth against an fp32 run of the same weights).
FAM_MOE_SERVE = (8, 4096, 4)     # (a) batch, prompt, decode tokens: 32
                                 # groups of 1024, 2 a wave, over data
FAM_MOE_FP32 = (8, 4096, 2, 2)   # (a) fp32: batch, prompt, steps, layers
FAM_MOE_FP32_TRAIN = (2, 2048)   # (a) fp32 loss and grads: batch, seq
FAM_MOE_TRAIN = (4, 2048, 4)     # (a) bf16 step: batch, seq, layers
                                 # (phase 29's cut: 16 B a parameter)
FAM_SERVE = (4, 2048, 4)         # (b)-(d): batch, prompt, decode tokens
FAM_TRAIN = (4, 2048)            # (c), (d): the bf16 step
FAM_ENC = (16, 224, 8)           # (e): batch, decoder prompt, tokens
FAM_ENC_FP32_DEPTH = 1           # (e): layers a side of the fp32 check
# (a)-(d) at these depths (full width): at full depth the phase took 790.9
# s on an H100 80GB HBM3 at 700 W (each shard's Python issuing every
# routing, dispatch, SSD chunk and collective), so the serve and train
# paths are cut in depth to keep it under 180 s; whisper-tiny (e) runs
# whole.  Cut again (from 12, 12, 12, 14, 14 layers and 8 decode tokens;
# phase 37's from 16 tokens), with phases 24-34's decode tokens (32 to 8)
# and train steps (5 to 3), phase 35's steps (6 to 4) and phase 14's
# profiled decode (32 tokens to 2): phases 1-40 took 987.5 s with the
# build on one H100 host and 1314.7 s on another (every phase 20-60%
# slower there), past the contract's 1200 s.  The moe archs stay at 12:
# at 4 layers their bf16 hold reads a coin flip, not the sharding.  Their
# bf16 routing is chaotic (each layer's record, "bf16_routing"), and one
# token routed otherwise moves its row's logits by the hold's whole
# margin: qwen3-moe's prefill logits at 4 layers lay 0.1622 from fp32
# sharded and 0.0778 unsharded (2.08x) on one host.  At 8 and 12 layers
# both runs' distances lay at 0.40-1.47, the ratios 0.55-1.31.
FAM_DEPTH = {"qwen3-moe-30b-a3b": 12, "moonshot-v1-16b-a3b": 12,
             "mamba2-370m": 4, "zamba2-1.2b": 7, "qwen2-vl-2b": 4}
FAM_REF_Q_CHUNK = 256            # the references' plain attention rows
# (a) an fp32 tie in the routing: two of a token's top-(k + 1) router
# probabilities within this much of its largest (fp32 rounds a prob to
# 6e-8 of itself; the sharded and unsharded runs' router inputs differ by
# the tp sums' order, about 1e-6 relative).
FAM_ROUTE_TIE = 1e-5
# Phase 39, the launch tooling (launch/specs.py, hlo_cost.py, dryrun.py)
# and state_over_data decode.  (a) qwen3-0.6b's smoke config through these
# dry-run cells, for real, on the 16 x 16 mesh with all 256 shards on
# cuda:0, their counts held equal to the meta dry run's of the same cell;
# (b) these full-width cells through the dry-run CLI on meta, their counts
# held equal to LT_CLI_COUNTS (the CPU sweep's records, PERF.md §5);
# (c) batch-1 decode under state_over_data on DIST_MESH at full width and
# depth: SOD_TOKENS bf16 tokens from a seeded random cache of SOD_LEN
# positions, sharded against unsharded (each token by DIST_BF16_RATIO
# against an fp32 copy reading the same bf16 cache), and
# fp32 against float64 by DIST_X, token by token, at
# SOD_FP32_DEPTH layers (zamba2's fp32 and float64 caches at 38 layers,
# 51.6 and 103 GB, do not fit; at 6 layers, one attention use, 8.6 and
# 17.2 GB) over SOD_FP32_TOKENS tokens.
LT_SMOKE_CELLS = ("train_4k", "prefill_32k", "decode_32k")
LT_CLI_CELLS = (("mamba2-370m", "long_500k"), ("zamba2-1.2b", "long_500k"),
                ("qwen3-0.6b", "decode_32k"))
LT_CLI_COUNTS = {   # per shard: flops, hbm_bytes, collectives
    "mamba2-370m long_500k": {
        "flops": 69648384.0, "hbm_bytes": 162726166.03125,
        "collectives": {
            "all-gather": {"count": 50.0, "operand_bytes": 1548.0,
                     "result_bytes": 24768.0},
            "all-reduce": {"count": 97.0, "operand_bytes": 198848.0,
                     "result_bytes": 198848.0},
            "reduce-scatter": {"count": 0.0, "operand_bytes": 0.0,
                     "result_bytes": 0.0},
            "all-to-all": {"count": 0.0, "operand_bytes": 0.0,
                     "result_bytes": 0.0},
            "collective-permute": {"count": 0.0, "operand_bytes": 0.0,
                     "result_bytes": 0.0},
        }},
    "zamba2-1.2b long_500k": {
        "flops": 393719808.0, "hbm_bytes": 1094511246.03125,
        "collectives": {
            "all-gather": {"count": 46.0, "operand_bytes": 3980.0,
                     "result_bytes": 63680.0},
            "all-reduce": {"count": 107.0, "operand_bytes": 464536.0,
                     "result_bytes": 464536.0},
            "reduce-scatter": {"count": 0.0, "operand_bytes": 0.0,
                     "result_bytes": 0.0},
            "all-to-all": {"count": 0.0, "operand_bytes": 0.0,
                     "result_bytes": 0.0},
            "collective-permute": {"count": 0.0, "operand_bytes": 0.0,
                     "result_bytes": 0.0},
        }},
    "qwen3-0.6b decode_32k": {
        "flops": 5234884608.0, "hbm_bytes": 17704946112.0,
        "collectives": {
            "all-gather": {"count": 30.0, "operand_bytes": 57440.0,
                     "result_bytes": 919040.0},
            "all-reduce": {"count": 141.0, "operand_bytes": 3715072.0,
                     "result_bytes": 3715072.0},
            "reduce-scatter": {"count": 0.0, "operand_bytes": 0.0,
                     "result_bytes": 0.0},
            "all-to-all": {"count": 0.0, "operand_bytes": 0.0,
                     "result_bytes": 0.0},
            "collective-permute": {"count": 0.0, "operand_bytes": 0.0,
                     "result_bytes": 0.0},
        }},
}
SOD_ARCHS = ("mamba2-370m", "zamba2-1.2b")
SOD_LEN = 524_288
SOD_TOKENS = 8
SOD_FP32_DEPTH = {"mamba2-370m": 48, "zamba2-1.2b": 6}
SOD_FP32_TOKENS = 2
DEVICE = "cuda"
# Phases 20-22, the stencil serving tier.  Autotune cells: (name, spec,
# grid, iterations a timed call); Table 1's and Fig 6's go to the committed
# table (--write-tuned).
TUNE_CELLS = (("table1", "laplace2d", (64, 64), 32),
              ("hetero", "hetero2d", HET_GRID, 32),
              ("big", "laplace2d", BIG_GRID, 16),
              ("fig6", "laplace3d", FIG6_GRID, 32))
TUNE_COMMITTED = ("table1", "fig6")
# Multigrid problems, bc 1 from zeros: (name, spec, grid, rtol, backend,
# transfer backend, cycles and levels the CPU takes or None).  13 and 5
# cycles at rtol 1e-5 are BENCH_stencil.json's rows; 18 and 6 at 1e-6 the
# CPU tests' counts (tests/test_torch_multigrid.py).
MG_PROBLEMS = (
    ("table1", "laplace2d", (64, 64), 1e-5, "auto", "reference", (13, 4)),
    ("table1", "laplace2d", (64, 64), 1e-6, "auto", "reference", (18, 4)),
    ("hetero65", "hetero2d", (65, 65), 1e-5, "auto", "reference", (5, 5)),
    ("hetero65", "hetero2d", (65, 65), 1e-6, "auto", "reference", (6, 5)),
    ("full2d", "laplace2d", (4097, 4097), 1e-6, "cuda", "cuda", (None, 11)),
    ("full3d", "laplace3d", (257, 257, 257), 1e-6, "cuda", "cuda",
     (None, 7)),
)
# Serving traffic: Jacobi requests per (grid, bc) group, the groups' grids
# (one 64x64 bucket) and Dirichlet values; kernel-backend requests; the
# multigrid requests' grid and count; requests timed cold-serial.
SERVE_PER_GROUP = 32
SERVE_GRIDS = (64, 60, 56, 48)
SERVE_BCS = (1.0, 0.5)
SERVE_FUSED = 16
SERVE_MG = ((1025, 1025), 4)
SERVE_COLD = 4
SERVE_BAR = 5.0   # coalesced solves/s over cold-serial (serving_bench.py)
# Phase 23, the differentiable solve on the default cache: JAX's adjoint
# benchmark cell (benchmarks/adjoint_bench.py: heterogeneous 64x64, fixed
# 200 iterations through conv), timed reps after a warm-up; the converged
# gradients' finite-difference check (JAX's tests/solver/test_adjoint.py
# eps and TOL) on cells of each operand; the batched inverse problem; the
# learned-stencil family's train steps (examples/learned_stencil.py's
# dataset, batch and lr).
ADJ_GRID = (64, 64)
ADJ_ITERS = 200
ADJ_REPS = 7
ADJ_RTOL = 1e-6
ADJ_CPU_RTOL = 1e-4       # of the largest gradient, card against the CPU
ADJ_FD_CELLS = 8
ADJ_FD_EPS = 1e-2
ADJ_FD_TOL = dict(rtol=1e-3, atol=2e-3)
ADJ_BATCH = 1024
LS_BATCH = 8
LS_STEPS = 20
LS_LR = 1e-2


T_START = time.perf_counter()


def emit(obj):
    if "phase" in obj:   # when each phase line was written
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def p_rounding_case(device):
    """bf16 q (1, 64, 2, 16), k and v (1, 1024, 1, 16), non-causal, on which
    rounding p to v's type matters: key 0 scores 0 and keys 1-1023 score
    2.125 * -1 / 4, so each of their p is exp(-0.53125) = 0.58787, which
    bf16 rounds down by 0.33%; v is 8 on those keys and -4800 on key 0,
    which nearly cancels their sum.  The output is -0.0078 everywhere, and
    a kernel that skips the rounding gives +0.0185."""
    import torch
    q = torch.zeros(1, 64, 2, 16, device=device)
    q[..., 0] = 2.125
    k = torch.zeros(1, 1024, 1, 16, device=device)
    k[:, 1:, :, 0] = -1.0
    v = torch.full((1, 1024, 1, 16), 8.0, device=device)
    v[:, 0] = -4800.0
    return tuple(t.to(torch.bfloat16) for t in (q, k, v))


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


OP_CLASSES = (("flash (K7-K9)", ("flash",)),
              ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
              ("sort", ("sort", "radix")),
              ("scatter/gather", ("scatter", "gather", "index")),
              ("reduce/scan", ("reduce", "softmax", "scan", "cumsum")),
              ("copy/cast/fill", ("copy", "cat", "fill", "cast")),
              ("elementwise", ("elementwise", "vectorized", "unrolled")))


def op_class(name):
    """The class of a device operation, by its kernel's name."""
    low = name.lower()
    for label, keys in OP_CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def sass_counts(library, opcode):
    """{kernel: count of ``opcode`` in its SASS} over the kernels of a built
    library, from ``cuobjdump -sass`` (next to nvcc)."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and opcode in line:
            counts[name] += 1
    return counts


def device_profile(fn, top=12, host=True):
    """Run ``fn`` once under torch.profiler: its wall ms (the
    profiler's own cost included), the device ms summed over kernels,
    the share of the wall the device sat idle, and the ``top`` kernels
    by device time as [name, ms, calls].  ``host=False`` traces the
    device alone: a path of 10^4-10^5 launches (the SSM families' steps)
    then costs seconds to trace instead of a minute or more."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU] * host
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    by_class = {}
    for e in events:
        c = op_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + e.self_device_time_total / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": 1 - device_ms / wall_ms,
            "profiler_s": time.perf_counter() - t_all,
            "ms_by_class": by_class,
            "kernels": [[e.key, e.self_device_time_total / 1e3, e.count]
                        for e in events[:top]]}


def stencil_serving_phases(dev, write_tuned=None):
    """Phases 20-22, the stencil serving tier on the card: the measured
    autotuner, the multigrid V-cycle and the coalescing engine over the
    bucketed plan cache.  Each phase zeroes the launch counts before it and
    reads them after; returns {"launches": {phase: launches}, "seconds",
    "peak_gb"}.  ``write_tuned`` saves the
    Table-1 and Fig-6 cells' measurements there (TUNED_stencil_cuda.json's
    source)."""
    import asyncio
    import warnings

    import numpy as np
    import torch

    import repro_torch.core as T
    from repro_torch.core import autotune
    from repro_torch.kernels import _build
    from repro_torch.serve import ServingEngine

    t_tier = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)

    het_kappa = {}

    def spec_of(name, grid):
        if name == "laplace2d":
            return T.laplace_jacobi(2)
        if name == "laplace3d":
            return T.laplace_jacobi(3)
        if grid not in het_kappa:   # multigrid_bench.py's problem
            het_kappa[grid] = 1.0 + 9.0 * np.random.default_rng(0).random(
                grid).astype(np.float32)
        return T.heterogeneous_jacobi(het_kappa[grid])

    launches = {}

    # -- 20. the autotuner on the card ---------------------------------------
    _build.LAUNCHES.clear()
    kind = autotune.device_kind(dev)
    jax_table = autotune.TunedTable.load(os.path.join(ROOT,
                                                      "TUNED_stencil.json"))
    check(len(jax_table) == 10, "the JAX package's table did not load")
    committed = autotune.TunedTable()
    cells = {}
    for name, sname, grid, iters in TUNE_CELLS:
        spec = spec_of(sname, grid)
        fam = autotune.spec_family(spec)
        cands = autotune.schedule_candidates(spec, grid, iters, bc=1.0,
                                             device=dev)
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as failed:
            warnings.simplefilter("always")
            table = autotune.autotune_cell(spec, grid, iters=iters, bc=1.0,
                                           device=dev)
        tune_s = time.perf_counter() - t0
        failed = [str(w.message) for w in failed
                  if "autotune: candidate" in str(w.message)]
        check(not failed and len(table) == len(cands),
              f"autotune {name}: {len(table)} of {len(cands)} candidates "
              f"measured; failed: {failed}")
        check(not any(e.interpreted for e in table.entries),
              f"autotune {name}: an interpreted entry on the card")
        best = table.lookup(kind, fam, grid, "float32")
        check(best is not None and best.us_per_iter
              == min(e.us_per_iter for e in table.entries),
              f"autotune {name}: lookup did not return the fastest entry")
        # The JAX package's CPU entries never price this card.
        plan = T.make_plan(spec, grid, bc=1.0, iters=iters, device=dev,
                           tuned=jax_table)
        check(jax_table.lookup(kind, fam, grid, "float32") is None
              and plan.source != "tuned",
              f"autotune {name}: a CPU entry won on the card")
        tuned_plan = T.make_plan(spec, grid, bc=1.0, iters=iters,
                                 device=dev, tuned=table)
        check(tuned_plan.source == "tuned"
              and tuned_plan.backend == best.backend,
              f"autotune {name}: make_plan did not take the winner")
        if name in TUNE_COMMITTED:
            for e in table.entries:
                committed.add(e)
        cells[name] = {
            "family": fam, "bucket": list(autotune.shape_bucket(grid)),
            "grid": list(grid), "iters": iters, "tune_s": tune_s,
            "us_per_iter": {f"{e.backend}/f{e.fuse}"
                            f"{'/' + e.rim if e.rim else ''}": e.us_per_iter
                            for e in table.entries},
            "winner": f"{best.backend}/f{best.fuse}"
                      f"{'/' + best.rim if best.rim else ''}",
            "roofline_pick": T.make_plan(spec, grid, bc=1.0, iters=iters,
                                         device=dev, tuned=None).backend}
    if write_tuned:
        committed.save(write_tuned)
    launches[20] = dict(_build.LAUNCHES)
    emit({"phase": 20, "device_kind": kind, "cells": cells,
          "launches": launches[20]})

    # -- 21. multigrid V-cycles ------------------------------------------------
    _build.LAUNCHES.clear()
    mg_rows, mg_fields = [], {}
    for name, sname, grid, rtol, backend, transfer, want in MG_PROBLEMS:
        spec = spec_of(sname, grid)
        t0 = time.perf_counter()
        mg = T.Multigrid(spec, grid, bc=1.0, rtol=rtol, backend=backend,
                         transfer_backend=transfer, device=dev)
        build_s = time.perf_counter() - t0
        x0 = torch.zeros(grid, device=dev)
        cold = mg.solve(x0)
        r = mg.solve(x0)
        ok = (r.converged and r.cycles == cold.cycles
              and tuple(r.x.shape) == grid
              and bool(torch.isfinite(r.x).all()))
        check(ok, f"multigrid {name} rtol {rtol}: converged {r.converged} "
                  f"in {r.cycles} cycles")
        cycles, levels = want
        check(len(r.level_shapes) == levels
              and (cycles is None or r.cycles == cycles),
              f"multigrid {name} rtol {rtol}: {r.cycles} cycles, "
              f"{len(r.level_shapes)} levels, expected {want}")
        row = {"problem": name, "grid": list(grid), "rtol": rtol,
               "backend": r.backend, "transfer_backend": transfer,
               "cycles": r.cycles, "levels": len(r.level_shapes),
               "work_per_cycle": r.work_per_cycle,
               "work_units": r.work_units, "residual": r.residual,
               "build_s": build_s, "cold_wall_ms": cold.wall_seconds * 1e3,
               "wall_ms": r.wall_seconds * 1e3,
               "ms_per_cycle": r.wall_seconds * 1e3 / r.cycles}
        if cycles is not None:
            # Against the reference backend on the card: the same cycles,
            # the fields within 1e-6 of their max-abs.
            ref = T.Multigrid(spec, grid, bc=1.0, rtol=rtol,
                              backend="reference",
                              transfer_backend="reference",
                              device=dev).solve(x0)
            d = float((r.x - ref.x).abs().max())
            scale = float(ref.x.abs().max())
            check(ref.cycles == r.cycles and d <= 1e-6 * max(scale, 1.0),
                  f"multigrid {name} rtol {rtol} vs reference: cycles "
                  f"{r.cycles}/{ref.cycles}, max diff {d}")
            row.update(reference_cycles=ref.cycles,
                       reference_max_abs_diff=d,
                       reference_wall_ms=ref.wall_seconds * 1e3)
        mg_rows.append(row)
        del mg, r, cold, x0
        torch.cuda.empty_cache()
    launches[21] = dict(_build.LAUNCHES)
    emit({"phase": 21, "problems": mg_rows, "launches": launches[21]})

    # -- 22. the coalescing engine over the bucketed plan cache ---------------
    _build.LAUNCHES.clear()
    rng = np.random.default_rng(22)
    lap = T.laplace_jacobi(2)
    jac_kw = dict(rtol=1e-6)
    traffic = []   # (group, x0, source, submit kwargs)
    for g in SERVE_GRIDS:
        for bc in SERVE_BCS:
            for _ in range(SERVE_PER_GROUP):
                traffic.append((
                    ("auto", g, bc),
                    rng.standard_normal((g, g)).astype(np.float32),
                    (rng.standard_normal((g, g)) * 1e-3).astype(np.float32),
                    dict(bc=bc, **jac_kw)))
    for _ in range(SERVE_FUSED):
        traffic.append((("cuda_fused", 64, 1.0),
                        rng.standard_normal((64, 64)).astype(np.float32),
                        None, dict(bc=1.0, backend="cuda_fused", **jac_kw)))
    mg_grid, n_mg = SERVE_MG
    for _ in range(n_mg):
        traffic.append((("multigrid",) + mg_grid,
                        rng.standard_normal(mg_grid).astype(np.float32),
                        None, dict(bc=1.0, method="multigrid", **jac_kw)))
    cache = T.PlanCache(device=dev)

    async def serve_all():
        eng = ServingEngine(cache, max_batch=64, max_wait=0.01,
                            max_queue=len(traffic))

        async def one(x0, src, kw):
            t0 = time.perf_counter()
            r = await eng.submit(lap, x0, source=src, **kw)
            return time.perf_counter() - t0, r

        async with eng:
            t0 = time.perf_counter()
            out = await asyncio.gather(*(one(x0, src, kw)
                                         for _, x0, src, kw in traffic))
            wall = time.perf_counter() - t0
        return eng, out, wall

    eng, out, wall = asyncio.run(serve_all())
    lat = sorted(t for t, _ in out)
    results = [r for _, r in out]
    st = cache.stats
    check(st.misses == 3 and st.rebuilds == 0 and st.probe_dropped == 0,
          f"serving cache: {st.as_dict()} (3 distinct keys: the 64x64 "
          f"bucket, the exact cuda_fused entry, the multigrid hierarchy)")
    check(eng.stats.coalesced > 0 and eng.stats.failed == 0
          and eng.stats.completed == len(traffic),
          f"serving engine: {eng.stats.as_dict()}")
    check(all(r.converged for r in results), "a served solve diverged")
    # Each result against its request solved on its own exact shape by the
    # port's Solver (Multigrid for multigrid requests): every group's
    # requests in one batched call (per-instance freezing), and alone the
    # multigrid requests and the first request of the cuda_fused group and
    # of the first and last Jacobi groups (64x64 at bc 1, 48x48 at bc 0.5).
    groups = {}
    for i, (key, *_rest) in enumerate(traffic):
        groups.setdefault(key, []).append(i)
    jacobi_keys = [k for k in groups if k[0] == "auto"]
    alone_keys = {jacobi_keys[0], jacobi_keys[-1], ("cuda_fused", 64, 1.0)}
    worst_batch, worst_alone, served_backend = 0.0, 0.0, {}
    for key, idx in groups.items():
        kw = dict(traffic[idx[0]][3])
        if key[0] == "multigrid":
            kw.pop("method")
            mg = T.Multigrid(lap, mg_grid, device=dev, **kw)
            for i in idx:
                alone = mg.solve(traffic[i][1])
                d = float((results[i].x - alone.x).abs().max())
                check(results[i].cycles == alone.cycles and d <= 1e-6,
                      f"served multigrid {i}: {results[i].cycles} cycles "
                      f"vs {alone.cycles}, max diff {d}")
                worst_alone = max(worst_alone, d)
            continue
        backend = results[idx[0]].backend
        served_backend["/".join(map(str, key))] = backend
        kw.pop("backend", None)
        g = key[1]
        solver = T.Solver(lap, (g, g), backend=backend, device=dev, **kw)
        srcs = [traffic[i][2] for i in idx]
        xs = np.stack([traffic[i][1] for i in idx])
        batched = solver.solve(xs, source=None if srcs[0] is None
                               else np.stack(srcs))
        for j, i in enumerate(idx):
            d = float((results[i].x - batched.x[j]).abs().max())
            check(results[i].iterations == int(batched.iterations[j])
                  and d <= 1e-6,
                  f"served {key} request {i}: {results[i].iterations} "
                  f"iterations vs {int(batched.iterations[j])} on its own "
                  f"shape, max diff {d}")
            worst_batch = max(worst_batch, d)
        if key not in alone_keys:
            continue
        i = idx[0]
        alone = solver.solve(traffic[i][1], source=traffic[i][2])
        d = float((results[i].x - alone.x).abs().max())
        check(results[i].iterations == alone.iterations and d <= 1e-6,
              f"served {key} request {i} vs alone: {results[i].iterations} "
              f"vs {alone.iterations} iterations, max diff {d}")
        worst_alone = max(worst_alone, d)
    # Cold-serial: a fresh cache a request (build, probe and solve), as
    # benchmarks/serving_bench.py defines it, over the first requests.
    cold_lat, cold_iters = [], []
    for key, x0, src, kw in traffic[:SERVE_COLD]:
        t0 = time.perf_counter()
        r = T.PlanCache(device=dev).solve(lap, x0, source=src, **kw)
        cold_lat.append(time.perf_counter() - t0)
        cold_iters.append(r.iterations)
        check(r.converged, "a cold-serial solve diverged")
    served = len(traffic) / wall
    cold = len(cold_lat) / sum(cold_lat)
    check(served >= SERVE_BAR * cold,
          f"coalesced {served:.2f} solves/s < {SERVE_BAR}x cold-serial "
          f"{cold:.2f}")
    p99 = lat[min(len(lat) - 1, int(np.ceil(0.99 * len(lat))) - 1)]
    launches[22] = dict(_build.LAUNCHES)
    emit({"phase": 22, "requests": len(traffic),
          "jacobi_groups": len(SERVE_GRIDS) * len(SERVE_BCS),
          "wall_s": wall, "solves_per_s": served,
          "p50_ms": lat[len(lat) // 2] * 1e3, "p99_ms": p99 * 1e3,
          "cold_serial_solves_per_s": cold,
          "cold_serial_ms": [t * 1e3 for t in cold_lat],
          "cold_serial_iterations": cold_iters,
          "coalesced_over_cold": served / cold, "bar": SERVE_BAR,
          "engine": eng.stats.as_dict(), "cache": st.as_dict(),
          "served_backend": served_backend,
          "iterations_by_group": {
              "/".join(map(str, k)): sorted({
                  results[i].cycles if k[0] == "multigrid"
                  else results[i].iterations for i in idx})
              for k, idx in groups.items()},
          "max_abs_diff_vs_own_shape_batched": worst_batch,
          "max_abs_diff_vs_alone": worst_alone,
          "launches": launches[22]})
    torch.cuda.synchronize(dev)
    return {"launches": launches, "seconds": time.perf_counter() - t_tier,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def adjoint_phase(dev, smi):
    """Phase 23, the differentiable solve (``core.adjoint.implicit_solve``)
    on the card's default plan cache: (a) JAX's adjoint benchmark cell,
    forward and value-and-grad; (b) a converged solve's gradients against
    the CPU port's and central differences; (c) a batch of Table-1
    instances sharing one learned field stack; (d) the learned-stencil
    family's train steps at full width.  None of K1-K9 runs (the launch
    counts are zeroed before and read after).  Returns the phase's record.
    """
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.core as T
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.model_zoo import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    t_phase = time.perf_counter()
    _build.LAUNCHES.clear()
    cache = T.default_plan_cache()
    check(cache.device.type == dev.type,
          f"the default plan cache runs on {cache.device}, not {dev}")

    def sync():
        torch.cuda.synchronize(dev)

    def event_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def median_ms(fn, reps=ADJ_REPS):
        fn()   # warm-up: the bucket's build and probe, cuDNN's first call
        sync()
        return float(np.median([event_ms(fn) for _ in range(reps)]))

    def device_ops(fn):
        """(device operations launched, device-busy ms, wall ms) of one
        call of ``fn`` under torch.profiler."""
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        return (sum(e.count for e in events),
                sum(e.self_device_time_total for e in events) / 1e3, wall)

    rng = np.random.default_rng(0)
    spec = T.heterogeneous_jacobi(1.0 + 9.0 * rng.random(ADJ_GRID))
    fields = torch.as_tensor(spec.field_stack(), device=dev)
    src_np = rng.standard_normal(ADJ_GRID).astype(np.float32)
    src = torch.as_tensor(src_np, device=dev)
    x0 = torch.zeros(ADJ_GRID, device=dev)

    # -- (a) JAX's adjoint benchmark cell ----------------------------------
    fixed = dict(backend="conv", rtol=None, atol=None, max_iters=ADJ_ITERS)
    f_req = fields.clone().requires_grad_(True)

    def fwd():
        with torch.no_grad():
            return torch.sum(T.implicit_solve(spec, x0, fields=fields,
                                              source=src, **fixed))

    def value_and_grad():
        loss = torch.sum(T.implicit_solve(spec, x0, fields=f_req,
                                          source=src, **fixed))
        return loss.detach(), torch.autograd.grad(loss, f_req)[0]

    fwd_ms, grad_ms = median_ms(fwd), median_ms(value_and_grad)
    ran = cache.solver(spec, ADJ_GRID, backend="conv",
                       bc=T.DirichletBC(0.0), rtol=None, atol=None,
                       max_iters=ADJ_ITERS)
    ops_fwd, busy_fwd, wall_fwd = device_ops(fwd)
    ops_grad, busy_grad, wall_grad = device_ops(value_and_grad)
    loss_a, g_a = value_and_grad()
    check(bool(torch.isfinite(loss_a)) and bool(torch.isfinite(g_a).all()),
          "the benchmark cell's loss or gradient is not finite")
    bench = {"grid": list(ADJ_GRID), "iters": ADJ_ITERS,
             "requested_backend": "conv", "backend_ran": ran.backend,
             "bucket": list(ran.bucket) if ran.padded else None,
             "fwd_ms": fwd_ms, "grad_ms": grad_ms,
             "grad_over_fwd": grad_ms / fwd_ms,
             "device_ops_per_fwd": ops_fwd, "device_ops_per_grad": ops_grad,
             "device_busy_ms_fwd": busy_fwd, "wall_ms_fwd": wall_fwd,
             "device_idle_share_fwd": 1 - busy_fwd / wall_fwd,
             "device_busy_ms_grad": busy_grad, "wall_ms_grad": wall_grad,
             "device_idle_share_grad": 1 - busy_grad / wall_grad}

    # -- (b) converged gradients: the CPU port, central differences --------
    # The loss <r, x*> for a random r, summed in float64: at 64x64 a
    # quadratic loss summed in fp32 rounds away the differences it is held
    # to (its terms reach 1e4), and the fp32 rounding of x* itself moves a
    # linear loss least.
    conv = dict(backend="conv", rtol=ADJ_RTOL, max_iters=20_000)
    r_np = np.random.default_rng(1).standard_normal(ADJ_GRID)

    def grads_on(device):
        """(loss, [d fields, d source, d bc, d x0]) on a default cache on
        ``device`` (the card's own cache for the card)."""
        ops = [torch.as_tensor(a, device=device).requires_grad_(True)
               for a in (spec.field_stack(), src_np, np.float32(0.7))]
        xz = torch.zeros(ADJ_GRID, device=device, requires_grad=True)
        x = T.implicit_solve(spec, xz, fields=ops[0], source=ops[1],
                             bc_value=ops[2], **conv)
        loss = torch.sum(x.double() * torch.as_tensor(r_np, device=device))
        return float(loss.detach()), [g.cpu() for g in
                                      torch.autograd.grad(loss, ops + [xz])]

    t0 = time.perf_counter()
    loss_b, card = grads_on(dev)
    card_s = time.perf_counter() - t0
    old = T.set_default_plan_cache(T.PlanCache(device="cpu"))
    try:
        loss_cpu, host = grads_on("cpu")
    finally:
        T.set_default_plan_cache(old)
    names = ("fields", "source", "bc")
    vs_cpu = {}
    for name, g, h in zip(names, card, host):
        rel = float((g - h).abs().max()) / float(h.abs().max())
        check(bool(torch.isfinite(g).all()) and rel <= ADJ_CPU_RTOL,
              f"the card's {name} gradient is {rel} of its largest entry "
              f"from the CPU port's (bound {ADJ_CPU_RTOL})")
        vs_cpu[name] = rel
    check(torch.equal(card[3], torch.zeros_like(card[3])),
          "x0's gradient is not exactly zero")

    # The finite differences' reference: the exact fixed point, one float64
    # direct solve of (I - M S) x = M s + (1 - M) bc a loss.  fp32 solves
    # run to rtol 1e-6 stop a chunk apart from one side of a difference
    # to the other, which jumps <r, x*> by more than the bound at 64x64.
    n = int(np.prod(ADJ_GRID))
    cell = np.arange(n).reshape(ADJ_GRID)
    inner = np.zeros(ADJ_GRID, bool)
    inner[1:-1, 1:-1] = True
    rows, cols, entry = [], [], []
    for k, off in enumerate(spec.variable_offsets):
        nb = cell[tuple(np.clip(np.indices(ADJ_GRID)[d] + off[d], 0, m - 1)
                        for d, m in enumerate(ADJ_GRID))]
        rows.append(cell[inner])
        cols.append(nb[inner])
        entry.append(k * n + cell[inner])
    rows, cols, entry = (torch.as_tensor(np.concatenate(a), device=dev)
                         for a in (rows, cols, entry))
    m64 = torch.as_tensor(inner.reshape(n, 1), dtype=torch.float64,
                          device=dev)
    r64 = torch.as_tensor(r_np.reshape(n), device=dev)

    def exact_losses(f, sources, bcs):
        """<r, x*> for the fields ``f`` and each (source, bc) column."""
        A = torch.eye(n, dtype=torch.float64, device=dev)
        A.index_put_((rows, cols), -torch.as_tensor(f, device=dev)
                     .reshape(-1)[entry], accumulate=True)
        s = torch.as_tensor(np.reshape(sources, (-1, n)).T, device=dev)
        g = torch.as_tensor(np.asarray(bcs, np.float64), device=dev)
        x = torch.linalg.solve(A, m64 * s + (1 - m64) * g)
        return (r64 @ x).cpu().numpy()

    # Fourth-order central differences at ADJ_FD_EPS: the two-point rule's
    # own truncation comes within 8% of the bound on a field cell here.
    steps = np.array([1.0, -1.0, 2.0, -2.0]) * ADJ_FD_EPS
    f64, s64 = spec.field_stack().astype(np.float64), \
        src_np.astype(np.float64)
    pick = np.random.default_rng(2)
    t0 = time.perf_counter()
    fd = {}
    for name, base, g in (("fields", f64, card[0]), ("source", s64, card[1]),
                          ("bc", np.float64(0.7), card[2])):
        flat = (pick.choice(base.size, ADJ_FD_CELLS, replace=False)
                if base.ndim else [0])
        got, want, two_point = [], [], []
        for i in flat:
            idx = np.unravel_index(int(i), base.shape)
            if name == "fields":
                v = []
                for h in steps:
                    f = f64.copy()
                    f[idx] += h
                    v.extend(exact_losses(f, s64, [0.7]))
            elif name == "source":
                srcs_fd = np.repeat(s64[None], len(steps), axis=0)
                srcs_fd[(slice(None),) + idx] += steps
                v = exact_losses(f64, srcs_fd, [0.7] * len(steps))
            else:
                v = exact_losses(f64, np.repeat(s64[None], len(steps), 0),
                                 0.7 + steps)
            want.append((8 * (v[0] - v[1]) - (v[2] - v[3]))
                        / (12 * ADJ_FD_EPS))
            two_point.append((v[0] - v[1]) / (2 * ADJ_FD_EPS))
            got.append(float(g[idx]))
        got, want = np.array(got), np.array(want)
        atol = ADJ_FD_TOL["atol"] if base.ndim else 0.0
        bound = atol + ADJ_FD_TOL["rtol"] * np.abs(want)
        bad = np.abs(got - want) > bound
        check(not bad.any(), f"{name}: gradient {got[bad]} against central "
              f"differences {want[bad]}")
        fd[name] = {"cells": len(got),
                    "max_err_over_bound": float((np.abs(got - want)
                                                 / bound).max()),
                    "max_rel_diff": float((np.abs(got - want)
                                           / np.abs(want)).max()),
                    "two_point_max_err_over_bound": float(
                        (np.abs(got - np.array(two_point)) / bound).max())}
    fd_s = time.perf_counter() - t0
    converged = {"rtol": ADJ_RTOL, "loss": loss_b, "loss_cpu": loss_cpu,
                 "value_and_grad_s": card_s,
                 "max_rel_diff_vs_cpu": vs_cpu, "bound_vs_cpu": ADJ_CPU_RTOL,
                 "x0_grad": "exactly 0", "fd_eps": ADJ_FD_EPS,
                 "fd_rule": "fourth-order central, exact float64 fixed "
                            "point", "fd_tol": ADJ_FD_TOL, "fd": fd,
                 "fd_s": fd_s}

    # -- (c) a batch sharing one learned field stack -----------------------
    brng = np.random.default_rng(3)
    srcs = torch.as_tensor(brng.standard_normal(
        (ADJ_BATCH, *ADJ_GRID)).astype(np.float32), device=dev)
    tgts = torch.as_tensor(brng.standard_normal(
        (ADJ_BATCH, *ADJ_GRID)).astype(np.float32), device=dev)
    xb0 = torch.zeros((ADJ_BATCH, *ADJ_GRID), device=dev)
    f_b = torch.as_tensor(spec.field_stack(), device=dev) \
        .requires_grad_(True)
    table1 = dict(backend="conv", bc_value=1.0, rtol=ADJ_RTOL,
                  max_iters=20_000)
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        xb = T.implicit_solve(spec, xb0, fields=f_b.detach(), source=srcs,
                              **table1)
    sync()
    batch_fwd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    xb = T.implicit_solve(spec, xb0, fields=f_b, source=srcs, **table1)
    (gb,) = torch.autograd.grad(torch.sum((xb - tgts) ** 2), f_b)
    sync()
    batch_grad_s = time.perf_counter() - t0
    check(bool(torch.isfinite(xb).all()) and bool(torch.isfinite(gb).all()),
          "the batched solve or its gradient is not finite")
    iters_b = cache.solver(spec, ADJ_GRID, backend="conv",
                           bc=T.DirichletBC(0.0), rtol=ADJ_RTOL,
                           max_iters=20_000).solve(
        xb0, fields=f_b.detach(), source=srcs, bc_value=1.0).iterations
    batched = {"instances": ADJ_BATCH, "grid": list(ADJ_GRID),
               "bc": 1.0, "rtol": ADJ_RTOL,
               "iterations_max": int(iters_b.max()),
               "iterations_min": int(iters_b.min()),
               "fwd_s": batch_fwd_s, "value_and_grad_s": batch_grad_s,
               "fwd_solves_per_s": ADJ_BATCH / batch_fwd_s,
               "grad_solves_per_s": ADJ_BATCH / batch_grad_s}
    del srcs, tgts, xb0, xb, gb

    # -- (d) the learned-stencil family's train steps ----------------------
    cfg = get_config("learned-stencil")
    drng = np.random.default_rng(0)   # examples/learned_stencil.py's data
    kappa = 1.0 + 9.0 * drng.random(cfg.grid)
    true_spec = T.heterogeneous_jacobi(kappa, name="hidden-kappa")
    ls_src = torch.as_tensor(drng.standard_normal(
        (LS_BATCH, *cfg.grid)).astype(np.float32), device=dev)
    with torch.no_grad():
        ls_tgt = T.implicit_solve(
            true_spec, torch.zeros_like(ls_src),
            fields=torch.as_tensor(true_spec.field_stack(), device=dev),
            source=ls_src, backend=cfg.backend, rtol=1e-6,
            max_iters=2 * cfg.max_iters)
    batch = {"source": ls_src, "target": ls_tgt}
    model = build(cfg, device=dev)
    state = init_train_state(model)
    step = make_train_step(model, AdamWConfig(
        lr=LS_LR, warmup_steps=10, total_steps=LS_STEPS, weight_decay=0.0,
        grad_clip=1.0))

    def solve_iters():
        solver = cache.solver(model.spec, cfg.grid, backend=cfg.backend,
                              bc=T.DirichletBC(0.0), rtol=cfg.rtol,
                              atol=cfg.atol, max_iters=cfg.max_iters)
        with torch.no_grad():
            return solver.solve(torch.zeros_like(ls_src),
                                fields=model.taps, source=ls_src,
                                bc_value=model.bc).iterations

    iters_first = solve_iters()
    losses, step_ms = [], []
    for _ in range(LS_STEPS):
        metrics = {}

        def one():
            nonlocal state
            state, m = step(state, batch)
            metrics.update(m)

        step_ms.append(event_ms(one))
        losses.append(float(metrics["loss"]))
    iters_last = solve_iters()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"learned-stencil: loss at step {LS_STEPS} {losses[-1]} is not "
          f"below step 1's {losses[0]}")
    trained = {"arch": cfg.arch, "grid": list(cfg.grid),
               "backend": cfg.backend, "rtol": cfg.rtol,
               "max_iters": cfg.max_iters, "batch": LS_BATCH,
               "steps": LS_STEPS, "lr": LS_LR, "losses": losses,
               "ms_per_step": step_ms,
               "ms_per_step_median_2_on": float(np.median(step_ms[1:])),
               "iterations_per_solve_step1": sorted(set(
                   int(i) for i in iters_first)),
               "iterations_per_solve_after": sorted(set(
                   int(i) for i in iters_last))}

    launches = dict(_build.LAUNCHES)
    check(not launches, f"the differentiable path launched {launches}; it "
          f"runs none of K1-K9")
    seconds = time.perf_counter() - t_phase
    return {"phase": 23, "card": smi, "benchmark_cell": bench,
            "converged": converged, "batched": batched,
            "learned_stencil": trained, "cache": cache.stats.as_dict(),
            "launches": launches, "seconds": seconds}


def lm_families_phases(dev, device_profile):
    """Phases 24-26, the ssm (mamba2-370m) and hybrid (zamba2-1.2b) LM
    families at full width and depth: (24) bf16 serving as
    ``launch.serve.serve`` runs it, then a profiled prefill and decode;
    (25) fp32 checks: (a) decode against the train-mode forward, (b)
    zamba2's flash against xla, (c) the card against the CPU on a
    depth-cut model; (26) bf16 training as ``launch.train.train`` runs
    it.  The launch counts are zeroed before each path
    and read after it; mamba2 launches none of K1-K9, zamba2 K7 once a use
    of its shared block in a forward and K8/K9 once in a backward.
    Returns {"launches": {(phase, arch): launches}, "seconds": {phase: s}}.
    """
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
    from repro_torch.models.model_zoo import build
    from repro_torch.models.transformer import Transformer, mask_pad_logits
    from repro_torch.train.serve_step import (greedy_generate,
                                              make_decode_step,
                                              make_prefill_step)

    def sync():
        torch.cuda.synchronize(dev)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    def flush():
        sync()
        torch.cuda.empty_cache()

    def clone(cache):
        return {k: clone(v) if isinstance(v, dict) else v.clone()
                for k, v in cache.items()}

    def reverse_halo(cache):
        """The conv halos of every Mamba layer in reverse time order."""
        subs = ([cache[k] for k in ("groups", "tail") if k in cache]
                if "groups" in cache else [cache])
        for sub in subs:
            for name in ("conv_x", "conv_bc"):
                sub[name].copy_(sub[name].flip(-2))

    cfgs = {arch: dataclasses.replace(get_config(arch), attn_impl="flash")
            for arch in SSM_ARCHS}

    def uses(cfg):
        """Applications of an attention block in one forward."""
        return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0

    def expect(cfg, fwd=1, bwd=0):
        n = uses(cfg)
        out = {"flash_fwd": fwd * n, "flash_bwd_dq": bwd * n,
               "flash_bwd_dkv": bwd * n}
        return {k: v for k, v in out.items() if v}

    launches, seconds = {}, {}

    # -- 24. bf16 serving -----------------------------------------------------
    t0 = time.perf_counter()
    B24, S24, T24 = SSM_SERVE
    for arch, cfg in cfgs.items():
        # Built here, as ``serve`` builds it, to profile the same weights.
        model = build(cfg, device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(0))
        _build.LAUNCHES.clear()
        served = serve(cfg, batch=B24, prompt_len=S24, tokens=T24,
                       model=model)
        launches[(24, arch)] = dict(_build.LAUNCHES)   # warm-up and timed
        gen = served.pop("generated")
        check(served["prefill_launches"] == expect(cfg)
              and not served["decode_launches"],
              f"{arch} bf16 serve launched {served['prefill_launches']}, "
              f"{served['decode_launches']}")
        check(launches[(24, arch)] == expect(cfg, fwd=2),
              f"{arch} bf16 serve run launched {launches[(24, arch)]}")
        check(gen.shape == (B24, T24 + 1) and bool((gen >= 0).all())
              and bool((gen < cfg.vocab_size).all()),
              f"{arch} bf16 serve tokens")
        # Where the device time goes: one more prefill and decode of the
        # same weights under the profiler (its cost is in the wall).
        prompts = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B24, S24)), device=dev)
        prefill = make_prefill_step(model, S24 + T24 + 1)
        prof_prefill = device_profile(lambda: prefill({"tokens": prompts}),
                                      host=False)
        first, cache = prefill({"tokens": prompts})

        def decode_loop():
            tok = first
            for i in range(SSM_PROFILE_TOKENS):
                tok, _ = make_decode_step(model, S24 + i)(tok, cache)

        prof_decode = device_profile(decode_loop, top=16, host=False)
        prof_decode["tokens"] = SSM_PROFILE_TOKENS
        emit({"phase": 24, **served, "launches_whole_run":
              launches[(24, arch)], "seq0": gen[0].tolist(),
              "profile_prefill": prof_prefill,
              "profile_decode": prof_decode})
        del model, cache, prefill, first
        flush()
    seconds[24] = time.perf_counter() - t0

    # -- 25. fp32 checks on the card ------------------------------------------
    t0 = time.perf_counter()
    B25, S25, T25 = SSM_FP32
    for arch, cfg in cfgs.items():
        pending = []   # checked after the record is written

        def later(ok, what):
            pending.append((bool(ok), what))

        # (a) each decode step's logits against the train-mode forward's
        # over the prompt and the tokens so far (the chunked SSD against
        # its recurrence, the conv halo, the hybrid's six attention caches).
        model = build(cfg, device=dev, dtype=torch.float32,
                      generator=torch.Generator(device=dev).manual_seed(0))
        prompts = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (B25, S25)), device=dev)
        max_len = S25 + T25 + 1
        V, rtol = cfg.vocab_size, SSM_DECODE_RTOL[arch]
        _build.LAUNCHES.clear()
        h, cache = model.prefill(prompts, max_len)
        sync()
        prefill_launches = dict(_build.LAUNCHES)
        later(prefill_launches == expect(cfg),
              f"{arch} fp32 prefill launched {prefill_launches}")
        prefilled = clone(cache)   # for the fault checks below
        seq = prompts
        with torch.no_grad():
            tok = torch.argmax(mask_pad_logits(model.logits(h), cfg), -1)
        first, errs = tok, []
        for i in range(T25):
            seq = torch.cat([seq, tok[:, None]], dim=1)
            logits, cache = model.decode_step(tok, cache, S25 + i)
            with torch.no_grad():
                hidden, _ = model(seq, remat=False)
                want = mask_pad_logits(model.logits(hidden[:, -1]), cfg)
            if i == 0:
                want_first = want
            errs.append(rel(logits[:, :V], want[:, :V]))
            tok = torch.argmax(logits, -1)
        later(max(errs) <= rtol, f"{arch} decode against forward: logits "
              f"{max(errs)} of max-abs")
        # The check's reach: the first step again from a wrong cache.
        faults = {"halo_reversed": (reverse_halo, 0)}
        if cfg.family == "hybrid":
            faults["kv_len_short"] = (None, -1)
        fault_errs = {}
        for name, (corrupt, shift) in faults.items():
            bad = clone(prefilled)
            if corrupt is not None:
                corrupt(bad)
            logits, _ = model.decode_step(first, bad, S25 + shift)
            fault_errs[name] = rel(logits[:, :V], want_first[:, :V])
            later(fault_errs[name] > rtol, f"{arch} decode from a "
                  f"{name} cache: logits only {fault_errs[name]} of "
                  f"max-abs from the forward's")
            del bad
        del prefilled
        record = {"phase": 25, "arch": arch, "dtype": "float32",
                  "batch": B25, "prompt_len": S25, "tokens": T25,
                  "decode_vs_forward_rel_err_by_step": errs, "rtol": rtol,
                  "first_step_from_a_wrong_cache": fault_errs,
                  "prefill_launches": prefill_launches}
        # (b) zamba2's attn_impl paths, as phase 13 runs qwen3's.
        if cfg.family == "hybrid":
            model_x = Transformer(dataclasses.replace(cfg, attn_impl="xla"),
                                  device=dev)
            model_x.load_state_dict(model.state_dict())
            _build.LAUNCHES.clear()
            h_x, _ = model_x.prefill(prompts, max_len)
            sync()
            later(not _build.LAUNCHES, "the xla prefill launched a kernel")
            hidden_rel = rel(h, h_x)
            later(hidden_rel <= ZAMBA_FLASH_RTOL, f"{arch} fp32 prefill "
                  f"hidden flash vs xla: {hidden_rel} of max-abs")
            tok_f = greedy_generate(model, {"tokens": prompts}, steps=T25,
                                    max_len=max_len)
            tok_x = greedy_generate(model_x, {"tokens": prompts}, steps=T25,
                                    max_len=max_len)
            margins = []
            for b in range(B25):
                diff = (tok_f[b] != tok_x[b]).nonzero()
                if len(diff) == 0:
                    continue
                t = int(diff[0])   # later tokens follow other prefixes
                ctx = torch.cat([prompts[b], tok_x[b, :t]])[None]
                h_t, _ = model_x.prefill(ctx, ctx.shape[1])
                with torch.no_grad():
                    lg = mask_pad_logits(model_x.logits(h_t), cfg)[0]
                top2 = torch.topk(lg, 2).values
                margin = float(top2[0] - top2[1]) / float(lg.abs().max())
                margins.append({"row": b, "position": t,
                                "rel_margin": margin})
                later(margin <= ZAMBA_FLASH_RTOL, f"{arch} row {b} token "
                      f"{t}: flash and xla disagree where xla's top-2 "
                      f"margin is {margin} of max-abs")
            record["flash_vs_xla"] = {
                "hidden_rel_err": hidden_rel, "rtol": ZAMBA_FLASH_RTOL,
                "tokens_agree": int((tok_f == tok_x).sum()),
                "tokens_total": B25 * T25, "first_disagreements": margins}
            del model_x
        del model, cache
        flush()
        # (c) the card against the CPU: a depth-cut model, the same weights.
        small = dataclasses.replace(cfg, n_layers=SSM_CPU_DEPTH[arch])
        card = build(small, device=dev, dtype=torch.float32,
                     generator=torch.Generator(device=dev).manual_seed(2))
        cpu = Transformer(small, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in
                             card.state_dict().items()})
        Bc, Sc = SSM_CPU
        tokens = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                   (Bc, Sc))
        h_card, _ = card.prefill(torch.as_tensor(tokens, device=dev), Sc)
        h_cpu, _ = cpu.prefill(torch.as_tensor(tokens), Sc)
        card_rel = rel(h_card.cpu(), h_cpu)
        later(bool(torch.isfinite(h_card).all())
              and card_rel <= SSM_CPU_RTOL,
              f"{arch} prefill hidden card vs CPU: {card_rel} of max-abs")
        record["card_vs_cpu"] = {"n_layers": small.n_layers, "batch": Bc,
                                 "prompt_len": Sc, "hidden_rel_err": card_rel,
                                 "rtol": SSM_CPU_RTOL}
        emit(record)
        for ok, what in pending:
            check(ok, what)
        del card, cpu
        flush()
    seconds[25] = time.perf_counter() - t0

    # -- 26. bf16 training ----------------------------------------------------
    t0 = time.perf_counter()
    B26, S26, T26 = SSM_TRAIN
    for arch, cfg in cfgs.items():
        _build.LAUNCHES.clear()
        trained = train(cfg, steps=T26, global_batch=B26, seq_len=S26,
                        device=dev, seed=0)
        launches[(26, arch)] = dict(_build.LAUNCHES)
        steps = trained.pop("steps")
        for rec in steps:
            check(rec["launches"] == expect(cfg, fwd=2, bwd=1),
                  f"{arch} bf16 train step {rec['step']} launched "
                  f"{rec['launches']}")
            check(all(math.isfinite(rec[k]) for k in ("loss", "nll",
                                                       "grad_norm")),
                  f"{arch} bf16 train step {rec['step']}: {rec}")
        timed = steps[1:]   # the first pays the allocator's growth
        ms = sum(r["ms"] for r in timed) / len(timed)
        emit({"phase": 26, **trained, "steps": [
            {k: r[k] for k in ("step", "loss", "nll", "grad_norm", "lr",
                               "ms", "tokens_per_s", "launches")}
            for r in steps],
            "ms_per_step": ms, "tokens_per_s": B26 * S26 / (ms * 1e-3),
            "launches_whole_run": launches[(26, arch)]})
        flush()
    seconds[26] = time.perf_counter() - t0
    emit({"lm_families_seconds": seconds})
    return {"launches": launches, "seconds": seconds}


def moe_phases(dev, device_profile):
    """Phases 27-29, the moe family (qwen3-moe-30b-a3b: 128 experts, top 8,
    GQA 8; moonshot-v1-16b-a3b: 64 experts, top 6, two shared, MHA 16) at
    full width: (27) bf16 serving at full depth as ``launch.serve.serve``
    runs it, the peak memory of building the model in place, then a
    profiled prefill and decode; (28) fp32 checks at depth cuts: (a)
    decode against the train-mode forward, where nothing is dropped, and
    two planted faults it must see, (b) flash against xla on the prefill,
    (c) the card against the CPU, (d) einsum against scatter dispatch on
    one layer, outputs and gradients; (29) bf16 training at depth 4 as
    ``launch.train.train`` runs it.  The launch counts are zeroed before
    each path and read after it: K7 once a layer in a forward (twice in a
    train step: forward and recompute), K8/K9 once a layer in a backward.
    Returns {"launches": {(phase, arch): launches}, "seconds": {phase: s}}.
    """
    import numpy as np
    import torch

    from _torch_moe_cases import no_drop_config, slots_swapped
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
    from repro_torch.models.layers import flatten
    from repro_torch.models.model_zoo import build
    from repro_torch.models.moe import MoE, expert_capacity, moe_table, route
    from repro_torch.models.transformer import (Transformer, mask_pad_logits,
                                                model_table, stacked_axes)
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step)

    def sync():
        torch.cuda.synchronize(dev)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    def flush():
        sync()
        torch.cuda.empty_cache()

    def gb(n):
        return n / 1e9

    cfgs = {arch: dataclasses.replace(get_config(arch), attn_impl="flash")
            for arch in MOE_ARCHS}

    def expect(n_layers, fwd=1, bwd=0):
        out = {"flash_fwd": fwd * n_layers, "flash_bwd_dq": bwd * n_layers,
               "flash_bwd_dkv": bwd * n_layers}
        return {k: v for k, v in out.items() if v}

    launches, seconds = {}, {}

    # -- 27. bf16 serving at full width and depth -----------------------------
    t0 = time.perf_counter()
    B27, S27, T27 = MOE_SERVE
    for arch, cfg in cfgs.items():
        flush()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t_build = time.perf_counter()
        model = build(cfg, device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(0))
        sync()
        build_s = time.perf_counter() - t_build
        # In place: the model, and beside it at most one layer's slice of
        # the largest stacked leaf drawn in fp32.
        model_bytes = sum(p.numel() * p.element_size()
                          for p in model.parameters())
        axes = stacked_axes(cfg)
        slice_bytes = max(4 * math.prod(pd.shape[len(axes[path[0]]):])
                          for path, pd in flatten(model_table(cfg))
                          if path[0] in axes)
        build_peak = torch.cuda.max_memory_allocated(dev) - base
        check(build_peak <= model_bytes + slice_bytes,
              f"{arch} build peak {gb(build_peak)} GB past the model "
              f"{gb(model_bytes)} GB plus one slice {gb(slice_bytes)} GB")
        _build.LAUNCHES.clear()
        served = serve(cfg, batch=B27, prompt_len=S27, tokens=T27,
                       model=model)
        launches[(27, arch)] = dict(_build.LAUNCHES)   # warm-up and timed
        gen = served.pop("generated")
        check(served["prefill_launches"] == expect(cfg.n_layers)
              and not served["decode_launches"],
              f"{arch} bf16 serve launched {served['prefill_launches']}, "
              f"{served['decode_launches']}")
        check(launches[(27, arch)] == expect(cfg.n_layers, fwd=2),
              f"{arch} bf16 serve run launched {launches[(27, arch)]}")
        check(gen.shape == (B27, T27 + 1) and bool((gen >= 0).all())
              and bool((gen < cfg.vocab_size).all()),
              f"{arch} bf16 serve tokens")
        prompts = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B27, S27)), device=dev)
        prefill = make_prefill_step(model, S27 + T27 + 1)
        prof_prefill = device_profile(lambda: prefill({"tokens": prompts}),
                                      top=16, host=False)
        first, cache = prefill({"tokens": prompts})

        def decode_loop():
            tok = first
            for i in range(MOE_PROFILE_TOKENS):
                tok, _ = make_decode_step(model, S27 + i)(tok, cache)

        prof_decode = device_profile(decode_loop, top=16, host=False)
        prof_decode["tokens"] = MOE_PROFILE_TOKENS
        emit({"phase": 27, **served, "launches_whole_run":
              launches[(27, arch)], "seq0": gen[0].tolist(),
              "build_s": build_s, "model_GB": gb(model_bytes),
              "build_peak_GB": gb(build_peak),
              "build_bound_GB": gb(model_bytes + slice_bytes),
              "profile_prefill": prof_prefill,
              "profile_decode": prof_decode})
        del model, cache, prefill, first, prompts
        flush()
    seconds[27] = time.perf_counter() - t0

    # -- 28. fp32 checks at depth cuts ----------------------------------------
    t0 = time.perf_counter()
    B28, S28, T28 = MOE_FP32
    for arch, cfg in cfgs.items():
        pending = []   # checked after the record is written

        def later(ok, what):
            pending.append((bool(ok), what))

        V = cfg.vocab_size
        cut = dataclasses.replace(cfg, n_layers=MOE_FP32_DEPTH)
        # (a) each decode step's logits against the train-mode forward's
        # over the prompt and the tokens so far.  The forward's token
        # counts (2 x (1024 + i + 1)) are no multiple of the 1024-token
        # group, and a forward that drops tokens differs from decode (a
        # group of B): the check runs one group a call with a capacity of
        # the whole group, where nothing drops (no_drop_config).
        cfg_a = no_drop_config(cut, B28 * (S28 + T28))
        model = build(cfg_a, device=dev, dtype=torch.float32,
                      generator=torch.Generator(device=dev).manual_seed(0))
        prompts = torch.as_tensor(np.random.default_rng(1).integers(
            0, V, (B28, S28)), device=dev)
        max_len = S28 + T28 + 1
        rtol = MOE_DECODE_RTOL[arch]
        _build.LAUNCHES.clear()
        h, cache = model.prefill(prompts, max_len)
        sync()
        prefill_launches = dict(_build.LAUNCHES)
        later(prefill_launches == expect(cut.n_layers),
              f"{arch} fp32 prefill launched {prefill_launches}")
        prefilled = {k: v.clone() for k, v in cache.items()}
        seq = prompts
        with torch.no_grad():
            tok = torch.argmax(mask_pad_logits(model.logits(h), cfg), -1)
        first, errs = tok, []
        for i in range(T28):
            seq = torch.cat([seq, tok[:, None]], dim=1)
            logits, cache = model.decode_step(tok, cache, S28 + i)
            with torch.no_grad():
                hidden, _ = model(seq, remat=False)
                want = mask_pad_logits(model.logits(hidden[:, -1]), cfg)
            if i == 0:
                want_first = want
            errs.append(rel(logits[:, :V], want[:, :V]))
            tok = torch.argmax(logits, -1)
            del hidden
        later(max(errs) <= rtol, f"{arch} decode against forward: logits "
              f"{max(errs)} of max-abs")
        # The check's reach: the first step again from a cache one place
        # short, and with the first token's two slots' gates swapped.
        fault_errs = {}
        for name in ("kv_len_short", "slots_swapped"):
            bad = {k: v.clone() for k, v in prefilled.items()}
            if name == "kv_len_short":
                logits, _ = model.decode_step(first, bad, S28 - 1)
            else:
                with slots_swapped():
                    logits, _ = model.decode_step(first, bad, S28)
            fault_errs[name] = rel(logits[:, :V], want_first[:, :V])
            later(fault_errs[name] > rtol, f"{arch} decode with "
                  f"{name}: logits only {fault_errs[name]} of max-abs "
                  f"from the forward's")
            del bad
        state = model.state_dict()
        del model, cache, prefilled, h
        flush()
        record = {"phase": 28, "arch": arch, "dtype": "float32",
                  "n_layers": cut.n_layers, "batch": B28, "prompt_len": S28,
                  "tokens": T28, "decode_capacity_factor":
                      cfg_a.capacity_factor,
                  "decode_vs_forward_rel_err_by_step": errs, "rtol": rtol,
                  "first_step_with_a_fault": fault_errs,
                  "prefill_launches": prefill_launches}
        # (b) flash against xla on the prefill, at the config's own groups
        # (1024 tokens, capacity factor 1.25: tokens may drop).
        hidden = {}
        for impl in ("flash", "xla"):
            m = Transformer(dataclasses.replace(cut, attn_impl=impl),
                            device=dev)
            m.load_state_dict(state)
            _build.LAUNCHES.clear()
            hidden[impl], _ = m.prefill(prompts, S28)
            sync()
            later(dict(_build.LAUNCHES) == (expect(cut.n_layers)
                                            if impl == "flash" else {}),
                  f"{arch} fp32 {impl} prefill launched "
                  f"{dict(_build.LAUNCHES)}")
            del m
            flush()
        flash_rel = rel(hidden["flash"], hidden["xla"])
        later(bool(torch.isfinite(hidden["flash"]).all())
              and flash_rel <= MOE_FLASH_RTOL[arch],
              f"{arch} fp32 prefill hidden flash vs xla: {flash_rel}")
        record["flash_vs_xla"] = {"hidden_rel_err": flash_rel,
                                  "rtol": MOE_FLASH_RTOL[arch]}
        del state, hidden, prompts
        flush()
        # (c) the card against the CPU: a depth-cut model, the same weights.
        small = dataclasses.replace(cfg, n_layers=MOE_CPU_DEPTH)
        card = build(small, device=dev, dtype=torch.float32,
                     generator=torch.Generator(device=dev).manual_seed(2))
        cpu = Transformer(small, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in
                             card.state_dict().items()})
        Bc, Sc = MOE_CPU
        tokens = np.random.default_rng(2).integers(0, V, (Bc, Sc))
        h_card, _ = card.prefill(torch.as_tensor(tokens, device=dev), Sc)
        h_cpu, _ = cpu.prefill(torch.as_tensor(tokens), Sc)
        card_rel = rel(h_card.cpu(), h_cpu)
        later(bool(torch.isfinite(h_card).all())
              and card_rel <= MOE_CPU_RTOL[arch],
              f"{arch} prefill hidden card vs CPU: {card_rel} of max-abs")
        record["card_vs_cpu"] = {"n_layers": small.n_layers, "batch": Bc,
                                 "prompt_len": Sc, "hidden_rel_err": card_rel,
                                 "rtol": MOE_CPU_RTOL[arch]}
        del card, cpu
        flush()
        # (d) einsum against scatter dispatch: one layer at full width
        # (moe_table's own draws), the config's capacity factor (tokens
        # drop), the output and the gradients of <out, r> + aux.
        Bd, Sd = MOE_DISPATCH
        gen = torch.Generator(device=dev).manual_seed(3)
        table = moe_table(cfg.d_model, cfg.n_experts, cfg.d_ff_expert,
                          cfg.n_shared_experts)
        x = torch.randn(Bd, Sd, cfg.d_model, generator=gen, device=dev)
        r = torch.randn(Bd, Sd, cfg.d_model, generator=gen, device=dev)
        res, dropped = {}, None
        for mode in ("einsum", "scatter"):
            layer = MoE(cfg.d_model, cfg.n_experts, cfg.d_ff_expert,
                        cfg.n_shared_experts, top_k=cfg.top_k,
                        capacity_factor=cfg.capacity_factor,
                        activation=cfg.activation, n_waves=cfg.moe_waves,
                        dispatch_mode=mode, device=dev)
            g = torch.Generator(device=dev).manual_seed(4)
            for path, pd in flatten(table):
                pd.fill(layer.get_parameter(".".join(path)), g)
            xx = x.clone().requires_grad_()
            out, aux = layer(xx, cfg.moe_group_size)
            names, leaves = zip(*layer.named_parameters())
            grads = torch.autograd.grad((out * r).sum() + aux,
                                        [*leaves, xx])
            res[mode] = (out.detach(), float(aux.detach()),
                         dict(zip((*names, "x"), grads)))
            if dropped is None:   # the share of slots past capacity
                gs = min(cfg.moe_group_size, Bd * Sd)
                _, _, _, _, keep = route(
                    x.reshape(-1, gs, cfg.d_model), layer.router, cfg.top_k,
                    expert_capacity(gs, cfg.top_k, cfg.capacity_factor,
                                    cfg.n_experts))
                dropped = float(1 - keep.float().mean())
            del layer, out, grads, xx
            flush()
        out_rel = rel(res["scatter"][0], res["einsum"][0])
        grad_rel = {n: rel(res["scatter"][2][n], g)
                    for n, g in res["einsum"][2].items()}
        worst_grad = max(grad_rel, key=grad_rel.get)
        tol_out, tol_grad = MOE_DISPATCH_RTOL[arch]
        later(out_rel <= tol_out, f"{arch} scatter vs einsum output "
              f"{out_rel}")
        later(grad_rel[worst_grad] <= tol_grad, f"{arch} scatter vs einsum "
              f"grad {worst_grad} {grad_rel[worst_grad]}")
        later(res["scatter"][1] == res["einsum"][1], f"{arch} aux differs "
              f"between dispatch modes")
        record["einsum_vs_scatter"] = {
            "batch": Bd, "tokens": Sd, "dropped_slot_share": dropped,
            "out_rel_err": out_rel, "grad_rel_err": grad_rel,
            "worst_grad": worst_grad, "rtol": [tol_out, tol_grad]}
        del res, x, r
        emit(record)
        for ok, what in pending:
            check(ok, what)
        flush()
    seconds[28] = time.perf_counter() - t0

    # -- 29. bf16 training at full width, depth 4 -----------------------------
    t0 = time.perf_counter()
    B29, S29, T29 = MOE_TRAIN
    for arch, cfg in cfgs.items():
        flush()
        cut = dataclasses.replace(cfg, n_layers=MOE_TRAIN_DEPTH)
        _build.LAUNCHES.clear()
        trained = train(cut, steps=T29, global_batch=B29, seq_len=S29,
                        device=dev, seed=0)
        launches[(29, arch)] = dict(_build.LAUNCHES)
        steps = trained.pop("steps")
        for rec in steps:
            check(rec["launches"] == expect(cut.n_layers, fwd=2, bwd=1),
                  f"{arch} bf16 train step {rec['step']} launched "
                  f"{rec['launches']}")
            check(all(math.isfinite(rec[k]) for k in ("loss", "nll", "aux",
                                                       "grad_norm")),
                  f"{arch} bf16 train step {rec['step']}: {rec}")
        timed = steps[1:]   # the first pays the allocator's growth
        ms = sum(r["ms"] for r in timed) / len(timed)
        emit({"phase": 29, **trained, "n_layers": cut.n_layers, "steps": [
            {**{k: r[k] for k in ("step", "loss", "nll", "aux", "grad_norm",
                                  "lr", "ms", "tokens_per_s", "launches")},
             "aux_per_layer": r["aux"] / cut.n_layers} for r in steps],
            "ms_per_step": ms, "tokens_per_s": B29 * S29 / (ms * 1e-3),
            "launches_whole_run": launches[(29, arch)]})
        flush()
    seconds[29] = time.perf_counter() - t0
    emit({"moe_seconds": seconds})
    return {"launches": launches, "seconds": seconds}


def pairs_of(shape, causal, kv_offset=0):
    """(query, visible key) pairs of a case: with ``kv_offset`` query i
    sees keys up to i + kv_offset (a sequence shard's queries)."""
    B_, Sq_, Skv_, H_ = shape[:4]
    if not causal:
        return B_ * H_ * Sq_ * Skv_
    return B_ * H_ * sum(min(i + kv_offset + 1, Skv_) for i in range(Sq_))


def _sdpa_kw(shape, causal, kv_offset, dev):
    """SDPA's arguments for a case: ``is_causal`` aligns to the top left,
    so an offset shard passes its boolean mask (key j visible to query i
    where j <= i + kv_offset)."""
    import torch
    B_, Sq_, Skv_, H_, KV_ = shape[:5]
    kw = {"enable_gqa": H_ != KV_}
    if causal and kv_offset:
        kw["attn_mask"] = (torch.arange(Skv_, device=dev)[None, :]
                           <= torch.arange(Sq_, device=dev)[:, None]
                           + kv_offset)
    else:
        kw["is_causal"] = causal
    return kw


def k7_timing(shape, causal, dev, gen, graph_ms, time_ms, kv_offset=0,
              dtype=None):
    """K7 at a case of FLASH_CASES in bf16 (or ``dtype``; inputs from
    ``gen``): its time by ``graph_ms`` (a CUDA graph's replay), the plain
    version's and SDPA's (``enable_gqa`` where grouped, a boolean mask for
    an offset shard), the operations (4 hd a pair), bytes (q, k, v, out,
    lse) and bound (phase 15; fp32 at the fp32 peak)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_fwd, flash_fwd_plain
    dtype = dtype or torch.bfloat16
    size = torch.finfo(dtype).bits // 8
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    B_, Sq_, Skv_, H_, KV_, hd_ = shape
    q, k, v = (torch.randn(s_, generator=gen, device=dev).to(dtype)
               for s_ in ((B_, Sq_, H_, hd_), (B_, Skv_, KV_, hd_),
                          (B_, Skv_, KV_, hd_)))
    ops = 4 * hd_ * pairs_of(shape, causal, kv_offset)
    nbytes = (size * (2 * B_ * Sq_ * H_ * hd_ + 2 * B_ * Skv_ * KV_ * hd_)
              + B_ * H_ * Sq_ * 4)
    kw = dict(causal=causal, kv_offset=kv_offset)
    out = {"shape": list(shape), "causal": causal, "operations": ops,
           "bytes": nbytes, "kv_offset": kv_offset,
           "k7_ms": graph_ms(lambda: flash_fwd(q, k, v, **kw), 5),
           "plain_ms": time_ms(lambda: flash_fwd_plain(q, k, v, **kw), 3)}
    qs, ks, vs = (t_.transpose(1, 2).contiguous() for t_ in (q, k, v))
    sdpa = _sdpa_kw(shape, causal, kv_offset, dev)
    out["sdpa_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, **sdpa), 5)
    out["bound_ms"] = max(ops / peak, nbytes / PEAK_BYTES) * 1e3
    out["k7_TFLOPs"] = ops / (out["k7_ms"] * 1e-3) / 1e12
    return out


def k89_timing(shape, causal, dev, gen, graph_ms, time_ms, kv_offset=0,
               dtype=None):
    """K8 and K9 at a case of FLASH_CASES in bf16 (or ``dtype``; inputs
    from ``gen``; o and lse from K7): their times by ``graph_ms``, the
    plain versions', the backward of SDPA (dq, dk and dv together; a
    boolean mask for an offset shard), operations (6 hd and 8 hd a pair),
    bytes and bounds (phase 19)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_fwd
    from repro_torch.kernels.flash_attention_bwd import (
        flash_bwd_dkv_plain, flash_bwd_dq_plain, flash_delta, launch_bwd_dkv,
        launch_bwd_dq)
    dtype = dtype or torch.bfloat16
    size = torch.finfo(dtype).bits // 8
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    B_, Sq_, Skv_, H_, KV_, hd_ = shape
    q, k, v, do = (torch.randn(s_, generator=gen, device=dev).to(dtype)
                   for s_ in ((B_, Sq_, H_, hd_), (B_, Skv_, KV_, hd_),
                              (B_, Skv_, KV_, hd_), (B_, Sq_, H_, hd_)))
    kw = dict(causal=causal, kv_offset=kv_offset)
    o, lse = flash_fwd(q, k, v, **kw)
    args = (q, k, v, do, lse, flash_delta(o, do))
    pairs = pairs_of(shape, causal, kv_offset)
    qkv = size * (2 * B_ * Sq_ * H_ * hd_ + 2 * B_ * Skv_ * KV_ * hd_)
    stat = 2 * B_ * H_ * Sq_ * 4
    k8_bytes = qkv + stat + size * B_ * Sq_ * H_ * hd_
    k9_bytes = qkv + stat + 2 * size * B_ * Skv_ * KV_ * hd_
    out = {"shape": list(shape), "causal": causal, "kv_offset": kv_offset,
           "k8_operations": 6 * hd_ * pairs,
           "k9_operations": 8 * hd_ * pairs,
           "k8_bytes": k8_bytes, "k9_bytes": k9_bytes,
           "k8_ms": graph_ms(lambda: launch_bwd_dq(*args, **kw), 5),
           "k9_ms": graph_ms(lambda: launch_bwd_dkv(*args, **kw), 5),
           "k8_plain_ms": time_ms(lambda: flash_bwd_dq_plain(*args, **kw),
                                  3),
           "k9_plain_ms": time_ms(lambda: flash_bwd_dkv_plain(*args, **kw),
                                  3),
           "k8_bound_ms": max(6 * hd_ * pairs / peak,
                              k8_bytes / PEAK_BYTES) * 1e3,
           "k9_bound_ms": max(8 * hd_ * pairs / peak,
                              k9_bytes / PEAK_BYTES) * 1e3}
    qs, ks, vs = (t_.transpose(1, 2).contiguous().requires_grad_()
                  for t_ in (q, k, v))
    o_s = F.scaled_dot_product_attention(
        qs, ks, vs, **_sdpa_kw(shape, causal, kv_offset, dev))
    do_s = do.transpose(1, 2).contiguous()
    out["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        o_s, (qs, ks, vs), do_s, retain_graph=True), 5)
    return out


def vlm_encdec_phases(dev, device_profile):
    """Phases 30-32, the vlm (qwen2-vl-2b) and encdec (whisper-tiny) LM
    families at full width and depth: (30, 31) bf16 serving as
    ``launch.serve.serve`` runs it, with qwen2-vl's 1024 vision embeddings
    on Qwen2-VL's 32 x 32 grid ids and whisper's 1500 frames drawn from the
    seed, a profiled prefill and decode, then bf16 training as
    ``launch.train.train`` runs it; (32) fp32 checks: (a) decode against the
    train-mode forward, with planted faults it must see (M-RoPE sections
    swapped; cross-attention run causal; the encoder's sinusoid one
    position late), (b) flash against xla on the prefill, (c) the card
    against the CPU.  The launch counts are zeroed before each path and
    read after it: K7 once a layer in a qwen2-vl forward and once an
    encoder layer and twice a decoder layer (self, cross) in whisper's;
    K8/K9 once each of those in a backward.  Returns {"launches": {(phase,
    arch): launches}, "seconds": {phase: s}}.
    """
    import numpy as np
    import torch

    from _torch_vlm_encdec_cases import (cross_attention_causal,
                                         decode_vs_forward, family_inputs,
                                         rel, sections_swapped,
                                         sinusoid_shifted)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
    from repro_torch.models.model_zoo import build
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step)

    def sync():
        torch.cuda.synchronize(dev)

    def flush():
        sync()
        torch.cuda.empty_cache()

    cfgs = {arch: dataclasses.replace(get_config(arch), attn_impl="flash")
            for arch in (VLM_ARCH, ENCDEC_ARCH)}

    def expect(cfg, fwd=1, bwd=0):
        uses = (cfg.n_enc_layers + 2 * cfg.n_layers
                if cfg.family == "encdec" else cfg.n_layers)
        out = {"flash_fwd": fwd * uses, "flash_bwd_dq": bwd * uses,
               "flash_bwd_dkv": bwd * uses}
        return {k: v for k, v in out.items() if v}

    def inputs(cfg, batch, seq, seed, n_vision=None, width=VLM_GRID_W,
               dtype=torch.bfloat16):
        return family_inputs(cfg, batch, seq, seed, dev, dtype, n_vision,
                             width)

    launches, seconds = {}, {}

    # -- 30, 31. bf16 serving and training at full width and depth -----------
    for phase, arch, (Bs, Ss, Ts), (Bt, St, Tt) in (
            (30, VLM_ARCH, VLM_SERVE, VLM_TRAIN),
            (31, ENCDEC_ARCH, ENC_SERVE, ENC_TRAIN)):
        t0 = time.perf_counter()
        cfg = cfgs[arch]
        flush()
        model = build(cfg, device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(0))
        extra = inputs(cfg, Bs, Ss, 0)
        _build.LAUNCHES.clear()
        served = serve(cfg, batch=Bs, prompt_len=Ss, tokens=Ts, model=model,
                       inputs=extra)
        launches[(phase, arch)] = dict(_build.LAUNCHES)  # warm-up and timed
        gen = served.pop("generated")
        check(served["prefill_launches"] == expect(cfg)
              and not served["decode_launches"],
              f"{arch} bf16 serve launched {served['prefill_launches']}, "
              f"{served['decode_launches']}")
        check(launches[(phase, arch)] == expect(cfg, fwd=2),
              f"{arch} bf16 serve run launched {launches[(phase, arch)]}")
        check(gen.shape == (Bs, Ts + 1) and bool((gen >= 0).all())
              and bool((gen < cfg.vocab_size).all()),
              f"{arch} bf16 serve tokens")
        # Where the device time goes: one more prefill and decode of the
        # same weights and inputs under the profiler.
        batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (Bs, Ss)), device=dev), **extra}
        prefill = make_prefill_step(model, Ss + Ts + 1)
        prof_prefill = device_profile(lambda: prefill(batch), top=16,
                                      host=False)
        first, cache = prefill(batch)

        def decode_loop():
            tok = first
            for i in range(VE_PROFILE_TOKENS):
                tok, _ = make_decode_step(model, Ss + i)(tok, cache)

        prof_decode = device_profile(decode_loop, top=16, host=False)
        prof_decode["tokens"] = VE_PROFILE_TOKENS
        n_params = sum(p.numel() for p in model.parameters())
        del model, cache, prefill, first, batch, extra
        flush()
        # Trained on inputs drawn from the seed as well: the launcher's zero
        # vision stub (JAX's) overflows qwen2-vl's gradients at full depth
        # (ROADMAP §3).
        key = (phase, f"{arch} train")
        _build.LAUNCHES.clear()
        trained = train(cfg, steps=Tt, global_batch=Bt, seq_len=St,
                        device=dev, seed=0, inputs=inputs(cfg, Bt, St, 3))
        launches[key] = dict(_build.LAUNCHES)
        steps = trained.pop("steps")
        for rec in steps:
            check(rec["launches"] == expect(cfg, fwd=2, bwd=1),
                  f"{arch} bf16 train step {rec['step']} launched "
                  f"{rec['launches']}")
            check(all(math.isfinite(rec[k]) for k in ("loss", "nll",
                                                       "grad_norm")),
                  f"{arch} bf16 train step {rec['step']}: {rec}")
        timed = steps[1:]   # the first pays the allocator's growth
        ms = sum(r["ms"] for r in timed) / len(timed)
        seconds[phase] = time.perf_counter() - t0
        emit({"phase": phase, "parameters": n_params, **served,
              "launches_whole_run": launches[(phase, arch)],
              "seq0": gen[0].tolist(), "profile_prefill": prof_prefill,
              "profile_decode": prof_decode,
              "train": {**trained, "steps": [
                  {k: r[k] for k in ("step", "loss", "grad_norm", "lr", "ms",
                                     "tokens_per_s", "launches")}
                  for r in steps],
                  "ms_per_step": ms, "tokens_per_s": Bt * St / (ms * 1e-3),
                  "launches_whole_run": launches[key]},
              "seconds": seconds[phase]})
        flush()

    # -- 32. fp32 checks ------------------------------------------------------
    t0 = time.perf_counter()
    pending = []   # checked after the record is written

    def later(ok, what):
        pending.append((bool(ok), what))

    record = {"phase": 32, "dtype": "float32"}
    for arch, cfg in cfgs.items():
        vlm = cfg.family == "vlm"
        B, S, T = VE_FP32[arch]
        cut = dataclasses.replace(cfg, **VE_FP32_CUT[arch])
        rtol = VE_DECODE_RTOL[arch]
        model = build(cut, device=dev, dtype=torch.float32,
                      generator=torch.Generator(device=dev).manual_seed(0))
        prompts = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (B, S)), device=dev)
        extra = inputs(cut, B, S, 1, dtype=torch.float32)
        pos = extra.pop("positions", None)
        # (a) decode against the forward, then the first step again from a
        # prefill with a fault planted.
        _build.LAUNCHES.clear()
        res = decode_vs_forward(model, prompts, T, extra, pos)
        sync()
        later(dict(_build.LAUNCHES) == expect(cut, fwd=T + 1),
              f"{arch} fp32 decode against forward launched "
              f"{dict(_build.LAUNCHES)}")
        later(max(res["errs"]) <= rtol, f"{arch} decode against forward: "
              f"logits {max(res['errs'])} of max-abs")
        first = res["tokens"][:, :1]
        faults = {}
        if vlm:
            bad = type(model)(dataclasses.replace(
                cut, m_rope_sections=sections_swapped(cut.m_rope_sections)),
                device=dev)
            bad.load_state_dict(model.state_dict())
            faults["sections_swapped"] = decode_vs_forward(
                model, prompts, 1, extra, pos, tokens=first,
                prefill_model=bad)["errs"][0]
            del bad
        else:
            # The forward's cross-attention run causal (decode attends to
            # the whole cache, so the fault lives in the full-sequence
            # path), and the prefill's encoder a position late.
            faults["cross_attention_causal"] = decode_vs_forward(
                model, prompts, 1, extra, tokens=first,
                forward_fault=cross_attention_causal)["errs"][0]
            faults["sinusoid_shifted"] = decode_vs_forward(
                model, prompts, 1, extra, tokens=first,
                fault=sinusoid_shifted)["errs"][0]
        for name, e in faults.items():
            later(e > rtol, f"{arch} decode with {name}: logits only {e} "
                  f"of max-abs from the forward's")
        # (b) flash against xla on the prefill hidden, the same weights.
        state = model.state_dict()
        hidden = {}
        for impl in ("flash", "xla"):
            m = type(model)(dataclasses.replace(cut, attn_impl=impl),
                            device=dev)
            m.load_state_dict(state)
            kw = dict(extra) if pos is None else {**extra, "positions": pos}
            _build.LAUNCHES.clear()
            hidden[impl], _ = m.prefill(prompts, S, **kw)
            sync()
            later(dict(_build.LAUNCHES) == (expect(cut) if impl == "flash"
                                            else {}),
                  f"{arch} fp32 {impl} prefill launched "
                  f"{dict(_build.LAUNCHES)}")
            del m
        flash_rel = rel(hidden["flash"], hidden["xla"])
        later(bool(torch.isfinite(hidden["flash"]).all())
              and flash_rel <= VE_FLASH_RTOL[arch],
              f"{arch} fp32 prefill hidden flash vs xla: {flash_rel}")
        del model, state, hidden
        flush()
        # (c) the card against the CPU: a depth-cut model, the same weights
        # and inputs.
        Bc, Sc, nvc, wc = VE_CPU[arch]
        small = dataclasses.replace(cfg, **VE_CPU_CUT[arch])
        card = build(small, device=dev, dtype=torch.float32,
                     generator=torch.Generator(device=dev).manual_seed(2))
        cpu = type(card)(small, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in
                             card.state_dict().items()})
        tokens = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (Bc, Sc)), device=dev)
        kw = inputs(small, Bc, Sc, 2, n_vision=nvc, width=wc,
                    dtype=torch.float32)
        h_card, _ = card.prefill(tokens, Sc, **kw)
        h_cpu, _ = cpu.prefill(tokens.cpu(), Sc,
                               **{k: v.cpu() for k, v in kw.items()})
        card_rel = rel(h_card.cpu(), h_cpu)
        later(bool(torch.isfinite(h_card).all())
              and card_rel <= VE_CPU_RTOL[arch],
              f"{arch} prefill hidden card vs CPU: {card_rel} of max-abs")
        record[arch] = {
            "decode_vs_forward": {
                "cut": VE_FP32_CUT[arch], "batch": B, "prompt_len": S,
                "tokens": T, "rel_err_by_step": res["errs"], "rtol": rtol,
                "first_step_with_a_fault": faults},
            "flash_vs_xla": {"hidden_rel_err": flash_rel,
                             "rtol": VE_FLASH_RTOL[arch]},
            "card_vs_cpu": {"cut": VE_CPU_CUT[arch], "batch": Bc,
                            "prompt_len": Sc, "hidden_rel_err": card_rel,
                            "rtol": VE_CPU_RTOL[arch]}}
        del card, cpu, extra, prompts, res
        flush()
    seconds[32] = time.perf_counter() - t0
    emit(record)
    for ok, what in pending:
        check(ok, what)
    emit({"vlm_encdec_seconds": seconds})
    return {"launches": launches, "seconds": seconds}


def dense_ft_phases(dev, device_profile):
    """Phases 33-35: (33) the dense family's last archs (glm4-9b: GQA 16 on
    2 kv heads; phi3-medium-14b: GQA 4 on 10; nemotron-4-15b: GQA 6 on 8,
    squared ReLU, ungated MLP), each first held in fp32 against the CPU
    port on a depth cut of the same weights, then served in bf16 at full
    width and depth as ``launch.serve.serve`` runs it, with a profiled
    prefill and decode; (34) trained in bf16 at full width cut in depth
    (``DENSE_TRAIN_DEPTH``) as ``launch.train.train`` runs it; (35)
    qwen3-0.6b trained at full width through ``launch.train.main`` with
    checkpoints, killed by ``--fail-at-step``, restarted, and held bit for
    bit against an uninterrupted run: the final loss and every array of the
    last checkpoint (params, m, v, step).  The launch counts are zeroed
    before each path and read after it: K7 once a layer in a forward
    (twice in a train step: forward and recompute), K8/K9 once a layer in a
    backward.  Returns {"launches": {(phase, arch): launches}, "seconds":
    {phase: s}}."""
    import contextlib
    import gc
    import hashlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import main as train_main
    from repro_torch.launch.train import train
    from repro_torch.models.model_zoo import build
    from repro_torch.models.transformer import Transformer
    from repro_torch.runtime.ft import InjectedFailure
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step)

    def sync():
        torch.cuda.synchronize(dev)

    def flush():
        sync()
        torch.cuda.empty_cache()

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max())

    cfgs = {arch: dataclasses.replace(get_config(arch), attn_impl="flash")
            for arch in DENSE_ARCHS}

    def expect(n_layers, fwd=1, bwd=0):
        out = {"flash_fwd": fwd * n_layers, "flash_bwd_dq": bwd * n_layers,
               "flash_bwd_dkv": bwd * n_layers}
        return {k: v for k, v in out.items() if v}

    launches, seconds = {}, {}
    gc.collect()
    flush()
    # What earlier phases still hold (phase 34's nemotron step needs all
    # but about 9 GB of the card).
    held_GB = torch.cuda.memory_allocated(dev) / 1e9

    # -- 33. fp32 against the CPU, then bf16 serving at full depth ----------
    t0 = time.perf_counter()
    B33, S33, T33 = DENSE_SERVE
    for arch, cfg in cfgs.items():
        flush()
        small = dataclasses.replace(cfg, n_layers=DENSE_CPU_DEPTH)
        card = build(small, device=dev, dtype=torch.float32,
                     generator=torch.Generator(device=dev).manual_seed(2))
        Bc, Sc = DENSE_CPU
        tokens = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (Bc, Sc)), device=dev)
        _build.LAUNCHES.clear()
        h_card, _ = card.prefill(tokens, Sc)
        sync()
        check_launches = dict(_build.LAUNCHES)
        check(check_launches == expect(small.n_layers),
              f"{arch} fp32 prefill launched {check_launches}")
        cpu = Transformer(dataclasses.replace(small, attn_impl="xla"),
                          device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in
                             card.state_dict().items()})
        del card
        flush()
        with torch.no_grad():
            h_cpu, _ = cpu.prefill(tokens.cpu(), Sc)
        del cpu
        card_rel = rel(h_card.cpu(), h_cpu)
        fp32_check = {"n_layers": small.n_layers, "batch": Bc,
                      "prompt_len": Sc, "hidden_rel_err": card_rel,
                      "rtol": DENSE_CPU_RTOL[arch],
                      "launches": check_launches}
        check(bool(torch.isfinite(h_card).all())
              and card_rel <= DENSE_CPU_RTOL[arch],
              f"{arch} fp32 prefill hidden card vs CPU: {card_rel} of "
              f"max-abs")
        del h_card, h_cpu
        model = build(cfg, device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(0))
        n_params = sum(p.numel() for p in model.parameters())
        _build.LAUNCHES.clear()
        served = serve(cfg, batch=B33, prompt_len=S33, tokens=T33,
                       model=model)
        launches[(33, arch)] = dict(_build.LAUNCHES)  # warm-up and timed
        gen = served.pop("generated")
        check(served["prefill_launches"] == expect(cfg.n_layers)
              and not served["decode_launches"],
              f"{arch} bf16 serve launched {served['prefill_launches']}, "
              f"{served['decode_launches']}")
        check(launches[(33, arch)] == expect(cfg.n_layers, fwd=2),
              f"{arch} bf16 serve run launched {launches[(33, arch)]}")
        check(gen.shape == (B33, T33 + 1) and bool((gen >= 0).all())
              and bool((gen < cfg.vocab_size).all()),
              f"{arch} bf16 serve tokens")
        prompts = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B33, S33)), device=dev)
        prefill = make_prefill_step(model, S33 + T33 + 1)
        prof_prefill = device_profile(lambda: prefill({"tokens": prompts}),
                                      top=16, host=False)
        first, cache = prefill({"tokens": prompts})

        def decode_loop():
            tok = first
            for i in range(DENSE_PROFILE_TOKENS):
                tok, _ = make_decode_step(model, S33 + i)(tok, cache)

        prof_decode = device_profile(decode_loop, top=16, host=False)
        prof_decode["tokens"] = DENSE_PROFILE_TOKENS
        emit({"phase": 33, "parameters": n_params, **served,
              "launches_whole_run": launches[(33, arch)],
              "seq0": gen[0].tolist(), "fp32_card_vs_cpu": fp32_check,
              "profile_prefill": prof_prefill,
              "profile_decode": prof_decode})
        del model, cache, prefill, first, prompts
        flush()
    seconds[33] = time.perf_counter() - t0

    # -- 34. bf16 training at full width, cut in depth ------------------------
    t0 = time.perf_counter()
    B34, S34, T34 = DENSE_TRAIN
    for arch, cfg in cfgs.items():
        flush()
        cut = dataclasses.replace(cfg, n_layers=DENSE_TRAIN_DEPTH[arch])
        _build.LAUNCHES.clear()
        trained = train(cut, steps=T34, global_batch=B34, seq_len=S34,
                        device=dev, seed=0)
        launches[(34, arch)] = dict(_build.LAUNCHES)
        steps = trained.pop("steps")
        for rec in steps:
            check(rec["launches"] == expect(cut.n_layers, fwd=2, bwd=1),
                  f"{arch} bf16 train step {rec['step']} launched "
                  f"{rec['launches']}")
            check(all(math.isfinite(rec[k]) for k in ("loss", "nll",
                                                       "grad_norm")),
                  f"{arch} bf16 train step {rec['step']}: {rec}")
        timed = steps[1:]   # the first pays the allocator's growth
        ms = sum(r["ms"] for r in timed) / len(timed)
        emit({"phase": 34, **trained, "n_layers": cut.n_layers,
              "parameters": cut.param_count(), "steps": [
                  {k: r[k] for k in ("step", "loss", "nll", "grad_norm",
                                     "lr", "ms", "tokens_per_s",
                                     "launches")} for r in steps],
              "ms_per_step": ms, "tokens_per_s": B34 * S34 / (ms * 1e-3),
              "launches_whole_run": launches[(34, arch)]})
        flush()
    seconds[34] = time.perf_counter() - t0

    # -- 35. a restart on the card, bit for bit --------------------------------
    t0 = time.perf_counter()
    B35, S35, T35, every, fail_at = RESTART
    cfg = get_config(RESTART_ARCH)
    # The train state a checkpoint holds: fp32 params, m and v.
    state_bytes = 12 * cfg.param_count()
    base = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # Two directories of T35 // every checkpoints each, at most.
        need = 2 * (T35 // every) * state_bytes
        free = shutil.disk_usage(base).free
        check(free >= 1.1 * need, f"phase 35 needs {need / 1e9:.1f} GB of "
              f"disk for its checkpoints under {base}; {free / 1e9:.1f} GB "
              f"free")
        argv = ["--arch", RESTART_ARCH, "--global-batch", str(B35),
                "--seq-len", str(S35), "--steps", str(T35),
                "--checkpoint-every", str(every), "--log-every", "1"]
        runs = {}
        for name, sub, extra in (("killed", "a", ["--fail-at-step",
                                                  str(fail_at)]),
                                 ("restarted", "a", []),
                                 ("uninterrupted", "b", [])):
            flush()
            out, raised = io.StringIO(), None
            _build.LAUNCHES.clear()
            t_run = time.perf_counter()
            with contextlib.redirect_stdout(out):
                try:
                    rc = train_main(argv + ["--checkpoint-dir",
                                            os.path.join(base, sub)] + extra)
                except InjectedFailure as e:
                    rc, raised = None, str(e)
            lines = out.getvalue().splitlines()
            runs[name] = {
                "seconds": time.perf_counter() - t_run, "rc": rc,
                "raised": raised, "launches": dict(_build.LAUNCHES),
                "steps": [ln for ln in lines if ln.startswith("step ")],
                "checkpoints": [ln for ln in lines
                                if ln.startswith("checkpoint ")],
                "final_loss": [ln for ln in lines
                               if ln.startswith("final loss ")],
                "resumed": [ln for ln in lines if ln.startswith("resumed")]}
        n_layers = cfg.n_layers
        for name, n_steps in (("killed", fail_at), ("restarted",
                                                    T35 - every),
                              ("uninterrupted", T35)):
            check(runs[name]["launches"] == expect(n_layers, fwd=2 * n_steps,
                                                   bwd=n_steps),
                  f"phase 35 {name} run launched {runs[name]['launches']}")
        check(runs["killed"]["raised"] == f"injected failure at step "
              f"{fail_at}", f"phase 35: the killed run {runs['killed']}")
        check(runs["restarted"]["resumed"] and runs["restarted"]["resumed"][
            0].startswith(f"resumed from step {every} "),
              f"phase 35: the restart {runs['restarted']['resumed']}")
        check(runs["uninterrupted"]["rc"] == 0 and not runs["uninterrupted"][
            "resumed"], "phase 35: the uninterrupted run")
        final = [runs[n]["final_loss"] for n in ("restarted",
                                                 "uninterrupted")]
        check(final[0] == final[1] != [], f"phase 35 final losses {final}")
        last = f"ckpt_{T35:08d}.npz"
        differ, n_arrays = [], 0
        with np.load(os.path.join(base, "a", last)) as za, np.load(
                os.path.join(base, "b", last)) as zb:
            check(sorted(za.files) == sorted(zb.files),
                  "phase 35: the last checkpoints' keys differ")
            h = {"a": hashlib.sha256(), "b": hashlib.sha256()}
            for key in sorted(za.files):
                xa, xb = za[key], zb[key]
                n_arrays += 1
                if not np.array_equal(xa, xb):
                    differ.append(key)
                if key.startswith("params/"):
                    h["a"].update(xa.tobytes())
                    h["b"].update(xb.tobytes())
            digests = {k: v.hexdigest() for k, v in h.items()}
        check(not differ and digests["a"] == digests["b"],
              f"phase 35: {len(differ)} arrays of the restarted run's last "
              f"checkpoint differ from the uninterrupted run's: "
              f"{differ[:8]}")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    seconds[35] = time.perf_counter() - t0
    for name in runs:
        launches[(35, name)] = runs[name]["launches"]
    emit({"phase": 35, "arch": RESTART_ARCH, "batch": B35, "seq_len": S35,
          "steps": T35, "checkpoint_every": every, "fail_at_step": fail_at,
          "state_GB": state_bytes / 1e9, "disk_free_GB": free / 1e9,
          "runs": runs, "arrays_compared": n_arrays,
          "params_sha256": digests["a"], "final_loss": final[0],
          "bit_equal": True, "seconds": seconds[35]})
    emit({"dense_ft_seconds": seconds, "held_GB_at_start": held_GB})
    return {"launches": launches, "seconds": seconds}


def lm_distribution_phase(dev, flash_case, bwd_case, graph_ms, time_ms,
                          device_profile):
    """Phase 37, LM distribution on a ``DIST_MESH`` ("data", "model")
    mesh with every shard on ``dev``, through the port's sharded entry
    points (``Sharder`` of ``parallel/sharding.py``; ``make_train_step``,
    ``make_prefill_step``, ``make_decode_step``, ``launch.serve.serve``
    and ``launch.train.train`` with ``sharder=``):

    (k) first K7, K8 and K9 at every shard shape the paths below launch,
    held against their plain versions (``flash_case``/``bwd_case`` of
    phases 12 and 16): a tp shard of qwen3-0.6b (4 q heads on their 2 kv
    heads, batch 2) in bf16 and fp32, of glm4-9b (8 q heads on one kv
    head), the sp shards of phi3-medium-14b (512 queries on 2048 keys at
    offsets 0, 512, 1024 and 1536: the first causal launches with
    kv_offset > 0 and Sq != Skv on a path), and a pipeline microbatch of
    qwen3-0.6b (batch 1, fp32); then their times (``k7_timing``,
    ``k89_timing``, SDPA with a boolean mask at an offset);
    (a) qwen3-0.6b, tp, full width and depth: fp32 prefill logits, two
    decode steps and a train step's loss and grads, sharded and unsharded,
    each held to DIST_X times the unsharded run's distance from float64;
    then bf16 served sharded and unsharded through ``serve`` (4 x 2048,
    16 tokens) and trained one step each through ``train``, timed, and
    the sharded prefill, decode and step profiled;
    (b) glm4-9b, tp, full depth, bf16: prefill and 8 decode steps at
    max_len 2112, the kv_seq-sharded cache's logits held to the unsharded
    decode's (bound from an fp32 run of the same weights);
    (c) phi3-medium-14b, sp: the bf16 prefill at full depth, and the bf16
    loss and grads of 4 layers, each held to the unsharded run (bounds
    from fp32 runs), then one sharded train step timed;
    (d) qwen3-0.6b through ``gpipe``: 4 stages of 7 layers, 4
    microbatches, fp32 loss and grads against the unpipelined step.

    Launch counts are zeroed before each path and read after it.  Returns
    {"launches": {label: counts}, "timings": {label: rows}, "seconds"}."""
    import functools
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataConfig, token_batch
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
    from repro_torch.models.model_zoo import build
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import Transformer, mask_pad_logits
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.halo import make_mesh
    from repro_torch.parallel.sharding import Sharded, Sharder
    from repro_torch.train.train_step import (init_train_state, loss_fn,
                                              make_train_step,
                                              pipelined_loss_fn,
                                              value_and_grad)

    t_start = time.perf_counter()

    def sync():
        torch.cuda.synchronize(dev)

    def flush():
        gc.collect()
        sync()
        torch.cuda.empty_cache()

    rel, worst, l2rel, widened = dist_rel, dist_worst, dist_l2rel, widened64

    def ms_of(fn):
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def expect(n, fwd=1, bwd=0):
        out = {"flash_fwd": fwd * n, "flash_bwd_dq": bwd * n,
               "flash_bwd_dkv": bwd * n}
        return {k: v for k, v in out.items() if v}

    def held_GB():
        return (torch.cuda.memory_allocated(dev) / 1e9
                if dev.type == "cuda" else 0.0)

    def counted(fn):
        """(fn(), the kernel launches it made)."""
        _build.LAUNCHES.clear()
        out = fn()
        sync()
        return out, dict(_build.LAUNCHES)

    mesh = make_mesh(DIST_MESH, ("data", "model"))
    check(all(d.type == dev.type and (d.index or 0) == 0
              for d in mesh.devices),
          f"phase 37: shards off {dev.type}:0: {mesh.devices}")
    n_shards = mesh.size
    Dd, Mm = DIST_MESH
    cfgs = {a: dataclasses.replace(get_config(a), attn_impl="flash")
            for a in (DIST_ARCH, "glm4-9b", "phi3-medium-14b")}
    qc, gc_, pc = (cfgs[a] for a in (DIST_ARCH, "glm4-9b",
                                     "phi3-medium-14b"))
    B, S, T = DIST_SERVE
    Bg, Sg, Tg, Lg = DIST_GLM
    Bp, Sp = DIST_PHI
    n_st, n_mb, B_pipe, S_pipe = DIST_PIPE
    launches, timings, seconds, out = {}, {}, {}, {}
    bf16, f32 = torch.bfloat16, torch.float32

    # -- (k) the shard shapes' kernels against their plain versions --------
    t0 = time.perf_counter()

    def shard_shape(cfg, batch, q_len, kv_len, heads_split):
        H, KV = cfg.n_heads, cfg.n_kv_heads
        if heads_split:
            H_l, G = H // Mm, H // KV
            KV = H_l // G if H_l % G == 0 else 1
            H = H_l
        return (batch // Dd, q_len, kv_len, H, KV, cfg.head_dim)

    shapes = {
        "qwen3-0.6b unsharded": (B, S, S, qc.n_heads, qc.n_kv_heads,
                                 qc.head_dim),
        "tp qwen3-0.6b shard": shard_shape(qc, B, S, S, True),
        "tp glm4-9b shard": shard_shape(gc_, Bg, Sg, Sg, True),
        "sp phi3-medium-14b shard": shard_shape(pc, Bp, Sp // Mm, Sp, False),
        "phi3-medium-14b unsharded": (Bp, Sp, Sp, pc.n_heads, pc.n_kv_heads,
                                      pc.head_dim),
        "glm4-9b unsharded": (Bg, Sg, Sg, gc_.n_heads, gc_.n_kv_heads,
                              gc_.head_dim),
        "gpipe qwen3-0.6b microbatch": (B_pipe // n_mb, S_pipe, S_pipe,
                                        qc.n_heads, qc.n_kv_heads,
                                        qc.head_dim)}
    offsets = [m * (Sp // Mm) for m in range(Mm)]
    gk = torch.Generator(device=dev).manual_seed(37)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gk, device=dev).to(dtype)

    def hold(label, dtype, kv_offset=0, backward=True):
        Bx, Sq, Skv, Hx, KVx, hd = shapes[label]
        name = f"{label} off{kv_offset}" if kv_offset else label
        flash_case(name, shapes[label], dtype, kv_offset=kv_offset,
                   blocks=(512, 512))
        if backward:
            bwd_case(name, rand(Bx, Sq, Hx, hd, dtype=dtype),
                     rand(Bx, Skv, KVx, hd, dtype=dtype),
                     rand(Bx, Skv, KVx, hd, dtype=dtype),
                     rand(Bx, Sq, Hx, hd, dtype=dtype), causal=True,
                     kv_offset=kv_offset, flips=dtype == bf16)
        flush()

    for dtype in (bf16, f32):
        hold("tp qwen3-0.6b shard", dtype)
    hold("qwen3-0.6b unsharded", f32)     # (a)'s and (d)'s fp32 reference
    for dtype in (bf16, f32):
        hold("tp glm4-9b shard", dtype, backward=False)
        for off in offsets:
            hold("sp phi3-medium-14b shard", dtype, kv_offset=off)
    hold("glm4-9b unsharded", f32, backward=False)  # (b)'s fp32 reference
    hold("gpipe qwen3-0.6b microbatch", f32)
    hold("phi3-medium-14b unsharded", f32)   # (c)'s fp32 reference step
    gt = torch.Generator(device=dev).manual_seed(38)

    def times(label, dtype, kv_offset=0, backward=True):
        row = {"k7": k7_timing(shapes[label], True, dev, gt, graph_ms,
                               time_ms, kv_offset=kv_offset, dtype=dtype)}
        if backward:
            row["k89"] = k89_timing(shapes[label], True, dev, gt, graph_ms,
                                    time_ms, kv_offset=kv_offset,
                                    dtype=dtype)
        flush()
        return row

    timings["tp qwen3-0.6b shard bfloat16"] = times("tp qwen3-0.6b shard",
                                                    bf16)
    timings["tp qwen3-0.6b shard float32"] = times("tp qwen3-0.6b shard",
                                                   f32)
    for dtype in (bf16, f32):
        key = str(dtype).split(".")[1]
        timings[f"tp glm4-9b shard {key}"] = times("tp glm4-9b shard", dtype,
                                                   backward=False)
        timings[f"sp phi3-medium-14b shard {key}"] = [
            times("sp phi3-medium-14b shard", dtype, kv_offset=o)
            for o in offsets]
    timings["gpipe qwen3-0.6b microbatch float32"] = times(
        "gpipe qwen3-0.6b microbatch", f32)
    seconds["kernels"] = time.perf_counter() - t0

    # -- (a) qwen3-0.6b, tp: fp32 against float64, then bf16 timed ---------
    t0 = time.perf_counter()
    seconds["held_GB_a"] = held_GB()
    tp = Sharder(mesh, qc.sharding_profile)
    check(tp.profile == "tp", f"{qc.arch} runs {tp.profile}")
    rng = np.random.default_rng(37)
    prompts = torch.as_tensor(rng.integers(0, qc.vocab_size, (B, S)),
                              device=dev)
    fed = torch.as_tensor(rng.integers(0, qc.vocab_size,
                                       (DIST_FP32_DECODE, B)), device=dev)
    batch = token_batch(DataConfig(qc.vocab_size, S, B), 0, device=dev)

    @torch.no_grad()
    def fp32_last_logits(model, toks):
        """The last position's logits of an fp32 forward on a bf16 model's
        weights, one layer converted to fp32 at a time (and back: exact),
        attention plain PyTorch: the reference where an fp32 copy of the
        whole model would not fit beside it."""
        cfg32 = dataclasses.replace(model.cfg, attn_impl="xla")
        x = model.embed[toks].float()
        pos = model._default_positions(toks)
        for block in model.layers:
            block.float()
            block.attn.cfg = cfg32
            x, _, _ = block(x, pos)
            block.attn.cfg = model.cfg
            block.to(bf16)
        h = rms_norm(x[:, -1], model.final_norm.float(), model.cfg.norm_eps)
        return mask_pad_logits(torch.nn.functional.linear(
            h, model.lm_head.float()), model.cfg)

    @torch.no_grad()
    def logits_run(model, sharder, toks, fed_tokens, max_len):
        """Prefill logits and the decode steps' on ``fed_tokens``, each
        gathered (B, V) fp32."""
        run = model.sharded(sharder)
        kw = {} if run is None else {"sharder": sharder}
        last, cache = model.prefill(toks, max_len, **kw)
        if run is None:
            outs = [mask_pad_logits(model.logits(last), model.cfg)]
        else:
            outs = [run.logits(last.pieces, last.spec[0]).gather()]
            check(isinstance(cache["k"], Sharded), "a sharded cache")
        for i, tok in enumerate(fed_tokens):
            lg, cache = model.decode_step(tok, cache, toks.shape[1] + i,
                                          **kw)
            outs.append(lg.gather() if isinstance(lg, Sharded) else lg)
        spec = tuple(cache["k"].spec) if run is not None else None
        return [o.float() for o in outs], spec

    m32 = build(qc, device=dev, dtype=f32,
                generator=torch.Generator(device=dev).manual_seed(0))
    params32 = {n: p.detach() for n, p in m32.named_parameters()}
    max_a = S + 2 * DIST_FP32_DECODE     # model 4 divides it: a sharded cache
    (lu, _), l_u = counted(lambda: logits_run(m32, None, prompts, fed,
                                              max_a))
    (ls, aspec), l_s = counted(lambda: logits_run(m32, tp, prompts, fed,
                                                  max_a))
    check(l_u == expect(qc.n_layers) and l_s == expect(
        qc.n_layers * n_shards), f"(a) fp32 serve launched {l_u}, {l_s}")
    (loss_u, _, g_u), step_u = counted(lambda: value_and_grad(
        m32, params32, batch))
    (loss_s, _, g_s), step_s = counted(lambda: value_and_grad(
        m32, params32, batch, functools.partial(loss_fn, sharder=tp)))
    check(step_u == expect(qc.n_layers, 2, 1) and step_s == expect(
        qc.n_layers * n_shards, 2, 1),
        f"(a) fp32 train steps launched {step_u}, {step_s}")
    launches["a fp32"] = {"serve": l_s, "step": step_s}
    m64 = Transformer(dataclasses.replace(qc, attn_impl="xla"), device=dev,
                      dtype=torch.float64)
    m64.load_state_dict(m32.state_dict())
    with widened():
        l64, _ = logits_run(m64, None, prompts, fed, max_a)
        loss64, _, g64 = value_and_grad(
            m64, {n: p.detach() for n, p in m64.named_parameters()}, batch)
    del m64
    flush()
    fp32 = {"logits": [], "cache_spec": aspec}
    for i, (a_, u_, r_) in enumerate(zip(ls, lu, l64)):
        d_u, d_s = rel(u_, r_), rel(a_, u_)
        fp32["logits"].append({"step": i, "unsharded_vs_f64": d_u,
                               "sharded_vs_unsharded": d_s,
                               "sharded_vs_f64": rel(a_, r_)})
        check(d_s <= DIST_X * d_u, f"(a) fp32 logits step {i}: sharded "
              f"{d_s} from unsharded, past {DIST_X} x {d_u}")
    d_u = abs(float(loss_u) / float(loss64) - 1)
    d_s = abs(float(loss_s) / float(loss_u) - 1)
    gd_u, gd_s = worst(g_u, g64), worst(g_s, g_u)
    fp32.update(loss_unsharded_vs_f64=d_u, loss_sharded_vs_unsharded=d_s,
                grads_unsharded_vs_f64=gd_u, grads_sharded_vs_unsharded=gd_s,
                loss=float(loss_s))
    check(d_s <= DIST_X * d_u, f"(a) fp32 loss: {d_s} past {DIST_X} x {d_u}")
    check(gd_s <= DIST_X * gd_u,
          f"(a) fp32 grads: {gd_s} past {DIST_X} x {gd_u}")
    out["a_fp32"] = fp32
    del m32, params32, g_u, g_s, g64, lu, ls, l64
    flush()

    model = build(qc, device=dev, dtype=bf16,
                  generator=torch.Generator(device=dev).manual_seed(0))
    served = {}
    for tag, sharder in (("unsharded", None), ("sharded", tp)):
        r = serve(qc, batch=B, prompt_len=S, tokens=T, model=model,
                  sharder=sharder or Sharder(make_mesh((1, 1), devices=dev),
                                             "tp"))
        served[tag] = r
    check(served["sharded"]["prefill_launches"] == expect(
        qc.n_layers * n_shards) and not served["sharded"]["decode_launches"],
        f"(a) bf16 sharded serve launched "
        f"{served['sharded']['prefill_launches']}")
    gen_u, gen_s = (served[t].pop("generated") for t in ("unsharded",
                                                         "sharded"))
    check(gen_s.shape == (B, T + 1) and bool((gen_s >= 0).all())
          and bool((gen_s < qc.vocab_size).all()), "(a) bf16 tokens")
    launches["a bf16 serve"] = served["sharded"]["prefill_launches"]
    pre = functools.partial(model.prefill, prompts, S + T + 1, sharder=tp)
    prof = {"prefill": device_profile(pre, top=8, host=False)}
    _, cache = pre()
    first = torch.zeros(B, dtype=torch.long, device=dev)
    prof["decode"] = device_profile(
        lambda: model.decode_step(first, cache, S, sharder=tp), top=8,
        host=False)
    del model, cache
    flush()
    trained = {}
    for tag, sharder in (("unsharded", Sharder(make_mesh((1, 1),
                                                         devices=dev),
                                               "tp")), ("sharded", tp)):
        r = train(qc, steps=2, global_batch=B, seq_len=S, device=dev,
                  seed=0, sharder=sharder)
        trained[tag] = {"ms": [x["ms"] for x in r["steps"]],
                        "loss": [x["loss"] for x in r["steps"]],
                        "grad_norm": [x["grad_norm"] for x in r["steps"]],
                        "launches": r["steps"][-1]["launches"],
                        "peak_memory_GB": r.get("peak_memory_GB"),
                        "mesh": r["mesh"]}
        flush()
    check(trained["sharded"]["launches"] == expect(
        qc.n_layers * n_shards, 2, 1),
        f"(a) bf16 sharded step launched {trained['sharded']['launches']}")
    check(all(math.isfinite(x) for t_ in trained.values()
              for x in t_["loss"] + t_["grad_norm"]), "(a) bf16 steps")
    launches["a bf16 step"] = trained["sharded"]["launches"]
    out["a_bf16"] = {
        "serve": served, "train": trained,
        "tokens_agree": float((gen_u == gen_s).float().mean()),
        "prefill_host_x": served["sharded"]["prefill_ms"]
        / served["unsharded"]["prefill_ms"],
        "decode_host_x": served["sharded"]["decode_ms_per_token"]
        / served["unsharded"]["decode_ms_per_token"],
        "step_host_x": trained["sharded"]["ms"][-1]
        / trained["unsharded"]["ms"][-1],
        "profile": prof}
    seconds["a"] = time.perf_counter() - t0

    # -- (b) glm4-9b, tp, full depth: the kv_seq-sharded cache ---------------
    t0 = time.perf_counter()
    seconds["held_GB_b"] = held_GB()
    gsh = Sharder(mesh, gc_.sharding_profile)
    rng = np.random.default_rng(38)
    gprompts = torch.as_tensor(rng.integers(0, gc_.vocab_size, (Bg, Sg)),
                               device=dev)
    gfed = torch.as_tensor(rng.integers(0, gc_.vocab_size, (Tg, Bg)),
                           device=dev)
    model = build(gc_, device=dev, dtype=bf16,
                  generator=torch.Generator(device=dev).manual_seed(0))
    ((lu, _), ms_u) = ms_of(lambda: logits_run(model, None, gprompts, gfed,
                                               Lg))
    _build.LAUNCHES.clear()
    ((lsh, gspec), ms_s) = ms_of(lambda: logits_run(model, gsh, gprompts,
                                                    gfed, Lg))
    launches["b"] = dict(_build.LAUNCHES)
    check(launches["b"] == expect(gc_.n_layers * n_shards),
          f"(b) sharded prefill and decode launched {launches['b']}")
    check(gspec == (None, "data", "model", None, None),
          f"(b) the cache's spec {gspec}")
    m32 = Transformer(dataclasses.replace(gc_, attn_impl="xla"), device=dev,
                      dtype=f32)
    m32.load_state_dict(model.state_dict())
    del model
    flush()
    l32, _ = logits_run(m32, None, gprompts, gfed, Lg)
    del m32
    flush()
    glm = {"max_len": Lg, "cache_spec": gspec, "bf16": [],
           "ms_unsharded": ms_u, "ms_sharded": ms_s}
    for i, (a_, u_, r_) in enumerate(zip(lsh, lu, l32)):
        d_s, d_u = rel(a_, r_), rel(u_, r_)
        glm["bf16"].append({"step": i, "sharded_vs_unsharded": rel(a_, u_),
                            "unsharded_vs_fp32": d_u, "sharded_vs_fp32": d_s})
        check(d_s <= DIST_BF16_RATIO * d_u, f"(b) glm4 bf16 logits step "
              f"{i}: {d_s} from fp32, the unsharded run {d_u}")
    del lu, lsh, l32
    # fp32 at DIST_CUT layers: sharded within DIST_X times the unsharded
    # run's distance from float64.
    cut = dataclasses.replace(gc_, n_layers=DIST_CUT)
    m32 = build(cut, device=dev, dtype=f32,
                generator=torch.Generator(device=dev).manual_seed(0))
    lu, _ = logits_run(m32, None, gprompts, gfed, Lg)
    (lsh, _), launches["b fp32"] = counted(lambda: logits_run(
        m32, gsh, gprompts, gfed, Lg))
    check(launches["b fp32"] == expect(cut.n_layers * n_shards),
          f"(b) fp32 sharded run launched {launches['b fp32']}")
    m64 = Transformer(dataclasses.replace(cut, attn_impl="xla"), device=dev,
                      dtype=torch.float64)
    m64.load_state_dict(m32.state_dict())
    del m32
    with widened():
        l64, _ = logits_run(m64, None, gprompts, gfed, Lg)
    del m64
    flush()
    glm["fp32"] = []
    for i, (a_, u_, r_) in enumerate(zip(lsh, lu, l64)):
        d_s, d_u = rel(a_, u_), rel(u_, r_)
        glm["fp32"].append({"step": i, "n_layers": DIST_CUT,
                            "sharded_vs_unsharded": d_s,
                            "unsharded_vs_f64": d_u})
        check(d_s <= DIST_X * d_u, f"(b) glm4 fp32 logits step {i}: {d_s} "
              f"past {DIST_X} x {d_u}")
    out["b"] = glm
    del lu, lsh, l64
    seconds["b"] = time.perf_counter() - t0

    # -- (c) phi3-medium-14b, sp: prefill at full depth, 4-layer step ---------
    t0 = time.perf_counter()
    seconds["held_GB_c"] = held_GB()
    sp = Sharder(mesh, pc.sharding_profile)
    check(sp.profile == "sp", f"{pc.arch} runs {sp.profile}")
    rng = np.random.default_rng(39)
    pprompts = torch.as_tensor(rng.integers(0, pc.vocab_size, (Bp, Sp)),
                               device=dev)
    model = build(pc, device=dev, dtype=bf16,
                  generator=torch.Generator(device=dev).manual_seed(0))
    none = torch.zeros(0, Bp, dtype=torch.long, device=dev)
    ((lu, _), ms_u) = ms_of(lambda: logits_run(model, None, pprompts, none,
                                               Sp))
    _build.LAUNCHES.clear()
    ((lsh, pspec), ms_s) = ms_of(lambda: logits_run(model, sp, pprompts,
                                                    none, Sp))
    launches["c prefill"] = dict(_build.LAUNCHES)
    check(launches["c prefill"] == expect(pc.n_layers * n_shards),
          f"(c) sp prefill launched {launches['c prefill']}")
    l32 = fp32_last_logits(model, pprompts)
    del model
    flush()
    phi = {"prefill": {"sharded_vs_unsharded": rel(lsh[0], lu[0]),
                       "unsharded_vs_fp32": rel(lu[0], l32),
                       "sharded_vs_fp32": rel(lsh[0], l32),
                       "ms_unsharded": ms_u, "ms_sharded": ms_s,
                       "cache_spec": pspec}}
    check(phi["prefill"]["sharded_vs_fp32"] <= DIST_BF16_RATIO
          * phi["prefill"]["unsharded_vs_fp32"],
          f"(c) phi3 bf16 prefill logits: {phi['prefill']}")
    del lu, lsh, l32
    cut = dataclasses.replace(pc, n_layers=DIST_PHI_DEPTH)
    master = build(cut, device=dev, dtype=f32,
                   generator=torch.Generator(device=dev).manual_seed(0))
    params = {n: p.detach() for n, p in master.named_parameters()}
    pbatch = token_batch(DataConfig(cut.vocab_size, Sp, Bp), 0, device=dev)
    sp_loss = functools.partial(loss_fn, sharder=sp)
    # fp32 (the masters compute): sharded within DIST_X times the unsharded
    # run's distance from float64 (per layer remat there: the float64
    # activations of 4 layers would not fit).
    loss_u, _, g_u = value_and_grad(master, params, pbatch)
    (loss_s, _, g_s), launches["c fp32 step"] = counted(
        lambda: value_and_grad(master, params, pbatch, sp_loss))
    check(launches["c fp32 step"] == expect(cut.n_layers * n_shards, 2, 1),
          f"(c) fp32 sp step launched {launches['c fp32 step']}")
    fp32 = {"n_layers": cut.n_layers,
            "loss_sharded_vs_unsharded": abs(float(loss_s) / float(loss_u)
                                             - 1),
            "grads_sharded_vs_unsharded": worst(g_s, g_u),
            "grads_l2_sharded_vs_unsharded": l2rel(g_s, g_u)}
    del g_s
    m64 = Transformer(dataclasses.replace(cut, attn_impl="xla",
                                          remat_group=1),
                      device=dev, dtype=torch.float64)
    m64.load_state_dict(master.state_dict())
    loss64 = 0.0
    with widened():
        # A row at a time, its gradient added into .grad (the float64
        # activations of 4 rows and a second float64 copy of the grads
        # would not fit): the loss is the mean of the rows' means.
        for r in range(Bp):
            row = {k: v[r:r + 1] for k, v in pbatch.items()}
            part, _ = loss_fn(m64, row)
            (part / Bp).backward()
            loss64 += float(part) / Bp
            del part
    g64 = {n: p.grad for n, p in m64.named_parameters()}
    del m64
    fp32.update(loss_unsharded_vs_f64=abs(float(loss_u) / float(loss64) - 1),
                grads_unsharded_vs_f64=worst(g_u, g64),
                grads_l2_unsharded_vs_f64=l2rel(g_u, g64))
    del g64
    check(fp32["loss_sharded_vs_unsharded"]
          <= DIST_X * fp32["loss_unsharded_vs_f64"]
          and fp32["grads_sharded_vs_unsharded"]
          <= DIST_X * fp32["grads_unsharded_vs_f64"],
          f"(c) phi3 fp32 loss and grads: {fp32}")
    phi["train_fp32"] = fp32
    # bf16 compute off the fp32 masters: the sharded loss within DIST_X
    # times the unsharded's distance from fp32, the grads no farther from
    # fp32 (over every leaf) than DIST_BF16_RATIO times the unsharded's.
    compute = type(master)(cut, device=dev, dtype=bf16)
    (lb_u, _, gb_u) = value_and_grad(compute, params, pbatch)
    (lb_s, _, gb_s), l_c = counted(lambda: value_and_grad(
        compute, params, pbatch, sp_loss))
    check(l_c == expect(cut.n_layers * n_shards, 2, 1),
          f"(c) sp train step launched {l_c}")
    del compute, params
    bf = {"loss": float(lb_s),
          "loss_sharded_vs_unsharded": abs(float(lb_s) / float(lb_u) - 1),
          "loss_unsharded_vs_fp32": abs(float(lb_u) / float(loss_u) - 1),
          "grads_sharded_vs_unsharded": l2rel(gb_s, gb_u),
          "grads_unsharded_vs_fp32": l2rel(gb_u, g_u),
          "grads_sharded_vs_fp32": l2rel(gb_s, g_u)}
    check(bf["loss_sharded_vs_unsharded"]
          <= DIST_X * bf["loss_unsharded_vs_fp32"]
          and bf["grads_sharded_vs_fp32"]
          <= DIST_BF16_RATIO * bf["grads_unsharded_vs_fp32"],
          f"(c) phi3 bf16 loss and grads: {bf}")
    del g_u, gb_u, gb_s
    flush()
    state = init_train_state(master)
    step = make_train_step(master, AdamWConfig(), sharder=sp)
    bf["step_ms"] = []
    for _ in range(2):     # the first pays the allocator's growth
        ((state, met), l_step), ms_step = ms_of(lambda: counted(
            lambda: step(state, pbatch)))
        bf["step_ms"].append(ms_step)
        check(l_step == l_c and all(math.isfinite(float(met[k]))
                                    for k in ("loss", "grad_norm")),
              f"(c) sp train step {met}, launched {l_step}")
    launches["c step"] = l_step
    phi["train_bf16"] = bf
    out["c"] = phi
    del master, state, step
    flush()
    seconds["c"] = time.perf_counter() - t0

    # -- (d) qwen3-0.6b through gpipe: 4 stages of 7 layers ----------------
    t0 = time.perf_counter()
    seconds["held_GB_d"] = held_GB()
    stage_mesh = make_mesh((n_st,), ("stage",))
    m32 = build(qc, device=dev, dtype=f32,
                generator=torch.Generator(device=dev).manual_seed(0))
    params32 = {n: p.detach() for n, p in m32.named_parameters()}
    dbatch = token_batch(DataConfig(qc.vocab_size, S_pipe, B_pipe), 0,
                         device=dev)
    ((loss_u, _, g_u), l_u), ms_u = ms_of(lambda: counted(
        lambda: value_and_grad(m32, params32, dbatch, functools.partial(
            loss_fn, remat=False))))
    ((loss_p, _, g_p), l_p), ms_p = ms_of(lambda: counted(
        lambda: value_and_grad(m32, params32, dbatch, functools.partial(
            pipelined_loss_fn, mesh=stage_mesh, n_microbatches=n_mb))))
    check(l_u == expect(qc.n_layers, 1, 1)
          and l_p == expect(qc.n_layers * n_mb, 1, 1),
          f"(d) launches unpipelined {l_u}, pipelined {l_p}")
    pipe = {"stages": n_st, "layers_a_stage": qc.n_layers // n_st,
            "microbatches": n_mb, "loss": float(loss_p),
            "loss_rel": abs(float(loss_p) / float(loss_u) - 1),
            "grads_rel": worst(g_p, g_u), "ms_unpipelined": ms_u,
            "ms_pipelined": ms_p, "bounds": DIST_PIPE_RTOL}
    check(pipe["loss_rel"] <= DIST_PIPE_RTOL[0]
          and pipe["grads_rel"] <= DIST_PIPE_RTOL[1],
          f"(d) pipelined against unpipelined: {pipe}")
    launches["d"] = l_p
    out["d"] = pipe
    del m32, params32, g_u, g_p
    flush()
    seconds["d"] = time.perf_counter() - t0
    seconds["total"] = time.perf_counter() - t_start
    emit({"phase": 37, "mesh": dict(zip(mesh.axis_names, mesh.shape)),
          "shard_devices": sorted({str(d) for d in mesh.devices}),
          "shapes": {k: list(v) for k, v in shapes.items()},
          "sp_kv_offsets": offsets, **out, "launches": launches,
          "kernel_times": timings, "seconds": seconds})
    return {"launches": launches, "timings": timings, "seconds": seconds,
            "shapes": shapes, "offsets": offsets}


def dist_rel(a, b):
    """max |a - b| / max |b| (phases 37-38)."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def dist_worst(run, ref):
    """The largest per-leaf max-abs-relative distance of two grads."""
    return max(dist_rel(run[n], g) for n, g in ref.items())


def dist_l2rel(run, ref):
    """||run - ref|| / ||ref|| over every leaf of two grads."""
    num = sum(float((run[n].double() - g.double()).square().sum())
              for n, g in ref.items())
    return (num / sum(float(g.double().square().sum())
                      for g in ref.values())) ** 0.5


@contextlib.contextmanager
def widened64():
    """The port's fp32 points (``.float()``: norms, softmax, rope, the LM
    head) as float64, for a float64 reference run."""
    import torch
    orig = torch.Tensor.float
    torch.Tensor.float = lambda self: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = orig


def dist_kernel_rows(dist, entry, case_err):
    """The kernels line's K7-K9 rows at phase 37's shard shapes."""
    dl = dist["launches"]
    dist_paths = {   # row -> (dtype, K7's path launches, the step's)
        "tp qwen3-0.6b shard": {
            "bfloat16": (dl["a bf16 serve"], dl["a bf16 step"]),
            "float32": (dl["a fp32"]["serve"], dl["a fp32"]["step"])},
        "tp glm4-9b shard": {"bfloat16": (dl["b"], {}),
                             "float32": (dl["b fp32"], {})},
        "sp phi3-medium-14b shard": {
            "bfloat16": (dl["c prefill"], dl["c step"]),
            "float32": (dl["c fp32 step"], dl["c fp32 step"])},
        "gpipe qwen3-0.6b microbatch": {"float32": (dl["d"], dl["d"])}}
    dist_case = {
        "tp qwen3-0.6b shard": "a tp shard of qwen3-0.6b on a 2x4 mesh (4 "
                               "query heads on their 2 kv heads, batch 2)",
        "tp glm4-9b shard": "a tp shard of glm4-9b on a 2x4 mesh (8 query "
                            "heads on one kv head, batch 2)",
        "sp phi3-medium-14b shard": "the sp shards of phi3-medium-14b on a "
                                    "2x4 mesh (512 queries on 2048 keys, "
                                    "one launch at each kv_offset)",
        "gpipe qwen3-0.6b microbatch": "a gpipe microbatch of qwen3-0.6b "
                                       "(batch 1, 4 stages of 7 layers)"}
    return shard_kernel_rows(dist["timings"], dist_paths, dist_case, 37,
                             entry, case_err)


def shard_kernel_rows(timings, paths, cases, phase, entry, case_err):
    """The kernels line's K7-K9 rows at a distribution phase's shard
    shapes: times from ``timings`` ({"<label> <dtype>": a row or a list
    of rows, one a kv_offset}: ``k7_timing``'s and ``k89_timing``'s,
    summed over the offsets of a sequence shard), launches from the path
    that ran each shape (``paths``: {label: {dtype: (K7's path launches,
    the train step's)}}), errors from the plain-version holds; ``cases``
    describes each label, ``entry`` is main's row maker."""
    kernels = []
    for label, by_dtype in paths.items():
        for dtype, (serve_l, train_l) in by_dtype.items():
            rows_t = timings[f"{label} {dtype}"]
            rows_t = rows_t if isinstance(rows_t, list) else [rows_t]
            offs = [r["k7"]["kv_offset"] for r in rows_t]
            causal = rows_t[0]["k7"]["causal"]
            names = [f"{label} off{o}" if o else label for o in offs]

            def total(part, key):
                return sum(r[part][key] for r in rows_t)

            peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_FP32_FLOPS
            gqa = rows_t[0]["k7"]["shape"][3] != rows_t[0]["k7"]["shape"][4]
            rows = {"shape": rows_t[0]["k7"]["shape"], "causal": causal,
                    "dtype": dtype, "case": cases[label],
                    "kv_offsets": offs, "plain_timing": "eager",
                    "phase": phase, "library": (
                        "F.scaled_dot_product_attention ("
                        + ("enable_gqa" if gqa else "MHA")
                        + ("; a boolean mask at each offset)" if any(offs)
                           else ")"))}
            if len(offs) > 1:
                rows["times_note"] = ("ms, bytes and operations summed over "
                                      "one launch at each offset")
            bwd_library = "backward of " + rows["library"] + (
                " (dq, dk and dv together)")
            kernels.append(entry(
                "flash_fwd", "src/repro_torch/csrc/flash_attention_sm90.cu"
                if dtype == "bfloat16" else
                "src/repro_torch/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention_bwd.py:86",
                total("k7", "k7_ms"), total("k7", "plain_ms"),
                total("k7", "bytes"), total("k7", "operations"),
                total("k7", "sdpa_ms"),
                {**rows, "train_launches": train_l.get("flash_fwd", 0),
                 "max_abs_err": max(case_err[("flash_fwd", n, dtype)]
                                    for n in names)},
                serve_l, peak))
            if "k89" not in rows_t[0]:
                continue
            src = ("src/repro_torch/csrc/flash_attention_bwd_sm90.cu"
                   if dtype == "bfloat16" else
                   "src/repro_torch/csrc/flash_attention_bwd.cu")
            kernels += [
                entry("flash_bwd_dq", src,
                      "src/repro/kernels/flash_attention_bwd.py:223",
                      total("k89", "k8_ms"), total("k89", "k8_plain_ms"),
                      total("k89", "k8_bytes"),
                      total("k89", "k8_operations"),
                      total("k89", "sdpa_bwd_ms"),
                      {**rows, "library": bwd_library,
                       "max_abs_err": max(case_err[("flash_bwd_dq", n,
                                                    dtype)] for n in names)},
                      train_l, peak),
                entry("flash_bwd_dkv", src,
                      "src/repro/kernels/flash_attention_bwd.py:249",
                      total("k89", "k9_ms"), total("k89", "k9_plain_ms"),
                      total("k89", "k9_bytes"),
                      total("k89", "k9_operations"),
                      total("k89", "sdpa_bwd_ms"),
                      {**rows, "library": bwd_library,
                       "max_abs_err": max(case_err[("flash_bwd_dkv",
                                                    f"{n} {g}", dtype)]
                                          for n in names
                                          for g in ("dk", "dv"))},
                      train_l, peak)]
    return kernels


def families_distribution_phase(dev, flash_case, bwd_case, graph_ms,
                                time_ms, device_profile):
    """Phase 38, every LM family but the dense one on phase 37's
    ``DIST_MESH`` ("data", "model") mesh with every shard on ``dev``,
    through the port's shard programs (``StackedModel.sharded``: the
    moe family's expert parallelism, the ssm and hybrid families' head
    sharding, the vlm and encdec families under sp), at full width and
    ``FAM_DEPTH``'s depths (whisper-tiny whole):

    (k) K7, K8 and K9 at every new shard shape these paths launch, held
    against their plain versions (``flash_case``/``bwd_case``), then
    timed (``k7_timing``, ``k89_timing``, SDPA);
    (a) qwen3-moe-30b-a3b, tp: fp32 at ``FAM_MOE_FP32`` (2 layers, 8 x
    4096: 32 groups, 2 a wave, split over data): prefill and decode
    logits, sharded and unsharded, each held to DIST_X times the unsharded
    run's distance from float64, the first MoE layer's routing identical
    sharded and unsharded, and the loss and grads of a step at
    ``FAM_MOE_FP32_TRAIN``; bf16: prefill 8 x 4096 and 8 decode tokens
    sharded and unsharded, held by DIST_BF16_RATIO to an fp32 run of the
    same weights (a layer at a time), the experts' device ms and the
    combine's adds; a bf16 step at 4 layers, sharded and unsharded, its
    loss held by DIST_X to the fp32 loss (``train_pair``);
    (b) moonshot-v1-16b-a3b, tp, the scatter dispatch: served (4 x 2048,
    8 tokens), held as (a)'s;
    (c) mamba2-370m and zamba2-1.2b, tp: served 4 x 2048 and 8 tokens,
    held by DIST_BF16_RATIO to an fp32 copy; one bf16 step each, its loss
    held as (a)'s;
    (d) qwen2-vl-2b, sp, drawn vision embeddings on grid ids: served and
    one step, as (c);
    (e) whisper-tiny, sp, batch 16 on 1500 drawn frames: served, held as
    (c), and in fp32 at ``FAM_ENC_FP32_DEPTH`` encoder and decoder layers
    against float64 by DIST_X.

    Each run reports its sharded and unsharded ms, peak GB and the
    sharded run's last decode step's idle share (torch.profiler, device
    only).
    The launch counts are zeroed before each path and read after it.
    Returns {"launches": {label: counts}, "timings": {label: rows},
    "seconds", "shapes"}."""
    import functools
    import gc

    import numpy as np
    import torch
    import torch.nn.functional as F

    from _torch_vlm_encdec_cases import family_inputs
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataConfig, token_batch
    from repro_torch.kernels import _build
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model_zoo import batch_inputs, build
    from repro_torch.models.moe import _expert_ffn, expert_capacity
    from repro_torch.models.transformer import mask_pad_logits
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.halo import make_mesh
    from repro_torch.parallel.sharding import Sharder
    from repro_torch.train.train_step import (compute_model,
                                              init_train_state, load_params,
                                              loss_fn, make_train_step,
                                              value_and_grad)

    t_start = time.perf_counter()
    rel, worst = dist_rel, dist_worst
    bf16, f32, f64 = torch.bfloat16, torch.float32, torch.float64

    def sync():
        torch.cuda.synchronize(dev)

    def flush():
        gc.collect()
        sync()
        torch.cuda.empty_cache()

    def peak_GB():
        return (torch.cuda.max_memory_allocated(dev) / 1e9
                if dev.type == "cuda" else 0.0)

    def reset_peak():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def counted(fn):
        """(fn(), the kernel launches it made)."""
        _build.LAUNCHES.clear()
        out = fn()
        sync()
        return out, dict(_build.LAUNCHES)

    def expect(uses, fwd=1, bwd=0):
        out = {"flash_fwd": fwd * uses, "flash_bwd_dq": bwd * uses,
               "flash_bwd_dkv": bwd * uses}
        return {k: v for k, v in out.items() if v}

    mesh = make_mesh(DIST_MESH, ("data", "model"))
    check(all(d.type == dev.type and (d.index or 0) == 0
              for d in mesh.devices),
          f"phase 38: shards off {dev.type}:0: {mesh.devices}")
    n_shards = mesh.size
    Dd, Mm = DIST_MESH
    archs = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "mamba2-370m",
             "zamba2-1.2b", "qwen2-vl-2b", "whisper-tiny")
    cfgs = {a: dataclasses.replace(get_config(a), attn_impl="flash")
            for a in archs}
    cfgs = {a: dataclasses.replace(c, n_layers=FAM_DEPTH.get(a, c.n_layers))
            for a, c in cfgs.items()}
    cfgs["moonshot-v1-16b-a3b"] = dataclasses.replace(
        cfgs["moonshot-v1-16b-a3b"], moe_dispatch="scatter")
    qm, ms_, m2, zb, vl, wh = (cfgs[a] for a in archs)
    Bq, Sq, Tq = FAM_MOE_SERVE
    Bs, Ss, Ts = FAM_SERVE
    Bt, St = FAM_TRAIN
    Be, Se, Te = FAM_ENC
    launches, timings, seconds, out = {}, {}, {}, {}

    # -- (k) the new shard shapes' kernels against their plain versions ----
    t0 = time.perf_counter()

    def tp_shard(cfg, batch, seq):
        H_l, G = cfg.n_heads // Mm, cfg.n_heads // cfg.n_kv_heads
        return (batch // Dd, seq, seq, H_l, H_l // G if H_l % G == 0 else 1,
                cfg.head_dim)

    enc_len = wh.enc_len
    shapes = {   # label -> (shape, causal, kv_offsets)
        "tp qwen3-moe serve shard": (tp_shard(qm, Bq, Sq), True, [0]),
        "tp qwen3-moe train shard": (tp_shard(qm, *FAM_MOE_TRAIN[:2]), True,
                                     [0]),
        "tp moonshot shard": (tp_shard(ms_, Bs, Ss), True, [0]),
        "tp zamba2 shared attention shard": (tp_shard(zb, Bs, Ss), True,
                                             [0]),
        "sp qwen2-vl shard": ((Bs // Dd, Ss // Mm, Ss, vl.n_heads,
                               vl.n_kv_heads, vl.head_dim), True,
                              [m * (Ss // Mm) for m in range(Mm)]),
        "sp whisper decoder self shard": (
            (Be // Dd, Se // Mm, Se, wh.n_heads, wh.n_kv_heads,
             wh.head_dim), True, [m * (Se // Mm) for m in range(Mm)]),
        "sp whisper cross shard": ((Be // Dd, Se // Mm, enc_len, wh.n_heads,
                                    wh.n_kv_heads, wh.head_dim), False, [0]),
        "sp whisper encoder shard": ((Be // Dd, enc_len, enc_len, wh.n_heads,
                                      wh.n_kv_heads, wh.head_dim), False,
                                     [0])}
    Bf, Sf, _, _ = FAM_MOE_FP32
    fp32_shapes = {   # held in fp32 (the fp32 checks' launches), untimed
        "tp qwen3-moe fp32 shard": (tp_shard(qm, Bf, Sf), True, [0]),
        "tp qwen3-moe fp32 train shard": (tp_shard(qm, *FAM_MOE_FP32_TRAIN),
                                          True, [0]),
        "sp whisper fp32 self shard": shapes["sp whisper decoder self shard"],
        "sp whisper fp32 cross shard": shapes["sp whisper cross shard"],
        "sp whisper fp32 encoder shard": shapes["sp whisper encoder shard"]}
    bwd_labels = ("tp qwen3-moe train shard",
                  "tp zamba2 shared attention shard", "sp qwen2-vl shard",
                  "tp qwen3-moe fp32 train shard")
    gk = torch.Generator(device=dev).manual_seed(38)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gk, device=dev).to(dtype)

    def hold(label, shape, causal, offsets, dtype):
        Bx, Sqx, Skv, Hx, KVx, hd = shape
        for off in offsets:
            name = f"{label} off{off}" if off else label
            flash_case(name, shape, dtype, causal=causal, kv_offset=off,
                       blocks=(512, 512))
            if label in bwd_labels:
                bwd_case(name, rand(Bx, Sqx, Hx, hd, dtype=dtype),
                         rand(Bx, Skv, KVx, hd, dtype=dtype),
                         rand(Bx, Skv, KVx, hd, dtype=dtype),
                         rand(Bx, Sqx, Hx, hd, dtype=dtype), causal=causal,
                         kv_offset=off, flips=dtype == bf16)
            flush()

    for label, (shape, causal, offs) in shapes.items():
        hold(label, shape, causal, offs, bf16)
    for label, (shape, causal, offs) in fp32_shapes.items():
        hold(label, shape, causal, offs, f32)
    gt = torch.Generator(device=dev).manual_seed(39)
    for label, (shape, causal, offs) in shapes.items():
        rows = []
        for off in offs:
            row = {"k7": k7_timing(shape, causal, dev, gt, graph_ms, time_ms,
                                   kv_offset=off, dtype=bf16)}
            if label in bwd_labels:
                row["k89"] = k89_timing(shape, causal, dev, gt, graph_ms,
                                        time_ms, kv_offset=off, dtype=bf16)
            rows.append(row)
            flush()
        timings[f"{label} bfloat16"] = rows
    seconds["kernels"] = time.perf_counter() - t0

    # -- helpers of the runs ------------------------------------------------

    @torch.no_grad()
    def serve_run(model, sharder, toks, fed, max_len, extra, prog=None,
                  profile=False):
        """Prefill ``toks`` (with ``extra``: a vlm's vision embeddings and
        positions, encdec's frames), then decode the ``fed`` tokens one a
        step (teacher-forced), unsharded or through ``prog`` (the model's
        shard program under ``sharder``): (the logits of the last prompt
        position and of each step, gathered (B, V) fp32 over the vocab's
        real rows; prefill ms; decode ms a token; launches; the first
        cache leaf's spec; with ``profile`` the last decode step run under
        ``device_profile`` (device only; a whole sharded serve traces 10^5
        launches, a minute of the profiler's own time) and left out of the
        decode ms, else None)."""
        if sharder is not None and prog is None:
            prog = model.sharded(sharder)
        S = toks.shape[1]
        _build.LAUNCHES.clear()
        sync()
        e0 = event()
        if prog is None:
            last, cache = model.prefill(toks, max_len, **extra)
            outs = [mask_pad_logits(model.logits(last), model.cfg)]
        else:
            last, cache = prog.prefill(toks, max_len, **extra)
            outs = [prog.logits(last.pieces, last.spec[0]).gather()]
        e1 = event()
        state = {"cache": cache}

        def step(i, tok):
            if prog is None:
                lg, state["cache"] = model.decode_step(tok, state["cache"],
                                                       S + i)
                return lg
            lg, state["cache"] = prog.decode_step(tok, state["cache"], S + i)
            return lg.gather()

        timed = len(fed) - 1 if profile else len(fed)
        for i, tok in enumerate(fed[:timed]):
            outs.append(step(i, tok))
        e2 = event()
        e2.synchronize()
        prof = None
        if profile:
            got = {}
            prof = device_profile(lambda: got.setdefault(
                "lg", step(timed, fed[timed])), top=6, host=False)
            outs.append(got["lg"])
        leaf = state["cache"]
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        spec = list(leaf.spec) if prog is not None else None
        V = model.cfg.vocab_size     # the padded rows' -1e30 cut off
        return ([o[:, :V].float() for o in outs], e0.elapsed_time(e1),
                e1.elapsed_time(e2) / max(timed, 1),
                dict(_build.LAUNCHES), spec, prof)

    def served(model, sharder, toks, fed, max_len, extra, prog=None):
        """serve_run unsharded, then sharded, its last decode step under
        the profiler: {"logits": (unsharded, sharded), ms, peak GB, the
        sharded decode step's idle share and device ms by class, launches,
        cache spec}."""
        t1 = time.perf_counter()
        reset_peak()
        lu, pu, du, l_u, _, _ = serve_run(model, None, toks, fed, max_len,
                                          extra)
        peak_u = peak_GB()
        flush()
        reset_peak()
        ls, ps, ds, l_s, spec, prof = serve_run(model, sharder, toks, fed,
                                                max_len, extra, prog,
                                                profile=True)
        rec = {"prefill_ms_unsharded": pu, "prefill_ms_sharded": ps,
               "decode_ms_per_token_unsharded": du,
               "decode_ms_per_token_sharded": ds,
               "peak_GB_unsharded": peak_u, "peak_GB_sharded": peak_GB(),
               "sharded_decode_step": {
                   k: prof[k] for k in ("wall_ms", "device_ms",
                                        "device_idle_share", "ms_by_class",
                                        "kernels")},
               "launches_unsharded": l_u, "launches_sharded": l_s,
               "cache_spec": spec, "n_layers": model.cfg.n_layers,
               "serve_s": time.perf_counter() - t1}
        flush()
        return (lu, ls), rec

    def moe_served(model, sharder, toks, fed, max_len):
        """served() and fp32_layerwise() of a moe model with each run's
        routing recorded: (lu, ls, l32, rec), rec["bf16_routing"] a layer
        the prefill tokens whose expert set differs sharded against
        unsharded and unsharded against the fp32 run."""
        def record(on):
            for lay in model.layers:
                lay.moe.routes = [] if on else None

        prog = model.sharded(sharder)
        prog.routes = {}
        record(True)
        (lu, ls), rec = served(model, sharder, toks, fed, max_len, {}, prog)
        ru = [lay.moe.routes for lay in model.layers]
        record(True)
        t1 = time.perf_counter()
        l32 = fp32_layerwise(model, toks, fed, max_len)
        rec["fp32_reference_s"] = time.perf_counter() - t1
        rf = [lay.moe.routes for lay in model.layers]
        record(False)
        rs = [prog.routes[f"layers.{i}."] for i in range(len(ru))]

        def moved(a, b):
            return int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())

        waves = len(ru[0]) - len(fed)
        rec["bf16_routing"] = []
        for u, s, f in zip(ru, rs, rf):
            G_u, Gl = u[0][0].shape[0], s[0][0].shape[0]
            n_su = 0
            for w in range(waves):
                rows = {}
                for k, coord in enumerate(mesh.coords()):
                    rows.setdefault(coord[0] if Gl < G_u else 0, k)
                for row, k in rows.items():
                    g0 = row * Gl if Gl < G_u else 0
                    n_su += moved(s[w * n_shards + k][0],
                                  u[w][0][g0:g0 + Gl])
            rec["bf16_routing"].append({
                "tokens": waves * u[0][0].shape[0] * u[0][0].shape[1],
                "sharded_vs_unsharded": n_su,
                "unsharded_vs_fp32": sum(moved(u[w][0], f[w][0])
                                         for w in range(waves))})
        del ru, rs, rf
        return lu, ls, l32, rec

    def hold_bf16(tag, lu, ls, l32, rec):
        """Each step's sharded logits no farther from the fp32 run than
        DIST_BF16_RATIO times the unsharded run's distance."""
        rec["bf16_vs_fp32"] = []
        for i, (u_, s_, r_) in enumerate(zip(lu, ls, l32)):
            d_u, d_s = rel(u_, r_), rel(s_, r_)
            rec["bf16_vs_fp32"].append({"step": i, "unsharded": d_u,
                                        "sharded": d_s,
                                        "sharded_vs_unsharded": rel(s_, u_)})
            check(d_s <= DIST_BF16_RATIO * d_u, f"({tag}) bf16 logits step "
                  f"{i}: sharded {d_s} from fp32, unsharded {d_u}")

    @contextlib.contextmanager
    def as_fp32(module, cfg32):
        """``module``'s bf16 parameters swapped for fp32 copies (and its
        attention's config for ``cfg32``) while it runs, then the bf16
        tensors put back as they were."""
        saved = [(p, p.data) for p in module.parameters()
                 if p.dtype == bf16]
        attn = [m for m in module.modules() if hasattr(m, "cfg")
                and hasattr(m, "wq")]
        for p, d in saved:
            p.data = d.float()
        cfgs_ = [a.cfg for a in attn]
        for a in attn:
            a.cfg = cfg32
        try:
            yield
        finally:
            for p, d in saved:
                p.data = d
            for a, c in zip(attn, cfgs_):
                a.cfg = c

    @torch.no_grad()
    def fp32_layerwise(model, toks, fed, max_len):
        """serve_run's logits from an fp32 run of a bf16 moe model's
        weights, one layer in fp32 at a time (``as_fp32``; the router is
        fp32 already), the embedding, final norm and head in fp32, the
        cache fp32, attention plain PyTorch: the reference where an fp32
        copy of the model would not fit beside it."""
        cfg = model.cfg
        cfg32 = dataclasses.replace(cfg, attn_impl="xla",
                                    q_chunk=FAM_REF_Q_CHUNK)
        B, S = toks.shape
        emb, head = model.embed.float(), model.lm_head.float()
        fnorm = model.final_norm.float()
        shape = (B, max_len, cfg.n_kv_heads, cfg.head_dim)
        kc = [torch.zeros(shape, device=dev) for _ in model.layers]
        vc = [torch.zeros(shape, device=dev) for _ in model.layers]

        def logits(x):
            return mask_pad_logits(F.linear(rms_norm(x, fnorm, cfg.norm_eps),
                                            head), cfg)

        x = emb[toks]
        pos = model._default_positions(toks)
        for i, block in enumerate(model.layers):
            with as_fp32(block, cfg32):
                x, (k, v), _ = block(x, pos)
            kc[i][:, :S], vc[i][:, :S] = k, v
        outs = [logits(x[:, -1])]
        for j, tok in enumerate(fed):
            x = emb[tok[:, None]]
            p = torch.full((B, 1), S + j, device=dev)
            for i, block in enumerate(model.layers):
                with as_fp32(block, cfg32):
                    x = block.decode(x, kc[i], vc[i], S + j, p)
            outs.append(logits(x[:, 0]))
        return outs

    def route_compare(routes_u, routes_s, waves):
        """The first MoE layer's routing of a prefill's ``waves``, each
        shard's groups (``routes_s``, shard order within a wave) against
        the unsharded run's (``routes_u``): the shards of a data row must
        agree exactly (the same expert ids and keep mask a token), and a
        token may route otherwise than unsharded only at an fp32 tie (the
        two runs' router inputs differ by the tp sums' order): two of its
        top-(k + 1) probabilities within FAM_ROUTE_TIE of its largest, the
        keep mask changing only in a group holding such a token."""
        G_u = routes_u[0][0].shape[0]
        Gl = routes_s[0][0].shape[0]
        agree, moved, ties, keep_off = True, 0, True, True
        gaps = []
        for w in range(waves):
            e_u, k_u, p_u = routes_u[w]
            rows = {}
            for k, coord in enumerate(mesh.coords()):
                e_s, k_s, _ = routes_s[w * n_shards + k]
                if coord[0] in rows:
                    agree &= bool(torch.equal(e_s, rows[coord[0]][0])
                                  and torch.equal(k_s, rows[coord[0]][1]))
                    continue
                rows[coord[0]] = (e_s, k_s)
                g0 = coord[0] * Gl if Gl < G_u else 0
                eu, ku = e_u[g0:g0 + Gl], k_u[g0:g0 + Gl]
                off = (e_s != eu).any(-1)                 # (Gl, S)
                moved += int(off.sum())
                if off.any():
                    top = p_u[g0:g0 + Gl][off].sort(
                        -1, descending=True).values[:, :e_s.shape[-1] + 1]
                    gap = ((top[:, :-1] - top[:, 1:]).amin(-1)
                           / top[:, 0])
                    gaps += gap.tolist()
                    ties &= bool((gap <= FAM_ROUTE_TIE).all())
                keep_off &= bool(((k_s != ku).any(-1).any(-1)
                                  <= off.any(-1)).all())
        return {"waves": waves, "groups_a_wave": G_u, "groups_a_shard": Gl,
                "groups_split": Gl < G_u, "shards_of_a_row_agree": agree,
                "tokens_routed_otherwise": moved,
                "their_relative_gaps": gaps[:16],
                "differences_at_ties_only": ties and keep_off}

    def fp32_copy(model, **changes):
        ref = type(model)(dataclasses.replace(
            model.cfg, attn_impl="xla", q_chunk=FAM_REF_Q_CHUNK, **changes),
            device=dev, dtype=f32)
        ref.load_state_dict(model.state_dict())
        return ref

    def prompts(cfg, B, S, T, seed):
        rng = np.random.default_rng(seed)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                               device=dev)
        fed = torch.as_tensor(rng.integers(0, cfg.vocab_size, (T, B)),
                              device=dev)
        return toks, fed

    def extra_of(cfg, B, S, seed, dtype):
        if cfg.family not in ("vlm", "encdec"):
            return {}
        return family_inputs(cfg, B, S, seed, dev, dtype)

    @torch.no_grad()
    def token_nll(model, batch):
        """Each token's nll (T,) fp32 under a forward of ``model``."""
        hidden, _ = model(batch["tokens"], remat=False,
                          **batch_inputs(model.cfg, batch))
        h = hidden.reshape(-1, hidden.shape[-1])
        y = batch["labels"].reshape(-1, 1)
        W, V = model.lm_head.float(), model.cfg.vocab_size
        out = []
        for c in range(0, h.shape[0], 1024):
            lg = F.linear(h[c:c + 1024].float(), W)[:, :V]
            out.append(torch.logsumexp(lg, -1)
                       - lg.gather(1, y[c:c + 1024])[:, 0])
        return torch.cat(out)

    def train_pair(cfg, B, S, tag):
        """One bf16 step off fp32 masters drawn from seed 0, unsharded and
        sharded (a fresh master each: a step updates its masters), timed;
        the sharded loss held to DIST_X times the unsharded's distance
        from the masters' fp32 loss, or, where that is smaller, to DIST_X
        times the bf16 loss's own noise: the standard error of the mean of
        the tokens' bf16-against-fp32 nll differences (a bf16 run of these
        random models moves each token's nll by far more than the mean
        moves, so two bf16 runs' losses part by about that error, whatever
        their summation order)."""
        sh = Sharder(mesh, cfg.sharding_profile)
        batch = {**token_batch(DataConfig(cfg.vocab_size, S, B), 0,
                               device=dev),
                 **extra_of(cfg, B, S, 7, bf16)}
        rec = {"batch": B, "seq_len": S, "n_layers": cfg.n_layers}
        for run in ("unsharded", "sharded"):
            master = build(cfg, device=dev, dtype=f32,
                           generator=torch.Generator(device=dev).manual_seed(0))
            if run == "unsharded":
                with torch.no_grad():
                    rec["loss_fp32"] = float(loss_fn(master, batch)[0])
                    compute = compute_model(master, bf16)
                    load_params(compute, dict(master.named_parameters()))
                    diff = token_nll(compute, batch) - token_nll(master,
                                                                 batch)
                    rec["loss_noise"] = float(diff.std() / diff.numel()
                                              ** 0.5) / rec["loss_fp32"]
                    del compute, diff
            step = make_train_step(master, AdamWConfig(),
                                   sharder=sh if run == "sharded" else None)
            state = init_train_state(master)
            reset_peak()
            sync()
            e0 = event()
            (state, met), l_ = counted(lambda: step(state, batch))
            e1 = event()
            e1.synchronize()
            rec[run] = {"ms": e0.elapsed_time(e1), "peak_GB": peak_GB(),
                        "loss": float(met["loss"]),
                        "grad_norm": float(met["grad_norm"]),
                        "aux": float(met["aux"]), "launches": l_}
            check(all(math.isfinite(rec[run][k])
                      for k in ("loss", "grad_norm")),
                  f"({tag}) {run} bf16 step: {rec[run]}")
            del master, step, state, met
            flush()
        d_u = abs(rec["unsharded"]["loss"] / rec["loss_fp32"] - 1)
        d_s = abs(rec["sharded"]["loss"] / rec["loss_fp32"] - 1)
        rec.update(loss_unsharded_vs_fp32=d_u, loss_sharded_vs_fp32=d_s)
        check(d_s <= DIST_X * max(d_u, rec["loss_noise"]),
              f"({tag}) bf16 step loss: sharded {d_s} from fp32, past "
              f"{DIST_X} x {max(d_u, rec['loss_noise'])}")
        return rec

    # -- (a) qwen3-moe-30b-a3b, tp -----------------------------------------
    t0 = time.perf_counter()
    tp = Sharder(mesh, qm.sharding_profile)
    check(tp.profile == "tp", f"{qm.arch} runs {tp.profile}")
    Bf, Sf, Tf, Lf = FAM_MOE_FP32
    cut = dataclasses.replace(qm, n_layers=Lf)
    m32 = build(cut, device=dev, dtype=f32,
                generator=torch.Generator(device=dev).manual_seed(0))
    toks, fed = prompts(cut, Bf, Sf, Tf, 40)
    max_f = Sf + Tf + 2                 # model 4 divides it: the cache shards
    m32.layers[0].moe.routes = []
    lu, _, _, l_u, _, _ = serve_run(m32, None, toks, fed, max_f, {})
    routes_u = m32.layers[0].moe.routes
    m32.layers[0].moe.routes = None
    prog = m32.sharded(tp)
    prog.routes = {}
    ls, _, _, l_s, fspec, _ = serve_run(m32, tp, toks, fed, max_f, {},
                                        prog)
    routes_s = prog.routes["layers.0."]
    check(l_u == expect(Lf) and l_s == expect(Lf * n_shards),
          f"(a) fp32 serve launched {l_u}, {l_s}")
    routing = route_compare(routes_u, routes_s, len(routes_u) - Tf)
    check(routing["shards_of_a_row_agree"] and routing["groups_split"]
          and routing["differences_at_ties_only"],
          f"(a) fp32 routing of layer 0: {routing}")
    del routes_u, routes_s, prog
    m64 = type(m32)(dataclasses.replace(cut, attn_impl="xla",
                                        q_chunk=FAM_REF_Q_CHUNK),
                    device=dev, dtype=f64)
    m64.load_state_dict(m32.state_dict())
    with widened64():
        l64 = serve_run(m64, None, toks, fed, max_f, {})[0]
    fp32 = {"n_layers": Lf, "batch": Bf, "prompt": Sf, "cache_spec": fspec,
            "routing": routing, "logits": []}
    for i, (s_, u_, r_) in enumerate(zip(ls, lu, l64)):
        d_u, d_s = rel(u_, r_), rel(s_, u_)
        fp32["logits"].append({"step": i, "unsharded_vs_f64": d_u,
                               "sharded_vs_unsharded": d_s,
                               "sharded_vs_f64": rel(s_, r_)})
        check(d_s <= DIST_X * d_u, f"(a) fp32 logits step {i}: sharded "
              f"{d_s} from unsharded, past {DIST_X} x {d_u}")
    del lu, ls, l64
    flush()
    Bg, Sg = FAM_MOE_FP32_TRAIN
    batch = token_batch(DataConfig(cut.vocab_size, Sg, Bg), 0, device=dev)
    params32 = {n: p.detach() for n, p in m32.named_parameters()}
    loss_u, _, g_u = value_and_grad(m32, params32, batch)
    (loss_s, _, g_s), step_s = counted(lambda: value_and_grad(
        m32, params32, batch, functools.partial(loss_fn, sharder=tp)))
    check(step_s == expect(Lf * n_shards, 2, 1),
          f"(a) fp32 sharded step launched {step_s}")
    launches["a fp32 step"] = step_s
    del m32, params32
    with widened64():
        loss64, _, g64 = value_and_grad(
            m64, {n: p.detach() for n, p in m64.named_parameters()}, batch)
    del m64
    d_u = abs(float(loss_u) / float(loss64) - 1)
    d_s = abs(float(loss_s) / float(loss_u) - 1)
    gd_u, gd_s = worst(g_u, g64), worst(g_s, g_u)
    fp32.update(step_batch=Bg, step_seq=Sg, loss_unsharded_vs_f64=d_u,
                loss_sharded_vs_unsharded=d_s, grads_unsharded_vs_f64=gd_u,
                grads_sharded_vs_unsharded=gd_s, loss=float(loss_s))
    check(d_s <= DIST_X * d_u, f"(a) fp32 loss: {d_s} past {DIST_X} x {d_u}")
    check(gd_s <= DIST_X * gd_u,
          f"(a) fp32 grads: {gd_s} past {DIST_X} x {gd_u}")
    del g_u, g_s, g64
    flush()
    out["a_fp32"] = fp32
    launches["a fp32 serve"] = l_s

    seconds["a fp32"] = time.perf_counter() - t0
    model = build(qm, device=dev, dtype=bf16,
                  generator=torch.Generator(device=dev).manual_seed(0))
    toks, fed = prompts(qm, Bq, Sq, Tq, 41)
    max_q = Sq + Tq
    lu, ls, l32, rec = moe_served(model, tp, toks, fed, max_q)
    check(rec["launches_sharded"] == expect(qm.n_layers * n_shards)
          and rec["launches_unsharded"] == expect(qm.n_layers),
          f"(a) bf16 serve launched {rec['launches_sharded']}")
    launches["a serve"] = rec["launches_sharded"]
    seconds["a fp32 reference"] = rec["fp32_reference_s"]
    hold_bf16("a", lu, ls, l32, rec)
    del lu, ls, l32
    # The experts' device ms: one shard's FFN on one wave (its 32 experts'
    # capacity slots of one group) against the unsharded wave's 128
    # experts on both groups, by graph replay, and a prefill's worth.
    E, gs = qm.n_experts, qm.moe_group_size
    C = expert_capacity(gs, qm.top_k, qm.capacity_factor, E)
    n_groups = Bq * Sq // gs
    n_waves = min(qm.moe_waves, n_groups)
    G = n_groups // n_waves
    lay = model.layers[0].moe
    El = E // Mm
    xin_s = rand(El, G // Dd, C, qm.d_model, dtype=bf16)
    xin_u = rand(E, G, C, qm.d_model, dtype=bf16)
    piece = {n: getattr(lay, n)[:El] for n in ("up", "gate", "down")}
    whole = {n: getattr(lay, n) for n in ("up", "gate", "down")}
    ex_s = graph_ms(lambda: _expert_ffn(piece, xin_s, qm.activation), 5)
    ex_u = graph_ms(lambda: _expert_ffn(whole, xin_u, qm.activation), 5)
    per = qm.n_layers * n_waves
    rec["experts"] = {
        "shard_wave_ms": ex_s, "unsharded_wave_ms": ex_u,
        "prefill_ms_sharded": ex_s * per * n_shards,
        "prefill_ms_unsharded": ex_u * per,
        "capacity": C, "waves": n_waves, "groups_a_wave": G,
        "groups_a_shard": G // Dd, "experts_a_shard": El}
    # The combine: each data row's partial outputs of every wave, added
    # over the 4 model shards once a layer (3 adds a row; shards on one
    # card share the sum).
    part = n_waves * (G // Dd) * gs * qm.d_model
    rec["combine"] = {"adds_a_layer": Dd * (Mm - 1),
                      "adds_a_prefill": qm.n_layers * Dd * (Mm - 1),
                      "elements_an_add": part,
                      "bytes_a_prefill": qm.n_layers * Dd * (Mm - 1) * 3
                      * part * 2}
    del model, xin_s, xin_u, piece, whole, lay
    flush()
    tcut = dataclasses.replace(qm, n_layers=FAM_MOE_TRAIN[2])
    t1 = time.perf_counter()
    rec["train"] = train_pair(tcut, *FAM_MOE_TRAIN[:2], "a")
    seconds["a train"] = time.perf_counter() - t1
    check(rec["train"]["sharded"]["launches"] == expect(
        tcut.n_layers * n_shards, 2, 1),
        f"(a) bf16 sharded step launched {rec['train']['sharded']}")
    launches["a step"] = rec["train"]["sharded"]["launches"]
    out["a"] = rec
    seconds["a"] = time.perf_counter() - t0

    # -- (b) moonshot-v1-16b-a3b, tp, scatter ------------------------------
    t0 = time.perf_counter()
    model = build(ms_, device=dev, dtype=bf16,
                  generator=torch.Generator(device=dev).manual_seed(0))
    toks, fed = prompts(ms_, Bs, Ss, Ts, 42)
    lu, ls, l32, rec = moe_served(model, Sharder(mesh, ms_.sharding_profile),
                                  toks, fed, Ss + Ts)
    check(rec["launches_sharded"] == expect(ms_.n_layers * n_shards),
          f"(b) serve launched {rec['launches_sharded']}")
    launches["b serve"] = rec["launches_sharded"]
    hold_bf16("b", lu, ls, l32, rec)
    out["b"] = rec
    del model, lu, ls, l32
    flush()
    seconds["b"] = time.perf_counter() - t0

    # -- (c)-(e): models whose fp32 copy fits beside them -------------------
    for tag, cfg, (B_, S_, T_), train_shape in (
            ("c mamba2", m2, FAM_SERVE, FAM_TRAIN),
            ("c zamba2", zb, FAM_SERVE, FAM_TRAIN),
            ("d", vl, FAM_SERVE, FAM_TRAIN),
            ("e", wh, FAM_ENC, None)):
        t0 = time.perf_counter()
        sh = Sharder(mesh, cfg.sharding_profile)
        model = build(cfg, device=dev, dtype=bf16,
                      generator=torch.Generator(device=dev).manual_seed(0))
        toks, fed = prompts(cfg, B_, S_, T_, 43)
        extra = extra_of(cfg, B_, S_, 44, bf16)
        (lu, ls), rec = served(model, sh, toks, fed, S_ + T_, extra)
        uses = {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
                "encdec": cfg.n_enc_layers + 2 * cfg.n_layers}.get(
                    cfg.family, cfg.n_layers)
        check(rec["launches_sharded"] == expect(uses * n_shards)
              and rec["launches_unsharded"] == expect(uses),
              f"({tag}) serve launched {rec['launches_sharded']}")
        launches[f"{tag} serve"] = rec["launches_sharded"]
        t1 = time.perf_counter()
        ref = fp32_copy(model)
        l32 = serve_run(ref, None, toks, fed, S_ + T_,
                        {k: v.float() if v.is_floating_point() else v
                         for k, v in extra.items()})[0]
        rec["fp32_reference_s"] = time.perf_counter() - t1
        hold_bf16(tag, lu, ls, l32, rec)
        del ref, lu, ls, l32, model
        flush()
        if train_shape is not None:
            t1 = time.perf_counter()
            rec["train"] = train_pair(cfg, *train_shape, tag)
            rec["train_s"] = time.perf_counter() - t1
            check(rec["train"]["sharded"]["launches"] == expect(
                uses * n_shards, 2, 1),
                f"({tag}) sharded step launched {rec['train']['sharded']}")
            launches[f"{tag} step"] = rec["train"]["sharded"]["launches"]
        out[tag] = rec
        seconds[tag] = time.perf_counter() - t0

    # (e) fp32 at FAM_ENC_FP32_DEPTH layers each side against float64.
    t0 = time.perf_counter()
    cut = dataclasses.replace(wh, n_layers=FAM_ENC_FP32_DEPTH,
                              n_enc_layers=FAM_ENC_FP32_DEPTH)
    sh = Sharder(mesh, cut.sharding_profile)
    m32 = build(cut, device=dev, dtype=f32,
                generator=torch.Generator(device=dev).manual_seed(0))
    toks, fed = prompts(cut, Be, Se, 2, 45)
    extra = extra_of(cut, Be, Se, 46, f32)
    lu = serve_run(m32, None, toks, fed, Se + 4, extra)[0]
    ls, _, _, l_s, _, _ = serve_run(m32, sh, toks, fed, Se + 4, extra)
    check(l_s == expect(3 * FAM_ENC_FP32_DEPTH * n_shards),
          f"(e) fp32 sharded serve launched {l_s}")
    launches["e fp32 serve"] = l_s
    m64 = type(m32)(dataclasses.replace(cut, attn_impl="xla"), device=dev,
                    dtype=f64)
    m64.load_state_dict(m32.state_dict())
    with widened64():
        l64 = serve_run(m64, None, toks, fed, Se + 4,
                        {k: v.double() for k, v in extra.items()})[0]
    enc = {"n_layers": FAM_ENC_FP32_DEPTH, "logits": []}
    for i, (s_, u_, r_) in enumerate(zip(ls, lu, l64)):
        d_u, d_s = rel(u_, r_), rel(s_, u_)
        enc["logits"].append({"step": i, "unsharded_vs_f64": d_u,
                              "sharded_vs_unsharded": d_s})
        check(d_s <= DIST_X * d_u, f"(e) fp32 logits step {i}: sharded "
              f"{d_s} from unsharded, past {DIST_X} x {d_u}")
    out["e_fp32"] = enc
    del m32, m64, lu, ls, l64
    flush()
    seconds["e fp32"] = time.perf_counter() - t0
    seconds["total"] = time.perf_counter() - t_start
    emit({"phase": 38, "mesh": dict(zip(mesh.axis_names, mesh.shape)),
          "shard_devices": sorted({str(d) for d in mesh.devices}),
          "shapes": {k: [list(v[0]), v[1], v[2]]
                     for k, v in {**shapes, **fp32_shapes}.items()},
          **out, "launches": launches, "kernel_times": timings,
          "seconds": seconds})
    return {"launches": launches, "timings": timings, "seconds": seconds,
            "shapes": shapes}


def families_kernel_rows(fam, entry, case_err):
    """The kernels line's K7-K9 rows at phase 38's shard shapes."""
    fl = fam["launches"]
    paths = {   # row -> (dtype, K7's path launches, the step's)
        "tp qwen3-moe serve shard": {"bfloat16": (fl["a serve"], {})},
        "tp qwen3-moe train shard": {"bfloat16": (fl["a step"],
                                                  fl["a step"])},
        "tp moonshot shard": {"bfloat16": (fl["b serve"], {})},
        "tp zamba2 shared attention shard": {
            "bfloat16": (fl["c zamba2 serve"], fl["c zamba2 step"])},
        "sp qwen2-vl shard": {"bfloat16": (fl["d serve"], fl["d step"])},
        "sp whisper decoder self shard": {"bfloat16": (fl["e serve"], {})},
        "sp whisper cross shard": {"bfloat16": (fl["e serve"], {})},
        "sp whisper encoder shard": {"bfloat16": (fl["e serve"], {})}}
    cases = {
        "tp qwen3-moe serve shard": "a tp shard of qwen3-moe-30b-a3b's "
                                    "prefill, 8 x 4096 on a 2x4 mesh (8 "
                                    "query heads on one kv head, batch 4)",
        "tp qwen3-moe train shard": "a tp shard of qwen3-moe-30b-a3b's "
                                    "4-layer step, 4 x 2048 on a 2x4 mesh",
        "tp moonshot shard": "a tp shard of moonshot-v1-16b-a3b on a 2x4 "
                             "mesh (4 MHA heads, batch 2)",
        "tp zamba2 shared attention shard": "a tp shard of zamba2-1.2b's "
                                            "shared attention (8 MHA heads "
                                            "of 64, batch 2)",
        "sp qwen2-vl shard": "the sp shards of qwen2-vl-2b on a 2x4 mesh "
                             "(512 queries on 2048 keys, 12 q heads on 2 "
                             "kv heads, one launch at each kv_offset)",
        "sp whisper decoder self shard": "the sp shards of whisper-tiny's "
                                         "decoder self-attention (56 "
                                         "queries on 224 keys, batch 8, "
                                         "one launch at each kv_offset)",
        "sp whisper cross shard": "a sp shard of whisper-tiny's cross-"
                                  "attention (56 queries on the 1500 "
                                  "frames, batch 8)",
        "sp whisper encoder shard": "whisper-tiny's encoder, whole on each "
                                    "sp shard (1500 frames, batch 8)"}
    return shard_kernel_rows(fam["timings"], paths, cases, 38, entry,
                             case_err)


def launch_tooling_phase(dev, flash_case, bwd_case, graph_ms, time_ms,
                         device_profile):
    """Phase 39, the launch tooling and state_over_data decode:

    (b) first started: the dry-run CLI (``python -m
    repro_torch.launch.dryrun``) on meta for ``LT_CLI_CELLS`` at full
    width and, for (a), qwen3-0.6b's smoke cells of ``LT_SMOKE_CELLS``,
    one subprocess each, all at once, while the card runs (a) and (c);
    each full-width cell's status OK and counts equal to ``LT_CLI_COUNTS``;
    (k) K7-K9 at (a)'s new shard shapes held against their plain versions
    (``flash_case``/``bwd_case``), then timed (``k7_timing``,
    ``k89_timing``, SDPA);
    (a) the same smoke cells for real through ``launch.dryrun.run_cell``
    with all 256 shards of the 16 x 16 mesh on ``dev``: the counted
    flops, hbm_bytes and collectives equal to the meta record's exactly,
    the kernels' launches those the shard program implies (train 2 x
    layers x 256 K7 and layers x 256 K8/K9, prefill layers x 256 K7,
    decode none: its attention is plain), each step's seconds and the
    card's peak memory beside the record's argument bytes x 256;
    (c) mamba2-370m and zamba2-1.2b under state_over_data on DIST_MESH,
    every shard on ``dev``, batch 1 (module constants' comment): ms/token
    sharded and unsharded, peak GB, the sharded step's idle share.

    Returns {"launches", "timings", "seconds"}."""
    import gc
    import shutil
    import subprocess
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.parallel.halo import make_mesh

    t_start = time.perf_counter()
    bf16 = torch.bfloat16

    def sync():
        torch.cuda.synchronize(dev)

    def flush():
        gc.collect()
        sync()
        torch.cuda.empty_cache()

    def peak_GB():
        return torch.cuda.max_memory_allocated(dev) / 1e9

    launches, timings, seconds, out = {}, {}, {}, {}

    # -- (b) the meta dry runs, started first ---------------------------------
    tmp = tempfile.mkdtemp(prefix="phase39_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    cells = ([("qwen3-0.6b", s, True) for s in LT_SMOKE_CELLS]
             + [(a, s, False) for a, s in LT_CLI_CELLS])
    procs = {}
    for arch, shape, smoke in cells:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", "pod", "--out",
               os.path.join(tmp, "smoke" if smoke else "full")]
        procs[(arch, shape, smoke)] = (subprocess.Popen(
            cmd + ["--smoke"] * smoke, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT),
            time.perf_counter())

    def record_of(arch, shape, smoke):
        p, t0 = procs[(arch, shape, smoke)]
        stdout, stderr = p.communicate(timeout=900)
        wall = time.perf_counter() - t0
        check(p.returncode == 0, f"phase 39: dryrun {arch} {shape} exited "
              f"{p.returncode}: {stderr[-2000:]}")
        path = os.path.join(tmp, "smoke" if smoke else "full",
                            f"{arch}__{shape}__pod16x16.json")
        with open(path) as f:
            rec = json.load(f)
        check(rec["status"] == "OK" and "status=OK" in stdout,
              f"phase 39: dryrun {arch} {shape}: {rec['status']}")
        return rec, wall

    def counts(rec):
        return {k: rec["hlo_cost"][k] for k in ("flops", "hbm_bytes",
                                                "collectives")}

    try:
        # -- (k) the new shard shapes' kernels against their plain versions --
        t0 = time.perf_counter()
        cfg = get_config("qwen3-0.6b", smoke=True)
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        shapes = {   # 4 q heads do not divide model 16: whole on a shard
            "pod qwen3-0.6b smoke train shard": (256 // 16, 4096, 4096, H,
                                                 KV, hd),
            "pod qwen3-0.6b smoke prefill shard": (32 // 16, 32768, 32768,
                                                   H, KV, hd)}
        gk = torch.Generator(device=dev).manual_seed(39)

        def rand(*shape):
            return torch.randn(shape, generator=gk, device=dev).to(bf16)

        for label, shape in shapes.items():
            Bx, Sqx, Skv, Hx, KVx, hdx = shape
            flash_case(label, shape, bf16, causal=True, blocks=(512, 512))
            if "train" in label:
                bwd_case(label, rand(Bx, Sqx, Hx, hdx),
                         rand(Bx, Skv, KVx, hdx), rand(Bx, Skv, KVx, hdx),
                         rand(Bx, Sqx, Hx, hdx), causal=True, flips=True)
            flush()
            row = {"k7": k7_timing(shape, True, dev, gk, graph_ms, time_ms,
                                   dtype=bf16)}
            if "train" in label:
                row["k89"] = k89_timing(shape, True, dev, gk, graph_ms,
                                        time_ms, dtype=bf16)
            timings[f"{label} bfloat16"] = [row]
            flush()
        seconds["kernels"] = time.perf_counter() - t0

        # -- (a) the smoke cells on the card, counted -----------------------
        t0 = time.perf_counter()
        gf = torch.Generator(device=dev).manual_seed(390)

        def fill(t):
            if t.is_floating_point():
                t.normal_(generator=gf)
            else:
                t.random_(0, cfg.vocab_size, generator=gf)

        L = cfg.n_layers
        want = {"train_4k": {"flash_fwd": 2 * L * 256,
                             "flash_bwd_dq": L * 256,
                             "flash_bwd_dkv": L * 256},
                "prefill_32k": {"flash_fwd": L * 256}, "decode_32k": {}}
        smoke = {}
        for shape in LT_SMOKE_CELLS:
            flush()
            torch.cuda.reset_peak_memory_stats(dev)
            _build.LAUNCHES.clear()
            t1 = time.perf_counter()
            rec = run_cell("qwen3-0.6b", shape, False, "", smoke=True,
                           devices=[dev] * 256, fill=fill)
            sync()
            wall = time.perf_counter() - t1
            got = dict(_build.LAUNCHES)
            launches[f"a {shape}"] = got
            meta, meta_wall = record_of("qwen3-0.6b", shape, True)
            check(got == want[shape], f"phase 39 (a) {shape} launched {got}, "
                  f"not {want[shape]}")
            check(counts(rec) == counts(meta), f"phase 39 (a) {shape}: "
                  f"cuda counts {counts(rec)} differ from meta's "
                  f"{counts(meta)}")
            sizes = ("argument_size_in_bytes", "output_size_in_bytes")
            check(all(rec["memory_analysis"][k] == meta["memory_analysis"][k]
                      for k in sizes),
                  f"phase 39 (a) {shape}: argument/output bytes differ")
            smoke[shape] = {
                "wall_s": wall, "trace_s": rec["compile_s"],
                "meta_trace_s": meta["compile_s"], "meta_wall_s": meta_wall,
                "peak_GB": peak_GB(),
                "argument_GB_x256": rec["memory_analysis"][
                    "argument_size_in_bytes"] * 256 / 1e9,
                "temp_GB_x256_cuda": rec["memory_analysis"][
                    "temp_size_in_bytes"] * 256 / 1e9,
                "temp_GB_x256_meta": meta["memory_analysis"][
                    "temp_size_in_bytes"] * 256 / 1e9,
                "flops_per_shard": rec["hlo_cost"]["flops"],
                "hbm_bytes_per_shard": rec["hlo_cost"]["hbm_bytes"],
                "launches": got, "counts_equal_meta": True}
            emit({"phase": 39, "part": "a", "cell": shape, **smoke[shape]})
        out["a"] = smoke
        seconds["a"] = time.perf_counter() - t0

        # -- (c) state_over_data decode at full width and depth -------------
        t0 = time.perf_counter()
        mesh = make_mesh(DIST_MESH, ("data", "model"))
        check(all(d.type == dev.type and (d.index or 0) == 0
                  for d in mesh.devices),
              f"phase 39: shards off {dev.type}:0: {mesh.devices}")
        sod = {}
        for arch in SOD_ARCHS:
            sod[arch] = sod_run(arch, mesh, dev, device_profile)
            flush()
        out["c"] = sod
        seconds["c"] = time.perf_counter() - t0

        # -- (b) the full-width cells' records ------------------------------
        full = {}
        for arch, shape in LT_CLI_CELLS:
            rec, wall = record_of(arch, shape, False)
            want_c = LT_CLI_COUNTS.get(f"{arch} {shape}")
            check(want_c is not None and counts(rec) == want_c,
                  f"phase 39 (b) {arch} {shape}: counts {counts(rec)} "
                  f"differ from the CPU sweep's {want_c}")
            full[f"{arch} {shape}"] = {
                "wall_s": wall, "trace_s": rec["compile_s"],
                "build_s": rec["lower_s"],
                "state_over_data": rec["state_over_data"],
                "flops_per_shard": rec["hlo_cost"]["flops"],
                "memory_analysis": rec["memory_analysis"]}
        out["b"] = full
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    seconds["total"] = time.perf_counter() - t_start
    emit({"phase": 39, **out, "launches": launches, "kernel_times": timings,
          "seconds": seconds})
    return {"launches": launches, "timings": timings, "seconds": seconds}


def sod_run(arch, mesh, dev, device_profile):
    """Phase 39 (c) for one arch: bf16 at full depth, sharded and unsharded
    from one seeded random cache of SOD_LEN positions, each token held by
    DIST_BF16_RATIO to an fp32 copy of the weights reading the same bf16
    cache; then fp32 sharded and unsharded at SOD_FP32_DEPTH layers
    against float64 by DIST_X, token by token.  The sharded cache's
    pieces are views of
    the one cache (every shard on ``dev``); each run overwrites the
    positions from kv_len before it reads them, and the Mamba states are
    put back between runs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.layers import flatten
    from repro_torch.models.model_zoo import build
    from repro_torch.parallel.sharding import Sharded, Sharder, shard

    bf16, f32, f64 = torch.bfloat16, torch.float32, torch.float64
    rel = dist_rel
    kv0 = SOD_LEN - SOD_TOKENS

    def sync():
        torch.cuda.synchronize(dev)

    def random_cache(model, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        cache = model.init_cache(1, SOD_LEN)
        for _, leaf in flatten(cache):
            leaf.normal_(generator=g)
        return cache

    def sharded_cache(model, sharder, cache):
        specs = dict(flatten(model.cache_dims()))
        out = {}
        for path, leaf in flatten(cache):
            spec = sharder.spec(specs[path], tuple(leaf.shape))
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = Sharded(shard(leaf, spec, mesh), spec,
                                     tuple(leaf.shape), mesh)
        return out

    def saved_states(cache):
        """Clones of the leaves a decode rewrites in place (not the kv)."""
        return {p: t.clone() for p, t in flatten(cache)
                if p[-1] not in ("k", "v")}

    def restore(cache, saved):
        for p, t in flatten(cache):
            if p in saved:
                t.copy_(saved[p])

    def decode(model, cache, toks, sharder=None, profile=False):
        kw = {} if sharder is None else {"sharder": sharder}
        outs = []
        sync()
        t0 = time.perf_counter()
        n = len(toks) - (1 if profile else 0)
        for i in range(n):
            lg, cache = model.decode_step(toks[i], cache, kv0 + i, **kw)
            outs.append(real(lg.gather() if sharder is not None else lg))
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / n
        prof = None
        if profile:
            box = {}

            def last():
                box["lg"] = model.decode_step(toks[n], cache, kv0 + n,
                                              **kw)[0]
            prof = device_profile(last, host=False)
            outs.append(real(box["lg"].gather()))
        return outs, ms, prof

    def real(logits):
        """The logits of the vocab's real rows (the padded ones are
        -1e30)."""
        return logits[:, :cfg.vocab_size]

    cfg = get_config(arch)
    toks = torch.randint(0, cfg.vocab_size, (SOD_TOKENS, 1), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             391))
    sh = Sharder(mesh, cfg.sharding_profile, state_over_data=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    m16 = build(cfg, device=dev, dtype=bf16, generator=gen)
    torch.cuda.reset_peak_memory_stats(dev)
    cache = random_cache(m16, 392)
    scache = sharded_cache(m16, sh, cache)
    specs = {".".join(p): list(leaf.spec) for p, leaf in flatten(scache)}
    check(all(("model", "data") in [tuple(e) if isinstance(e, (list, tuple))
                                    else e for e in v]
              for k, v in specs.items() if k.endswith(("k", "v")))
          and all("data" in v for k, v in specs.items()
                  if k.endswith("state")),
          f"phase 39 (c) {arch}: cache specs {specs}")
    saved = saved_states(cache)
    ls, ms_s, prof = decode(m16, scache, toks, sh, profile=True)
    peak_s = torch.cuda.max_memory_allocated(dev) / 1e9
    restore(cache, saved)
    torch.cuda.reset_peak_memory_stats(dev)
    lu, ms_u, _ = decode(m16, cache, toks)
    peak_u = torch.cuda.max_memory_allocated(dev) / 1e9
    restore(cache, saved)
    # the fp32 copy: the same weights, the Mamba leaves fp32, the kv the
    # same bf16 tensors (its writes rounded to bf16, as the runs' are)
    m32 = build(cfg, device=dev, dtype=f32, generator=torch.Generator(
        device=dev).manual_seed(0))
    m32.load_state_dict(m16.state_dict())
    c32 = {}
    for p, t in flatten(cache):
        node = c32
        for q in p[:-1]:
            node = node.setdefault(q, {})
        node[p[-1]] = t if p[-1] in ("k", "v") else t.float()
    lr, _, _ = decode(m32, c32, toks)
    del m32, c32
    # Token by token: the tp partial products add in fp32 and round once,
    # as JAX's f32 all-reduce does (tests/test_torch_state_over_data.py
    # holds the same decode against JAX's, per token).
    bf16_rows = [{"token": i, "unsharded_vs_fp32": rel(u_, r_),
                  "sharded_vs_fp32": rel(s_, r_),
                  "sharded_vs_unsharded": rel(s_, u_)}
                 for i, (s_, u_, r_) in enumerate(zip(ls, lu, lr))]
    for r in bf16_rows:
        check(r["sharded_vs_fp32"] <= DIST_BF16_RATIO
              * r["unsharded_vs_fp32"], f"phase 39 (c) {arch} bf16 token "
              f"{r['token']}: the sharded decode {r['sharded_vs_fp32']} "
              f"from fp32, past {DIST_BF16_RATIO} x "
              f"{r['unsharded_vs_fp32']}")
    del cache, scache, saved, m16, ls, lu, lr
    torch.cuda.empty_cache()

    # fp32 against float64 at SOD_FP32_DEPTH layers
    cut = dataclasses.replace(cfg, n_layers=SOD_FP32_DEPTH[arch])
    m32 = build(cut, device=dev, dtype=f32, generator=torch.Generator(
        device=dev).manual_seed(0))
    cache = random_cache(m32, 393)
    scache = sharded_cache(m32, sh, cache)
    saved = saved_states(cache)
    t2 = toks[:SOD_FP32_TOKENS]
    ls, _, _ = decode(m32, scache, t2, sh)
    restore(cache, saved)
    lu, _, _ = decode(m32, cache, t2)
    restore(cache, saved)
    del scache
    c64 = {}
    for p, t in flatten(cache):
        node = c64
        for q in p[:-1]:
            node = node.setdefault(q, {})
        node[p[-1]] = t.double()
    del cache, saved
    m64 = type(m32)(cut, device=dev, dtype=f64)
    m64.load_state_dict(m32.state_dict())
    del m32
    with widened64():
        l64, _, _ = decode(m64, c64, t2)
    del m64, c64
    fp32_rows = []
    for i, (s_, u_, r_) in enumerate(zip(ls, lu, l64)):
        d_u, d_s = rel(u_, r_), rel(s_, u_)
        fp32_rows.append({"token": i, "unsharded_vs_f64": d_u,
                          "sharded_vs_unsharded": d_s,
                          "sharded_vs_f64": rel(s_, r_)})
        check(d_s <= DIST_X * d_u, f"phase 39 (c) {arch} fp32 token {i}: "
              f"sharded {d_s} from unsharded, past {DIST_X} x {d_u}")
    torch.cuda.empty_cache()
    return {"n_layers": cfg.n_layers, "positions": SOD_LEN,
            "cache_specs": specs, "ms_per_token_sharded": ms_s,
            "ms_per_token_unsharded": ms_u, "peak_GB_sharded": peak_s,
            "peak_GB_unsharded": peak_u,
            "sharded_step_idle_share": prof["device_idle_share"],
            "sharded_step_device_ms": prof["device_ms"],
            "bf16": bf16_rows, "fp32_layers": cut.n_layers,
            "fp32": fp32_rows}


def launch_kernel_rows(lt, entry, case_err):
    """The kernels line's K7-K9 rows at phase 39 (a)'s shard shapes."""
    la = lt["launches"]
    paths = {"pod qwen3-0.6b smoke train shard": {
                 "bfloat16": (la["a train_4k"], la["a train_4k"])},
             "pod qwen3-0.6b smoke prefill shard": {
                 "bfloat16": (la["a prefill_32k"], {})}}
    cases = {"pod qwen3-0.6b smoke train shard":
             "a shard of qwen3-0.6b's smoke train_4k cell on the 16 x 16 "
             "mesh (16 x 4096, 4 q heads on 2 kv heads of 16, whole)",
             "pod qwen3-0.6b smoke prefill shard":
             "a shard of qwen3-0.6b's smoke prefill_32k cell on the 16 x "
             "16 mesh (2 x 32768)"}
    return shard_kernel_rows(lt["timings"], paths, cases, 39, entry,
                             case_err)


def halo_phase(dev, smi, k2):
    """Phase 36, halo distribution on a tile mesh with every tile on
    ``dev``, through the port's entry points: (a) Table 1 through
    ``solve(backend="halo", mesh=make_mesh(HALO_T1_MESH))`` against the
    ``reference`` solve (the same iteration count, the field bit-equal);
    (b) BIG_GRID over HALO_BIG_MESH, HALO_BIG_ITERS steps through
    ``make_plan(backend="halo")`` at each of HALO_BIG_FUSES, bit-equal to
    ``reference``, with ms an iteration, exchanges, the bytes and device
    operations of one exchange and its copy rate, beside K2's stream kernel
    on the same grid (``k2``: phase 7's ms a launch at fuse 1 and 16);
    (c) per-cell taps on HALO_VAR_GRID at fuse HALO_VAR_FUSE against
    ``reference``; (e) phase 6's BATCH Table-1 grids through
    ``make_halo_runner(..., batch_axis="batch")`` on HALO_BATCH_MESH for
    HALO_BATCH_ITERS steps, bit-equal to ``reference``; (d)
    ``autotune_halo_cell`` on HALO_TUNE_GRID.  The path
    runs plain PyTorch: none of K1-K9 may launch (the counts are zeroed
    before and read after).  Returns the phase's record."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.core as T
    from repro_torch.core.autotune import autotune_halo_cell
    from repro_torch.core.distributed import make_halo_runner
    from repro_torch.kernels import _build
    from repro_torch.parallel import exchange_halo_2d, make_mesh

    t_phase = time.perf_counter()
    _build.LAUNCHES.clear()
    lap = T.laplace_jacobi(2)

    def sync():
        torch.cuda.synchronize(dev)

    def event_ms(fn):
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), out

    def device_ops(fn):
        """Device operations ``fn`` launches and their busy ms, traced on
        the device alone."""
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        return (sum(e.count for e in events),
                sum(e.self_device_time_total for e in events) / 1e3)

    def tiles_of(mesh, x):
        n_row, n_col = mesh.shape
        h, w = x.shape[-2] // n_row, x.shape[-1] // n_col
        return [x[..., i * h:(i + 1) * h, j * w:(j + 1) * w].to(d)
                for (i, j), d in zip(itertools.product(range(n_row),
                                                       range(n_col)),
                                     mesh.devices)]

    def exchange_bytes(mesh, x, depth):
        """Bytes the tiles receive from neighbours in one exchange: columns
        of the tile, then rows of the column-augmented tile."""
        n_row, n_col = mesh.shape
        b, h, w = x.shape[0], x.shape[-2] // n_row, x.shape[-1] // n_col
        cols = 2 * (n_col - 1) * n_row * b * h * depth
        rows = 2 * (n_row - 1) * n_col * b * depth * (w + 2 * depth)
        return (cols + rows) * x.element_size()

    def mesh_record(mesh):
        check(all(d == torch.device(dev.type, 0) for d in mesh.devices),
              f"tiles off cuda:0: {mesh.devices}")
        return {"mesh": list(mesh.shape),
                "tile_devices": [str(d) for d in mesh.devices]}

    record = {"phase": 36, "card": smi}

    # (a) Table 1 over 2x2
    mesh4 = make_mesh(HALO_T1_MESH)
    x0 = torch.zeros(64, 64)
    ref = T.solve(lap, x0, backend="reference", device=dev, **TABLE1)
    halo = T.solve(lap, x0, backend="halo", mesh=mesh4, device=dev,
                   **TABLE1)
    check(halo.backend == "halo" and halo.converged,
          f"Table 1 through halo: {halo.backend}, {halo.converged}")
    check(halo.iterations == ref.iterations,
          f"Table 1: halo {halo.iterations} iterations, reference "
          f"{ref.iterations}")
    check(torch.equal(halo.x, ref.x), "Table 1: the halo field differs "
          f"from reference by {float((halo.x - ref.x).abs().max())}")
    record["table1"] = {
        **mesh_record(mesh4), "grid": [64, 64], **TABLE1,
        "fuse": halo.fuse, "iterations": halo.iterations,
        "reference_iterations": ref.iterations,
        "jax_cpu_iterations": TABLE1_ITERS, "bit_equal": True,
        "wall_ms": halo.wall_seconds * 1e3,
        "ms_per_iteration": halo.wall_seconds * 1e3 / halo.iterations,
        "reference_wall_ms": ref.wall_seconds * 1e3}

    # (b) BIG_GRID over 2x4, fuse 1 and 16
    mesh8 = make_mesh(HALO_BIG_MESH)
    gen = torch.Generator(device=dev).manual_seed(36)
    xb = torch.randn((1, *BIG_GRID), generator=gen, device=dev)
    refb = T.stencil_apply(lap, xb, backend="reference", bc=1.0,
                           iters=HALO_BIG_ITERS, device=dev)
    big = []
    for fuse in HALO_BIG_FUSES:
        plan = T.make_plan(lap, BIG_GRID, backend="halo", bc=1.0,
                           iters=HALO_BIG_ITERS, fuse=fuse, mesh=mesh8,
                           device=dev)
        check(torch.equal(plan(xb), refb),
              f"8192x8192 halo fuse {fuse} differs from reference")
        ms, out = event_ms(lambda: plan(xb))
        check(torch.equal(out, refb), f"8192x8192 halo fuse {fuse}, rerun")
        del out
        ops, busy = device_ops(lambda: plan(xb))
        tiles = tiles_of(mesh8, T.DirichletBC(1.0).set_boundary(xb, 2))
        depth = lap.radius * fuse
        ex_ms, _ = event_ms(lambda: exchange_halo_2d(tiles, *mesh8.shape,
                                                     depth))
        ex_ops, ex_busy = device_ops(
            lambda: exchange_halo_2d(tiles, *mesh8.shape, depth))
        nbytes = exchange_bytes(mesh8, xb, depth)
        del tiles
        k2_ms = k2[fuse]
        big.append({
            **mesh_record(mesh8), "grid": list(BIG_GRID),
            "tile": [BIG_GRID[0] // HALO_BIG_MESH[0],
                     BIG_GRID[1] // HALO_BIG_MESH[1]],
            "iterations": HALO_BIG_ITERS, "fuse": fuse, "bit_equal": True,
            "ms": ms, "ms_per_iteration": ms / HALO_BIG_ITERS,
            "device_ops_per_iteration": ops / HALO_BIG_ITERS,
            "device_busy_ms": busy, "exchanges": HALO_BIG_ITERS // fuse,
            "bytes_per_exchange": nbytes, "device_ops_per_exchange": ex_ops,
            "exchange_ms": ex_ms, "exchange_busy_ms": ex_busy,
            "exchange_copy_GBps": (nbytes / (ex_busy * 1e-3) / 1e9
                                   if ex_busy else None),
            "k2_stream_ms_per_launch": k2_ms,
            "k2_stream_ms_per_iteration": k2_ms / fuse,
            "ratio_to_k2": ms / HALO_BIG_ITERS / (k2_ms / fuse)})
        del plan
    record["big"] = big
    del xb, refb
    torch.cuda.empty_cache()

    # (c) per-cell taps over 2x4
    rng = np.random.default_rng(36)
    het = T.heterogeneous_jacobi(1.0 + 9.0 * rng.random(HALO_VAR_GRID))
    xv = torch.randn((1, *HALO_VAR_GRID), generator=gen, device=dev)
    plan = T.make_plan(het, HALO_VAR_GRID, backend="halo", bc=1.0,
                       iters=HALO_BIG_ITERS, fuse=HALO_VAR_FUSE, mesh=mesh8,
                       device=dev)
    refv = T.stencil_apply(het, xv, backend="reference", bc=1.0,
                           iters=HALO_BIG_ITERS, device=dev)
    ms, out = event_ms(lambda: plan(xv))
    check(torch.equal(out, refv), "per-cell taps: the halo field differs "
          f"from reference by {float((out - refv).abs().max())}")
    record["fields"] = {**mesh_record(mesh8), "grid": list(HALO_VAR_GRID),
                        "field_taps": het.num_variable_taps,
                        "iterations": HALO_BIG_ITERS, "fuse": HALO_VAR_FUSE,
                        "bit_equal": True, "ms": ms,
                        "ms_per_iteration": ms / HALO_BIG_ITERS}

    # (e) phase 6's batch of Table-1 grids, split over a third mesh axis
    shape, names = HALO_BATCH_MESH
    mesh3 = make_mesh(shape, names)
    check(all(d == torch.device(dev.type, 0) for d in mesh3.devices),
          f"tiles off cuda:0: {mesh3.devices}")
    run3 = make_halo_runner(mesh3, lap, H=64, W=64, bc_value=1.0,
                            iterations=HALO_BATCH_ITERS, fuse=HALO_BATCH_FUSE,
                            row_axis="data", col_axis="model",
                            batch_axis="batch")
    xt = torch.zeros((BATCH, 64, 64), device=dev)
    ms, out = event_ms(lambda: run3(xt))
    ref3 = T.stencil_apply(lap, xt, backend="reference", bc=1.0,
                           iters=HALO_BATCH_ITERS, device=dev)
    check(torch.equal(out, ref3), "batch over 2x2x2: the halo field "
          f"differs from reference by {float((out - ref3).abs().max())}")
    record["batch_axis"] = {
        "mesh": list(shape), "axes": list(names),
        "tile_devices": sorted({str(d) for d in mesh3.devices}),
        "instances": BATCH, "grid": [64, 64], "iterations": HALO_BATCH_ITERS,
        "fuse": HALO_BATCH_FUSE, "bit_equal": True, "ms": ms,
        "ms_per_iteration": ms / HALO_BATCH_ITERS}
    del xt, out, ref3

    # (d) the autotuner's halo sweep
    table = autotune_halo_cell(lap, HALO_TUNE_GRID, mesh8,
                               iters=HALO_TUNE_ITERS, device=dev)
    fuses = sorted(e.fuse for e in table.entries)
    check(fuses == [1, 2, 4, 8], f"autotune_halo_cell measured {fuses}")
    check(all(tuple(e.mesh) == HALO_BIG_MESH and not e.interpreted
              for e in table.entries), "halo entries without their mesh")
    best = table.lookup(table.entries[0].device_kind,
                        table.entries[0].family, HALO_TUNE_GRID,
                        table.entries[0].dtype, mesh_shape=HALO_BIG_MESH)
    record["autotune"] = {
        **mesh_record(mesh8), "grid": list(HALO_TUNE_GRID),
        "iters": HALO_TUNE_ITERS,
        "us_per_iter": {e.fuse: e.us_per_iter for e in sorted(
            table.entries, key=lambda e: e.fuse)},
        "best_fuse": best.fuse}

    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    check(not launched, f"the halo path launched {launched}")
    record["launches"] = launched
    record["seconds"] = time.perf_counter() - t_phase
    check(record["seconds"] < HALO_SECONDS,
          f"phase 36 took {record['seconds']} s")
    return record


def stencil_counts_phase(dev, lap, lap3, table1_x, xd, matrix):
    """Phase 40, the stencil tiers counted: each tier's run of phases 3-10
    once as the phase runs it, then under ``launch.hlo_cost.CostCounter``
    on ``dev``, then the same entry point on ``meta`` (which prices and
    plans as the card: the tuned table's pick included).  Holds the count
    on cuda equal to meta's, key by key; the launches under the counter
    those of the uncounted run; the counted result bit-equal to the
    uncounted one and held to its plain version as its phase holds it;
    nothing launched on meta.  K1-K5 charge their operands' and result's
    bytes once a call, K5 its 2·S·N² flops.  The tiers: (a) Table 1
    through ``auto`` to convergence (TABLE1 with max_iters TABLE1_ITERS,
    so meta, which cannot test convergence, runs the same chunks); (b)
    HET_GRID's per-cell taps, 200 steps of K1; (c) BIG_GRID, 1024 steps at
    fuse 16 (K2); (d) one K4 sweep of PAPER_BATCH Fig-6 grids; (e) the
    dense row, DENSE_ITERS products on DENSE_BATCH instances (K5 fp32)."""
    import numpy as np
    import torch

    import repro_torch.core as T
    from repro_torch.kernels import (_build, dense_jacobi_kernel, jacobi2d,
                                     stencil2d_plain, stencil3d_plain)
    from repro_torch.launch.hlo_cost import CostCounter

    t_phase = time.perf_counter()
    meta = torch.device("meta")

    def sync():
        torch.cuda.synchronize(dev)

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    def run(fn, count):
        """(fn's result, its count or None, the launches it made)."""
        before = dict(_build.LAUNCHES)
        if count:
            with CostCounter() as c:
                out = fn()
        else:
            out, c = fn(), None
        if dev.type == "cuda":
            sync()
        return out, c and c.result(), {
            k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
            if v != before.get(k, 0)}

    tiers = {}

    def tier(name, on, hold):
        """``on(device)`` -> a thunk running the tier there, returning its
        field; ``hold(field)`` -> the error its phase holds."""
        t0 = time.perf_counter()
        ref, _, want = run(on(dev), False)
        out, count, got = run(on(dev), True)
        _, mcount, mgot = run(on(meta), True)
        check(count == mcount, f"phase 40 {name}: cuda counts {count}, "
              f"meta {mcount}")
        check(got == want and got, f"phase 40 {name}: launches {got} "
              f"under the counter, {want} without")
        check(not mgot, f"phase 40 {name}: meta launched {mgot}")
        check(torch.equal(out, ref), f"phase 40 {name}: the counted run "
              f"differs from the uncounted one")
        tiers[name] = {"flops": count["flops"],
                       "hbm_bytes": count["hbm_bytes"], "launches": got,
                       "hold": hold(out),
                       "seconds": time.perf_counter() - t0}

    # (a) Table 1 through auto, to convergence
    t1 = dict(TABLE1, max_iters=TABLE1_ITERS)
    solvers = {d.type: T.Solver(lap, (64, 64), backend="auto", device=d,
                                **t1) for d in (dev, meta)}
    picks = {k: (s.backend, s.fuse, s.plan.rim) for k, s in solvers.items()}
    check(picks["meta"] == picks[dev.type],
          f"phase 40 (a): auto picks {picks}")

    def table1(d):
        def go():
            x, iters, done, _ = solvers[d.type].run(
                torch.zeros(64, 64, device=d))
            if d.type != "meta":
                check(bool(done) and int(iters) == TABLE1_ITERS,
                      f"phase 40 (a): {int(iters)} iterations")
            return x
        return go

    def t1_hold(x):
        e = err(x, table1_x)
        check(e <= TOL["float32"], f"phase 40 (a) vs phase 3: {e}")
        return e
    tier("table1_auto", table1, t1_hold)
    check(any(k.startswith("jacobi2d_resident")
              for k in tiers["table1_auto"]["launches"]),
          f"phase 40 (a) launched {tiers['table1_auto']['launches']}")
    tiers["table1_auto"]["pick"] = list(picks[dev.type])

    # (b) per-cell taps, 200 steps of K1
    kappa = 1.0 + 9.0 * np.random.default_rng(0).random(HET_GRID)
    het = T.heterogeneous_jacobi(kappa)
    het_solvers = {d.type: T.Solver(het, HET_GRID, backend="cuda", bc=1.0,
                                    rtol=None, atol=None, max_iters=200,
                                    fuse=1, device=d) for d in (dev, meta)}

    def k1(d):
        return lambda: het_solvers[d.type].run(
            torch.zeros(1, *HET_GRID, device=d))[0]

    def k1_hold(x):
        y = T.DirichletBC(1.0).set_boundary(
            torch.zeros(1, *HET_GRID, device=dev), 2)
        f = torch.as_tensor(het.field_stack(), device=dev)
        for _ in range(200):
            y = stencil2d_plain(y, het, bc_value=1.0, fields=f)
        e = err(x, y)
        check(e <= TOL["float32"], f"phase 40 (b) vs plain: {e}")
        return e
    tier("k1_fields_1024", k1, k1_hold)

    # (c) BIG_GRID at fuse 16 (K2)
    xb = torch.rand((1, *BIG_GRID), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    big_plans = {d.type: T.make_plan(lap, BIG_GRID, backend="cuda_fused",
                                     bc=1.0, iters=1024, fuse=16, device=d)
                 for d in (dev, meta)}

    def k2(d):
        x = xb if d.type != "meta" else torch.empty(xb.shape, device=d)
        return lambda: big_plans[d.type](x)

    def k2_hold(x):
        check(bool(torch.isfinite(x).all()), "phase 40 (c) not finite")
        return "finite, as phase 5"
    tier("k2_8192_fuse16", k2, k2_hold)
    del xb
    torch.cuda.empty_cache()

    # (d) one K4 sweep of PAPER_BATCH Fig-6 grids
    x3 = T.DirichletBC(1.0).set_boundary(torch.rand(
        (PAPER_BATCH, *FIG6_GRID), device=dev,
        generator=torch.Generator(device=dev).manual_seed(3)), 3)
    plans3 = {d.type: T.make_plan(lap3, FIG6_GRID, backend="cuda", bc=1.0,
                                  iters=1, device=d) for d in (dev, meta)}

    def k4(d):
        x = x3 if d.type != "meta" else torch.empty(x3.shape, device=d)
        return lambda: plans3[d.type](x)

    def k4_hold(x):
        e = err(x[:CHECK_SLICE], stencil3d_plain(x3[:CHECK_SLICE], lap3,
                                                  bc_value=1.0))
        check(e == 0.0, f"phase 40 (d) vs plain: {e}")
        return e
    tier("k4_fig6_50000", k4, k4_hold)
    del x3
    torch.cuda.empty_cache()

    # (e) the dense row (K5 fp32)
    def k5(d):
        if d.type == "meta":
            x, m = (torch.empty(t.shape, device=d) for t in (xd, matrix))
        else:
            x, m = xd, matrix
        return lambda: dense_jacobi_kernel(x, m, iterations=DENSE_ITERS)

    def k5_hold(x):
        e = err(x, jacobi2d(xd, lap, bc_value=1.0, iterations=DENSE_ITERS))
        check(e <= 1e-5, f"phase 40 (e) vs jacobi2d: {e}")
        return e
    tier("k5_dense_65536", k5, k5_hold)
    check(tiers["k5_dense_65536"]["flops"] == DENSE_ITERS * 2 * DENSE_BATCH
          * (64 * 64) ** 2, f"phase 40 (e) flops "
          f"{tiers['k5_dense_65536']['flops']}")
    seconds = time.perf_counter() - t_phase
    check(seconds < STENCIL_COUNT_SECONDS, f"phase 40 took {seconds} s")
    return {"phase": 40, "tiers": tiers, "seconds": seconds}


def api_phase(smi):
    """Phase 41, the names the port gained to cover the JAX package's
    public API, run with ``device=None`` (the card) and each held against
    its run on the CPU: (a) ``stencil_apply`` of ``causal_conv1d_spec``
    through ``auto`` on API_CONV; (b) ``dense_jacobi_with_bc`` at Table
    1's 64x64 for DENSE_ITERS; (c) Table 1's TABLE1_ITERS steps through
    ``stencil_apply(tuned=)``, the committed table loaded (its schedule,
    K3) and None (the roofline's pick), each bit-equal to ``reference``
    on the card.  The launch counts are zeroed before each part and read
    after it.  Returns the phase's record."""
    import numpy as np
    import torch

    import repro_torch.core as T
    from repro_torch.core import autotune as TA
    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")

    def err(a, b):
        return float((a.float().cpu() - b.float().cpu()).abs().max())

    def on_card(fn):
        """(fn()'s result, the launches it made), the counts zeroed."""
        _build.LAUNCHES.clear()
        out = fn()
        torch.cuda.synchronize()
        check(out.device.type == "cuda", f"phase 41 ran on {out.device}")
        return out, dict(_build.LAUNCHES)

    def pick(spec, grid, **kw):
        plan = T.make_plan(spec, grid, backend="auto", **kw)
        return {"source": plan.source, "backend": plan.backend,
                "fuse": plan.fuse, "rim": plan.rim}

    rec = {"phase": 41, "nvidia_smi": smi}
    rng = np.random.default_rng(41)

    # (a) the causal conv1d stencil through auto, on the card and the CPU
    t0 = time.perf_counter()
    conv = T.causal_conv1d_spec([0.1, 0.2, 0.3, 0.4])
    xa = rng.standard_normal(API_CONV, dtype=np.float32)
    kw = dict(backend="auto", bc=1.5, iters=2)
    out, launched = on_card(lambda: T.stencil_apply(conv, xa, **kw))
    want = T.stencil_apply(conv, xa, device=cpu, **kw)
    e = err(out, want)
    check(tuple(out.shape) == API_CONV and e <= TOL["float32"],
          f"phase 41 (a): shape {tuple(out.shape)}, vs the CPU {e}")
    check(not launched, f"phase 41 (a) launched {launched}")
    rec["a"] = {"grids": API_CONV[0], "cells": API_CONV[1],
                "pick": pick(conv, API_CONV[1:], bc=1.5, iters=2),
                "max_abs_err_vs_cpu": e,
                "seconds": time.perf_counter() - t0}
    del out, want, xa

    # (b) the dense encoding with its BCs, Table 1's grid, 7 iterations
    t0 = time.perf_counter()
    lap, bc = T.laplace_jacobi(2), T.DirichletBC(1.0)
    xb = rng.random((16, 64, 64), dtype=np.float32)
    out, launched = on_card(lambda: T.dense_jacobi_with_bc(
        xb, lap, bc, DENSE_ITERS))
    want = T.dense_jacobi_with_bc(xb, lap, bc, DENSE_ITERS, device=cpu)
    e = err(out, want)
    check(tuple(out.shape) == xb.shape and e <= TOL["float32"],
          f"phase 41 (b): shape {tuple(out.shape)}, vs the CPU {e}")
    check(not launched, f"phase 41 (b) launched {launched}")
    rec["b"] = {"instances": xb.shape[0], "matrix": [64 * 64] * 2,
                "iterations": DENSE_ITERS, "max_abs_err_vs_cpu": e,
                "seconds": time.perf_counter() - t0}

    # (c) Table 1 through stencil_apply(tuned=): the table, the roofline
    t0 = time.perf_counter()
    table = T.TunedTable.load(os.path.join(ROOT, "TUNED_stencil_cuda.json"))
    x0 = torch.zeros(64, 64)
    kw = dict(bc=TABLE1["bc"], iters=TABLE1_ITERS)
    ref, _ = on_card(lambda: T.stencil_apply(lap, x0, backend="reference",
                                             **kw))
    rec["c"] = {"iterations": TABLE1_ITERS}
    for name, tuned in (("tuned", table), ("roofline", None)):
        out, launched = on_card(lambda: T.stencil_apply(
            lap, x0, backend="auto", tuned=tuned, **kw))
        chosen = pick(lap, (64, 64), tuned=tuned, **kw)
        e = err(out, ref)
        check(e == 0.0, f"phase 41 (c) {name} ({chosen}) vs reference: {e}")
        rec["c"][name] = {"pick": chosen, "launches": launched,
                          "max_abs_err_vs_reference": e}
    best = table.lookup(TA.device_kind(), TA.spec_family(lap), (64, 64),
                        "float32")
    check(best is not None, f"phase 41 (c): the table has no entry for "
          f"{TA.device_kind()}")
    tuned = rec["c"]["tuned"]
    check(tuned["pick"]["source"] == "tuned"
          and (tuned["pick"]["backend"], tuned["pick"]["rim"])
          == (best.backend, best.rim),
          f"phase 41 (c) picked {tuned['pick']}, the table's best is "
          f"{best}")
    check(any(k.startswith("jacobi2d_resident") for k in tuned["launches"]),
          f"phase 41 (c) launched {tuned['launches']}, no K3")
    rec["c"]["seconds"] = time.perf_counter() - t0
    rec["seconds"] = time.perf_counter() - t_phase
    check(rec["seconds"] < API_SECONDS, f"phase 41 took {rec['seconds']} s")
    return rec


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write-tuned", metavar="PATH", default=None,
                    help="save phase 20's Table-1 and Fig-6 measurements "
                         "there (the source of TUNED_stencil_cuda.json)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import torch.nn.functional as F

    import repro_torch.core as T
    from repro_torch.kernels import (_build, dense_jacobi_kernel,
                                     dense_stencil_matmul,
                                     dense_stencil_plain, jacobi2d,
                                     jacobi2d_fused_plain,
                                     jacobi2d_fused_step, split_bf16x3,
                                     stencil2d, stencil2d_plain, stencil3d,
                                     stencil3d_plain)
    from repro_torch.kernels.dense_stencil import (dense_stencil_split_plain,
                                                   launch_split, padded_cols)
    from repro_torch.kernels.jacobi_fused import COUNTERS as K23_COUNTERS
    from repro_torch.kernels.jacobi_fused import (kernel_for,
                                                  trapezoid_passes)

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_dense_cases import (GEMM_SHAPES, K5_NORM_ERR, W_PIECES_ULPS,
                                    max_ulps, perm_exact_case, w_pieces_case)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def sync():
        torch.cuda.synchronize()

    def time_ms(fn, reps, warmup=1):
        for _ in range(warmup):
            fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(fn, reps, x=None):
        """Device ms of one call of ``fn``: ``reps`` calls captured in one
        CUDA graph and replayed, so the host's time between launches (the
        wrappers' Python) does not count as the kernel's.  Given ``x``, the
        calls chain y = fn(y) from it (memory: two outputs at a time)."""
        step = fn if x is not None else (lambda _: fn())
        step(x)  # warm: library and module load, allocator
        sync()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = x
            for _ in range(reps):
                y = step(y)
        del y
        graph.replay()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        del graph
        torch.cuda.empty_cache()
        return start.elapsed_time(end) / reps

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    # -- 1. the card and the build ---------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for name in libs for ln in _build.build_log(name)
             .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": 1, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_s": build_s, "libraries": sorted(libs), "ptxas": ptxas})

    # -- 2. each kernel against its plain version ---------------------------
    rng = np.random.default_rng(0)

    def specs(grid):
        kappa = 1.0 + 9.0 * rng.random(grid)
        return {
            "laplace_bc": (T.laplace_jacobi(2), 1.5),
            "laplace_raw": (T.laplace_jacobi(2), None),
            "fields_bc": (T.heterogeneous_jacobi(kappa), 1.5),
            "star_r2_bc": (T.star(2, [0.15, 0.05], center=0.2), 1.5),
            "box_raw": (T.box(2), None),
        }

    def field(shape, dtype=torch.float32):
        g = torch.Generator(device=dev).manual_seed(1)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    worst = {}   # kernel -> {dtype: max error}
    ratio = {}   # kernel -> {dtype: max error / its per-element bound}
    cases = {}
    case_err = {}   # (kernel, case label, dtype) -> max error

    def record(kernel, dtype, out, plain, label, tol=None):
        """Hold ``out`` to ``plain`` element by element, within atol +
        rtol * |plain| (``tol``: dtype -> (atol, rtol); default TOL, 0)."""
        key = str(dtype).split(".")[1]
        atol, rtol = (TOL[key], 0.0) if tol is None else tol[key]
        diff = (out.float() - plain.float()).abs()
        bound = atol + rtol * plain.float().abs()
        bad = int((diff > bound).sum())
        e, r = float(diff.max()), float((diff / bound).max())
        del diff, bound
        check(bad == 0, f"{kernel} {label} {key}: {bad} elements past "
              f"{atol} + {rtol} * |plain|, max error {e}")
        case_err[(kernel, label, key)] = e
        w = worst.setdefault(kernel, {"float32": 0.0, "bfloat16": 0.0})
        w[key] = max(w[key], e)
        w = ratio.setdefault(kernel, {"float32": 0.0, "bfloat16": 0.0})
        w[key] = max(w[key], r)
        cases[kernel] = cases.get(kernel, 0) + 1
        return e

    for shape in ((3, 33, 57), (2, *HET_GRID)):
        for name, (spec, bc) in specs(shape[1:]).items():
            for dtype in (torch.float32, torch.bfloat16):
                x = field(shape, dtype)
                out = stencil2d(x, spec, bc_value=bc)
                sync()
                record("stencil2d", dtype, out,
                       stencil2d_plain(x, spec, bc_value=bc),
                       f"{name} {shape}")
        # K2 by name: the stream kernel, and the tile kernel before it.
        sp = specs(shape[1:])
        for kernel in ("stream", "tile"):
            for fuse in (1, 2, 4, 8, 16):
                for name in ("laplace_bc", "fields_bc"):
                    spec, bc = sp[name]
                    x = field(shape)
                    out = jacobi2d_fused_step(x, spec, fuse=fuse, bc_value=bc,
                                              kernel=kernel)
                    sync()
                    record(K23_COUNTERS[kernel], torch.float32, out,
                           jacobi2d_fused_plain(x, spec, fuse=fuse,
                                                bc_value=bc),
                           f"{name} fuse={fuse} {shape}")
            x = field(shape, torch.bfloat16)
            spec, bc = sp["star_r2_bc"]
            out = jacobi2d_fused_step(x, spec, fuse=8, bc_value=bc,
                                      kernel=kernel)
            sync()
            record(K23_COUNTERS[kernel], torch.bfloat16, out,
                   jacobi2d_fused_plain(x, spec, fuse=8, bc_value=bc),
                   f"star_r2_bc fuse=8 {shape}")
    # K3 by name: the register kernel on the tables and grids it takes, the
    # cta kernel and the one-CTA kernel before both on every table.
    one_cta = {"resident_regs": ((64, 64), (128, 128)),
               "resident_cta": ((64, 64), (160, 160)),
               "resident_smem": ((64, 64), (160, 160))}
    for kernel, grids in one_cta.items():
        for grid in grids:
            sp = specs(grid)
            names = (("laplace_bc", "fields_bc", "box_raw")
                     if kernel == "resident_regs" else
                     ("laplace_bc", "fields_bc", "star_r2_bc", "box_raw"))
            for fuse in (1, 8, 64, 512):
                for name in names:
                    spec, bc = sp[name]
                    x = field((2, *grid))
                    out = jacobi2d_fused_step(x, spec, fuse=fuse, bc_value=bc,
                                              rim="resident", kernel=kernel)
                    sync()
                    record(K23_COUNTERS[kernel], torch.float32, out,
                           jacobi2d_fused_plain(x, spec, fuse=fuse,
                                                bc_value=bc),
                           f"{name} fuse={fuse} {grid}")
            x = field((2, *grid), torch.bfloat16)
            spec, bc = sp["laplace_bc"]
            out = jacobi2d_fused_step(x, spec, fuse=64, bc_value=bc,
                                      rim="resident", kernel=kernel)
            sync()
            record(K23_COUNTERS[kernel], torch.bfloat16, out,
                   jacobi2d_fused_plain(x, spec, fuse=64, bc_value=bc),
                   f"laplace_bc fuse=64 {grid}")

    def specs3(grid):
        kappa = 1.0 + 9.0 * rng.random(grid)
        return {
            "laplace_bc": (T.laplace_jacobi(3), 1.5),
            "laplace_raw": (T.laplace_jacobi(3), None),
            "fields_bc": (T.heterogeneous_jacobi(kappa), 1.5),
            "fields_raw": (T.heterogeneous_jacobi(kappa), None),
            "star_r2_bc": (T.star(3, [0.15, 0.05], center=0.2), 1.5),
            "box_raw": (T.box(3), None),
        }

    for shape in ((2, 6, 10, 12), (1, 10, 33, 57), (3, *FIG6_GRID)):
        for name, (spec, bc) in specs3(shape[1:]).items():
            for dtype in (torch.float32, torch.bfloat16):
                x = field(shape, dtype)
                out = stencil3d(x, spec, bc_value=bc)
                sync()
                record("stencil3d", dtype, out,
                       stencil3d_plain(x, spec, bc_value=bc),
                       f"{name} {shape}")
    check(worst["stencil3d"]["float32"] == 0.0,
          f"K4 fp32 is not bit-equal: {worst['stencil3d']['float32']}")

    # Past the kernels' former limits: tap tables larger than the
    # parameter space holds (the radius-3 boxes, 49 taps in 2D and 343 in
    # 3D, from a device array), and trapezoids deeper than one CTA's shared
    # memory (fuse 64: passes of 32 + 32 at radius 1, 22 + 21 + 21 at
    # radius 2, handing each other fp32).  fp32 to 0.0, bf16 within TOL.
    def box_r3(ndim):
        n = 7 ** ndim
        return T.StencilSpec({o: 1.0 / n for o in itertools.product(
            range(-3, 4), repeat=ndim)})

    limits = {}

    def limit_case(kernel, label, dtype, out, plain):
        e = record(kernel, dtype, out, plain, label)
        check(dtype == torch.bfloat16 or e == 0.0,
              f"{kernel} {label} fp32 is not bit-equal: {e}")
        limits[f"{kernel} {label} {str(dtype).split('.')[1]}"] = e

    for dtype in (torch.float32, torch.bfloat16):
        box2, box3 = box_r3(2), box_r3(3)
        x = field((2, 64, 64), dtype)
        out = stencil2d(x, box2, bc_value=1.5)
        sync()
        limit_case("stencil2d", "box_r3 49 taps", dtype, out,
                   stencil2d_plain(x, box2, bc_value=1.5))
        out = jacobi2d_fused_step(x, box2, fuse=4, bc_value=1.5,
                                  kernel="stream")
        sync()
        limit_case("jacobi2d_trapezoid", "box_r3 49 taps fuse=4", dtype, out,
                   jacobi2d_fused_plain(x, box2, fuse=4, bc_value=1.5))
        x = field((2, *FIG6_GRID), dtype)
        out = stencil3d(x, box3, bc_value=1.5)
        sync()
        limit_case("stencil3d", "box_r3 343 taps", dtype, out,
                   stencil3d_plain(x, box3, bc_value=1.5))
        for r, spec in ((1, T.laplace_jacobi(2)),
                        (2, T.star(2, [0.15, 0.05], center=0.2))):
            x = field((2, 300, 260), dtype)
            key = K23_COUNTERS[kernel_for("trapezoid", spec, 64, *x.shape)]
            k2_before = _build.LAUNCHES[key]
            out = jacobi2d_fused_step(x, spec, fuse=64, bc_value=1.5)
            sync()
            passes = _build.LAUNCHES[key] - k2_before
            check(passes == r + 1, f"fuse 64 radius {r}: {passes} launches")
            limit_case(key, f"fuse=64 radius {r}", dtype, out,
                       jacobi2d_fused_plain(x, spec, fuse=64, bc_value=1.5))
        # Resident grids past one CTA, up to the JAX package's 8 MiB
        # (1024x2048): the grid-wide kernel.
        for grid, fuses in RESIDENT_GRIDS:
            for fuse in fuses:
                x = field((1, *grid), dtype)
                k_before = _build.LAUNCHES["jacobi2d_resident_grid"]
                out = jacobi2d_fused_step(x, T.laplace_jacobi(2), fuse=fuse,
                                          bc_value=1.5, rim="resident")
                sync()
                check(_build.LAUNCHES["jacobi2d_resident_grid"]
                      == k_before + 1, f"resident {grid} took another kernel")
                limit_case("jacobi2d_resident_grid",
                           f"resident {grid[0]}x{grid[1]} fuse={fuse}", dtype,
                           out, jacobi2d_fused_plain(x, T.laplace_jacobi(2),
                                                     fuse=fuse, bc_value=1.5))

    def gemm_case(s_rows, n, dtype):
        x = field((s_rows, n), dtype)
        w = field((n, n), dtype) / n ** 0.5
        out = dense_stencil_matmul(x, w)
        sync()
        record("dense_stencil_matmul", dtype, out, dense_stencil_plain(x, w),
               f"({s_rows},{n})", GEMM_TOL)

    designed = {}
    for s_rows, n in GEMM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            gemm_case(s_rows, n, dtype)
        # fp32 K5 against dense_stencil_split_plain, the same six piece
        # products in plain PyTorch: within K5_NORM_ERR of |x| . |W|.
        x = field((s_rows, n))
        w = field((n, n)) / n ** 0.5
        gap = (dense_stencil_matmul(x, w).double()
               - dense_stencil_split_plain(x, w).double()).abs()
        gap = float((gap / (x.double().abs() @ w.double().abs())).max())
        check(gap <= K5_NORM_ERR,
              f"K5 ({s_rows},{n}) vs its split arithmetic: {gap}")
        designed[f"vs split_plain ({s_rows},{n}) norm_err"] = gap
        # The split kernel against its plain version: bit-equal.
        v = field((s_rows, n))
        cols = padded_cols(n)
        record("split_bf16x3", torch.float32, launch_split(v, cols).float(),
               split_bf16x3(v, cols).float(), f"({s_rows},{n})")
        check(worst["split_bf16x3"]["float32"] == 0.0,
              f"split_bf16x3 ({s_rows},{n}) is not bit-equal")
    # fp32 K5's designed cases: W a permutation (0.0) and W a permutation
    # times full-mantissa scalars (within W_PIECES_ULPS fp32 ulps).
    for s_rows, n in GEMM_SHAPES[2:4]:
        x, w, exact = perm_exact_case(s_rows, n, seed=n, device=dev)
        e = err(dense_stencil_matmul(x, w), exact)
        check(e == 0.0 and err(dense_stencil_split_plain(x, w), exact)
              == 0.0, f"K5 perm_exact ({s_rows},{n}): {e}")
        designed[f"perm_exact ({s_rows},{n}) max_abs_err"] = e
        x, w, exact = w_pieces_case(s_rows, n, seed=n, device=dev)
        u = max_ulps(dense_stencil_matmul(x, w), exact)
        check(u <= W_PIECES_ULPS, f"K5 w_pieces ({s_rows},{n}): {u} ulps")
        designed[f"w_pieces ({s_rows},{n}) max_ulps"] = u
    emit({"phase": 2, "cases": cases, "max_abs_err": worst, "tol": TOL,
          "gemm_tol": GEMM_TOL, "k5_designed": designed,
          "past_former_limits": limits})

    # -- 3-6. the main path, with the launch counts from zero ----------------
    _build.LAUNCHES.clear()
    lap = T.laplace_jacobi(2)

    solves, cold_ms = {}, {}
    for backend in ("cuda_fused", "cuda", "conv", "reference"):
        # Twice: the first solve pays one-time costs (library load, cuDNN
        # set-up, allocator growth); the second is the one reported.  The
        # fuse depth is the roofline's (tuned=None), the schedule phases 3-7
        # have always measured; the tuned table's is the auto solve below.
        solver = T.Solver(lap, (64, 64), backend=backend, device=dev,
                          tuned=None, **TABLE1)
        cold_ms[backend] = solver.solve(
            torch.zeros(64, 64)).wall_seconds * 1e3
        before = dict(_build.LAUNCHES)
        r = solver.solve(torch.zeros(64, 64))
        if backend == "cuda_fused":   # this solve's own launches
            t1_launches = {k: v - before.get(k, 0)
                           for k, v in _build.LAUNCHES.items()
                           if v != before.get(k, 0)}
        check(r.converged and r.x.shape == (64, 64)
              and bool(torch.isfinite(r.x).all()), f"table1 {backend}")
        check(abs(r.iterations - TABLE1_ITERS) <= TABLE1["check_every"],
              f"table1 {backend}: {r.iterations} iterations")
        solves[backend] = r
    ref = solves["reference"]
    for backend, r in solves.items():
        # Iterates a chunk apart differ by at most that chunk's residual.
        chunks = abs(r.iterations - ref.iterations) // TABLE1["check_every"]
        check(err(r.x, ref.x) <= TOL["float32"] + chunks * 2 * ref.residual,
              f"table1 {backend} field vs reference")
    n_iters = solves["cuda_fused"].iterations
    # backend="auto" through the committed tuned table
    # (TUNED_stencil_cuda.json, measured on an H100 by phase 20's
    # autotune_cell): the schedule it picked, at the CPU's exact count.
    auto = T.Solver(lap, (64, 64), backend="auto", device=dev, **TABLE1)
    auto_r = auto.solve(torch.zeros(64, 64))
    check(auto_r.converged and auto_r.iterations == TABLE1_ITERS,
          f"table1 auto ({auto.plan.source} {auto.backend} fuse "
          f"{auto.fuse}): {auto_r.iterations} iterations")
    tuned_pick = {"source": auto.plan.source, "backend": auto.backend,
                  "fuse": auto.fuse, "rim": auto.plan.rim,
                  "iterations": auto_r.iterations,
                  "wall_ms": auto_r.wall_seconds * 1e3}
    resident = T.make_plan(lap, (64, 64), backend="cuda_fused", bc=1.0,
                           iters=n_iters, rim="resident", device=dev)
    res_x = resident(torch.zeros(64, 64, device=dev))
    sync()
    res_err = err(res_x, solves["cuda_fused"].x)
    check(resident.fuse == n_iters and res_err <= TOL["float32"],
          f"resident {n_iters} iterations vs the converged field: {res_err}")
    emit({"phase": 3, "table1": {
        b: {"iterations": r.iterations, "residual": r.residual,
            "wall_ms": r.wall_seconds * 1e3, "cold_wall_ms": cold_ms[b],
            "fuse": r.fuse}
        for b, r in solves.items()},
        "resident": {"iterations": n_iters, "max_abs_err_vs_converged":
                     res_err}, "auto": tuned_pick})

    kappa = 1.0 + 9.0 * np.random.default_rng(0).random(HET_GRID)
    het = T.heterogeneous_jacobi(kappa)
    het_solver = T.Solver(het, HET_GRID, backend="cuda", bc=1.0,
                          rtol=None, atol=None, max_iters=200, fuse=1,
                          device=dev)
    het_x0 = torch.zeros(1, *HET_GRID, device=dev)
    t0 = time.perf_counter()
    het_r = het_solver.solve(het_x0)
    het_ms = (time.perf_counter() - t0) * 1e3
    y = T.DirichletBC(1.0).set_boundary(het_x0, 2)
    het_fields = torch.as_tensor(het.field_stack(), device=dev)
    for _ in range(200):
        y = stencil2d_plain(y, het, bc_value=1.0, fields=het_fields)
    het_err = err(het_r.x, y)
    check(het_err <= TOL["float32"], f"hetero vs plain: {het_err}")
    emit({"phase": 4, "grid": list(HET_GRID), "iterations": 200,
          "wall_ms": het_ms, "max_abs_err_vs_plain": het_err})

    big = BIG_GRID
    n_big = big[0] * big[1]
    g = torch.Generator(device=dev).manual_seed(2)
    xb = torch.rand((1, *big), generator=g, device=dev)
    full = {}
    outs = {}
    for backend, iters, fuse in (("cuda_fused", 1024, 16), ("cuda", 64, 1)):
        plan = T.make_plan(lap, big, backend=backend, bc=1.0, iters=iters,
                           fuse=fuse, device=dev)

        def run(plan=plan, backend=backend):
            outs[backend] = plan(xb)
        ms = time_ms(run, 1)
        check(bool(torch.isfinite(outs[backend]).all()),
              f"full-size {backend} finite")
        per_iter = ms / iters
        full[backend] = {
            "iters": iters, "fuse": plan.fuse, "ms": ms,
            "ms_per_iter": per_iter,
            # as if each iteration read and wrote the grid once
            "effective_GBps": 2 * n_big * 4 / (per_iter * 1e-3) / 1e9,
            # what each pass really moves
            "device_GBps": 2 * n_big * 4 / (per_iter * plan.fuse * 1e-3)
            / 1e9,
            "bound_GBps": PEAK_BYTES / 1e9}
    k33 = torch.as_tensor(lap.to_kernel(), device=dev)[None, None]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        conv_big_ms = graph_ms(lambda: F.conv2d(xb[None], k33, padding=1),
                               5)
    full["library_ms_conv2d_one_sweep"] = conv_big_ms
    # A resident plan past one CTA's shared memory: all its iterations in
    # one pass of the grid-wide kernel.
    res_big = T.make_plan(lap, RESIDENT_BIG, backend="cuda_fused", bc=1.0,
                          iters=RESIDENT_BIG_ITERS, rim="resident",
                          device=dev)
    xr = torch.rand((1, *RESIDENT_BIG), generator=g, device=dev)
    res_big_ms = time_ms(lambda: outs.__setitem__("resident", res_big(xr)),
                         1)
    res_big_err = err(outs["resident"], jacobi2d_fused_plain(
        xr, lap, fuse=RESIDENT_BIG_ITERS, bc_value=1.0))
    check(res_big.fuse == RESIDENT_BIG_ITERS
          and res_big_err <= TOL["float32"],
          f"resident plan {RESIDENT_BIG} vs plain: {res_big_err}")
    full["resident_plan"] = {"grid": list(RESIDENT_BIG),
                             "iters": RESIDENT_BIG_ITERS,
                             "fuse": res_big.fuse, "ms": res_big_ms,
                             "max_abs_err_vs_plain": res_big_err}
    emit({"phase": 5, "grid": list(big), **full})

    batch = T.Solver(lap, (64, 64), backend="cuda_fused", device=dev,
                     tuned=None, **TABLE1)
    t0 = time.perf_counter()
    br = batch.solve(torch.zeros(BATCH, 64, 64, device=dev))
    batch_ms = (time.perf_counter() - t0) * 1e3
    check(bool((br.iterations == n_iters).all()) and br.converged.all(),
          f"batch iterations {sorted(set(br.iterations.tolist()))} vs "
          f"{n_iters}")
    check(err(br.x, solves["cuda_fused"].x[None].expand_as(br.x)) == 0.0,
          "batch instances equal the single solve")
    emit({"phase": 6, "instances": BATCH, "iterations": n_iters,
          "wall_ms": batch_ms, "fuse": br.fuse})

    launches = dict(_build.LAUNCHES)
    for k in ("stencil2d", "jacobi2d_trapezoid", "jacobi2d_resident",
              "jacobi2d_resident_grid"):
        check(launches.get(k, 0) > 0, f"main path never launched {k}")

    # -- 7. kernel inventory: times at the main path's shapes ----------------
    # "ms" and "plain_ms" replay a CUDA graph of the calls (device time);
    # "eager_ms" times the same calls issued one by one from Python, which
    # at small sizes is the wrapper's host time, not the kernel's.
    # K1 at the heterogeneous 1024x1024 step (4 field taps, bc).
    x1 = field((1, *HET_GRID))

    def k1():
        stencil2d(x1, het, bc_value=1.0, fields=het_fields)
    k1_ms, k1_eager = graph_ms(k1, 50), time_ms(k1, 50)
    k1_plain = graph_ms(lambda: stencil2d_plain(x1, het, bc_value=1.0,
                                                fields=het_fields), 10)
    n1 = x1.numel()
    k1_bytes = 2 * n1 * 4 + het_fields.numel() * 4
    k1_ops = (2 * len(het.taps) - 1) * n1
    # K2 at the 8192x8192 fuse-1 sweep (the cuda backend's pass), where
    # F.conv2d computes the same 5-point sweep (less the shell pinning), and
    # at fuse 16 (phase 5's pass): the stream kernel the shape picks, and the
    # tile kernel before it asked for by name.
    xs = T.DirichletBC(1.0).set_boundary(xb, 2)

    def k2(fuse, kernel=None, x=xs, rim="trapezoid"):
        return lambda: jacobi2d_fused_step(x, lap, fuse=fuse, bc_value=1.0,
                                           rim=rim, kernel=kernel)
    k2_ms, k2_eager = graph_ms(k2(1), 10), time_ms(k2(1), 10)
    k2_tile_ms = graph_ms(k2(1, "tile"), 10)
    k2_plain = graph_ms(lambda: jacobi2d_fused_plain(xs, lap, fuse=1,
                                                     bc_value=1.0), 3)
    k2_f16_plain = time_ms(lambda: jacobi2d_fused_plain(xs, lap, fuse=16,
                                                        bc_value=1.0), 1)
    k2_err = err(k2(16)(), jacobi2d_fused_plain(xs, lap, fuse=16,
                                                bc_value=1.0))
    check(k2_err <= TOL["float32"], f"K2 fuse 16 at full size: {k2_err}")
    k2_f16, k2_f16_tile = graph_ms(k2(16), 5), graph_ms(k2(16, "tile"), 5)
    k2_ops = (2 * len(lap.taps) - 1) * n_big
    # K3 at the Table-1 resident pass: n_iters steps on one 64x64 grid, the
    # register kernel the shape picks, the cta kernel and the one-CTA kernel
    # before both.  Its plain version (n_iters sweeps of a dozen small ops)
    # is timed eagerly.
    x3 = T.DirichletBC(1.0).set_boundary(torch.zeros(1, 64, 64, device=dev),
                                         2)
    k3_ms = graph_ms(k2(n_iters, x=x3, rim="resident"), 3)
    k3_smem_ms = graph_ms(k2(n_iters, "resident_smem", x3, "resident"), 3)
    k3_cta_ms = graph_ms(k2(n_iters, "resident_cta", x3, "resident"), 3)
    k3_plain = time_ms(lambda: jacobi2d_fused_plain(x3, lap, fuse=n_iters,
                                                    bc_value=1.0), 1, 0)
    k3_ops = n_iters * (2 * len(lap.taps) - 1) * 64 * 64
    # K2 as the Table-1 solve runs it (64x64, fuse 4): the shape sends it to
    # the register kernel; the stream and tile kernels by name beside it.
    # With the launch count this splits the solve's wall time into kernel
    # time and the rest.
    t1_fuse = solves["cuda_fused"].fuse
    t1_kernel = kernel_for("trapezoid", lap, t1_fuse, 1, 64, 64)
    k2_t1_ms = graph_ms(k2(t1_fuse, x=x3), 200)
    k2_t1_eager = time_ms(k2(t1_fuse, x=x3), 200)
    k2_t1_by_name = {k: graph_ms(k2(t1_fuse, k, x3), 200)
                     for k in ("stream", "tile", "resident_cta",
                               "resident_smem")}
    k2_t1_plain = graph_ms(lambda: jacobi2d_fused_plain(
        x3, lap, fuse=t1_fuse, bc_value=1.0), 50)
    t1_kernel_ms = n_iters // t1_fuse * k2_t1_ms
    # Phase 6's launch: the batch of 1024 Table-1 grids at fuse 4, by shape
    # and each kernel by name (where the dispatch's batch rule is read).
    xB = T.DirichletBC(1.0).set_boundary(
        torch.zeros(BATCH, 64, 64, device=dev), 2)
    batch_kernel = kernel_for("trapezoid", lap, t1_fuse, BATCH, 64, 64)
    k2_batch = {k or "by_shape": graph_ms(k2(t1_fuse, k, xB), 20)
                for k in (None, "stream", "tile", "resident_regs",
                          "resident_cta", "resident_smem")}
    # The grid-wide resident kernel at phase 5's resident plan (its
    # cooperative launch replays in a CUDA graph), and the stream kernel's
    # passes (by name) on the same request.
    x0 = T.DirichletBC(1.0).set_boundary(xr, 2)
    kg_ms = graph_ms(k2(RESIDENT_BIG_ITERS, x=x0, rim="resident"), 3)
    kg_stream_ms = graph_ms(k2(RESIDENT_BIG_ITERS, "stream", x0, "resident"),
                            3)
    kg_eager = time_ms(k2(RESIDENT_BIG_ITERS, x=x0, rim="resident"), 3)
    kg_plain = time_ms(lambda: jacobi2d_fused_plain(
        x0, lap, fuse=RESIDENT_BIG_ITERS, bc_value=1.0), 1, 0)
    n_res = RESIDENT_BIG[0] * RESIDENT_BIG[1]
    kg_ops = RESIDENT_BIG_ITERS * (2 * len(lap.taps) - 1) * n_res
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        conv64_ms = graph_ms(lambda: F.conv2d(x3[None], k33, padding=1), 50)
    emit({"phase": 7, "launches": launches, "table1_cuda_fused": {
        "wall_ms": solves["cuda_fused"].wall_seconds * 1e3,
        "launches": t1_launches, "kernel": t1_kernel,
        "kernel_ms": t1_kernel_ms,
        "kernel_share": t1_kernel_ms
        / (solves["cuda_fused"].wall_seconds * 1e3)},
        "batch_launch_ms": {"by_shape": batch_kernel, **k2_batch}})

    # Free the 2D path's large tensors before the 3D path's 8 GB batch.
    del xb, xs, xB, outs, br, batch, k2  # k2 holds xs as its default
    torch.cuda.empty_cache()

    # -- 8-9. the 3D path (Fig 6), with the launch counts from zero ---------
    _build.LAUNCHES.clear()
    lap3 = T.laplace_jacobi(3)
    fig6, fig6_cold, fig6_k4 = {}, {}, {}
    for backend in ("cuda", "conv", "conv3d_native", "reference"):
        solver = T.Solver(lap3, FIG6_GRID, backend=backend, bc=1.0,
                          device=dev, **FIG6)
        fig6_cold[backend] = solver.solve(
            torch.zeros(FIG6_GRID)).wall_seconds * 1e3
        k4_before = _build.LAUNCHES["stencil3d"]
        r = solver.solve(torch.zeros(FIG6_GRID))
        fig6_k4[backend] = _build.LAUNCHES["stencil3d"] - k4_before
        check(r.converged and r.x.shape == FIG6_GRID
              and bool(torch.isfinite(r.x).all()), f"fig6 {backend}")
        if backend in ("cuda", "reference"):
            check(r.iterations == FIG6_ITERS
                  and r.residual == FIG6_RESIDUAL,
                  f"fig6 {backend}: {r.iterations} iterations, residual "
                  f"{r.residual!r}")
        else:
            check(abs(r.iterations - FIG6_ITERS) <= FIG6["check_every"],
                  f"fig6 {backend}: {r.iterations} iterations")
        fig6[backend] = r
    check(err(fig6["cuda"].x, fig6["reference"].x) == 0.0,
          "fig6 cuda field is not bit-equal to reference")
    for backend, r in fig6.items():
        chunks = abs(r.iterations - FIG6_ITERS) // FIG6["check_every"]
        check(err(r.x, fig6["reference"].x)
              <= TOL["float32"] + chunks * 2 * fig6["reference"].residual,
              f"fig6 {backend} field vs reference")
    kappa3 = 1.0 + 9.0 * np.random.default_rng(0).random(FIG6_GRID)
    het3 = T.heterogeneous_jacobi(kappa3)
    het3d = {}
    for backend in ("cuda", "conv3d_native", "reference"):
        solver = T.Solver(het3, FIG6_GRID, backend=backend, bc=1.0,
                          device=dev, **FIG6)
        k4_before = _build.LAUNCHES["stencil3d"]
        r = solver.solve(torch.zeros(FIG6_GRID))
        if backend == "conv3d_native":
            check(abs(r.iterations - HET3D_ITERS) <= FIG6["check_every"],
                  f"hetero 3D {backend}: {r.iterations} iterations")
        else:
            check(r.iterations == HET3D_ITERS,
                  f"hetero 3D {backend}: {r.iterations} iterations")
        het3d[backend] = {"iterations": r.iterations,
                          "residual": r.residual,
                          "wall_ms": r.wall_seconds * 1e3,
                          "k4_launches": _build.LAUNCHES["stencil3d"]
                          - k4_before, "x": r.x}
    check(err(het3d["cuda"].pop("x"), het3d["reference"].pop("x")) == 0.0,
          "hetero 3D cuda field is not bit-equal to reference")
    het3d["conv3d_native"].pop("x")
    emit({"phase": 8, "grid": list(FIG6_GRID), "fig6": {
        b: {"iterations": r.iterations, "residual": r.residual,
            "wall_ms": r.wall_seconds * 1e3, "cold_wall_ms": fig6_cold[b],
            "k4_launches": fig6_k4[b]} for b, r in fig6.items()},
        "hetero3d": het3d})

    # The paper's full problem and one deep grid, through the plan.
    g3 = torch.Generator(device=dev).manual_seed(3)
    xp_batch = torch.rand((PAPER_BATCH, *FIG6_GRID), generator=g3,
                          device=dev)
    xp_deep = torch.rand((1, *DEEP_GRID), generator=g3, device=dev)
    big3 = {}
    for name, x3d in (("paper_batch", xp_batch), ("deep_grid", xp_deep)):
        plan = T.make_plan(lap3, x3d.shape[1:], backend="cuda", bc=1.0,
                           iters=ITERS_3D, device=dev)
        k4_before = _build.LAUNCHES["stencil3d"]
        sync()
        t0 = time.perf_counter()
        y3d = plan(x3d)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
        launches3d = _build.LAUNCHES["stencil3d"] - k4_before
        check(y3d.shape == x3d.shape and bool(torch.isfinite(y3d).all()),
              f"{name} finite")
        big3[name] = {"shape": list(x3d.shape), "iters": ITERS_3D,
                      "wall_ms": wall, "k4_launches": launches3d,
                      "out": y3d}
    launches3 = dict(_build.LAUNCHES)
    check(launches3.get("stencil3d", 0) > 0,
          "the 3D path never launched stencil3d")
    # Against the plain version: a slice of the batch, the whole deep grid.
    for name, x3d in (("paper_batch", xp_batch[:CHECK_SLICE]),
                      ("deep_grid", xp_deep)):
        y = T.DirichletBC(1.0).set_boundary(x3d, 3)
        for _ in range(ITERS_3D):
            y = stencil3d_plain(y, lap3, bc_value=1.0)
        e = err(big3[name].pop("out")[:len(x3d)], y)
        check(e == 0.0, f"{name} vs plain on {len(x3d)} instances: {e}")
        big3[name]["max_abs_err_vs_plain"] = e
        big3[name]["checked_instances"] = len(x3d)
    del y
    emit({"phase": 9, "launches": launches3, **big3})

    # -- 10. the dense path (Algorithm 1), with the launch counts from zero --
    _build.LAUNCHES.clear()
    gd = torch.Generator(device=dev).manual_seed(4)
    xd = T.DirichletBC(1.0).set_boundary(
        torch.rand((DENSE_BATCH, 64, 64), generator=gd, device=dev), 2)
    matrix = torch.as_tensor(T.build_dense_matrix((64, 64), lap), device=dev)
    sync()
    t0 = time.perf_counter()
    yd = dense_jacobi_kernel(xd, matrix, iterations=DENSE_ITERS)
    sync()
    dense_wall = (time.perf_counter() - t0) * 1e3
    launches5 = dict(_build.LAUNCHES)
    check(launches5.get("dense_stencil_matmul", 0) == DENSE_ITERS
          and launches5.get("split_bf16x3", 0) == 2 * DENSE_ITERS,
          f"the dense path launched K5 {launches5}")
    # One jacobi2d call on all 65,536 instances: past gridDim.z's 65,535,
    # K2's wrapper launches the batch in slices (two launches an iteration).
    k23 = K23_COUNTERS[kernel_for("trapezoid", lap, 1, DENSE_BATCH, 64,
                                  64)]
    k2_before = _build.LAUNCHES[k23]
    yk = jacobi2d(xd, lap, bc_value=1.0, iterations=DENSE_ITERS)
    k2_sliced = _build.LAUNCHES[k23] - k2_before
    check(k2_sliced == 2 * DENSE_ITERS,
          f"jacobi2d on {DENSE_BATCH} instances: {k2_sliced} {k23} launches")
    dense_err = err(yd, yk)
    check(yd.shape == xd.shape and dense_err <= 1e-5,
          f"dense path vs jacobi2d: {dense_err}")
    emit({"phase": 10, "instances": DENSE_BATCH, "grid": [64, 64],
          "N": 64 * 64, "iterations": DENSE_ITERS, "wall_ms": dense_wall,
          "launches": launches5, "max_abs_err_vs_jacobi2d": dense_err,
          "jacobi2d_one_call_kernel": k23,
          "jacobi2d_one_call_launches": k2_sliced})
    del yd, yk

    # -- 11. K4 and K5 timed at the 3D and dense paths' shapes ---------------
    def k4_step(y):
        return stencil3d(y, lap3, bc_value=1.0)

    xs3 = T.DirichletBC(1.0).set_boundary(xp_batch, 3)
    del xp_batch
    torch.cuda.empty_cache()
    n3 = xs3.numel()
    k4_ms = graph_ms(k4_step, 3, xs3)
    k4_cell_ms = graph_ms(lambda y: stencil3d(y, lap3, bc_value=1.0,
                                              kernel="cell"), 3, xs3)
    k4_eager = time_ms(lambda: k4_step(xs3), 3)
    k4_plain = time_ms(lambda: stencil3d_plain(xs3, lap3, bc_value=1.0), 1)
    k333 = torch.as_tensor(lap3.to_kernel(), device=dev)[None, None]
    kch = torch.as_tensor(T.conv3d_channels_kernel(lap3, FIG6_GRID[0]),
                          device=dev)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        conv3d_ms = time_ms(lambda: F.conv3d(xs3[:, None], k333, padding=1),
                            3)
        conv2d_ch_ms = time_ms(lambda: F.conv2d(xs3, kch, padding=1), 3)
    k4_ops = (2 * len(lap3.taps) - 1) * n3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del xs3
    torch.cuda.empty_cache()
    deep = T.DirichletBC(1.0).set_boundary(xp_deep, 3)
    n_deep = deep.numel()
    k4_deep_ms = graph_ms(k4_step, 10, deep)
    k4_deep_cell_ms = graph_ms(lambda y: stencil3d(y, lap3, bc_value=1.0,
                                                   kernel="cell"), 10, deep)
    k4_deep_plain = time_ms(lambda: stencil3d_plain(deep, lap3,
                                                    bc_value=1.0), 3)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        conv3d_deep_ms = time_ms(
            lambda: F.conv3d(deep[:, None], k333, padding=1), 3)
    del deep, xp_deep
    # One Fig-6 grid (the single-grid solves of phase 8) and a few, where
    # the kernel the shape picks changes: that kernel and each of the two
    # by name, 200 steps a replay.
    k4_small = {}
    for nb in K4_SMALL_BATCHES:
        few = T.DirichletBC(1.0).set_boundary(
            torch.rand((nb, *FIG6_GRID), generator=g3, device=dev), 3)
        k4_small[nb] = {
            name: graph_ms(lambda y, k=k: stencil3d(y, lap3, bc_value=1.0,
                                                     kernel=k), 200, few)
            for name, k in (("ms", None), ("cell_kernel_ms", "cell"),
                            ("stream_kernel_ms", "stream"))}
        k4_small[nb]["bound_ms"] = 2 * few.numel() * 4 / PEAK_BYTES * 1e3
    del few
    k4_one = k4_small[1]

    # K5 against its plain version at the dense path's shape, then timed.
    xd2 = xd.reshape(DENSE_BATCH, -1)
    out = dense_stencil_matmul(xd2, matrix)
    sync()
    k5_err = record("dense_stencil_matmul", torch.float32, out,
                    dense_stencil_plain(xd2, matrix), f"{tuple(xd2.shape)}",
                    GEMM_TOL)
    del out
    k5_ms = graph_ms(lambda y: dense_stencil_matmul(y, matrix), 3, xd2)
    k5_plain = time_ms(lambda: dense_stencil_plain(xd2, matrix), 3)
    torch.backends.cuda.matmul.allow_tf32 = False   # the default, stated
    matmul_ms = time_ms(lambda: torch.matmul(xd2, matrix), 3)
    nd_ = 64 * 64
    split_ms = graph_ms(lambda: launch_split(xd2, nd_), 3)
    split_plain_ms = time_ms(lambda: split_bf16x3(xd2, nd_), 3)
    # fp32 K5 and torch.matmul against an fp64 product, with random W:
    # max |y - y64| / (|x| . |W|), the latter in fp64.
    wr = field((nd_, nd_)) / 64
    x64 = xd2.double()
    y64 = x64 @ wr.double()
    den = x64.abs() @ wr.double().abs()
    del x64
    norm_err = {}
    for name, fn in (("k5", dense_stencil_matmul), ("torch_matmul",
                                                    torch.matmul)):
        norm_err[name] = float(((fn(xd2, wr).double() - y64).abs()
                                / den).max())
    del y64, den
    # The Laplace matrix is mostly zeros, on which the tensor cores draw
    # less power: the times with the random W beside it.
    k5_rand_ms = graph_ms(lambda: dense_stencil_matmul(xd2, wr), 3)
    matmul_rand_ms = time_ms(lambda: torch.matmul(xd2, wr), 3)
    del wr
    check(norm_err["k5"] <= K5_NORM_ERR,
          f"fp32 K5 against fp64: {norm_err['k5']} of |x| . |W|")
    # bf16 K5 at the same shape: against its plain version, then timed
    # beside torch.matmul in bf16.
    xb16, mb16 = xd2.bfloat16(), matrix.bfloat16()
    out = dense_stencil_matmul(xb16, mb16)
    sync()
    k5_bf16_err = record("dense_stencil_matmul", torch.bfloat16, out,
                         dense_stencil_plain(xb16, mb16),
                         f"{tuple(xd2.shape)}", GEMM_TOL)
    del out
    k5_bf16_ms = graph_ms(lambda y: dense_stencil_matmul(y, mb16), 5, xb16)
    k5_bf16_plain = time_ms(lambda: dense_stencil_plain(xb16, mb16), 3)
    matmul_bf16_ms = graph_ms(lambda: torch.matmul(xb16, mb16), 5)
    del xb16, mb16
    k5_ops = 2 * DENSE_BATCH * nd_ * nd_
    k5_bytes = (2 * DENSE_BATCH * nd_ + nd_ * nd_) * 4
    split_bytes = DENSE_BATCH * nd_ * (4 + 3 * 2)
    # The tensor-core instances: HGMMA in each, and no spills (ptxas -v).
    hgmma_k5 = {f: n for f, n in sass_counts(libs["dense_stencil_sm90"],
                                              "HGMMA").items()
                if "dense_gemm" in f}
    check(len(hgmma_k5) == 2 and min(hgmma_k5.values()) > 0,
          f"HGMMA instructions by K5 instance: {hgmma_k5}")
    k5_ptxas = [ln.strip() for ln in
                _build.build_log("dense_stencil_sm90").splitlines()
                if "registers" in ln or "spill" in ln]
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in ln
              for ln in k5_ptxas if "spill" in ln),
          f"the K5 kernels spill: {k5_ptxas}")
    emit({"phase": 11, "k4": {
        "paper_batch": {"shape": [PAPER_BATCH, *FIG6_GRID], "ms": k4_ms,
                        "cell_kernel_ms": k4_cell_ms,
                        "eager_ms": k4_eager, "plain_ms": k4_plain,
                        "bound_ms": 2 * n3 * 4 / PEAK_BYTES * 1e3,
                        "conv3d_ms": conv3d_ms,
                        "conv2d_channels_ms": conv2d_ch_ms,
                        "library_batch": PAPER_BATCH,
                        "peak_memory_GB": peak_gb},
        "deep_grid": {"shape": [1, *DEEP_GRID], "ms": k4_deep_ms,
                      "cell_kernel_ms": k4_deep_cell_ms,
                      "plain_ms": k4_deep_plain,
                      "bound_ms": 2 * n_deep * 4 / PEAK_BYTES * 1e3,
                      "conv3d_ms": conv3d_deep_ms},
        "fig6_grids": {str(nb): {"shape": [nb, *FIG6_GRID], **t}
                       for nb, t in k4_small.items()}},
        "k5": {"shape": [DENSE_BATCH, nd_], "ms": k5_ms, "plain_ms": k5_plain,
               "matmul_ms": matmul_ms, "max_abs_err_vs_plain": k5_err,
               "bound_ms": k5_ops / PEAK_BF16_FLOPS * 1e3,
               "six_product_bound_ms":
                   K5_PRODUCTS * k5_ops / PEAK_BF16_FLOPS * 1e3,
               "simt_fp32_bound_ms": k5_ops / PEAK_FP32_FLOPS * 1e3,
               "TFLOPs": k5_ops / (k5_ms * 1e-3) / 1e12,
               "norm_err_vs_fp64": norm_err, "norm_err_limit": K5_NORM_ERR,
               "random_w_ms": k5_rand_ms,
               "random_w_matmul_ms": matmul_rand_ms,
               "split_ms": split_ms, "split_plain_ms": split_plain_ms,
               "bf16_ms": k5_bf16_ms, "bf16_plain_ms": k5_bf16_plain,
               "bf16_matmul_ms": matmul_bf16_ms,
               "bf16_bound_ms": k5_ops / PEAK_BF16_FLOPS * 1e3,
               "bf16_max_abs_err_vs_plain": k5_bf16_err,
               "hgmma_by_instance": hgmma_k5, "ptxas": k5_ptxas}})


    # -- 40. the stencil tiers counted: cuda against meta --------------------
    emit(stencil_counts_phase(dev, lap, lap3, solves["cuda_fused"].x, xd,
                              matrix))

    # -- 12. K6 and K7 against their plain versions ---------------------------
    del xd, xd2, matrix
    torch.cuda.empty_cache()
    from _torch_flash_cases import DENSE_CASES, FLASH_CASES
    from repro_torch.configs import get_config
    from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                     flash_fwd, flash_fwd_plain)
    from repro_torch.launch.serve import serve
    from repro_torch.models.model_zoo import build
    from repro_torch.models.transformer import Transformer, mask_pad_logits
    from repro_torch.train.serve_step import (greedy_generate,
                                              make_decode_step,
                                              make_prefill_step)

    ga = torch.Generator(device=dev).manual_seed(5)
    lse_worst = {"float32": 0.0, "bfloat16": 0.0}

    def flash_case(label, shape, dtype, causal=True, kv_offset=0,
                   blocks=(32, 128), qkv=None):
        """Both kernels on one case, held element by element to the plain
        versions (every row here has a valid key); q, k, v random normal
        unless given."""
        B_, Sq_, Skv_, H_, KV_, hd_ = shape
        q, k, v = qkv or (torch.randn(s_, generator=ga, device=dev).to(dtype)
                          for s_ in ((B_, Sq_, H_, hd_), (B_, Skv_, KV_, hd_),
                                     (B_, Skv_, KV_, hd_)))
        kw = dict(causal=causal, kv_offset=kv_offset, block_q=blocks[0],
                  block_k=blocks[1])
        out6 = flash_attention(q, k, v, **kw)
        out7, lse7 = flash_fwd(q, k, v, **kw)
        sync()
        plain7, plain_lse = flash_fwd_plain(q, k, v, **kw)
        record("flash_attention", dtype, out6,
               flash_attention_plain(q, k, v, **kw), label, FLASH_TOL)
        record("flash_fwd", dtype, out7, plain7, label, FLASH_TOL)
        key = str(dtype).split(".")[1]
        e = err(lse7, plain_lse) / float(plain_lse.abs().max())
        check(e <= LSE_RTOL, f"flash_fwd lse {label} {key}: {e} relative")
        lse_worst[key] = max(lse_worst[key], e)
        return q, k, v, out7

    for dtype in (torch.float32, torch.bfloat16):
        flash_case("mha", (1, 128, 128, 2, 2, 32), dtype)
        flash_case("gqa_2to1_ragged_96", (2, 96, 96, 4, 2, 16), dtype)
        flash_case("mqa", (1, 256, 256, 8, 1, 32), dtype)
        flash_case("non_causal", (1, 64, 64, 2, 2, 16), dtype, causal=False)
        flash_case("cross_kv_offset_128", (1, 32, 160, 2, 2, 16), dtype,
                   kv_offset=128)
        for hd in (16, 32, 64, 128):
            flash_case(f"hd{hd}", (2, 200, 200, 4, 2, hd), dtype)
        for label in ("cross_ragged_non_causal", "non_causal_gqa6"):
            shape, causal, kv_offset = FLASH_CASES[label]
            flash_case(label, shape, dtype, causal=causal,
                       kv_offset=kv_offset)
    flash_case("p_rounding", (1, 64, 1024, 2, 1, 16), torch.bfloat16,
               causal=False, qkv=p_rounding_case(dev))
    Bm, Sm, Hm, KVm, hdm = LM_SHAPE
    qm, km, vm, out_m = flash_case("serve_shape", (Bm, Sm, Sm, Hm, KVm, hdm),
                                   torch.bfloat16, blocks=(512, 512))
    Bh, Sh, Hh, KVh, hdh = HYBRID_SHAPE
    flash_case("hybrid_shape", (Bh, Sh, Sh, Hh, KVh, hdh), torch.bfloat16,
               blocks=(512, 512))
    for arch, (Bx, Sx, Hx, KVx, hdx) in MOE_SHAPES.items():
        flash_case(f"{arch} shape", (Bx, Sx, Sx, Hx, KVx, hdx),
                   torch.bfloat16, blocks=(512, 512))
    for label in (*VE_CASES, *DENSE_CASES.values()):
        shape, causal, _ = FLASH_CASES[label]
        flash_case(label, shape, torch.bfloat16, causal=causal,
                   blocks=(512, 512))
    # A diagnostic, not a check: the bf16 kernel's own schedule is the plain
    # version at its 128 x 128 tiles (p rounded against the same running
    # maxima), so what is left there is the order of the fp32 sums.
    tiles128 = flash_fwd_plain(qm, km, vm, causal=True, block_q=128,
                               block_k=128)[0].float()
    own_tiles = {"max_abs_err": err(out_m, tiles128),
                 "max_err_over_bound": float(
                     ((out_m.float() - tiles128).abs()
                      / (FLASH_TOL["bfloat16"][0] + FLASH_TOL["bfloat16"][1]
                         * tiles128.abs())).max())}
    del qm, km, vm, out_m, tiles128
    emit({"phase": 12, "cases": {n: cases[n] for n in ("flash_attention",
                                                       "flash_fwd")},
          "serve_shape_vs_plain_at_kernel_tiles": own_tiles,
          "max_abs_err": {n: worst[n] for n in ("flash_attention",
                                                "flash_fwd")},
          "max_err_over_bound": {n: ratio[n] for n in ("flash_attention",
                                                       "flash_fwd")},
          "lse_max_rel_err": lse_worst, "tol": FLASH_TOL,
          "lse_rtol": LSE_RTOL})

    # -- 13. the serve path in fp32 at full width: flash against xla ----------
    cfg_f = dataclasses.replace(get_config(LM_ARCH), attn_impl="flash")
    cfg_x = dataclasses.replace(cfg_f, attn_impl="xla")
    model_f = build(cfg_f, device=dev, dtype=torch.float32,
                    generator=torch.Generator(device=dev).manual_seed(0))
    model_x = Transformer(cfg_x, device=dev, dtype=torch.float32)
    model_x.load_state_dict(model_f.state_dict())
    B13, S13, T13 = LM_FP32
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg_f.vocab_size, (B13, S13)), device=dev)
    max_len = S13 + T13 + 1
    _build.LAUNCHES.clear()
    h_f, _ = model_f.prefill(prompts, max_len)
    sync()
    prefill13 = dict(_build.LAUNCHES)
    check(prefill13 == {"flash_fwd": cfg_f.n_layers},
          f"fp32 flash prefill launched {prefill13}")
    h_x, _ = model_x.prefill(prompts, max_len)
    sync()
    check(dict(_build.LAUNCHES) == prefill13, "the xla prefill launched "
          "a kernel")
    hidden_rel = err(h_f, h_x) / float(h_x.abs().max())
    check(bool(torch.isfinite(h_f).all()) and hidden_rel <= 1e-4,
          f"fp32 prefill hidden flash vs xla: {hidden_rel} of max-abs")
    _build.LAUNCHES.clear()
    tok_f = greedy_generate(model_f, {"tokens": prompts}, steps=T13,
                            max_len=max_len)
    generate13 = dict(_build.LAUNCHES)
    check(generate13 == {"flash_fwd": cfg_f.n_layers},
          f"fp32 flash generate launched {generate13}")
    tok_x = greedy_generate(model_x, {"tokens": prompts}, steps=T13,
                            max_len=max_len)
    agree = int((tok_f == tok_x).sum())
    margins = []
    for b in range(B13):
        diff = (tok_f[b] != tok_x[b]).nonzero()
        if len(diff) == 0:
            continue
        t = int(diff[0])   # later tokens follow different prefixes
        ctx = torch.cat([prompts[b], tok_x[b, :t]])[None]
        h_t, _ = model_x.prefill(ctx, ctx.shape[1])
        logits = mask_pad_logits(model_x.logits(h_t), cfg_x)[0]
        top2 = torch.topk(logits, 2).values
        margin = float(top2[0] - top2[1]) / float(logits.abs().max())
        margins.append({"row": b, "position": t, "rel_margin": margin})
        check(margin <= 1e-3, f"row {b} token {t}: flash and xla disagree "
              f"where xla's top-2 margin is {margin} of max-abs")
    emit({"phase": 13, "arch": cfg_f.arch, "dtype": "float32",
          "batch": B13, "prompt_len": S13, "tokens": T13,
          "hidden_rel_err": hidden_rel, "prefill_launches": prefill13,
          "generate_launches": generate13,
          "tokens_flash": tok_f.tolist(), "tokens_xla": tok_x.tolist(),
          "tokens_agree": agree, "tokens_total": B13 * T13,
          "first_disagreements": margins})
    del model_f, model_x, h_f, h_x
    torch.cuda.empty_cache()

    # -- 14. the main path: bf16 serve at full width --------------------------
    B14, S14, T14 = LM_SERVE
    _build.LAUNCHES.clear()
    served = serve(cfg_f, batch=B14, prompt_len=S14, tokens=T14, device=dev,
                   dtype=torch.bfloat16, seed=0)
    launches7 = dict(_build.LAUNCHES)   # the warm-up and the timed run
    gen = served.pop("generated")
    check(served["prefill_launches"] == {"flash_fwd": cfg_f.n_layers}
          and not served["decode_launches"],
          f"bf16 serve launched {served['prefill_launches']}, "
          f"{served['decode_launches']}")
    check(gen.shape == (B14, T14 + 1) and bool((gen >= 0).all())
          and bool((gen < cfg_f.vocab_size).all()), "bf16 serve tokens")
    # Where the device time goes: the same model, one more prefill and
    # decode under the profiler (its own cost is in the wall time).
    model_b = build(cfg_f, device=dev, dtype=torch.bfloat16,
                    generator=torch.Generator(device=dev).manual_seed(0))
    prompts_b = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg_f.vocab_size, (B14, S14)), device=dev)
    prefill_b = make_prefill_step(model_b, S14 + T14 + 1)
    prof_prefill = device_profile(lambda: prefill_b({"tokens": prompts_b}))
    first_b, cache_b = prefill_b({"tokens": prompts_b})

    def decode_loop():
        tok = first_b
        for i in range(LM_PROFILE_TOKENS):
            tok, _ = make_decode_step(model_b, S14 + i)(tok, cache_b)

    prof_decode = device_profile(decode_loop)
    # The prefill step holds its model: all of it goes (1.5 GB).
    del model_b, cache_b, prefill_b, first_b, decode_loop, prompts_b
    torch.cuda.empty_cache()
    emit({"phase": 14, **served, "launches_whole_run": launches7,
          "seq0": gen[0].tolist(), "profile_prefill": prof_prefill,
          "profile_decode": prof_decode})

    # -- 15. K6 and K7 timed at the serve shape --------------------------------
    gq = torch.Generator(device=dev).manual_seed(6)
    qm, km, vm = (torch.randn(s_, generator=gq, device=dev)
                  .to(torch.bfloat16)
                  for s_ in ((Bm, Sm, Hm, hdm), (Bm, Sm, KVm, hdm),
                             (Bm, Sm, KVm, hdm)))
    k6_ms = graph_ms(lambda: flash_attention(qm, km, vm, causal=True), 5)
    k7_ms = graph_ms(lambda: flash_fwd(qm, km, vm, causal=True), 5)
    k67_plain = time_ms(lambda: flash_fwd_plain(qm, km, vm, causal=True), 3)
    # The library yardstick, timed here only: (B, H, S, hd) copies first.
    qs_, ks_, vs_ = (t_.transpose(1, 2).contiguous() for t_ in (qm, km, vm))
    sdpa_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qs_, ks_, vs_, is_causal=True, enable_gqa=True), 5)
    q32, k32, v32 = qm.float(), km.float(), vm.float()
    k7_fp32_ms = graph_ms(lambda: flash_fwd(q32, k32, v32, causal=True), 3)
    del q32, k32, v32
    lm_ops = 4 * Bm * Hm * hdm * (Sm * (Sm + 1) // 2)
    lm_bytes = 2 * (2 * Bm * Sm * Hm * hdm + 2 * Bm * Sm * KVm * hdm)
    lse_bytes = Bm * Hm * Sm * 4
    # The bf16 kernels run on the tensor cores: HGMMA (wgmma) instructions
    # in every instance of the built library, and no spills (ptxas -v).
    hgmma = sass_counts(libs["flash_attention_sm90"], "HGMMA")
    check(len(hgmma) == 8 and min(hgmma.values()) > 0,
          f"HGMMA instructions by bf16 instance: {hgmma}")
    sm90_ptxas = [ln.strip() for ln in
                  _build.build_log("flash_attention_sm90").splitlines()
                  if "registers" in ln or "spill" in ln]
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in ln
              for ln in sm90_ptxas if "spill" in ln),
          f"the bf16 flash kernels spill: {sm90_ptxas}")
    # zamba2-1.2b's shared attention (MHA, head_dim 64): the same operations.
    qh, kh, vh = (torch.randn(s_, generator=gq, device=dev)
                  .to(torch.bfloat16)
                  for s_ in ((Bh, Sh, Hh, hdh), (Bh, Sh, KVh, hdh),
                             (Bh, Sh, KVh, hdh)))
    hyb_ops = 4 * Bh * Hh * hdh * (Sh * (Sh + 1) // 2)
    hyb_bytes = 2 * (2 * Bh * Sh * Hh * hdh + 2 * Bh * Sh * KVh * hdh)
    hyb_lse_bytes = Bh * Hh * Sh * 4
    hyb15 = {"shape": list(HYBRID_SHAPE), "operations": hyb_ops,
             "k7_ms": graph_ms(lambda: flash_fwd(qh, kh, vh, causal=True),
                               5),
             "plain_ms": time_ms(lambda: flash_fwd_plain(qh, kh, vh,
                                                         causal=True), 3)}
    qs_, ks_, vs_ = (t_.transpose(1, 2).contiguous() for t_ in (qh, kh, vh))
    hyb15["sdpa_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
        qs_, ks_, vs_, is_causal=True), 5)
    hyb15["bound_ms"] = max(hyb_ops / PEAK_BF16_FLOPS,
                            (hyb_bytes + hyb_lse_bytes) / PEAK_BYTES) * 1e3
    hyb15["k7_TFLOPs"] = hyb_ops / (hyb15["k7_ms"] * 1e-3) / 1e12
    del qh, kh, vh
    # qwen3-moe-30b-a3b's attention (GQA 8: 32 query heads on 4 kv heads).
    Bg, Sg, Hg, KVg, hdg = MOE_SHAPES["qwen3-moe-30b-a3b"]
    qg, kg, vg = (torch.randn(s_, generator=gq, device=dev)
                  .to(torch.bfloat16)
                  for s_ in ((Bg, Sg, Hg, hdg), (Bg, Sg, KVg, hdg),
                             (Bg, Sg, KVg, hdg)))
    gqa_ops = 4 * Bg * Hg * hdg * (Sg * (Sg + 1) // 2)
    gqa_bytes = 2 * (2 * Bg * Sg * Hg * hdg + 2 * Bg * Sg * KVg * hdg)
    gqa_lse_bytes = Bg * Hg * Sg * 4
    gqa15 = {"shape": list(MOE_SHAPES["qwen3-moe-30b-a3b"]),
             "operations": gqa_ops,
             "k7_ms": graph_ms(lambda: flash_fwd(qg, kg, vg, causal=True),
                               5),
             "plain_ms": time_ms(lambda: flash_fwd_plain(qg, kg, vg,
                                                         causal=True), 3)}
    qs_, ks_, vs_ = (t_.transpose(1, 2).contiguous() for t_ in (qg, kg, vg))
    gqa15["sdpa_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
        qs_, ks_, vs_, is_causal=True, enable_gqa=True), 5)
    gqa15["bound_ms"] = max(gqa_ops / PEAK_BF16_FLOPS,
                            (gqa_bytes + gqa_lse_bytes) / PEAK_BYTES) * 1e3
    gqa15["k7_TFLOPs"] = gqa_ops / (gqa15["k7_ms"] * 1e-3) / 1e12
    del qg, kg, vg

    ve15 = {label: k7_timing(*FLASH_CASES[label][:2], dev, gq, graph_ms,
                             time_ms)
            for label in (*VE_CASES, *DENSE_CASES.values())}
    emit({"phase": 15, "shape": list(LM_SHAPE), "dtype": "bfloat16",
          "hybrid_shape": hyb15, "moe_gqa8_shape": gqa15,
          "vlm_encdec_shapes": {k: ve15[k] for k in VE_CASES},
          "dense_shapes": {k: ve15[k] for k in DENSE_CASES.values()},
          "k6_ms": k6_ms, "k7_ms": k7_ms, "plain_ms": k67_plain,
          "sdpa_ms": sdpa_ms, "k7_fp32_ms": k7_fp32_ms,
          "operations": lm_ops, "bytes": lm_bytes,
          "bound_ms": max(lm_ops / PEAK_BF16_FLOPS,
                          lm_bytes / PEAK_BYTES) * 1e3,
          "fp32_bound_ms": lm_ops / PEAK_FP32_FLOPS * 1e3,
          "k7_TFLOPs": lm_ops / (k7_ms * 1e-3) / 1e12,
          "hgmma_by_instance": hgmma, "ptxas": sm90_ptxas})

    # -- 16. K8 and K9 against their plain versions ---------------------------
    del qs_, ks_, vs_
    torch.cuda.empty_cache()
    from _torch_flash_cases import (FLIP_CASES, ds_flip_atol,
                                    ds_rounding_case, dv_p_rounding_case)
    from repro_torch.data.synthetic import DataConfig, token_batch
    from repro_torch.kernels.flash_attention_bwd import (
        flash_bwd, flash_bwd_dkv_plain, flash_bwd_dq_plain, flash_delta,
        launch_bwd_dkv, launch_bwd_dq)
    from repro_torch.launch.train import train
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step, value_and_grad)

    rerun_equal = {}
    flip_atol = {}   # the moe shapes: label -> the flip allowances

    def bwd_case(label, q, k, v, do, *, causal, kv_offset=0, rerun=False,
                 flips=False):
        """K8 and K9 on one case (o and lse from K7), held element by
        element to their plain versions; with ``rerun``, run again and
        required bit-equal; with ``flips`` (bf16: the moe shapes and
        ``FLIP_CASES``) dq's and dk's bounds also allow one flipped bf16
        rounding of the largest ds term (``ds_flip_atol``)."""
        kw = dict(causal=causal, kv_offset=kv_offset)
        o, lse = flash_fwd(q, k, v, **kw)
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, **kw)
        sync()
        if rerun:
            again = flash_bwd(q, k, v, o, lse, do, **kw)
            same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv),
                                                          again))
            check(same, f"K8/K9 {label} {q.dtype}: a rerun differs")
            rerun_equal[label] = same
            del again
        delta = flash_delta(o, do)
        tol_dq = tol_dk = FLASH_BWD_TOL
        if flips:
            atol, rtol = FLASH_BWD_TOL["bfloat16"]
            flip_dq, flip_dk = ds_flip_atol(q, k, v, do, lse, delta, causal)
            flip_atol[label] = {"dq": flip_dq, "dk": flip_dk}
            tol_dq = {"bfloat16": (atol + flip_dq, rtol)}
            tol_dk = {"bfloat16": (atol + flip_dk, rtol)}
        record("flash_bwd_dq", q.dtype, dq,
               flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw), label,
               tol_dq)
        pdk, pdv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
        record("flash_bwd_dkv", q.dtype, dk, pdk, f"{label} dk", tol_dk)
        record("flash_bwd_dkv", q.dtype, dv, pdv, f"{label} dv",
               FLASH_BWD_TOL)

    gb = torch.Generator(device=dev).manual_seed(7)
    for dtype in (torch.float32, torch.bfloat16):
        for label, (shape, causal, kv_offset) in FLASH_CASES.items():
            B_, Sq_, Skv_, H_, KV_, hd_ = shape
            q, k, v, do = (torch.randn(s_, generator=gb, device=dev).to(dtype)
                           for s_ in ((B_, Sq_, H_, hd_), (B_, Skv_, KV_, hd_),
                                      (B_, Skv_, KV_, hd_), (B_, Sq_, H_, hd_)))
            bf16 = dtype == torch.bfloat16
            bwd_case(label, q, k, v, do, causal=causal, kv_offset=kv_offset,
                     rerun=bf16 and label == "serve_shape",
                     flips=bf16 and label in FLIP_CASES)
    bwd_case("ds_rounding", *ds_rounding_case(dev), causal=False)
    bwd_case("dv_p_rounding", *dv_p_rounding_case(dev), causal=False)
    bwd_case("hybrid_shape", *(
        torch.randn(s_, generator=gb, device=dev).to(torch.bfloat16)
        for s_ in ((Bh, Sh, Hh, hdh), (Bh, Sh, KVh, hdh), (Bh, Sh, KVh, hdh),
                   (Bh, Sh, Hh, hdh))), causal=True)
    for arch, (Bx, Sx, Hx, KVx, hdx) in MOE_SHAPES.items():
        bwd_case(f"{arch} shape", *(
            torch.randn(s_, generator=gb, device=dev).to(torch.bfloat16)
            for s_ in ((Bx, Sx, Hx, hdx), (Bx, Sx, KVx, hdx),
                       (Bx, Sx, KVx, hdx), (Bx, Sx, Hx, hdx))), causal=True,
            flips=True)
    emit({"phase": 16, "cases": {n: cases[n] for n in BWD_KERNELS},
          "max_abs_err": {n: worst[n] for n in BWD_KERNELS},
          "max_err_over_bound": {n: ratio[n] for n in BWD_KERNELS},
          "bf16_rerun_bit_equal": rerun_equal, "tol": FLASH_BWD_TOL,
          "flip_atol": flip_atol})

    # -- 17. an fp32 train step at full width: flash against xla ---------------
    B17, S17 = LM_FP32[:2]
    model17 = build(cfg_f, device=dev, dtype=torch.float32,
                    generator=torch.Generator(device=dev).manual_seed(0))
    state17 = init_train_state(model17)
    batch17 = token_batch(DataConfig(cfg_f.vocab_size, S17, B17), 0,
                          device=dev)
    _build.LAUNCHES.clear()
    loss_f, _, grads_f = value_and_grad(model17, state17["params"], batch17)
    sync()
    launches17 = dict(_build.LAUNCHES)
    n_layers = cfg_f.n_layers
    step_launches = {"flash_fwd": 2 * n_layers, "flash_bwd_dq": n_layers,
                     "flash_bwd_dkv": n_layers}
    check(launches17 == step_launches,
          f"fp32 flash train step launched {launches17}")
    model17x = Transformer(cfg_x, device=dev, dtype=torch.float32)
    loss_x, _, grads_x = value_and_grad(model17x, state17["params"], batch17)
    sync()
    check(dict(_build.LAUNCHES) == launches17,
          "the xla train step launched a kernel")
    loss_rel = abs(float(loss_f) / float(loss_x) - 1)
    grad_rel = {n: err(grads_f[n], g) / float(g.abs().max())
                for n, g in grads_x.items()}
    worst_grad = max(grad_rel, key=grad_rel.get)
    check(loss_rel <= 1e-5 and bool(torch.isfinite(loss_f)),
          f"fp32 train loss flash vs xla: {loss_rel} relative")
    check(grad_rel[worst_grad] <= 1e-4,
          f"fp32 grad {worst_grad} flash vs xla: {grad_rel[worst_grad]} "
          f"of max-abs")
    emit({"phase": 17, "arch": cfg_f.arch, "dtype": "float32",
          "batch": B17, "seq_len": S17, "loss_flash": float(loss_f),
          "loss_xla": float(loss_x), "loss_rel_err": loss_rel,
          "max_grad_rel_err": grad_rel[worst_grad],
          "worst_grad": worst_grad, "launches": launches17})
    del model17, model17x, state17, grads_f, grads_x
    torch.cuda.empty_cache()

    # -- 18. the main path: bf16 training at full width -------------------------
    B18, S18, T18 = LM_TRAIN
    _build.LAUNCHES.clear()
    trained = train(cfg_f, steps=T18, global_batch=B18, seq_len=S18,
                    device=dev, seed=0)
    launches18 = dict(_build.LAUNCHES)
    steps18 = trained.pop("steps")
    for rec in steps18:
        check(rec["launches"] == step_launches,
              f"bf16 train step {rec['step']} launched {rec['launches']}")
        check(all(math.isfinite(rec[k]) for k in ("loss", "nll",
                                                   "grad_norm")),
              f"bf16 train step {rec['step']}: {rec}")
    timed = steps18[1:]   # the first pays the build and allocator growth
    ms18 = sum(r["ms"] for r in timed) / len(timed)
    # Where the device time goes: one more step of a fresh model under the
    # profiler, after one warm step (the profiler's own cost is in the wall).
    model18 = build(cfg_f, device=dev, dtype=torch.float32,
                    generator=torch.Generator(device=dev).manual_seed(0))
    step18 = make_train_step(model18, AdamWConfig(lr=3e-4, total_steps=T18,
                                                  warmup_steps=1))
    state18 = init_train_state(model18)
    batch18 = token_batch(DataConfig(cfg_f.vocab_size, S18, B18), 0,
                          device=dev)
    step18(state18, batch18)
    prof18 = device_profile(lambda: step18(state18, batch18), top=16)
    del model18, step18, state18
    torch.cuda.empty_cache()
    emit({"phase": 18, **trained, "steps": [
        {k: r[k] for k in ("step", "loss", "nll", "grad_norm", "lr", "ms",
                           "tokens_per_s", "launches")} for r in steps18],
        "ms_per_step": ms18,
        "tokens_per_s": B18 * S18 / (ms18 * 1e-3),
        "launches_whole_run": launches18, "profile_step": prof18})

    # -- 19. K8 and K9 timed at the training shape ------------------------------
    q8, k8, v8, do8 = (torch.randn(s_, generator=gq, device=dev)
                       .to(torch.bfloat16)
                       for s_ in ((Bm, Sm, Hm, hdm), (Bm, Sm, KVm, hdm),
                                  (Bm, Sm, KVm, hdm), (Bm, Sm, Hm, hdm)))
    o8, lse8 = flash_fwd(q8, k8, v8, causal=True)
    delta8 = flash_delta(o8, do8)
    kw8 = dict(causal=True, kv_offset=0)
    k8_ms = graph_ms(lambda: launch_bwd_dq(q8, k8, v8, do8, lse8, delta8,
                                           **kw8), 5)
    k9_ms = graph_ms(lambda: launch_bwd_dkv(q8, k8, v8, do8, lse8, delta8,
                                            **kw8), 5)
    k8_plain = time_ms(lambda: flash_bwd_dq_plain(q8, k8, v8, do8, lse8,
                                                  delta8, causal=True), 3)
    k9_plain = time_ms(lambda: flash_bwd_dkv_plain(q8, k8, v8, do8, lse8,
                                                   delta8, causal=True), 3)
    # The library yardstick, timed here only: the backward of SDPA on
    # (B, H, S, hd) copies, dq, dk and dv together.
    qs8, ks8, vs8 = (t_.transpose(1, 2).contiguous().requires_grad_()
                     for t_ in (q8, k8, v8))
    out8 = F.scaled_dot_product_attention(qs8, ks8, vs8, is_causal=True,
                                          enable_gqa=True)
    dout8 = do8.transpose(1, 2).contiguous()
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
        out8, (qs8, ks8, vs8), dout8, retain_graph=True), 5)
    del qs8, ks8, vs8, out8, dout8
    pairs = Bm * Hm * (Sm * (Sm + 1) // 2)
    k8_ops, k9_ops = 6 * hdm * pairs, 8 * hdm * pairs
    qkv_bytes = 2 * (2 * Bm * Sm * Hm * hdm + 2 * Bm * Sm * KVm * hdm)
    stat_bytes = 2 * Bm * Hm * Sm * 4            # lse and delta
    k8_bytes = qkv_bytes + stat_bytes + 2 * Bm * Sm * Hm * hdm
    k9_bytes = qkv_bytes + stat_bytes + 2 * 2 * Bm * Sm * KVm * hdm
    # The bf16 backward runs on the tensor cores: HGMMA instructions in
    # every instance of its library, and no spills (ptxas -v).
    hgmma_bwd = sass_counts(libs["flash_attention_bwd_sm90"], "HGMMA")
    check(len(hgmma_bwd) == 8 and min(hgmma_bwd.values()) > 0,
          f"HGMMA instructions by bf16 backward instance: {hgmma_bwd}")
    bwd_ptxas = [ln.strip() for ln in
                 _build.build_log("flash_attention_bwd_sm90").splitlines()
                 if "registers" in ln or "spill" in ln]
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in ln
              for ln in bwd_ptxas if "spill" in ln),
          f"the bf16 backward kernels spill: {bwd_ptxas}")
    # zamba2-1.2b's shared attention (MHA, head_dim 64).
    q8h, k8h, v8h, do8h = (torch.randn(s_, generator=gq, device=dev)
                           .to(torch.bfloat16)
                           for s_ in ((Bh, Sh, Hh, hdh), (Bh, Sh, KVh, hdh),
                                      (Bh, Sh, KVh, hdh), (Bh, Sh, Hh, hdh)))
    o8h, lse8h = flash_fwd(q8h, k8h, v8h, causal=True)
    delta8h = flash_delta(o8h, do8h)
    hyb_args = (q8h, k8h, v8h, do8h, lse8h, delta8h)
    hyb_pairs = Bh * Hh * (Sh * (Sh + 1) // 2)
    hyb_qkv = 2 * (2 * Bh * Sh * Hh * hdh + 2 * Bh * Sh * KVh * hdh)
    hyb_stat = 2 * Bh * Hh * Sh * 4
    hyb19 = {"shape": list(HYBRID_SHAPE),
             "k8_ms": graph_ms(lambda: launch_bwd_dq(*hyb_args, **kw8), 5),
             "k9_ms": graph_ms(lambda: launch_bwd_dkv(*hyb_args, **kw8), 5),
             "k8_plain_ms": time_ms(lambda: flash_bwd_dq_plain(
                 *hyb_args, causal=True), 3),
             "k9_plain_ms": time_ms(lambda: flash_bwd_dkv_plain(
                 *hyb_args, causal=True), 3),
             "k8_bound_ms": max(6 * hdh * hyb_pairs / PEAK_BF16_FLOPS,
                                (hyb_qkv + hyb_stat + 2 * Bh * Sh * Hh * hdh)
                                / PEAK_BYTES) * 1e3,
             "k9_bound_ms": max(8 * hdh * hyb_pairs / PEAK_BF16_FLOPS,
                                (hyb_qkv + hyb_stat
                                 + 2 * 2 * Bh * Sh * KVh * hdh)
                                / PEAK_BYTES) * 1e3}
    qs8, ks8, vs8 = (t_.transpose(1, 2).contiguous().requires_grad_()
                     for t_ in (q8h, k8h, v8h))
    out8 = F.scaled_dot_product_attention(qs8, ks8, vs8, is_causal=True)
    dout8 = do8h.transpose(1, 2).contiguous()
    hyb19["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        out8, (qs8, ks8, vs8), dout8, retain_graph=True), 5)
    del qs8, ks8, vs8, out8, dout8, hyb_args, q8h, k8h, v8h, do8h, o8h
    # qwen3-moe-30b-a3b's attention (GQA 8): K9 folds the group's 8 heads.
    q8g, k8g, v8g, do8g = (torch.randn(s_, generator=gq, device=dev)
                           .to(torch.bfloat16)
                           for s_ in ((Bg, Sg, Hg, hdg), (Bg, Sg, KVg, hdg),
                                      (Bg, Sg, KVg, hdg), (Bg, Sg, Hg, hdg)))
    o8g, lse8g = flash_fwd(q8g, k8g, v8g, causal=True)
    gqa_args = (q8g, k8g, v8g, do8g, lse8g, flash_delta(o8g, do8g))
    gqa_pairs = Bg * Hg * (Sg * (Sg + 1) // 2)
    gqa_stat = 2 * Bg * Hg * Sg * 4
    gqa_k8_bytes = gqa_bytes + gqa_stat + 2 * Bg * Sg * Hg * hdg
    gqa_k9_bytes = gqa_bytes + gqa_stat + 2 * 2 * Bg * Sg * KVg * hdg
    gqa19 = {"shape": list(MOE_SHAPES["qwen3-moe-30b-a3b"]),
             "k8_ms": graph_ms(lambda: launch_bwd_dq(*gqa_args, **kw8), 5),
             "k9_ms": graph_ms(lambda: launch_bwd_dkv(*gqa_args, **kw8), 5),
             "k8_plain_ms": time_ms(lambda: flash_bwd_dq_plain(
                 *gqa_args, causal=True), 3),
             "k9_plain_ms": time_ms(lambda: flash_bwd_dkv_plain(
                 *gqa_args, causal=True), 3),
             "k8_bound_ms": max(6 * hdg * gqa_pairs / PEAK_BF16_FLOPS,
                                gqa_k8_bytes / PEAK_BYTES) * 1e3,
             "k9_bound_ms": max(8 * hdg * gqa_pairs / PEAK_BF16_FLOPS,
                                gqa_k9_bytes / PEAK_BYTES) * 1e3}
    qs8, ks8, vs8 = (t_.transpose(1, 2).contiguous().requires_grad_()
                     for t_ in (q8g, k8g, v8g))
    out8 = F.scaled_dot_product_attention(qs8, ks8, vs8, is_causal=True,
                                          enable_gqa=True)
    dout8 = do8g.transpose(1, 2).contiguous()
    gqa19["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        out8, (qs8, ks8, vs8), dout8, retain_graph=True), 5)
    del qs8, ks8, vs8, out8, dout8, gqa_args, q8g, k8g, v8g, do8g, o8g

    ve19 = {label: k89_timing(*FLASH_CASES[label][:2], dev, gq, graph_ms,
                              time_ms)
            for label in (*VE_CASES, *DENSE_CASES.values())}
    emit({"phase": 19, "shape": list(LM_SHAPE), "dtype": "bfloat16",
          "hybrid_shape": hyb19, "moe_gqa8_shape": gqa19,
          "vlm_encdec_shapes": {k: ve19[k] for k in VE_CASES},
          "dense_shapes": {k: ve19[k] for k in DENSE_CASES.values()},
          "k8_ms": k8_ms, "k9_ms": k9_ms, "k8_plain_ms": k8_plain,
          "k9_plain_ms": k9_plain, "sdpa_bwd_ms": sdpa_bwd_ms,
          "k8_bound_ms": max(k8_ops / PEAK_BF16_FLOPS,
                             k8_bytes / PEAK_BYTES) * 1e3,
          "k9_bound_ms": max(k9_ops / PEAK_BF16_FLOPS,
                             k9_bytes / PEAK_BYTES) * 1e3,
          "k8_TFLOPs": k8_ops / (k8_ms * 1e-3) / 1e12,
          "k9_TFLOPs": k9_ops / (k9_ms * 1e-3) / 1e12,
          "hgmma_by_instance": hgmma_bwd, "ptxas": bwd_ptxas})

    def entry(name, source, replaces, ms, plain_ms, nbytes, ops, lib_ms,
              extra, path_launches=launches, peak_flops=PEAK_FP32_FLOPS):
        tb, to = nbytes / PEAK_BYTES * 1e3, ops / peak_flops * 1e3
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": path_launches.get(name, 0),
                "max_abs_err": worst[name]["float32"], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(tb, to),
                "bound_by": "bytes" if tb >= to else "operations",
                "library_ms": lib_ms, **extra}

    kernels = [
        entry("stencil2d", "src/repro_torch/csrc/stencil2d.cu",
              "src/repro/kernels/stencil2d.py:125", k1_ms, k1_plain,
              k1_bytes, k1_ops, None,
              {"shape": [1, *HET_GRID], "fields": 4, "eager_ms": k1_eager,
               "max_abs_err_bf16": worst["stencil2d"]["bfloat16"]}),
        entry("jacobi2d_trapezoid", "src/repro_torch/csrc/jacobi_fused.cu",
              "src/repro/kernels/jacobi_fused.py:247", k2_ms, k2_plain,
              2 * n_big * 4, k2_ops, conv_big_ms,
              {"case": "8192x8192 fuse 1", "kernel": "stream",
               "shape": [1, *big], "fuse": 1, "eager_ms": k2_eager,
               "tile_kernel_ms": k2_tile_ms,
               "max_abs_err_bf16": worst["jacobi2d_trapezoid"]["bfloat16"]}),
        entry("jacobi2d_trapezoid", "src/repro_torch/csrc/jacobi_fused.cu",
              "src/repro/kernels/jacobi_fused.py:247", k2_f16, k2_f16_plain,
              2 * n_big * 4, 16 * k2_ops, None,
              {"case": "8192x8192 fuse 16", "kernel": "stream",
               "shape": [1, *big], "fuse": 16, "tile_kernel_ms": k2_f16_tile,
               "plain_timing": "eager",
               "fuse1_bound_ms_x16": 16 * 2 * n_big * 4 / PEAK_BYTES * 1e3,
               "max_abs_err_fuse16": k2_err}),
        # Table 1's trapezoid request, named for the kernel the shape sends
        # it to; its launches are the Table-1 solve's own.
        entry(K23_COUNTERS[t1_kernel], "src/repro_torch/csrc/jacobi_fused.cu",
              "src/repro/kernels/jacobi_fused.py:247", k2_t1_ms, k2_t1_plain,
              2 * 64 * 64 * 4, t1_fuse * k3_ops // n_iters, None,
              {"case": "Table-1 launch, 64x64 trapezoid fuse 4, batch 1",
               "kernel": t1_kernel, "eager_ms": k2_t1_eager,
               **{f"{k}_kernel_ms": v for k, v in k2_t1_by_name.items()}},
              t1_launches),
        entry("jacobi2d_resident", "src/repro_torch/csrc/jacobi_fused.cu",
              "src/repro/kernels/jacobi_fused.py:215", k3_ms, k3_plain,
              2 * 64 * 64 * 4, k3_ops, None,
              {"case": "64x64 fuse 7960", "kernel": "resident_regs",
               "shape": [1, 64, 64], "fuse": n_iters,
               "one_sm_bound_ms": k3_ops / (PEAK_FP32_FLOPS / sms) * 1e3,
               "smem_kernel_ms": k3_smem_ms, "cta_kernel_ms": k3_cta_ms,
               "plain_timing": "eager", "conv2d_one_sweep_ms": conv64_ms,
               "max_abs_err_bf16": worst["jacobi2d_resident"]["bfloat16"]}),
        entry("jacobi2d_resident_grid",
              "src/repro_torch/csrc/jacobi_fused.cu",
              "src/repro/kernels/jacobi_fused.py:215", kg_ms, kg_plain,
              2 * n_res * 4, kg_ops, None,
              {"case": f"{RESIDENT_BIG[0]}x{RESIDENT_BIG[1]} fuse "
                       f"{RESIDENT_BIG_ITERS}", "kernel": "resident_grid",
               "shape": [1, *RESIDENT_BIG], "fuse": RESIDENT_BIG_ITERS,
               "eager_ms": kg_eager, "plain_timing": "eager",
               "stream_kernel_ms": kg_stream_ms,
               "stream_passes": len(trapezoid_passes(RESIDENT_BIG_ITERS, 1)),
               "max_abs_err_bf16":
                   worst["jacobi2d_resident_grid"]["bfloat16"]}),
        entry("stencil3d", "src/repro_torch/csrc/stencil3d.cu",
              "src/repro/kernels/stencil3d.py:117", k4_ms, k4_plain,
              2 * n3 * 4, k4_ops, conv3d_ms,
              {"shape": [PAPER_BATCH, *FIG6_GRID], "eager_ms": k4_eager,
               "plain_timing": "eager", "library": "F.conv3d",
               "conv2d_channels_ms": conv2d_ch_ms,
               "deep_grid_ms": k4_deep_ms,
               "deep_grid_bound_ms": 2 * n_deep * 4 / PEAK_BYTES * 1e3,
               "cell_kernel_ms": k4_cell_ms,
               "deep_grid_cell_kernel_ms": k4_deep_cell_ms,
               "fig6_grid_ms": k4_one["ms"],
               "fig6_grid_cell_kernel_ms": k4_one["cell_kernel_ms"],
               "fig6_grid_stream_kernel_ms": k4_one["stream_kernel_ms"],
               "max_abs_err_bf16": worst["stencil3d"]["bfloat16"]},
              launches3),
        entry("dense_stencil_matmul",
              "src/repro_torch/csrc/dense_stencil_sm90.cu",
              "src/repro/kernels/dense_stencil.py:61", k5_ms, k5_plain,
              k5_bytes, k5_ops, matmul_ms,
              {"shape": [DENSE_BATCH, nd_, nd_], "plain_timing": "eager",
               "library": "torch.matmul (TF32 off)",
               "bound": "2 S N^2 at the bf16 tensor-core rate",
               "six_product_bound_ms":
                   K5_PRODUCTS * k5_ops / PEAK_BF16_FLOPS * 1e3,
               "simt_fp32_bound_ms": k5_ops / PEAK_FP32_FLOPS * 1e3,
               "norm_err_vs_fp64": norm_err,
               "hgmma": sum(hgmma_k5.values()),
               "bf16_ms": k5_bf16_ms, "bf16_plain_ms": k5_bf16_plain,
               "bf16_library_ms": matmul_bf16_ms,
               "bf16_bound_ms": k5_ops / PEAK_BF16_FLOPS * 1e3,
               "max_abs_err_bf16": worst["dense_stencil_matmul"]["bfloat16"]},
              launches5, PEAK_BF16_FLOPS),
        entry("split_bf16x3", "src/repro_torch/csrc/dense_stencil_sm90.cu",
              "src/repro/kernels/dense_stencil.py:61", split_ms,
              split_plain_ms, split_bytes, 0, None,
              {"shape": [DENSE_BATCH, nd_], "plain_timing": "eager",
               "part_of": "dense_stencil_matmul (fp32 route: x and W "
                          "split into three bf16 pieces)"},
              launches5),
        entry("flash_attention",
              "src/repro_torch/csrc/flash_attention_sm90.cu",
              "src/repro/kernels/flash_attention.py:122", k6_ms, k67_plain,
              lm_bytes, lm_ops, sdpa_ms,
              {"shape": list(LM_SHAPE), "dtype": "bfloat16",
               "plain_timing": "eager",
               "fp32_source": "src/repro_torch/csrc/flash_attention.cu",
               "library": "F.scaled_dot_product_attention",
               "path": "not on the serve path (K7 is); held on the card "
                       "in phase 12",
               "max_abs_err_bf16": worst["flash_attention"]["bfloat16"]},
              launches7, PEAK_BF16_FLOPS),
        entry("flash_fwd", "src/repro_torch/csrc/flash_attention_sm90.cu",
              "src/repro/kernels/flash_attention_bwd.py:86", k7_ms,
              k67_plain, lm_bytes + lse_bytes, lm_ops, sdpa_ms,
              {"shape": list(LM_SHAPE), "dtype": "bfloat16",
               "plain_timing": "eager", "fp32_ms": k7_fp32_ms,
               "fp32_source": "src/repro_torch/csrc/flash_attention.cu",
               "hgmma": sum(hgmma.values()),
               "library": "F.scaled_dot_product_attention",
               "max_abs_err_bf16": worst["flash_fwd"]["bfloat16"],
               "lse_max_rel_err": lse_worst},
              launches7, PEAK_BF16_FLOPS),
        entry("flash_bwd_dq",
              "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
              "src/repro/kernels/flash_attention_bwd.py:223", k8_ms,
              k8_plain, k8_bytes, k8_ops, sdpa_bwd_ms,
              {"shape": list(LM_SHAPE), "dtype": "bfloat16",
               "plain_timing": "eager",
               "fp32_source": "src/repro_torch/csrc/flash_attention_bwd.cu",
               "hgmma": sum(n for f, n in hgmma_bwd.items()
                            if "flash_bwd_dq_" in f),
               "library": "backward of F.scaled_dot_product_attention "
                          "(dq, dk and dv together)",
               "max_abs_err_bf16": worst["flash_bwd_dq"]["bfloat16"]},
              launches18, PEAK_BF16_FLOPS),
        entry("flash_bwd_dkv",
              "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
              "src/repro/kernels/flash_attention_bwd.py:249", k9_ms,
              k9_plain, k9_bytes, k9_ops, sdpa_bwd_ms,
              {"shape": list(LM_SHAPE), "dtype": "bfloat16",
               "plain_timing": "eager",
               "fp32_source": "src/repro_torch/csrc/flash_attention_bwd.cu",
               "hgmma": sum(n for f, n in hgmma_bwd.items()
                            if "flash_bwd_dkv_" in f),
               "library": "backward of F.scaled_dot_product_attention "
                          "(dq, dk and dv together)",
               "max_abs_err_bf16": worst["flash_bwd_dkv"]["bfloat16"]},
              launches18, PEAK_BF16_FLOPS),
    ]
    # -- 20-22. the stencil serving tier ----------------------------------------
    torch.cuda.empty_cache()
    tier = stencil_serving_phases(dev, args.write_tuned)
    named = set().union(*tier["launches"].values())
    check("stencil2d" in named and "stencil3d" in named
          and any(k.startswith("jacobi2d_") for k in named),
          f"the serving tier's phases did not launch K1, K2/K3 and K4: "
          f"{sorted(named)}")
    emit({"serving_tier_launches": {str(k): v for k, v
                                    in tier["launches"].items()},
          "seconds": tier["seconds"], "peak_gb": tier["peak_gb"]})

    # -- 23. the differentiable solve ---------------------------------------
    torch.cuda.empty_cache()
    emit(adjoint_phase(dev, smi))

    kernels[-3]["train_launches"] = launches18.get("flash_fwd", 0)
    # -- 24-26. the ssm and hybrid families ------------------------------------
    torch.cuda.empty_cache()
    fam = lm_families_phases(dev, device_profile)
    zamba = "zamba2-1.2b"
    serve_z, train_z = fam["launches"][(24, zamba)], fam["launches"][(26,
                                                                      zamba)]
    hybrid_rows = {"shape": list(HYBRID_SHAPE), "dtype": "bfloat16",
                   "case": "zamba2-1.2b's shared attention (MHA, head_dim "
                           "64)", "plain_timing": "eager",
                   "library": "F.scaled_dot_product_attention"}
    dkv_err = max(case_err[("flash_bwd_dkv", f"hybrid_shape {g}",
                            "bfloat16")] for g in ("dk", "dv"))
    kernels += [
        entry("flash_fwd", "src/repro_torch/csrc/flash_attention_sm90.cu",
              "src/repro/kernels/flash_attention_bwd.py:86", hyb15["k7_ms"],
              hyb15["plain_ms"], hyb_bytes + hyb_lse_bytes, hyb_ops,
              hyb15["sdpa_ms"],
              {**hybrid_rows, "train_launches": train_z.get("flash_fwd", 0),
               "max_abs_err": case_err[("flash_fwd", "hybrid_shape",
                                        "bfloat16")]},
              serve_z, PEAK_BF16_FLOPS),
        entry("flash_bwd_dq",
              "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
              "src/repro/kernels/flash_attention_bwd.py:223",
              hyb19["k8_ms"], hyb19["k8_plain_ms"],
              hyb_qkv + hyb_stat + 2 * Bh * Sh * Hh * hdh,
              6 * hdh * hyb_pairs, hyb19["sdpa_bwd_ms"],
              {**hybrid_rows, "library": "backward of "
               "F.scaled_dot_product_attention (dq, dk and dv together)",
               "max_abs_err": case_err[("flash_bwd_dq", "hybrid_shape",
                                        "bfloat16")]},
              train_z, PEAK_BF16_FLOPS),
        entry("flash_bwd_dkv",
              "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
              "src/repro/kernels/flash_attention_bwd.py:249",
              hyb19["k9_ms"], hyb19["k9_plain_ms"],
              hyb_qkv + hyb_stat + 2 * 2 * Bh * Sh * KVh * hdh,
              8 * hdh * hyb_pairs, hyb19["sdpa_bwd_ms"],
              {**hybrid_rows, "library": "backward of "
               "F.scaled_dot_product_attention (dq, dk and dv together)",
               "max_abs_err": dkv_err},
              train_z, PEAK_BF16_FLOPS)]
    for (phase, arch), got in fam["launches"].items():
        check(arch == zamba or not got, f"{arch} launched {got} in phase "
              f"{phase}")
    check(serve_z == {"flash_fwd": 12}, f"zamba2's serve path launched "
          f"{serve_z}")
    steps26 = SSM_TRAIN[2]
    check(train_z == {"flash_fwd": 12 * steps26, "flash_bwd_dq": 6 * steps26,
                      "flash_bwd_dkv": 6 * steps26},
          f"zamba2's train path launched {train_z}")

    # -- 27-29. the moe family -------------------------------------------------
    torch.cuda.empty_cache()
    moe = moe_phases(dev, device_profile)
    qwen_moe = "qwen3-moe-30b-a3b"
    serve_m, train_m = (moe["launches"][(27, qwen_moe)],
                        moe["launches"][(29, qwen_moe)])
    gqa_rows = {"shape": list(MOE_SHAPES[qwen_moe]), "dtype": "bfloat16",
                "case": "qwen3-moe-30b-a3b's attention (GQA 8: 32 query "
                        "heads on 4 kv heads, head_dim 128)",
                "plain_timing": "eager",
                "library": "F.scaled_dot_product_attention (enable_gqa)"}
    bwd_library = ("backward of F.scaled_dot_product_attention (enable_gqa;"
                   " dq, dk and dv together)")
    gqa_case = f"{qwen_moe} shape"
    kernels += [
        entry("flash_fwd", "src/repro_torch/csrc/flash_attention_sm90.cu",
              "src/repro/kernels/flash_attention_bwd.py:86", gqa15["k7_ms"],
              gqa15["plain_ms"], gqa_bytes + gqa_lse_bytes, gqa_ops,
              gqa15["sdpa_ms"],
              {**gqa_rows, "train_launches": train_m.get("flash_fwd", 0),
               "max_abs_err": case_err[("flash_fwd", gqa_case,
                                        "bfloat16")]},
              serve_m, PEAK_BF16_FLOPS),
        entry("flash_bwd_dq",
              "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
              "src/repro/kernels/flash_attention_bwd.py:223",
              gqa19["k8_ms"], gqa19["k8_plain_ms"], gqa_k8_bytes,
              6 * hdg * gqa_pairs, gqa19["sdpa_bwd_ms"],
              {**gqa_rows, "library": bwd_library,
               "max_abs_err": case_err[("flash_bwd_dq", gqa_case,
                                        "bfloat16")]},
              train_m, PEAK_BF16_FLOPS),
        entry("flash_bwd_dkv",
              "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
              "src/repro/kernels/flash_attention_bwd.py:249",
              gqa19["k9_ms"], gqa19["k9_plain_ms"], gqa_k9_bytes,
              8 * hdg * gqa_pairs, gqa19["sdpa_bwd_ms"],
              {**gqa_rows, "library": bwd_library,
               "max_abs_err": max(case_err[("flash_bwd_dkv",
                                            f"{gqa_case} {g}", "bfloat16")]
                                  for g in ("dk", "dv"))},
              train_m, PEAK_BF16_FLOPS)]
    steps29 = MOE_TRAIN[2]
    for arch in MOE_ARCHS:
        n = get_config(arch).n_layers
        check(moe["launches"][(27, arch)] == {"flash_fwd": 2 * n},
              f"{arch}'s serve path launched {moe['launches'][(27, arch)]}")
        check(moe["launches"][(29, arch)] == {
            "flash_fwd": 2 * MOE_TRAIN_DEPTH * steps29,
            "flash_bwd_dq": MOE_TRAIN_DEPTH * steps29,
            "flash_bwd_dkv": MOE_TRAIN_DEPTH * steps29},
            f"{arch}'s train path launched {moe['launches'][(29, arch)]}")

    # -- 30-32. the vlm and encdec families ------------------------------------
    torch.cuda.empty_cache()
    ve = vlm_encdec_phases(dev, device_profile)
    ve_paths = {"vlm_shape": (30, VLM_ARCH),
                "whisper_encoder": (31, ENCDEC_ARCH),
                "whisper_cross": (31, ENCDEC_ARCH)}
    ve_case = {
        "vlm_shape": "qwen2-vl-2b's attention (GQA 6: 12 query heads on 2 "
                     "kv heads, head_dim 128), causal",
        "whisper_encoder": "whisper-tiny's encoder self-attention (MHA 6, "
                           "head_dim 64, 1500 frames), non-causal",
        "whisper_cross": "whisper-tiny's cross-attention (224 decoder "
                         "tokens on 1500 frames), non-causal"}
    for label in VE_CASES:
        phase, arch = ve_paths[label]
        serve_l, train_l = (ve["launches"][(phase, arch)],
                            ve["launches"][(phase, f"{arch} train")])
        t15, t19 = ve15[label], ve19[label]
        rows = {"shape": t15["shape"], "causal": t15["causal"],
                "dtype": "bfloat16", "case": ve_case[label],
                "plain_timing": "eager",
                "library": "F.scaled_dot_product_attention"
                           + (" (enable_gqa)" if label == "vlm_shape"
                              else "")}
        if arch == ENCDEC_ARCH:
            rows["launches_note"] = ("the path's count over all of its "
                                     "attention: encoder, decoder self and "
                                     "cross, a layer each")
        bwd_library = "backward of " + rows["library"] + (
            " (dq, dk and dv together)")
        kernels += [
            entry("flash_fwd", "src/repro_torch/csrc/flash_attention_sm90.cu",
                  "src/repro/kernels/flash_attention_bwd.py:86",
                  t15["k7_ms"], t15["plain_ms"], t15["bytes"],
                  t15["operations"], t15["sdpa_ms"],
                  {**rows, "train_launches": train_l.get("flash_fwd", 0),
                   "max_abs_err": case_err[("flash_fwd", label,
                                            "bfloat16")]},
                  serve_l, PEAK_BF16_FLOPS),
            entry("flash_bwd_dq",
                  "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
                  "src/repro/kernels/flash_attention_bwd.py:223",
                  t19["k8_ms"], t19["k8_plain_ms"], t19["k8_bytes"],
                  t19["k8_operations"], t19["sdpa_bwd_ms"],
                  {**rows, "library": bwd_library,
                   "max_abs_err": case_err[("flash_bwd_dq", label,
                                            "bfloat16")]},
                  train_l, PEAK_BF16_FLOPS),
            entry("flash_bwd_dkv",
                  "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
                  "src/repro/kernels/flash_attention_bwd.py:249",
                  t19["k9_ms"], t19["k9_plain_ms"], t19["k9_bytes"],
                  t19["k9_operations"], t19["sdpa_bwd_ms"],
                  {**rows, "library": bwd_library,
                   "max_abs_err": max(case_err[("flash_bwd_dkv",
                                                f"{label} {g}", "bfloat16")]
                                      for g in ("dk", "dv"))},
                  train_l, PEAK_BF16_FLOPS)]
    for phase, arch, steps in ((30, VLM_ARCH, VLM_TRAIN[2]),
                               (31, ENCDEC_ARCH, ENC_TRAIN[2])):
        cfg = get_config(arch)
        uses = (cfg.n_enc_layers + 2 * cfg.n_layers
                if cfg.family == "encdec" else cfg.n_layers)
        check(ve["launches"][(phase, arch)] == {"flash_fwd": 2 * uses},
              f"{arch}'s serve path launched "
              f"{ve['launches'][(phase, arch)]}")
        check(ve["launches"][(phase, f"{arch} train")] == {
            "flash_fwd": 2 * uses * steps, "flash_bwd_dq": uses * steps,
            "flash_bwd_dkv": uses * steps},
            f"{arch}'s train path launched "
            f"{ve['launches'][(phase, f'{arch} train')]}")

    # -- 33-35. the dense family's last archs, and a restart ------------------
    torch.cuda.empty_cache()
    dense = dense_ft_phases(dev, device_profile)
    for arch, label in DENSE_CASES.items():
        cfg = get_config(arch)
        serve_l, train_l = (dense["launches"][(33, arch)],
                            dense["launches"][(34, arch)])
        t15, t19 = ve15[label], ve19[label]
        shape = t15["shape"]
        rows = {"shape": shape, "causal": True, "dtype": "bfloat16",
                "case": f"{arch}'s attention (GQA {shape[3] // shape[4]}: "
                        f"{shape[3]} query heads on {shape[4]} kv heads, "
                        f"head_dim 128), causal",
                "plain_timing": "eager",
                "train_depth": DENSE_TRAIN_DEPTH[arch],
                "library": "F.scaled_dot_product_attention (enable_gqa)"}
        bwd_library = ("backward of F.scaled_dot_product_attention "
                       "(enable_gqa; dq, dk and dv together)")
        kernels += [
            entry("flash_fwd", "src/repro_torch/csrc/flash_attention_sm90.cu",
                  "src/repro/kernels/flash_attention_bwd.py:86",
                  t15["k7_ms"], t15["plain_ms"], t15["bytes"],
                  t15["operations"], t15["sdpa_ms"],
                  {**rows, "train_launches": train_l.get("flash_fwd", 0),
                   "max_abs_err": case_err[("flash_fwd", label,
                                            "bfloat16")]},
                  serve_l, PEAK_BF16_FLOPS),
            entry("flash_bwd_dq",
                  "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
                  "src/repro/kernels/flash_attention_bwd.py:223",
                  t19["k8_ms"], t19["k8_plain_ms"], t19["k8_bytes"],
                  t19["k8_operations"], t19["sdpa_bwd_ms"],
                  {**rows, "library": bwd_library,
                   "max_abs_err": case_err[("flash_bwd_dq", label,
                                            "bfloat16")]},
                  train_l, PEAK_BF16_FLOPS),
            entry("flash_bwd_dkv",
                  "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
                  "src/repro/kernels/flash_attention_bwd.py:249",
                  t19["k9_ms"], t19["k9_plain_ms"], t19["k9_bytes"],
                  t19["k9_operations"], t19["sdpa_bwd_ms"],
                  {**rows, "library": bwd_library,
                   "max_abs_err": max(case_err[("flash_bwd_dkv",
                                                f"{label} {g}", "bfloat16")]
                                      for g in ("dk", "dv"))},
                  train_l, PEAK_BF16_FLOPS)]
        check(serve_l == {"flash_fwd": 2 * cfg.n_layers},
              f"{arch}'s serve path launched {serve_l}")
        depth, steps = DENSE_TRAIN_DEPTH[arch], DENSE_TRAIN[2]
        check(train_l == {"flash_fwd": 2 * depth * steps,
                          "flash_bwd_dq": depth * steps,
                          "flash_bwd_dkv": depth * steps},
              f"{arch}'s train path launched {train_l}")
    # qwen3-0.6b's K7 row (the first): phase 35's runs launch its shape.
    next(k for k in kernels if k["name"] == "flash_fwd")[
        "restart_launches"] = {k[1]: v for k, v in dense["launches"].items()
                               if k[0] == 35}

    # -- 36. halo distribution on a tile mesh ----------------------------------
    torch.cuda.empty_cache()
    emit(halo_phase(dev, smi, {1: k2_ms, 16: k2_f16}))

    # -- 37. LM distribution on a data x model mesh ----------------------------
    torch.cuda.empty_cache()
    dist = lm_distribution_phase(dev, flash_case, bwd_case, graph_ms,
                                 time_ms, device_profile)
    kernels += dist_kernel_rows(dist, entry, case_err)

    # -- 38. every other LM family on the mesh ----------------------------------
    torch.cuda.empty_cache()
    fam = families_distribution_phase(dev, flash_case, bwd_case, graph_ms,
                                      time_ms, device_profile)
    kernels += families_kernel_rows(fam, entry, case_err)

    # -- 39. the launch tooling and state_over_data decode ---------------------
    torch.cuda.empty_cache()
    lt = launch_tooling_phase(dev, flash_case, bwd_case, graph_ms, time_ms,
                              device_profile)
    kernels += launch_kernel_rows(lt, entry, case_err)

    # -- 41. the JAX package's last public API on the card ---------------------
    torch.cuda.empty_cache()
    emit(api_phase(smi))

    check(launches7.get("flash_fwd", 0) == 2 * cfg_f.n_layers,
          f"the serve path launched {launches7}")
    check(launches18 == {k: T18 * n for k, n in step_launches.items()},
          f"the train path launched {launches18}")
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
