#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card (H100 class, sm_90a) and nvcc; exits non-zero and
prints no result without a card, or when run outside the repository.
Phases, one line each; any failure raises and exits non-zero:

1. environment: torch / CUDA versions, the card's name and power limit
   (nvidia-smi), the matmul precision settings used throughout;
2. build every kernel from the repository's sources (kernels/csrc/);
   ptxas' registers and spills for each instantiation of the wgmma flash
   kernels (forward, dQ, dK/dV), of the projection-LN's cluster kernels,
   of the SwiGLU backward's wgmma kernels (its P1 and the GEMM core's
   instantiations, which the GeLU backward shares), of the GeLU
   backward's own (its P1, the core at P3 / P4's narrower tile) and of
   the forwards' (the core's P1: the GeLU's EpiGelu, the SwiGLU's paired
   EpiSwiglu; P2: EpiBias with and without the dropout key, EpiSum,
   EpiStore, EpiSumLast), every wgmma kernel of fused_mlp.cu listed once,
   and of the decode split route's, the persistent LayerNorm
   backward's, the persistent BatchNorm backward's and the cluster
   BatchNorm forward's instantiations (none may spill);
3. the decode kernels against their plain PyTorch version on the card
   at the main path's shapes (GPT-3 1.3B: NH=16, D=128, HO=2048,
   block_size 16, 64-entry tables, MHA and GQA at KVH 4, positions 0,
   15, 16, 511, 1023), fp32 and bf16, on the split route decode_route
   gives (decode_attn_split_kernel, then decode_proj_kernel as its
   programmatic dependent) and on the generic one, each within TOL and
   DECODE_REL_TOL, two calls giving the same bits; the check shown to
   reject the kernel with its last context split left out; the split
   route's time in turns with the generic route's, the plain version's
   and a PyTorch library call's, and its bound, at pos 511, then at pos
   1023 and at KVH 4; the CUDA launches a call of each route from a
   profile (split 2 at most, generic 3);
4. serve gpt3-1.3b (random weights from a seed, bf16, full width and
   depth) through ServingEngine with FLAGS_serving_decode_kernel on at
   max_batch=1: 4 greedy requests, prompts 128/256/384/512, 32 new
   tokens each; every B=1 decode step must launch the kernel once per
   layer, every call on the split route;
5. torch.profiler over 8 more B=1 decode steps: device busy time per
   step, idle share, the kernels that take the time (the decode
   kernels' share by DECODE_KERNELS);
6. serve with max_batch=4 and device_loop_k=4: 8 requests, greedy and
   sampled mixed;
7. parity in fp32 at full width: one request, 16 greedy tokens, decode
   kernel on vs the composite PyTorch path: same tokens, close logits;
8. the three flash-attention kernels (forward, dQ, dK/dV) against their
   plain versions on the card: causal and not, S 2048 and 1000 (ragged),
   B*NH 64 and 16, D=128; D=64; Sq=512 with Sk=1000; D=96 (bf16 on the
   generic forward); fp32 and bf16 (out, lse, dq, dk, dv), each element
   within its row's scale, each forward and backward on the route
   fwd_route / bwd_route gives it (the wgmma kernels for bf16 at D 64
   and 128, read on the route counters), each bf16 backward repeating
   bit for bit; the check shown to reject a forward missing one tile of
   64 or of 128 rows, a dQ missing its diagonal KV tile and a dK/dV
   missing the first q tile of its band; the backward's pre-pass (qs, ks
   bit for bit, delta); then their times at the slice's
   shape (B=4, NH=16, S=2048, bf16, causal) beside the plain versions'
   and the bound, the forward, dQ and dK/dV beside the generic kernels
   they replaced there (in turns), the forward beside SDPA's forward,
   and the whole backward (the pre-pass, dQ, dK/dV) beside SDPA's
   backward and the generic route's;
9. the three fused MLP kernels (forward, dX, dW) against their plain
   versions on the card: gpt3-1.3b (R=8192, H=2048, F=8192), bert-base
   (R=16384, H=768, F=3072) and ragged shapes (R=1000/333, H=96/100,
   F=320/360/200/2560), fp32 and bf16, both GeLU forms (y, dx, dw1,
   db1, dw2, db2), each element within its row's scale; the forward's
   and backward's route per case (mlp_fwd_routes, mlp_bwd_routes: the
   bf16 cases with H and F multiples of 8 on the wgmma kernels, the rest
   on the generic ones); two backward calls give the same bits; the
   check shown to reject a forward missing one ffn chunk's down product
   (the wgmma route's chunk), a forward without b2 and a dW1 missing one
   128-row block of R; their times at gpt3-1.3b's and bert-base's shapes
   beside the plain versions' and the bound, the forward beside the
   dense addmm -> gelu -> addmm, the shared backward beside that
   composite's backward, both beside the generic route in turns; the
   forward's CUDA launches a call (2 a chunk) read in phases 11, 17, 24
   and 34's profiles;
10. train gpt3-1.3b (random weights from a seed, bf16, full width and
   depth, FLAGS_fused_mlp on as by default, remat save_small, bf16 AdamW
   moments, the plain LM head) at B=4, S=2048 on one fixed batch: one
   warm-up step, then 4 steps; finite, falling loss; the fused MLP path
   taken; each flash and fused MLP kernel launched 24 times per step,
   every flash forward and backward on the wgmma kernels (the route
   counters, as in phases 12, 13, 16, 18, 23, 25, 33 and 35), every
   GeLU MLP forward and backward on the wgmma route (as in phases 11,
   12, 23, 24, 33 and 34; none with the fused MLP off, 13, 25, 35);
   ms/step, tokens/s, model TFLOP/s, peak memory, and the card's SM
   clock, power draw and temperature sampled during the timed steps;
11. torch.profiler over 2 more training steps: device busy time per
   step, idle share, the flash and fused MLP kernels' shares (the fused
   MLP's by direction, as in phases 17, 24 and 34), the kernels that
   take the time;
12. one step under remat 'full': the flash and fused MLP forwards run 48
   times, the backward kernels 24;
13. the same training with FLAGS_fused_mlp off (the dense MLP; 1 warm-up
   and 2 steps): ms/step, peak memory and the card's clocks beside the
   fused step's, whose peak may exceed it by no more than the kernels'
   workspace;
14. parity in fp32 at gpt3-1.3b width, 2 layers, B=1, S=2048: loss and
   every gradient with the fused MLP kernels vs the dense MLP, and with
   the flash kernels vs _block_apply's dense attention branch;
15. the fused SwiGLU kernels (forward, and the backward that computes dX
   and dW in one call) against their plain versions on the card through
   the custom ops and autograd through fused_swiglu_2d: llama-7b (R=2048,
   H=4096, F=11008, the last ffn chunk ragged) and ragged shapes
   (R=1000/333, H=96/2048/100, F=320/2560/4608/200), fp32 and bf16 (y, dx,
   dwg, dwu, dwd), each element within its row's scale; the forward's
   and backward's route per case (swiglu_fwd_routes, swiglu_bwd_routes:
   the bf16 cases with H and F multiples of 8 on the wgmma kernels, the
   rest on the generic ones); two backward calls give the same bits; the
   check shown to reject a forward missing one ffn chunk's down product
   and a dWg missing one 128-row block of R; their times at llama-7b
   shape beside the plain versions', the bound and the dense silu-gated
   composite through cuBLAS (forward, and its autograd backward), both
   also beside the generic route in turns;
16. train llama-7b (random weights from a seed, bf16, full width and
   depth, FLAGS_fused_mlp on as by default) through the Layer model and
   AdamW (model.loss -> backward -> opt.step -> opt.clear_grad) at B=1,
   S=2048 on one fixed batch: one warm-up step, then 4 steps; finite,
   falling loss; each SwiGLU and flash kernel launched 32 times per step,
   every SwiGLU forward and backward on the wgmma route;
   ms/step, tokens/s, model TFLOP/s, the AdamW update's ms (CUDA events),
   peak memory and the card's clocks;
17. torch.profiler over 2 more llama-7b steps (every SwiGLU forward and
   backward on the wgmma route): device busy time per step,
   idle share, the flash and SwiGLU kernels' shares, the optimizer
   step's device time, the kernels that take the time;
18. the same llama-7b training with FLAGS_fused_mlp off (the dense
   SwiGLU through cuBLAS; 1 warm-up and 2 steps): ms/step and peak
   memory beside the fused step's;
19. parity in fp32 at llama-7b width, 2 layers, B=1, S=2048: loss and
   every gradient with the SwiGLU kernels vs the dense SwiGLU, and with
   the flash kernels vs a dense causal attention written here;
20. the LayerNorm kernels (forward; backward with its fixed-order column
   sums) through their custom ops against their plain versions (and,
   below, their dropout variants):
   bert-base rows (R=16384, H=768), a ragged R=16383, H=1024 and 2048
   (the GPT Layer model's norms), f32 and bf16, all four (residual,
   bias) variants; two backward calls give the same bits; autograd
   through fused_layer_norm_2d in bf16 at bert-base shape against the
   plain versions and bitwise against the ops; the check shown to reject
   a forward without the residual and a backward missing its first 32
   rows; their times with and without the residual beside the plain
   versions', the bound and F.layer_norm(res + h) with its autograd
   backward; the dropout variants (p = 0.1, the mask keyed by the
   reference's row tile) at bert-base rows, a ragged R with H = 1024 and
   H = 100, f32 and bf16: dh's zeros equal to the plain mask's, every
   output within the tolerance, repeat bits, the mask keyed by the CUDA
   block's rows rejected, and their times beside F.dropout -> + res ->
   F.layer_norm; the backward on the route ln_bwd_route gives (the
   persistent ln_bwd_persist on every case but bf16 and f32 H 2048),
   the generic kernels held beside it on the same inputs, the routes
   counted; its kernels alone timed in turns with the generic ones, and
   its CUDA launches a call from a profile (2 at most);
21. the projection-LayerNorm kernels through their custom ops against
   their plain versions (R=16384, Hin=Hout=768 and 1024; a ragged R with
   Hin != Hout; f32 and bf16); two backward calls give the same bits;
   autograd through fused_proj_ln_2d in bf16 at bert-base shape against
   the plain versions; the check shown to reject a forward missing one
   256-column chunk of the product and a backward missing one 32-row
   partial; their times at bert-base shape beside the plain versions',
   the bound and F.layer_norm(res + addmm(b, x, W)) with its backward,
   and the cost of the f32 dx/dW products the backward runs outside
   them; the widest Hout the kernels take, reckoned in Python (the
   functional's routing rule), equal to the library's, and Hout = 2048
   through fused_attn_proj_residual_layer_norm on the card (the dense
   route) against the plain version; the dropout variants as phase 20's
   (dp's zeros against the plain mask; the times beside addmm ->
   F.dropout -> + res -> F.layer_norm). The cluster route (pl_route:
   bf16, Hout a multiple of 256 up to 768, what bert-base takes): its
   forward's y, mean, rstd and its backward kernel's dres, dgamma, dbeta,
   db against their plain versions, hi + lo within 2^-14 of the plain
   dp, repeat bits, hi's zeros the plain mask, with and without dropout;
   autograd through fused_proj_ln_2d (dx, dW from the pair products)
   within one bf16 unit of the f32-product reference; planted faults
   rejected (a block's column slice zeroed, lo dropped, a 128-row
   partial cut, the mask keyed by the cluster's 128 rows); the forward,
   the backward kernel and the whole backward timed in turns against the
   generic kernels (earlier_ms) and the composite (library_ms), and at
   Hin = 64; at PyTorch's default allow_bf16_reduced_precision_reduction,
   dx and dW through autograd at ragged R (128, 600) and Hout 256 and 512
   within one bf16 unit of the f32-product reference;
22. the flash kernels' key-padding variant against their plain versions
   at bert-base's attention (B=32, 12 heads, S=512, D=64, valid lengths
   128-512 from the seed, bf16; B=4 in f32; a ragged S=200 in both),
   masked keys getting no dK, the backward on bwd_route's kernels and
   repeating bit for bit;
   their times beside SDPA with the same additive mask and the generic
   kernels (in turns); the dropout
   variants (p = 0.1, keyed by the reference's tile: (128, 128) in bf16,
   (256, 512) in f32; bf16 S=1024 at (256, 512) and S=100 at (104, 104))
   against their plain versions with repeat bits, the mask keyed by the
   generic kernels' 64-row tile rejected and, at S=1024, by the wgmma
   forward's own (128, 128), and the backward's by the dK/dV kernel's
   (64, 64); the kernels' times also beside the generic ones'; their
   times beside SDPA with the same mask and dropout_p = 0.1;
23. train bert-base (random weights from a seed, bf16, full width and
   depth, dropout rates 0) through BertForPretraining.loss and AdamW (lr
   1e-4, weight decay 0.01) at B=32, S=512 on one fixed padded batch
   (15% of the valid positions MLM-labelled): one warm-up step, whose
   update is held element by element to AdamW's rule, then 4 steps; a
   finite loss whose mean over the 4 lies below the warm-up step's (it
   oscillates: the reference's normal(0, 1) word embeddings are the
   decoder's weight too); exactly 14 LayerNorm, 12 projection-LN
   and 12 of each flash and fused MLP kernel launches per step, every
   projection-LN call on the cluster route (pl_routes), every flash
   backward on the wgmma kernels after its pre-pass; ms/step,
   tokens/s (all B*S positions), model TFLOP/s, the AdamW update's ms,
   peak memory and the card's clocks;
24. torch.profiler over 2 more bert-base steps: busy time, idle share,
   each kernel family's share, the kernels that take the time;
25. the same training with FLAGS_fused_norm and FLAGS_fused_mlp off (the
   dense norms, projection and MLP; the flash kernels kept): 1 warm-up
   and 2 steps;
26. parity in fp32 at bert-base width, 2 layers, B=4, S=512: loss and
   every gradient with the fused flags on vs off;
27. the fused BatchNorm kernels (forward, every call on the cluster
   route and its plan the Python mirror's, with the clusters the card
   holds at once; backward with the mean and var cotangents, every call
   on the persistent route and its plan the Python mirror's, fed the
   forward's outputs) through their custom ops against their plain
   versions at
   resnet50's B=256 shapes: the stem's BN (C=64, HW=12544), layer 1's bn3
   (residual + ReLU), layer 3's bn2 (HW=196, planes off 16-byte
   boundaries in bf16), layer 4's bn3 (C=2048, HW=49, residual), a
   downsample BN (no ReLU) and a BatchNorm1D shape (HW=1), f32 and
   bf16; two forward and two backward calls give the same bits; dres is
   g gated by the kernel's own y > 0, bit for bit;
   autograd through fused_batch_norm_train at layer 1's bn3 in bf16
   against the plain versions and bitwise against the ops; the check
   shown to reject a forward without the residual, a forward and a
   backward missing one reduction part, a cluster forward whose rank 0
   leaves out its last peer's partial and a persistent backward whose
   folds leave out one block's partial; the ops with bf16 weight and bias
   (AMP's O2 casts) at layer 1's bn3 and the stem against the plain
   versions, bitwise equal to the same values in f32, dw and db bf16, one
   launch a forward call and one and a memset a backward call, timed in
   turns with the f32-vector call, the planted faults rejected; their
   times at layer 1's bn3 and
   the stem beside the plain versions', the bound and F.batch_norm -> +
   res -> relu with its autograd backward, each direction's new kernel
   in turns with the generic route's kernels and its CUDA launches
   and memsets a call; then at all six shapes in bf16, each alone and in
   turns: the cluster forward, the generic forward, the plain version,
   the F.batch_norm chain, the bound and the bytes the plan reads; the
   persistent and the generic backward;
28. train resnet50 (random weights from a seed, bf16, full width and
   depth, FLAGS_fused_norm on as by default) through the Layer model and
   Momentum(0.1, momentum=0.9) (cross_entropy(net(x).float(), y) ->
   backward -> opt.step -> opt.clear_grad) at B=256, 3x224x224 on one
   fixed batch: one warm-up step, whose running statistics are held to
   Paddle's rule, then 4 steps; a finite loss; exactly 53 fused_bn_fwd
   and 53 fused_bn_bwd launches per step, every forward on the cluster
   route, every backward on the persistent route; ms/step, images/s, model
   TFLOP/s (convolution and fc flops from the shapes, x3), the Momentum
   update's ms, peak memory, the BN kernels' summed bound and the card's
   clocks;
29. torch.profiler over 2 more resnet50 steps: busy time, idle share,
   the BN kernels' time by direction and the convolutions' share, the
   kernels that take the time (the forward's kernel launches a step as
   the profile counts them); in turns with the generic backward, then
   with the generic forward;
30. the same training with FLAGS_fused_norm off (the dense BatchNorm):
   1 warm-up and 2 steps;
31. parity in fp32 at full width, B=8, 64x64: loss, gradients and running
   statistics with the BN kernels and with the dense BatchNorm, each
   against the dense route in f64 (the kernels at most 3x as far from it
   as the dense f32 route);
32. the dropout keep-mask: the device hash of each library that draws
   masks (its debug entry) against the plain version bit for bit at
   bert-base's keys (the flash score matrices at the bf16 and f32 tiles
   and at S=100's (104, 104),
   the LayerNorm's and projection-LN's rows, the fused MLP's rows at
   bert-base's and a tuning-table hit's row tiles), the kept share within
   4 sigma of 0.9;
33. train bert-base at its default config (dropout 0.1 / 0.1, no cut) as
   phase 23 does: exactly 12 of each flash and projection-LN dropout
   variant (the projection-LN's on the cluster route), 12 LayerNorm
   dropout and 2 dropout-free LayerNorm launches a
   step (the embeddings' and the MLM transform's), and 12 of each fused
   MLP kernel;
34. its profile, and the embeddings' dense mask (F.dropout of [32, 512,
   768] bf16) timed alone;
35. the same at the default dropout with the fused norms and MLP off;
36. parity in fp32 at bert-base width, 2 layers, B=4, S=512, dropout
   0.1 / 0.1: the loss and every gradient with the kernels on the card
   against the port's CPU route (the plain versions) from the same
   weights and generator seed, the generators' states equal after;
37. the fused GeLU MLP's dropout variants (kernels 4-6 at p = 0.1,
   keyed by the reference's row tile) through the custom ops against
   their plain versions: gpt3-1.3b's width (R=8192, H=2048, F=8192,
   tanh; block_r 128), bert-base's (R=16384, H=768, F=3072, erf;
   block_r 256), a tuning-table hit (R=4096, H=2048, F=8192; block_r
   32), all bf16, and a ragged R=1000 in f32 (y, dx, dw1, db1, dw2,
   db2), each element within its row's scale; y's zeros equal to the
   plain mask's, and with g in one row only dW2's zero columns and db2's
   zeros equal to that row's dropped columns; each bf16 forward and
   backward on the wgmma route; two backward calls give the same bits;
   autograd through fused_mlp_2d equal to the ops; the
   check shown to reject the mask keyed by the kernels' 128-row block;
   their times at gpt3-1.3b's and bert-base's widths beside the plain
   versions', the dropout-free kernels', the generic route's (in turns),
   the bound and addmm -> gelu -> addmm -> F.dropout with its autograd
   backward;
38. F.fused_mlp at dropout 0.1 in fp32, R=1024 at gpt3-1.3b's and
   bert-base's full H and F: the output and every gradient through
   autograd with the kernels on the card against the port's CPU route
   from the same inputs and generator seed, the generators' states
   equal after; each call launches each dropout variant of kernels 4-6
   once and no other kernel;
39. serve llama-7b (random weights from a seed, bf16, full width, 12 of
   its 32 layers: LLAMA_SERVE_LAYERS) through llama_adapter and ServingEngine at max_batch=4,
   device_loop_k=4, 512 blocks of 16, max_model_len 1024: 4 greedy
   requests, prompts 128/256/384/512, 32 new tokens; every request
   finished, tokens in the vocabulary, 0 leaked blocks; ms per token,
   TTFT, and torch.profiler's busy / idle split over 4 decode windows;
   then the fast-path traffic of phase 40 through this plain engine (its
   streams and TTFTs are phase 40's yardstick);
40. the llama-7b fast path: prefill_chunk=256 and prefix_cache=True
   (one warm request, then 4 sharing its 384-token prefix with distinct
   64-160-token tails: prefix hits >= 4, no cached token recomputed, the
   chunk counts chunk_spans gives), then the same traffic at max_batch=1
   with a self-draft (SpeculativeConfig(llama_adapter(model), k=4)) on
   top: 0 leaked blocks in both pools and the trie, the peak memory
   under the weights + both pools + 2 GB; the prefix's TTFT against the
   plain engine's for the same tails, the accept rate, and each bf16
   stream's first divergence from the plain engine's (reported, not
   gated);
41. the gpt3-1.3b fast path at max_batch=1 with
   FLAGS_serving_decode_kernel on: chunked prefill, the prefix cache
   and a self-draft at k=4; every draft step of every speculative round
   launches the decode kernel once a layer (24 x k a round), all on the
   split route;
42. fast-path parity in fp32 (TF32 off) at llama-7b's and gpt3-1.3b's
   full width, 2 layers: the plain, chunked, prefix-cached and
   speculative engines give identical greedy streams, and a chunked
   prefill's last logits row is within 2e-5 x max|logit| of the whole
   prefill's;
43. the ppyoloe-s eval stream of bench.py's bench_ppyoloe (random weights
   from a seed, f32, eval mode, eagerly under torch.no_grad(), B=1): the
   48 images of mixed sizes 416-640 drawn by np.random.default_rng(0),
   zero-padded by pad_spatial_nchw to the ladder [448, 512, 576, 640];
   every distinct image's scores and boxes checked; two passes of the
   stream chained through one accumulator and synced once; each bucket's
   steady ms over 24 chained repetitions, the bucket-mix expectation and
   stream_vs_bucket_agreement; ms an image, images/s, peak memory, a
   profiled pass (busy, idle, aten calls and CUDA launches an image);
   post_process (matrix NMS over 8400 boxes, 80 classes) on one 640^2
   image with its detection count; no kernel of the port runs (eval
   BatchNorm is dense);
44. train ppyoloe-l (random weights from a seed, f32, full width and
   depth) through PPYOLOE.loss and Momentum(0.01, momentum=0.9,
   weight_decay=5e-4) at B=8, 640^2 on one fixed synthetic batch (8 gt
   boxes an image, 2 padding rows labelled -1): one warm-up step, whose
   running statistics are held to Paddle's rule, then 8 steps; finite
   losses, the last below the warm-up's; exactly 35 fused_bn_fwd and 35
   fused_bn_bwd op calls a step (no residual, no ReLU), every forward on
   the cluster route and every backward on the persistent route; ms/step,
   images/s, model TFLOP/s, peak memory,
   the card's clocks; the dense BatchNorm (FLAGS_fused_norm off) in turns
   with the fused step; a profile of 2 steps (the BN kernels' time by
   direction; its 70 forward calls on the cluster route by the counters);
45. the fused BatchNorm kernels against their plain versions at
   PP-YOLOE's shapes (N=8: the stem's [8, 32, 102400], the stride-8
   level's [8, 128, 6400], the last stage's [8, 512, 400]; no residual,
   no ReLU), f32 and bf16, phase 27's per-case checks; the stem's shape
   timed in f32 beside the plain versions, the bound, F.batch_norm with
   its autograd backward and the generic route's kernels in turns (each
   direction), with the bytes the forward's plan reads; the backward op's
   host time a call (the enqueue of 200 calls, no sync) on both routes
   at the stem and at layer 1's bn3;
46. parity in fp32 (TF32 off) at ppyoloe-s's full width on 2 images of
   256^2: the loss, every gradient, the running statistics, the state
   after one Momentum step, the eval scores and boxes and post_process's
   rows and count with the kernels on the card against the port's CPU
   route from the same weights and batch, each within 3x the CPU route's
   own f32-against-f64 reading;
47. bench.py's resnet50 step (:552-583) under AMP: resnet50 with f32
   parameters (random from a seed, full width and depth), B=256,
   3x224x224, the forward under auto_cast(level="O2", dtype="bfloat16"),
   cross_entropy of the logits cast to f32 (ops.cast, the bench's
   astype), Momentum(0.1, 0.9), on the fused
   route (FLAGS_fused_norm on) and the dense one in turns (fused, dense,
   dense, fused; 5 steps a turn, one fixed batch each): the first step's
   operator statistics (collect_operator_stats: 53 conv2d and 53
   fused_bn_train or batch_norm_train calls in the reference's buckets),
   equal to the table of the same model on the CPU at B=2, 3x32x32, and,
   fused, its running statistics against Paddle's rule and each BN
   kernel call's weight dtype; finite, falling losses; 53 cluster forward
   and 53 persistent backward calls a step, all with bf16 weight and
   bias, on the fused route and none on the dense; ms a step, images/s,
   peak memory; a profile of each route (busy, idle, the O2 casts'
   aten::_to_copy calls and copy kernels a step); no parameter leaves f32;
48. bench.py's bert-base step (:647-692) under AMP: BertForPretraining
   with f32 parameters at dropout 0.1 / 0.1, B=64, S=512, ids and MLM /
   NSP labels as its batch() draws them (no mask), the loss under
   auto_cast(level="O1", dtype="bfloat16"), AdamW(1e-4), on the fused
   route and the dense one (norm and MLP flags off) in turns: the first
   step's operator statistics, equal to the table of the same model at
   full width on the CPU at B=2, S=16; the loss finite and on average
   below the
   first step's; the flash, fused MLP, projection-LN and LayerNorm
   launches a step exactly bert_launches', each on its bf16 route; ms a
   step, tokens/s, peak memory, a profile of each route; no parameter
   leaves f32;
49. AMP parity, the card against the port's CPU route from the same
   weights and batch: resnet50 at B=8, 64x64 under O2 (the loss, the
   gradients as one vector, the running statistics) and bert-base at
   full width, 2 layers, B=4, S=512, dropout 0.1 / 0.1 under O1 (the loss
   and every gradient, the generators seeded alike), each within 3x the
   CPU's own AMP-against-f32 reading;
50. AMP tools at bert-base width, 2 layers, B=4, S=512: GradScaler under
   O1 float16 (an inf planted in one gradient at step 2: the update
   skipped, parameters and moments bitwise unchanged, the scale halved);
   decorate(level="O2") (the LayerNorm parameters f32, every other one
   bf16 with an f32 master weight; a scaled O2 bf16 run whose skipped
   step leaves the master weights bitwise unchanged); LinearWarmup ->
   PolynomialDecay, ClipGradByGlobalNorm(1.0) and PaddleNLP's
   apply_decay_param_fun over 3 AdamW steps in f32: the rates, the
   clipped global norms and the parameters against the CPU route;
51. one bert-base step at full width under AMP O2 bf16 with f32
   parameters, fused, B=32, S=512 with the padding mask, dropout 0.1 /
   0.1, AdamW: the loss bf16 and finite, its arithmetic (multiply x2, sum
   x2, divide, subtract) bf16 in the operator table, the table equal to
   the CPU's at B=2, S=16, every kernel of bert_launches launched;
52. ops_vs_cpu: the ported ops (ops/) on the card against the same op on
   the CPU at small shapes, from a table of its own (ops_cases): every op
   the BERT and ResNet paths dispatch, and per ops/ file the cases where
   CUDA may differ (ties in sort, argsort, topk, argmax; unique, nonzero,
   masked_select; scatter and index_add with repeated indices; bf16
   cumsum and sum; qr, svd, eigh, solve, det, cholesky; the random draws
   from one key): dtypes, shapes and values at OPS_TOL, the
   decompositions also through their invariants; the number of ops and
   cases checked;
53. the host cost of a dispatch: one registered ops.add against a bare
   torch.add on a 16-element CUDA tensor, AMP off and under O2, plain and
   facade arguments, in turns; the ops phases 47 and 48 dispatch a step
   beside those steps' ms;
54. a Paddle user's script through ``import paddle_tpu_torch as paddle``
   and nothing else: (a) bert-base at full width and depth (phase 23's
   configuration: B=32, S=512, dropout 0, the padding mask, AdamW) takes
   two steps with exactly bert_launches' kernels on their bf16 routes,
   the second through paddle.grad and .backward() of one loss (bit for
   bit the same gradients; the backward kernels twice); a forward under
   paddle.no_grad() equal bit for bit to the grad-mode one, no output
   requiring a gradient, its peak (paddle.device.cuda after a reset)
   below the grad-mode forward's and equal to torch's reading; a forward
   under paddle.device.stream_guard on a second Stream after an Event
   handoff, equal bit for bit; paddle.save of the model's and AdamW's
   state dicts, set_state_dict(paddle.load(...)) into a fresh model from
   another seed and a fresh AdamW (every tensor bit for bit, nothing
   missing or unexpected), one more step from each (loss and parameters
   bit for bit); (b) resnet50 B=256, 224² under O2 with Momentum (phase
   47's loop, BN kernels 15-18: 53 + 53 a step) the same for two steps,
   the running statistics and the velocity included, the resumed loss
   within the spread of two forwards from one state and the parameters
   within lr times the spread of two backwards (both 0 when cuDNN is
   deterministic); (c) a PyLayer with its own backward on the card
   against the CPU within the f32 tolerance;
then the card's name and power limit again, the kernels' JSON line and
the final status line. Every kernel time is device time (cuda_ms: the
calls queued behind a spin of the card, so the host's launch rate does
not show).
"""
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": (5e-5, 5e-5), "bfloat16": (1.6e-2, 1.6e-2)}  # atol, rtol
REPLACES = "paddle_tpu/kernels/mlp_fusion.py:977"
SOURCE = "paddle_tpu_torch/kernels/csrc/decode_attn_proj.cu"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


_T0 = time.perf_counter()


def phase(n, name, **fields):
    fields["elapsed_s"] = time.perf_counter() - _T0
    print(f"phase {n} {name}: " + json.dumps(fields), flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


class ClockSampler:
    """Samples the card's SM clock, power draw and temperature with
    nvidia-smi every `period` s while the `with` block runs (a thread,
    joined on exit): min / mean / max of each."""

    QUERY = "clocks.sm,power.draw,temperature.gpu"

    def __init__(self, period=0.25):
        self.period = period
        self.rows = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            try:
                out = subprocess.run(
                    ["nvidia-smi", f"--query-gpu={self.QUERY}",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=30).stdout.strip().splitlines()
                self.rows.append([float(v) for v in out[0].split(",")])
            except (OSError, subprocess.SubprocessError, IndexError,
                    ValueError):
                return      # no reading: summary() says so
            self._stop.wait(self.period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)

    def summary(self):
        if not self.rows:
            return "not measured (no nvidia-smi samples)"
        cols = zip(*self.rows)
        return {name: dict(min=min(c), mean=sum(c) / len(c), max=max(c))
                for name, c in zip(("sm_clock_mhz", "power_w", "temp_c"),
                                   cols)} | {"samples": len(self.rows)}


def cuda_ms(fn, sets, iters=30):
    """Device ms per call: CUDA events around `iters` calls cycling through
    `sets` of inputs (for the decode kernel, together larger than the 50
    MB L2, as in the real decode where each layer's weights are cold),
    enqueued behind a spin of the card (torch.cuda._sleep, ~50 ms at 1980
    MHz) so that they run back to back on the device however slow the
    host's launches are: the device time, also of calls shorter than
    their host-side cost (a LayerNorm's ~0.03 ms against ~0.03-0.06 ms of
    Python and ctypes per launch)."""
    import torch
    for s in sets[:2]:
        fn(s)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for i in range(iters):
        fn(sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: decode_attn_proj against its plain version
# ---------------------------------------------------------------------------

NH, D, HO, BS, MB, NBLOCKS = 16, 128, 2048, 16, 64, 96
POSITIONS = (0, 15, 16, 511, 1023)


def kernel_inputs(torch, kvh, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    pool = NBLOCKS * BS + 1
    return dict(q=rnd(NH, D), k_pool=rnd(pool, kvh, D),
                v_pool=rnd(pool, kvh, D), proj_w=rnd(NH * D, HO, scale=0.02),
                proj_b=rnd(HO, scale=0.02),
                order=torch.randperm(NBLOCKS, generator=g, device=dev))


def table_for(torch, order, pos):
    """Shuffled block ids for the pages pos needs, pad entries
    (= num_blocks) after them."""
    t = order[:MB].to(torch.int32).clone()
    t[pos // BS + 1:] = NBLOCKS
    return t


def bound_ms(pos, kvh, dtype_name):
    e = 2 if dtype_name == "bfloat16" else 4
    nbytes = (NH * D * e + 4 + MB * 4 + 2 * (pos + 1) * kvh * D * e
              + NH * D * HO * e + HO * e + HO * e)
    flops = 4 * NH * (pos + 1) * D + 2 * NH * D * HO
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# bf16 and f32 readings held beside TOL: max |kernel - plain| <= tol *
# max |plain| (attn rounded to bf16 at one point in both, the f32 sums in
# other orders; a kernel that drops one context split reads ~0.1)
DECODE_REL_TOL = {"float32": 2e-5, "bfloat16": 2 ** -7}
# the decode kernels as the profiler names them: the split route's two,
# the generic route's three
DECODE_KERNELS = ("decode_attn_split_kernel", "decode_proj_kernel",
                  "attn_partial", "proj_partial", "proj_out")


def cuda_launches(torch, fn, calls=10):
    """The CUDA kernels a call of fn launches, from a profile of ``calls``
    calls: the runtime's kernel launches a call (cudaLaunchKernel*;
    the device's kernel records, copies and fills left out, where the
    profile shows no runtime call) and the kernels' names."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.key.startswith(("Memcpy", "Memset"))]
    api = sum(e.count for e in events
              if e.key.startswith("cudaLaunchKernel"))
    short = {re.match(r"(?:void\s+)?([\w:]*)", e.key.replace(
        "(anonymous namespace)::", "")).group(1).split("::")[-1][:80] or
             e.key[:80] for e in dev}
    return (api or sum(e.count for e in dev)) / calls, sorted(short)


def decode_sets(torch, pos, kvh):
    """Six input sets at the main path's shape, bf16, together larger than
    the 50 MB L2 (each layer's weight is cold in the real decode), each
    with the context gathered for the library yardstick."""
    sets = []
    for s in range(6):
        x = kernel_inputs(torch, kvh, torch.bfloat16, seed=100 + s)
        table = table_for(torch, x["order"], pos)
        slots = (table.long().clamp(0, NBLOCKS - 1)[:, None] * BS
                 + torch.arange(BS, device="cuda")).reshape(-1)[:pos + 1]
        x.update(table=table,
                 p=torch.tensor([pos], dtype=torch.int32, device="cuda"),
                 kc=x["k_pool"][slots].permute(1, 0, 2)[None].contiguous(),
                 vc=x["v_pool"][slots].permute(1, 0, 2)[None].contiguous())
        sets.append(x)
    return sets


def decode_times(torch, mf, pos, kvh, plain=False):
    """Device ms of the split route, the generic one and the library
    yardstick (SDPA over the context gathered beforehand + addmm; never
    called by the port) in turns at one shape: generic, split, split,
    generic, library (and the plain version first and last)."""
    scale = 1.0 / np.sqrt(D)
    sets = decode_sets(torch, pos, kvh)

    def args(x):
        return (x["q"], x["k_pool"], x["v_pool"], x["p"], x["table"],
                x["proj_w"], x["proj_b"])

    def run(route):
        return lambda x: mf._launch(*args(x), BS, scale, route=route)

    def run_plain(x):
        mf.decode_attn_proj_ref(*args(x), block_size=BS, scale=scale)

    def run_library(x):
        attn = torch.nn.functional.scaled_dot_product_attention(
            x["q"][None, :, None, :], x["kc"], x["vc"], enable_gqa=kvh != NH)
        torch.addmm(x["proj_b"], attn.reshape(1, NH * D), x["proj_w"])

    order = [("generic", run("generic")), ("split", run("split")),
             ("split_2", run("split")), ("generic_2", run("generic")),
             ("library", run_library)]
    if plain:
        order = [("plain", run_plain)] + order + [("plain_2", run_plain)]
    t = {key: cuda_ms(fn, sets) for key, fn in order}
    bms, by = bound_ms(pos, kvh, "bfloat16")
    out = dict(ms=min(t["split"], t["split_2"]), route="split",
               earlier_ms=min(t["generic"], t["generic_2"]),
               earlier="the generic attn_partial, proj_partial, proj_out, "
                       "same inputs, in turns",
               library_ms=t["library"], bound_ms=bms, bound_by=by,
               timed_at=dict(pos=pos, dtype="bfloat16", kvh=kvh, ho=HO),
               all_ms=t)
    if plain:
        out["plain_ms"] = min(t["plain"], t["plain_2"])
    x = sets[0]
    out["cuda_launches_per_call"], out["kernels"] = cuda_launches(
        torch, lambda: run("split")(x))
    out["generic_cuda_launches_per_call"], _ = cuda_launches(
        torch, lambda: run("generic")(x))
    check(1 <= out["cuda_launches_per_call"] <= 2
          and out["generic_cuda_launches_per_call"] == 3,
          f"decode CUDA launches a call: split {out['cuda_launches_per_call']}"
          f" ({out['kernels']}), generic "
          f"{out['generic_cuda_launches_per_call']}")
    return out


def phase_kernel_vs_plain(torch):
    """decode_attn_proj against its plain version: f32 and bf16, KVH 16
    and 4, every position of POSITIONS, on the route decode_route gives
    (split) and on the generic one, each within TOL and DECODE_REL_TOL;
    two calls give the same bits. The check shown to reject the kernel
    with its last context split dropped (run at the position just before
    the split starts, held against the plain version of the whole). Then
    the times: the split route in turns with the generic one, the plain
    version and the library yardstick at pos 511, KVH 16; the same
    without the plain version at pos 1023 and at KVH 4; the CUDA launches
    a call of each route from a profile."""
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    scale = 1.0 / np.sqrt(D)
    worst = {}
    before = dict(mf.decode_routes)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        atol, rtol = TOL[name]
        for kvh in (16, 4):
            x = kernel_inputs(torch, kvh, dtype, seed=kvh)
            for pos in POSITIONS:
                table = table_for(torch, x["order"], pos)
                p = torch.tensor([pos], dtype=torch.int32, device="cuda")
                args = (x["q"], x["k_pool"], x["v_pool"], p, table,
                        x["proj_w"], x["proj_b"])
                got = mf.decode_attn_proj(*args, block_size=BS, scale=scale)
                again = mf.decode_attn_proj(*args, block_size=BS, scale=scale)
                gen = mf._launch(*args, BS, scale, route="generic")
                ref = mf.decode_attn_proj_ref(*args, block_size=BS,
                                              scale=scale)
                torch.cuda.synchronize()
                check(same_bits(got, again), f"decode kernel differs between "
                      f"two calls: {name} kvh={kvh} pos={pos}")
                for route, out in (("split", got), ("generic", gen)):
                    check(bool(torch.isfinite(out).all()),
                          f"{route} decode kernel output not finite")
                    err = (out.float() - ref.float()).abs()
                    lim = atol + rtol * ref.float().abs()
                    rel = rel_err(out, ref)[1]
                    check(bool((err <= lim).all())
                          and rel <= DECODE_REL_TOL[name],
                          f"{route} decode kernel disagrees with plain: "
                          f"{name} kvh={kvh} pos={pos} max_abs_err="
                          f"{float(err.max())} relative {rel}")
                    w = worst.setdefault(route, {}).setdefault(name, [0., 0.])
                    w[0], w[1] = max(w[0], float(err.max())), max(w[1], rel)
    runs = 2 * 2 * len(POSITIONS)
    routes = {k: mf.decode_routes[k] - before[k] for k in before}
    check(routes == {"split": 2 * runs, "generic": runs},
          f"decode routes {routes}, want split {2 * runs}, generic {runs}")
    # the planted fault: the last context split left out
    pos, kvh = 511, 16
    x = kernel_inputs(torch, kvh, torch.bfloat16, seed=7)
    table = table_for(torch, x["order"], pos)
    cut = mf.decode_split_plan(pos, MB, BS, kvh)[-1][0] - 1
    full = (x["q"], x["k_pool"], x["v_pool"],
            torch.tensor([pos], dtype=torch.int32, device="cuda"), table,
            x["proj_w"], x["proj_b"])
    short = full[:3] + (torch.tensor([cut], dtype=torch.int32,
                                     device="cuda"),) + full[4:]
    wrong = mf.decode_attn_proj(*short, block_size=BS, scale=scale)
    ref = mf.decode_attn_proj_ref(*full, block_size=BS, scale=scale)
    fault = dict(pos=pos, kept_positions=cut + 1,
                 relative=rel_err(wrong, ref)[1])
    check(fault["relative"] > DECODE_REL_TOL["bfloat16"],
          f"the decode check passes a kernel missing a split: {fault}")
    main = decode_times(torch, mf, 511, 16, plain=True)
    return dict(worst={r: {n: dict(max_abs_err=e, relative=rel)
                           for n, (e, rel) in w.items()}
                       for r, w in worst.items()},
                max_abs_err=worst["split"]["bfloat16"][0],
                max_abs_err_f32=worst["split"]["float32"][0],
                relative_tolerance=DECODE_REL_TOL, routes=routes,
                repeat_bitwise=True, planted_fault=fault,
                **{k: main[k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by", "route",
                                        "earlier_ms", "earlier")},
                main=main, pos_1023=decode_times(torch, mf, 1023, 16),
                kvh_4=decode_times(torch, mf, 511, 4))


# ---------------------------------------------------------------------------
# phases 4-6: the serving path
# ---------------------------------------------------------------------------

def phase_serve_b1(torch, model):
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.inference import (SamplingParams, ServingEngine,
                                            gpt_adapter)
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    from paddle_tpu_torch.kernels.mlp_fusion import decode_attn_proj
    from paddle_tpu_torch.models import gpt
    cfg = model.cfg
    set_flags({"FLAGS_serving_decode_kernel": True})
    eng = ServingEngine(gpt_adapter(model), num_blocks=512, block_size=16,
                        max_model_len=1024, max_batch=1)
    rng = np.random.default_rng(0)
    eng.submit(rng.integers(0, cfg.vocab_size, 16), SamplingParams(4),
               request_id="warmup")
    eng.run_until_idle()
    steps0 = eng.stats()["decode_steps"]
    decode_attn_proj.launches = 0
    for key in mf.decode_routes:
        mf.decode_routes[key] = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, n),
                       SamplingParams(max_new_tokens=32))
            for n in (128, 256, 384, 512)]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = decode_attn_proj.launches
    routes = dict(mf.decode_routes)
    st = eng.stats()
    steps = st["decode_steps"] - steps0
    check(all(r.state == "FINISHED" and len(r.tokens) == 32 for r in reqs),
          "B=1 serving: not every request finished with 32 tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens),
          "B=1 serving: token out of vocabulary")
    check(st["leaked_blocks"] == 0, f"leaked {st['leaked_blocks']} blocks")
    check(gpt.last_decode_kernel_path() == "kernel/cuda",
          f"decode path {gpt.last_decode_kernel_path()}")
    check(launches == cfg.num_layers * steps and steps > 0,
          f"decode_attn_proj launched {launches} times in {steps} B=1 "
          f"decode steps ({cfg.num_layers} layers)")
    check(routes == {"split": launches, "generic": 0},
          f"decode_attn_proj calls by route {routes}, want all {launches} "
          f"on the split kernels")
    ntok = sum(len(r.tokens) for r in reqs)
    out = dict(requests=len(reqs), tokens=ntok, decode_steps=steps,
               kernel_launches=launches, decode_routes=routes,
               leaked_blocks=st["leaked_blocks"],
               wall_s=wall, tokens_per_s=ntok / wall,
               prefill_ms=[(r.t_first_token - r.t_admit) * 1e3 for r in reqs],
               ttft_ms=[(r.t_first_token - r.t_submit) * 1e3 for r in reqs],
               ms_per_token=[(r.t_terminal - r.t_first_token) * 1e3
                             / (len(r.tokens) - 1) for r in reqs])
    return out, eng


def phase_profile_b1(torch, eng, vocab_size, steps=8, prompts=None):
    """torch.profiler over `steps` decode steps (windows of the engine's
    device_loop_k tokens) of `prompts` (default one 256-token prompt),
    admitted and prefilled in the step before, after the measured run:
    device busy time per step against the profiled wall time, the host's
    operator calls and kernel launches per step, and the kernels that
    take the device time. The profiler adds host time, so the idle share
    here is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference import SamplingParams
    if prompts is None:
        prompts = [np.random.default_rng(3).integers(0, vocab_size, 256)]
    for p in prompts:
        eng.submit(p, SamplingParams(
            max_new_tokens=(steps + 2) * eng.device_loop_k))
    eng.step()                       # admission + prefill + first decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run_until_idle()
    events = prof.key_averages()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if busy_ms == 0.0:
        return dict(steps=steps, device_time="not measured (no CUDA events)")
    ours = sum(e.self_device_time_total for e in dev
               if any(k in e.key for k in DECODE_KERNELS)) / 1e3
    # aten:: calls count the nested ones too (linear -> matmul -> mm)
    aten = sum(e.count for e in events if e.key.startswith("aten::"))
    launches = sum(e.count for e in events
                   if e.key.startswith(("cudaLaunchKernel", "cuLaunch")))
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)
    return dict(steps=steps, batch=len(prompts),
                tokens_per_step=len(prompts) * eng.device_loop_k,
                wall_ms_per_step=wall_ms / steps,
                device_busy_ms_per_step=busy_ms / steps,
                device_idle_share=1.0 - busy_ms / wall_ms,
                aten_calls_per_step=aten / steps,
                cuda_launches_per_step=launches / steps,
                decode_attn_proj_ms_per_step=ours / steps,
                top_device_ms_per_step=[
                    (e.key[:60], e.self_device_time_total / 1e3 / steps,
                     e.count // steps) for e in top[:8]])


def phase_serve_b4(torch, model):
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.inference import (SamplingParams, ServingEngine,
                                            gpt_adapter)
    from paddle_tpu_torch.kernels.mlp_fusion import decode_attn_proj
    cfg = model.cfg
    set_flags({"FLAGS_serving_decode_kernel": True})
    eng = ServingEngine(gpt_adapter(model), num_blocks=512, block_size=16,
                        max_model_len=1024, max_batch=4, device_loop_k=4)
    rng = np.random.default_rng(1)
    decode_attn_proj.launches = 0
    t0 = time.perf_counter()
    reqs = []
    for i in range(8):
        samp = (dict(temperature=0.8, top_p=0.9, seed=i) if i % 2 else {})
        reqs.append(eng.submit(rng.integers(0, cfg.vocab_size,
                                            int(rng.integers(64, 513))),
                               SamplingParams(max_new_tokens=32, **samp)))
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    check(all(r.state == "FINISHED" and len(r.tokens) == 32 for r in reqs),
          "B=4 serving: not every request finished with 32 tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens),
          "B=4 serving: token out of vocabulary")
    check(st["leaked_blocks"] == 0, f"leaked {st['leaked_blocks']} blocks")
    ntok = sum(len(r.tokens) for r in reqs)
    out = dict(requests=len(reqs), tokens=ntok, windows=st["decode_steps"],
               kernel_launches_b1_tail=decode_attn_proj.launches,
               leaked_blocks=st["leaked_blocks"], wall_s=wall,
               tokens_per_s=ntok / wall)
    del eng
    return out


def generate(torch, params, cfg, prompt, n_new, kernel):
    """Prefill + greedy decode through a BlockPool; returns tokens and
    the logits rows."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.inference import BlockPool, kv_append
    from paddle_tpu_torch.models import gpt
    set_flags({"FLAGS_serving_decode_kernel": kernel})
    bs, width = 16, 8
    pool = BlockPool(cfg.num_layers, 16, bs, cfg.num_heads,
                     cfg.hidden_size // cfg.num_heads, dtype=cfg.dtype)
    pool.alloc("r", pool.blocks_needed(len(prompt) + n_new))
    ids = torch.tensor(prompt, dtype=torch.int32, device="cuda")[None]
    last, ks, vs = gpt.serving_prefill(
        params, ids, torch.tensor([len(prompt)], device="cuda"), cfg)
    slots = torch.from_numpy(pool.slots_for("r", 0, len(prompt))).cuda()
    for layer in range(cfg.num_layers):
        kv_append(pool.k[layer], ks[layer, 0], slots)
        kv_append(pool.v[layer], vs[layer, 0], slots)
    bt = torch.from_numpy(pool.block_table("r", width)).cuda()[None]
    rows = [last[0]]
    toks = [int(torch.argmax(last[0]))]
    for i in range(n_new - 1):
        lg, _, _ = gpt.serving_decode_step(
            params, pool.k, pool.v,
            torch.tensor([toks[-1]], dtype=torch.int32, device="cuda"),
            torch.tensor([len(prompt) + i], dtype=torch.int32, device="cuda"),
            bt, cfg, bs)
        rows.append(lg[0])
        toks.append(int(torch.argmax(lg[0])))
    check(gpt.last_decode_kernel_path() == ("kernel/cuda" if kernel
                                            else "composite"),
          f"parity run took {gpt.last_decode_kernel_path()}")
    return toks, torch.stack(rows)


def phase_parity_fp32(torch):
    from paddle_tpu_torch.models import gpt
    cfg = gpt.CONFIGS["gpt3-1.3b"]._replace(dtype=torch.float32)
    model = gpt.GPTForCausalLM(cfg, seed=1)
    params = gpt.serving_params(model)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 64).tolist()
    tk, lk = generate(torch, params, cfg, prompt, 16, kernel=True)
    tc, lc = generate(torch, params, cfg, prompt, 16, kernel=False)
    diff = float((lk - lc).abs().max())
    check(bool(torch.isfinite(lk).all()) and lk.shape == (16, cfg.vocab_size),
          "parity logits not finite or misshapen")
    check(tk == tc, f"greedy tokens differ: kernel {tk} vs composite {tc}")
    check(diff <= 1e-3, f"logits differ by {diff} > 1e-3")
    del model, params
    return dict(tokens=len(tk), same_tokens=tk == tc, max_abs_logit_diff=diff,
                tolerance=1e-3)


# ---------------------------------------------------------------------------
# phase 8: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------

FLASH_SOURCE = "paddle_tpu_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = {"flash_fwd": "paddle_tpu/kernels/flash_attention.py:167",
                  "flash_dq": "paddle_tpu/kernels/flash_attention.py:329",
                  "flash_dkv": "paddle_tpu/kernels/flash_attention.py:420"}
# Each element is held to |kernel - plain| <= tol * (rms + |plain|), with
# rms that of the element's row of plain (the last axis: D for out, dq,
# dk, dv; S for lse), so late causal rows, whose values are small, are
# held at their own scale. f32 sums in another order; bf16 I/O rounds p
# and ds to 8 bits at other points (the kernel's online softmax scales p
# by the running max, the plain version by the row's final max). Worst
# readings at these seeds on an H100: 7.0e-6 (f32), 0.0103 (bf16); a
# forward that drops one tile reads over 1.6 (flash_check_rejects).
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2 ** -5}
# the wgmma backward's pre-pass: the scaled operands of _dq_kernel (:357)
# and _dkv_kernel (:448), and delta, which _bwd computes outside them
FLASH_PREP_REPLACES = ("paddle_tpu/kernels/flash_attention.py:357, :448 "
                       "(k * scale, q * scale) and :551 (delta)")
FLASH_D = 128
# (causal, sq, sk, bh, d): S 2048 and 1000 (ragged) at B*NH 64 and 16,
# D=128; then D=64 (the wgmma kernel's other width), Sq != Sk (the causal
# offset sk - sq, ragged on both sides), and D=96 (bf16 on the generic
# kernel: fwd_route sends only D 64 and 128 to the wgmma one)
FLASH_CASES = ([(causal, s, s, bh, FLASH_D) for causal in (True, False)
                for s in (2048, 1000) for bh in (64, 16)]
               + [(True, 1000, 1000, 16, 64), (False, 512, 512, 16, 64),
                  (True, 512, 1000, 16, 128), (False, 512, 1000, 16, 64),
                  (True, 1000, 1000, 16, 96), (False, 512, 1000, 16, 96)])
TRAIN_B, TRAIN_S, TRAIN_NH = 4, 2048, 16     # the slice's attention shape


def flash_inputs(torch, bh, s, dtype, seed, sk=None, d=FLASH_D):
    """q and dout [bh, s, d], k and v [bh, sk, d] (sk = s by default)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    sk = s if sk is None else sk
    return [torch.randn(bh, n, d, generator=g, device="cuda").to(dtype)
            for n in (s, sk, sk, s)]                     # q, k, v, dout


def flash_bounds(bh, s, causal):
    """bound_ms and what bounds it for each kernel at [bh, s, 128] bf16:
    the products each kernel's function needs over the visible (q, k)
    pairs (fwd: s and p.v; dQ: s, dp, ds.k; dK/dV: s, dp, p^T.dO,
    ds^T.q), each 2 flops per pair per head-dim element, at 989 TFLOP/s;
    its inputs read once and outputs written once at 3.35 TB/s. The
    backward's pre-pass is bytes alone (its few flops an element run on
    the CUDA cores)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    prod = 2.0 * pairs * FLASH_D * bh
    mat = bh * s * FLASH_D * 2                 # one bf16 [bh, s, d]
    row = bh * s * 4                           # one f32 [bh, s]
    work = {"flash_fwd": (2 * prod, 4 * mat + row),
            "flash_dq": (3 * prod, 5 * mat + 2 * row),
            "flash_dkv": (4 * prod, 6 * mat + 2 * row),
            # the backward's pre-pass: q, k, o, dO in, qs, ks, delta out
            "flash_bwd_prep": (0.0, 6 * mat + row)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / H100_FLOPS["bfloat16"]
        t_bytes = nbytes / H100_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def flash_reading(got, ref):
    """max over elements of |got - ref| / (rms + |ref|), rms that of each
    row (the last axis) of ref but no less than 1/16 of the whole
    tensor's (a row whose terms cancel to ~0, as causal dQ's first row
    does, is held at the tensor's scale): what FLASH_TOL bounds."""
    g, r = got.float(), ref.float()
    rms = r.square().mean(-1, keepdim=True).sqrt().clamp_min(
        float(r.square().mean().sqrt()) / 16)
    return float(((g - r).abs() / (rms + r.abs()).clamp_min(1e-30)).max())


def phase_flash_vs_plain(torch):
    """All three kernels against their plain versions on the card (out,
    lse, dq, dk, dv), each forward and backward on the route fwd_route /
    bwd_route gives it (the route counters read per case), each bf16
    backward run twice and compared bit for bit, then their times at the
    slice's shape."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    worst, routes, broutes = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for causal, sq, sk, bh, d in FLASH_CASES:
            scale = d ** -0.5
            q, k, v, do = flash_inputs(torch, bh, sq, dtype, seed=sq + bh + d,
                                       sk=sk, d=d)
            before = dict(fa.fwd_routes)
            out, lse = fa.flash_fwd(q, k, v, causal, scale)
            route = fa.fwd_route(dtype, d, True)
            check({r: fa.fwd_routes[r] - before[r] for r in before}
                  == {r: int(r == route) for r in before},
                  f"flash forward {name} d={d} did not take the {route} "
                  f"kernel once: {before} -> {fa.fwd_routes}")
            routes[route] = routes.get(route, 0) + 1
            before = dict(fa.bwd_routes)
            dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, do, causal, scale)
            broute = fa.bwd_route(dtype, d, True)
            check({r: fa.bwd_routes[r] - before[r] for r in before}
                  == {r: 2 * int(r == broute) for r in before},
                  f"flash backward {name} d={d} did not take the {broute} "
                  f"kernels once each: {before} -> {fa.bwd_routes}")
            broutes[broute] = broutes.get(broute, 0) + 1
            if dtype == torch.bfloat16:
                again = fa.flash_bwd(q, k, v, out, lse, do, causal, scale)
                check(all(same_bits(a, b) for a, b in zip(again,
                                                          (dq, dk, dv))),
                      f"flash backward {name} causal={causal} sq={sq} sk={sk} "
                      f"d={d} differs between two calls ({broute})")
                del again
            rout, rlse = fa.flash_fwd_ref(q, k, v, causal, scale)
            # the plain backward from the kernel's own (out, lse), so each
            # kernel is held alone
            rdq, rdk, rdv = fa.flash_bwd_ref(q, k, v, out, lse, do, causal,
                                             scale)
            torch.cuda.synchronize()
            for key, got, ref in (("out", out, rout), ("lse", lse, rlse),
                                  ("dq", dq, rdq), ("dk", dk, rdk),
                                  ("dv", dv, rdv)):
                check(bool(torch.isfinite(got).all()),
                      f"flash {key} not finite ({name} sq={sq} sk={sk} "
                      f"bh={bh} d={d})")
                err = float((got.float() - ref.float()).abs().max())
                rel = flash_reading(got, ref)
                check(rel <= FLASH_TOL[name],
                      f"flash {key} disagrees with plain: {name} causal="
                      f"{causal} sq={sq} sk={sk} bh={bh} d={d} route={route} "
                      f"max_abs_err={err} relative {rel} > {FLASH_TOL[name]}")
                kern = {"out": "flash_fwd", "lse": "flash_fwd",
                        "dq": "flash_dq"}.get(key, "flash_dkv")
                if dtype == torch.bfloat16:
                    kern += "" if (route if kern == "flash_fwd"
                                   else broute) == "wgmma" else "_generic"
                w = worst.setdefault(name, {}).setdefault(kern, [0.0, 0.0])
                w[0], w[1] = max(w[0], err), max(w[1], rel)
            del q, k, v, do, out, lse, dq, dk, dv, rout, rlse, rdq, rdk, rdv
            torch.cuda.empty_cache()
    scale = FLASH_D ** -0.5
    times = flash_times(torch, fa, scale)
    return dict(tolerance_relative_to_row_rms_plus_abs=FLASH_TOL,
                worst={n: {k: dict(max_abs_err=e, relative=r)
                           for k, (e, r) in w.items()}
                       for n, w in worst.items()},
                cases=[list(c) for c in FLASH_CASES], dtypes=2,
                forward_routes=routes, backward_routes=broutes,
                wrong_kernel_readings={
                    f"tile {t}": flash_check_rejects(torch, fa, scale, t)
                    for t in (64, fa.WGMMA_BQ)},
                wrong_backward_readings=flash_bwd_check_rejects(torch, fa,
                                                                scale),
                prep=flash_prep_check(torch, fa),
                **times)


def flash_check_rejects(torch, fa, scale, tile=64):
    """The bf16 check must reject a forward that skips a tile of `tile`
    rows (the generic kernel's 64, the wgmma kernel's 128): the plain
    forward with the diagonal tile dropped for the late half of the rows
    (causal, S=2048), or with the ragged tail tile dropped (S=1000).
    Returns each one's reading, and its max error over max |plain| (the
    measure a whole-tensor check would see)."""
    out = {}
    for label, causal, s in (("diagonal", True, 2048), ("tail", False, 1000)):
        q, k, v, _ = flash_inputs(torch, 16, s, torch.bfloat16, seed=s + 16)
        ref, _ = fa.flash_fwd_ref(q, k, v, causal, scale)
        i = torch.arange(s, device="cuda")
        row, col = i[:, None], i[None, :]
        if causal:
            keep = (col <= row) & ~((row // tile == col // tile)
                                    & (row >= s // 2))
        else:
            keep = (col < s // tile * tile).expand(s, s)
        qs = (q.float() * scale).to(q.dtype).float()
        sc = qs @ k.float().transpose(1, 2)
        wrong = (torch.softmax(sc.masked_fill(~keep, -1e30), -1)
                 @ v.float()).to(q.dtype)
        reading = flash_reading(wrong, ref)
        check(reading > FLASH_TOL["bfloat16"],
              f"the bf16 flash check passes a forward with the {label} tile "
              f"of {tile} rows dropped: {reading} <= {FLASH_TOL['bfloat16']}")
        out[label] = dict(reading=reading, relative_to_max=float(
            (wrong.float() - ref.float()).abs().max()
            / ref.float().abs().max()))
        del q, k, v, ref, qs, sc, wrong
    torch.cuda.empty_cache()
    return out


def bwd_with_keep(torch, q, k, v, do, lse, delta, scale, keep):
    """The plain backward (flash_dq_ref, flash_dkv_ref's arithmetic) with
    the pairs outside ``keep`` [s, s] hidden: what a kernel that skipped
    them would compute."""
    def rnd(x):
        return x.to(q.dtype).float()
    ks, qs = rnd(k.float() * scale), rnd(q.float() * scale)
    dp = do.float() @ v.float().transpose(1, 2)
    ds = rnd(torch.exp(q.float() @ ks.transpose(1, 2) - lse[..., None])
             .masked_fill(~keep, 0.0) * (dp - delta[..., None]))
    dq = (ds @ ks).to(q.dtype)
    del ds
    p = torch.exp(qs @ k.float().transpose(1, 2)
                  - lse[..., None]).masked_fill(~keep, 0.0)
    dv = (rnd(p).transpose(1, 2) @ do.float()).to(q.dtype)
    dk = (rnd(p * (dp - delta[..., None])).transpose(1, 2) @ qs).to(q.dtype)
    return dq, dk, dv


def flash_bwd_check_rejects(torch, fa, scale, s=2048):
    """The bf16 check must reject a backward that skips a tile of the
    wgmma kernels' schedules (causal, S=2048, 16 heads): dQ without the
    diagonal KV tile of each of its 128-row q tiles (the 64 keys
    [128 i + 64, 128 i + 128), which only the tile's second half sees),
    and dK/dV without the first q tile of each kv tile's band (the 64 q
    rows of the kv tile's own rows). Returns each reading, and its max
    error over max |plain|."""
    q, k, v, do = flash_inputs(torch, 16, s, torch.bfloat16, seed=s + 17)
    out, lse = fa.flash_fwd_ref(q, k, v, True, scale)
    delta = fa._delta(out, do)
    i = torch.arange(s, device="cuda")
    row, col = i[:, None], i[None, :]
    causal = col <= row
    ref = fa.flash_bwd_ref(q, k, v, out, lse, do, True, scale)
    faults = {"dq": (causal & (col // fa.DQ_BK != 2 * (row // fa.DQ_BQ) + 1),
                     (0,)),
              "dkv": (causal & (row // fa.DKV_BQ != col // fa.DKV_BKV),
                      (1, 2))}
    res = {}
    for label, (keep, which) in faults.items():
        wrong = bwd_with_keep(torch, q, k, v, do, lse, delta, scale, keep)
        for w in which:
            name = ("dq", "dk", "dv")[w]
            reading = flash_reading(wrong[w], ref[w])
            check(reading > FLASH_TOL["bfloat16"],
                  f"the bf16 flash check passes a {name} with a {label} "
                  f"tile skipped: {reading} <= {FLASH_TOL['bfloat16']}")
            res[name] = dict(reading=reading, relative_to_max=float(
                (wrong[w].float() - ref[w].float()).abs().max()
                / ref[w].float().abs().max()))
        del wrong
    del q, k, v, do, out, lse, delta, ref
    torch.cuda.empty_cache()
    return res


def flash_prep_check(torch, fa):
    """The wgmma backward's pre-pass against its plain version at the GPT
    shape (bf16, D=128) and BERT's (D=64): qs and ks bit for bit
    round(x * scale), delta within 1e-5 of max |delta| of rowsum(dO * O)
    (f32 sums in another order)."""
    out = {}
    for bh, s, d in ((TRAIN_B * TRAIN_NH, TRAIN_S, FLASH_D),
                     (BERT_B * BERT_NH, BERT_S, BERT_D)):
        q, k, o, do = flash_inputs(torch, bh, s, torch.bfloat16, seed=11,
                                   d=d)
        scale = d ** -0.5
        qs, ks, delta = fa._bwd_prep_cuda(q, k, o, do, scale)
        want = fa._delta(o, do)
        torch.cuda.synchronize()
        check(same_bits(qs, (q.float() * scale).to(q.dtype))
              and same_bits(ks, (k.float() * scale).to(k.dtype)),
              f"the backward's pre-pass rounds q or k otherwise (d={d})")
        err = float((delta - want).abs().max())
        rel = err / float(want.abs().max())
        check(rel <= 1e-5, f"the pre-pass's delta: {rel} > 1e-5 (d={d})")
        out[f"bh={bh} s={s} d={d}"] = dict(delta_max_abs_err=err,
                                           delta_relative_to_max=rel)
        del q, k, o, do, qs, ks, delta, want
    torch.cuda.empty_cache()
    return out


def in_turns(a, b, iters=20):
    """cuda_ms of a and b timed in turns (a, b, b, a), the better pass of
    each, and all four passes."""
    t = {}
    for key, fn in (("a", a), ("b", b), ("b_2", b), ("a_2", a)):
        t[key] = cuda_ms(fn, [None], iters=iters)
    return min(t["a"], t["a_2"]), min(t["b"], t["b_2"]), t


def bwd_turns(res, runs, generic):
    """dQ and dK/dV (``runs``: name -> (kernel, plain), the kernels on the
    wgmma route from the pre-pass's operands) each in turns with its plain
    version and with the generic kernel it replaced (``generic``: name ->
    call, ``earlier_ms``)."""
    for name, (kern, plain) in runs.items():
        plain_ms, ms, t = in_turns(plain, kern)
        earlier_ms, _, et = in_turns(generic[name], kern)
        res[name].update(ms=ms, plain_ms=plain_ms, all_ms=t, route="wgmma",
                         earlier_ms=earlier_ms, earlier_all_ms=et,
                         earlier=f"the generic {name}_kernel, same inputs, "
                                 f"in turns")


def prep_times(fa, q, k, out, do, scale, bound):
    """The pre-pass in turns with its plain version (the two roundings and
    rowsum(dO * O) in PyTorch); no one library call computes the three."""
    def plain(_):
        return ((q.float() * scale).to(q.dtype),
                (k.float() * scale).to(k.dtype), fa._delta(out, do))
    plain_ms, ms, t = in_turns(
        plain, lambda _: fa._bwd_prep_cuda(q, k, out, do, scale))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, all_ms=t,
                bound_ms=bound[0], bound_by=bound[1])


def flash_times(torch, fa, scale):
    """CUDA-event times at B=4, NH=16, S=2048, D=128, bf16, causal: each
    kernel in turns with its plain version; the forward (the wgmma
    kernel), dQ and dK/dV (the wgmma kernels, from the pre-pass's qs and
    ks) each in turns with the generic kernel it replaced on this shape
    (``earlier_ms``); the pre-pass alone. The library yardsticks (never
    called by the port): SDPA's forward for the forward kernel; no
    library call computes dQ alone or dK/dV alone, so SDPA's backward
    (dQ, dK and dV in one call, on a retained forward graph) is held
    against the port's whole backward (the pre-pass, dQ, dK/dV), which is
    also timed in turns with the generic route's (delta in PyTorch, the
    generic kernels)."""
    bh, s = TRAIN_B * TRAIN_NH, TRAIN_S
    q, k, v, do = flash_inputs(torch, bh, s, torch.bfloat16, seed=7)
    out, lse = fa.flash_fwd(q, k, v, True, scale)
    qs, ks, delta = fa._bwd_prep_cuda(q, k, out, do, scale)
    runs = {
        "flash_dq": (lambda _: fa._dq_cuda(q, k, v, do, lse, delta, True,
                                           scale, ks=ks),
                     lambda _: fa.flash_dq_ref(q, k, v, do, lse, delta, True,
                                               scale)),
        "flash_dkv": (lambda _: fa._dkv_cuda(q, k, v, do, lse, delta, True,
                                             scale, qs=qs),
                      lambda _: fa.flash_dkv_ref(q, k, v, do, lse, delta,
                                                 True, scale)),
    }
    generic = {
        "flash_dq": lambda _: fa._dq_cuda(q, k, v, do, lse, delta, True,
                                          scale, route="generic"),
        "flash_dkv": lambda _: fa._dkv_cuda(q, k, v, do, lse, delta, True,
                                            scale, route="generic")}
    bounds = flash_bounds(bh, s, True)
    res = {name: dict(library_ms=None, bound_ms=bounds[name][0],
                      bound_by=bounds[name][1])
           for name in ("flash_fwd", "flash_dq", "flash_dkv")}
    plain_ms, ms, t = in_turns(
        lambda _: fa.flash_fwd_ref(q, k, v, True, scale),
        lambda _: fa._fwd_cuda(q, k, v, True, scale))
    res["flash_fwd"].update(ms=ms, plain_ms=plain_ms, all_ms=t)
    bwd_turns(res, runs, generic)
    res["flash_bwd_prep"] = prep_times(fa, q, k, out, do, scale,
                                       bounds["flash_bwd_prep"])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh, doh = (x.view(TRAIN_B, TRAIN_NH, s, FLASH_D)
                       for x in (q, k, v, do))
    fwd = lambda _: fa._fwd_cuda(q, k, v, True, scale)   # noqa: E731
    res["flash_fwd"]["library_ms"], _, _ = in_turns(
        lambda _: sdpa(qh, kh, vh, is_causal=True), fwd)
    earlier_ms, _, t = in_turns(
        lambda _: fa._fwd_cuda(q, k, v, True, scale, route="generic"), fwd)
    res["flash_fwd"].update(route=fa.fwd_route(q.dtype, FLASH_D, True),
                            earlier_ms=earlier_ms, earlier_all_ms=t)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qh, kh, vh))
    og = sdpa(qg, kg, vg, is_causal=True)
    whole = lambda _: fa._bwd_cuda(q, k, v, out, lse, do, True, scale)  # noqa: E731,E501
    sdpa_bwd_ms, bwd_ms, t = in_turns(
        lambda _: torch.autograd.grad(og, (qg, kg, vg), doh,
                                      retain_graph=True), whole)
    earlier_ms, _, et = in_turns(
        lambda _: fa._bwd_cuda(q, k, v, out, lse, do, True, scale,
                               route="generic"), whole)
    res["backward"] = dict(ms=bwd_ms, sdpa_bwd_ms=sdpa_bwd_ms, all_ms=t,
                           earlier_ms=earlier_ms, earlier_all_ms=et,
                           bound_ms=bounds["flash_dq"][0]
                           + bounds["flash_dkv"][0])
    res["timed_at"] = dict(b=TRAIN_B, nh=TRAIN_NH, s=s, d=FLASH_D,
                           dtype="bfloat16", causal=True)
    del q, k, v, do, out, lse, delta, qs, ks, qg, kg, vg, og
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 9: the fused MLP kernels against their plain versions
# ---------------------------------------------------------------------------

MLP_SOURCE = "paddle_tpu_torch/kernels/csrc/fused_mlp.cu"
MLP_REPLACES = {"fused_mlp_fwd": "paddle_tpu/kernels/mlp_fusion.py:228",
                "fused_mlp_dx": "paddle_tpu/kernels/mlp_fusion.py:260",
                "fused_mlp_dw": "paddle_tpu/kernels/mlp_fusion.py:296"}
# Each element is held as the flash kernels are (flash_reading): |kernel -
# plain| <= tol * (rms of its row + |plain|). f32 sums in another order.
# bf16: act and da are rounded at the same points in both (the kernel's
# f32 sums may land across a rounding boundary), and for dW the bf16
# kernel feeds round(da) and round(act) to the tensor cores where the
# plain version (the reference) keeps them f32; dW1 and dW2 come out in
# bf16, the plain ones in f32.
MLP_TOL = {"float32": 1e-4, "bfloat16": 2 ** -5}
MLP_R, MLP_H, MLP_F = TRAIN_B * TRAIN_S, 2048, 8192   # the slice's shape
MLP_BERT = (16384, 768, 3072)     # bert-base's MLP: R = 32 x 512, H, F
# three forward chunks on the wgmma route (8192, 8192, 128: the f32 sum
# stored, added to, then loaded by the last, ragged chunk), five
# backward chunks, rows not a multiple of the tiles
MLP_MULTI = (300, 64, 16512)
# (r, h, f, dtype, approximate): gpt3-1.3b; bert-base; rows not a
# multiple of any tile, f <= 512 not a multiple of 128, h not a multiple
# of 64; the same with the wgmma backward's one chunk ending off a
# 64-column edge (360); the generic route's last ffn chunk ragged (2560 =
# 2048 + 512); MLP_MULTI; strides not a multiple of 16 bytes (h = 100:
# the kernels' scalar load path)
MLP_CASES = [(MLP_R, MLP_H, MLP_F, "bfloat16", True),
             (*MLP_BERT, "bfloat16", False),
             (1000, 96, 320, "bfloat16", False),
             (1000, 96, 320, "float32", True),
             (1000, 96, 360, "bfloat16", True),
             (1000, 2048, 2560, "float32", False),
             (1000, 2048, 2560, "bfloat16", True),
             (*MLP_MULTI, "bfloat16", True),
             (333, 100, 200, "bfloat16", True)]
# the bf16 cases whose forward and backward take the wgmma route (H and F
# multiples of 8); every other case takes the generic kernels
MLP_WGMMA = {(MLP_R, MLP_H, MLP_F), MLP_BERT, (1000, 96, 320), (1000, 96, 360),
             (1000, 2048, 2560), MLP_MULTI}


def mlp_inputs(torch, r, h, f, dtype, seed):
    """x, w1, b1, w2, b2, g at the model's scale (normal(0, 0.02)
    weights; LayerNorm'd x; small biases)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * s).to(dtype)

    return (rnd(r, h), rnd(h, f, s=0.02), rnd(f, s=0.02), rnd(f, h, s=0.02),
            rnd(h, s=0.02), rnd(r, h, s=1e-3))


def mlp_bounds(r, h, f, esize, drop=False):
    """bound_ms and what bounds it for the forward and the backward: the
    products each call needs (forward 4 RHF; backward 10 RHF: dX's two
    products, dW's two and the first product recomputed once for both)
    at 989 TFLOP/s, with dropout plus the hash's HASH_OPS integer
    operations per element of y (forward) or g (backward) at the CUDA
    cores' 67 T/s; its inputs read once and outputs written once at 3.35
    TB/s."""
    rhf = float(r) * h * f
    t_hash = HASH_OPS * r * h / H100_FLOPS["float32"] if drop else 0.0
    rows, w, vf, vh = r * h * esize, h * f * esize, f * esize, h * esize
    work = {"forward": (4 * rhf, rows + 2 * w + vf + vh + rows),
            "backward": (10 * rhf, 2 * rows + 2 * w + vf + rows
                         + 2 * w + 4 * f + 4 * h)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / H100_FLOPS["bfloat16"] + t_hash
        t_bytes = nbytes / H100_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def mlp_workspace_gb(r, h, f, esize):
    """The larger of the wgmma forward's and backward's workspaces
    (csrc/fused_mlp.cu): the forward's act chunk in the dtype (chunk
    _MLP_FWD_CHUNK_F), the backward's da and act chunks in the dtype
    (chunk _MLP_BWD_CHUNK_F) and the f32 column-sum partials of the bias
    gradients, each with the f32 [R, H] accumulator when F exceeds its
    chunk."""
    from paddle_tpu_torch.kernels import mlp_fusion as mf

    def acc(fc):
        return r * h * 4 if f > fc else 0

    fwd, bwd = min(f, mf._MLP_FWD_CHUNK_F), min(f, mf._MLP_BWD_CHUNK_F)
    parts = -(-r // mf._ROW_BLOCK)
    return max(r * fwd * esize + acc(fwd),
               r * bwd * 2 * esize + acc(bwd) + parts * (f + h) * 4) / 1e9


def phase_mlp_vs_plain(torch):
    """The forward and backward custom ops (``fused_mlp_fwd``,
    ``fused_mlp_bwd``: the kernels' wrappers, which the training step
    reaches through ``fused_mlp_2d``) against their plain versions on
    the card (y, dx, dw1, db1, dw2, db2) in every MLP_CASES case, the
    forward and the backward on their route (MLP_WGMMA: wgmma, else
    generic); the backward repeated gives the same bits, and autograd
    through ``fused_mlp_2d`` gives the ops' results; the check shown to
    reject a forward missing one ffn chunk's down product, a forward
    without b2 and a dW1 missing one row block; then the times at the
    slice's shape and at bert-base's."""
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    worst, routes = {}, {}
    for r, h, f, name, approx in MLP_CASES:
        dtype = getattr(torch, name)
        x, w1, b1, w2, b2, g = mlp_inputs(torch, r, h, f, dtype, seed=r + f)
        before = dict(mf.mlp_bwd_routes)
        fbefore = dict(mf.mlp_fwd_routes)
        y = mf.fused_mlp_fwd(x, w1, b1, w2, b2, approx)
        grads = mf.fused_mlp_bwd(x, w1, b1, w2, b2, g, approx)
        dx, dw1, db1, dw2, db2 = grads
        again = mf.fused_mlp_bwd(x, w1, b1, w2, b2, g, approx)
        prim = [t.detach().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        y_ag = mf.fused_mlp_2d(*prim, approximate=approx)
        auto = torch.autograd.grad(y_ag, prim, g)
        torch.cuda.synchronize()
        took = {k: n - before[k] for k, n in mf.mlp_bwd_routes.items()}
        ftook = {k: n - fbefore[k] for k, n in mf.mlp_fwd_routes.items()}
        route = ("wgmma" if name == "bfloat16" and (r, h, f) in MLP_WGMMA
                 else "generic")
        check(took == {"wgmma": 0, "generic": 0, route: 3}
              and ftook == {"wgmma": 0, "generic": 0, route: 2},
              f"fused MLP routes: forward {ftook}, backward {took} ({name} "
              f"r={r} h={h} f={f}), want 2 and 3 calls on {route}")
        routes[f"{name} r={r} h={h} f={f}"] = route
        check(all(torch.equal(a, b) for a, b in zip(again, grads)),
              f"fused MLP backward differs between two calls ({name} r={r} "
              f"h={h} f={f})")
        check(torch.equal(y_ag, y) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(auto, grads)),
              f"autograd through fused_mlp_2d differs from the fused MLP "
              f"ops ({name} r={r} h={h} f={f})")
        ry = mf.fused_mlp_fwd_ref(x, w1, b1, w2, b2, approx)
        rdx = mf.fused_mlp_dx_ref(x, w1, b1, w2, g, approx)
        rdw = mf.fused_mlp_dw_ref(x, w1, b1, w2, g, approx)
        for key, got, ref in (("y", y, ry), ("dx", dx, rdx),
                              ("dw1", dw1, rdw[0]), ("db1", db1, rdw[1]),
                              ("dw2", dw2, rdw[2]), ("db2", db2, rdw[3])):
            check(bool(torch.isfinite(got).all()),
                  f"fused MLP {key} not finite ({name} r={r} h={h} f={f})")
            err = float((got.float() - ref.float()).abs().max())
            rel = flash_reading(got, ref)
            check(rel <= MLP_TOL[name],
                  f"fused MLP {key} disagrees with plain: {name} r={r} h={h} "
                  f"f={f} approximate={approx} max_abs_err={err} relative "
                  f"{rel} > {MLP_TOL[name]}")
            kern = {"y": "fused_mlp_fwd", "dx": "fused_mlp_dx"}.get(
                key, "fused_mlp_dw")
            w = worst.setdefault(name, {}).setdefault(kern, [0.0, 0.0])
            w[0], w[1] = max(w[0], err), max(w[1], rel)
        del x, w1, b1, w2, b2, g, y, grads, dx, dw1, db1, dw2, db2, again
        del prim, y_ag, auto, ry, rdx, rdw
        torch.cuda.empty_cache()
    return dict(tolerance_relative_to_row_rms_plus_abs=MLP_TOL,
                worst={n: {k: dict(max_abs_err=e, relative=r)
                           for k, (e, r) in w.items()}
                       for n, w in worst.items()},
                cases=[list(c) for c in MLP_CASES], routes=routes,
                **mlp_check_rejects(torch, mf),
                wrong_dw1_reading=mlp_dw_check_rejects(torch, mf),
                bert_base=mlp_times(torch, mf, *MLP_BERT, approx=False),
                **mlp_times(torch, mf))


def mlp_check_rejects(torch, mf):
    """The bf16 check must reject the forward's planted faults: the
    plain forward at MLP_MULTI with the wgmma route's middle ffn chunk
    (_MLP_FWD_CHUNK_F columns: one P2 launch) of the activation left out
    of the down product, and at the slice's shape without b2. Returns
    their readings."""
    out, fc = {}, mf._MLP_FWD_CHUNK_F
    for fault, (r, h, f) in (("wrong_kernel_reading", MLP_MULTI),
                             ("without_b2_reading", (MLP_R, MLP_H, MLP_F))):
        x, w1, b1, w2, b2, _ = mlp_inputs(torch, r, h, f, torch.bfloat16,
                                          seed=r + f)
        ref = mf.fused_mlp_fwd_ref(x, w1, b1, w2, b2, True)
        act = mf._gelu_f32(mf._pre(x, w1, b1), True).to(x.dtype).float()
        if fault == "wrong_kernel_reading":
            keep = torch.ones(f, dtype=torch.bool, device="cuda")
            keep[fc:2 * fc] = False
            wrong = act[:, keep] @ w2.float()[keep] + b2.float()
        else:
            wrong = act @ w2.float()
        out[fault] = flash_reading(wrong.to(x.dtype), ref)
        check(out[fault] > MLP_TOL["bfloat16"],
              f"the bf16 MLP check passes a planted forward fault ({fault}): "
              f"{out[fault]} <= {MLP_TOL['bfloat16']}")
        del x, w1, b1, w2, b2, ref, act, wrong
    torch.cuda.empty_cache()
    return out


def mlp_dw_check_rejects(torch, mf, rows=128):
    """The bf16 check must reject a dW1 that leaves out one 128-row block
    of R (a tile of the wgmma route's K walk, dropped): the plain dW1 at
    the slice's shape with rows 128-255 of x and da left out, rounded.
    Returns its reading."""
    x, w1, b1, w2, _, g = mlp_inputs(torch, MLP_R, MLP_H, MLP_F,
                                     torch.bfloat16, seed=MLP_R + MLP_F)
    _, da = mf._da(x, w1, b1, w2, g.float(), True)
    ref = x.float().T @ da
    keep = torch.ones(MLP_R, dtype=torch.bool, device="cuda")
    keep[rows:2 * rows] = False
    wrong = (x.float()[keep].T @ da[keep]).to(x.dtype)
    reading = flash_reading(wrong, ref)
    check(reading > MLP_TOL["bfloat16"],
          f"the bf16 MLP check passes a dW1 with one {rows}-row block left "
          f"out: {reading} <= {MLP_TOL['bfloat16']}")
    del x, w1, b1, w2, g, da, ref, wrong
    torch.cuda.empty_cache()
    return reading


def mlp_times(torch, mf, r=MLP_R, h=MLP_H, f=MLP_F, approx=True, key=None):
    """CUDA-event times in bf16 (phase 9: gpt3-1.3b's R=8192, H=2048,
    F=8192, tanh): the forward and the backward op, each in turns with
    its plain version. The backward computes dX and dW in one call, so
    the dX and dW kernels share its time, its plain version's (dX's and
    dW's together) and its bound. The library yardsticks (never called
    by the port): the dense composite addmm -> gelu -> addmm through
    cuBLAS for the forward; no library call computes dX alone or dW
    alone, so their library_ms is null and the composite's whole backward
    (autograd on a retained graph) is timed beside the backward op. The
    forward and the backward (on the wgmma route) are also timed in turns
    with the generic route on the same inputs (``earlier_ms``). With a
    dropout ``key``:
    the dropout variants, each also in turns with the dropout-free op,
    and F.dropout on the composite's output (its retained graph keeps one
    mask)."""
    x, w1, b1, w2, b2, g = mlp_inputs(torch, r, h, f, torch.bfloat16, seed=11)
    d = () if key is None else (key.p, key.s0, key.s1, key.rows)

    def plain_bwd(_):
        return (mf.fused_mlp_dx_ref(x, w1, b1, w2, g, approx, key),
                *mf.fused_mlp_dw_ref(x, w1, b1, w2, g, approx, key))

    runs = {
        "forward": (
            lambda _: mf.fused_mlp_fwd(x, w1, b1, w2, b2, approx, *d),
            lambda _: mf.fused_mlp_fwd_ref(x, w1, b1, w2, b2, approx, key)),
        "backward": (
            lambda _: mf.fused_mlp_bwd(x, w1, b1, w2, b2, g, approx, *d),
            plain_bwd),
    }
    bounds = mlp_bounds(r, h, f, 2, drop=key is not None)
    res = {}
    for name, (kern, plain) in runs.items():
        plain_ms, ms, t = in_turns(plain, kern, iters=10)
        res[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, all_ms=t,
                         bound_ms=bounds[name][0], bound_by=bounds[name][1])
    if key is not None:
        free = {"forward": lambda _: mf.fused_mlp_fwd(x, w1, b1, w2, b2,
                                                      approx),
                "backward": lambda _: mf.fused_mlp_bwd(x, w1, b1, w2, b2, g,
                                                       approx)}
        for name, fn in free.items():
            t = res[name]
            t["dropout_free_ms"], t["ms_beside_dropout_free"], _ = in_turns(
                fn, runs[name][0], iters=10)
    fwd = res["forward"]
    fwd["earlier_ms"], _, fwd["earlier_all_ms"] = in_turns(
        lambda _: mf._fwd_cuda(x, w1, b1, w2, b2, approx, key,
                               route="generic"),
        lambda _: mf._fwd_cuda(x, w1, b1, w2, b2, approx, key, route="wgmma"),
        iters=10)
    fwd.update(route="wgmma", earlier="the generic route (mlp_gemm_kernel, "
               "2 launches a chunk of 2048), same inputs, in turns")
    bwd = res["backward"]
    bwd["earlier_ms"], _, bwd["earlier_all_ms"] = in_turns(
        lambda _: mf._bwd_cuda(x, w1, b1, w2, g, approx, key,
                               route="generic"),
        lambda _: mf._bwd_cuda(x, w1, b1, w2, g, approx, key, route="wgmma"),
        iters=10)
    bwd.update(route="wgmma", earlier="the generic route (mlp_gemm_kernel, "
               "5 launches a chunk of 2048), same inputs, in turns")
    gelu = torch.nn.functional.gelu

    def composite(x, w1, b1, w2, b2):
        y = torch.addmm(b2, gelu(torch.addmm(b1, x, w1),
                                 approximate="tanh" if approx else "none"), w2)
        return y if key is None else torch.nn.functional.dropout(y, key.p)

    res["forward"]["library_ms"], _, _ = in_turns(
        lambda _: composite(x, w1, b1, w2, b2), runs["forward"][0], iters=10)
    prim = [t.detach().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    yc = composite(*prim)
    bwd["library_bwd_ms"], bwd["ms_beside_library"], _ = in_turns(
        lambda _: torch.autograd.grad(yc, prim, g, retain_graph=True),
        runs["backward"][0], iters=10)
    res["timed_at"] = dict(r=r, h=h, f=f, dtype="bfloat16", approximate=approx,
                           chunk_f=mf._CHUNK_F,
                           wgmma_forward_chunk_f=mf._MLP_FWD_CHUNK_F,
                           wgmma_backward_chunk_f=mf._MLP_BWD_CHUNK_F,
                           dropout=None if key is None else key.p,
                           block_r=None if key is None else key.rows)
    del x, w1, b1, w2, b2, g, prim, yc
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 10-14: the training path
# ---------------------------------------------------------------------------

TRAIN_STEPS = 4


def model_flops_per_step(cfg, tokens, seq):
    """6 flops per token per matmul weight (forward + backward; the tied
    head counts once) plus causal attention's two products over S(S+1)/2
    pairs per head per layer, times 3 for forward + backward. Remat
    recompute is not counted (model flops, not hardware flops)."""
    H, L = cfg.hidden_size, cfg.num_layers
    weights = L * (3 * H * H + H * H + 2 * H * cfg.ffn) + cfg.vocab_size * H
    pairs = seq * (seq + 1) // 2
    attn = 3 * 2 * 2 * pairs * H * L * (tokens // seq)
    return 6.0 * weights * tokens + attn


def _launch_counts():
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    from paddle_tpu_torch.kernels import norm_fusion as nf
    return ((fa.launches, fa.prep_launches, mf.launches, nf.launches),
            (fa.dropout_launches, mf.dropout_launches, nf.dropout_launches))


def reset_launches():
    """Every kernel count of the training paths to 0, the dropout
    variants', the flash forward's and backward's, the projection-LN's,
    the GeLU and SwiGLU forwards' and backwards' and the norms' backward
    routes included."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    from paddle_tpu_torch.kernels import norm_fusion as nf
    plain, drop = _launch_counts()
    for counts in plain + drop + (fa.fwd_routes, fa.bwd_routes, mf.pl_routes,
                                  mf.swiglu_bwd_routes, mf.mlp_bwd_routes,
                                  mf.swiglu_fwd_routes, mf.mlp_fwd_routes,
                                  nf.ln_bwd_routes, nf.bn_bwd_routes,
                                  nf.bn_fwd_routes):
        for key in counts:
            counts[key] = 0


def fwd_routes_reading(counts, what):
    """The flash forward's launches by route since reset_launches: on a
    bf16 model path every one (dropout variant or not) must take the
    wgmma kernel."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    n = counts.get("flash_fwd", 0) + counts.get("dropout_flash_fwd", 0)
    routes = dict(fa.fwd_routes)
    check(n > 0 and routes == {"wgmma": n, "generic": 0},
          f"{what}: flash forward launches by route {routes}, want all "
          f"{n} on the wgmma kernel")
    return routes


def bwd_routes_reading(counts, what):
    """The flash backward's dQ and dK/dV launches by route since
    reset_launches: on a bf16 model path every one (dropout variant or
    not) must take the wgmma kernels, each backward after one pre-pass."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    n = sum(counts.get(f"{p}{k}", 0) for p in ("", "dropout_")
            for k in ("flash_dq", "flash_dkv"))
    routes = dict(fa.bwd_routes)
    check(n > 0 and routes == {"wgmma": n, "generic": 0}
          and 2 * counts.get("flash_bwd_prep", 0) == n,
          f"{what}: flash backward launches by route {routes} with "
          f"{counts.get('flash_bwd_prep')} pre-passes, want all {n} dQ and "
          f"dK/dV launches on the wgmma kernels after {n // 2} pre-passes")
    return routes


def pl_routes_reading(counts, what):
    """The projection-LN's calls by direction and route since
    reset_launches: on a bf16 model path at Hout 768 every one (dropout
    variant or not) must take the cluster kernels."""
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    n = {d: counts.get(f"fused_proj_ln_{d}", 0)
         + counts.get(f"dropout_fused_proj_ln_{d}", 0) for d in ("fwd", "bwd")}
    routes = dict(mf.pl_routes)
    want = {"fwd_cluster": n["fwd"], "fwd_generic": 0,
            "bwd_cluster": n["bwd"], "bwd_generic": 0}
    check(n["fwd"] > 0 and routes == want,
          f"{what}: projection-LN calls by route {routes}, want {want}")
    return routes


def ln_bwd_routes_reading(counts, what, fused=True):
    """The LayerNorm backward's calls by route since reset_launches: on
    bert-base's bf16 path (H 768) with the fused norms every one (dropout
    variant or not) must take the persistent kernel; with them off there
    is none."""
    from paddle_tpu_torch.kernels import norm_fusion as nf
    n = counts.get("fused_ln_bwd", 0) + counts.get("dropout_fused_ln_bwd", 0)
    routes = dict(nf.ln_bwd_routes)
    check((n > 0) == fused and routes == {"persistent": n, "generic": 0},
          f"{what}: LayerNorm backward calls by route {routes}, want all {n} "
          f"on the persistent kernel (fused norms {fused})")
    return routes


def bn_bwd_routes_reading(counts, what, fused=True):
    """The BatchNorm backward's calls by route since reset_launches: with
    the fused norms every one must take the persistent kernel (the generic
    route serves in-call comparisons only); with them off there is none."""
    from paddle_tpu_torch.kernels import norm_fusion as nf
    n = counts.get("fused_bn_bwd", 0)
    routes = dict(nf.bn_bwd_routes)
    check((n > 0) == fused and routes == {"persistent": n, "generic": 0},
          f"{what}: BatchNorm backward calls by route {routes}, want all {n} "
          f"on the persistent kernel (fused norms {fused})")
    return routes


def bn_fwd_routes_reading(counts, what, fused=True):
    """The BatchNorm forward's calls by route since reset_launches: with
    the fused norms every one must take the cluster kernel (the generic
    route serves in-call comparisons only); with them off there is none."""
    from paddle_tpu_torch.kernels import norm_fusion as nf
    n = counts.get("fused_bn_fwd", 0)
    routes = dict(nf.bn_fwd_routes)
    check((n > 0) == fused and routes == {"cluster": n, "generic": 0},
          f"{what}: BatchNorm forward calls by route {routes}, want all {n} "
          f"on the cluster kernel (fused norms {fused})")
    return routes


def mlp_bwd_routes_reading(counts, what, fused=True):
    """The GeLU MLP backward's calls by route since reset_launches: on a
    bf16 model path with the fused MLP every one (dropout variant or not)
    must take the wgmma kernels; with it off there is none."""
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    n = counts.get("fused_mlp_dw", 0) + counts.get("dropout_fused_mlp_dw", 0)
    routes = dict(mf.mlp_bwd_routes)
    check((n > 0) == fused and routes == {"wgmma": n, "generic": 0},
          f"{what}: GeLU MLP backward calls by route {routes}, want all {n} "
          f"on the wgmma kernels (fused MLP {fused})")
    return routes


def mlp_fwd_routes_reading(counts, what, fused=True):
    """The GeLU MLP forward's calls by route since reset_launches: on a
    bf16 model path with the fused MLP every one (dropout variant or not)
    must take the wgmma kernels; with it off there is none."""
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    n = counts.get("fused_mlp_fwd", 0) + counts.get("dropout_fused_mlp_fwd", 0)
    routes = dict(mf.mlp_fwd_routes)
    check((n > 0) == fused and routes == {"wgmma": n, "generic": 0},
          f"{what}: GeLU MLP forward calls by route {routes}, want all {n} "
          f"on the wgmma kernels (fused MLP {fused})")
    return routes


def swiglu_fwd_routes_reading(counts, what, fused=True):
    """The SwiGLU forward's calls by route since reset_launches: on the
    bf16 llama-7b path with the fused MLP every one must take the wgmma
    kernels; with it off there is none."""
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    n = counts.get("fused_swiglu_fwd", 0)
    routes = dict(mf.swiglu_fwd_routes)
    check((n > 0) == fused and routes == {"wgmma": n, "generic": 0},
          f"{what}: SwiGLU forward calls by route {routes}, want all {n} on "
          f"the wgmma kernels (fused MLP {fused})")
    return routes


def swiglu_routes_reading(counts, what):
    """The SwiGLU backward's calls by route since reset_launches: on the
    bf16 llama-7b path every one must take the wgmma kernels."""
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    n = counts.get("fused_swiglu_dw", 0)
    routes = dict(mf.swiglu_bwd_routes)
    check(n > 0 and routes == {"wgmma": n, "generic": 0},
          f"{what}: SwiGLU backward calls by route {routes}, want all {n} "
          f"on the wgmma kernels")
    return routes


def read_launches():
    """The counts by kernel name; a dropout variant's under
    ``dropout_<name>``."""
    plain, drop = _launch_counts()
    out = {}
    for counts in plain:
        out.update(counts)
    for counts in drop:
        out.update({f"dropout_{k}": n for k, n in counts.items()})
    return out


def phase_train(torch, cfg, fused, steps=TRAIN_STEPS):
    """Train cfg at B=4, S=2048 on one fixed batch: one warm-up step, then
    `steps` steps, with FLAGS_fused_mlp as `fused` says. Each flash
    kernel runs 24 times per step; with the flag on each fused MLP kernel
    24 times too (save_small keeps the MLP forward's output), with it off
    none."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.nn.functional import last_mlp_path
    set_flags({"FLAGS_fused_mlp": fused})
    params = gpt.init_hybrid_params(cfg, seed=0)
    opt = gpt.init_opt_state(params, dtype=cfg.opt_dtype)
    step = gpt.make_train_step(cfg)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (TRAIN_B, TRAIN_S + 1))).cuda()
    x, y = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    _, _, loss0 = step(params, opt, x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with ClockSampler() as clocks:
        t0 = time.perf_counter()
        losses = [step(params, opt, x, y)[2] for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_launches()
    path = last_mlp_path()
    losses = [float(l) for l in losses]
    check(all(np.isfinite(losses)), f"training loss not finite: {losses}")
    check(losses[-1] < losses[0], f"training loss did not fall: {losses}")
    check(path == ("fused_mlp/cuda" if fused else "dense"),
          f"training took the MLP path {path} with FLAGS_fused_mlp={fused}")
    L = cfg.num_layers
    for key, n in counts.items():
        want = (L * steps if key.startswith("flash")
                or (fused and key.startswith("fused_mlp")) else 0)
        check(n == want, f"{key} launched {n} times in {steps} steps of {L} "
              f"layers (want {want}; FLAGS_fused_mlp={fused})")
    routes = fwd_routes_reading(counts, "gpt3-1.3b training")
    broutes = bwd_routes_reading(counts, "gpt3-1.3b training")
    mroutes = mlp_bwd_routes_reading(counts, "gpt3-1.3b training", fused)
    froutes = mlp_fwd_routes_reading(counts, "gpt3-1.3b training", fused)
    tokens = TRAIN_B * TRAIN_S
    flops = model_flops_per_step(cfg, tokens, TRAIN_S)
    ms = wall / steps * 1e3
    out = dict(config="gpt3-1.3b", b=TRAIN_B, s=TRAIN_S,
               fused_mlp=fused, last_mlp_path=path,
               remat_policy=cfg.remat_policy, opt_dtype=str(cfg.opt_dtype),
               lm_head=cfg.lm_head, warmup_loss=float(loss0), losses=losses,
               ms_per_step=ms, tokens_per_s=tokens / (ms / 1e3),
               model_tflop_per_step=flops / 1e12,
               model_tflops=flops / (ms / 1e3) / 1e12,
               model_flops_share_of_989=flops / (ms / 1e3) / 989e12,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               card_during_steps=clocks.summary(), launches=counts,
               launches_per_step={k: n / steps for k, n in counts.items()},
               flash_fwd_routes=routes, flash_bwd_routes=broutes,
               fused_mlp_fwd_routes=froutes, fused_mlp_bwd_routes=mroutes)
    return out, params, opt, (x, y)


def phase_profile_train(torch, cfg, params, opt, batch, steps=2):
    """torch.profiler over `steps` training steps: device busy time per
    step against the profiled wall time, the flash and fused MLP kernels'
    shares, and the kernels that take the time."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models import gpt
    step = gpt.make_train_step(cfg)
    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(params, opt, *batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = read_launches()
    mroutes = mlp_bwd_routes_reading(counts, "gpt3-1.3b profile")
    froutes = mlp_fwd_routes_reading(counts, "gpt3-1.3b profile")
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if busy_ms == 0.0:
        return dict(steps=steps, device_time="not measured (no CUDA events)")
    flash = {k: sum(e.self_device_time_total for e in dev if k in e.key)
             / 1e3 / steps
             for k in ("flash_fwd_wgmma_kernel", "flash_fwd_kernel",
                       "flash_bwd_prep_kernel", "flash_dq_wgmma_kernel",
                       "flash_dkv_wgmma_kernel", "flash_dq_kernel",
                       "flash_dkv_kernel")}
    # the fused MLP kernels by instantiation: the generic core's <dtype, A
    # col-major, B col-major, epilogue> (0 gelu, 1 accumulate, 2
    # pre-activation, 3 gelu', 4 store), the backward's wgmma P1, the GEMM
    # core's <A MN-major, B MN-major, BN, stages, epilogue, paired> (the
    # forward's P1 EpiGelu and P2 EpiSum / EpiBias, the backward's P2-P4),
    # the column sums of g and the bias gradients' sum over the row blocks
    mlp = kernel_ms(dev, MLP_KERNEL_NAMES, steps)
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    r, f = TRAIN_B * TRAIN_S, cfg.ffn
    flaunch = fwd_core_launches(
        dev, steps, counts["fused_mlp_fwd"] // steps, mf.mlp_fwd_plan(
            r, cfg.hidden_size, f, min(f, mf._MLP_FWD_CHUNK_F)),
        "gpt3-1.3b profile")
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)
    return dict(steps=steps, wall_ms_per_step=wall_ms / steps,
                device_busy_ms_per_step=busy_ms / steps,
                device_idle_share=1.0 - busy_ms / wall_ms,
                fused_mlp_fwd_routes=froutes, fused_mlp_bwd_routes=mroutes,
                fused_mlp_fwd_launches=flaunch,
                flash_ms_per_step=flash,
                flash_share_of_busy=sum(flash.values()) * steps / busy_ms,
                fused_mlp_ms_per_step=sum(mlp.values()),
                fused_mlp_share_of_busy=sum(mlp.values()) * steps / busy_ms,
                fused_mlp_ms_per_step_by_direction=mlp_by_direction(mlp),
                fused_mlp_kernels_ms_per_step=mlp,
                top_device_ms_per_step=[
                    (e.key[:70], e.self_device_time_total / 1e3 / steps,
                     e.count // steps) for e in top[:12]])


def phase_remat_full(torch, cfg, params, opt, batch):
    """One step under remat 'full': the backward re-runs each layer's
    flash forward and fused MLP forward (2 per layer); dQ, dK/dV, the MLP
    dX and dW once per layer."""
    from paddle_tpu_torch.models import gpt
    cfg = cfg._replace(remat_policy="full")
    step = gpt.make_train_step(cfg)
    reset_launches()
    _, _, loss = step(params, opt, *batch)
    torch.cuda.synchronize()
    counts = read_launches()
    L = cfg.num_layers
    want = dict.fromkeys(counts, 0) | {
        "flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L,
        "flash_bwd_prep": L,
        "fused_mlp_fwd": 2 * L, "fused_mlp_dx": L, "fused_mlp_dw": L}
    check(counts == want, f"remat 'full' step launched {counts} (want "
          f"{want})")
    check(bool(np.isfinite(float(loss))), "remat 'full' loss not finite")
    return dict(remat_policy="full", loss=float(loss), launches=counts,
                flash_fwd_routes=fwd_routes_reading(counts, "remat 'full'"),
                flash_bwd_routes=bwd_routes_reading(counts, "remat 'full'"),
                fused_mlp_fwd_routes=mlp_fwd_routes_reading(counts,
                                                            "remat 'full'"),
                fused_mlp_bwd_routes=mlp_bwd_routes_reading(counts,
                                                            "remat 'full'"))


def phase_train_parity_fp32(torch):
    """fp32 at gpt3-1.3b width, 2 layers, B=1, S=2048: loss and every
    gradient of the step (a) with the flash and fused MLP kernels against
    (b) the same step with FLAGS_fused_mlp off (the dense MLP), and (b)
    against (c) the step through _block_apply's dense attention branch
    (reached by replacing _attn_mode in this script only) as well."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.models import gpt
    cfg = gpt.CONFIGS["gpt3-1.3b"]._replace(
        dtype=torch.float32, num_layers=2, remat_policy="save_small",
        lm_head="plain")
    params = gpt.init_hybrid_params(cfg, seed=1)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (1, TRAIN_S + 1))).cuda()
    x, y = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    leaves = gpt._leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def grads(fused):
        set_flags({"FLAGS_fused_mlp": fused})
        reset_launches()
        loss = gpt.loss_fn(params, x, y, cfg)
        g = torch.autograd.grad(loss, leaves)
        return loss.item(), g, read_launches()

    lf, gf, counts = grads(True)
    check(counts["fused_mlp_fwd"] == 2 and counts["fused_mlp_dw"] == 2,
          f"fp32 parity run with FLAGS_fused_mlp on launched {counts}")
    lk, gk, _ = grads(False)
    attn_mode = gpt._attn_mode
    gpt._attn_mode = lambda seq_len, head_dim: None
    try:
        ld, gd, _ = grads(False)
    finally:
        gpt._attn_mode = attn_mode
        set_flags({"FLAGS_fused_mlp": True})
    torch.cuda.synchronize()
    tol = 1e-4      # per leaf, relative to the leaf's largest gradient

    def worst(ga, gb):
        w = 0.0
        for a, b in zip(ga, gb):
            check(bool(torch.isfinite(a).all()), "parity gradient not finite")
            w = max(w, float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-30))
        return w

    worst_mlp, worst_flash = worst(gf, gk), worst(gk, gd)
    check(abs(lf - lk) <= 1e-5 * abs(lk), f"fp32 loss: fused MLP {lf} vs "
          f"dense MLP {lk}")
    check(abs(lk - ld) <= 1e-5 * abs(ld), f"fp32 loss: flash {lk} vs dense "
          f"{ld}")
    check(worst_mlp <= tol, f"fp32 gradients: fused vs dense MLP relative "
          f"{worst_mlp} > {tol}")
    check(worst_flash <= tol, f"fp32 gradients: flash vs dense attention "
          f"relative {worst_flash} > {tol}")
    del params, gf, gk, gd
    return dict(loss_fused_mlp=lf, loss_flash=lk, loss_dense=ld,
                worst_grad_relative_fused_vs_dense_mlp=worst_mlp,
                worst_grad_relative_flash_vs_dense_attention=worst_flash,
                tolerance=tol, leaves=len(leaves))


# ---------------------------------------------------------------------------
# phase 15: the fused SwiGLU kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_ms(dev, names, steps):
    """Device ms per step of each profiled kernel whose name holds one of
    ``names``, by its name without the argument list (the template
    arguments tell the instantiations apart)."""
    out = {}
    for e in dev:
        if any(k in e.key for k in names):
            key = e.key.split("(CUtensorMap")[0][:160]
            out[key] = out.get(key, 0.0) + e.self_device_time_total / 1e3 / steps
    return out


# the fused MLP library's kernels as the profiler names them: the generic
# GEMM core, the GeLU backward's column sums and their fixed-order sum,
# the wgmma routes of the GeLU and SwiGLU backwards (their P1 kernels,
# then the core's P2-P4) and forwards (the core's P1 and P2)
MLP_KERNEL_NAMES = ("mlp_gemm_kernel", "colsum_kernel", "sum_parts_kernel",
                    "gelu_dact_wgmma_kernel", "swiglu_dact_wgmma_kernel",
                    "wgmma_gemm_kernel")
# the GEMM core's instantiations of the forwards' wgmma route: A (x, act_c)
# K-major, B (the weights' windows) MN-major; every backward product takes
# A and B both K-major (P2) or both MN-major (P3, P4)
MLP_FWD_CORE = "wgmma_gemm_kernel<false, true,"


def mlp_by_direction(kernels):
    """kernel_ms's fused MLP kernels summed by direction: the forward (the
    core's MLP_FWD_CORE instantiations), the backward (its P1 kernels, the
    core's other instantiations, the column sums and sum_parts) and the
    generic route's mlp_gemm_kernel (either direction; no bf16 model call
    takes it)."""
    out = {"forward": 0.0, "backward": 0.0, "generic_either": 0.0}
    for name, ms in kernels.items():
        key = ("forward" if MLP_FWD_CORE in name else "generic_either"
               if "mlp_gemm_kernel" in name else "backward")
        out[key] += ms
    return out


def fwd_core_launches(dev, steps, calls, plan, what):
    """The forward's CUDA launches a call in a profiled training run:
    the core's MLP_FWD_CORE kernels over ``steps`` steps of ``calls``
    forward calls each, exactly 2 a chunk of ``plan`` (mlp_fwd_plan or
    swiglu_fwd_plan at the model's shape)."""
    n = sum(e.count for e in dev if MLP_FWD_CORE in e.key)
    want = 2 * len(plan)
    check(calls > 0 and n == steps * calls * want,
          f"{what}: {n} forward core launches in {steps} steps of {calls} "
          f"calls, want {want} a call")
    return dict(forward_cuda_launches_per_call=n / (steps * calls),
                want=want)

SWIGLU_REPLACES = {
    "fused_swiglu_fwd": "paddle_tpu/kernels/mlp_fusion.py:522",
    "fused_swiglu_dx": "paddle_tpu/kernels/mlp_fusion.py:543",
    "fused_swiglu_dw": "paddle_tpu/kernels/mlp_fusion.py:572"}
# Held as the GeLU MLP kernels are (flash_reading, MLP_TOL). bf16: act,
# dag and dau are rounded at the same points in both for y and dx; for dW
# the bf16 kernel feeds round(dag), round(dau) and round(act) to the
# tensor cores where the plain version (the reference) keeps them f32.
LLAMA_S = 2048                                  # the slice's B=1 sequence
SW_R, SW_H, SW_F = LLAMA_S, 4096, 11008         # the slice's MLP shape
# (r, h, f, dtype): llama-7b (5 chunks of 2048 and a ragged one of 768;
# the wgmma forward's: 8192, 2816; the wgmma backward's: 4096, 4096,
# 2816), in bf16 and f32; rows not a multiple of any tile, f <= 512 not a
# multiple of 128, h not a multiple of 64; a ragged last chunk (2560 =
# 2048 + 512; the wgmma backward's 4608 = 4096 + 512); MLP_MULTI (the
# wgmma forward's middle chunk); strides not a multiple of 16 bytes (h =
# 100: the scalar load path)
SWIGLU_CASES = [(SW_R, SW_H, SW_F, "bfloat16"), (SW_R, SW_H, SW_F, "float32"),
                (1000, 96, 320, "bfloat16"), (1000, 96, 320, "float32"),
                (1000, 2048, 2560, "bfloat16"), (1000, 2048, 4608, "bfloat16"),
                (*MLP_MULTI, "bfloat16"),
                (333, 100, 200, "bfloat16"), (333, 100, 200, "float32")]
# the bf16 cases whose forward and backward take the wgmma route (H and F
# multiples of 8); every other case takes the generic kernels
SWIGLU_WGMMA = {(SW_R, SW_H, SW_F), (1000, 96, 320), (1000, 2048, 2560),
                (1000, 2048, 4608), MLP_MULTI}


def swiglu_inputs(torch, r, h, f, dtype, seed):
    """x, wg, wu, wd, g at the model's scale (an RMSNorm'd x, Xavier-normal
    weights, a small upstream gradient)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * s).to(dtype)

    std = (2.0 / (h + f)) ** 0.5
    return (rnd(r, h), rnd(h, f, s=std), rnd(h, f, s=std), rnd(f, h, s=std),
            rnd(r, h, s=1e-3))


def swiglu_bounds(r, h, f, esize):
    """bound_ms and what bounds it: forward 6 RHF (ag, au, the down
    product), backward 16 RHF (ag and au recomputed once, dact, dX's two
    products, dW's three) at 989 TFLOP/s; inputs read once and outputs
    written once at 3.35 TB/s."""
    rhf = float(r) * h * f
    rows, w = r * h * esize, h * f * esize
    work = {"forward": (6 * rhf, rows + 3 * w + rows),
            "backward": (16 * rhf, 2 * rows + 3 * w + rows + 3 * w)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / H100_FLOPS["bfloat16"]
        t_bytes = nbytes / H100_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def swiglu_workspace_gb(r, h, f, esize):
    """The larger of the wgmma forward's and backward's workspaces
    (csrc/fused_mlp.cu): the forward's act chunk in the dtype (chunk
    _MLP_FWD_CHUNK_F; ag and au stay in registers), the backward's dag,
    dau and act chunks in the dtype (chunk _SWIGLU_BWD_CHUNK_F), each with
    the f32 [R, H] accumulator when F exceeds its chunk."""
    from paddle_tpu_torch.kernels import mlp_fusion as mf

    def acc(fc):
        return r * h * 4 if f > fc else 0

    fwd, bwd = min(f, mf._MLP_FWD_CHUNK_F), min(f, mf._SWIGLU_BWD_CHUNK_F)
    return max(r * fwd * esize + acc(fwd),
               r * bwd * 3 * esize + acc(bwd)) / 1e9


def phase_swiglu_vs_plain(torch):
    """The forward and backward custom ops (``fused_swiglu_fwd``,
    ``fused_swiglu_bwd``: the kernels' wrappers, which the LLaMA MLP
    reaches through ``fused_swiglu_2d``) against their plain versions on
    the card (y, dx, dwg, dwu, dwd) in every SWIGLU_CASES case, the
    forward and the backward on their route (SWIGLU_WGMMA: wgmma, else
    generic); the backward repeated gives the same bits, and autograd
    through ``fused_swiglu_2d`` gives the ops' results; the check shown to
    reject a forward missing one ffn chunk's down product and a dWg
    missing one row block; then the times at the slice's shape."""
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    worst, routes = {}, {}
    for r, h, f, name in SWIGLU_CASES:
        dtype = getattr(torch, name)
        x, wg, wu, wd, g = swiglu_inputs(torch, r, h, f, dtype, seed=r + f)
        before = dict(mf.swiglu_bwd_routes)
        fbefore = dict(mf.swiglu_fwd_routes)
        y = mf.fused_swiglu_fwd(x, wg, wu, wd)
        grads = mf.fused_swiglu_bwd(x, wg, wu, wd, g)
        again = mf.fused_swiglu_bwd(x, wg, wu, wd, g)
        prim = [t.detach().requires_grad_(True) for t in (x, wg, wu, wd)]
        y_ag = mf.fused_swiglu_2d(*prim)
        auto = torch.autograd.grad(y_ag, prim, g)
        torch.cuda.synchronize()
        where = f"{name} r={r} h={h} f={f}"
        took = {k: n - before[k] for k, n in mf.swiglu_bwd_routes.items()}
        ftook = {k: n - fbefore[k] for k, n in mf.swiglu_fwd_routes.items()}
        route = ("wgmma" if name == "bfloat16" and (r, h, f) in SWIGLU_WGMMA
                 else "generic")
        check(took == {"wgmma": 0, "generic": 0, route: 3}
              and ftook == {"wgmma": 0, "generic": 0, route: 2},
              f"fused SwiGLU routes: forward {ftook}, backward {took} "
              f"({where}), want 2 and 3 calls on {route}")
        routes[where] = route
        check(all(torch.equal(a, b) for a, b in zip(again, grads)),
              f"fused SwiGLU backward differs between two calls ({where})")
        check(torch.equal(y_ag, y) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(auto, grads)),
              f"autograd through fused_swiglu_2d differs from the SwiGLU "
              f"ops ({where})")
        ry = mf.fused_swiglu_fwd_ref(x, wg, wu, wd)
        rdx = mf.fused_swiglu_dx_ref(x, wg, wu, wd, g)
        rdw = mf.fused_swiglu_dw_ref(x, wg, wu, wd, g)
        for key, got, ref in (("y", y, ry), ("dx", grads[0], rdx),
                              ("dwg", grads[1], rdw[0]),
                              ("dwu", grads[2], rdw[1]),
                              ("dwd", grads[3], rdw[2])):
            check(bool(torch.isfinite(got).all()),
                  f"fused SwiGLU {key} not finite ({where})")
            err = float((got.float() - ref.float()).abs().max())
            rel = flash_reading(got, ref)
            check(rel <= MLP_TOL[name],
                  f"fused SwiGLU {key} disagrees with plain: {where} "
                  f"max_abs_err={err} relative {rel} > {MLP_TOL[name]}")
            kern = {"y": "fused_swiglu_fwd", "dx": "fused_swiglu_dx"}.get(
                key, "fused_swiglu_dw")
            w = worst.setdefault(name, {}).setdefault(kern, [0.0, 0.0])
            w[0], w[1] = max(w[0], err), max(w[1], rel)
        del x, wg, wu, wd, g, y, grads, again, prim, y_ag, auto, ry, rdx, rdw
        torch.cuda.empty_cache()
    return dict(tolerance_relative_to_row_rms_plus_abs=MLP_TOL,
                worst={n: {k: dict(max_abs_err=e, relative=r)
                           for k, (e, r) in w.items()}
                       for n, w in worst.items()},
                cases=[list(c) for c in SWIGLU_CASES], routes=routes,
                wrong_kernel_reading=swiglu_check_rejects(torch, mf),
                wrong_dwg_reading=swiglu_dw_check_rejects(torch, mf),
                **swiglu_times(torch, mf))


def swiglu_check_rejects(torch, mf):
    """The bf16 check must reject a forward that skips one ffn chunk: the
    plain forward at the slice's shape with the wgmma route's second ffn
    chunk (_MLP_FWD_CHUNK_F columns: one P2 launch) of the activation left
    out of the down product. Returns its reading."""
    x, wg, wu, wd, _ = swiglu_inputs(torch, SW_R, SW_H, SW_F, torch.bfloat16,
                                     seed=SW_R + SW_F)
    ref = mf.fused_swiglu_fwd_ref(x, wg, wu, wd)
    fc = mf._MLP_FWD_CHUNK_F
    keep = torch.ones(SW_F, dtype=torch.bool, device="cuda")
    keep[fc:2 * fc] = False
    ag, au = mf._gate_up(x, wg, wu)
    act = (mf._silu_f32(ag) * au).to(x.dtype).float()
    wrong = (act[:, keep] @ wd.float()[keep]).to(x.dtype)
    reading = flash_reading(wrong, ref)
    check(reading > MLP_TOL["bfloat16"],
          f"the bf16 SwiGLU check passes a forward with one ffn chunk "
          f"dropped: {reading} <= {MLP_TOL['bfloat16']}")
    del x, wg, wu, wd, ref, ag, au, act, wrong
    torch.cuda.empty_cache()
    return reading


def swiglu_dw_check_rejects(torch, mf, rows=128):
    """The bf16 check must reject a dWg that leaves out one 128-row block
    of R (a tile of the wgmma route's K walk, dropped): the plain dWg at
    the slice's shape with rows 128-255 of x and dag left out, rounded.
    Returns its reading."""
    x, wg, wu, wd, g = swiglu_inputs(torch, SW_R, SW_H, SW_F, torch.bfloat16,
                                     seed=SW_R + SW_F)
    _, _, dag, _ = mf._swiglu_da(x, wg, wu, wd, g)
    ref = x.float().T @ dag
    keep = torch.ones(SW_R, dtype=torch.bool, device="cuda")
    keep[rows:2 * rows] = False
    wrong = (x.float()[keep].T @ dag[keep]).to(x.dtype)
    reading = flash_reading(wrong, ref)
    check(reading > MLP_TOL["bfloat16"],
          f"the bf16 SwiGLU check passes a dWg with one {rows}-row block "
          f"left out: {reading} <= {MLP_TOL['bfloat16']}")
    del x, wg, wu, wd, g, dag, ref, wrong
    torch.cuda.empty_cache()
    return reading


def swiglu_times(torch, mf):
    """CUDA-event times at R=2048, H=4096, F=11008, bf16: the forward and
    the backward op, each in turns with its plain version. The backward
    computes dX and dW in one call, so the dX and dW kernels share its
    time, its plain version's and its bound. The library yardsticks
    (never called by the port): the dense composite (silu(x Wg) * (x Wu))
    Wd through cuBLAS for the forward; no library call computes dX alone
    or dW alone, so their library_ms is null and the composite's whole
    backward (autograd on a retained graph) is timed beside the backward
    op. The forward and the backward (on the wgmma route) are also timed
    in turns with the generic route on the same inputs
    (``earlier_ms``)."""
    x, wg, wu, wd, g = swiglu_inputs(torch, SW_R, SW_H, SW_F, torch.bfloat16,
                                     seed=13)

    def plain_bwd(_):
        return (mf.fused_swiglu_dx_ref(x, wg, wu, wd, g),
                *mf.fused_swiglu_dw_ref(x, wg, wu, wd, g))

    runs = {
        "forward": (lambda _: mf.fused_swiglu_fwd(x, wg, wu, wd),
                    lambda _: mf.fused_swiglu_fwd_ref(x, wg, wu, wd)),
        "backward": (lambda _: mf.fused_swiglu_bwd(x, wg, wu, wd, g),
                     plain_bwd),
    }
    bounds = swiglu_bounds(SW_R, SW_H, SW_F, 2)
    res = {}
    for name, (kern, plain) in runs.items():
        plain_ms, ms, t = in_turns(plain, kern, iters=10)
        res[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, all_ms=t,
                         bound_ms=bounds[name][0], bound_by=bounds[name][1])
    silu = torch.nn.functional.silu

    def composite(x, wg, wu, wd):
        return (silu(x @ wg) * (x @ wu)) @ wd

    fwd = res["forward"]
    fwd["earlier_ms"], _, fwd["earlier_all_ms"] = in_turns(
        lambda _: mf._swiglu_fwd_cuda(x, wg, wu, wd, route="generic"),
        lambda _: mf._swiglu_fwd_cuda(x, wg, wu, wd, route="wgmma"), iters=10)
    fwd.update(route="wgmma", earlier="the generic route (mlp_gemm_kernel, "
               "3 launches a chunk of 2048), same inputs, in turns")
    bwd = res["backward"]
    bwd["earlier_ms"], _, bwd["earlier_all_ms"] = in_turns(
        lambda _: mf._swiglu_bwd_cuda(x, wg, wu, wd, g, route="generic"),
        lambda _: mf._swiglu_bwd_cuda(x, wg, wu, wd, g, route="wgmma"),
        iters=10)
    bwd.update(route="wgmma", earlier="the generic route (mlp_gemm_kernel, "
               "8 launches a chunk), same inputs, in turns")
    res["forward"]["library_ms"], _, _ = in_turns(
        lambda _: composite(x, wg, wu, wd), runs["forward"][0], iters=10)
    prim = [t.detach().requires_grad_(True) for t in (x, wg, wu, wd)]
    yc = composite(*prim)
    bwd["library_bwd_ms"], bwd["ms_beside_library"], _ = in_turns(
        lambda _: torch.autograd.grad(yc, prim, g, retain_graph=True),
        runs["backward"][0], iters=10)
    res["timed_at"] = dict(r=SW_R, h=SW_H, f=SW_F, dtype="bfloat16",
                           chunk_f=mf._CHUNK_F,
                           wgmma_forward_chunk_f=mf._MLP_FWD_CHUNK_F,
                           wgmma_backward_chunk_f=mf._SWIGLU_BWD_CHUNK_F)
    del x, wg, wu, wd, g, prim, yc
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 16-19: LLaMA training through the Layer model and AdamW
# ---------------------------------------------------------------------------

LLAMA_LR = 1e-4


def llama_flops_per_step(cfg, tokens, seq):
    """6 flops per token per matmul weight (forward + backward; the untied
    head counts) plus causal attention's two products over S(S+1)/2 pairs
    per head per layer, times 3 for forward + backward."""
    H, L = cfg.hidden_size, cfg.num_hidden_layers
    kv = cfg.kv_heads * (H // cfg.num_attention_heads)
    weights = (L * (2 * H * H + 2 * H * kv + 3 * H * cfg.intermediate_size)
               + cfg.vocab_size * H)
    pairs = seq * (seq + 1) // 2
    attn = 3 * 2 * 2 * pairs * H * L * (tokens // seq)
    return 6.0 * weights * tokens + attn


def llama_trainer(torch, cfg, seed=0):
    """The user's loop: LlamaForCausalLM (bf16 on the card), AdamW over its
    parameters, one fixed [1, S] batch with labels = ids as the reference's
    test passes them. Returns (model, opt, step); step() -> (loss, the
    CUDA events recorded around the AdamW update)."""
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.optimizer import AdamW
    model = llama.LlamaForCausalLM(cfg, seed=seed)
    opt = AdamW(learning_rate=LLAMA_LR, parameters=model.parameters())
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (1, LLAMA_S))).cuda()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def step():
        loss = model.loss(ids, ids)
        loss.backward()
        ev[0].record()
        with torch.profiler.record_function("adamw_step"):
            opt.step()
        ev[1].record()
        opt.clear_grad()
        return loss.detach(), ev

    return model, opt, step


def phase_train_llama(torch, cfg, fused, steps=TRAIN_STEPS):
    """Train cfg at B=1, S=2048 on one fixed batch: one warm-up step, then
    `steps` steps, with FLAGS_fused_mlp as `fused` says. Each flash kernel
    runs once per layer per step; with the flag on each SwiGLU kernel
    too, with it off none; the GeLU MLP kernels never."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    from paddle_tpu_torch.nn.functional import last_mlp_path
    set_flags({"FLAGS_fused_mlp": fused})
    model, opt, step = llama_trainer(torch, cfg)
    loss0, _ = step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, adamw_ms = [], []
    with ClockSampler() as clocks:
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, ev = step()
            losses.append(loss)
            ev[1].synchronize()
            adamw_ms.append(ev[0].elapsed_time(ev[1]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_launches()
    path = last_mlp_path()
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"llama loss not finite: {losses}")
    check(losses[-1] < losses[0], f"llama loss did not fall: {losses}")
    check(path == ("fused_swiglu/cuda" if fused else "dense"),
          f"llama took the MLP path {path} with FLAGS_fused_mlp={fused}")
    L = cfg.num_hidden_layers
    for key, n in counts.items():
        want = (L * steps if key.startswith("flash")
                or (fused and key.startswith("fused_swiglu")) else 0)
        check(n == want, f"{key} launched {n} times in {steps} llama steps "
              f"of {L} layers (want {want}; FLAGS_fused_mlp={fused})")
    routes = fwd_routes_reading(counts, "llama-7b training")
    broutes = bwd_routes_reading(counts, "llama-7b training")
    sroutes = (swiglu_routes_reading(counts, "llama-7b training") if fused
               else dict(mf.swiglu_bwd_routes))
    sfroutes = swiglu_fwd_routes_reading(counts, "llama-7b training", fused)
    tokens = LLAMA_S
    flops = llama_flops_per_step(cfg, tokens, LLAMA_S)
    ms = wall / steps * 1e3
    out = dict(config="llama-7b", layers=L, b=1, s=LLAMA_S, dtype="bfloat16",
               fused_mlp=fused, last_mlp_path=path, lr=LLAMA_LR,
               warmup_loss=float(loss0), losses=losses, ms_per_step=ms,
               tokens_per_s=tokens / (ms / 1e3),
               model_tflop_per_step=flops / 1e12,
               model_tflops=flops / (ms / 1e3) / 1e12,
               model_flops_share_of_989=flops / (ms / 1e3) / 989e12,
               adamw_ms_per_step=sum(adamw_ms) / steps,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               parameters=sum(p.numel() for p in model.parameters()),
               card_during_steps=clocks.summary(), launches=counts,
               launches_per_step={k: n / steps for k, n in counts.items()},
               flash_fwd_routes=routes, flash_bwd_routes=broutes,
               swiglu_fwd_routes=sfroutes, swiglu_bwd_routes=sroutes)
    return out, model, opt, step


def phase_profile_llama(torch, step, steps=2):
    """torch.profiler over `steps` llama training steps: device busy time
    per step against the profiled wall time, the flash and SwiGLU
    kernels' shares, the optimizer step's span on the device, and the
    kernels that take the time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = read_launches()
    sroutes = swiglu_routes_reading(counts, "llama-7b profile")
    sfroutes = swiglu_fwd_routes_reading(counts, "llama-7b profile")
    # the "adamw_step" range of llama_trainer shows on the device timeline
    # as an annotation spanning the optimizer's kernels: its span is the
    # AdamW update's device time, and it is kept out of the busy sum
    spans = {}
    dev = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.key == "adamw_step":
                spans[e.key] = e.self_device_time_total / 1e3 / steps
            else:
                dev.append(e)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if busy_ms == 0.0:
        return dict(steps=steps, device_time="not measured (no CUDA events)")
    flash = {k: sum(e.self_device_time_total for e in dev if k in e.key)
             / 1e3 / steps
             for k in ("flash_fwd_wgmma_kernel", "flash_fwd_kernel",
                       "flash_bwd_prep_kernel", "flash_dq_wgmma_kernel",
                       "flash_dkv_wgmma_kernel", "flash_dq_kernel",
                       "flash_dkv_kernel")}
    # the SwiGLU kernels by instantiation: the core's <A MN-major, B
    # MN-major, BN, stages, epilogue, paired>: the forward's P1 (EpiSwiglu,
    # paired) and P2 (EpiSum, EpiSumLast) at <false, true>; the backward's
    # P1 (swiglu_dact_wgmma_kernel), P2 (EpiStore / EpiSum / EpiSumLast at
    # <false, false>), P3 and P4 (EpiStore at <true, true>)
    mlp = kernel_ms(dev, MLP_KERNEL_NAMES, steps)
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    flaunch = fwd_core_launches(
        dev, steps, counts["fused_swiglu_fwd"] // steps, mf.swiglu_fwd_plan(
            SW_R, SW_H, SW_F, min(SW_F, mf._MLP_FWD_CHUNK_F)),
        "llama-7b profile")
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)
    return dict(steps=steps, wall_ms_per_step=wall_ms / steps,
                device_busy_ms_per_step=busy_ms / steps,
                device_idle_share=1.0 - busy_ms / wall_ms,
                swiglu_fwd_launches=flaunch, flash_ms_per_step=flash,
                flash_share_of_busy=sum(flash.values()) * steps / busy_ms,
                swiglu_ms_per_step=sum(mlp.values()),
                swiglu_share_of_busy=sum(mlp.values()) * steps / busy_ms,
                swiglu_ms_per_step_by_direction=mlp_by_direction(mlp),
                swiglu_kernels_ms_per_step=mlp, swiglu_fwd_routes=sfroutes,
                swiglu_bwd_routes=sroutes,
                adamw_span_ms_per_step=spans.get(
                    "adamw_step", "not measured (no adamw_step range)"),
                top_device_ms_per_step=[
                    (e.key[:70], e.self_device_time_total / 1e3 / steps,
                     e.count // steps) for e in top[:14]])


def dense_causal_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                           is_causal=False, training=True):
    """Plain causal softmax attention on [B, S, NH, D], written here for
    the parity phase only (the port's LLaMA takes the flash kernels)."""
    import torch
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    n = s.shape[-1]
    keep = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), -1)
    return (p @ v).transpose(1, 2)


def phase_llama_parity_fp32(torch):
    """fp32 at llama-7b width, 2 layers, B=1, S=2048: loss and every
    gradient of the Layer model's loss (a) with the SwiGLU and flash
    kernels against (b) FLAGS_fused_mlp off (the dense SwiGLU), and (b)
    against (c) the model with its attention call replaced, in this
    script only, by dense_causal_attention."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.models import llama
    cfg = llama.CONFIGS["llama-7b"]._replace(num_hidden_layers=2)
    model = llama.LlamaForCausalLM(cfg, dtype=torch.float32, seed=1)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, LLAMA_S))).cuda()
    params = list(model.parameters())

    def grads(fused):
        set_flags({"FLAGS_fused_mlp": fused})
        reset_launches()
        loss = model.loss(ids, ids)
        g = torch.autograd.grad(loss, params)
        return loss.item(), g, read_launches()

    lf, gf, counts = grads(True)
    check(counts["fused_swiglu_fwd"] == 2 and counts["fused_swiglu_dw"] == 2
          and counts["flash_fwd"] == 2,
          f"llama fp32 parity run with FLAGS_fused_mlp on launched {counts}")
    lk, gk, _ = grads(False)
    sdpa = llama.scaled_dot_product_attention
    llama.scaled_dot_product_attention = dense_causal_attention
    try:
        ld, gd, counts_d = grads(False)
    finally:
        llama.scaled_dot_product_attention = sdpa
        set_flags({"FLAGS_fused_mlp": True})
    check(counts_d["flash_fwd"] == 0, f"dense attention run launched "
          f"{counts_d}")
    torch.cuda.synchronize()
    tol = 1e-4      # per leaf, relative to the leaf's largest gradient

    def worst(ga, gb):
        w = 0.0
        for a, b in zip(ga, gb):
            check(bool(torch.isfinite(a).all()), "parity gradient not finite")
            w = max(w, float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-30))
        return w

    worst_mlp, worst_flash = worst(gf, gk), worst(gk, gd)
    check(abs(lf - lk) <= 1e-5 * abs(lk), f"llama fp32 loss: SwiGLU kernels "
          f"{lf} vs dense {lk}")
    check(abs(lk - ld) <= 1e-5 * abs(ld), f"llama fp32 loss: flash {lk} vs "
          f"dense attention {ld}")
    check(worst_mlp <= tol, f"llama fp32 gradients: SwiGLU kernels vs dense "
          f"relative {worst_mlp} > {tol}")
    check(worst_flash <= tol, f"llama fp32 gradients: flash vs dense "
          f"attention relative {worst_flash} > {tol}")
    leaves = len(gk)
    del model, params, gf, gk, gd
    return dict(loss_fused_mlp=lf, loss_flash=lk, loss_dense=ld,
                worst_grad_relative_fused_vs_dense_mlp=worst_mlp,
                worst_grad_relative_flash_vs_dense_attention=worst_flash,
                tolerance=tol, leaves=leaves)


# ---------------------------------------------------------------------------
# phase 20: the LayerNorm kernels (13, 14) against their plain versions
# ---------------------------------------------------------------------------

LN_SOURCE = "paddle_tpu_torch/kernels/csrc/norm_fusion.cu"
PL_SOURCE = "paddle_tpu_torch/kernels/csrc/proj_ln.cu"
LN_REPLACES = {
    "fused_ln_fwd": "paddle_tpu/kernels/norm_fusion.py:82",
    "fused_ln_bwd": "paddle_tpu/kernels/norm_fusion.py:120",
    "fused_proj_ln_fwd": "paddle_tpu/kernels/mlp_fusion.py:714",
    "fused_proj_ln_bwd": "paddle_tpu/kernels/mlp_fusion.py:751"}
# Each output is held to max |kernel - plain| <= tol * max |plain|. f32:
# the same f32 arithmetic in other summation orders. bf16 I/O: both round
# the same f32 values to bf16, a value near a rounding boundary rounds the
# other way (one bf16 unit, 2^-8 of the largest magnitude at most), so
# 2^-7. Readings on an H100 in the first run of these kernels: 3.4e-7
# (f32), 0.0034 (bf16).
LN_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
# integer operations of the dropout hash per element (common.cuh keep_mix
# and the tile index: two multiplies, six shifts and xors, the index's
# multiply-add and the compare), counted at the CUDA cores' f32 rate
HASH_OPS = 12
BERT_R, BERT_H = 16384, 768          # bert-base at B=32, S=512
LN_CASES = [(BERT_R, BERT_H), (BERT_R - 1, BERT_H), (4096, 1024),
            (4096, 2048)]
LN_VARIANTS = [(False, False), (True, False), (False, True), (True, True)]


def rel_err(got, ref):
    g, r = got.detach().float(), ref.detach().float()
    err = float((g - r).abs().max())
    return err, err / max(float(r.abs().max()), 1e-30)


def ln_inputs(torch, r, h, dtype, seed, res=True, lin_b=False):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, s=1.0, m=0.0):
        return (m + torch.randn(*shape, generator=g, device="cuda") * s)

    return dict(h=rnd(r, h, s=2.0, m=0.5).to(dtype),
                res=rnd(r, h).to(dtype) if res else None,
                lin_b=rnd(h, s=0.3) if lin_b else None,
                w=rnd(h, s=0.2, m=1.0), b=rnd(h, s=0.2),
                g=rnd(r, h).to(dtype))


def ln_bounds(r, h, esize, res, drop=False):
    """bound_ms and what bounds it: the forward reads h (and res) and
    writes y, mean and rstd; the backward reads h (and res), g, mean and
    rstd and writes dh (and dres), dw and db, each once at 3.35 TB/s; ~10
    flops per element on the CUDA cores (67 TFLOP/s f32) take far less,
    with dropout the hash's ~12 integer operations an element more
    (HASH_OPS, at the same rate)."""
    rows, rowvec, vec = r * h * esize, r * 4, h * 4
    n = 2 if res else 1
    extra = HASH_OPS * r * h if drop else 0.0
    work = {"fused_ln_fwd": (10.0 * r * h + extra, n * rows + 2 * vec + rows
                             + 2 * rowvec),
            "fused_ln_bwd": (12.0 * r * h + extra, (n + 1) * rows + vec
                             + 2 * rowvec + n * rows + 2 * vec)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / H100_FLOPS["float32"]
        t_bytes = nbytes / H100_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def same_bits(a, b):
    """Both None, or tensors of one dtype equal bit for bit."""
    import torch
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and torch.equal(a, b)


def phase_ln_vs_plain(torch):
    """The forward and backward custom ops (``fused_ln_fwd``,
    ``fused_ln_bwd``: the kernels' wrappers, which the training step
    reaches through ``fused_layer_norm_2d``) against their plain versions
    (y, mean, rstd, dh, dres, dbias, dw, db) in every case: bert-base rows
    and H, a ragged R, and the GPT Layer model's H = 1024 and 2048; f32
    and bf16; all four (residual, lin_b) variants. Two backward calls give
    the same bits. Autograd through ``fused_layer_norm_2d`` at bert-base
    shape in bf16 (bf16 gains and biases, as the model holds them) against
    the plain versions, and bitwise against the ops. The check shown to
    reject a forward that drops the residual and a backward that drops
    the first 32 rows of its column sums. Then the times of the BERT FFN
    close (residual, no bias) and of the embeddings' LayerNorm
    (neither)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import norm_fusion as nf
    worst, worst_generic = {}, {}
    before = dict(nf.ln_bwd_routes)
    want = {"persistent": 0, "generic": 0}
    taken = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for r, h in LN_CASES:
            route = nf.ln_bwd_route(dtype, h, True)
            taken[f"{name} {r}x{h}"] = route
            for has_res, has_lb in LN_VARIANTS:
                x = ln_inputs(torch, r, h, dtype, r + h, has_res, has_lb)
                args = (x["h"], x["res"], x["lin_b"], x["w"], x["b"])
                y, mean, rstd = nf.fused_ln_fwd(*args, 1e-12)
                grads = nf.fused_ln_bwd(*args, mean, rstd, x["g"])
                again = nf.fused_ln_bwd(*args, mean, rstd, x["g"])
                want[route] += 2
                dh, dres, dlb, dw, db = grads
                # the generic kernels beside the persistent one, same inputs
                gen = None
                if route == "persistent":
                    gen = nf._bwd_cuda(x["h"], x["res"], x["lin_b"], x["w"],
                                       mean, rstd, x["g"], route="generic")
                    want["generic"] += 1
                ry, rmean, rrstd = nf.fused_ln_fwd_ref(*args, 1e-12)
                dz, rdw, rdb, rdlb = nf.fused_ln_bwd_ref(
                    *args[:4], mean, rstd, x["g"])
                torch.cuda.synchronize()
                check(all(same_bits(a, b) for a, b in zip(again, grads)),
                      f"fused LN backward differs between two calls ({name} "
                      f"r={r} h={h} res={has_res} lin_b={has_lb})")
                outs = [("y", y, ry), ("mean", mean, rmean),
                        ("rstd", rstd, rrstd), ("dh", dh, dz),
                        ("dw", dw, rdw), ("db", db, rdb)]
                if has_res:
                    outs.append(("dres", dres, dz))
                if has_lb:
                    outs.append(("dbias", dlb, rdlb))
                if gen is not None:
                    outs += [(f"generic {k}", t, ref) for k, t, ref in (
                        ("dh", gen[0], dz), ("dres", gen[1], dz),
                        ("dw", gen[2], rdw), ("db", gen[3], rdb),
                        ("dbias", gen[4], rdlb)) if t is not None]
                for key, got, ref in outs:
                    check(bool(torch.isfinite(got).all()),
                          f"fused LN {key} not finite ({name} r={r} h={h})")
                    err, rel = rel_err(got, ref)
                    check(rel <= LN_TOL[name],
                          f"fused LN {key} disagrees with plain: {name} r={r} "
                          f"h={h} res={has_res} lin_b={has_lb} route={route} "
                          f"max_abs_err={err} relative {rel} > {LN_TOL[name]}")
                    kern = ("fused_ln_fwd" if key in ("y", "mean", "rstd")
                            else "fused_ln_bwd")
                    into = worst_generic if key.startswith("generic") \
                        else worst
                    w = into.setdefault(name, {}).setdefault(kern, [0., 0.])
                    w[0], w[1] = max(w[0], err), max(w[1], rel)
                del x, args, y, mean, rstd, grads, again, dh, dres, dlb, dw
                del db, ry, rmean, rrstd, dz, rdw, rdb, rdlb, gen
    routes = {k: nf.ln_bwd_routes[k] - before[k] for k in before}
    check(routes == want, f"LN backward routes {routes}, want {want}")
    torch.cuda.empty_cache()
    return dict(tolerance_relative_to_max=LN_TOL,
                worst={n: {k: dict(max_abs_err=e, relative=r)
                           for k, (e, r) in w.items()}
                       for n, w in worst.items()},
                worst_generic_backward={
                    n: dict(max_abs_err=w["fused_ln_bwd"][0],
                            relative=w["fused_ln_bwd"][1])
                    for n, w in worst_generic.items()},
                backward_routes=taken, routes=routes,
                cases=[[r, h] for r, h in LN_CASES],
                variants=len(LN_VARIANTS),
                autograd_bf16=ln_autograd(torch, nf),
                wrong_kernel_reading=ln_check_rejects(torch, nf),
                times={"residual": ln_times(torch, nf, True),
                       "plain_ln": ln_times(torch, nf, False)},
                dropout=ln_dropout(torch, nf, fa))


def ln_autograd(torch, nf):
    """Autograd through fused_layer_norm_2d at R=16384, H=768, bf16, with
    the residual and the bias and bf16 gains: each gradient (dh, dres,
    dbias, dw, db, cast to its primal's dtype) against the plain backward
    cast the same way, within LN_TOL; bitwise equal to the ops' results.
    Returns the readings."""
    x = ln_inputs(torch, BERT_R, BERT_H, torch.bfloat16, 17, True, True)
    h, res, g = x["h"], x["res"], x["g"]
    lb, w, b = (x[k].to(torch.bfloat16) for k in ("lin_b", "w", "b"))
    prim = [t.detach().requires_grad_(True) for t in (h, res, lb, w, b)]
    y = nf.fused_layer_norm_2d(prim[0], prim[3], prim[4], residual=prim[1],
                               lin_bias=prim[2], eps=1e-12)
    auto = torch.autograd.grad(y, prim, g)
    y_op, mean, rstd = nf.fused_ln_fwd(h, res, lb, w, b, 1e-12)
    ops = nf.fused_ln_bwd(h, res, lb, w, b, mean, rstd, g)
    ry, _, _ = nf.fused_ln_fwd_ref(h, res, lb, w, b, 1e-12)
    dz, rdw, rdb, rdlb = nf.fused_ln_bwd_ref(h, res, lb, w, mean, rstd, g)
    torch.cuda.synchronize()
    check(same_bits(y, y_op) and all(same_bits(a, o)
                                     for a, o in zip(auto, ops)),
          "autograd through fused_layer_norm_2d differs from the LN ops")
    bf = torch.bfloat16
    readings = {}
    for key, got, ref in (("y", y, ry), ("dh", auto[0], dz.to(bf)),
                          ("dres", auto[1], dz.to(bf)),
                          ("dbias", auto[2], rdlb.to(bf)),
                          ("dw", auto[3], rdw.to(bf)),
                          ("db", auto[4], rdb.to(bf))):
        readings[key] = rel_err(got, ref)[1]
        check(got.dtype == bf and readings[key] <= LN_TOL["bfloat16"],
              f"autograd through fused_layer_norm_2d: {key} {got.dtype} "
              f"relative {readings[key]} > {LN_TOL['bfloat16']}")
    del x, h, res, g, lb, w, b, prim, y, auto, y_op, mean, rstd, ops, ry
    del dz, rdw, rdb, rdlb
    torch.cuda.empty_cache()
    return dict(r=BERT_R, h=BERT_H, relative_to_max=readings,
                bitwise_equal_to_ops=True)


def ln_check_rejects(torch, nf):
    """The bf16 check must reject a forward that leaves out the residual
    and a backward that leaves out 32 rows of dw and db (one partial of
    the generic kernels): the kernels run on inputs that do just that (no
    residual; the first 32 rows cut), held against the plain versions of
    the whole. Returns the readings."""
    x = ln_inputs(torch, BERT_R, BERT_H, torch.bfloat16, 23, True)
    h, res, w, b, g = x["h"], x["res"], x["w"], x["b"], x["g"]
    ry, mean, rstd = nf.fused_ln_fwd_ref(h, res, None, w, b, 1e-12)
    _, rdw, rdb, _ = nf.fused_ln_bwd_ref(h, res, None, w, mean, rstd, g)
    no_res, _, _ = nf.fused_ln_fwd(h, None, None, w, b, 1e-12)
    k = 32
    _, _, _, cut_dw, cut_db = nf.fused_ln_bwd(h[k:], res[k:], None, w, b,
                                              mean[k:], rstd[k:], g[k:])
    readings = {"forward_without_residual": rel_err(no_res, ry)[1],
                "dw_one_partial_dropped": rel_err(cut_dw, rdw)[1],
                "db_one_partial_dropped": rel_err(cut_db, rdb)[1]}
    for key, reading in readings.items():
        check(reading > LN_TOL["bfloat16"],
              f"the bf16 LN check passes a wrong kernel ({key}): {reading} "
              f"<= {LN_TOL['bfloat16']}")
    del x, h, res, w, b, g, ry, mean, rstd, rdw, rdb, no_res, cut_dw, cut_db
    torch.cuda.empty_cache()
    return readings


def ln_times(torch, nf, res, key=None):
    """Device times at R=16384, H=768, bf16 (with the residual: the FFN
    close; without: the embeddings' and the MLM transform's LayerNorm):
    each op in turns with its plain version; the library yardstick (never
    called by the port) is F.layer_norm of res + h and its autograd
    backward. With a dropout ``key``: the dropout variants, and
    F.layer_norm(res + F.dropout(h)) as the yardstick."""
    x = ln_inputs(torch, BERT_R, BERT_H, torch.bfloat16, 5, res)
    h, r, w, b, g = x["h"], x["res"], x["w"], x["b"], x["g"]
    d = () if key is None else (key.p, key.s0, key.s1, key.rows)
    y, mean, rstd = nf.fused_ln_fwd(h, r, None, w, b, 1e-12, *d)
    runs = {
        "fused_ln_fwd": (lambda _: nf.fused_ln_fwd(h, r, None, w, b, 1e-12,
                                                   *d),
                         lambda _: nf.fused_ln_fwd_ref(h, r, None, w, b,
                                                       1e-12, key)),
        "fused_ln_bwd": (lambda _: nf.fused_ln_bwd(h, r, None, w, b, mean,
                                                   rstd, g, *d),
                         lambda _: nf.fused_ln_bwd_ref(h, r, None, w, mean,
                                                       rstd, g, key)),
    }
    bounds = ln_bounds(BERT_R, BERT_H, 2, res, key is not None)
    out = {}
    for name, (kern, plain) in runs.items():
        plain_ms, ms, t = in_turns(plain, kern)
        out[name] = dict(ms=ms, plain_ms=plain_ms, all_ms=t,
                         bound_ms=bounds[name][0], bound_by=bounds[name][1])
    # the backward's kernels alone (no casts), persistent against generic
    kern = {route: (lambda _, rt=route: nf._bwd_cuda(h, r, None, w, mean,
                                                     rstd, g, key, route=rt))
            for route in ("persistent", "generic")}
    earlier_ms, kernel_ms, t = in_turns(kern["generic"], kern["persistent"])
    n, names = cuda_launches(torch, lambda: kern["persistent"](None))
    check(1 <= n <= 2, f"LN backward: {n} CUDA launches a call ({names})")
    out["fused_ln_bwd"].update(
        route="persistent", kernel_ms=kernel_ms, earlier_ms=earlier_ms,
        earlier="the generic ln_bwd_vec + sum_parts, same inputs, in turns",
        route_all_ms=t, cuda_launches_per_call=n, kernels=names,
        generic_cuda_launches_per_call=cuda_launches(
            torch, lambda: kern["generic"](None))[0],
        note="ms and plain_ms: the op (the kernels and the casts of dw and "
             "db); kernel_ms, earlier_ms: the persistent and generic "
             "kernels alone")
    wl, bl = w.to(h.dtype), b.to(h.dtype)
    layer_norm = torch.nn.functional.layer_norm

    def library(hh, rr, ww, bb):
        if key is not None:
            hh = torch.nn.functional.dropout(hh, key.p)
        return layer_norm(hh if rr is None else rr + hh, (BERT_H,), ww, bb,
                          1e-12)

    out["fused_ln_fwd"]["library_ms"], _, _ = in_turns(
        lambda _: library(h, r, wl, bl), runs["fused_ln_fwd"][0])
    prim = [t.detach().requires_grad_(True) for t in (h, wl, bl)]
    rg = None if r is None else r.detach().requires_grad_(True)
    yl = library(prim[0], rg, prim[1], prim[2])
    leaves = prim + ([] if rg is None else [rg])
    out["fused_ln_bwd"]["library_ms"], _, _ = in_turns(
        lambda _: torch.autograd.grad(yl, leaves, g, retain_graph=True),
        runs["fused_ln_bwd"][0])
    out["timed_at"] = dict(r=BERT_R, h=BERT_H, dtype="bfloat16",
                           residual=res, lin_b=False,
                           dropout=None if key is None else key.p)
    del x, h, r, w, b, g, y, mean, rstd, prim, rg, yl, leaves
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 21: the projection-LayerNorm kernels (10, 11) against plain
# ---------------------------------------------------------------------------

PL_CASES = [(BERT_R, 768, 768), (BERT_R, 1024, 1024), (1000, 512, 768)]


def pl_inputs(torch, r, hin, hout, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, s=1.0, m=0.0):
        return m + torch.randn(*shape, generator=g, device="cuda") * s

    return dict(x=rnd(r, hin).to(dtype),
                w=rnd(hin, hout, s=hin ** -0.5).to(dtype),
                b=rnd(hout, s=0.2), res=rnd(r, hout).to(dtype),
                lnw=rnd(hout, s=0.2, m=1.0), lnb=rnd(hout, s=0.2),
                g=rnd(r, hout).to(dtype))


def pl_bounds(r, hin, hout, esize):
    """The forward reads x, W and res and writes y (and the row stats);
    its product is 2 R Hin Hout flops at 989 TFLOP/s. The cluster
    backward reads x, W, res, g and the stats, writes dres (res's dtype),
    the pair (hi, lo: 4 bytes an element) and dgamma, dbeta, db, and
    repeats the product; the generic backward (the earlier kernel 11)
    writes dz and dp in f32 and dgamma, dbeta instead. Dropout moves no
    byte more; its hash's R Hout integer operations run on the CUDA cores
    beside the tensor cores' product, and the bound stays the bytes. The
    whole backward on the cluster route is the kernel, then the pair
    products (dx over K = 2 Hout, dW over the pair's 2 Hout columns: 2 x
    2 R Hin 2 Hout flops): its floor is the sum of the two."""
    flops = 2.0 * r * hin * hout
    rows_in, rows_out = r * hin * esize, r * hout * esize
    wbytes, rowvec, vec = hin * hout * esize, r * 4, hout * 4
    bwd_in = rows_in + wbytes + 2 * rows_out + 2 * vec + 2 * rowvec
    work = {"fused_proj_ln_fwd": (flops, rows_in + wbytes + rows_out + 3 * vec
                                  + rows_out + 2 * rowvec),
            "fused_proj_ln_bwd": (flops, bwd_in + rows_out + r * hout * 4
                                  + 3 * vec),
            "fused_proj_ln_bwd_generic": (flops, bwd_in + 2 * r * hout * 4
                                          + 2 * vec)}
    out = {}
    for name, (fl, nbytes) in work.items():
        t_ops = fl / H100_FLOPS["bfloat16"]
        t_bytes = nbytes / H100_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    products_ms = 2 * 2.0 * r * hin * 2 * hout / H100_FLOPS["bfloat16"] * 1e3
    out["whole_backward"] = (out["fused_proj_ln_bwd"][0] + products_ms,
                             "the kernel's bytes, then the pair products' "
                             "operations")
    return out


def phase_proj_ln_vs_plain(torch):
    """The forward and backward custom ops (``fused_proj_ln_fwd``,
    ``fused_proj_ln_bwd``: the kernels' wrappers, which the training step
    reaches through ``fused_proj_ln_2d``) against their plain versions
    (y, mean, rstd, dz, dp, dgamma, dbeta): bert-base (Hin = Hout = 768),
    bert-large's 1024 and a ragged R with Hin != Hout, f32 and bf16. Two
    backward calls give the same bits. Autograd through
    ``fused_proj_ln_2d`` at bert-base shape in bf16 (dx, dW, db, dres,
    dgamma, dbeta) against the plain versions. The check shown to reject
    a forward missing one 256-column chunk of the product and a backward
    missing one 32-row partial. Then their times at bert-base shape, and
    the f32 products the backward runs outside the kernel (dx, dW, db
    from dp)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    from paddle_tpu_torch.kernels import norm_fusion as nf
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for r, hin, hout in PL_CASES:
            x = pl_inputs(torch, r, hin, hout, dtype, r + hin + hout)
            args = (x["x"], x["w"], x["b"], x["res"], x["lnw"])
            y, mean, rstd = mf.fused_proj_ln_fwd(*args, x["lnb"], 1e-12)
            grads = mf.fused_proj_ln_bwd(*args, mean, rstd, x["g"])
            again = mf.fused_proj_ln_bwd(*args, mean, rstd, x["g"])
            dz, dp, dg, dbeta = grads
            ry, rmean, rrstd = mf.fused_proj_ln_fwd_ref(*args, x["lnb"],
                                                        1e-12)
            rdz, rdp, rdg, rdbeta = mf.fused_proj_ln_bwd_ref(*args, mean,
                                                             rstd, x["g"])
            torch.cuda.synchronize()
            check(all(same_bits(a, b) for a, b in zip(again, grads)),
                  f"proj-LN backward differs between two calls ({name} "
                  f"r={r} hin={hin} hout={hout})")
            for key, got, ref in (("y", y, ry), ("mean", mean, rmean),
                                  ("rstd", rstd, rrstd), ("dz", dz, rdz),
                                  ("dp", dp, rdp), ("dgamma", dg, rdg),
                                  ("dbeta", dbeta, rdbeta)):
                check(bool(torch.isfinite(got).all()),
                      f"proj-LN {key} not finite ({name} r={r})")
                err, rel = rel_err(got, ref)
                check(rel <= LN_TOL[name],
                      f"proj-LN {key} disagrees with plain: {name} r={r} "
                      f"hin={hin} hout={hout} max_abs_err={err} relative "
                      f"{rel} > {LN_TOL[name]}")
                kern = ("fused_proj_ln_fwd" if key in ("y", "mean", "rstd")
                        else "fused_proj_ln_bwd")
                w = worst.setdefault(name, {}).setdefault(kern, [0., 0.])
                w[0], w[1] = max(w[0], err), max(w[1], rel)
            del x, args, y, mean, rstd, grads, again, dz, dp, dg, dbeta
            del ry, rmean, rrstd, rdz, rdp, rdg, rdbeta
    torch.cuda.empty_cache()
    return dict(tolerance_relative_to_max=LN_TOL,
                worst={n: {k: dict(max_abs_err=e, relative=r)
                           for k, (e, r) in w.items()}
                       for n, w in worst.items()},
                cases=[list(c) for c in PL_CASES],
                autograd_bf16=pl_autograd(torch, mf),
                wrong_kernel_reading=pl_check_rejects(torch, mf),
                cluster=pl_cluster(torch, mf, nf, fa),
                wide_hout=pl_wide_hout(torch, mf),
                dropout=pl_dropout(torch, mf, nf, fa),
                **pl_times(torch, mf))


PL_WIDE = (4096, 768, 2048)          # R, Hin, Hout beyond the kernel's tile


def pl_wide_hout(torch, mf):
    """The widest Hout the kernels take, as the Python side reckons it
    (``proj_ln_max_hout``, the routing rule), equals the library's
    ``proj_ln_max_hout_*``; a wider Hout (2048) goes through
    ``fused_attn_proj_residual_layer_norm`` on the card by the once-warned
    dense route (linear, then the LayerNorm kernels) and agrees with the
    projection-LN's plain version, f32 and bf16 (LN_TOL). Returns the
    limits and the readings."""
    import warnings
    from paddle_tpu_torch.nn.functional import (
        fused_attn_proj_residual_layer_norm, last_mlp_path)
    lib = mf._pl_lib()
    limits = {"float32": (mf.proj_ln_max_hout(torch.float32),
                          lib.proj_ln_max_hout_f32()),
              "bfloat16": (mf.proj_ln_max_hout(torch.bfloat16),
                           lib.proj_ln_max_hout_bf16())}
    for name, (py, cu) in limits.items():
        check(py == cu, f"proj_ln_max_hout({name}): Python {py}, library {cu}")
    r, hin, hout = PL_WIDE
    readings = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        x = pl_inputs(torch, r, hin, hout, dtype, 43)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            y = fused_attn_proj_residual_layer_norm(
                x["x"], x["w"], x["b"].to(dtype), x["res"],
                x["lnw"].to(dtype), x["lnb"].to(dtype), dropout_rate=0.0,
                ln_epsilon=1e-12)
        path = last_mlp_path()
        ry, _, _ = mf.fused_proj_ln_fwd_ref(x["x"], x["w"], x["b"], x["res"],
                                            x["lnw"], x["lnb"], 1e-12)
        readings[name] = rel_err(y, ry)[1]
        check(path == "dense" and readings[name] <= LN_TOL[name],
              f"Hout={hout} {name} through the functional: path {path}, "
              f"relative {readings[name]} > {LN_TOL[name]}")
        del x, y, ry
    torch.cuda.empty_cache()
    return dict(max_hout={k: v[1] for k, v in limits.items()},
                python_equals_library=True, r=r, hin=hin, hout=hout,
                path="dense", relative_to_plain=readings)


def bf16_unit(t):
    """One bf16 unit in the last place of t's largest magnitude: two
    roundings of nearly equal f32 values to bf16 differ by at most this
    (between 2^-8 and 2^-7 of the magnitude)."""
    m = float(t.detach().float().abs().max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def pl_autograd(torch, mf):
    """Autograd through fused_proj_ln_2d at R=16384, Hin=Hout=768, bf16
    (the projection's weight and bias and the LN gains in bf16, as the
    model holds them), on the cluster route: its six gradients bitwise
    equal to the fused_proj_ln_grads op's, and dx, dW, db, dres, dgamma
    and dbeta within one bf16 unit of the largest magnitude (bf16_unit)
    of the f32-product reference (fused_proj_ln_grads_ref: the plain
    kernel's f32 dp, dx = dp.W^T and dW = x^T.dp in f32, each cast once).
    The pair products again with PyTorch's default
    allow_bf16_reduced_precision_reduction on (cuBLAS may then reduce
    split-K partial sums in bf16): whether dx and dW keep their bits; and
    at that default, dx and dW at ragged R and the other Hout held to the
    same unit (pl_autograd_default_flag). Returns the readings."""
    bf = torch.bfloat16
    x = pl_inputs(torch, BERT_R, BERT_H, BERT_H, bf, 19)
    xx, w, res, g = x["x"], x["w"], x["res"], x["g"]
    b, lnw, lnb = (x[k].to(bf) for k in ("b", "lnw", "lnb"))
    prim = [t.detach().requires_grad_(True) for t in (xx, w, b, res, lnw,
                                                      lnb)]
    before = dict(mf.pl_routes)
    y = mf.fused_proj_ln_2d(*prim, eps=1e-12)
    auto = torch.autograd.grad(y, prim, g)
    routes = {k: n - before[k] for k, n in mf.pl_routes.items()}
    check(routes == {"fwd_cluster": 1, "fwd_generic": 0, "bwd_cluster": 1,
                     "bwd_generic": 0},
          f"autograd through fused_proj_ln_2d took the routes {routes}")
    _, mean, rstd = mf.fused_proj_ln_fwd(xx, w, b, res, lnw, lnb, 1e-12)
    op = mf.fused_proj_ln_grads(xx, w, b, res, lnw, lnb, mean, rstd, g)
    ry, _, _ = mf.fused_proj_ln_fwd_ref(xx, w, b, res, lnw, lnb, 1e-12)
    ref = mf.fused_proj_ln_grads_ref(xx, w, b, res, lnw, lnb, mean, rstd, g)
    flag = torch.backends.cuda.matmul
    flag.allow_bf16_reduced_precision_reduction = True
    try:
        op_default = mf.fused_proj_ln_grads(xx, w, b, res, lnw, lnb, mean,
                                            rstd, g)
        torch.cuda.synchronize()
    finally:
        flag.allow_bf16_reduced_precision_reduction = False
    check(all(same_bits(a, e) for a, e in zip(auto, op)),
          "autograd through fused_proj_ln_2d differs from the "
          "fused_proj_ln_grads op")
    readings = {"y": rel_err(y, ry)[1]}
    check(readings["y"] <= LN_TOL["bfloat16"],
          f"fused_proj_ln_2d's y: relative {readings['y']}")
    for key, got, want in zip(("dx", "dW", "db", "dres", "dgamma", "dbeta"),
                              auto, ref):
        err, rel = rel_err(got, want)
        unit = bf16_unit(want)
        readings[key] = dict(max_abs_err=err, relative_to_max=rel,
                             bf16_unit=unit)
        check(got.dtype == bf and err <= unit,
              f"autograd through fused_proj_ln_2d: {key} {got.dtype} "
              f"max_abs_err {err} > one bf16 unit {unit}")
    default_bits = {k: same_bits(a, e) for k, a, e in
                    zip(("dx", "dW"), op_default, op)}
    default_flag = pl_autograd_default_flag(torch, mf)
    for shape, r in default_flag.items():
        for key, reading in r.items():
            check(reading["held"], f"autograd through fused_proj_ln_2d at "
                  f"{shape} with allow_bf16_reduced_precision_reduction on: "
                  f"{key} max_abs_err {reading['max_abs_err']} > one bf16 "
                  f"unit {reading['bf16_unit']}")
    del x, xx, w, res, g, b, lnw, lnb, prim, y, auto, mean, rstd, op, ry, ref
    del op_default
    torch.cuda.empty_cache()
    return dict(r=BERT_R, hin=BERT_H, hout=BERT_H, routes=routes,
                readings=readings,
                same_bits_with_reduced_precision_reduction=default_bits,
                default_flag_shapes=default_flag)


# ragged R and the other Hout the cluster route takes: cuBLAS may split
# K = 2 Hout of the dx product there, and reduce the parts in bf16 at
# PyTorch's default allow_bf16_reduced_precision_reduction
PL_DEFAULT_FLAG_SHAPES = [(128, 768, 256), (600, 768, 256), (128, 768, 512),
                          (600, 768, 512), (128, 256, 256), (600, 512, 512)]


def pl_autograd_default_flag(torch, mf):
    """Autograd through fused_proj_ln_2d on the cluster route at
    PL_DEFAULT_FLAG_SHAPES in bf16 with PyTorch's default
    allow_bf16_reduced_precision_reduction (on): dx and dW within one bf16
    unit of the largest magnitude of the f32-product reference, the check
    of pl_autograd. Returns each shape's readings and whether it held."""
    bf = torch.bfloat16
    flag = torch.backends.cuda.matmul
    out = {}
    for r, hin, hout in PL_DEFAULT_FLAG_SHAPES:
        x = pl_inputs(torch, r, hin, hout, bf, r + hin + hout)
        xx, w, res, g = x["x"], x["w"], x["res"], x["g"]
        b, lnw, lnb = (x[k].to(bf) for k in ("b", "lnw", "lnb"))
        prim = [t.detach().requires_grad_(True)
                for t in (xx, w, b, res, lnw, lnb)]
        before = dict(mf.pl_routes)
        flag.allow_bf16_reduced_precision_reduction = True
        try:
            y = mf.fused_proj_ln_2d(*prim, eps=1e-12)
            dx, dw = torch.autograd.grad(y, prim[:2], g)
            torch.cuda.synchronize()
        finally:
            flag.allow_bf16_reduced_precision_reduction = False
        routes = {k: n - before[k] for k, n in mf.pl_routes.items()}
        check(routes["fwd_cluster"] == 1 and routes["bwd_cluster"] == 1,
              f"fused_proj_ln_2d at R={r} Hin={hin} Hout={hout} took the "
              f"routes {routes}")
        _, mean, rstd = mf.fused_proj_ln_fwd(xx, w, b, res, lnw, lnb, 1e-12)
        ref = mf.fused_proj_ln_grads_ref(xx, w, b, res, lnw, lnb, mean, rstd,
                                         g)
        shape = f"R={r} Hin={hin} Hout={hout}"
        out[shape] = {}
        for key, got, want in (("dx", dx, ref[0]), ("dW", dw, ref[1])):
            err, rel = rel_err(got, want)
            unit = bf16_unit(want)
            out[shape][key] = dict(max_abs_err=err, relative_to_max=rel,
                                   bf16_unit=unit, held=err <= unit)
        del x, xx, w, res, g, b, lnw, lnb, prim, y, dx, dw, mean, rstd, ref
    torch.cuda.empty_cache()
    return out


def pl_check_rejects(torch, mf):
    """The bf16 check must reject a forward missing one 256-column chunk
    of the product (W's columns 256-511 zeroed) and a backward missing
    one 32-row partial of dgamma and dbeta (the first 32 rows cut): the
    kernels on those inputs, held against the plain versions of the
    whole. Returns the readings."""
    x = pl_inputs(torch, BERT_R, BERT_H, BERT_H, torch.bfloat16, 29)
    xx, w, b, res, lnw, lnb, g = (x[k] for k in ("x", "w", "b", "res", "lnw",
                                                 "lnb", "g"))
    ry, mean, rstd = mf.fused_proj_ln_fwd_ref(xx, w, b, res, lnw, lnb, 1e-12)
    _, _, rdg, rdbeta = mf.fused_proj_ln_bwd_ref(xx, w, b, res, lnw, mean,
                                                 rstd, g)
    w_cut = w.clone()
    c0 = min(256, BERT_H // 2)          # the kernel's second column chunk
    w_cut[:, c0:2 * c0] = 0
    no_chunk, _, _ = mf.fused_proj_ln_fwd(xx, w_cut, b, res, lnw, lnb, 1e-12)
    k = 32
    _, _, cut_dg, cut_dbeta = mf.fused_proj_ln_bwd(
        xx[k:], w, b, res[k:], lnw, mean[k:], rstd[k:], g[k:])
    readings = {"forward_one_column_chunk_dropped": rel_err(no_chunk, ry)[1],
                "dgamma_one_partial_dropped": rel_err(cut_dg, rdg)[1],
                "dbeta_one_partial_dropped": rel_err(cut_dbeta, rdbeta)[1]}
    for key, reading in readings.items():
        check(reading > LN_TOL["bfloat16"],
              f"the bf16 proj-LN check passes a wrong kernel ({key}): "
              f"{reading} <= {LN_TOL['bfloat16']}")
    del x, xx, w, b, res, lnw, lnb, g, ry, mean, rstd, rdg, rdbeta, w_cut
    del no_chunk, cut_dg, cut_dbeta
    torch.cuda.empty_cache()
    return readings


PAIR_TOL = 2 ** -14   # hi + lo against the plain f32 dp, of its largest magnitude


def pl_cluster(torch, mf, nf, fa):
    """The cluster route's kernels (pl_route: bf16, Hout a multiple of 256
    up to 768) against their plain versions at PL_CASES, and with dropout
    (keyed by mlp_blocks' row tile) at PL_DROP_CASES: y, mean and rstd
    within LN_TOL of fused_proj_ln_fwd_ref; dres, dgamma, dbeta and db
    within LN_TOL of fused_proj_ln_bwd_pair_ref; hi + lo within PAIR_TOL
    of the plain f32 dp; two backward calls give the same bits; under
    dropout hi's zeros are the plain mask's. A case the route does not
    take (Hout 1024) is listed with its route; the route's geometry in
    Python equals the library's. Then the planted faults
    (pl_cluster_rejects). Returns the readings."""
    bf = torch.bfloat16
    lib = mf._pl_lib()
    check(lib.proj_ln_cluster_max_hout() == mf.PL_CLUSTER_MAX_HOUT
          and lib.proj_ln_cluster_rows() == mf.PL_CLUSTER_ROWS,
          f"the cluster route's geometry: library max Hout "
          f"{lib.proj_ln_cluster_max_hout()}, rows "
          f"{lib.proj_ln_cluster_rows()}; Python {mf.PL_CLUSTER_MAX_HOUT}, "
          f"{mf.PL_CLUSTER_ROWS}")
    worst, routes = {}, {}
    cases = [(c, False) for c in PL_CASES] + [(c, True) for c in PL_DROP_CASES]
    for (r, hin, hout), drop in cases:
        what = f"r={r} hin={hin} hout={hout} dropout={drop}"
        variant = "dropout" if drop else "plain"
        routes[what] = mf.pl_route(bf, hin, hout, True)
        if routes[what] != "cluster":
            continue
        x = pl_inputs(torch, r, hin, hout, bf, r + hin + hout + 2 + drop)
        key = (drop_key(fa, mf.mlp_blocks(r, hout, hin, dtype=bf)[0], hout)
               if drop else None)
        args = (x["x"], x["w"], x["b"], x["res"], x["lnw"])
        y, mean, rstd = mf._proj_ln_fwd_cuda(*args, x["lnb"], 1e-12, key,
                                             route="cluster")
        got = mf._proj_ln_bwd_pair_cuda(*args, mean, rstd, x["g"], key)
        again = mf._proj_ln_bwd_pair_cuda(*args, mean, rstd, x["g"], key)
        ry, rmean, rrstd = mf.fused_proj_ln_fwd_ref(*args, x["lnb"], 1e-12,
                                                    key)
        ref = mf.fused_proj_ln_bwd_pair_ref(*args, mean, rstd, x["g"], key)
        rdp = mf.fused_proj_ln_bwd_ref(*args, mean, rstd, x["g"], key)[1]
        torch.cuda.synchronize()
        check(all(same_bits(a, b) for a, b in zip(got, again)),
              f"proj-LN cluster backward differs between two calls ({what})")
        for label, g_, r_ in zip(
                ("y", "mean", "rstd", "dres", "dgamma", "dbeta", "db"),
                (y, mean, rstd, got[0], *got[3:]),
                (ry, rmean, rrstd, ref[0], *ref[3:])):
            check(bool(torch.isfinite(g_).all()),
                  f"proj-LN cluster {label} not finite ({what})")
            err, rel = rel_err(g_, r_)
            check(rel <= LN_TOL["bfloat16"],
                  f"proj-LN cluster {label} disagrees with plain: {what} "
                  f"max_abs_err={err} relative {rel} > {LN_TOL['bfloat16']}")
            kern = ("fused_proj_ln_fwd" if label in ("y", "mean", "rstd")
                    else "fused_proj_ln_bwd")
            w = worst.setdefault(variant, {}).setdefault(kern, [0., 0.])
            w[0], w[1] = max(w[0], err), max(w[1], rel)
        err, rel = rel_err(got[1].float() + got[2].float(), rdp)
        check(rel <= PAIR_TOL, f"proj-LN cluster: hi + lo is not dp ({what}): "
              f"relative {rel} > {PAIR_TOL}")
        w = worst.setdefault(variant, {}).setdefault("pair", [0., 0.])
        w[0], w[1] = max(w[0], err), max(w[1], rel)
        if drop:
            off = mask_mismatches(got[1], nf.row_keep_ref(key, x["res"]))
            check(off == 0, f"proj-LN cluster dropout: hi's zeros differ from "
                  f"the plain mask at {off} elements ({what})")
        del x, args, y, mean, rstd, got, again, ry, rmean, rrstd, ref, rdp
    torch.cuda.empty_cache()
    return dict(tolerance_relative_to_max=dict(LN_TOL, pair=PAIR_TOL),
                routes=routes,
                worst={v: {k: dict(max_abs_err=e, relative=r)
                           for k, (e, r) in w.items()}
                       for v, w in worst.items()},
                planted_faults=pl_cluster_rejects(torch, mf, nf, fa))


def pl_cluster_rejects(torch, mf, nf, fa):
    """The cluster checks must reject, at bert-base's shape: a forward
    missing one block's column slice (W's rank-1 slice zeroed); the pair
    without its lo half (hi alone against dp); a backward missing one
    128-row tile's partial of dgamma, dbeta and db (the first 128 rows
    cut); and the mask keyed by the cluster's own 128-row tile instead of
    the reference's (mlp_blocks: 256 rows here), which must differ at
    this shape. Each reading is held above its tolerance."""
    bf = torch.bfloat16
    x = pl_inputs(torch, BERT_R, BERT_H, BERT_H, bf, 31)
    xx, w, b, res, lnw, lnb, g = (x[k] for k in ("x", "w", "b", "res", "lnw",
                                                 "lnb", "g"))
    ry, mean, rstd = mf.fused_proj_ln_fwd_ref(xx, w, b, res, lnw, lnb, 1e-12)
    ref = mf.fused_proj_ln_bwd_pair_ref(xx, w, b, res, lnw, mean, rstd, g)
    rdp = mf.fused_proj_ln_bwd_ref(xx, w, b, res, lnw, mean, rstd, g)[1]
    c0, c1 = mf.pl_cluster_plan(BERT_H)[1]
    w_cut = w.clone()
    w_cut[:, c0:c1] = 0
    y_cut = mf._proj_ln_fwd_cuda(xx, w_cut, b, res, lnw, lnb, 1e-12,
                                 route="cluster")[0]
    hi = mf._proj_ln_bwd_pair_cuda(xx, w, b, res, lnw, mean, rstd, g)[1]
    k = mf.PL_CLUSTER_ROWS
    cut = mf._proj_ln_bwd_pair_cuda(xx[k:], w, b, res[k:], lnw, mean[k:],
                                    rstd[k:], g[k:])
    readings = {
        "forward_one_block_slice_zeroed": (rel_err(y_cut, ry)[1],
                                           LN_TOL["bfloat16"]),
        "pair_lo_dropped": (rel_err(hi, rdp)[1], PAIR_TOL),
        "dgamma_one_row_tile_cut": (rel_err(cut[3], ref[3])[1],
                                    LN_TOL["bfloat16"]),
        "dbeta_one_row_tile_cut": (rel_err(cut[4], ref[4])[1],
                                   LN_TOL["bfloat16"]),
        "db_one_row_tile_cut": (rel_err(cut[5], ref[5])[1],
                                LN_TOL["bfloat16"])}
    key = drop_key(fa, mf.mlp_blocks(BERT_R, BERT_H, BERT_H, dtype=bf)[0],
                   BERT_H)
    own = drop_key(fa, k, BERT_H)
    keep = nf.row_keep_ref(key, res)
    masks_differ = int((keep != nf.row_keep_ref(own, res)).sum())
    check(key.rows != own.rows and masks_differ > 0,
          f"the masks keyed by {key.rows} and {own.rows} rows agree at "
          f"bert-base's shape: the planted fault would show nothing")
    _, dmean, drstd = mf.fused_proj_ln_fwd_ref(xx, w, b, res, lnw, lnb,
                                               1e-12, key)
    hi_own = mf._proj_ln_bwd_pair_cuda(xx, w, b, res, lnw, dmean, drstd, g,
                                       own)[1]
    torch.cuda.synchronize()
    readings["mask_keyed_by_the_cluster_tile"] = (
        mask_mismatches(hi_own, keep), 0)
    for name, (reading, tol) in readings.items():
        check(reading > tol, f"the proj-LN cluster checks pass a planted "
              f"fault ({name}): {reading} <= {tol}")
    del x, xx, w, b, res, lnw, lnb, g, ry, mean, rstd, ref, rdp, w_cut, y_cut
    del hi, cut, keep, dmean, drstd, hi_own
    torch.cuda.empty_cache()
    return dict({n: dict(reading=r, tolerance=t)
                 for n, (r, t) in readings.items()},
                reference_tile_rows=key.rows, cluster_tile_rows=own.rows,
                masks_differ_at=masks_differ)


def pl_times(torch, mf, key=None):
    """Device times at R=16384, Hin=Hout=768, bf16, each in turns: the
    forward on the route the model takes (pl_route: the cluster kernel)
    with its plain version and with the generic kernel (earlier_ms); the
    cluster backward kernel with its plain version
    (fused_proj_ln_bwd_pair_ref) and with the generic backward kernel
    (earlier_ms: dz, dp in f32). The library yardstick (never called by
    the port) is F.layer_norm(res + addmm(b, x, W)) and its autograd
    backward (dx, dW, db, dres, dgamma, dbeta), beside which the whole
    backward (fused_proj_ln_grads' CUDA route: the kernel, then the pair
    products) is timed, and the generic route's whole backward (the f32
    kernel and f32 products: earlier_ms). The two kernels again at Hin =
    64, the product nearly free: what the rest costs. With a dropout
    ``key``: the dropout variants, and F.dropout on the addmm in the
    yardstick."""
    bf = torch.bfloat16
    x = pl_inputs(torch, BERT_R, BERT_H, BERT_H, bf, 9)
    xx, w, b, res, lnw, lnb, g = (x[k] for k in ("x", "w", "b", "res", "lnw",
                                                 "lnb", "g"))
    d = () if key is None else (key.p, key.s0, key.s1, key.rows)
    fwd_args = (xx, w, b, res, lnw, lnb, 1e-12)
    y, mean, rstd = mf.fused_proj_ln_fwd(*fwd_args, *d)
    bwd_args = (xx, w, b, res, lnw, mean, rstd, g)
    route = mf.pl_route(bf, BERT_H, BERT_H, True)
    check(route == "cluster", f"bert-base's projection-LN takes {route}")
    runs = {
        "fused_proj_ln_fwd": (
            lambda _: mf._proj_ln_fwd_cuda(*fwd_args, key, route=route),
            lambda _: mf.fused_proj_ln_fwd_ref(*fwd_args, key),
            lambda _: mf._proj_ln_fwd_cuda(*fwd_args, key, route="generic"),
            "the generic proj_ln_fwd_kernel (32-row blocks, mma.sync), same "
            "inputs, in turns"),
        "fused_proj_ln_bwd": (
            lambda _: mf._proj_ln_bwd_pair_cuda(*bwd_args, key),
            lambda _: mf.fused_proj_ln_bwd_pair_ref(*bwd_args, key),
            lambda _: mf._proj_ln_bwd_cuda(*bwd_args, key),
            "the generic proj_ln_bwd_kernel + sum_parts (dz, dp in f32), "
            "same inputs, in turns"),
    }
    bounds = pl_bounds(BERT_R, BERT_H, BERT_H, 2)
    out = {}
    for name, (kern, plain, earlier, what) in runs.items():
        plain_ms, _, t = in_turns(plain, kern)
        earlier_ms, ms, te = in_turns(earlier, kern)
        out[name] = dict(ms=ms, plain_ms=plain_ms, all_ms=t, route=route,
                         earlier_ms=earlier_ms, earlier=what,
                         earlier_turns_ms=te, bound_ms=bounds[name][0],
                         bound_by=bounds[name][1])
    out["fused_proj_ln_bwd"]["earlier_bound_ms"] = \
        bounds["fused_proj_ln_bwd_generic"][0]
    wb, lw, lb = b.to(xx.dtype), lnw.to(xx.dtype), lnb.to(xx.dtype)
    layer_norm = torch.nn.functional.layer_norm

    def library(xx, w, wb, res, lw, lb):
        p = torch.addmm(wb, xx, w)
        if key is not None:
            p = torch.nn.functional.dropout(p, key.p)
        return layer_norm(res + p, (BERT_H,), lw, lb, 1e-12)

    out["fused_proj_ln_fwd"]["library_ms"], _, _ = in_turns(
        lambda _: library(xx, w, wb, res, lw, lb), runs["fused_proj_ln_fwd"][0])
    prim = [t.detach().requires_grad_(True) for t in (xx, w, wb, res, lw, lb)]
    yl = library(*prim)

    def library_bwd(_):
        return torch.autograd.grad(yl, prim, g, retain_graph=True)

    out["fused_proj_ln_bwd"]["library_ms"], _, _ = in_turns(
        library_bwd, runs["fused_proj_ln_bwd"][0])

    def whole(route_):
        return lambda _: mf._proj_ln_grads_cuda(xx, w, b, res, lnw, lnb, mean,
                                                rstd, g, key, route=route_)

    earlier_ms, whole_ms, te = in_turns(whole("generic"), whole(route))
    lib_ms, _, tl = in_turns(library_bwd, whole(route))
    _, pair, _ = mf._pl_pair_kernel(*bwd_args, key)
    pair2 = pair.view(BERT_R, 2 * BERT_H)
    w2 = torch.cat([w, w], 1)
    out["whole_backward"] = dict(
        ms=whole_ms, earlier_ms=earlier_ms, library_ms=lib_ms,
        turns_ms=dict(generic_vs_cluster=te, library_vs_cluster=tl),
        pair_products_ms=cuda_ms(
            lambda _: (torch.mm(pair2, w2.T),
                       torch.mm(xx.T, pair2, out_dtype=torch.float32)),
            [None], iters=20),
        bound_ms=bounds["whole_backward"][0],
        bound_by=bounds["whole_backward"][1],
        note="the cluster kernel, then dx = [hi | lo].[W^T; W^T] and dW = "
             "x^T.[hi | lo] (bf16 tensor-core products over the pair, f32 "
             "accumulation), db from the kernel's column sums; earlier: the "
             "generic kernel and the reference's f32 products")
    x64 = pl_inputs(torch, BERT_R, 64, BERT_H, bf, 10)
    a64 = (x64["x"], x64["w"], x64["b"], x64["res"], x64["lnw"])
    _, m64, r64 = mf.fused_proj_ln_fwd(*a64, x64["lnb"], 1e-12, *d)
    out["hin_64"] = dict(
        fwd_ms=cuda_ms(lambda _: mf._proj_ln_fwd_cuda(
            *a64, x64["lnb"], 1e-12, key, route=route), [None], iters=20),
        bwd_ms=cuda_ms(lambda _: mf._proj_ln_bwd_pair_cuda(
            *a64, m64, r64, x64["g"], key), [None], iters=20),
        note="the cluster kernels at Hin = 64 (R, Hout as above): the "
             "product nearly free, the rest of each kernel's time")
    out["timed_at"] = dict(r=BERT_R, hin=BERT_H, hout=BERT_H,
                           dtype="bfloat16",
                           dropout=None if key is None else key.p)
    del x, xx, w, b, res, lnw, lnb, g, y, mean, rstd, prim, yl, pair, pair2
    del w2, x64, a64, m64, r64
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 22: the flash kernels' key-padding (kv_bias) variant
# ---------------------------------------------------------------------------

BERT_B, BERT_S, BERT_NH, BERT_D = 32, 512, 12, 64


def bert_lengths(b, s, seed):
    """Valid keys per row: drawn in [s/4, s] from the seed, the first row
    full and the second at the smallest length."""
    rng = np.random.default_rng(seed)
    n = rng.integers(s // 4, s + 1, b)
    n[0], n[min(1, b - 1)] = s, s // 4
    return n


def kv_bias_for(torch, lengths, s):
    """The model's bias row per batch: 0 on valid keys, -1e30 (the
    canonicalised -1e9 padding) past them."""
    n = torch.as_tensor(lengths, device="cuda")[:, None]
    col = torch.arange(s, device="cuda")[None, :]
    return torch.where(col < n, 0.0, -1e30).float().contiguous()


def flash_bias_bounds(lengths, s, nh, d, esize, drop=False):
    """bound_ms and what bounds it for each kernel, counting the work this
    batch's valid keys need: the products over the (query, valid key)
    pairs (s x length per row and head; fwd 2, dQ 3, dK/dV 4 products of
    2 flops per pair per head-dim element) at 989 TFLOP/s, against the
    bytes moved once at 3.35 TB/s: q (dO, o, dq) whole, k, v and the
    bias over the valid keys only (a wholly masked key tile is skipped,
    its rows never read), lse and delta; dk and dv written whole (the
    masked keys' rows are zeros the kernel must write). Dropout moves no
    byte more; its hash takes HASH_OPS integer operations per pair on the
    CUDA cores (at the f32 rate, beside the tensor cores' products), and
    the bound is the largest of the three times."""
    valid = float(sum(int(n) for n in lengths))
    pairs = valid * s * nh
    prod = 2.0 * pairs * d
    bh = len(lengths) * nh
    mat, row = bh * s * d * esize, bh * s * 4
    kv = 2 * valid * nh * d * esize          # k and v over the valid keys
    bias = valid * 4
    work = {"flash_fwd": (2 * prod, 2 * mat + kv + row + bias),
            "flash_dq": (3 * prod, 3 * mat + kv + 2 * row + bias),
            "flash_dkv": (4 * prod, 4 * mat + kv + 2 * row + bias),
            # the backward's pre-pass: q, k, o, dO whole in, qs, ks, delta
            "flash_bwd_prep": (0.0, 6 * mat + row)}
    out = {}
    for name, (flops, nbytes) in work.items():
        # each kernel draws each pair's mask once (the wgmma dK/dV
        # kernel's first warpgroup hands the bit to the second in P^T's
        # sign); the pre-pass draws none
        hash_ops = HASH_OPS * pairs if drop and flops else 0.0
        t_ops = max(flops / H100_FLOPS["bfloat16"],
                    hash_ops / H100_FLOPS["float32"])
        t_bytes = nbytes / H100_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def phase_flash_bias_vs_plain(torch):
    """The three flash kernels with the key-padding bias against their
    plain versions (out, lse, dq, dk, dv) at bert-base's attention (B=32,
    12 heads, S=512, D=64, valid lengths from the seed) in bf16, at B=4
    in f32, and at a ragged S=200 (B=3) in both, each element within its
    row's scale (flash_reading); then their times at the bf16 shape
    beside the plain versions', the bound and SDPA with the same additive
    mask."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    scale = BERT_D ** -0.5
    worst = {}
    cases = ((torch.float32, 4, BERT_S), (torch.bfloat16, BERT_B, BERT_S),
             (torch.float32, 3, 200), (torch.bfloat16, 3, 200))
    for dtype, b, s in cases:
        name = str(dtype).split(".")[-1]
        lengths = bert_lengths(b, s, seed=b)
        bias = kv_bias_for(torch, lengths, s)
        g = torch.Generator(device="cuda").manual_seed(b)
        q, k, v, do = (torch.randn(b * BERT_NH, s, BERT_D, generator=g,
                                   device="cuda").to(dtype) for _ in range(4))
        out, lse = fa.flash_fwd(q, k, v, False, scale, bias, BERT_NH)
        before = dict(fa.bwd_routes)
        dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, do, False, scale, bias,
                                  BERT_NH)
        broute = fa.bwd_route(dtype, BERT_D, True)
        check({r: fa.bwd_routes[r] - before[r] for r in before}
              == {r: 2 * int(r == broute) for r in before},
              f"flash kv_bias backward {name} s={s} did not take the "
              f"{broute} kernels once each: {before} -> {fa.bwd_routes}")
        again = fa.flash_bwd(q, k, v, out, lse, do, False, scale, bias,
                             BERT_NH)
        check(all(same_bits(x, y) for x, y in zip(again, (dq, dk, dv))),
              f"flash kv_bias backward {name} s={s} differs between two "
              f"calls")
        rout, rlse = fa.flash_fwd_ref(q, k, v, False, scale, bias, BERT_NH)
        rdq, rdk, rdv = fa.flash_bwd_ref(q, k, v, out, lse, do, False, scale,
                                         bias, BERT_NH)
        torch.cuda.synchronize()
        for key, got, ref in (("out", out, rout), ("lse", lse, rlse),
                              ("dq", dq, rdq), ("dk", dk, rdk),
                              ("dv", dv, rdv)):
            check(bool(torch.isfinite(got).all()),
                  f"flash kv_bias {key} not finite ({name})")
            err = float((got.float() - ref.float()).abs().max())
            rel = flash_reading(got, ref)
            check(rel <= FLASH_TOL[name],
                  f"flash kv_bias {key} disagrees with plain: {name} b={b} "
                  f"s={s} max_abs_err={err} relative {rel} > "
                  f"{FLASH_TOL[name]}")
            kern = {"out": "flash_fwd", "lse": "flash_fwd",
                    "dq": "flash_dq"}.get(key, "flash_dkv")
            w = worst.setdefault(name, {}).setdefault(kern, [0.0, 0.0])
            w[0], w[1] = max(w[0], err), max(w[1], rel)
        # masked keys get no gradient
        keep = (bias >= 0).repeat_interleave(BERT_NH, 0)[..., None]
        check(float(dk.float().masked_fill(keep, 0).abs().max()) == 0.0,
              "flash kv_bias: a masked key got a dK")
        del q, k, v, do, out, lse, dq, dk, dv, rout, rlse, rdq, rdk, rdv, again
        torch.cuda.empty_cache()
    return dict(tolerance_relative_to_row_rms_plus_abs=FLASH_TOL,
                worst={n: {k: dict(max_abs_err=e, relative=r)
                           for k, (e, r) in w.items()}
                       for n, w in worst.items()},
                cases=[[str(d).split(".")[-1], b, s] for d, b, s in cases],
                dropout=flash_dropout(torch, fa),
                **flash_bias_times(torch, fa, scale))


def flash_bias_times(torch, fa, scale, key=None):
    """Device times at bert-base's attention (bf16): each kernel in turns
    with its plain version, the forward (the wgmma kernel) beside SDPA
    with the same additive mask, and it, dQ and dK/dV (the wgmma kernels,
    from the pre-pass's qs and ks) in turns with the generic kernels
    (``earlier_ms``); the pre-pass alone; the whole backward beside SDPA's
    and the generic route's; with a dropout ``key``, the dropout variants
    beside SDPA with dropout_p = key.p."""
    lengths = bert_lengths(BERT_B, BERT_S, seed=BERT_B)
    bias = kv_bias_for(torch, lengths, BERT_S)
    bh = BERT_B * BERT_NH
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn(bh, BERT_S, BERT_D, generator=g,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    a = (False, scale, bias, BERT_NH, key)
    out, lse = fa._fwd_cuda(q, k, v, *a)
    qs, ks, delta = fa._bwd_prep_cuda(q, k, out, do, scale)
    bounds = flash_bias_bounds(lengths, BERT_S, BERT_NH, BERT_D, 2,
                               key is not None)
    res = {name: dict(library_ms=None, bound_ms=bounds[name][0],
                      bound_by=bounds[name][1])
           for name in ("flash_fwd", "flash_dq", "flash_dkv")}
    fwd = lambda _: fa._fwd_cuda(q, k, v, *a)   # noqa: E731
    plain_ms, ms, t = in_turns(lambda _: fa.flash_fwd_ref(q, k, v, *a), fwd)
    res["flash_fwd"].update(ms=ms, plain_ms=plain_ms, all_ms=t)
    runs = {
        "flash_dq": (lambda _: fa._dq_cuda(q, k, v, do, lse, delta, *a,
                                           ks=ks),
                     lambda _: fa.flash_dq_ref(q, k, v, do, lse, delta, *a)),
        "flash_dkv": (lambda _: fa._dkv_cuda(q, k, v, do, lse, delta, *a,
                                             qs=qs),
                      lambda _: fa.flash_dkv_ref(q, k, v, do, lse, delta,
                                                 *a)),
    }
    generic = {
        "flash_dq": lambda _: fa._dq_cuda(q, k, v, do, lse, delta, *a,
                                          route="generic"),
        "flash_dkv": lambda _: fa._dkv_cuda(q, k, v, do, lse, delta, *a,
                                            route="generic")}
    bwd_turns(res, runs, generic)
    res["flash_bwd_prep"] = prep_times(fa, q, k, out, do, scale,
                                       bounds["flash_bwd_prep"])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh, doh = (x.view(BERT_B, BERT_NH, BERT_S, BERT_D)
                       for x in (q, k, v, do))
    mask = bias.clamp_min(-1e9).to(torch.bfloat16)[:, None, None, :]
    p = 0.0 if key is None else key.p
    res["flash_fwd"]["library_ms"], _, _ = in_turns(
        lambda _: sdpa(qh, kh, vh, attn_mask=mask, dropout_p=p), fwd)
    earlier_ms, _, t = in_turns(
        lambda _: fa._fwd_cuda(q, k, v, *a, route="generic"), fwd)
    res["flash_fwd"].update(route=fa.fwd_route(q.dtype, BERT_D, True),
                            earlier_ms=earlier_ms, earlier_all_ms=t)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qh, kh, vh))
    og = sdpa(qg, kg, vg, attn_mask=mask, dropout_p=p)
    whole = lambda _: fa._bwd_cuda(q, k, v, out, lse, do, *a)  # noqa: E731
    sdpa_bwd_ms, bwd_ms, t = in_turns(
        lambda _: torch.autograd.grad(og, (qg, kg, vg), doh,
                                      retain_graph=True), whole)
    earlier_ms, _, et = in_turns(
        lambda _: fa._bwd_cuda(q, k, v, out, lse, do, *a, route="generic"),
        whole)
    res["backward"] = dict(ms=bwd_ms, sdpa_bwd_ms=sdpa_bwd_ms, all_ms=t,
                           earlier_ms=earlier_ms, earlier_all_ms=et,
                           bound_ms=bounds["flash_dq"][0]
                           + bounds["flash_dkv"][0])
    res["timed_at"] = dict(b=BERT_B, nh=BERT_NH, s=BERT_S, d=BERT_D,
                           dtype="bfloat16", causal=False, dropout=p,
                           valid_keys=int(sum(int(n) for n in lengths)),
                           lengths_min_mean_max=[
                               int(min(lengths)),
                               float(np.mean(lengths)), int(max(lengths))])
    del q, k, v, do, out, lse, delta, qs, ks, qg, kg, vg, og, bias, mask
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 23-26: BERT-base pretraining through the Layer model and AdamW
# ---------------------------------------------------------------------------

BERT_LR = 1e-4


def bert_launches(cfg, fused, wgmma=True):
    """Kernel launches per step: LayerNorm at the embeddings, the L FFN
    closes and the MLM transform; projection-LN at the L attention closes;
    each flash and fused MLP kernel once per layer (L = 12: 14, 12, 12),
    the flash backward's pre-pass too on its wgmma route (bf16; ``wgmma``
    False: an f32 model's generic route, no pre-pass).
    At a rate above 0 the sites it drops launch the dropout variants
    (read_launches' ``dropout_<name>``): the flash kernels with the
    attention rate, the FFN closes' LayerNorm and the projection-LN with
    the hidden rate; the embeddings' and the MLM transform's LayerNorm
    stay dropout-free. With the fused flags off only the flash kernels
    run."""
    L = cfg.num_hidden_layers
    attn = "dropout_" if cfg.attention_probs_dropout_prob > 0 else ""
    want = {attn + k: L for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    if wgmma:
        want["flash_bwd_prep"] = L     # the wgmma backward's pre-pass, any rate
    if fused:
        hid = "dropout_" if cfg.hidden_dropout_prob > 0 else ""
        want.update({k: L for k in ("fused_mlp_fwd", "fused_mlp_dx",
                                    "fused_mlp_dw")})
        want.update({hid + k: L for k in ("fused_proj_ln_fwd",
                                          "fused_proj_ln_bwd")})
        for k in ("fused_ln_fwd", "fused_ln_bwd"):
            want[k] = 2
            want[hid + k] = want.get(hid + k, 0) + L
    return want


def bert_batch(torch, cfg, b, s, seed):
    """ids, MLM labels (15% of the valid positions; -100 elsewhere), NSP
    labels and the 1/0 attention mask, valid lengths from bert_lengths."""
    rng = np.random.default_rng(seed)
    lengths = bert_lengths(b, s, seed)
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int64)
    mlm = np.where((rng.random((b, s)) < 0.15) & (mask == 1), ids, -100)
    nsp = rng.integers(0, 2, (b,))
    return tuple(torch.from_numpy(a.astype(np.int64)).cuda()
                 for a in (ids, mlm, nsp, mask)), lengths


def bert_flops_per_step(cfg, b, s, lengths):
    """6 flops per token per matmul weight (forward + backward) over all
    B*S positions (the MLM head's tied decoder included: the chunked head
    scores every position), plus the attention's two products over the
    (query, valid key) pairs, times 3 for forward + backward."""
    H, L, FF = cfg.hidden_size, cfg.num_hidden_layers, cfg.intermediate_size
    weights = L * (4 * H * H + 2 * H * FF) + H * H + cfg.vocab_size * H
    pairs = float(sum(int(n) for n in lengths)) * s
    attn = 3 * 2 * 2 * pairs * H * L
    return 6.0 * weights * b * s + attn


def bert_trainer(torch, cfg, seed=0):
    """The user's loop: BertForPretraining (bf16 on the card), AdamW (lr
    1e-4, weight decay 0.01) over its parameters, one fixed batch.
    Returns (model, step, lengths); step() -> (loss, the CUDA events
    recorded around the AdamW update); step(check_update=True) also holds
    the update against AdamW's rule (adamw_first_step_reading; the first
    step only: it takes the moments as zero)."""
    from paddle_tpu_torch import seed as framework_seed
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.optimizer import AdamW
    framework_seed(seed)        # the dropout masks' generator
    model = bert.BertForPretraining(cfg, seed=seed)
    opt = AdamW(learning_rate=BERT_LR, weight_decay=0.01,
                parameters=model.parameters())
    (ids, mlm, nsp, mask), lengths = bert_batch(torch, cfg, BERT_B, BERT_S,
                                                seed)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def step(check_update=False):
        loss = model.loss(ids, mlm, nsp, attention_mask=mask)
        loss.backward()
        params = list(model.parameters())
        before = [p.detach().clone() for p in params] if check_update else None
        ev[0].record()
        with torch.profiler.record_function("adamw_step"):
            opt.step()
        ev[1].record()
        reading = (adamw_first_step_reading(torch, params, before)
                   if check_update else None)
        opt.clear_grad()
        return loss.detach(), ev, reading

    return model, step, lengths


def adamw_first_step_reading(torch, params, before):
    """Each parameter after the first AdamW step against the rule written
    here: from zero moments the bias-corrected update is g / (|g| + eps),
    so p1 = round(p0 (1 - lr wd) - lr g / (|g| + eps)), in f32 from the
    bf16 p0 and g, rounded to bf16 once. The optimizer keeps its moments
    in bf16 (their rounding moves the update by up to ~2^-8 of lr) and
    rounds the parameter twice, so an element may differ from the rule by
    one bf16 unit of itself plus 2^-7 lr: none may differ by more, and at
    most 2% may differ at all. A step that does nothing, or moves the
    wrong way or by the wrong amount, differs by ~lr on the elements the
    rule moves: their share is reported, and must be at least 5%."""
    lr, wd, eps = BERT_LR, 0.01, 1e-8
    n = off = far = moves = 0
    for p, p0 in zip(params, before):
        g = p.grad.float()
        want = (p0.float() * (1.0 - lr * wd)
                - lr * g / (g.abs() + eps)).to(p.dtype)
        got = p.detach()
        diff = (got.float() - want.float()).abs()
        limit = (2.0 ** -7 * torch.maximum(got.float().abs(),
                                           want.float().abs())
                 + 2.0 ** -7 * lr)
        n += p.numel()
        off += int((got != want).sum())
        far += int((diff > limit).sum())
        moves += int((want != p0).sum())
    out = dict(elements=n, share_differing=off / n, elements_beyond_limit=far,
               share_the_rule_moves=moves / n)
    check(far == 0 and off <= 0.02 * n and moves >= 0.05 * n,
          f"the first AdamW step does not follow AdamW's rule: {out}")
    return out


def phase_train_bert(torch, cfg, fused, steps=TRAIN_STEPS):
    """Train cfg at B=32, S=512 on one fixed padded batch: one warm-up
    step, then `steps` steps, with FLAGS_fused_norm and FLAGS_fused_mlp as
    `fused` says, at cfg's dropout rates. Exactly bert_launches(cfg,
    fused) per step (dense: the flash kernels only; the key-padding
    variant stays on both routes)."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.nn.functional import (last_attn_path,
                                                last_mlp_path,
                                                last_norm_path)
    set_flags({"FLAGS_fused_norm": fused, "FLAGS_fused_mlp": fused})
    model, step, lengths = bert_trainer(torch, cfg)
    loss0, _, first_update = step(check_update=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, adamw_ms = [], []
    with ClockSampler() as clocks:
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, ev, _ = step()
            losses.append(loss)
            ev[1].synchronize()
            adamw_ms.append(ev[0].elapsed_time(ev[1]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_launches()
    paths = dict(norm=last_norm_path(), mlp=last_mlp_path(),
                 attn=last_attn_path())
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"bert loss not finite: {losses}")
    # the loss starts near 116 (the reference's normal(0, 1) word
    # embeddings are the decoder's weight too, so the logits are large)
    # and Adam at lr 1e-4 moves it up and down on the fixed batch: it must
    # fall on average below the warm-up step's; the warm-up step's update
    # itself was held to AdamW's rule (first_update)
    check(np.mean(losses) < float(loss0), f"bert loss did not fall below the "
          f"warm-up step's {float(loss0)} on average: {losses}")
    want_paths = (dict(norm="fused_ln/cuda", mlp="fused_mlp/cuda",
                       attn="flash_masked/cuda") if fused else
                  dict(norm="dense", mlp="dense", attn="flash_masked/cuda"))
    check(paths == want_paths, f"bert took the paths {paths} with the fused "
          f"flags {fused}")
    want = bert_launches(cfg, fused)
    for key, n in counts.items():
        per_step = want.get(key, 0)
        check(n == per_step * steps, f"{key} launched {n} times in {steps} "
              f"bert steps (want {per_step * steps}; fused flags {fused}, "
              f"dropout {cfg.hidden_dropout_prob}, "
              f"{cfg.attention_probs_dropout_prob})")
    routes = fwd_routes_reading(counts, "bert-base training")
    broutes = bwd_routes_reading(counts, "bert-base training")
    mroutes = mlp_bwd_routes_reading(counts, "bert-base training", fused)
    froutes = mlp_fwd_routes_reading(counts, "bert-base training", fused)
    lroutes = ln_bwd_routes_reading(counts, "bert-base training", fused)
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    if fused:
        proj_ln_routes = pl_routes_reading(counts, "bert-base training")
    else:
        proj_ln_routes = dict(mf.pl_routes)
        check(not any(proj_ln_routes.values()), f"bert-base with the fused "
              f"flags off called the projection-LN kernels: {proj_ln_routes}")
    tokens = BERT_B * BERT_S
    flops = bert_flops_per_step(cfg, BERT_B, BERT_S, lengths)
    ms = wall / steps * 1e3
    out = dict(config="bert-base",
               dropout=dict(hidden=cfg.hidden_dropout_prob,
                            attention=cfg.attention_probs_dropout_prob),
               layers=cfg.num_hidden_layers,
               b=BERT_B, s=BERT_S, dtype="bfloat16", fused=fused,
               paths=paths, lr=BERT_LR, weight_decay=0.01,
               valid_tokens=int(sum(int(n) for n in lengths)),
               warmup_loss=float(loss0), losses=losses,
               first_update=first_update, ms_per_step=ms,
               tokens_per_s=tokens / (ms / 1e3),
               tokens_counted="all B*S positions, padding included",
               model_tflop_per_step=flops / 1e12,
               model_tflops=flops / (ms / 1e3) / 1e12,
               model_flops_share_of_989=flops / (ms / 1e3) / 989e12,
               adamw_ms_per_step=sum(adamw_ms) / steps,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               parameters=sum(p.numel() for p in model.parameters()),
               card_during_steps=clocks.summary(), launches=counts,
               launches_per_step={k: n / steps for k, n in counts.items()},
               flash_fwd_routes=routes, flash_bwd_routes=broutes,
               proj_ln_routes=proj_ln_routes, fused_mlp_fwd_routes=froutes,
               fused_mlp_bwd_routes=mroutes, ln_bwd_routes=lroutes)
    return out, model, step


def phase_profile_bert(torch, step, steps=2):
    """torch.profiler over `steps` BERT steps: device busy time per step
    against the profiled wall time, the shares of the LayerNorm,
    projection-LN, flash and fused MLP kernels, the AdamW span, and the
    kernels that take the time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = read_launches()
    mroutes = mlp_bwd_routes_reading(counts, "bert-base profile")
    froutes = mlp_fwd_routes_reading(counts, "bert-base profile")
    lroutes = ln_bwd_routes_reading(counts, "bert-base profile")
    spans, dev = {}, []
    events = prof.key_averages()
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.key == "adamw_step":
                spans[e.key] = e.self_device_time_total / 1e3 / steps
            else:
                dev.append(e)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if busy_ms == 0.0:
        return dict(steps=steps, device_time="not measured (no CUDA events)")
    # "::ln_" and not "ln_": the projection-LN kernels' names contain
    # "ln_fwd_" too; the LayerNorm, projection-LN and fused MLP backwards
    # all end in common.cuh's sum_parts_kernel, counted on its own
    groups = {"layer_norm (ln_fwd, ln_bwd, ln_bwd_persist)": ("::ln_fwd_",
                                                               "::ln_bwd_"),
              "proj_ln (proj_ln_fwd, proj_ln_bwd, their cluster route)":
              ("proj_ln_fwd_kernel", "proj_ln_bwd_kernel",
               "proj_ln_fwd_cluster_kernel", "proj_ln_bwd_cluster_kernel"),
              "flash (fwd, dq, dkv)": ("flash_fwd_wgmma_kernel",
                                       "flash_fwd_kernel",
                                       "flash_bwd_prep_kernel",
                                       "flash_dq_wgmma_kernel",
                                       "flash_dkv_wgmma_kernel",
                                       "flash_dq_kernel",
                                       "flash_dkv_kernel"),
              "fused_mlp (gelu_dact_wgmma, the GEMM core, mlp_gemm, colsum)":
              ("gelu_dact_wgmma_kernel", "wgmma_gemm_kernel",
               "mlp_gemm_kernel", "colsum_kernel"),
              "column sums (sum_parts_kernel: LN, proj-LN, MLP backwards)":
              ("sum_parts_kernel",)}
    by_group = {g: sum(e.self_device_time_total for e in dev
                       if any(k in e.key for k in keys)) / 1e3 / steps
                for g, keys in groups.items()}
    # the fused MLP's own kernels (sum_parts_kernel, shared with the
    # norms' backwards, left out) by direction
    mlp = kernel_ms(dev, [k for k in MLP_KERNEL_NAMES
                          if k != "sum_parts_kernel"], steps)
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    flaunch = fwd_core_launches(
        dev, steps, (counts["fused_mlp_fwd"] + counts["dropout_fused_mlp_fwd"])
        // steps, mf.mlp_fwd_plan(BERT_R, BERT_H, BERT_F, min(
            BERT_F, mf._MLP_FWD_CHUNK_F)), "bert-base profile")
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)
    return dict(steps=steps, wall_ms_per_step=wall_ms / steps,
                device_busy_ms_per_step=busy_ms / steps,
                device_idle_share=1.0 - busy_ms / wall_ms,
                fused_mlp_fwd_routes=froutes, fused_mlp_bwd_routes=mroutes,
                ln_bwd_routes=lroutes, fused_mlp_fwd_launches=flaunch,
                fused_mlp_ms_per_step_by_direction=mlp_by_direction(mlp),
                kernels_ms_per_step=by_group,
                kernels_share_of_busy={g: t * steps / busy_ms
                                       for g, t in by_group.items()},
                adamw_span_ms_per_step=spans.get(
                    "adamw_step", "not measured (no adamw_step range)"),
                top_device_ms_per_step=[
                    (e.key[:70], e.self_device_time_total / 1e3 / steps,
                     e.count // steps) for e in top[:16]])


def phase_bert_parity_fp32(torch):
    """fp32 at bert-base width, 2 layers, B=4, S=512 with padding: the loss
    and every gradient with the fused flags on (the LayerNorm,
    projection-LN and fused MLP kernels) against them off (the dense
    norms, projection and MLP); the flash kernels' key-padding variant on
    both."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.models import bert
    cfg = bert.CONFIGS["bert-base"]._replace(
        num_hidden_layers=2, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    model = bert.BertForPretraining(cfg, dtype=torch.float32, seed=1)
    (ids, mlm, nsp, mask), _ = bert_batch(torch, cfg, 4, BERT_S, 1)
    params = list(model.parameters())

    def grads(fused):
        set_flags({"FLAGS_fused_norm": fused, "FLAGS_fused_mlp": fused})
        reset_launches()
        loss = model.loss(ids, mlm, nsp, attention_mask=mask)
        g = torch.autograd.grad(loss, params)
        return loss.item(), g, read_launches()

    try:
        lf, gf, counts = grads(True)
        ld, gd, counts_d = grads(False)
    finally:
        set_flags({"FLAGS_fused_norm": True, "FLAGS_fused_mlp": True})
    check(counts["fused_ln_fwd"] == 4 and counts["fused_proj_ln_bwd"] == 2
          and counts["fused_mlp_dw"] == 2 and counts["flash_dkv"] == 2,
          f"bert fp32 parity run with the fused flags on launched {counts}")
    check(counts_d["fused_ln_fwd"] == counts_d["fused_proj_ln_fwd"] == 0
          and counts_d["flash_fwd"] == 2,
          f"bert fp32 parity run with the fused flags off launched "
          f"{counts_d}")
    torch.cuda.synchronize()
    tol = 1e-4      # per leaf, relative to the leaf's largest gradient
    worst = 0.0
    for a, b in zip(gf, gd):
        check(bool(torch.isfinite(a).all()), "parity gradient not finite")
        worst = max(worst, float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-30))
    check(abs(lf - ld) <= 1e-5 * abs(ld), f"bert fp32 loss: fused {lf} vs "
          f"dense {ld}")
    check(worst <= tol, f"bert fp32 gradients: fused vs dense relative "
          f"{worst} > {tol}")
    leaves = len(gd)
    del model, params, gf, gd
    return dict(loss_fused=lf, loss_dense=ld,
                worst_grad_relative_fused_vs_dense=worst, tolerance=tol,
                leaves=leaves)


# ---------------------------------------------------------------------------
# the dropout variants of kernels 1-3, 10, 11, 13, 14 (in phases 20-22),
# the device hash against its plain version (phase 32) and bert-base
# pretraining at its default dropout (phases 33-36)
# ---------------------------------------------------------------------------

DROP_P = 0.1                          # bert-base's two rates
DROP_SEED = (0x9E3779B9, 0x80000001)  # one generator key; words above 2^31
DROP_NAMES = {"flash_fwd": "flash_fwd_dropout", "flash_dq": "flash_dq_dropout",
              "flash_dkv": "flash_dkv_dropout",
              "fused_mlp_fwd": "fused_mlp_fwd_dropout",
              "fused_mlp_dx": "fused_mlp_dx_dropout",
              "fused_mlp_dw": "fused_mlp_dw_dropout",
              "fused_ln_fwd": "fused_ln_fwd_dropout",
              "fused_ln_bwd": "fused_ln_bwd_dropout",
              "fused_proj_ln_fwd": "fused_proj_ln_fwd_dropout",
              "fused_proj_ln_bwd": "fused_proj_ln_bwd_dropout"}


def drop_key(fa, rows, cols, seed=DROP_SEED):
    return fa.DropKey(DROP_P, seed[0], seed[1], rows, cols)


def mask_mismatches(grad, keep):
    """Elements whose zero or nonzero disagrees with the mask: a dropped
    gradient (LayerNorm's dh, projection-LN's dp) is 0 exactly where the
    mask drops (a kept value of exactly 0 does not occur on random
    data)."""
    return int(((grad == 0) != ~keep).sum())


# (r, h, residual, lin_b): bert-base's FFN close (residual, no bias), with
# a bias, a ragged R with H = 1024 (bias, no residual), and H = 100, whose
# bf16 rows are no whole 16-byte vectors (the generic kernels)
LN_DROP_CASES = [(BERT_R, BERT_H, True, False), (BERT_R, BERT_H, True, True),
                 (BERT_R - 1, 1024, False, True), (77, 100, True, True)]


def ln_dropout(torch, nf, fa):
    """The LayerNorm ops' dropout variants against their plain versions,
    f32 and bf16, keyed by the reference's row tile (``ln_block_r``): y,
    mean, rstd, dh, dres, dlin_b, dw, db within LN_TOL; dh's zeros are
    the plain mask's, exactly; two backward calls give the same bits.
    The check shown to reject the mask keyed by a CUDA block's 32 rows.
    Then the times of bert-base's FFN close with dropout."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for r, h, has_res, has_lb in LN_DROP_CASES:
            x = ln_inputs(torch, r, h, dtype, r + h + 1, has_res, has_lb)
            key = drop_key(fa, nf.ln_block_r(r, h, dtype), h)
            d = (key.p, key.s0, key.s1, key.rows)
            args = (x["h"], x["res"], x["lin_b"], x["w"], x["b"])
            y, mean, rstd = nf.fused_ln_fwd(*args, 1e-12, *d)
            grads = nf.fused_ln_bwd(*args, mean, rstd, x["g"], *d)
            again = nf.fused_ln_bwd(*args, mean, rstd, x["g"], *d)
            dh, dres, dlb, dw, db = grads
            ry, rmean, rrstd = nf.fused_ln_fwd_ref(*args, 1e-12, key)
            dz, rdw, rdb, rdlb = nf.fused_ln_bwd_ref(*args[:4], mean, rstd,
                                                     x["g"], key)
            keep = nf.row_keep_ref(key, x["h"])
            torch.cuda.synchronize()
            what = f"{name} r={r} h={h} res={has_res} lin_b={has_lb}"
            check(all(same_bits(a, b) for a, b in zip(again, grads)),
                  f"fused LN dropout backward differs between two calls "
                  f"({what})")
            off = mask_mismatches(dh, keep)
            check(off == 0, f"fused LN dropout: dh's zeros differ from the "
                  f"plain mask at {off} elements ({what})")
            outs = [("y", y, ry), ("mean", mean, rmean),
                    ("rstd", rstd, rrstd), ("dh", dh, nf._dropped(dz, key)),
                    ("dw", dw, rdw), ("db", db, rdb)]
            if has_res:
                outs.append(("dres", dres, dz))
            if has_lb:
                outs.append(("dbias", dlb, rdlb))
            for label, got, ref in outs:
                check(bool(torch.isfinite(got).all()),
                      f"fused LN dropout {label} not finite ({what})")
                err, rel = rel_err(got, ref)
                check(rel <= LN_TOL[name],
                      f"fused LN dropout {label} disagrees with plain: "
                      f"{what} max_abs_err={err} relative {rel} > "
                      f"{LN_TOL[name]}")
                kern = ("fused_ln_fwd" if label in ("y", "mean", "rstd")
                        else "fused_ln_bwd")
                w = worst.setdefault(name, {}).setdefault(kern, [0., 0.])
                w[0], w[1] = max(w[0], err), max(w[1], rel)
            del x, args, y, mean, rstd, grads, again, dh, dres, dlb, dw, db
            del ry, rmean, rrstd, dz, rdw, rdb, rdlb, keep
    # the planted fault: the kernels keyed by a CUDA block's rows
    x = ln_inputs(torch, BERT_R, BERT_H, torch.bfloat16, 37, True)
    args = (x["h"], x["res"], None, x["w"], x["b"])
    key = drop_key(fa, nf.ln_block_r(BERT_R, BERT_H, torch.bfloat16), BERT_H)
    ry, mean, rstd = nf.fused_ln_fwd_ref(*args, 1e-12, key)
    wrong = (key.p, key.s0, key.s1, 32)
    y_w, _, _ = nf.fused_ln_fwd(*args, 1e-12, *wrong)
    dh_w = nf.fused_ln_bwd(*args, mean, rstd, x["g"], *wrong)[0]
    fault = dict(cuda_tile_rows=32, reference_tile_rows=key.rows,
                 y_relative=rel_err(y_w, ry)[1],
                 dh_mask_mismatches=mask_mismatches(
                     dh_w, nf.row_keep_ref(key, x["h"])))
    check(fault["y_relative"] > LN_TOL["bfloat16"]
          and fault["dh_mask_mismatches"] > 0,
          f"the LN dropout checks pass the mask keyed by the CUDA tile: "
          f"{fault}")
    del x, args, ry, mean, rstd, y_w, dh_w
    torch.cuda.empty_cache()
    return dict(worst={n: {k: dict(max_abs_err=e, relative=r)
                           for k, (e, r) in w.items()}
                       for n, w in worst.items()},
                cases=[list(c) for c in LN_DROP_CASES],
                key_tile_rows_bf16=key.rows, planted_fault=fault,
                times=ln_times(torch, nf, True, key))


PL_DROP_CASES = [(BERT_R, BERT_H, BERT_H), (1000, 512, 768)]


def pl_dropout(torch, mf, nf, fa):
    """The projection-LN ops' dropout variants against their plain
    versions, f32 and bf16, keyed by ``mlp_blocks``'s row tile: y, mean,
    rstd, dz, dp, dgamma, dbeta within LN_TOL; dp's zeros are the plain
    mask's, exactly; two backward calls give the same bits. The check
    shown to reject the mask keyed by the kernel's 32-row block. Then
    the times at bert-base's shape with dropout."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for r, hin, hout in PL_DROP_CASES:
            x = pl_inputs(torch, r, hin, hout, dtype, r + hin + hout + 1)
            key = drop_key(fa, mf.mlp_blocks(r, hout, hin, dtype=dtype)[0],
                           hout)
            d = (key.p, key.s0, key.s1, key.rows)
            args = (x["x"], x["w"], x["b"], x["res"], x["lnw"])
            y, mean, rstd = mf.fused_proj_ln_fwd(*args, x["lnb"], 1e-12, *d)
            grads = mf.fused_proj_ln_bwd(*args, mean, rstd, x["g"], *d)
            again = mf.fused_proj_ln_bwd(*args, mean, rstd, x["g"], *d)
            ry, rmean, rrstd = mf.fused_proj_ln_fwd_ref(*args, x["lnb"],
                                                        1e-12, key)
            refs = mf.fused_proj_ln_bwd_ref(*args, mean, rstd, x["g"], key)
            keep = nf.row_keep_ref(key, x["res"])
            torch.cuda.synchronize()
            what = f"{name} r={r} hin={hin} hout={hout}"
            check(all(same_bits(a, b) for a, b in zip(again, grads)),
                  f"proj-LN dropout backward differs between two calls "
                  f"({what})")
            off = mask_mismatches(grads[1], keep)
            check(off == 0, f"proj-LN dropout: dp's zeros differ from the "
                  f"plain mask at {off} elements ({what})")
            for label, got, ref in zip(
                    ("y", "mean", "rstd", "dz", "dp", "dgamma", "dbeta"),
                    (y, mean, rstd, *grads), (ry, rmean, rrstd, *refs)):
                check(bool(torch.isfinite(got).all()),
                      f"proj-LN dropout {label} not finite ({what})")
                err, rel = rel_err(got, ref)
                check(rel <= LN_TOL[name],
                      f"proj-LN dropout {label} disagrees with plain: "
                      f"{what} max_abs_err={err} relative {rel} > "
                      f"{LN_TOL[name]}")
                kern = ("fused_proj_ln_fwd" if label in ("y", "mean", "rstd")
                        else "fused_proj_ln_bwd")
                w = worst.setdefault(name, {}).setdefault(kern, [0., 0.])
                w[0], w[1] = max(w[0], err), max(w[1], rel)
            del x, args, y, mean, rstd, grads, again, ry, rmean, rrstd, refs
            del keep
    x = pl_inputs(torch, BERT_R, BERT_H, BERT_H, torch.bfloat16, 41)
    args = (x["x"], x["w"], x["b"], x["res"], x["lnw"])
    key = drop_key(fa, mf.mlp_blocks(BERT_R, BERT_H, BERT_H,
                                     dtype=torch.bfloat16)[0], BERT_H)
    ry, mean, rstd = mf.fused_proj_ln_fwd_ref(*args, x["lnb"], 1e-12, key)
    wrong = (key.p, key.s0, key.s1, mf._pl_lib().proj_ln_rows_per_block())
    y_w, _, _ = mf.fused_proj_ln_fwd(*args, x["lnb"], 1e-12, *wrong)
    dp_w = mf.fused_proj_ln_bwd(*args, mean, rstd, x["g"], *wrong)[1]
    fault = dict(cuda_tile_rows=wrong[3], reference_tile_rows=key.rows,
                 y_relative=rel_err(y_w, ry)[1],
                 dp_mask_mismatches=mask_mismatches(
                     dp_w, nf.row_keep_ref(key, x["res"])))
    check(fault["y_relative"] > LN_TOL["bfloat16"]
          and fault["dp_mask_mismatches"] > 0,
          f"the proj-LN dropout checks pass the mask keyed by the CUDA "
          f"tile: {fault}")
    del x, args, ry, mean, rstd, y_w, dp_w
    torch.cuda.empty_cache()
    return dict(worst={n: {k: dict(max_abs_err=e, relative=r)
                           for k, (e, r) in w.items()}
                       for n, w in worst.items()},
                cases=[list(c) for c in PL_DROP_CASES],
                key_tile_rows_bf16=key.rows, planted_fault=fault,
                **pl_times(torch, mf, key))


def flash_dropout(torch, fa):
    """The flash kernels' dropout variants with the key-padding bias
    against their plain versions: bert-base's attention in bf16 (keyed by
    the table's (128, 128)) and at B=4 in f32 (the heuristic's (256,
    512)), a ragged S=200 in both, and in bf16 S=1024 (the tile (256,
    512): the wgmma forward's shift path on a tile larger than its own)
    and S=100 (the tile (104, 104): its division path), each element
    within FLASH_TOL of its row's scale; two backward calls give the same
    bits; the masks are the device hash's, held bit for bit in phase 32.
    The check shown to reject the mask keyed by the generic kernels'
    64-row tile (S=512) and by the wgmma forward's own (128, 128) tile
    where the reference's differs (S=1024). Then their times beside SDPA
    with the same mask and dropout_p = 0.1."""
    scale = BERT_D ** -0.5
    worst = {}
    cases = ((torch.float32, 4, BERT_S), (torch.bfloat16, BERT_B, BERT_S),
             (torch.float32, 3, 200), (torch.bfloat16, 3, 200),
             (torch.bfloat16, 4, 1024), (torch.bfloat16, 3, 100))
    tiles = {}
    for dtype, b, s in cases:
        name = str(dtype).split(".")[-1]
        lengths = bert_lengths(b, s, seed=b + 1)
        bias = kv_bias_for(torch, lengths, s)
        tile = fa.flash_drop_tile(s, s, False, dtype)
        tiles[f"{name} s={s}"] = list(tile)
        key = drop_key(fa, *tile)
        g = torch.Generator(device="cuda").manual_seed(b + 1)
        q, k, v, do = (torch.randn(b * BERT_NH, s, BERT_D, generator=g,
                                   device="cuda").to(dtype) for _ in range(4))
        a = (False, scale, bias, BERT_NH, key)
        out, lse = fa._fwd_cuda(q, k, v, *a)
        before = dict(fa.bwd_routes)
        grads = fa._bwd_cuda(q, k, v, out, lse, do, *a)
        broute = fa.bwd_route(dtype, BERT_D, True)
        check({r: fa.bwd_routes[r] - before[r] for r in before}
              == {r: 2 * int(r == broute) for r in before},
              f"flash dropout backward {name} s={s} did not take the "
              f"{broute} kernels once each: {before} -> {fa.bwd_routes}")
        again = fa._bwd_cuda(q, k, v, out, lse, do, *a)
        rout, rlse = fa.flash_fwd_ref(q, k, v, *a)
        rgrads = fa.flash_bwd_ref(q, k, v, out, lse, do, *a)
        torch.cuda.synchronize()
        what = f"{name} b={b} s={s} tile={tile}"
        check(all(same_bits(x, y) for x, y in zip(again, grads)),
              f"flash dropout backward differs between two calls ({what})")
        for label, got, ref in zip(("out", "lse", "dq", "dk", "dv"),
                                   (out, lse, *grads), (rout, rlse, *rgrads)):
            check(bool(torch.isfinite(got).all()),
                  f"flash dropout {label} not finite ({what})")
            err = float((got.float() - ref.float()).abs().max())
            rel = flash_reading(got, ref)
            check(rel <= FLASH_TOL[name],
                  f"flash dropout {label} disagrees with plain: {what} "
                  f"max_abs_err={err} relative {rel} > {FLASH_TOL[name]}")
            kern = {"out": "flash_fwd", "lse": "flash_fwd",
                    "dq": "flash_dq"}.get(label, "flash_dkv")
            w = worst.setdefault(name, {}).setdefault(kern, [0.0, 0.0])
            w[0], w[1] = max(w[0], err), max(w[1], rel)
        del q, k, v, do, out, lse, grads, again, rout, rlse, rgrads
        torch.cuda.empty_cache()
    # the planted faults: the wgmma forward keyed by the generic kernels'
    # 64-row tile at bert-base's shape, and by its own (128, 128) tile at
    # S=1024, whose reference tile is (256, 512) (at S=512 and 200 the
    # reference's bf16 tile is (128, 128) itself)
    faults = {}
    for b, s, tile in ((BERT_B, BERT_S, 64), (4, 1024, fa.WGMMA_BQ)):
        bias = kv_bias_for(torch, bert_lengths(b, s, seed=b + 1), s)
        g = torch.Generator(device="cuda").manual_seed(43)
        q, k, v = (torch.randn(b * BERT_NH, s, BERT_D, generator=g,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        key = drop_key(fa, *fa.flash_drop_tile(s, s, False, torch.bfloat16))
        check((key.rows, key.cols) != (tile, tile),
              f"S={s}: the reference's tile is the planted one, {tile}")
        ref, _ = fa.flash_fwd_ref(q, k, v, False, scale, bias, BERT_NH, key)
        wrong, _ = fa._fwd_cuda(q, k, v, False, scale, bias, BERT_NH,
                                drop_key(fa, tile, tile))
        fault = dict(cuda_tile=[tile, tile],
                     reference_tile=[key.rows, key.cols],
                     reading=flash_reading(wrong, ref))
        check(fault["reading"] > FLASH_TOL["bfloat16"],
              f"the flash dropout check passes the mask keyed by a CUDA "
              f"tile: {fault}")
        faults[f"s={s}"] = fault
        del q, k, v, ref, wrong
        torch.cuda.empty_cache()
    faults["backward"] = flash_dropout_bwd_rejects(torch, fa, scale)
    return dict(worst={n: {k: dict(max_abs_err=e, relative=r)
                           for k, (e, r) in w.items()}
                       for n, w in worst.items()},
                cases=[[str(d).split(".")[-1], b, s] for d, b, s in cases],
                key_tiles=tiles, planted_faults=faults,
                **flash_bias_times(torch, fa, scale, drop_key(
                    fa, *fa.flash_drop_tile(BERT_S, BERT_S, False,
                                            torch.bfloat16))))


def flash_dropout_bwd_rejects(torch, fa, scale):
    """The bf16 check must reject the wgmma backward with its mask keyed
    by the dK/dV kernel's own (64, 64) tile at bert-base's shape, where
    the reference's is (128, 128): dq, dk and dv each read over
    FLASH_TOL against the plain versions under the right key."""
    b, s = BERT_B, BERT_S
    bias = kv_bias_for(torch, bert_lengths(b, s, seed=b + 1), s)
    g = torch.Generator(device="cuda").manual_seed(44)
    q, k, v, do = (torch.randn(b * BERT_NH, s, BERT_D, generator=g,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    key = drop_key(fa, *fa.flash_drop_tile(s, s, False, torch.bfloat16))
    tile = (fa.DKV_BQ, fa.DKV_BKV)
    check((key.rows, key.cols) != tile,
          f"S={s}: the reference's tile is the planted one, {tile}")
    a = (False, scale, bias, BERT_NH)
    out, lse = fa._fwd_cuda(q, k, v, *a, key)
    ref = fa.flash_bwd_ref(q, k, v, out, lse, do, *a, key)
    wrong = fa._bwd_cuda(q, k, v, out, lse, do, *a, drop_key(fa, *tile))
    fault = dict(cuda_tile=list(tile), reference_tile=[key.rows, key.cols],
                 readings={n: flash_reading(w, r) for n, w, r in
                           zip(("dq", "dk", "dv"), wrong, ref)})
    check(min(fault["readings"].values()) > FLASH_TOL["bfloat16"],
          f"the flash dropout check passes a backward whose mask is keyed "
          f"by a CUDA tile: {fault}")
    del q, k, v, do, out, lse, ref, wrong, bias
    torch.cuda.empty_cache()
    return fault


def phase_dropout_bits(torch):
    """The device hash (common.cuh's keep-mask, compiled into every
    library; read through its debug entry ``dropout_bits``) against the
    plain version, bit for bit, in each of the four libraries whose
    kernels draw masks, at the keys of bert-base's path: the flash
    score matrices [B·NH, S, S] at the bf16 tile (128, 128) and the f32
    tile (256, 512) (common.cuh's FlashKey, the wgmma forward's reckoning:
    shifts), and at S=100's (104, 104) (its division path), and the
    [B·S, H] rows at the LayerNorm's, the
    projection-LN's and the fused MLP's bf16 row tiles; and the fused
    MLP's rows at a tuning-table hit (R=4096, H=2048: block_r 32). The
    kept share lies within 4 sigma of 0.9 in each."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    from paddle_tpu_torch.kernels import norm_fusion as nf
    bh, bf = BERT_B * BERT_NH, torch.bfloat16
    cases = {
        "flash bf16": (drop_key(fa, *fa.flash_drop_tile(
            BERT_S, BERT_S, False, bf)), (bh, BERT_S, BERT_S), False),
        "flash f32": (drop_key(fa, *fa.flash_drop_tile(
            BERT_S, BERT_S, False, torch.float32)), (bh, BERT_S, BERT_S),
            False),
        "flash bf16 s=100": (drop_key(fa, *fa.flash_drop_tile(
            100, 100, False, bf)), (3 * BERT_NH, 100, 100), False),
        "layer_norm bf16": (drop_key(fa, nf.ln_block_r(BERT_R, BERT_H, bf),
                                     BERT_H), (BERT_R, BERT_H), True),
        "proj_ln bf16": (drop_key(fa, mf.mlp_blocks(BERT_R, BERT_H, BERT_H,
                                                    dtype=bf)[0], BERT_H),
                         (BERT_R, BERT_H), True),
        "fused_mlp bf16": (mlp_key(fa, mf, BERT_R, BERT_H, BERT_F, bf),
                           (BERT_R, BERT_H), True),
        "fused_mlp bf16 table hit": (mlp_key(fa, mf, *MLP_TABLE, bf),
                                     MLP_TABLE[:2], True)}
    libs = {"flash_attention.cu": fa._lib(), "norm_fusion.cu": nf._lib(),
            "proj_ln.cu": mf._pl_lib(), "fused_mlp.cu": mf._mlp_lib()}
    out = {}
    for label, (key, shape, rows) in cases.items():
        ref = (fa.row_bits_ref(key, *shape, "cuda") if rows
               else fa.flash_bits_ref(key, *shape, "cuda"))
        kept = float((ref < key.threshold).double().mean())
        n = ref.numel()
        sigma = (DROP_P * (1 - DROP_P) / n) ** 0.5
        check(abs(kept - (1 - DROP_P)) <= 4 * sigma,
              f"dropout bits {label}: kept share {kept} beyond 4 sigma "
              f"({sigma}) of {1 - DROP_P}")
        for lib_name, lib in libs.items():
            got = fa.dropout_bits_cuda(lib, key, shape, rows, "cuda")
            differ = int((got != ref).sum())
            check(differ == 0, f"dropout bits {label}: {lib_name}'s device "
                  f"hash differs from the plain version at {differ} of {n}")
            del got
        out[label] = dict(tile=[key.rows, key.cols], shape=list(shape),
                          elements=n, kept_share=kept, sigma=sigma,
                          libraries_bitwise_equal=list(libs))
        del ref
        torch.cuda.empty_cache()
    return dict(seed_pair=[hex(w) for w in DROP_SEED], p=DROP_P, cases=out)


def phase_bert_dropout_parity_fp32(torch):
    """fp32 at bert-base width, 2 layers, B=4, S=512 with padding, at the
    default rates (0.1 / 0.1): the loss and every gradient with the
    kernels on the card against the port's CPU route (the kernels' plain
    versions) from the same weights and the same generator seed; the
    masks are the same, so they agree as tightly as at rate 0. The card
    launches each dropout variant; the generators end in the same state,
    1 + 3·L splits past the seed."""
    from paddle_tpu_torch import seed, set_flags
    from paddle_tpu_torch.core import generator as gen
    from paddle_tpu_torch.models import bert
    cfg = bert.CONFIGS["bert-base"]._replace(num_hidden_layers=2)
    set_flags({"FLAGS_fused_norm": True, "FLAGS_fused_mlp": True})
    model = bert.BertForPretraining(cfg, dtype=torch.float32, seed=1)
    cpu = bert.BertForPretraining(cfg, device="cpu", dtype=torch.float32,
                                  seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    batch, _ = bert_batch(torch, cfg, 4, BERT_S, 1)

    def run(m, b):
        seed(7)
        reset_launches()
        loss = m.loss(*b[:3], attention_mask=b[3])
        g = torch.autograd.grad(loss, list(m.parameters()))
        state = gen.default_generator.get_state()
        return loss.item(), g, read_launches(), state

    lc, gcard, counts, state_c = run(model, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp, gplain, counts_p, state_p = run(cpu, tuple(t.cpu() for t in batch))
    cpu_s = time.perf_counter() - t0
    want = bert_launches(cfg, True, wgmma=False)     # f32: the generic route
    check(all(counts[k] == n for k, n in want.items())
          and sum(counts.values()) == sum(want.values()),
          f"bert dropout parity on the card launched {counts} (want {want})")
    check(not any(counts_p.values()), f"the CPU route launched {counts_p}")
    fresh = gen.Generator(7)
    for _ in range(1 + 3 * cfg.num_hidden_layers):
        fresh.split_key()
    check(torch.equal(state_c, state_p) and torch.equal(state_c,
                                                        fresh.get_state()),
          f"generator states after the step: card {state_c}, CPU {state_p}, "
          f"want {fresh.get_state()}")
    tol = 1e-4      # per leaf, relative to the leaf's largest gradient
    worst = 0.0
    for a, b in zip(gcard, gplain):
        check(bool(torch.isfinite(a).all()), "parity gradient not finite")
        worst = max(worst, float((a.cpu() - b).abs().max())
                    / max(float(b.abs().max()), 1e-30))
    check(abs(lc - lp) <= 1e-5 * abs(lp), f"bert fp32 dropout loss: card "
          f"{lc} vs CPU {lp}")
    check(worst <= tol, f"bert fp32 dropout gradients: card vs CPU relative "
          f"{worst} > {tol}")
    leaves = len(gplain)
    del model, cpu, gcard, gplain
    return dict(rates=[cfg.hidden_dropout_prob,
                       cfg.attention_probs_dropout_prob],
                loss_card=lc, loss_cpu=lp,
                worst_grad_relative_card_vs_cpu=worst, tolerance=tol,
                leaves=leaves, launches=counts, cpu_seconds=cpu_s,
                generator_state=state_c.tolist())


def dropout_mask_ms(torch):
    """The embeddings' dense mask at bert-base's shape: F.dropout of a
    [32, 512, 768] bf16 tensor (threefry over 12.6M elements in int64
    PyTorch ops), device time."""
    from paddle_tpu_torch.nn.functional import dropout
    x = torch.randn(BERT_B, BERT_S, BERT_H, device="cuda").to(torch.bfloat16)
    ms = cuda_ms(lambda _: dropout(x, DROP_P), [None], iters=10)
    del x
    torch.cuda.empty_cache()
    return ms


# ---------------------------------------------------------------------------
# phases 37-38: the fused GeLU MLP's dropout variants (kernels 4-6)
# ---------------------------------------------------------------------------

BERT_F = 3072                          # bert-base's intermediate size
MLP_TABLE = (4096, 2048, 8192)         # a tuning-table hit: block_r 32 in bf16
# (r, h, f, dtype, approximate): gpt3-1.3b's width (block_r 128, the CUDA
# row block's height), bert-base's (256), the table hit (32), MLP_MULTI
# (256: the wgmma forward's mask in its last chunk's epilogue after two
# f32 sums), and a ragged R in f32 over two ffn chunks (256; the last row
# block 232 rows)
MLP_DROP_CASES = [(MLP_R, MLP_H, MLP_F, "bfloat16", True),
                  (BERT_R, BERT_H, BERT_F, "bfloat16", False),
                  (*MLP_TABLE, "bfloat16", True),
                  (*MLP_MULTI, "bfloat16", False),
                  (1000, BERT_H, BERT_F, "float32", False)]


def mlp_key(fa, mf, r, h, f, dtype):
    """The fused MLP's dropout key: the reference's row tile in ``dtype``
    by H columns."""
    return drop_key(fa, mf.mlp_blocks(r, h, f, dtype=dtype)[0], h)


def phase_mlp_dropout_vs_plain(torch):
    """The fused MLP ops' dropout variants (``fused_mlp_fwd`` /
    ``fused_mlp_bwd`` with the key) against their plain versions in every
    MLP_DROP_CASES case, keyed by ``mlp_blocks``'s row tile: y, dx, dw1,
    db1, dw2, db2 within MLP_TOL of their rows' scale (phase 9's
    tolerance); y's zeros are the plain mask's, exactly; with g in its
    last row only, dW2's all-zero columns and db2's zeros are that row's
    dropped columns, exactly; two backward calls give the same bits;
    autograd through ``fused_mlp_2d`` gives the ops' bits. The check
    shown to reject the mask keyed by the kernels' 128-row block wherever
    block_r differs from it. Then the times at gpt3-1.3b's and
    bert-base's widths."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    from paddle_tpu_torch.kernels import norm_fusion as nf
    worst, tiles, faults, routes = {}, {}, {}, {}
    for r, h, f, name, approx in MLP_DROP_CASES:
        dtype = getattr(torch, name)
        x, w1, b1, w2, b2, g = mlp_inputs(torch, r, h, f, dtype,
                                          seed=r + h + f)
        key = mlp_key(fa, mf, r, h, f, dtype)
        d = (key.p, key.s0, key.s1, key.rows)
        what = f"{name} r={r} h={h} f={f} approximate={approx}"
        tiles[what] = key.rows
        before = dict(mf.mlp_bwd_routes)
        fbefore = dict(mf.mlp_fwd_routes)
        y = mf.fused_mlp_fwd(x, w1, b1, w2, b2, approx, *d)
        grads = mf.fused_mlp_bwd(x, w1, b1, w2, b2, g, approx, *d)
        again = mf.fused_mlp_bwd(x, w1, b1, w2, b2, g, approx, *d)
        prim = [t.detach().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        y_ag = mf.fused_mlp_2d(*prim, approximate=approx, dropout_p=key.p,
                               dropout_seed=DROP_SEED)
        auto = torch.autograd.grad(y_ag, prim, g)
        g1 = torch.zeros_like(g)
        g1[-1] = g[-1]
        one = mf.fused_mlp_bwd(x, w1, b1, w2, b2, g1, approx, *d)
        keep = nf.row_keep_ref(key, x)
        torch.cuda.synchronize()
        took = {k: n - before[k] for k, n in mf.mlp_bwd_routes.items()}
        ftook = {k: n - fbefore[k] for k, n in mf.mlp_fwd_routes.items()}
        route = "wgmma" if name == "bfloat16" else "generic"
        check(took == {"wgmma": 0, "generic": 0, route: 4}
              and ftook == {"wgmma": 0, "generic": 0, route: 2},
              f"fused MLP dropout routes: forward {ftook}, backward {took} "
              f"({what}), want 2 and 4 calls on {route}")
        routes[what] = route
        check(all(same_bits(a, b) for a, b in zip(again, grads)),
              f"fused MLP dropout backward differs between two calls "
              f"({what})")
        check(same_bits(y_ag, y) and all(same_bits(a, b)
                                         for a, b in zip(auto, grads)),
              f"autograd through fused_mlp_2d at dropout differs from the "
              f"fused MLP ops ({what})")
        off = mask_mismatches(y, keep)
        check(off == 0, f"fused MLP dropout: y's zeros differ from the plain "
              f"mask at {off} elements ({what})")
        dropped = ~keep[-1]
        off_dw2 = int(((one[3] == 0).all(0) != dropped).sum())
        off_db2 = int(((one[4] == 0) != dropped).sum())
        check(off_dw2 == 0 and off_db2 == 0,
              f"fused MLP dropout: with g in the last row only, dW2's zero "
              f"columns differ from that row's mask at {off_dw2} columns, "
              f"db2's zeros at {off_db2} ({what})")
        ry = mf.fused_mlp_fwd_ref(x, w1, b1, w2, b2, approx, key)
        rdx = mf.fused_mlp_dx_ref(x, w1, b1, w2, g, approx, key)
        rdw = mf.fused_mlp_dw_ref(x, w1, b1, w2, g, approx, key)
        for label, got, ref in zip(("y", "dx", "dw1", "db1", "dw2", "db2"),
                                   (y, *grads), (ry, rdx, *rdw)):
            check(bool(torch.isfinite(got).all()),
                  f"fused MLP dropout {label} not finite ({what})")
            err = float((got.float() - ref.float()).abs().max())
            rel = flash_reading(got, ref)
            check(rel <= MLP_TOL[name],
                  f"fused MLP dropout {label} disagrees with plain: {what} "
                  f"max_abs_err={err} relative {rel} > {MLP_TOL[name]}")
            kern = {"y": "fused_mlp_fwd", "dx": "fused_mlp_dx"}.get(
                label, "fused_mlp_dw")
            w = worst.setdefault(name, {}).setdefault(kern, [0.0, 0.0])
            w[0], w[1] = max(w[0], err), max(w[1], rel)
        if key.rows != mf._ROW_BLOCK:
            # the planted fault: the mask keyed by the kernels' row block
            wrong = mf.fused_mlp_fwd(x, w1, b1, w2, b2, approx, key.p,
                                     key.s0, key.s1, mf._ROW_BLOCK)
            fault = dict(cuda_tile_rows=mf._ROW_BLOCK,
                         reference_tile_rows=key.rows,
                         y_reading=flash_reading(wrong, ry),
                         y_mask_mismatches=mask_mismatches(wrong, keep))
            check(fault["y_reading"] > MLP_TOL[name]
                  and fault["y_mask_mismatches"] > 0,
                  f"the fused MLP dropout checks pass the mask keyed by the "
                  f"CUDA row block ({what}): {fault}")
            faults[what] = fault
            del wrong
        del x, w1, b1, w2, b2, g, y, grads, again, prim, y_ag, auto, g1, one
        del keep, ry, rdx, rdw
        torch.cuda.empty_cache()
    return dict(p=DROP_P, tolerance_relative_to_row_rms_plus_abs=MLP_TOL,
                worst={n: {k: dict(max_abs_err=e, relative=r)
                           for k, (e, r) in w.items()}
                       for n, w in worst.items()},
                cases=[list(c) for c in MLP_DROP_CASES], key_tile_rows=tiles,
                routes=routes, planted_faults=faults,
                times={"gpt3-1.3b": mlp_times(torch, mf, key=mlp_key(
                           fa, mf, MLP_R, MLP_H, MLP_F, torch.bfloat16)),
                       "bert-base": mlp_times(
                           torch, mf, BERT_R, BERT_H, BERT_F, False, mlp_key(
                               fa, mf, BERT_R, BERT_H, BERT_F,
                               torch.bfloat16))})


def phase_mlp_dropout_parity_fp32(torch):
    """F.fused_mlp at dropout 0.1 in fp32, x [2, 512, H] (R=1024), at
    gpt3-1.3b's (H=2048, F=8192, tanh) and bert-base's (H=768, F=3072,
    erf) widths: the output and every gradient through autograd with the
    kernels on the card against the port's CPU route (the plain versions)
    from the same inputs and the same generator seed, within 1e-4 of each
    leaf's largest, the output's zeros equal. The launch counts are set
    to 0 before each call and read after it: each card call launches the
    three dropout variants of kernels 4-6 once each and nothing else, the
    CPU calls nothing; both generators end one split past the seed."""
    from paddle_tpu_torch import seed, set_flags
    from paddle_tpu_torch.core import generator as gen
    from paddle_tpu_torch.nn import functional as F
    set_flags({"FLAGS_fused_mlp": True})
    tol = 1e-4      # per leaf, relative to the leaf's largest
    want = {f"dropout_{k}": 1
            for k in ("fused_mlp_fwd", "fused_mlp_dx", "fused_mlp_dw")}
    total = dict.fromkeys(want, 0)
    out = {}
    for label, h, f, approx in (("gpt3-1.3b", MLP_H, MLP_F, True),
                                ("bert-base", BERT_H, BERT_F, False)):
        x, w1, b1, w2, b2, g = mlp_inputs(torch, 1024, h, f, torch.float32,
                                          seed=h + f + 1)
        x, g = x.reshape(2, 512, h), g.reshape(2, 512, h)

        def run(tensors):
            seed(9)
            prim = [t.detach().requires_grad_(True) for t in tensors[:5]]
            reset_launches()
            y = F.fused_mlp(*prim, approximate=approx, dropout_rate=DROP_P)
            grads = torch.autograd.grad(y, prim, tensors[5])
            counts = {k: n for k, n in read_launches().items() if n}
            return (y.detach(), grads, counts, F.last_mlp_path(),
                    gen.default_generator.get_state())

        yc, gcard, counts, path_c, state_c = run((x, w1, b1, w2, b2, g))
        torch.cuda.synchronize()
        yp, gplain, counts_p, path_p, state_p = run(
            tuple(t.cpu() for t in (x, w1, b1, w2, b2, g)))
        check(counts == want, f"F.fused_mlp at dropout {DROP_P} ({label}) "
              f"launched {counts} on the card (want {want})")
        check(not counts_p, f"the CPU route launched {counts_p}")
        check((path_c, path_p) == ("fused_mlp/cuda", "fused_mlp/plain"),
              f"F.fused_mlp took the paths {path_c}, {path_p}")
        fresh = gen.Generator(9)
        fresh.split_key()
        check(torch.equal(state_c, state_p)
              and torch.equal(state_c, fresh.get_state()),
              f"generator states after F.fused_mlp: card {state_c}, CPU "
              f"{state_p}, want {fresh.get_state()}")
        zeros_off = int(((yc.cpu() == 0) != (yp == 0)).sum())
        check(zeros_off == 0, f"F.fused_mlp {label}: the card's zeros differ "
              f"from the CPU's at {zeros_off} elements")
        readings = {}
        for leaf, a, b in zip(("y", "dx", "dw1", "db1", "dw2", "db2"),
                              (yc, *gcard), (yp, *gplain)):
            check(bool(torch.isfinite(a).all()), f"{leaf} not finite")
            readings[leaf] = (float((a.cpu() - b).abs().max())
                              / max(float(b.abs().max()), 1e-30))
            check(readings[leaf] <= tol, f"F.fused_mlp {label} {leaf}: card "
                  f"vs CPU relative {readings[leaf]} > {tol}")
        for k in total:
            total[k] += counts[k]
        out[label] = dict(h=h, f=f, approximate=approx, launches=counts,
                          relative_card_vs_cpu=readings,
                          dropped_share=float((yp == 0).double().mean()),
                          generator_state=state_c.tolist())
        del x, w1, b1, w2, b2, g, yc, gcard, yp, gplain
        torch.cuda.empty_cache()
    return dict(p=DROP_P, r=1024, tolerance=tol, launches=total, **out)


# ---------------------------------------------------------------------------
# phases 27-31: ResNet-50 training through the Layer model and Momentum,
# with the fused BatchNorm kernels (15-18)
# ---------------------------------------------------------------------------

BN_REPLACES = {
    "fused_bn_fwd": ("paddle_tpu/kernels/norm_fusion.py:403",
                     "paddle_tpu/kernels/norm_fusion.py:428"),
    "fused_bn_bwd": ("paddle_tpu/kernels/norm_fusion.py:455",
                     "paddle_tpu/kernels/norm_fusion.py:487")}
# Each output is held to max |kernel - plain| <= tol * max |plain|. The rows
# (y, dx, dres): f32, the same f32 arithmetic in other summation orders;
# bf16 I/O, both round the same f32 values, one bf16 unit (2^-8) at most
# apart, so 2^-7. The per-channel statistics and sums (mean, var, dw, db)
# are f32 sums of the same values in both dtypes: 1e-5.
BN_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
BN_STAT_TOL = 1e-5
BN_N = 256                               # resnet50 at B=256, 224^2
# (name, C, HW, relu, residual): the stem's BN, layer 1's bn3, layer 3's
# bn2 (HW = 196: bf16 planes off 16-byte boundaries), layer 4's bn3 (HW =
# 49), layer 1's downsample BN (no ReLU), and a BatchNorm1D over [N, C]
# (HW = 1: every vector spans channels)
BN_CASES = [("stem", 64, 12544, True, False),
            ("layer1.bn3", 256, 3136, True, True),
            ("layer3.bn2", 256, 196, True, False),
            ("layer4.bn3", 2048, 49, True, True),
            ("downsample", 256, 3136, False, False),
            ("bn1d", 512, 1, True, True)]
BN_EPS = 1e-5


def bn_inputs(torch, n, c, hw, dtype, seed, res=True):
    """x with per-channel and per-(image, channel) offsets (so that a
    dropped image shows in the statistics), the residual, w, b, g with a
    small mean (so that a dropped part shows in the sums) and the
    cotangents of the mean and var outputs."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, s=1.0, m=0.0):
        return m + torch.randn(*shape, generator=g, device="cuda") * s

    x = rnd(n, c, hw) + rnd(1, c, 1, s=0.5) + rnd(n, c, 1, s=0.5)
    return dict(x=x.to(dtype), res=rnd(n, c, hw).to(dtype) if res else None,
                w=rnd(c, s=0.2, m=1.0), b=rnd(c, s=0.2),
                g=rnd(n, c, hw, m=0.1).to(dtype), gmean=rnd(c),
                gvar=rnd(c))


def bn_bounds(n, c, hw, esize, res):
    """bound_ms and what bounds it: the forward reads x (and res) and
    writes y, the backward reads x, g (and res) and writes dx (and dres),
    each once at 3.35 TB/s, with the [C] vectors; ~6 and ~12 flops an
    element on the CUDA cores (67 TFLOP/s f32) take less."""
    rows, vec = n * c * hw * esize, c * 4
    k = 1 if res else 0
    work = {"fused_bn_fwd": (6.0 * n * c * hw, (2 + k) * rows + 4 * vec),
            "fused_bn_bwd": (12.0 * n * c * hw, (3 + 2 * k) * rows + 6 * vec)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / H100_FLOPS["float32"]
        t_bytes = nbytes / H100_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def bn_plain_pre(torch, nf, x, res, w, b, mean, var):
    """The plain version's pre-activation from the given statistics."""
    _, a, bb = nf._bn_fold(w, b, mean, var, BN_EPS)
    return nf._bn_pre(x.float(), res, a, bb)


def phase_bn_vs_plain(torch, timed=True):
    """The forward and backward custom ops (``fused_bn_fwd``,
    ``fused_bn_bwd``: the kernels' wrappers, which the training step
    reaches through ``fused_batch_norm_train``) against their plain
    versions at the resnet50 B=256 shapes of BN_CASES (bn_cases_vs_plain).
    Autograd through ``fused_batch_norm_train`` at layer 1's bn3 in bf16
    (bf16 w and b, as the model holds them) against the plain versions
    and bitwise against the ops; the check shown to reject a forward
    without the residual, a forward missing its first reduction part and
    a backward missing its first reduction part. The ops with bf16 weight
    and bias at layer 1's bn3 and the stem (bn_bf16_vectors: AMP's O2
    casts). Then the times of layer 1's bn3 and the stem's BN, and each
    direction's kernels alone at all six shapes in bf16
    (bn_shape_times)."""
    from paddle_tpu_torch.kernels import norm_fusion as nf
    out = bn_cases_vs_plain(torch, nf, BN_CASES, BN_N)
    out.update(autograd_bf16=bn_autograd(torch, nf),
               wrong_kernel_reading=bn_check_rejects(torch, nf),
               bf16_vectors=bn_bf16_vectors(torch, nf))
    if timed:
        out["times"] = {"layer1.bn3": bn_times(torch, nf, 256, 3136, True),
                        "stem": bn_times(torch, nf, 64, 12544, False)}
        out["shapes"] = bn_shape_times(torch, nf, BN_CASES, BN_N,
                                       torch.bfloat16)
    return out


def bn_cases_vs_plain(torch, nf, cases, n):
    """Each (name, C, HW, relu, residual) of ``cases`` at ``n`` images, f32
    and bf16: the ops' y, mean, var, dx, dres, dw, db against their plain
    versions, the backward with cotangents of the mean and var outputs.
    The backward's plain version takes the kernel's mean and var, as the
    backward does; where the kernel's ReLU gate (y > 0) and the plain
    version's (its pre-activation > 0) differ, dx differs by a·g, so such
    elements are counted and left out of the dx comparison (at most 1e-6
    of the elements, each with |pre| within 2^-20 of the largest). Two
    forward and two backward calls give the same bits. The gate: dres is g
    where the kernel's y is above 0 and 0 elsewhere, bit for bit (the
    persistent backward fed the cluster forward's mean and var). Every
    forward call takes the cluster route and every backward call the
    persistent route, and the plans their kernels reckon are
    bn_fwd_plan's and bn_bwd_plan's (bn_fwd_plan_reading,
    bn_plan_reading)."""
    worst, flips = {}, {}
    before = dict(nf.bn_bwd_routes)
    fwd_before = dict(nf.bn_fwd_routes)
    plans, fwd_plans = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for case, c, hw, relu, has_res in cases:
            x = bn_inputs(torch, n, c, hw, dtype, c + hw, has_res)
            xx, res, w, b, g = (x[k] for k in ("x", "res", "w", "b", "g"))
            plans[f"{name} {case}"] = bn_plan_reading(
                torch, nf, n, c, hw, dtype, 3 if relu and has_res else 2)
            fwd_plans[f"{name} {case}"] = bn_fwd_plan_reading(
                torch, nf, n, c, hw, dtype, has_res)
            y, mean, var = nf.fused_bn_fwd(xx, res, w, b, BN_EPS, relu)
            fwd_again = nf.fused_bn_fwd(xx, res, w, b, BN_EPS, relu)
            grads = nf.fused_bn_bwd(xx, res, w, b, mean, var, g, x["gmean"],
                                    x["gvar"], BN_EPS, relu)
            again = nf.fused_bn_bwd(xx, res, w, b, mean, var, g, x["gmean"],
                                    x["gvar"], BN_EPS, relu)
            dx, dres, dw, db = grads
            ry, rmean, rvar = nf.fused_bn_fwd_ref(xx, res, w, b, BN_EPS, relu)
            rdx, rgate, rdw, rdb = nf.fused_bn_bwd_ref(
                xx, res, w, b, mean, var, g, x["gmean"], x["gvar"], BN_EPS,
                relu)
            torch.cuda.synchronize()
            where = f"({name} {case} c={c} hw={hw})"
            check(all(same_bits(a, o) for a, o in zip(fwd_again,
                                                      (y, mean, var))),
                  f"fused BN forward differs between two calls {where}")
            check(all(same_bits(a, o) for a, o in zip(again, grads)),
                  f"fused BN backward differs between two calls {where}")
            keep = None
            if relu:
                pre = bn_plain_pre(torch, nf, xx, res, w, b, mean, var)
                differ = (y > 0) != (pre > 0)
                n_flip = int(differ.sum())
                band = 2.0 ** -20 * float(pre.abs().max())
                check(n_flip <= 1e-6 * y.numel() and bool(
                    (pre[differ].abs() <= band).all()),
                      f"fused BN ReLU gate differs from the plain version's "
                      f"at {n_flip} elements {where}")
                flips[f"{name} {case}"] = n_flip
                keep = ~differ
                if has_res:
                    want = torch.where(y > 0, g, torch.zeros_like(g))
                    check(same_bits(dres, want),
                          f"fused BN dres is not g gated by the kernel's own "
                          f"y > 0 {where}")
                del pre, differ
            outs = [("y", y, ry, BN_TOL[name]), ("mean", mean, rmean,
                                                 BN_STAT_TOL),
                    ("var", var, rvar, BN_STAT_TOL),
                    ("dx", dx, rdx.to(dtype), BN_TOL[name]),
                    ("dw", dw, rdw, BN_STAT_TOL), ("db", db, rdb,
                                                   BN_STAT_TOL)]
            if has_res:
                outs.append(("dres", dres, rgate.to(dtype), BN_TOL[name]))
            for key, got, ref, tol in outs:
                check(bool(torch.isfinite(got).all()),
                      f"fused BN {key} not finite {where}")
                if key == "dx" and keep is not None:
                    got, ref = got[keep], ref[keep]
                err, rel = rel_err(got, ref)
                check(rel <= tol, f"fused BN {key} disagrees with plain "
                      f"{where}: max_abs_err={err} relative {rel} > {tol}")
                kern = ("fused_bn_fwd" if key in ("y", "mean", "var")
                        else "fused_bn_bwd")
                wst = worst.setdefault(name, {}).setdefault(kern, [0., 0.])
                wst[0], wst[1] = max(wst[0], err), max(wst[1], rel)
            del x, xx, res, w, b, g, y, mean, var, grads, again, dx, dres
            del dw, db, ry, rmean, rvar, rdx, rgate, rdw, rdb, outs, keep
            del fwd_again
            torch.cuda.empty_cache()
    routes = {k: nf.bn_bwd_routes[k] - before[k] for k in before}
    want = {"persistent": 2 * 2 * len(cases), "generic": 0}
    check(routes == want, f"fused BN backward calls by route {routes}, want "
          f"{want}")
    fwd_routes = {k: nf.bn_fwd_routes[k] - fwd_before[k] for k in fwd_before}
    want = {"cluster": 2 * 2 * len(cases), "generic": 0}
    check(fwd_routes == want, f"fused BN forward calls by route {fwd_routes}, "
          f"want {want}")
    return dict(tolerance_relative_to_max=dict(rows=BN_TOL,
                                               statistics=BN_STAT_TOL),
                forward_routes=fwd_routes, cluster_plans=fwd_plans,
                backward_routes=routes, persistent_plans=plans,
                worst={d: {k: dict(max_abs_err=e, relative=r)
                           for k, (e, r) in w.items()}
                       for d, w in worst.items()},
                gate_flips_left_out_of_dx=flips, images=n,
                cases=[list(c) for c in cases])


def bn_plan_reading(torch, nf, n, c, hw, dtype, tensors):
    """The persistent backward's plan as its C side reckons it
    (fused_bn_bwd_plan) against bn_bwd_plan's, which sizes the scratch:
    channels a group, groups, the first group's tile, slot vectors."""
    import ctypes
    sms = nf._sm_count(torch.device("cuda"))
    plan = nf.bn_bwd_plan(n, c, hw, dtype, sms, tensors)
    got = (ctypes.c_int * 8)()
    rc = nf._lib().fused_bn_bwd_plan(n, c, hw, plan.vec, tensors, sms, got)
    g0, gl = plan.groups[0], plan.groups[-1]
    want = [plan.cg, len(plan.groups), g0.th, g0.tw, gl.cn, gl.th, gl.tw,
            plan.cap]
    check(rc == 0 and list(got) == want, f"persistent BN plan at [{n}, {c}, "
          f"{hw}] {dtype}: the kernel's {list(got)} (rc {rc}), "
          f"bn_bwd_plan's {want}")
    return dict(channels_a_group=plan.cg, groups=len(plan.groups),
                tile=[g0.th, g0.tw], tiles=g0.tiles, blocks=plan.parts)


def bn_fwd_plan_reading(torch, nf, n, c, hw, dtype, res):
    """The cluster forward's plan as its C side reckons it
    (fused_bn_fwd_plan) against bn_fwd_plan's; the route's cluster size
    and the clusters the card holds at once
    (cudaOccupancyMaxActiveClusters, fused_bn_fwd_clusters); the bytes of
    x the plan reads over x's size."""
    import ctypes
    sms = nf._sm_count(torch.device("cuda"))
    plan = nf.bn_fwd_plan(n, c, hw, dtype, res, sms)
    got = (ctypes.c_int * 11)()
    lib = nf._lib()
    rc = lib.fused_bn_fwd_plan(n, c, hw, plan.vec, int(res), sms, got)
    want = [plan.cg, plan.k, plan.ns, plan.cs, plan.rowv, plan.cap,
            plan.ring_t, plan.smem, plan.slabs, plan.tv, plan.threads]
    check(rc == 0 and list(got) == want, f"cluster BN plan at [{n}, {c}, "
          f"{hw}] {dtype}: the kernel's {list(got)} (rc {rc}), "
          f"bn_fwd_plan's {want}")
    act = (ctypes.c_int * 2)()
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    rc = getattr(lib, f"fused_bn_fwd_clusters_{suffix}")(n, c, hw, int(res),
                                                         act)
    check(rc == 0 and act[0] == plan.k and act[1] > 0,
          f"cluster BN at [{n}, {c}, {hw}]: K {act[0]}, {act[1]} clusters "
          f"at once (rc {rc})")
    nbytes = nf.bn_fwd_bytes(plan)
    return dict(channels_a_slab=plan.cg, slabs=plan.slabs, k=plan.k,
                threads=plan.threads, active_clusters=act[1],
                smem_bytes=plan.smem,
                resident_vectors=plan.cap, tile_vectors=plan.tv,
                x_read_over_x=nbytes["x_read"] / nbytes["y_written"])


def bn_bwd_calls(torch, fn, calls=10):
    """The CUDA work one persistent backward call enqueues, from a profile
    of ``calls`` calls: kernel launches (cudaLaunchKernel*, the
    cooperative launch included) and memsets (the counters') a call, and
    the kernels' names."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    n, names = cuda_launches(torch, fn, calls)
    memsets = sum(e.count for e in events
                  if e.key.startswith("cudaMemset")) / calls
    return dict(kernel_launches_per_call=n, memsets_per_call=memsets,
                kernels=names)


def bn_host_us(torch, fn, calls=200, chunk=50):
    """Host time a call: the enqueue wall of ``calls`` calls, no sync, in
    chunks of ``chunk`` (synced between, outside the clock) so that the
    launch queue never fills and blocks the host on the card."""
    total = 0.0
    fn()
    for _ in range(calls // chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(chunk):
            fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / (calls // chunk * chunk) * 1e6


def bn_autograd(torch, nf):
    """Autograd through fused_batch_norm_train on [256, 256, 56, 56] bf16
    (layer 1's bn3: residual and ReLU) with bf16 w and b: y, dx, dres, dw,
    db against the plain versions within BN_TOL (the sums in bf16 after
    the cast, so 2^-7), and bitwise equal to the ops' results."""
    x = bn_inputs(torch, BN_N, 256, 3136, torch.bfloat16, 31, True)
    bf = torch.bfloat16
    xx, res, g = (x[k].reshape(BN_N, 256, 56, 56) for k in ("x", "res", "g"))
    w, b = x["w"].to(bf), x["b"].to(bf)
    prim = [t.detach().requires_grad_(True) for t in (xx, res, w, b)]
    y, mean, var = nf.fused_batch_norm_train(prim[0], prim[2], prim[3],
                                             residual=prim[1], eps=BN_EPS,
                                             fuse_relu=True)
    auto = torch.autograd.grad(y, prim, g)
    x3, r3, g3 = (t.reshape(BN_N, 256, 3136) for t in (xx, res, g))
    y_op, mean_op, var_op = nf.fused_bn_fwd(x3, r3, w, b, BN_EPS, True)
    ops = nf.fused_bn_bwd(x3, r3, w, b, mean_op, var_op, g3, None, None,
                          BN_EPS, True)
    ry, _, _ = nf.fused_bn_fwd_ref(x3, r3, w, b, BN_EPS, True)
    rdx, rgate, rdw, rdb = nf.fused_bn_bwd_ref(x3, r3, w, b, mean_op, var_op,
                                               g3, None, None, BN_EPS, True)
    torch.cuda.synchronize()
    check(same_bits(y.reshape(x3.shape), y_op)
          and same_bits(mean, mean_op) and same_bits(var, var_op)
          and all(same_bits(a.reshape(o.shape), o)
                  for a, o in zip(auto, ops)),
          "autograd through fused_batch_norm_train differs from the BN ops")
    readings = {}
    for key, got, ref in (("y", y, ry), ("dx", auto[0], rdx.to(bf)),
                          ("dres", auto[1], rgate.to(bf)),
                          ("dw", auto[2], rdw.to(bf)),
                          ("db", auto[3], rdb.to(bf))):
        readings[key] = rel_err(got.reshape(ref.shape), ref)[1]
        check(got.dtype == bf and readings[key] <= BN_TOL["bfloat16"],
              f"autograd through fused_batch_norm_train: {key} {got.dtype} "
              f"relative {readings[key]} > {BN_TOL['bfloat16']}")
    del x, xx, res, g, w, b, prim, y, mean, var, auto, x3, r3, g3, y_op
    del mean_op, var_op, ops, ry, rdx, rgate, rdw, rdb
    torch.cuda.empty_cache()
    return dict(shape=[BN_N, 256, 56, 56], relative_to_max=readings,
                bitwise_equal_to_ops=True)


def bn_check_rejects(torch, nf, n=BN_N, c=256, hw=3136,
                     dtype=None, relu=True, res=True):
    """The checks must reject a forward that leaves out the residual
    (where there is one), a forward that leaves out its first reduction
    part (the images of the first block of the reduction grid), a
    backward that leaves out those images, a cluster forward whose rank
    0 folds without its last peer's partial (mean and var, which rank 0
    writes, and rank 0's tile of y) and a persistent backward whose
    every fold leaves out block 0's partial (block 0 holds a tile of every
    group, so each group is applied from wrong a, b', p2, p3): the kernels
    on inputs that do just that, or with the fault planted, held against
    the plain versions of the whole; at layer 1's bn3 in bf16 unless told
    otherwise. Returns the readings."""
    dtype = torch.bfloat16 if dtype is None else dtype
    name = str(dtype).split(".")[-1]
    x = bn_inputs(torch, n, c, hw, dtype, 37, res)
    xx, r, w, b, g = (x[k] for k in ("x", "res", "w", "b", "g"))
    ry, rmean, rvar = nf.fused_bn_fwd_ref(xx, r, w, b, BN_EPS, relu)
    rdx, _, rdw, rdb = nf.fused_bn_bwd_ref(xx, r, w, b, rmean, rvar, g, None,
                                           None, BN_EPS, relu)
    fault = nf._bn_bwd_cuda(xx, r, w, b, rmean, rvar, g, None, None, BN_EPS,
                            relu, skip=0)
    sms = nf._sm_count(xx.device)
    check(nf.bn_fwd_plan(n, c, hw, dtype, r is not None, sms).k > 1,
          f"the planted forward fault needs a cluster of 2 CTAs or more at "
          f"[{n}, {c}, {hw}]")
    ffault = nf._bn_fwd_cuda(xx, r, w, b, BN_EPS, relu, skip=1)
    k = -(-n // nf._bn_parts(n, hw))    # the images one reduction part sums
    rk = None if r is None else r[k:]
    _, cut_mean, cut_var = nf.fused_bn_fwd(xx[k:], rk, w, b, BN_EPS, relu)
    _, _, cut_dw, cut_db = nf.fused_bn_bwd(xx[k:], rk, w, b, rmean, rvar,
                                           g[k:], None, None, BN_EPS, relu)
    readings = {"mean_one_part_dropped": (rel_err(cut_mean, rmean)[1],
                                          BN_STAT_TOL),
                "var_one_part_dropped": (rel_err(cut_var, rvar)[1],
                                         BN_STAT_TOL),
                "dw_one_part_dropped": (rel_err(cut_dw, rdw)[1], BN_STAT_TOL),
                "db_one_part_dropped": (rel_err(cut_db, rdb)[1], BN_STAT_TOL),
                "mean_fold_missing_last_rank": (rel_err(ffault[1], rmean)[1],
                                                BN_STAT_TOL),
                "var_fold_missing_last_rank": (rel_err(ffault[2], rvar)[1],
                                               BN_STAT_TOL),
                "y_fold_missing_last_rank": (rel_err(ffault[0], ry)[1],
                                             BN_TOL[name]),
                "dw_fold_missing_a_partial": (rel_err(fault[2], rdw)[1],
                                              BN_STAT_TOL),
                "db_fold_missing_a_partial": (rel_err(fault[3], rdb)[1],
                                              BN_STAT_TOL)}
    if res:
        no_res, _, _ = nf.fused_bn_fwd(xx, None, w, b, BN_EPS, relu)
        readings["forward_without_residual"] = (rel_err(no_res, ry)[1],
                                                BN_TOL[name])
        del no_res
    for key, (reading, tol) in readings.items():
        check(reading > tol, f"the {name} BN check passes a wrong kernel "
              f"({key}): {reading} <= {tol}")
    out = {k: dict(reading=v, tolerance=t) for k, (v, t) in readings.items()}
    # dx of the planted fault moves by about a * (the partial's share of
    # sum g') / M, which may stay inside the rows' tolerance: reported
    out["dx_fold_missing_a_partial"] = dict(
        reading=rel_err(fault[0], rdx.to(dtype))[1], tolerance="reported")
    out["shape"] = [n, c, hw, name]
    del x, xx, r, w, b, g, ry, rmean, rvar, rdx, rdw, rdb, cut_mean
    del cut_var, cut_dw, cut_db, fault, rk, ffault
    torch.cuda.empty_cache()
    return out


def bn_times(torch, nf, c, hw, res, n=BN_N, dtype="bfloat16", relu=True):
    """Device times at [n, C, HW] in ``dtype`` with ReLU (and the
    residual) as asked: each op in turns with its plain version; the
    library yardstick (never called by the port) is F.batch_norm(x, None,
    None, w, b, training=True) → + res → relu with f32 w and b, and its
    autograd backward; each direction's kernels alone (the cluster
    forward, the persistent backward) in turns with the generic route's,
    with their CUDA launches and memsets a call."""
    x = bn_inputs(torch, n, c, hw, getattr(torch, dtype), 41, res)
    xx, r, w, b, g = (x[k] for k in ("x", "res", "w", "b", "g"))
    y, mean, var = nf.fused_bn_fwd(xx, r, w, b, BN_EPS, relu)
    runs = {
        "fused_bn_fwd": (
            lambda _: nf.fused_bn_fwd(xx, r, w, b, BN_EPS, relu),
            lambda _: nf.fused_bn_fwd_ref(xx, r, w, b, BN_EPS, relu)),
        "fused_bn_bwd": (
            lambda _: nf.fused_bn_bwd(xx, r, w, b, mean, var, g, None, None,
                                      BN_EPS, relu),
            lambda _: nf.fused_bn_bwd_ref(xx, r, w, b, mean, var, g, None,
                                          None, BN_EPS, relu)),
    }
    bounds = bn_bounds(n, c, hw, xx.element_size(), res)
    out = {}
    for name, (kern, plain) in runs.items():
        plain_ms, ms, t = in_turns(plain, kern)
        out[name] = dict(ms=ms, plain_ms=plain_ms, all_ms=t,
                         bound_ms=bounds[name][0], bound_by=bounds[name][1])
    batch_norm = torch.nn.functional.batch_norm

    def library(xx, rr, ww, bb):
        yy = batch_norm(xx, None, None, ww, bb, training=True, eps=BN_EPS)
        yy = yy if rr is None else yy + rr
        return torch.relu(yy) if relu else yy

    out["fused_bn_fwd"]["library_ms"], _, _ = in_turns(
        lambda _: library(xx, r, w, b), runs["fused_bn_fwd"][0])
    prim = [t.detach().requires_grad_(True) for t in (xx, w, b)]
    rg = None if r is None else r.detach().requires_grad_(True)
    yl = library(prim[0], rg, prim[1], prim[2])
    leaves = prim + ([] if rg is None else [rg])
    out["fused_bn_bwd"]["library_ms"], _, _ = in_turns(
        lambda _: torch.autograd.grad(yl, leaves, g, retain_graph=True),
        runs["fused_bn_bwd"][0])
    # the backward's kernels alone (no casts): the persistent route in
    # turns with the generic route's four launches
    kern = {route: (lambda _, rt=route: nf._bn_bwd_cuda(
        xx, r, w, b, mean, var, g, None, None, BN_EPS, relu, route=rt))
        for route in ("persistent", "generic")}
    earlier_ms, kernel_ms, t = in_turns(kern["generic"], kern["persistent"])
    calls = bn_bwd_calls(torch, lambda: kern["persistent"](None))
    check(calls["kernel_launches_per_call"] == 1
          and calls["memsets_per_call"] <= 1,
          f"persistent BN backward: {calls} a call, want 1 launch and the "
          f"counters' memset")
    out["fused_bn_bwd"].update(
        route="persistent", kernel_ms=kernel_ms, earlier_ms=earlier_ms,
        earlier="the four-launch bn_reduce + sum_parts + bn_fold_bwd + bn_apply (the "
                "generic route), same inputs, in turns",
        route_all_ms=t, **calls,
        generic_kernel_launches_per_call=cuda_launches(
            torch, lambda: kern["generic"](None))[0],
        note="ms and plain_ms: the op (the kernel and the casts of dw and "
             "db); kernel_ms, earlier_ms: the persistent and generic "
             "kernels alone; one cooperative launch after a memset of the "
             "counters")
    # the forward's kernels alone: the cluster route in turns with the
    # generic route's four launches
    fkern = {route: (lambda _, rt=route: nf._bn_fwd_cuda(
        xx, r, w, b, BN_EPS, relu, route=rt))
        for route in ("cluster", "generic")}
    earlier_ms, kernel_ms, t = in_turns(fkern["generic"], fkern["cluster"])
    calls = bn_bwd_calls(torch, lambda: fkern["cluster"](None))
    check(calls["kernel_launches_per_call"] == 1
          and calls["memsets_per_call"] == 0,
          f"cluster BN forward: {calls} a call, want 1 launch and no memset")
    out["fused_bn_fwd"].update(
        route="cluster", kernel_ms=kernel_ms, earlier_ms=earlier_ms,
        earlier="the four-launch bn_reduce + sum_parts + bn_fold_fwd + "
                "bn_apply (the generic route), same inputs, in turns",
        route_all_ms=t, **calls,
        generic_kernel_launches_per_call=cuda_launches(
            torch, lambda: fkern["generic"](None))[0],
        note="ms and plain_ms: the op; kernel_ms, earlier_ms: the cluster "
             "and generic kernels alone; one launch of thread-block "
             "clusters, no memset")
    out["timed_at"] = dict(shape=[n, c, hw], dtype=dtype, residual=res,
                           relu=relu)
    del x, xx, r, w, b, g, y, mean, var, prim, rg, yl, leaves
    torch.cuda.empty_cache()
    return out


def bn_shape_times(torch, nf, cases, n, dtype):
    """Each (name, C, HW, relu, residual) of ``cases`` at ``n`` images in
    ``dtype``, each direction's kernels alone: the cluster forward in turns
    with the generic forward (bn::run's four launches), with the plain
    version and with the F.batch_norm chain (F.batch_norm(x, None, None,
    w, b, training=True) -> + res -> relu as the epilogue says, never
    called by the port); the persistent backward in turns with the
    generic backward; the bounds (bn_bounds) and the bytes the forward's
    plan moves (x's resident part once and the rest twice, the residual,
    y). Every cluster call is one launch and no memset (bn_bwd_calls)."""
    out = {}
    batch_norm = torch.nn.functional.batch_norm
    sms = nf._sm_count(torch.device("cuda"))
    for case, c, hw, relu, has_res in cases:
        x = bn_inputs(torch, n, c, hw, dtype, 47, has_res)
        xx, r, w, b, g = (x[k] for k in ("x", "res", "w", "b", "g"))
        _, mean, var = nf.fused_bn_fwd(xx, r, w, b, BN_EPS, relu)

        def fwd(route):
            return lambda _: nf._bn_fwd_cuda(xx, r, w, b, BN_EPS, relu,
                                             route=route)

        def bwd(route):
            return lambda _: nf._bn_bwd_cuda(xx, r, w, b, mean, var, g, None,
                                             None, BN_EPS, relu, route=route)

        def library(_):
            yy = batch_norm(xx, None, None, w, b, training=True, eps=BN_EPS)
            yy = yy if r is None else yy + r
            return torch.relu(yy) if relu else yy

        generic_ms, cluster_ms, t = in_turns(fwd("generic"), fwd("cluster"))
        plain_ms, _, tp = in_turns(
            lambda _: nf.fused_bn_fwd_ref(xx, r, w, b, BN_EPS, relu),
            fwd("cluster"), iters=5)
        library_ms, _, tl = in_turns(library, fwd("cluster"))
        bwd_generic_ms, bwd_ms, tb = in_turns(bwd("generic"),
                                              bwd("persistent"))
        calls = bn_bwd_calls(torch, lambda: fwd("cluster")(None))
        check(calls["kernel_launches_per_call"] == 1
              and calls["memsets_per_call"] == 0,
              f"cluster BN forward at {case}: {calls} a call, want 1 launch "
              f"and no memset")
        bounds = bn_bounds(n, c, hw, xx.element_size(), has_res)
        plan = nf.bn_fwd_plan(n, c, hw, dtype, has_res, sms)
        nbytes = nf.bn_fwd_bytes(plan)
        moved = sum(nbytes[k] for k in ("x_read", "res_read", "y_written"))
        out[case] = dict(
            shape=[n, c, hw], relu=relu, residual=has_res,
            forward=dict(ms=cluster_ms, earlier_ms=generic_ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bounds["fused_bn_fwd"][0],
                         bound_by=bounds["fused_bn_fwd"][1],
                         share_of_bound=bounds["fused_bn_fwd"][0]
                         / cluster_ms,
                         all_ms=dict(turns=t, plain=tp, library=tl),
                         k=plan.k, slabs=plan.slabs, channels_a_slab=plan.cg,
                         bytes_moved=moved,
                         bytes_moved_ms_at_3_35_tb_s=moved
                         / H100_BYTES_PER_S * 1e3,
                         x_read_over_x=nbytes["x_read"] / nbytes["y_written"],
                         cuda_launches_per_call=calls[
                             "kernel_launches_per_call"],
                         memsets_per_call=calls["memsets_per_call"]),
            backward=dict(persistent_ms=bwd_ms, generic_ms=bwd_generic_ms,
                          faster="persistent" if bwd_ms < bwd_generic_ms
                          else "generic",
                          bound_ms=bounds["fused_bn_bwd"][0],
                          channel_bytes=n * hw * xx.element_size(),
                          all_ms=tb))
        del x, xx, r, w, b, g, mean, var
        torch.cuda.empty_cache()
    return dict(dtype=str(dtype).split(".")[-1], images=n, cases=out,
                note="kernels alone, device time (cuda_ms), the better of "
                     "two passes in turns (a, b, b, a); the plain version "
                     "at 5 calls a pass")


RESNET_B, RESNET_HW, RESNET_CLASSES = 256, 224, 1000
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9
# 53 BatchNorms a step: the stem, 16 blocks x 3, 4 downsample BNs; each op
# call counts once, its four launches inside it
RESNET_BNS = 53
RESNET_LEAVES = 161      # parameters: 53 BN weights and biases, 53 convs, fc


def resnet_batch(torch, b, hw, dtype, seed):
    """One fixed batch from the seed: images N(0, 1) and labels [B, 1] in
    [0, 1000)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, 3, hw, hw, generator=g, device="cuda").to(dtype)
    y = torch.randint(0, RESNET_CLASSES, (b, 1), generator=g, device="cuda")
    return x, y


def resnet_trainer(torch, dtype, b, hw, seed=0):
    """The user's loop (tests/test_vision_hapi.py:32-42, bench.py:552-566):
    resnet50 on the card in ``dtype``, Momentum(0.1, momentum=0.9) over its
    parameters, F.cross_entropy(net(x).float(), y) → backward → step →
    clear_grad on one fixed batch. Returns (net, step, batch); step() →
    (loss, the CUDA events around the Momentum update)."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    net = resnet50(num_classes=RESNET_CLASSES, dtype=dtype, seed=seed)
    opt = Momentum(RESNET_LR, parameters=net.parameters(),
                   momentum=RESNET_MOMENTUM)
    x, y = resnet_batch(torch, b, hw, dtype, seed)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def step():
        loss = F.cross_entropy(net(x).float(), y)
        loss.backward()
        ev[0].record()
        with torch.profiler.record_function("momentum_step"):
            opt.step()
        ev[1].record()
        opt.clear_grad()
        return loss.detach(), ev

    return net, step, (x, y)


def resnet_flops_per_image(torch, net, hw):
    """2 flops per multiply-add of every convolution and of the fc layer,
    from the shapes of one image's forward (hooks on Conv2D and Linear)."""
    from paddle_tpu_torch.nn import Conv2D, Linear
    total = [0]

    def conv_hook(mod, inp, out):
        kh, kw = mod._kernel_size
        total[0] += (2 * out.shape[1] * (inp[0].shape[1] // mod._groups)
                     * kh * kw * out.shape[2] * out.shape[3])

    def fc_hook(mod, inp, out):
        total[0] += 2 * mod.weight.shape[0] * mod.weight.shape[1]

    hooks = [m.register_forward_hook(conv_hook if isinstance(m, Conv2D)
                                     else fc_hook)
             for m in net.modules() if isinstance(m, (Conv2D, Linear))]
    was = net.training
    net.eval()
    with torch.no_grad():
        net(torch.zeros(1, 3, hw, hw, device="cuda",
                        dtype=net.parameters()[0].dtype))
    net.train(was)
    for h in hooks:
        h.remove()
    return total[0]


class BnRecorder:
    """While the ``with`` block runs, records each train-mode BatchNorm of
    the model: its running buffers (the layer's ``_mean``, ``_variance``)
    and values before the call, the batch statistics the fused route
    returns, and the shape and epilogue of the call (for the bound)."""

    def __init__(self):
        from paddle_tpu_torch.nn.functional import norm as fnorm
        from paddle_tpu_torch.nn.layer import norm as lnorm
        self.fnorm, self.lnorm = fnorm, lnorm
        self.calls, self.stats = [], []

    def __enter__(self):
        self._saved = (self.lnorm.batch_norm_act, self.lnorm.batch_norm,
                       self.fnorm.fused_batch_norm_train)
        fbn = self._saved[2]

        def recorder(fn):
            # the layers' forward_act and forward (the downsample BNs)
            def rec(x, rm, rv, *args, **kw):
                self.calls.append(dict(rm=rm, rv=rv, rm0=rm.clone(),
                                       rv0=rv.clone(), shape=tuple(x.shape),
                                       res=kw.get("residual") is not None))
                return fn(x, rm, rv, *args, **kw)
            return rec

        def fbn_rec(*args, **kw):
            out = fbn(*args, **kw)
            self.stats.append((out[1].detach().clone(),
                               out[2].detach().clone()))
            return out

        self.lnorm.batch_norm_act = recorder(self._saved[0])
        self.lnorm.batch_norm = recorder(self._saved[1])
        self.fnorm.fused_batch_norm_train = fbn_rec
        return self

    def __exit__(self, *exc):
        (self.lnorm.batch_norm_act, self.lnorm.batch_norm,
         self.fnorm.fused_batch_norm_train) = self._saved

    def running_stats_reading(self, torch, calls=RESNET_BNS):
        """Each BN's running stats after the step against Paddle's rule
        m·before + (1 − m)·batch, m = 0.9 (the layers' default), the
        biased batch variance: the largest relative difference (rtol
        1e-6). ``calls``: the BN calls the step makes."""
        check(len(self.calls) == len(self.stats) == calls,
              f"{len(self.calls)} BN calls, {len(self.stats)} fused, want "
              f"{calls}")
        worst = 0.0
        for call, (mean, var) in zip(self.calls, self.stats):
            for now, before, batch in ((call["rm"], call["rm0"], mean),
                                       (call["rv"], call["rv0"], var)):
                want = before * RESNET_MOMENTUM + batch * (1 - RESNET_MOMENTUM)
                moved = float((now - before).abs().max())
                diff = float((now - want).abs().max()) / max(
                    float(want.abs().max()), 1e-30)
                check(moved > 0, "a running statistic did not move")
                worst = max(worst, diff)
        check(worst <= 1e-6, f"running statistics off Paddle's rule: {worst}")
        return worst

    def bound_ms(self, esize):
        """The fused BN kernels' bytes-once bound summed over the step's
        calls (forward and backward)."""
        fwd = bwd = 0.0
        for call in self.calls:
            n, c = call["shape"][:2]
            hw = int(np.prod(call["shape"][2:]))
            b = bn_bounds(n, c, hw, esize, call["res"])
            fwd += b["fused_bn_fwd"][0]
            bwd += b["fused_bn_bwd"][0]
        return dict(forward=fwd, backward=bwd)


def phase_train_resnet(torch, fused, steps=TRAIN_STEPS):
    """Train resnet50 bf16 at B=256, 224^2 on one fixed batch: one warm-up
    step (its running statistics held to Paddle's rule, on the fused route
    its batch statistics recorded), then `steps` steps, with
    FLAGS_fused_norm as `fused` says. Fused: exactly 53 fused_bn_fwd and
    53 fused_bn_bwd a step; dense: none."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.nn.functional import last_norm_path
    set_flags({"FLAGS_fused_norm": fused})
    net, step, _ = resnet_trainer(torch, torch.bfloat16, RESNET_B, RESNET_HW)
    flops = resnet_flops_per_image(torch, net, RESNET_HW) * RESNET_B * 3
    if fused:
        with BnRecorder() as rec:
            loss0, _ = step()
        stats_reading = rec.running_stats_reading(torch)
        bn_bound = rec.bound_ms(2)
        del rec
    else:
        loss0, _ = step()
        stats_reading = bn_bound = "fused route only"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, momentum_ms = [], []
    with ClockSampler() as clocks:
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, ev = step()
            losses.append(loss)
            ev[1].synchronize()
            momentum_ms.append(ev[0].elapsed_time(ev[1]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_launches()
    path = last_norm_path()
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)) and np.isfinite(float(loss0)),
          f"resnet50 loss not finite: {float(loss0)}, {losses}")
    check(path == ("fused_bn/cuda" if fused else "dense"),
          f"resnet50 took the norm path {path} with FLAGS_fused_norm={fused}")
    for key, n in counts.items():
        want = (RESNET_BNS * steps if fused and key.startswith("fused_bn")
                else 0)
        check(n == want, f"{key} launched {n} times in {steps} resnet50 "
              f"steps (want {want}; FLAGS_fused_norm={fused})")
    broutes = bn_bwd_routes_reading(counts, "resnet50 training", fused)
    froutes = bn_fwd_routes_reading(counts, "resnet50 training", fused)
    ms = wall / steps * 1e3
    out = dict(config="resnet50", b=RESNET_B, hw=RESNET_HW, dtype="bfloat16",
               fused_norm=fused, last_norm_path=path, lr=RESNET_LR,
               momentum=RESNET_MOMENTUM, warmup_loss=float(loss0),
               losses=losses, ms_per_step=ms,
               images_per_s=RESNET_B / (ms / 1e3),
               model_tflop_per_step=flops / 1e12,
               model_tflops=flops / (ms / 1e3) / 1e12,
               model_flops_share_of_989=flops / (ms / 1e3) / 989e12,
               momentum_ms_per_step=sum(momentum_ms) / steps,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               parameters=sum(p.numel() for p in net.parameters()),
               running_stats_vs_paddle_rule=stats_reading,
               bn_kernels_bound_ms_per_step=bn_bound,
               card_during_steps=clocks.summary(), launches=counts,
               launches_per_step={k: n / steps for k, n in counts.items()},
               bn_fwd_routes=froutes, bn_bwd_routes=broutes)
    return out, net, step


def bn_direction(key):
    """The direction of a fused BN kernel from its name in a profile: the
    persistent backward and the generic one's fold and MODE-1
    instantiations are the backward's; the cluster forward, the MODE-0
    instantiations, the forward's fold and sum_parts (with the generic
    forward forced; with the generic backward forced, its sum_parts counts
    here too) the forward's; None for any other kernel."""
    if "bn_bwd_persist" in key or "bn_fold_bwd" in key:
        return "backward"
    if "bn_fwd_cluster" in key:
        return "forward"
    m = re.search(r"bn_(?:reduce|apply)<[^>]*,\s*(\d)>", key)
    if m:
        return "backward" if m.group(1) == "1" else "forward"
    if "bn_fold_fwd" in key or "sum_parts_kernel" in key:
        return "forward"
    return None


def phase_profile_resnet(torch, step, steps=2):
    """torch.profiler over `steps` steps of a convolutional model (resnet50,
    ppyoloe-l): device busy time per step against the profiled wall time,
    the host's aten calls (nested ones included) and CUDA launches a step,
    the BN kernels' time by direction, the convolutions' (every other
    kernel whose name says conv, gemm or a cuDNN/CUTLASS tile), the
    Momentum span and the kernels that take the time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, dev = {}, []
    events = prof.key_averages()
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.key == "momentum_step":
                spans[e.key] = e.self_device_time_total / 1e3 / steps
            else:
                dev.append(e)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if busy_ms == 0.0:
        return dict(steps=steps, device_time="not measured (no CUDA events)")
    conv_keys = ("conv", "gemm", "xmma", "cudnn", "cutlass", "sm90_",
                 "implicit", "wgrad", "dgrad", "fprop", "nchw", "nhwc")
    groups = {"fused_bn forward": lambda k: bn_direction(k) == "forward",
              "fused_bn backward":
              lambda k: bn_direction(k) == "backward",
              "convolutions and fc (cuDNN, cuBLAS)":
              lambda k: bn_direction(k) is None
              and any(s in k.lower() for s in conv_keys)}
    by_group = {g: sum(e.self_device_time_total for e in dev if f(e.key))
                / 1e3 / steps for g, f in groups.items()}
    by_group["the rest (pooling, copies, casts, the loss, Momentum's ops)"] = (
        busy_ms / steps - sum(by_group.values()))
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)
    bn_fwd_launches = sum(e.count for e in dev
                          if bn_direction(e.key) == "forward")
    aten = sum(e.count for e in events if e.key.startswith("aten::"))
    launches = sum(e.count for e in events
                   if e.key.startswith(("cudaLaunchKernel", "cuLaunch")))
    return dict(steps=steps, wall_ms_per_step=wall_ms / steps,
                device_busy_ms_per_step=busy_ms / steps,
                device_idle_share=1.0 - busy_ms / wall_ms,
                aten_calls_per_step=aten / steps,
                cuda_launches_per_step=launches / steps,
                kernels_ms_per_step=by_group,
                kernels_share_of_busy={g: t * steps / busy_ms
                                       for g, t in by_group.items()},
                bn_forward_kernel_launches_per_step=bn_fwd_launches / steps,
                momentum_span_ms_per_step=spans.get(
                    "momentum_step", "not measured (no momentum_step range)"),
                top_device_ms_per_step=[
                    (e.key[:70], e.self_device_time_total / 1e3 / steps,
                     e.count // steps) for e in top[:16]])


def phase_profile_resnet_turns(torch, step):
    """Phase 29: the resnet50 step's profile (phase_profile_resnet) with
    the BatchNorm kernels on their routes (the cluster forward, the
    persistent backward; the profile's count of forward kernel launches a
    step reported, the route counters checked exactly). Then each
    direction in turns with the generic route's kernels on the same model
    and batch (new, generic, generic, new; for these profiles alone
    bn_bwd_route, then bn_fwd_route, is made to name the generic route):
    the busy time, the direction's kernels a step and the wall of each,
    the better of each pair."""
    from paddle_tpu_torch.kernels import norm_fusion as nf
    directions = (("backward", "bn_bwd_route", "bn_bwd_routes", "persistent"),
                  ("forward", "bn_fwd_route", "bn_fwd_routes", "cluster"))
    out, turns = None, {}
    for direction, attr, counter, new in directions:
        real = getattr(nf, attr)
        turns[direction] = []
        try:
            for route in (new, "generic", "generic", new):
                setattr(nf, attr, real if route == new else (
                    lambda *a: "generic"))
                step()
                before = dict(getattr(nf, counter))
                prof = phase_profile_resnet(torch, step)
                taken = {k: getattr(nf, counter)[k] - before[k]
                         for k in before}
                check(taken[route] == 2 * RESNET_BNS and sum(taken.values())
                      == 2 * RESNET_BNS, f"resnet50 profile on the {route} "
                      f"{direction} took {taken}")
                turns[direction].append((route, prof))
        finally:
            setattr(nf, attr, real)
        if out is None:
            out = dict(turns[direction][0][1])

    def summary(direction, route):
        key = f"fused_bn {direction}"
        profs = [p for r, p in turns[direction] if r == route]
        busy = [p["device_busy_ms_per_step"] for p in profs]
        kern = [p["kernels_ms_per_step"][key] for p in profs]
        wall = [p["wall_ms_per_step"] for p in profs]
        return dict(device_busy_ms_per_step=min(busy),
                    bn_ms_per_step=min(kern), wall_ms_per_step=min(wall),
                    all_busy=busy, all_bn=kern, all_wall=wall)

    if all("kernels_ms_per_step" in p for t in turns.values() for _, p in t):
        out["in_turns"] = {
            direction: {route: summary(direction, route)
                        for route in (new, "generic")}
            | {"order": f"{new}, generic, generic, {new}; 2 profiled steps "
                        f"each; the other direction on its route"}
            for direction, _, _, new in directions}
    return out


def phase_resnet_parity_fp32(torch):
    """fp32 at full width, B=8, 64^2 (the input cut from 224^2): the loss,
    the gradients and the running statistics after one train-mode forward
    and backward with FLAGS_fused_norm on (the BN kernels) and off (the
    dense BatchNorm), from the same weights and buffers, each against the
    dense route in f64. The limit: at this batch and depth the model
    amplifies rounding many times over (BatchNorm at initialisation; on
    the CPU the two packages' dense routes drift from 3.5e-7 after the
    stem to 1.8e-4 after layer 4), so no f32 route is within 1e-4 of
    another leaf by leaf; the kernels' route must lie at most 3x as far
    from the f64 answer as the dense f32 route does: the gradients of all
    leaves as one vector (relative L2), the running statistics (largest
    relative difference) and the loss."""
    import copy

    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.vision.models import resnet50
    net = resnet50(num_classes=RESNET_CLASSES, dtype=torch.float32, seed=1)
    net64 = copy.deepcopy(net).double()
    x, y = resnet_batch(torch, 8, 64, torch.float32, 1)

    def run(model, fused):
        set_flags({"FLAGS_fused_norm": fused})
        reset_launches()
        loss = F.cross_entropy(model(x.to(model.parameters()[0].dtype)),
                               y)
        g = torch.autograd.grad(loss, list(model.parameters()))
        flat = torch.cat([t.double().reshape(-1) for t in g])
        stats = [b.double().clone() for b in model.buffers()]
        return loss.item(), flat, stats, read_launches()

    start = [b.clone() for b in net.buffers()]
    try:
        l64, g64, s64, _ = run(net64, False)
        ld, gd, sd, counts_d = run(net, False)
        with torch.no_grad():
            for b, s in zip(net.buffers(), start):
                b.copy_(s)
        lf, gf, sf, counts = run(net, True)
    finally:
        set_flags({"FLAGS_fused_norm": True})
    check(counts["fused_bn_fwd"] == counts["fused_bn_bwd"] == RESNET_BNS,
          f"resnet50 fp32 parity with the flag on launched {counts}")
    bn_bwd_routes_reading(counts, "resnet50 fp32 parity")
    bn_fwd_routes_reading(counts, "resnet50 fp32 parity")
    check(counts_d["fused_bn_fwd"] == counts_d["fused_bn_bwd"] == 0,
          f"resnet50 fp32 parity with the flag off launched {counts_d}")
    check(bool(torch.isfinite(gf).all()), "parity gradient not finite")

    def stat_err(s):
        return max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-30)
                   for a, b in zip(s, s64))

    factor = 3.0
    readings = dict(
        grads_rel_l2=(float((gf - g64).norm() / g64.norm()),
                      float((gd - g64).norm() / g64.norm())),
        running_stats_rel=(stat_err(sf), stat_err(sd)),
        loss_abs=(abs(lf - l64), abs(ld - l64)))
    for key, (kern, dense) in readings.items():
        check(kern <= factor * dense + 1e-6 * (abs(l64) if key == "loss_abs"
                                               else 1.0),
              f"resnet50 fp32 {key}: the kernels' route {kern} from f64, the "
              f"dense f32 route {dense}: more than {factor}x")
    del net, net64, gf, gd, g64, sf, sd, s64, start
    return dict(b=8, hw=64, loss_fused=lf, loss_dense=ld, loss_f64=l64,
                from_f64={k: dict(kernels=v[0], dense_f32=v[1])
                          for k, v in readings.items()},
                limit=f"the kernels' route within {factor}x the dense f32 "
                      "route's distance from f64",
                leaves=RESNET_LEAVES)


def route_fields(times):
    """A redesigned kernel's extra keys in the kernels' line (the flash
    forward's, the projection-LN's): the route it took and the earlier
    kernel's time on the same inputs, in turns."""
    if "earlier_ms" not in times:
        return {}
    return {"kernel_route": times["route"], "earlier_ms": times["earlier_ms"],
            "earlier": times.get(
                "earlier", "the generic flash_fwd_kernel, same inputs, in "
                "turns")}


def pl_whole_fields(times):
    """The projection-LN backward's extra keys in the kernels' line: the
    whole backward (the kernel and the pair products) on the cluster
    route, the generic route's (f32 products) and the composite's."""
    t = times["whole_backward"]
    return {"whole_backward_ms": t["ms"],
            "whole_backward_earlier_ms": t["earlier_ms"],
            "whole_backward_library_ms": t["library_ms"],
            "whole_backward_bound_ms": t["bound_ms"],
            "note": "ms, plain_ms, bound_ms: the cluster backward kernel "
                    "(dres, the pair, dgamma, dbeta, db); library_ms: the "
                    "composite's whole autograd backward; whole_backward_*: "
                    "the kernel and the pair products"}


def pl_cluster_ptxas(build_log):
    """ptxas -v's lines for each instantiation of the projection-LN's
    cluster kernels (forward and backward, NW = Hout / 4 of 64, 128 and
    192, with and without dropout): none may spill."""
    out, name = {}, None
    for ln in build_log.get("proj_ln.cu", "").splitlines():
        m = re.search(r"Compiling entry function '\S*(proj_ln_(?:fwd|bwd)_"
                      r"cluster_kernel)ILi(\d+)ELb(\d)E", ln)
        if m:
            name = (f"{m.group(1)}<{m.group(2)}, "
                    f"{'true' if m.group(3) == '1' else 'false'}>")
        elif "Compiling entry function" in ln:
            name = None
        elif name and ("spill" in ln or "registers" in ln):
            out.setdefault(name, []).append(ln.strip())
    check(len(out) == 12 or "proj_ln.cu" not in build_log,
          f"ptxas lines for {len(out)} cluster instantiations, want 12")
    for lines in out.values():
        check(not any(re.search(r"[1-9]\d* bytes spill", ln) for ln in lines),
              f"a projection-LN cluster kernel spills: {lines}")
    return out


def wgmma_ptxas(build_log):
    """ptxas -v's lines for each instantiation of the wgmma flash kernels
    (the forward, dQ and dK/dV at D 64 and 128, with and without dropout:
    their registers and spills): no instantiation may spill."""
    out, name = {}, None
    for ln in build_log.get("flash_attention.cu", "").splitlines():
        m = re.search(r"Compiling entry function '\S*(flash_(?:fwd|dq|dkv)_"
                      r"wgmma_kernel)ILi(\d+)ELb(\d)E", ln)
        if m:
            name = (f"{m.group(1)}<{m.group(2)}, "
                    f"{'true' if m.group(3) == '1' else 'false'}>")
        elif "Compiling entry function" in ln:
            name = None
        elif name and ("spill" in ln or "registers" in ln):
            out.setdefault(name, []).append(ln.strip())
    check(len(out) == 12 or "flash_attention.cu" not in build_log,
          f"ptxas lines for {len(out)} wgmma instantiations, want 12")
    for name, lines in out.items():
        check(not any(re.search(r"[1-9]\d* bytes spill", ln) for ln in lines),
              f"{name} spills: {lines}")
    return out


def core_kernel_name(mangled):
    """A GEMM core instantiation's readable name from its mangled one:
    wgmma_gemm_kernel<A MN-major, B MN-major, BN, stages, epilogue[<its
    arguments>][, paired]>, or None for another kernel."""
    m = re.search(r"wgmma_gemm_kernelILb(\d)ELb(\d)ELi(\d+)ELi(\d+)E(\w*?)"
                  r"Lb(\d)EEEv", mangled)
    if m is None:
        return None
    e = re.search(r"(\d+)(Epi\w+)", m.group(5))
    epi = e.group(2)[:int(e.group(1))]
    args = re.match(r"ILb(\d)ENS\w*?\d(Drop|NoDrop)E", e.group(2)[len(epi):])
    if args:
        epi += f"<{args.group(1)}, {args.group(2)}>"
    return (f"wgmma_gemm_kernel<{', '.join(m.group(i) for i in range(1, 5))}"
            f", {epi}{', paired' if m.group(6) == '1' else ''}>")


def mlp_ptxas_lines(log):
    """ptxas -v's register and spill lines of the wgmma kernels in an nvcc
    log of fused_mlp.cu: the backwards' P1 kernels (swiglu_dact_wgmma_kernel,
    gelu_dact_wgmma_kernel; a probe's copy may instantiate the latter per
    form, <0 erf | 1 tanh>) and each GEMM core instantiation
    (core_kernel_name)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"(swiglu_dact_wgmma_kernel|gelu_dact_wgmma_kernel)"
                          r"(?:ILi(\d)E)?", ln)
            name = core_kernel_name(ln) or (m and (
                m.group(1) if m.group(2) is None
                else f"{m.group(1)}<{m.group(2)}>"))
        elif name and ("spill" in ln or "registers" in ln):
            out.setdefault(name, []).append(ln.strip())
    return out


# the wgmma kernels of fused_mlp.cu as mlp_ptxas_lines names them. The
# SwiGLU backward's: P1; the core's P2 with its three epilogues (one
# chunk, the f32 sum's first and middle chunks, the last); P3 / P4 (the
# GeLU backward's P2-P4 share these).
SWIGLU_WGMMA_KERNELS = ("swiglu_dact_wgmma_kernel",
                        "wgmma_gemm_kernel<0, 0, 256, 3, EpiStore>",
                        "wgmma_gemm_kernel<0, 0, 256, 3, EpiSum>",
                        "wgmma_gemm_kernel<0, 0, 256, 3, EpiSumLast>",
                        "wgmma_gemm_kernel<1, 1, 256, 3, EpiStore>")
# the GeLU backward's own: P1 (both forms, read at run time) and the
# core's P3 / P4 at the narrower tile
GELU_WGMMA_KERNELS = ("gelu_dact_wgmma_kernel",
                      "wgmma_gemm_kernel<1, 1, 192, 4, EpiStore>")
# the forwards': the GeLU's P1 and the SwiGLU's (paired); P2's one-chunk
# and last-chunk epilogues with and without the dropout key (GeLU: the
# last at the narrower tile) or bias (SwiGLU: EpiStore, EpiSumLast), the
# f32 sum's first and middle
FWD_WGMMA_KERNELS = tuple(
    f"wgmma_gemm_kernel<0, 1, 192, 4, {e}>" for e in (
        "EpiGelu", "EpiBias<1, NoDrop>", "EpiBias<1, Drop>")) + tuple(
    f"wgmma_gemm_kernel<0, 1, 256, 3, {e}>" for e in (
        "EpiSwiglu, paired", "EpiBias<0, NoDrop>", "EpiBias<0, Drop>",
        "EpiSum", "EpiStore", "EpiSumLast"))


def mlp_wgmma_ptxas(build_log):
    """The ptxas lines of fused_mlp.cu's wgmma kernels by route (the
    three lists above): every kernel the build made listed once, none
    spilling."""
    if "fused_mlp.cu" not in build_log:
        return {}
    lines = mlp_ptxas_lines(build_log["fused_mlp.cu"])
    routes = {"swiglu_backward": SWIGLU_WGMMA_KERNELS,
              "gelu_backward": GELU_WGMMA_KERNELS,
              "forwards": FWD_WGMMA_KERNELS}
    known = {k for names in routes.values() for k in names}
    check(set(lines) == known, f"fused_mlp.cu's wgmma kernels "
          f"{sorted(set(lines) ^ known)} not both built and listed")
    for name, ln in lines.items():
        check(not any(re.search(r"[1-9]\d* bytes spill", x) for x in ln),
              f"{name} spills: {ln}")
    return {route: {k: lines[k] for k in names}
            for route, names in routes.items()}


def route_ptxas(build_log, src, pattern):
    """ptxas -v's register and spill lines of the kernels of ``src`` whose
    mangled names match ``pattern`` (the decode split route's, the
    persistent LayerNorm backward's), by mangled name: none may spill."""
    out, name = {}, None
    for ln in build_log.get(src, "").splitlines():
        if "Compiling entry function" in ln:
            m = re.search(rf"'(\S*(?:{pattern})\S*)'", ln)
            name = m.group(1) if m else None
        elif name and ("spill" in ln or "registers" in ln):
            out.setdefault(name, []).append(ln.strip())
    check(bool(out) or src not in build_log,
          f"no ptxas lines for {pattern} in {src}")
    for key, lines in out.items():
        check(not any(re.search(r"[1-9]\d* bytes spill", ln) for ln in lines),
              f"{key} spills: {lines}")
    return out


# ---------------------------------------------------------------------------
# phases 39-42: LLaMA serving and the serving fast path
# ---------------------------------------------------------------------------

SERVE_POOL = dict(num_blocks=512, block_size=16, max_model_len=1024)
# llama-7b's serving phases (39, 40) at full width and 12 of its 32 layers:
# the depth cut that keeps the whole script within about a minute of its
# length before phases 47-50 (the training phases 16-18 keep all 32)
LLAMA_SERVE_LAYERS = 12
FAST_PREFIX, FAST_TAILS, FAST_CHUNK, SPEC_K = 384, (64, 96, 128, 160), 256, 4


def fast_prompts(vocab, seed=5):
    """The fast path's traffic: a warm request, then 4 that share its
    384-token prefix, each with a distinct tail of 64-160 tokens."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, FAST_PREFIX)
    warm = np.concatenate([prefix, rng.integers(0, vocab, 32)])
    return warm, [np.concatenate([prefix, rng.integers(0, vocab, n)])
                  for n in FAST_TAILS]


def serve_waves(torch, eng, waves, max_new):
    """Submit each wave whole, run it to idle; the requests and the wall
    seconds of the last wave."""
    from paddle_tpu_torch.inference import SamplingParams
    reqs = []
    for wave in waves:
        t0 = time.perf_counter()
        reqs += [eng.submit(p, SamplingParams(max_new_tokens=max_new))
                 for p in wave]
        eng.run_until_idle()
        torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def request_times(reqs):
    return dict(ttft_ms=[(r.t_first_token - r.t_submit) * 1e3 for r in reqs],
                prefill_ms=[(r.t_first_token - r.t_admit) * 1e3
                            for r in reqs],
                ms_per_token=[(r.t_terminal - r.t_first_token) * 1e3
                              / (len(r.tokens) - 1) for r in reqs])


def check_served(reqs, vocab, n_new, what):
    check(all(r.state == "FINISHED" and len(r.tokens) == n_new
              for r in reqs),
          f"{what}: not every request finished with {n_new} tokens")
    check(all(0 <= t < vocab for r in reqs for t in r.tokens),
          f"{what}: token out of vocabulary")


def first_divergence(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def phase_serve_llama_b4(torch, model, device=None):
    """Phase 39; also returns the plain engine's run of the fast path's
    traffic (phase 40's yardstick)."""
    from paddle_tpu_torch.inference import ServingEngine, llama_adapter
    cfg = model.cfg
    eng = ServingEngine(llama_adapter(model), **SERVE_POOL, max_batch=4,
                        device_loop_k=4, device=device)
    rng = np.random.default_rng(0)
    serve_waves(torch, eng, [[rng.integers(0, cfg.vocab_size, 16)]], 4)
    reqs, wall = serve_waves(
        torch, eng, [[rng.integers(0, cfg.vocab_size, n)
                      for n in (128, 256, 384, 512)]], 32)
    st = eng.stats()
    check_served(reqs, cfg.vocab_size, 32, "llama-7b B=4 serving")
    check(st["leaked_blocks"] == 0, f"leaked {st['leaked_blocks']} blocks")
    ntok = sum(len(r.tokens) for r in reqs)
    out = dict(requests=len(reqs), tokens=ntok, windows=st["decode_steps"],
               pool_kv_heads=eng.pool.num_kv_heads,
               leaked_blocks=st["leaked_blocks"], wall_s=wall,
               tokens_per_s=ntok / wall, **request_times(reqs),
               profile=phase_profile_b1(
                   torch, eng, cfg.vocab_size, steps=4, prompts=[
                       rng.integers(0, cfg.vocab_size, n)
                       for n in (128, 256, 384, 512)]))
    warm, shared = fast_prompts(cfg.vocab_size)
    plain, _ = serve_waves(torch, eng, [[warm], shared], 32)
    check_served(plain, cfg.vocab_size, 32, "llama-7b plain fast traffic")
    check(eng.stats()["leaked_blocks"] == 0, "plain engine leaked blocks")
    out["fast_traffic_plain"] = request_times(plain[1:])
    return out, [r.tokens for r in plain]


def chunk_gates(eng, reqs, chunks0, what):
    """Prefix hits, no cached token computed again, and each request's
    chunks as chunk_spans plans its uncached tail."""
    st = eng.stats()
    want = sum(len(chunk_spans_of(r)) for r in reqs)
    hits = st["prefix_cache"]["hits"]
    check(hits >= len(reqs) - 1,
          f"{what}: {hits} prefix hits for {len(reqs) - 1} sharers")
    check(st["prefix_recompute_tokens"] == 0,
          f"{what}: {st['prefix_recompute_tokens']} cached tokens computed "
          f"again")
    check(st["prefill_chunks"] - chunks0 == want,
          f"{what}: {st['prefill_chunks'] - chunks0} chunks, chunk_spans "
          f"plans {want}")
    check(st["leaked_blocks"] == 0 and st.get("draft_leaked_blocks", 0) == 0,
          f"{what}: leaked {st['leaked_blocks']} blocks, "
          f"{st.get('draft_leaked_blocks')} in the draft pool")
    return dict(prefix_hits=hits, prefix_cache=st["prefix_cache"],
                prefix_recompute_tokens=st["prefix_recompute_tokens"],
                prefill_chunks=st["prefill_chunks"] - chunks0,
                chunk_spans_chunks=want,
                reused_tokens=[r.reused_tokens for r in reqs],
                leaked_blocks=st["leaked_blocks"],
                draft_leaked_blocks=st.get("draft_leaked_blocks"))


def chunk_spans_of(req):
    from paddle_tpu_torch.inference import chunk_spans
    return chunk_spans(req.prompt.size - req.reused_tokens, FAST_CHUNK)


def spec_fields(st):
    return dict(spec_verify_steps=st["spec_verify_steps"],
                spec_drafted=st["spec_drafted"],
                spec_accepted=st["spec_accepted"],
                accept_rate=st["spec_accepted"] / max(1, st["spec_drafted"]))


def pool_gb(*pools):
    return sum(p.k.numel() * p.k.element_size() * 2 for p in pools) / 1e9


def phase_serve_llama_fast(torch, model, plain_streams, plain_times,
                           device=None):
    """Phase 40: chunked prefill + prefix cache at max_batch=4, then the
    same with a self-draft at max_batch=1."""
    from paddle_tpu_torch.inference import (ServingEngine, SpeculativeConfig,
                                            llama_adapter)
    cfg = model.cfg
    warm, shared = fast_prompts(cfg.vocab_size)
    eng = ServingEngine(llama_adapter(model), **SERVE_POOL, max_batch=4,
                        device_loop_k=4, prefill_chunk=FAST_CHUNK,
                        prefix_cache=True, device=device)
    reqs, wall = serve_waves(torch, eng, [[warm], shared], 32)
    check_served(reqs, cfg.vocab_size, 32, "llama-7b chunked + prefix")
    fast = dict(chunk_gates(eng, reqs, 0, "llama-7b chunked + prefix"),
                wall_s=wall, **request_times(reqs[1:]),
                first_divergence_from_plain=[
                    first_divergence(r.tokens, t)
                    for r, t in zip(reqs, plain_streams)])
    del eng, reqs
    free_card(torch)
    weights_gb = sum(p.numel() * p.element_size()
                     for p in model.parameters()) / 1e9
    eng = ServingEngine(llama_adapter(model), **SERVE_POOL, max_batch=1,
                        prefill_chunk=FAST_CHUNK, prefix_cache=True,
                        speculative=SpeculativeConfig(llama_adapter(model),
                                                      k=SPEC_K),
                        device=device)
    reqs, wall = serve_waves(torch, eng, [[warm], shared], 32)
    check_served(reqs, cfg.vocab_size, 32, "llama-7b speculative")
    st = eng.stats()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    limit_gb = weights_gb + pool_gb(eng.pool, eng.draft_pool) + 2.0
    check(peak_gb < limit_gb, f"llama-7b speculative peaks at {peak_gb} GB, "
          f"over weights + both pools + 2 GB = {limit_gb}")
    spec = dict(chunk_gates(eng, reqs, 0, "llama-7b speculative"),
                **spec_fields(st), wall_s=wall, **request_times(reqs[1:]),
                peak_memory_gb=peak_gb, memory_limit_gb=limit_gb,
                weights_gb=weights_gb,
                pools_gb=pool_gb(eng.pool, eng.draft_pool),
                first_divergence_from_plain=[
                    first_divergence(r.tokens, t)
                    for r, t in zip(reqs, plain_streams)])
    del eng
    return dict(plain_same_tails=plain_times, chunked_prefix=fast,
                speculative_self_draft=spec)


def phase_serve_gpt_fast(torch, model, device=None):
    """Phase 41: the B=1 speculative draft loop on the decode kernel."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.inference import (ServingEngine, SpeculativeConfig,
                                            gpt_adapter)
    from paddle_tpu_torch.kernels import mlp_fusion as mf
    from paddle_tpu_torch.kernels.mlp_fusion import decode_attn_proj
    cfg = model.cfg
    set_flags({"FLAGS_serving_decode_kernel": True})
    eng = ServingEngine(gpt_adapter(model), **SERVE_POOL, max_batch=1,
                        prefill_chunk=FAST_CHUNK, prefix_cache=True,
                        speculative=SpeculativeConfig(gpt_adapter(model),
                                                      k=SPEC_K),
                        device=device)
    rng = np.random.default_rng(4)
    serve_waves(torch, eng, [[rng.integers(0, cfg.vocab_size, 16)]], 4)
    st0 = eng.stats()
    decode_attn_proj.launches = 0
    for key in mf.decode_routes:
        mf.decode_routes[key] = 0
    warm, shared = fast_prompts(cfg.vocab_size, seed=6)
    reqs, wall = serve_waves(torch, eng, [[warm], shared], 32)
    launches, routes = decode_attn_proj.launches, dict(mf.decode_routes)
    check_served(reqs, cfg.vocab_size, 32, "gpt3-1.3b speculative")
    st = eng.stats()
    rounds = st["spec_verify_steps"] - st0["spec_verify_steps"]
    want = cfg.num_layers * SPEC_K * rounds
    check(rounds > 0 and launches == want,
          f"decode_attn_proj launched {launches} times in {rounds} "
          f"speculative rounds, want {cfg.num_layers} layers x k {SPEC_K} "
          f"x rounds = {want}")
    check(routes == {"split": launches, "generic": 0},
          f"decode_attn_proj calls by route {routes}, want all {launches} "
          f"on the split kernels")
    drafted = st["spec_drafted"] - st0["spec_drafted"]
    accepted = st["spec_accepted"] - st0["spec_accepted"]
    out = dict(chunk_gates(eng, reqs, st0["prefill_chunks"],
                           "gpt3-1.3b speculative"),
               spec_rounds=rounds, kernel_launches=launches,
               kernel_launches_per_round=launches / rounds,
               decode_routes=routes, spec_drafted=drafted,
               spec_accepted=accepted, accept_rate=accepted / max(1, drafted),
               wall_s=wall, **request_times(reqs))
    del eng
    return out


def chunked_last_logits(torch, ad, prompt, device):
    """The last logits row of ``prompt`` prefilled in chunks of
    FAST_CHUNK through ``ad.chunk`` into a pool of its own."""
    from paddle_tpu_torch.inference import BlockPool, chunk_spans
    bs = SERVE_POOL["block_size"]
    width = SERVE_POOL["max_model_len"] // bs
    pool = BlockPool(ad.num_layers, width, bs, ad.num_kv_heads, ad.head_dim,
                     dtype=ad.dtype, device=device)
    pool.alloc("r", pool.blocks_needed(len(prompt)))
    table = torch.as_tensor(pool.block_table("r", width),
                            device=pool.device)[None]
    for s0, e in chunk_spans(len(prompt), FAST_CHUNK):
        ids = torch.as_tensor(prompt[s0:e], dtype=torch.int32,
                              device=pool.device)[None]
        pos = torch.arange(s0, e, dtype=torch.int32, device=pool.device)[None]
        slots = torch.as_tensor(pool.slots_for("r", s0, e),
                                device=pool.device)[None]
        logits, pool.k, pool.v = ad.chunk(ad.params, pool.k, pool.v, ids, pos,
                                          slots, table, bs)
    return logits[0, -1]


def phase_fastpath_parity_fp32(torch, device=None):
    """Phase 42: f32 at full width, 2 layers: four engines, one stream."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.inference import (ServingEngine, SpeculativeConfig,
                                            gpt_adapter, llama_adapter)
    from paddle_tpu_torch.models import gpt, llama
    set_flags({"FLAGS_serving_decode_kernel": False})
    out = {}
    for name, build, adapter in (
            ("llama-7b", lambda: llama.LlamaForCausalLM(
                llama.CONFIGS["llama-7b"]._replace(num_hidden_layers=2),
                seed=1, dtype=torch.float32, device=device), llama_adapter),
            ("gpt3-1.3b", lambda: gpt.GPTForCausalLM(
                gpt.CONFIGS["gpt3-1.3b"]._replace(num_layers=2,
                                                  dtype=torch.float32),
                seed=1, device=device), gpt_adapter)):
        model = build()
        vocab = model.cfg.vocab_size
        warm, shared = fast_prompts(vocab, seed=7)
        waves = [[warm], shared[:3]]
        streams, stats = {}, {}
        for kind, kw in (
                ("plain", dict(max_batch=4)),
                ("chunked", dict(max_batch=4, prefill_chunk=FAST_CHUNK)),
                ("prefix", dict(max_batch=4, prefix_cache=True)),
                ("speculative", dict(max_batch=4, speculative=(
                    SpeculativeConfig(adapter(model), k=SPEC_K))))):
            eng = ServingEngine(adapter(model), **SERVE_POOL, **kw,
                                device=device)
            reqs, _ = serve_waves(torch, eng, waves, 16)
            check_served(reqs, vocab, 16, f"{name} fp32 {kind}")
            st = eng.stats()
            check(st["leaked_blocks"] == 0
                  and st.get("draft_leaked_blocks", 0) == 0,
                  f"{name} fp32 {kind}: leaked blocks")
            streams[kind] = [r.tokens for r in reqs]
            stats[kind] = dict(
                prefix_hits=st.get("prefix_cache", {}).get("hits"),
                prefill_chunks=st["prefill_chunks"],
                prefix_recompute_tokens=st["prefix_recompute_tokens"],
                **(spec_fields(st) if kind == "speculative" else {}))
            del eng
        same = {k: v == streams["plain"] for k, v in streams.items()}
        where = {k: [first_divergence(a, b)
                     for a, b in zip(v, streams["plain"])]
                 for k, v in streams.items()}
        check(all(same.values()),
              f"{name} fp32: greedy streams differ from the plain engine's "
              f"at {where}")
        check(stats["prefix"]["prefix_hits"] >= len(shared[:3]),
              f"{name} fp32: prefix engine hit {stats['prefix']}")
        ad = adapter(model)
        prompt = np.concatenate([shared[0], warm])[:600]
        ids = torch.as_tensor(prompt, dtype=torch.int32,
                              device=ad.device)[None]
        whole, _, _ = ad.prefill(ad.params, ids,
                                 torch.tensor([len(prompt)],
                                              device=ad.device))
        chunked = chunked_last_logits(torch, ad, prompt, ad.device)
        scale = float(whole.abs().max())
        diff = float((chunked - whole[0]).abs().max())
        check(bool(torch.isfinite(chunked).all()) and diff <= 2e-5 * scale,
              f"{name} fp32: chunked prefill's last logits differ by {diff} "
              f"> 2e-5 x {scale}")
        out[name] = dict(same_streams=same, tokens=sum(map(len,
                                                           streams["plain"])),
                         engines=stats, chunked_vs_whole_max_abs_diff=diff,
                         max_abs_logit=scale, tolerance=2e-5 * scale)
        del model, ad, whole, chunked
        free_card(torch)
    return out


# ---------------------------------------------------------------------------
# phases 43-46: PP-YOLOE: the mixed-size eval stream of bench.py's
# bench_ppyoloe (ppyoloe-s), detector training (ppyoloe-l) on the fused
# BatchNorm kernels (15-18), the kernels at its shapes, f32 parity
# ---------------------------------------------------------------------------

PPYOLOE_LADDER = (448, 512, 576, 640)                  # bench.py:782
PPYOLOE_SIZES = (416, 480, 512, 544, 576, 608, 640)    # bench.py:820
PPYOLOE_IMAGES, PPYOLOE_BUCKET_REPS = 48, 24           # bench.py:762, :848
PPYOLOE_B, PPYOLOE_HW = 8, 640
PPYOLOE_GTS, PPYOLOE_PADDED = 8, 2       # gt boxes an image, then padding
PPYOLOE_LR, PPYOLOE_MOMENTUM, PPYOLOE_DECAY = 0.01, 0.9, 5e-4
PPYOLOE_STEPS, PPYOLOE_TURN_STEPS = 8, 5
# ConvBNLayers a forward: ppyoloe-l 2 stem + 3 x (1 + 6 CSP) + 6 neck + 6
# head; ppyoloe-s the same with one block a CSP stage, 3 x (1 + 4)
PPYOLOE_BNS = {"ppyoloe-l": 35, "ppyoloe-s": 29}
# (name, C, HW, relu, residual) at N = 8, 640^2: the stem's first BN
# (320^2), the stride-8 level (80^2) and the last stage (20^2); no
# residual, no ReLU (the SiLU follows outside the kernels)
PPYOLOE_BN_CASES = [("stem", 32, 102400, False, False),
                    ("stride8", 128, 6400, False, False),
                    ("stage3", 512, 400, False, False)]
PPYOLOE_KEEP_TOP_K = 100
PPYOLOE_PP_HW = 640                  # post_process: k = M = 8400 boxes
PPYOLOE_PARITY_B, PPYOLOE_PARITY_HW = 2, 256


def ppyoloe_stream(torch, ladder, n=PPYOLOE_IMAGES, seed=0):
    """bench.py:819-826's stream on the card: sizes drawn by
    np.random.default_rng(seed).choice over PPYOLOE_SIZES, then one
    standard_normal image for each distinct size (in sorted order, from
    the same generator), zero-padded to its bucket by pad_spatial_nchw."""
    from paddle_tpu_torch.inference.batching import pad_spatial_nchw
    rng = np.random.default_rng(seed)
    sizes = rng.choice(list(PPYOLOE_SIZES), size=n)
    imgs = {}
    for s in sorted(set(sizes)):
        img = rng.standard_normal((1, 3, s, s)).astype(np.float32)
        imgs[int(s)] = torch.from_numpy(
            pad_spatial_nchw(img, ladder.bucket_for(s))).cuda()
    return [int(s) for s in sizes], imgs


def chained_ms(torch, eval_step, xs):
    """Host ms an image of eval_step over xs, every output's mean folded
    into one accumulator read once at the end (bench.py:828-845): the
    window holds every execution, with one sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tot = None
    for x in xs:
        scores, _ = eval_step(x)
        m = scores.mean()
        tot = m if tot is None else tot + m
    float(tot)
    return (time.perf_counter() - t0) * 1e3 / len(xs)


def check_detections(torch, scores, boxes, hw, nc, what):
    """Finite scores in [0, 1] of [B, P, nc] and finite boxes of [B, P, 4]
    with x2 >= x1, y2 >= y1 (the softplus distances), P from the strides."""
    p = sum((hw // s) ** 2 for s in (8, 16, 32))
    check(tuple(scores.shape[1:]) == (p, nc)
          and tuple(boxes.shape[1:]) == (p, 4),
          f"{what}: scores {tuple(scores.shape)}, boxes {tuple(boxes.shape)}")
    check(bool(torch.isfinite(scores).all() & torch.isfinite(boxes).all()),
          f"{what}: outputs not finite")
    check(bool(((scores >= 0) & (scores <= 1)).all()),
          f"{what}: scores outside [0, 1]")
    check(bool((boxes[..., 2] >= boxes[..., 0]).all()
               & (boxes[..., 3] >= boxes[..., 1]).all()),
          f"{what}: a box with x2 < x1 or y2 < y1")


def profile_window(torch, fn, units):
    """torch.profiler over fn() (``units`` images or steps): device busy
    ms, wall ms, idle share, the host's aten calls (nested ones included)
    and CUDA launches, each per unit, and the ten costliest kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if busy_ms == 0.0:
        return dict(units=units, device_time="not measured (no CUDA events)")
    aten = sum(e.count for e in events if e.key.startswith("aten::"))
    launches = sum(e.count for e in events
                   if e.key.startswith(("cudaLaunchKernel", "cuLaunch")))
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)
    return dict(units=units, wall_ms_per_unit=wall_ms / units,
                device_busy_ms_per_unit=busy_ms / units,
                device_idle_share=1.0 - busy_ms / wall_ms,
                aten_calls_per_unit=aten / units,
                cuda_launches_per_unit=launches / units,
                top_device_ms_per_unit=[
                    (e.key[:70], e.self_device_time_total / 1e3 / units,
                     e.count / units) for e in top[:10]])


def phase_ppyoloe_eval_stream(torch):
    """bench.py:762-884's protocol on the card, eagerly under
    torch.no_grad() (jit.to_static is ROADMAP A9): ppyoloe-s (random
    weights from seed 0, f32, eval mode: the dense eval BatchNorm, no
    kernel of the port) at B=1 over the 48-image mixed-size stream on the
    ladder [448, 512, 576, 640]: each bucket's first call (cuDNN's
    algorithm choice: the reference's compile), every distinct image's
    outputs checked, the stream twice, chained through one accumulator
    and synced once; each bucket's steady ms over 24 chained repetitions;
    the bucket-mix expectation and stream_vs_bucket_agreement; a profiled
    pass of the stream (busy, idle, aten calls and CUDA launches an
    image); then post_process (matrix NMS over 8400 boxes and 80 classes)
    on one 640^2 image."""
    from paddle_tpu_torch.inference.batching import BucketLadder
    from paddle_tpu_torch.models import ppyoloe
    from paddle_tpu_torch.vision.ops import matrix_nms
    ladder = BucketLadder(PPYOLOE_LADDER)
    buckets = list(ladder)
    cfg = ppyoloe.CONFIGS["ppyoloe-s"]
    net = ppyoloe.PPYOLOE(cfg, seed=0)
    net.eval()

    def eval_step(x):
        with torch.no_grad():
            return net(x)

    t0 = time.perf_counter()
    for b in buckets:
        scores, _ = eval_step(torch.zeros(1, 3, b, b, device="cuda"))
    float(scores.ravel()[0])
    first_call_s = time.perf_counter() - t0
    sizes, imgs = ppyoloe_stream(torch, ladder)
    for s, x in imgs.items():
        scores, boxes = eval_step(x)
        check_detections(torch, scores, boxes, ladder.bucket_for(s),
                         cfg.num_classes, f"ppyoloe-s eval at {s}^2")
    stream = [imgs[s] for s in sizes]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    passes = [chained_ms(torch, eval_step, stream) for _ in range(2)]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = read_launches()
    check(not any(counts.values()), f"the eval stream launched {counts}")
    per_bucket = {}
    for b in buckets:
        x = torch.zeros(1, 3, b, b, device="cuda")
        eval_step(x)
        per_bucket[str(b)] = chained_ms(torch, eval_step,
                                        [x] * PPYOLOE_BUCKET_REPS)
    mix_ms = float(np.mean([per_bucket[str(ladder.bucket_for(s))]
                            for s in sizes]))
    dt = min(passes)
    prof = profile_window(torch, lambda: chained_ms(torch, eval_step, stream),
                          len(stream))
    # post_process on one 640^2 image: the forward, then matrix NMS over
    # every box (k = M = 8400) and 80 classes
    g = torch.Generator(device="cuda").manual_seed(7)
    hw = PPYOLOE_PP_HW
    x640 = torch.randn(1, 3, hw, hw, generator=g, device="cuda")
    with torch.no_grad():
        rows, n = net.post_process(x640, keep_top_k=PPYOLOE_KEEP_TOP_K)
        scores, boxes = net(x640)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
        pp_ms, nms_ms = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            rows, n = net.post_process(x640, keep_top_k=PPYOLOE_KEEP_TOP_K)
            int(n)
            pp_ms.append((time.perf_counter() - t0) * 1e3)
        pp_peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
        for _ in range(5):
            t0 = time.perf_counter()
            _, n2 = matrix_nms(boxes[0], scores[0].transpose(0, 1),
                               score_threshold=0.3, post_threshold=0.3,
                               keep_top_k=PPYOLOE_KEEP_TOP_K)
            int(n2)
            nms_ms.append((time.perf_counter() - t0) * 1e3)
    k = scores.shape[1]
    count = int(n)
    check(rows.shape == (PPYOLOE_KEEP_TOP_K, 6) and 0 < count
          <= PPYOLOE_KEEP_TOP_K and bool(torch.isfinite(rows).all())
          and bool(((rows[:count, 0] >= 0)
                    & (rows[:count, 0] < cfg.num_classes)).all())
          and bool((rows[count:] == 0).all()),
          f"post_process at {hw}^2: rows {tuple(rows.shape)}, count {count}")
    out = dict(config="ppyoloe-s", dtype="float32",
               allow_tf32=torch.backends.cuda.matmul.allow_tf32,
               cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
               mode="eager, eval, torch.no_grad(), B=1",
               parameters=sum(p.numel() for p in net.parameters()),
               buckets=buckets, images=len(sizes),
               images_per_bucket={str(b): sum(ladder.bucket_for(s) == b
                                              for s in sizes)
                                  for b in buckets},
               first_call_per_bucket_s=first_call_s,
               eval_ms_per_image=dt, images_per_s=1e3 / dt,
               pass_ms_per_image=passes, per_bucket_steady_ms=per_bucket,
               bucket_reps=PPYOLOE_BUCKET_REPS,
               bucket_mix_expected_ms=mix_ms,
               stream_vs_bucket_agreement=dt / mix_ms,
               sync="dependency-chained, one sync a pass",
               peak_memory_gb=peak_gb, kernel_launches=counts,
               profile_of_one_pass=prof,
               post_process=dict(
                   image=hw, boxes=k, classes=cfg.num_classes,
                   ms=min(pp_ms), all_ms=pp_ms, matrix_nms_ms=min(nms_ms),
                   detections=count, keep_top_k=PPYOLOE_KEEP_TOP_K,
                   peak_above_weights_and_input_gb=pp_peak_gb,
                   kk_f32_tensor_gb=k * k * 4 / 1e9,
                   kk2_f32_tensor_gb=k * k * 8 / 1e9,
                   # lt, rb, rb - lt and wh live at once: 4 [k, k, 2]
                   reckoned_nms_peak_gb=4 * k * k * 8 / 1e9))
    del net, imgs, stream
    return out


def ppyoloe_batch(torch, b, hw, seed):
    """One fixed detection batch from the seed: images N(0, 1);
    PPYOLOE_GTS gt boxes an image inside it (top-left corners in the first
    three quarters, sides 16 px to half the image, clipped to it), labels
    in [0, 80); then PPYOLOE_PADDED padding rows (the whole image,
    label -1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, 3, hw, hw, generator=g, device="cuda")
    xy = torch.rand(b, PPYOLOE_GTS, 2, generator=g, device="cuda") * (
        hw * 0.75)
    wh = 16 + torch.rand(b, PPYOLOE_GTS, 2, generator=g, device="cuda") * (
        hw * 0.5 - 16)
    real = torch.cat([xy, torch.clamp(xy + wh, max=float(hw))], -1)
    pad = torch.tensor([0.0, 0.0, hw, hw], device="cuda").expand(
        b, PPYOLOE_PADDED, 4)
    labels = torch.randint(0, 80, (b, PPYOLOE_GTS + PPYOLOE_PADDED),
                           generator=g, device="cuda")
    labels[:, PPYOLOE_GTS:] = -1
    return x, torch.cat([real, pad], 1), labels


def ppyoloe_trainer(torch, name, b, hw, seed=0):
    """The user's loop: PPYOLOE(CONFIGS[name]) on the card in f32,
    Momentum(0.01, momentum=0.9, weight_decay=5e-4) over its parameters
    (PaddleDetection's PP-YOLOE recipe), model.loss(images, gt_boxes,
    gt_labels) → backward → step → clear_grad on one fixed batch. Returns
    (net, step); step() → (loss, the CUDA events around the Momentum
    update)."""
    from paddle_tpu_torch.models import ppyoloe
    from paddle_tpu_torch.optimizer import Momentum
    net = ppyoloe.PPYOLOE(ppyoloe.CONFIGS[name], seed=seed)
    opt = Momentum(learning_rate=PPYOLOE_LR, momentum=PPYOLOE_MOMENTUM,
                   weight_decay=PPYOLOE_DECAY, parameters=net.parameters())
    x, boxes, labels = ppyoloe_batch(torch, b, hw, seed)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def step():
        loss = net.loss(x, boxes, labels)
        loss.backward()
        ev[0].record()
        with torch.profiler.record_function("momentum_step"):
            opt.step()
        ev[1].record()
        opt.clear_grad()
        return loss.detach(), ev

    return net, step


def timed_steps(torch, step, steps):
    """`steps` steps on the host clock, synced at the end: (ms a step,
    the losses, the Momentum update's device ms a step)."""
    losses, momentum_ms = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, ev = step()
        losses.append(loss)
        ev[1].synchronize()
        momentum_ms.append(ev[0].elapsed_time(ev[1]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return ms, [float(v) for v in losses], sum(momentum_ms) / steps


def phase_train_ppyoloe(torch):
    """Train ppyoloe-l (random weights from a seed, f32, full width and
    depth) at B=8, 640^2 on one fixed synthetic batch: one warm-up step
    (its running statistics held to Paddle's rule, its batch statistics
    from the fused route), then 8 steps: finite losses, the last below the
    warm-up's; exactly 35 fused_bn_fwd and 35 fused_bn_bwd op calls a
    step (one per ConvBNLayer, counted in the model) and no other kernel;
    ms a step, images/s, model TFLOP/s (convolutions from the shapes, x3),
    peak memory, the BN kernels' summed bound and the card's clocks; then
    the dense yardstick (FLAGS_fused_norm off) in turns with the fused
    step on the same model (fused, dense, dense, fused; 5 timed steps a
    turn after one untimed), then a profile of 2 dense steps and of 2
    fused ones."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.models.ppyoloe import ConvBNLayer
    from paddle_tpu_torch.nn.functional import last_norm_path
    name = "ppyoloe-l"
    set_flags({"FLAGS_fused_norm": True})
    net, step = ppyoloe_trainer(torch, name, PPYOLOE_B, PPYOLOE_HW)
    bns = sum(isinstance(m, ConvBNLayer) for m in net.modules())
    check(bns == PPYOLOE_BNS[name], f"{name} has {bns} ConvBNLayers, want "
          f"{PPYOLOE_BNS[name]}")
    flops = resnet_flops_per_image(torch, net, PPYOLOE_HW) * PPYOLOE_B * 3
    with BnRecorder() as rec:
        loss0, _ = step()
    stats_reading = rec.running_stats_reading(torch, bns)
    bn_bound = rec.bound_ms(4)
    del rec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with ClockSampler() as clocks:
        ms, losses, momentum_ms = timed_steps(torch, step, PPYOLOE_STEPS)
    counts = read_launches()
    path = last_norm_path()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss0 = float(loss0)
    check(all(np.isfinite(losses)) and np.isfinite(loss0),
          f"{name} loss not finite: {loss0}, {losses}")
    check(losses[-1] < loss0, f"{name} loss did not fall: {loss0} -> "
          f"{losses}")
    check(path == "fused_bn/cuda", f"{name} took the norm path {path}")
    for key, n in counts.items():
        want = bns * PPYOLOE_STEPS if key.startswith("fused_bn") else 0
        check(n == want, f"{key} launched {n} times in {PPYOLOE_STEPS} "
              f"{name} steps (want {want})")
    broutes = bn_bwd_routes_reading(counts, f"{name} training")
    froutes = bn_fwd_routes_reading(counts, f"{name} training")
    turns = []
    for fused in (True, False, False, True):
        set_flags({"FLAGS_fused_norm": fused})
        step()
        reset_launches()
        t_ms, t_losses, _ = timed_steps(torch, step, PPYOLOE_TURN_STEPS)
        t_counts = read_launches()
        want = bns * PPYOLOE_TURN_STEPS if fused else 0
        check(t_counts["fused_bn_fwd"] == t_counts["fused_bn_bwd"] == want
              and last_norm_path() == ("fused_bn/cuda" if fused else "dense")
              and all(np.isfinite(t_losses)),
              f"{name} turn fused={fused}: {t_counts}, {last_norm_path()}, "
              f"{t_losses}")
        turns.append(dict(fused_norm=fused, ms_per_step=t_ms,
                          losses=t_losses))
    fused_ms = min(turns[0]["ms_per_step"], turns[3]["ms_per_step"])
    dense_ms = min(turns[1]["ms_per_step"], turns[2]["ms_per_step"])
    set_flags({"FLAGS_fused_norm": False})
    dense_prof = phase_profile_resnet(torch, step)
    check(last_norm_path() == "dense", "the dense profile took the norm "
          f"path {last_norm_path()}")
    set_flags({"FLAGS_fused_norm": True})
    from paddle_tpu_torch.kernels import norm_fusion as nf
    before = dict(nf.bn_fwd_routes)
    prof = phase_profile_resnet(torch, step)
    taken = {k: nf.bn_fwd_routes[k] - before[k] for k in before}
    check(taken == {"cluster": bns * prof["steps"], "generic": 0},
          f"{name} profile: BN forward calls by route {taken}, want "
          f"{bns} a step on the cluster kernel (one launch each)")
    out = dict(config=name, b=PPYOLOE_B, hw=PPYOLOE_HW, dtype="float32",
               allow_tf32=torch.backends.cuda.matmul.allow_tf32,
               cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
               gts_per_image=PPYOLOE_GTS, padded_rows=PPYOLOE_PADDED,
               optimizer=dict(name="Momentum", lr=PPYOLOE_LR,
                              momentum=PPYOLOE_MOMENTUM,
                              weight_decay=PPYOLOE_DECAY),
               last_norm_path=path, conv_bn_layers=bns,
               warmup_loss=loss0, losses=losses, ms_per_step=ms,
               images_per_s=PPYOLOE_B / (ms / 1e3),
               model_tflop_per_step=flops / 1e12,
               model_gflop_per_image_forward=flops / 3 / PPYOLOE_B / 1e9,
               model_tflops=flops / (ms / 1e3) / 1e12,
               model_flops_share_of_67_f32=flops / (ms / 1e3) / 67e12,
               momentum_ms_per_step=momentum_ms, peak_memory_gb=peak_gb,
               parameters=sum(p.numel() for p in net.parameters()),
               running_stats_vs_paddle_rule=stats_reading,
               bn_kernels_bound_ms_per_step=bn_bound,
               card_during_steps=clocks.summary(), launches=counts,
               launches_per_step={k: n / PPYOLOE_STEPS
                                  for k, n in counts.items()},
               bn_fwd_routes=froutes, bn_bwd_routes=broutes,
               in_turns=dict(turns=turns, fused_ms_per_step=fused_ms,
                             dense_ms_per_step=dense_ms,
                             dense_over_fused=dense_ms / fused_ms),
               profile=prof, dense_profile=dense_prof)
    del net, step
    return out


def phase_ppyoloe_bn_vs_plain(torch):
    """Kernels 15-18 through their custom ops against their plain versions
    at PP-YOLOE's shapes (PPYOLOE_BN_CASES, N=8: no residual, no ReLU), f32
    and bf16, with phase 27's per-case checks (bn_cases_vs_plain); then
    the stem's shape timed in f32 (the training path's dtype) beside the
    plain versions, the bound and F.batch_norm with its autograd
    backward."""
    from paddle_tpu_torch.kernels import norm_fusion as nf
    out = bn_cases_vs_plain(torch, nf, PPYOLOE_BN_CASES, PPYOLOE_B)
    _, c, hw, relu, res = PPYOLOE_BN_CASES[0]
    out.update(wrong_kernel_reading=bn_check_rejects(
        torch, nf, PPYOLOE_B, c, hw, torch.float32, relu, res))
    out["times"] = {"stem_f32": bn_times(torch, nf, c, hw, res, n=PPYOLOE_B,
                                         dtype="float32", relu=relu)}
    out["shapes"] = bn_shape_times(torch, nf, PPYOLOE_BN_CASES[:1],
                                   PPYOLOE_B, torch.float32)
    out["host_us_per_call"] = {
        "stem_f32": bn_host_times(torch, nf, PPYOLOE_B, c, hw, "float32",
                                  relu, res),
        "layer1.bn3_bf16": bn_host_times(torch, nf, BN_N, 256, 3136,
                                         "bfloat16", True, True)}
    return out


def bn_host_times(torch, nf, n, c, hw, dtype, relu, res):
    """The backward's host time a call (bn_host_us: 200 calls, no sync):
    the op (custom-op dispatch, the wrapper, the persistent kernel, the
    casts of dw and db) and the op's body on each route (the wrapper and
    the casts, no dispatch)."""
    x = bn_inputs(torch, n, c, hw, getattr(torch, dtype), 43, res)
    xx, r, w, b, g = (x[k] for k in ("x", "res", "w", "b", "g"))
    _, mean, var = nf.fused_bn_fwd(xx, r, w, b, BN_EPS, relu)

    def body(route):
        def fn():
            _, _, dw, db = nf._bn_bwd_cuda(xx, r, w, b, mean, var, g, None,
                                           None, BN_EPS, relu, route=route)
            return dw.to(w.dtype, copy=True), db.to(b.dtype, copy=True)
        return fn

    out = dict(op=bn_host_us(torch, lambda: nf.fused_bn_bwd(
        xx, r, w, b, mean, var, g, None, None, BN_EPS, relu)),
        persistent=bn_host_us(torch, body("persistent")),
        generic=bn_host_us(torch, body("generic")),
        shape=[n, c, hw], calls=200,
        note="us a call: op = the custom op on the persistent route; "
             "persistent, generic = the op's body on each route")
    del x, xx, r, w, b, g, mean, var
    torch.cuda.empty_cache()
    return out


def ppyoloe_readings(torch, name, state, batch, dev, dtype, fused=True):
    """One run of the parity protocol on ``dev`` in ``dtype`` from the
    given weights, FLAGS_fused_norm as ``fused`` says: the train-mode
    loss, every gradient and the running statistics after it, the
    parameters and statistics after one Momentum step, then the eval
    scores and boxes and post_process of the first image; with the kernel
    counts and the norm path."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.models import ppyoloe
    from paddle_tpu_torch.nn.functional import last_norm_path
    from paddle_tpu_torch.optimizer import Momentum
    set_flags({"FLAGS_fused_norm": fused})
    net = ppyoloe.PPYOLOE(ppyoloe.CONFIGS[name], device=dev,
                          dtype=dtype).load_numpy(state)
    x, boxes, labels = (t.to(dev) for t in batch)
    x, boxes = x.to(dtype), boxes.to(dtype)
    opt = Momentum(learning_rate=PPYOLOE_LR, momentum=PPYOLOE_MOMENTUM,
                   weight_decay=PPYOLOE_DECAY, parameters=net.parameters())
    reset_launches()
    loss = net.loss(x, boxes, labels)
    loss.backward()
    path = last_norm_path()
    out = dict(loss=loss.item(), path=path)
    out["grads"] = {n: p.grad.detach().double().cpu()
                    for n, p in net.named_parameters()}
    out["stats"] = {n: b.detach().double().cpu()
                    for n, b in net.named_buffers()}
    opt.step()
    opt.clear_grad()
    out["state"] = {n: t.detach().double().cpu()
                    for n, t in net.state_dict().items()}
    net.eval()
    with torch.no_grad():
        scores, boxes_out = net(x)
        rows, n = net.post_process(x[:1])
    out["launches"] = read_launches()
    set_flags({"FLAGS_fused_norm": True})
    out.update(scores=scores.double().cpu(), boxes=boxes_out.double().cpu(),
               rows=rows.double().cpu(), count=int(n))
    return out


def phase_ppyoloe_parity_fp32(torch):
    """f32 parity at ppyoloe-s's full width on 2 images of 256^2 (TF32
    off): the card (the BN kernels: 29 + 29 calls) against the port's CPU
    route (the kernels' plain versions) from the same weights and batch,
    each against the port's f64 route on the CPU (the dense BatchNorm).
    The card's convolutions are cuDNN's, the CPU's oneDNN's, so the yard
    is the larger of the two f32 routes' own distances from f64 that do
    not run the kernels: the CPU's and the card's dense BatchNorm
    (FLAGS_fused_norm off). As in phase 31: each reading of the card's
    kernels, against the CPU and against f64, within 3x that yard plus
    1e-6 of the reading's scale: the loss, every gradient as one vector
    (relative L2), the running statistics after the forward and the
    parameters and statistics after one Momentum step (largest relative
    difference per tensor), the eval scores and boxes (largest
    difference), post_process's rows; its count and classes exactly."""
    import warnings
    name = "ppyoloe-s"
    from paddle_tpu_torch.models import ppyoloe
    net = ppyoloe.PPYOLOE(ppyoloe.CONFIGS[name], seed=1, device="cpu")
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    del net
    batch = [t.cpu() for t in ppyoloe_batch(torch, PPYOLOE_PARITY_B,
                                            PPYOLOE_PARITY_HW, 1)]
    card = ppyoloe_readings(torch, name, state, batch, "cuda", torch.float32)
    dense = ppyoloe_readings(torch, name, state, batch, "cuda",
                             torch.float32, fused=False)
    cpu = ppyoloe_readings(torch, name, state, batch, "cpu", torch.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # f64 takes the dense BN
        f64 = ppyoloe_readings(torch, name, state, batch, "cpu",
                               torch.float64)
    bns = PPYOLOE_BNS[name]
    check(card["path"] == "fused_bn/cuda" and cpu["path"] == "fused_bn/plain"
          and card["launches"]["fused_bn_fwd"] == bns
          and card["launches"]["fused_bn_bwd"] == bns
          and dense["path"] == "dense"
          and not any(cpu["launches"].values())
          and not any(dense["launches"].values()),
          f"{name} parity routes: card {card['path']} {card['launches']}, "
          f"card dense {dense['path']} {dense['launches']}, cpu "
          f"{cpu['path']} {cpu['launches']}")

    def rel_l2(a, b):
        fa = torch.cat([a[n].reshape(-1) for n in sorted(b)])
        fb = torch.cat([b[n].reshape(-1) for n in sorted(b)])
        return float((fa - fb).norm() / fb.norm())

    def worst(a, b):
        return max(float((a[n] - b[n]).abs().max())
                   / max(float(b[n].abs().max()), 1e-30) for n in b)

    def maxdiff(a, b):
        return float((a - b).abs().max())

    readings = {}
    for key, fn, scale in (
            ("loss", lambda a, b: abs(a - b), abs(f64["loss"])),
            ("grads", rel_l2, 1.0), ("stats", worst, 1.0),
            ("state", worst, 1.0),
            ("scores", maxdiff, float(f64["scores"].abs().max())),
            ("boxes", maxdiff, float(f64["boxes"].abs().max())),
            ("rows", maxdiff, float(f64["rows"].abs().max()))):
        yard = dict(cpu_vs_f64=fn(cpu[key], f64[key]),
                    card_dense_vs_f64=fn(dense[key], f64[key]))
        floor = max(yard.values())
        got = dict(card_vs_cpu=fn(card[key], cpu[key]),
                   card_vs_f64=fn(card[key], f64[key]), **yard,
                   limit=3.0 * floor + 1e-6 * scale)
        for k in ("card_vs_cpu", "card_vs_f64"):
            check(got[k] <= got["limit"], f"{name} fp32 parity {key}: "
                  f"{k} {got[k]} > {got['limit']} (3x the f32 routes' "
                  f"f32-against-f64 {yard})")
        readings[key] = got
    check(card["count"] == cpu["count"] == dense["count"] == f64["count"] > 0
          and torch.equal(card["rows"][:, 0], cpu["rows"][:, 0]),
          f"{name} post_process: counts {card['count']}, {cpu['count']}, "
          f"{f64['count']}; classes equal "
          f"{torch.equal(card['rows'][:, 0], cpu['rows'][:, 0])}")
    for r in (card, cpu):
        check(all(bool(torch.isfinite(g).all()) for g in r["grads"].values()),
              f"{name} parity gradient not finite")
    return dict(config=name, b=PPYOLOE_PARITY_B, hw=PPYOLOE_PARITY_HW,
                dtype="float32",
                allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                loss=dict(card=card["loss"], card_dense=dense["loss"],
                          cpu=cpu["loss"], f64=f64["loss"]),
                readings=readings, detections=card["count"],
                card_launches={k: v for k, v in card["launches"].items()
                               if v},
                limit="each reading of the card's kernels within 3x the "
                      "larger of the CPU's and the card's dense route's "
                      "f32-against-f64 readings + 1e-6 of its scale; the "
                      "detection count and classes exactly")


# ---------------------------------------------------------------------------
# mixed precision (amp/): phases 47-50 and the BatchNorm kernels with bf16
# weight and bias
# ---------------------------------------------------------------------------

AMP_STEPS = 5
AMP_BERT_B, AMP_BERT_S, AMP_BERT_LR = 64, 512, 1e-4


def bn_bf16_vectors(torch, nf):
    """The BatchNorm ops with bf16 weight and bias (what AMP's white
    ``fused_bn_train`` hands the kernels at O2) at layer 1's bn3 and the
    stem, bf16 x: y, mean, var, dx, dres, dw, db against the plain
    versions within BN_TOL / BN_STAT_TOL; bitwise equal to the same call
    with the vectors' values in f32 (the kernels read a bf16 vector as
    f32); dw and db come back bf16; one launch a forward call and one
    launch and one memset a backward call (no conversion launch); each
    op's device time in turns with the f32-vector call; the planted
    faults (rank 0 folding without the last rank's partial, the
    backward's folds without block 0's partial) rejected."""
    bf = torch.bfloat16
    out = {}
    for case, c, hw, relu, has_res in (BN_CASES[1], BN_CASES[0]):
        x = bn_inputs(torch, BN_N, c, hw, bf, 41 + c, has_res)
        xx, res, g = x["x"], x["res"], x["g"]
        w16, b16 = x["w"].to(bf), x["b"].to(bf)
        w32, b32 = w16.float(), b16.float()
        y, mean, var = nf.fused_bn_fwd(xx, res, w16, b16, BN_EPS, relu)
        grads = nf.fused_bn_bwd(xx, res, w16, b16, mean, var, g, x["gmean"],
                                x["gvar"], BN_EPS, relu)
        f32 = nf.fused_bn_fwd(xx, res, w32, b32, BN_EPS, relu)
        g32 = nf.fused_bn_bwd(xx, res, w32, b32, mean, var, g, x["gmean"],
                              x["gvar"], BN_EPS, relu)
        ry, rmean, rvar = nf.fused_bn_fwd_ref(xx, res, w16, b16, BN_EPS, relu)
        rdx, rgate, rdw, rdb = nf.fused_bn_bwd_ref(
            xx, res, w16, b16, mean, var, g, x["gmean"], x["gvar"], BN_EPS,
            relu)
        torch.cuda.synchronize()
        where = f"(bf16 weight and bias, {case})"
        dx, dres, dw, db = grads
        check(dw.dtype == db.dtype == bf, f"fused BN dw, db come back "
              f"{dw.dtype}, {db.dtype} {where}")
        check(all(same_bits(a, o) for a, o in zip((y, mean, var), f32))
              and same_bits(dx, g32[0])
              and (dres is None or same_bits(dres, g32[1]))
              and same_bits(dw, g32[2].to(bf)) and same_bits(db, g32[3].to(bf)),
              f"fused BN with bf16 vectors differs from the same values in "
              f"f32 {where}")
        keep = None
        if relu:
            pre = bn_plain_pre(torch, nf, xx, res, w16, b16, mean, var)
            keep = (y > 0) == (pre > 0)
        readings = {}
        for key, got, ref, tol in (
                ("y", y, ry, BN_TOL["bfloat16"]),
                ("mean", mean, rmean, BN_STAT_TOL),
                ("var", var, rvar, BN_STAT_TOL),
                ("dx", dx, rdx.to(bf), BN_TOL["bfloat16"]),
                ("dw", dw, rdw.to(bf), BN_TOL["bfloat16"]),
                ("db", db, rdb.to(bf), BN_TOL["bfloat16"])) + (
                (("dres", dres, rgate.to(bf), BN_TOL["bfloat16"]),)
                if has_res else ()):
            if key == "dx" and keep is not None:
                got, ref = got[keep], ref[keep]
            readings[key] = rel_err(got, ref)[1]
            check(readings[key] <= tol, f"fused BN {key} disagrees with "
                  f"plain {where}: relative {readings[key]} > {tol}")
        fwd_work = bn_bwd_calls(torch, lambda: nf.fused_bn_fwd(
            xx, res, w16, b16, BN_EPS, relu))
        bwd_work = bn_bwd_calls(torch, lambda: nf.fused_bn_bwd(
            xx, res, w16, b16, mean, var, g, None, None, BN_EPS, relu))
        check(fwd_work["kernel_launches_per_call"] == 1
              and fwd_work["memsets_per_call"] == 0
              and bwd_work["kernel_launches_per_call"] == 1
              and bwd_work["memsets_per_call"] == 1,
              f"fused BN with bf16 vectors: forward {fwd_work}, backward "
              f"{bwd_work}, want one launch (and the backward's memset)")
        fwd_ms = in_turns(
            lambda _: nf.fused_bn_fwd(xx, res, w16, b16, BN_EPS, relu),
            lambda _: nf.fused_bn_fwd(xx, res, w32, b32, BN_EPS, relu))
        bwd_ms = in_turns(
            lambda _: nf.fused_bn_bwd(xx, res, w16, b16, mean, var, g, None,
                                      None, BN_EPS, relu),
            lambda _: nf.fused_bn_bwd(xx, res, w32, b32, mean, var, g, None,
                                      None, BN_EPS, relu))
        ffault = nf._bn_fwd_cuda(xx, res, w16, b16, BN_EPS, relu, skip=1)
        bfault = nf._bn_bwd_cuda(xx, res, w16, b16, rmean, rvar, g, None,
                                 None, BN_EPS, relu, skip=0)
        _, _, fdw, fdb = nf.fused_bn_bwd_ref(xx, res, w16, b16, rmean, rvar,
                                             g, None, None, BN_EPS, relu)
        faults = {"mean_fold_missing_last_rank": (rel_err(ffault[1], rmean)[1],
                                                  BN_STAT_TOL),
                  "dw_fold_missing_a_partial": (rel_err(bfault[2], fdw)[1],
                                                BN_STAT_TOL),
                  "db_fold_missing_a_partial": (rel_err(bfault[3], fdb)[1],
                                                BN_STAT_TOL)}
        for key, (reading, tol) in faults.items():
            check(reading > tol, f"the bf16-vector BN check passes a wrong "
                  f"kernel ({key}, {case}): {reading} <= {tol}")
        out[case] = dict(shape=[BN_N, c, hw], relative_to_max=readings,
                         bitwise_equal_to_f32_vectors=True,
                         dw_db_dtype="bfloat16",
                         forward_cuda_launches_per_call=fwd_work[
                             "kernel_launches_per_call"],
                         backward_cuda_launches_per_call=bwd_work[
                             "kernel_launches_per_call"],
                         backward_memsets_per_call=bwd_work[
                             "memsets_per_call"],
                         fused_bn_fwd=dict(ms=fwd_ms[0],
                                           ms_f32_vectors=fwd_ms[1],
                                           all_ms=fwd_ms[2]),
                         fused_bn_bwd=dict(ms=bwd_ms[0],
                                           ms_f32_vectors=bwd_ms[1],
                                           all_ms=bwd_ms[2]),
                         times="the op with bf16 vectors (a) in turns with "
                               "the same values in f32 (b): a, b, b, a",
                         wrong_kernel_reading={k: dict(reading=v, tolerance=t)
                                               for k, (v, t) in
                                               faults.items()})
        del x, xx, res, g, y, mean, var, grads, f32, g32, ry, rmean, rvar
        del rdx, rgate, rdw, rdb, dx, dres, dw, db, keep, ffault, bfault
        torch.cuda.empty_cache()
    return out


class BnVecDtypes:
    """While the ``with`` block runs, the dtype of the weight each
    BatchNorm kernel call receives (the cluster forward's and the
    persistent backward's wrappers), by direction."""

    def __enter__(self):
        from paddle_tpu_torch.kernels import norm_fusion as nf
        self.nf, self.seen = nf, {"forward": [], "backward": []}
        self._saved = (nf._bn_fwd_cuda, nf._bn_bwd_cuda)
        fwd, bwd = self._saved

        def rec_fwd(x, res, w, *a, **k):
            self.seen["forward"].append(str(w.dtype).split(".")[-1])
            return fwd(x, res, w, *a, **k)

        def rec_bwd(x, res, w, *a, **k):
            self.seen["backward"].append(str(w.dtype).split(".")[-1])
            return bwd(x, res, w, *a, **k)

        nf._bn_fwd_cuda, nf._bn_bwd_cuda = rec_fwd, rec_bwd
        return self

    def __exit__(self, *exc):
        self.nf._bn_fwd_cuda, self.nf._bn_bwd_cuda = self._saved

    def reading(self):
        return {d: {t: v.count(t) for t in sorted(set(v))}
                for d, v in self.seen.items()}


def amp_op_stats(fn):
    """collect_operator_stats over one call of ``fn``: each registered op
    dispatched, its calls and the dtype buckets of its outputs (zero
    buckets left out)."""
    import contextlib
    import io

    from paddle_tpu_torch.amp import debugging
    with contextlib.redirect_stdout(io.StringIO()):
        with debugging.collect_operator_stats() as stats:
            fn()
    return {op: {k: v for k, v in rec.items() if v}
            for op, rec in sorted(stats.items())}


def amp_profile(torch, step, steps=2):
    """torch.profiler over ``steps`` steps: device busy ms a step against
    the profiled wall, the idle share, the AMP casts a step (aten::_to_copy
    calls, the copy kernels' launches and device ms) and the kernels that
    take the time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if busy_ms == 0.0:
        return dict(steps=steps, device_time="not measured (no CUDA events)")
    copies = [e for e in dev if "copy" in e.key.lower()
              and not e.key.startswith("Memcpy")]
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)
    return dict(
        steps=steps, wall_ms_per_step=wall_ms / steps,
        device_busy_ms_per_step=busy_ms / steps,
        device_idle_share=1.0 - busy_ms / wall_ms,
        aten_to_copy_calls_per_step=sum(
            e.count for e in events if e.key == "aten::_to_copy") / steps,
        copy_kernel_launches_per_step=sum(e.count for e in copies) / steps,
        copy_kernels_ms_per_step=sum(e.self_device_time_total
                                     for e in copies) / 1e3 / steps,
        cuda_launches_per_step=sum(
            e.count for e in events
            if e.key.startswith(("cudaLaunchKernel", "cuLaunch"))) / steps,
        top_device_ms_per_step=[
            (e.key[:70], e.self_device_time_total / 1e3 / steps,
             e.count // steps) for e in top[:12]])


def amp_turns(torch, runs, steps=AMP_STEPS):
    """``runs`` {route: step} trained in turns (a, b, b, a), ``steps``
    steps a turn: each turn's ms a step, losses, launches since
    reset_launches, peak memory and clocks."""
    order = list(runs) + list(runs)[::-1]
    turns = {r: [] for r in runs}
    for route in order:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses = []
        with ClockSampler() as clocks:
            t0 = time.perf_counter()
            for _ in range(steps):
                losses.append(runs[route]())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        turns[route].append(dict(
            ms_per_step=wall / steps * 1e3,
            losses=[float(v) for v in losses], launches=read_launches(),
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            card=clocks.summary()))
    return turns


def resnet_amp_trainer(torch, fused, seed=0):
    """bench.py:552-583's step on the card: resnet50 with f32 parameters
    (1000 classes), Momentum(0.1, 0.9), the forward under
    auto_cast(level="O2", dtype="bfloat16"), cross_entropy of the logits in
    f32, backward, step, clear_grad, on one fixed batch, FLAGS_fused_norm
    as ``fused`` says. Returns (net, step, forward-and-loss)."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import amp, ops, set_flags
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    net = resnet50(num_classes=RESNET_CLASSES, dtype=torch.float32,
                   seed=seed)
    opt = Momentum(RESNET_LR, parameters=net.parameters(),
                   momentum=RESNET_MOMENTUM)
    x, y = resnet_batch(torch, RESNET_B, RESNET_HW, torch.float32, seed)

    def forward():
        set_flags({"FLAGS_fused_norm": fused})
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = net(x)
        return F.cross_entropy(ops.cast(logits, "float32"), y)

    def step():
        loss = forward()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    return net, step, forward


def amp_param_dtypes(model):
    return sorted({str(p.dtype).split(".")[-1] for p in model.parameters()})


def phase_train_resnet_amp(torch):
    """Phase 47: resnet50 at B=256, 3x224^2 under O2 bf16 with f32
    parameters (bench.py's step), the fused route (FLAGS_fused_norm on: the
    BN kernels) and the dense route (off) in turns, AMP_STEPS steps a turn
    on one fixed batch each. The first step of each: the operator
    statistics; on the fused route the running statistics held to Paddle's
    rule and each BN kernel call's weight dtype. The turns: ms a step, the
    loss finite and falling, 53 cluster forward and 53 persistent backward
    calls a step with bf16 vectors on the fused route and none on the dense
    one, peak memory; then a profile of each route (busy, idle, the casts);
    no parameter leaves f32."""
    from paddle_tpu_torch import set_flags
    out, runs, nets = {}, {}, {}
    try:
        for route, fused in (("fused", True), ("dense", False)):
            net, step, forward = resnet_amp_trainer(torch, fused)
            first = {}
            if fused:
                with BnRecorder() as rec, BnVecDtypes() as vec:
                    first["operator_stats"] = amp_op_stats(
                        lambda: first.setdefault("loss", forward()))
                    first["loss"].backward()
                    first["running_stats_vs_paddle_rule"] = (
                        rec.running_stats_reading(torch))
                    first["bn_weight_dtypes"] = vec.reading()
                del rec
            else:
                first["operator_stats"] = amp_op_stats(
                    lambda: first.setdefault("loss", forward()))
                first["loss"].backward()
            first["loss"] = float(first["loss"])
            for p in net.parameters():
                p.grad = None
            first["operator_tables"] = check_same_table(
                first["operator_stats"], resnet_o2_cpu_table(torch, fused),
                f"resnet50 O2 {route}")
            runs[route], nets[route] = step, net
            out[route] = first
        turns = amp_turns(torch, runs)
        for route, fused in (("fused", True), ("dense", False)):
            stats = out[route]["operator_stats"]
            bn_op = "fused_bn_train" if fused else "batch_norm_train"
            check(stats.get(bn_op) == dict(
                calls=RESNET_BNS, **{"bf16" if fused else "fp32":
                                     RESNET_BNS})
                  and stats.get("conv2d") == dict(calls=RESNET_BNS,
                                                  bf16=RESNET_BNS),
                  f"resnet50 O2 {route}: operator statistics {stats}")
            losses = [v for t in turns[route] for v in t["losses"]]
            check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                  f"resnet50 O2 {route}: losses {losses}")
            for t in turns[route]:
                for key, n in t["launches"].items():
                    want = (RESNET_BNS * AMP_STEPS
                            if fused and key.startswith("fused_bn") else 0)
                    check(n == want, f"resnet50 O2 {route}: {key} launched "
                          f"{n} times in {AMP_STEPS} steps (want {want})")
            check(amp_param_dtypes(nets[route]) == ["float32"],
                  f"resnet50 O2 {route}: parameters "
                  f"{amp_param_dtypes(nets[route])}")
            out[route].update(
                ms_per_step=min(t["ms_per_step"] for t in turns[route]),
                turns=turns[route],
                images_per_s=RESNET_B / (min(t["ms_per_step"]
                                             for t in turns[route]) / 1e3),
                profile=amp_profile(torch, runs[route]))
        with BnVecDtypes() as vec:
            reset_launches()
            runs["fused"]()
            counts = read_launches()
        out["fused"]["bn_launches_per_step"] = dict(
            forward=bn_fwd_routes_reading(counts, "resnet50 O2"),
            backward=bn_bwd_routes_reading(counts, "resnet50 O2"),
            weight_dtypes=vec.reading())
        check(vec.reading() == {"forward": {"bfloat16": RESNET_BNS},
                                "backward": {"bfloat16": RESNET_BNS}}
              and out["fused"]["bn_weight_dtypes"] == vec.reading(),
              f"resnet50 O2: the BN kernels' weight dtypes {vec.reading()}")
    finally:
        set_flags({"FLAGS_fused_norm": True})
    del runs, nets
    return dict(config="resnet50", b=RESNET_B, hw=RESNET_HW,
                amp="O2 bfloat16", parameters="float32", lr=RESNET_LR,
                momentum=RESNET_MOMENTUM, steps_a_turn=AMP_STEPS,
                order="fused, dense, dense, fused", **out)


def bert_amp_batch(torch, cfg, b, s, seed=0):
    """bench.py:671-677's draw: ids uniform over the vocabulary, MLM labels
    the same draw at the 15% of positions kept (-100 elsewhere), NSP
    labels; no attention mask."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    mlm = rng.integers(0, cfg.vocab_size, (b, s))
    mlm[rng.random((b, s)) > 0.15] = -100
    nsp = rng.integers(0, 2, (b,))
    return tuple(torch.from_numpy(a.astype(np.int64)).cuda()
                 for a in (ids, mlm, nsp))


def bert_amp_trainer(torch, cfg, fused, seed=0):
    """bench.py:647-692's step on the card: BertForPretraining(cfg) with
    f32 parameters at its dropout rates, the loss under
    auto_cast(level="O1", dtype="bfloat16"), backward, AdamW(1e-4) step,
    clear_grad, on one fixed batch, the fused flags as ``fused`` says."""
    from paddle_tpu_torch import amp, set_flags
    from paddle_tpu_torch import seed as framework_seed
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.optimizer import AdamW
    framework_seed(seed)
    model = bert.BertForPretraining(cfg, dtype=torch.float32, seed=seed)
    opt = AdamW(AMP_BERT_LR, parameters=model.parameters())
    batch = bert_amp_batch(torch, cfg, AMP_BERT_B, AMP_BERT_S, seed)

    def forward():
        set_flags({"FLAGS_fused_norm": fused, "FLAGS_fused_mlp": fused})
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return model.loss(*batch)

    def step():
        loss = forward()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    return model, step, forward


def phase_train_bert_amp(torch):
    """Phase 48: bert-base at B=64, S=512 (no mask) under O1 bf16 with f32
    parameters at dropout 0.1 / 0.1 (bench.py's step), the fused route
    and the dense one (the fused norm and MLP flags off; flash kept) in
    turns, AMP_STEPS steps a turn. The first step: the operator statistics.
    The turns: ms a step, the loss finite and falling below the first
    step's on average, the flash, MLP, projection-LN and LayerNorm
    launches a step exactly bert_launches' on their bf16 routes, peak
    memory; a profile of each; no parameter leaves f32."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.models import bert
    cfg = bert.CONFIGS["bert-base"]
    out, runs, models = {}, {}, {}
    try:
        for route, fused in (("fused", True), ("dense", False)):
            model, step, forward = bert_amp_trainer(torch, cfg, fused)
            first = {}
            first["operator_stats"] = amp_op_stats(
                lambda: first.setdefault("loss", forward()))
            first["loss"].backward()
            first["loss"] = float(first["loss"])
            for p in model.parameters():
                p.grad = None
            first["operator_tables"] = check_same_table(
                first["operator_stats"], bert_cpu_table(torch, cfg, fused,
                                                        "O1"),
                f"bert-base O1 {route}")
            runs[route], models[route] = step, model
            out[route] = first
        turns = amp_turns(torch, runs)
        for route, fused in (("fused", True), ("dense", False)):
            stats = out[route]["operator_stats"]
            L = cfg.num_hidden_layers
            check(stats.get("linear", {}).get("bf16") == (
                L + 3 if fused else 4 * L + 3)
                  and stats.get("cross_entropy") == dict(calls=1, fp32=1)
                  and stats.get("flash_attention_masked") == dict(
                      calls=L, bf16=L),
                  f"bert-base O1 {route}: operator statistics {stats}")
            losses = [v for t in turns[route] for v in t["losses"]]
            check(all(np.isfinite(losses))
                  and np.mean(losses) < out[route]["loss"],
                  f"bert-base O1 {route}: losses {losses} against the first "
                  f"step's {out[route]['loss']}")
            want = bert_launches(cfg, fused)
            for t in turns[route]:
                for key, n in t["launches"].items():
                    check(n == want.get(key, 0) * AMP_STEPS,
                          f"bert-base O1 {route}: {key} launched {n} times "
                          f"in {AMP_STEPS} steps (want "
                          f"{want.get(key, 0) * AMP_STEPS})")
            check(amp_param_dtypes(models[route]) == ["float32"],
                  f"bert-base O1 {route}: parameters "
                  f"{amp_param_dtypes(models[route])}")
            reset_launches()
            runs[route]()
            counts = read_launches()
            routes = dict(flash_fwd=fwd_routes_reading(counts, "bert O1"),
                          flash_bwd=bwd_routes_reading(counts, "bert O1"),
                          mlp_fwd=mlp_fwd_routes_reading(counts, "bert O1",
                                                         fused),
                          mlp_bwd=mlp_bwd_routes_reading(counts, "bert O1",
                                                         fused),
                          ln_bwd=ln_bwd_routes_reading(counts, "bert O1",
                                                       fused))
            if fused:
                routes["proj_ln"] = pl_routes_reading(counts, "bert O1")
            ms = min(t["ms_per_step"] for t in turns[route])
            out[route].update(
                ms_per_step=ms, turns=turns[route],
                tokens_per_s=AMP_BERT_B * AMP_BERT_S / (ms / 1e3),
                launches_per_step={k: n for k, n in counts.items() if n},
                routes_per_step=routes,
                profile=amp_profile(torch, runs[route]))
    finally:
        set_flags({"FLAGS_fused_norm": True, "FLAGS_fused_mlp": True})
    del runs, models
    return dict(config="bert-base", b=AMP_BERT_B, s=AMP_BERT_S,
                amp="O1 bfloat16", parameters="float32", lr=AMP_BERT_LR,
                dropout=[cfg.hidden_dropout_prob,
                         cfg.attention_probs_dropout_prob],
                steps_a_turn=AMP_STEPS, order="fused, dense, dense, fused",
                **out)


def amp_readings(torch, run, *args):
    """(loss, gradients as f64 CPU tensors, extra) of one ``run``."""
    loss, grads, extra = run(*args)
    return (float(loss), [g.detach().double().cpu() for g in grads], extra)


def amp_worst(a, b):
    """The largest difference of two gradient lists, each leaf's relative
    to its largest entry in b."""
    return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(a, b))


def phase_amp_parity(torch):
    """Phase 49: the card against the port's CPU route under AMP, from the
    same weights and batch: resnet50 at B=8, 64^2 under O2 (its kernels
    against their plain versions), the loss, the gradients of all leaves
    as one vector and the running statistics, each within 3x the port's
    own reading between the O2 step and the f32 step on the CPU (the rule
    of phase 31); bert-base at full width, 2 layers, B=4, S=512, dropout
    0.1 / 0.1, under O1 (generators seeded alike, as phase 36): the loss
    and every gradient within 3x the CPU's own O1-against-f32 reading.
    (The BatchNorm ops with bf16 weight and bias against their plain
    versions: phase 27, bn_bf16_vectors.)"""
    import copy

    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import amp, seed, set_flags
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.vision.models import resnet50
    set_flags({"FLAGS_fused_norm": True, "FLAGS_fused_mlp": True})
    factor = 3.0
    net = resnet50(num_classes=RESNET_CLASSES, dtype=torch.float32, seed=2)
    cpu = copy.deepcopy(net).cpu()
    start = [b.detach().clone() for b in net.buffers()]
    x, y = resnet_batch(torch, 8, 64, torch.float32, 2)

    def resnet_run(model, level):
        xx, yy = (x, y) if model.parameters()[0].is_cuda else (
            x.cpu(), y.cpu())
        with torch.no_grad():
            for b, s in zip(model.buffers(), start):
                b.copy_(s)
        reset_launches()
        with amp.auto_cast(enable=level != "O0", level=level,
                           dtype="bfloat16"):
            logits = model(xx)
        loss = F.cross_entropy(logits.float(), yy)
        g = torch.autograd.grad(loss, list(model.parameters()))
        stats = [b.double().cpu().clone() for b in model.buffers()]
        return loss, g, (stats, read_launches())

    lc, gc_, (sc, counts) = amp_readings(torch, resnet_run, net, "O2")
    lp, gp, (sp, _) = amp_readings(torch, resnet_run, cpu, "O2")
    l32, g32, (s32, _) = amp_readings(torch, resnet_run, cpu, "O0")
    check(counts["fused_bn_fwd"] == counts["fused_bn_bwd"] == RESNET_BNS,
          f"resnet50 O2 parity on the card launched {counts}")

    def flat(g):
        return torch.cat([t.reshape(-1) for t in g])

    def stat_err(s, ref):
        return max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-30)
                   for a, b in zip(s, ref))

    fc, fp, f32 = flat(gc_), flat(gp), flat(g32)
    resnet = dict(
        grads_rel_l2=(float((fc - fp).norm() / fp.norm()),
                      float((fp - f32).norm() / f32.norm())),
        running_stats_rel=(stat_err(sc, sp), stat_err(sp, s32)),
        loss_abs=(abs(lc - lp), abs(lp - l32)))
    for key, (card, own) in resnet.items():
        check(card <= factor * own, f"resnet50 O2 parity {key}: card vs CPU "
              f"{card}, the CPU's O2 vs f32 {own}: more than {factor}x")
    del net, cpu, gc_, gp, g32, fc, fp, f32

    cfg = bert.CONFIGS["bert-base"]._replace(num_hidden_layers=2)
    bcard = bert.BertForPretraining(cfg, dtype=torch.float32, seed=1)
    bcpu = bert.BertForPretraining(cfg, device="cpu", dtype=torch.float32,
                                   seed=1)
    bcpu.load_state_dict({k: v.cpu() for k, v in bcard.state_dict().items()})
    batch, _ = bert_batch(torch, cfg, 4, BERT_S, 1)

    def bert_run(model, level):
        b = batch if model.parameters()[0].is_cuda else tuple(
            t.cpu() for t in batch)
        seed(7)
        reset_launches()
        with amp.auto_cast(enable=level != "O0", level=level,
                           dtype="bfloat16"):
            loss = model.loss(*b[:3], attention_mask=b[3])
        return loss, torch.autograd.grad(loss, list(model.parameters())), \
            read_launches()

    blc, bgc, bcounts = amp_readings(torch, bert_run, bcard, "O1")
    blp, bgp, _ = amp_readings(torch, bert_run, bcpu, "O1")
    bl32, bg32, _ = amp_readings(torch, bert_run, bcpu, "O0")
    want = bert_launches(cfg, True)
    check(all(bcounts[k] == n for k, n in want.items())
          and sum(bcounts.values()) == sum(want.values()),
          f"bert O1 parity on the card launched {bcounts} (want {want})")
    bertr = dict(grads_worst_leaf=(amp_worst(bgc, bgp), amp_worst(bgp, bg32)),
                 loss_abs=(abs(blc - blp), abs(blp - bl32)))
    for key, (card, own) in bertr.items():
        check(card <= factor * own, f"bert-base O1 parity {key}: card vs CPU "
              f"{card}, the CPU's O1 vs f32 {own}: more than {factor}x")
    del bcard, bcpu, bgc, bgp, bg32
    torch.cuda.empty_cache()
    return dict(
        resnet50=dict(b=8, hw=64, level="O2", loss_card=lc, loss_cpu=lp,
                      loss_cpu_f32=l32,
                      readings={k: dict(card_vs_cpu=v[0],
                                        cpu_o2_vs_f32=v[1])
                                for k, v in resnet.items()}),
        bert_base_2_layers=dict(b=4, s=BERT_S, level="O1",
                                dropout=[cfg.hidden_dropout_prob,
                                         cfg.attention_probs_dropout_prob],
                                loss_card=blc, loss_cpu=blp,
                                loss_cpu_f32=bl32,
                                readings={k: dict(card_vs_cpu=v[0],
                                                  cpu_o1_vs_f32=v[1])
                                          for k, v in bertr.items()}),
        limit=f"card vs CPU within {factor}x the CPU's own AMP-against-f32 "
              "reading")


class _RecordingClip:
    """ClipGradByGlobalNorm(clip_norm) that keeps each call's global norm."""

    def __init__(self, clip_norm):
        from paddle_tpu_torch.nn import ClipGradByGlobalNorm
        self.clip = ClipGradByGlobalNorm(clip_norm)
        self.norms = []

    def __call__(self, params_grads):
        self.norms.append(float(self.clip._global_norm_sq(params_grads))
                          ** 0.5)
        return self.clip(params_grads)


def phase_amp_tools(torch):
    """Phase 50, at bert-base width with 2 layers, B=4, S=512, dropout 0:
    (a) GradScaler under O1 float16 (f32 parameters, AdamW): an inf
    planted in one gradient at step 2 skips the update (parameters and
    moments bitwise unchanged) and halves the scale; (b) decorate(level=
    "O2"): the LayerNorm parameters stay f32, every other parameter
    becomes bf16 with an f32 master weight after a step under O2, and a
    GradScaler's skipped step leaves the master weights bitwise unchanged;
    (c) LinearWarmup → PolynomialDecay, ClipGradByGlobalNorm(1.0) and
    PaddleNLP's apply_decay_param_fun, 3 AdamW steps in f32 from the same
    weights: the rates, the clipped global norms and the parameters
    against the port's CPU route."""
    from paddle_tpu_torch import amp, set_flags
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.nn.layer.norm import LayerNorm
    from paddle_tpu_torch.optimizer import AdamW, lr
    set_flags({"FLAGS_fused_norm": True, "FLAGS_fused_mlp": True})
    cfg = bert.CONFIGS["bert-base"]._replace(
        num_hidden_layers=2, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    batch, _ = bert_batch(torch, cfg, 4, BERT_S, 3)
    out = {}

    def scaled_steps(model, opt, level, dtype):
        scaler = amp.GradScaler(init_loss_scaling=2.0 ** 8)
        scales, skipped = [], []
        for step in range(4):
            with amp.auto_cast(level=level, dtype=dtype):
                loss = model.loss(*batch[:3], attention_mask=batch[3])
            scaler.scale(loss).backward()
            if step == 2:
                p0 = next(iter(model.parameters()))
                p0.grad.view(-1)[0] = float("inf")
            before = ([p.detach().clone() for p in model.parameters()],
                      {k: [t.clone() for t in v.values()]
                       for k, v in opt._accumulators.items()},
                      [t.clone() for t in opt._master_weights.values()])
            scale = scaler.get_init_loss_scaling()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            after = ([p.detach() for p in model.parameters()],
                     {k: list(v.values())
                      for k, v in opt._accumulators.items()},
                     list(opt._master_weights.values()))
            same = (all(same_bits(a, b) for a, b in zip(*(x[0] for x in (
                before, after))))
                and all(same_bits(a, b) for k in before[1]
                        for a, b in zip(before[1][k], after[1][k]))
                and all(same_bits(a, b) for a, b in zip(before[2],
                                                         after[2])))
            scales.append(scale)
            skipped.append(same)
            check(np.isfinite(float(loss)), f"{level} {dtype}: loss {loss}")
        check(skipped == [False, False, True, False]
              and scaler.get_init_loss_scaling() == scales[2] / 2,
              f"GradScaler under {level} {dtype}: skipped {skipped}, scales "
              f"{scales} then {scaler.get_init_loss_scaling()}")
        return dict(scales=scales, skipped_step=2,
                    scale_after=scaler.get_init_loss_scaling(),
                    unchanged_on_skip=dict(parameters=True, moments=True,
                                           master_weights=len(before[2])))

    model = bert.BertForPretraining(cfg, dtype=torch.float32, seed=4)
    opt = AdamW(1e-4, parameters=model.parameters())
    out["grad_scaler_o1_float16"] = scaled_steps(model, opt, "O1", "float16")
    del model, opt

    model = bert.BertForPretraining(cfg, dtype=torch.float32, seed=4)
    opt = AdamW(1e-4, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    ln = {id(p) for m in model.modules() if isinstance(m, LayerNorm)
          for p in m.parameters()}
    dtypes = {("layernorm" if id(p) in ln else "other"): set()
              for p in model.parameters()}
    for p in model.parameters():
        dtypes["layernorm" if id(p) in ln else "other"].add(
            str(p.dtype).split(".")[-1])
    check(dtypes == {"layernorm": {"float32"}, "other": {"bfloat16"}},
          f"decorate O2: parameter dtypes {dtypes}")
    out["decorate_o2"] = dict(
        parameter_dtypes={k: sorted(v) for k, v in dtypes.items()},
        grad_scaler_o2_bfloat16=scaled_steps(model, opt, "O2", "bfloat16"))
    masters = opt._master_weights
    check(len(masters) == sum(1 for p in model.parameters()
                              if id(p) not in ln)
          and all(m.dtype == torch.float32 for m in masters.values()),
          f"decorate O2: {len(masters)} master weights")
    out["decorate_o2"]["master_weights"] = len(masters)
    del model, opt, masters

    card = bert.BertForPretraining(cfg, dtype=torch.float32, seed=5)
    state = {k: v.cpu() for k, v in card.state_dict().items()}
    del card

    def recipe(device):
        # one set of weights on both: the card's seeded draw, carried over
        model = bert.BertForPretraining(cfg, device=device,
                                        dtype=torch.float32, seed=5)
        model.load_state_dict(state)
        decay = [p.name for n, p in model.named_parameters()
                 if not any(nd in n for nd in ["bias", "norm"])]
        sched = lr.LinearWarmup(lr.PolynomialDecay(1e-3, decay_steps=10),
                                warmup_steps=2, start_lr=0.0, end_lr=1e-3)
        clip = _RecordingClip(1.0)
        opt = AdamW(sched, parameters=model.parameters(), weight_decay=0.01,
                    grad_clip=clip,
                    apply_decay_param_fun=lambda n: n in decay)
        b = batch if device is None else tuple(t.cpu() for t in batch)
        rates = []
        for _ in range(3):
            loss = model.loss(*b[:3], attention_mask=b[3])
            loss.backward()
            rates.append(opt.get_lr())
            opt.step()
            opt.clear_grad()
            sched.step()
        return (rates, clip.norms,
                [p.detach().double().cpu() for p in model.parameters()],
                len(decay), sum(1 for _ in model.parameters()))

    rc, nc, pc, ndecay, nparams = recipe(None)
    rp, np_, pp, _, _ = recipe("cpu")
    far = max(float((a - b).abs().max()) for a, b in zip(pc, pp))
    norm_rel = max(abs(a - b) / b for a, b in zip(nc, np_))
    check(rc == rp and rc[0] == 0.0 and rc[2] > rc[1] > 0,
          f"scheduler rates card {rc}, CPU {rp}")
    check(norm_rel <= 1e-4 and all(n > 1.0 for n in nc),
          f"clipped global norms card {nc}, CPU {np_}")
    check(far <= 2 * 1e-3 * 3, f"parameters after 3 AdamW steps, card vs "
          f"CPU: {far} > 2 lr steps")
    out["recipe"] = dict(rates=rc, global_norms_card=nc, global_norms_cpu=np_,
                         global_norm_rel=norm_rel, decayed=ndecay,
                         parameters=nparams, param_max_abs_diff=far,
                         limit="rates equal; norms rtol 1e-4; parameters "
                               "within 2 lr steps (Adam's normalisation)")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the operator surface (ops/, the Tensor facade): phases 51-53 and the CPU
# operator tables of phases 47 and 48
# ---------------------------------------------------------------------------

AMP_O2_BERT_B, AMP_O2_BERT_S = 32, 512
# phase 52's tolerances (relative, absolute as a share of the output's
# largest value): float32 1e-5, bfloat16 one unit (2^-7); the
# decompositions through their invariants at 1e-4 of the input's scale;
# integers, bools, dtypes and shapes exact
OPS_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 2.0 ** -7),
           "linalg": 1e-4}


def table_counts(stats):
    """(ops dispatched, distinct op names) of an operator table."""
    return dict(ops_dispatched=sum(r["calls"] for r in stats.values()),
                op_names=len(stats))


def check_same_table(card, cpu, what):
    """The card's operator table against the CPU's of the same model and
    configuration: equal, name for name and bucket for bucket."""
    diff = {k: (card.get(k), cpu.get(k)) for k in sorted(set(card) | set(cpu))
            if card.get(k) != cpu.get(k)}
    check(not diff, f"{what}: the card's operator table differs from the "
          f"CPU's: {diff}")
    return dict(card=table_counts(card), cpu=table_counts(cpu))


def resnet_o2_cpu_table(torch, fused):
    """resnet50 (the card's classes, f32 parameters) on the CPU at B=2,
    3x32x32 under O2 bf16, the loss as phase 47 takes it: the table
    depends on the configuration, not the batch."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import amp, ops, set_flags
    from paddle_tpu_torch.vision.models import resnet50
    net = resnet50(num_classes=RESNET_CLASSES, dtype=torch.float32, seed=0,
                   device="cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 32, 32, generator=g)
    y = torch.randint(0, RESNET_CLASSES, (2, 1), generator=g)

    def forward():
        set_flags({"FLAGS_fused_norm": fused})
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = net(x)
        return F.cross_entropy(ops.cast(logits, "float32"), y)

    return amp_op_stats(forward)


_CPU_BERT = {}


def bert_cpu_table(torch, cfg, fused, level, b=2, s=16, mask=False):
    """BertForPretraining(cfg) at full width on the CPU, f32 parameters,
    its loss at B=2, S=16 under ``level`` bf16 (the card's phase with no
    mask, or a padding mask when ``mask``)."""
    from paddle_tpu_torch import amp, set_flags
    from paddle_tpu_torch.models import bert
    if _CPU_BERT.get("cfg") != cfg:     # one CPU model for phases 48, 51
        _CPU_BERT.update(cfg=cfg, model=bert.BertForPretraining(
            cfg, device="cpu", dtype=torch.float32, seed=0))
    model = _CPU_BERT["model"]
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    mlm = np.where(rng.random((b, s)) < 0.3, ids, -100)
    args = [torch.from_numpy(a.astype(np.int64)) for a in
            (ids, mlm, rng.integers(0, 2, (b,)))]
    kw = {}
    if mask:
        m = np.ones((b, s), np.int64)
        m[-1, s // 2:] = 0
        kw["attention_mask"] = torch.from_numpy(m)

    def forward():
        set_flags({"FLAGS_fused_norm": fused, "FLAGS_fused_mlp": fused})
        with amp.auto_cast(level=level, dtype="bfloat16"):
            return model.loss(*args, **kw)

    try:
        return amp_op_stats(forward)
    finally:
        set_flags({"FLAGS_fused_norm": True, "FLAGS_fused_mlp": True})


def phase_train_bert_o2(torch):
    """Phase 51: one bert-base step at full width under O2 bf16 with f32
    parameters, fused kernels, B=32, S=512 with the padding mask (bert_batch),
    dropout 0.1 / 0.1, AdamW: the loss arithmetic (multiply, sum, divide,
    subtract) bf16 in the operator table, the table equal to the CPU's
    at B=2, S=16, the loss finite and bf16, every kernel of bert_launches
    launched, the step's ms."""
    from paddle_tpu_torch import amp, set_flags
    from paddle_tpu_torch import seed as framework_seed
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.optimizer import AdamW
    cfg = bert.CONFIGS["bert-base"]
    set_flags({"FLAGS_fused_norm": True, "FLAGS_fused_mlp": True})
    framework_seed(0)
    model = bert.BertForPretraining(cfg, dtype=torch.float32, seed=0)
    opt = AdamW(AMP_BERT_LR, parameters=model.parameters())
    batch, lengths = bert_batch(torch, cfg, AMP_O2_BERT_B, AMP_O2_BERT_S, 0)
    ids, mlm, nsp, mask = batch
    first = {}

    def forward():
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            return model.loss(ids, mlm, nsp, attention_mask=mask)

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    stats = amp_op_stats(lambda: first.setdefault("loss", forward()))
    loss = first["loss"]
    loss.backward()
    opt.step()
    opt.clear_grad()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_launches()
    check(loss.dtype == torch.bfloat16 and bool(torch.isfinite(loss)),
          f"bert-base O2: loss {loss} ({loss.dtype})")
    for name, calls in (("multiply", 2), ("sum", 2), ("divide", 1),
                        ("subtract", 1)):
        check(stats.get(name) == dict(calls=calls, bf16=calls),
              f"bert-base O2: {name} {stats.get(name)} (want {calls} bf16)")
    want = bert_launches(cfg, True)
    missed = sorted(k for k, n in want.items() if n and not counts.get(k))
    check(not missed, f"bert-base O2: kernels not launched: {missed}")
    tables = check_same_table(stats, bert_cpu_table(
        torch, cfg, True, "O2", mask=True), "bert-base O2")
    del model, opt
    return dict(config="bert-base", b=AMP_O2_BERT_B, s=AMP_O2_BERT_S,
                amp="O2 bfloat16", parameters="float32",
                dropout=[cfg.hidden_dropout_prob,
                         cfg.attention_probs_dropout_prob],
                valid_tokens=int(lengths.sum()), loss=float(loss),
                loss_dtype="bfloat16", first_step_ms=ms,
                loss_arithmetic={k: stats[k] for k in
                                 ("multiply", "sum", "divide", "subtract")},
                operator_tables=tables,
                launches={k: n for k, n in counts.items() if n})


def _invariants(torch, name, outs, ins):
    """The decompositions on one device, read through what defines them:
    the largest violation relative to the input's scale."""
    a = ins[0].double()
    scale = float(a.abs().max())
    outs = [o.double() for o in outs]
    if name == "qr":
        q, r = outs
        eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
        return max(float((q @ r - a).abs().max()) / scale,
                   float((q.mT @ q - eye).abs().max()),
                   float(torch.tril(r, -1).abs().max()) / scale)
    if name == "svd":
        u, s, v = outs
        return float((u @ torch.diag_embed(s) @ v.mT - a).abs().max()) / scale
    if name == "eigh":
        w, v = outs
        sym = (a + a.mT) / 2
        return float((sym @ v - v * w[..., None, :]).abs().max()) / scale
    if name == "solve":
        return float((a @ outs[0] - ins[1].double()).abs().max()) / max(
            scale * float(outs[0].abs().max()), 1e-30)
    raise KeyError(name)


def ops_cases(torch):
    """(name, fn(*tensors), numpy inputs, kind) of phase 52: kind "value"
    compares the outputs; "linalg" compares the invariant-free outputs
    (singular values, eigenvalues, |diag R|, the solution) and holds each
    device's decomposition to its invariants; "mostly" (poisson, whose
    rejection tests read log and lgamma, a few ulps apart between the
    CPU's and CUDA's libraries) wants the same draw in 98% of the
    elements and the same dtype and shape."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import extras as X
    from paddle_tpu_torch.ops import manipulation as M
    from paddle_tpu_torch.ops import random as R
    rng = np.random.default_rng(52)

    def f32(*s):
        return rng.standard_normal(s).astype(np.float32)

    def ints(*s, lo=-6, hi=7):
        return rng.integers(lo, hi, s).astype(np.int64)

    def pos(*s):
        return np.abs(f32(*s)) + 0.1

    def ties(*s):
        return rng.integers(0, 3, s).astype(np.float32)

    def nz(*s):
        return (np.where(rng.random(s) < 0.5, -1, 1)
                * rng.integers(1, 5, s)).astype(np.int64)

    spd = f32(6, 6)
    spd = spd @ spd.T + 6 * np.eye(6, dtype=np.float32)
    key = (0, 7)
    bf = torch.bfloat16
    return [
        # the ops the BERT and ResNet paths dispatch (ops/ and the
        # functionals with plain bodies; the kernels' ops are held to
        # their plain versions by phases 3-46)
        ("add", lambda x, y: pt.add(x, y), [f32(4, 8), f32(4, 8)], "value"),
        ("add-scalar-bf16", lambda x: pt.add(x.to(bf), 1e-6), [f32(64)],
         "value"),
        ("subtract", lambda x: pt.subtract(1.0, x), [f32(4, 8)], "value"),
        ("multiply", lambda x: pt.multiply(x, -1e9), [f32(4, 8)], "value"),
        ("divide", lambda x, y: pt.divide(x, y), [f32(4, 8), f32(4, 8)],
         "value"),
        ("sum", lambda x: pt.sum(x), [f32(16, 64)], "value"),
        ("sum-bf16", lambda x: pt.sum(x.to(bf)), [pos(16, 64)], "value"),
        ("matmul", lambda x, y: pt.matmul(x, y, transpose_y=True),
         [f32(8, 16), f32(12, 16)], "value"),
        ("tanh", lambda x: pt.tanh(x), [f32(4, 8)], "value"),
        ("cast", lambda x: pt.cast(x, "float32"), [ints(4, 8)], "value"),
        ("not_equal", lambda x: pt.not_equal(x, -100),
         [np.where(rng.random((4, 8)) < 0.5, -100, ints(4, 8))], "value"),
        ("where", lambda c, x: pt.where(c != 0, x, pt.zeros_like(x)),
         [ints(4, 8, lo=0, hi=2), ints(4, 8)], "value"),
        ("zeros_like", lambda x: pt.zeros_like(x), [ints(4, 8)], "value"),
        ("unsqueeze", lambda x: pt.unsqueeze(pt.unsqueeze(x, 1), 1),
         [f32(2, 8)], "value"),
        ("reshape", lambda x: pt.reshape(x, [2, 4, 2, 4]), [f32(2, 4, 8)],
         "value"),
        ("split_even", lambda x: M.split(x, 3, axis=-1), [f32(2, 4, 12)],
         "value"),
        ("getitem", lambda x: M._getitem(x, (slice(None), 0)),
         [f32(2, 4, 8)], "value"),
        ("flatten", lambda x: pt.flatten(x, 1), [f32(2, 8, 1, 1)], "value"),
        ("linear", lambda x, w, b: F.linear(x, w, b),
         [f32(4, 16), f32(16, 8), f32(8)], "value"),
        ("embedding", lambda i, w: F.embedding(i, w),
         [ints(2, 6, lo=0, hi=10), f32(10, 8)], "value"),
        ("cross_entropy", lambda x, y: F.cross_entropy(x, y),
         [f32(6, 10), ints(6, lo=0, hi=10)], "value"),
        # math
        ("cumsum-bf16", lambda x: pt.cumsum(x.to(bf), axis=1), [pos(4, 64)],
         "value"),
        ("cummax-ties", lambda x: pt.cummax(x, axis=1), [ties(4, 16)],
         "value"),
        ("floor_divide-signs", lambda x, y: pt.floor_divide(x, y),
         [ints(4, 8), nz(4, 8)], "value"),
        ("remainder-signs", lambda x, y: pt.remainder(x, y),
         [ints(4, 8), nz(4, 8)], "value"),
        ("divide-int", lambda x, y: pt.divide(x, y), [ints(4, 8), nz(4, 8)],
         "value"),
        ("logaddexp", lambda x, y: pt.logaddexp(x, y), [f32(4, 8), f32(4, 8)],
         "value"),
        # manipulation
        ("sort-ties", lambda x: pt.sort(x, axis=1, descending=True),
         [ties(4, 32)], "value"),
        ("argsort-ties", lambda x: pt.argsort(x, axis=1), [ties(4, 32)],
         "value"),
        ("argsort-ties-desc", lambda x: pt.argsort(x, axis=1,
                                                   descending=True),
         [ties(4, 32)], "value"),
        ("topk-ties", lambda x: pt.topk(x, 5), [ties(4, 32)], "value"),
        ("unique", lambda x: M._unique_all(x), [ints(40, lo=0, hi=9)],
         "value"),
        ("nonzero", lambda x: pt.nonzero(x), [ints(6, 7, lo=0, hi=2)],
         "value"),
        ("masked_select", lambda x, m: pt.masked_select(x, m != 0),
         [f32(6, 7), ints(6, 7, lo=0, hi=2)], "value"),
        ("scatter-repeated-add", lambda x, i, u: pt.scatter(
            x, i, u, overwrite=False),
         [f32(5, 4), np.array([1, 3, 1, 0, 3, 1]), f32(6, 4)], "value"),
        ("index_add-repeated", lambda x, i, u: pt.index_add(x, i, 0, u),
         [f32(5, 4), np.array([2, 2, 0, 2]), f32(4, 4)], "value"),
        ("mode", lambda x: pt.mode(x, axis=1), [ties(4, 9)], "value"),
        ("histogram", lambda x: pt.histogram(x, bins=7), [f32(200)],
         "value"),
        ("getitem-negative-step", lambda x: M._getitem(
            x, (slice(None, None, -1), slice(5, 0, -2))), [f32(4, 6)],
         "value"),
        # reduction
        ("argmax-ties", lambda x: pt.argmax(x, axis=1), [ties(6, 33)],
         "value"),
        ("argmin-ties", lambda x: pt.argmin(x), [ties(6, 33)], "value"),
        ("median-even", lambda x: pt.median(x, axis=1), [f32(4, 10)],
         "value"),
        ("quantile", lambda x: pt.quantile(x, [0.1, 0.5, 0.9], axis=1),
         [f32(4, 11)], "value"),
        ("logsumexp", lambda x: pt.logsumexp(x, axis=1), [f32(4, 50)],
         "value"),
        ("prod", lambda x: pt.prod(x, axis=[0, 2]), [f32(2, 3, 4)], "value"),
        # logic
        ("equal-nan", lambda x: pt.equal(x, x),
         [np.where(rng.random((4, 8)) < 0.3, np.nan, f32(4, 8))], "value"),
        ("isclose", lambda x, y: pt.isclose(x, y), [f32(4, 8), f32(4, 8)],
         "value"),
        ("bitwise_right_shift", lambda x, y: pt.bitwise_right_shift(x, y),
         [ints(4, 8, lo=-64, hi=64), ints(4, 8, lo=0, hi=5)], "value"),
        ("isin", lambda x, y: pt.isin(x, y), [ints(4, 8), ints(5)], "value"),
        ("logical_xor", lambda x, y: pt.logical_xor(x, y),
         [ints(4, 8, lo=0, hi=2), ints(4, 8, lo=0, hi=2)], "value"),
        # linalg
        ("qr", lambda x: pt.qr(x), [f32(8, 5)], "linalg"),
        ("svd", lambda x: pt.svd(x), [f32(6, 4)], "linalg"),
        ("eigh", lambda x: pt.eigh(x), [spd], "linalg"),
        ("solve", lambda x, y: pt.solve(x, y), [spd, f32(6, 2)], "linalg"),
        ("det", lambda x: pt.det(x), [spd / 6], "value"),
        ("cholesky", lambda x: pt.cholesky(x), [spd], "value"),
        ("inverse", lambda x: pt.inverse(x), [spd], "value"),
        # creation (on the current place)
        ("to_tensor", lambda: pt.to_tensor([[1.5, 2.0], [3.0, 4.5]]), [],
         "value"),
        ("arange", lambda: pt.arange(2, 30, 3), [], "value"),
        ("linspace", lambda: pt.linspace(-1.0, 2.0, 9), [], "value"),
        ("full", lambda: pt.full([3, 2], 7), [], "value"),
        ("tril", lambda x: pt.tril(x, -1), [f32(5, 5)], "value"),
        ("diag", lambda x: pt.diag(x, 1, padding_value=9.0), [f32(4)],
         "value"),
        # random, from one key (card against CPU: the same draws)
        ("uniform", lambda: R._uniform(key, [500], "float32", -2.0, 3.0),
         [], "value"),
        ("normal", lambda: R._normal(key, [500], "float32", 1.0, 2.0), [],
         "value"),
        ("randint", lambda: R._randint(key, [500], -5, 9, "int64"), [],
         "value"),
        ("randperm", lambda: R._randperm(key, 300, "int64"), [], "value"),
        ("bernoulli", lambda p: R._bernoulli(key, p),
         [np.full(400, 0.3, np.float32)], "value"),
        ("multinomial", lambda p: R._multinomial(key, p, 3, False),
         [np.array([0.1, 0.2, 0.3, 0.4], np.float32)], "value"),
        ("poisson", lambda lam: R._poisson(key, lam),
         [np.array([0.5, 3.0, 9.5, 12.0, 40.0, 0.0] * 20, np.float32)],
         "mostly"),
        ("exponential", lambda: R._exponential(key, [500], 2.0, "float32"),
         [], "value"),
        # extras
        ("logcumsumexp", lambda x: pt.logcumsumexp(x, axis=1), [f32(4, 16)],
         "value"),
        ("cdist", lambda x, y: pt.cdist(x, y), [f32(5, 3), f32(6, 3)],
         "value"),
        ("take-wrap", lambda x, i: pt.take(x, i, mode="wrap"),
         [f32(3, 4), np.array([0, 13, -2, -20, 11])], "value"),
        ("masked_scatter", lambda x, m, v: pt.masked_scatter(x, m != 0, v),
         [f32(3, 4), ints(3, 4, lo=0, hi=2), f32(5)], "value"),
        ("frexp", lambda x: pt.frexp(x), [f32(4, 8)], "value"),
        ("i0", lambda x: pt.i0(x), [f32(4, 8)], "value"),
        ("top_p_sampling", lambda p: X._top_p_sampling(
            key, p, np.full(4, 0.8, np.float32), None),
         [np.abs(f32(4, 6)) / np.abs(f32(4, 6)).sum(-1, keepdims=True)],
         "value"),
    ]


def _close(torch, got, ref, what):
    """One output of the card against the CPU's: dtype, shape, values."""
    check(got.dtype == ref.dtype and tuple(got.shape) == tuple(ref.shape),
          f"ops_vs_cpu {what}: {got.dtype}{tuple(got.shape)} on the card, "
          f"{ref.dtype}{tuple(ref.shape)} on the CPU")
    g, r = got.cpu(), ref
    if r.is_floating_point() or r.is_complex():
        rtol, atol = OPS_TOL["bfloat16" if r.dtype == torch.bfloat16
                             else "float32"]
        g, r = g.double(), r.double()
        same_nan = torch.equal(torch.isnan(g), torch.isnan(r))
        top = float(r.nan_to_num().abs().max()) if r.numel() else 0.0
        bad = (g - r).abs() > atol * top + rtol * r.abs()
        bad &= ~torch.isnan(r)
        check(same_nan and not bool(bad.any()),
              f"ops_vs_cpu {what}: max |diff| "
              f"{float((g - r).nan_to_num().abs().max())}")
        return float((g - r).nan_to_num().abs().max())
    check(torch.equal(g, r), f"ops_vs_cpu {what}: values differ")
    return 0.0


def phase_ops_vs_cpu(torch):
    """Phase 52: the ported ops on the card against the same op on the
    CPU, at small shapes (ops_cases): every op of the BERT and ResNet
    paths and at least five ops of each ops/ file, where CUDA may differ
    (ties, unique, nonzero, repeated indices, bf16 cumsum and sums, the
    decompositions, the random draws from one key): dtypes, shapes and
    values at OPS_TOL; the decompositions also through their invariants
    on each device."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import place as pplace
    prev = pplace._CURRENT_PLACE[0]
    worst, names = {}, set()
    try:
        for name, fn, arrays, kind in ops_cases(torch):
            outs = {}
            for dev in ("cpu", "gpu"):
                pt.set_device(dev)
                d = "cpu" if dev == "cpu" else "cuda"
                ins = [torch.from_numpy(np.ascontiguousarray(a)).to(d)
                       for a in arrays]
                res = fn(*ins)
                res = list(res) if isinstance(res, (tuple, list)) else [res]
                outs[dev] = (res, ins)
            card, cpu = outs["gpu"][0], outs["cpu"][0]
            check(len(card) == len(cpu), f"ops_vs_cpu {name}: arity")
            if kind == "linalg":
                inv = max(_invariants(torch, name.split("-")[0], o, i)
                          for o, i in (outs["gpu"], outs["cpu"]))
                check(inv < OPS_TOL["linalg"],
                      f"ops_vs_cpu {name}: invariant off by {inv}")
                free = {"qr": [lambda o: o[1].diagonal(0, -2, -1).abs()],
                        "svd": [lambda o: o[1]], "eigh": [lambda o: o[0]],
                        "solve": [lambda o: o[0]]}[name]
                err = max(float((f(card).double().cpu()
                                 - f(cpu).double()).abs().max())
                          for f in free)
                check(err < OPS_TOL["linalg"] * float(
                    outs["cpu"][1][0].abs().max()),
                      f"ops_vs_cpu {name}: {err}")
                worst[name] = dict(invariants=inv, max_abs_err=err)
            elif kind == "mostly":
                c, r = card[0], cpu[0]
                check(c.dtype == r.dtype and c.shape == r.shape,
                      f"ops_vs_cpu {name}: dtype or shape")
                same = float((c.cpu() == r).double().mean())
                check(same >= 0.98, f"ops_vs_cpu {name}: {same} equal")
                worst[name] = dict(equal_share=same)
            else:
                worst[name] = max(_close(torch, c, r, f"{name}[{i}]")
                                  for i, (c, r) in enumerate(zip(card, cpu)))
            names.add(name.split("-")[0])
    finally:
        pplace._CURRENT_PLACE[0] = prev
    return dict(cases=len(worst), ops_checked=len(names), tolerance=OPS_TOL,
                max_abs_err=worst)


def host_us(torch, fn, calls=4000):
    """Host µs a call: ``calls`` calls back to back, synchronised at the
    end (the small kernel each queues runs in far less than a call's host
    time)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def phase_dispatch_cost(torch, amp47, amp48):
    """Phase 53: the host cost of a dispatch: one registered ``ops.add``
    against a bare ``torch.add`` on a 16-element CUDA tensor, AMP off and
    under O2, plain and facade arguments, in turns (bare, op, op, bare);
    the ops phases 47 and 48 dispatch a step (the forward: autograd's
    backward does not go through the registry) beside those steps' ms."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp
    x = torch.ones(16, device="cuda")
    fx = pt.Tensor(x)
    runs = {"bare": lambda: torch.add(x, x), "op": lambda: pt.add(x, x),
            "op_facade": lambda: pt.add(fx, fx)}
    res = {}
    for level in ("off", "O2"):
        turns = {k: [] for k in runs}
        for k in list(runs) + list(runs)[::-1]:
            if level == "off":
                turns[k].append(host_us(torch, runs[k]))
            else:
                with amp.auto_cast(level="O2", dtype="bfloat16"):
                    turns[k].append(host_us(torch, runs[k]))
        res[level] = {k: min(v) for k, v in turns.items()}
        res[level]["op_over_bare_us"] = res[level]["op"] - res[level]["bare"]
        res[level]["turns"] = turns
    per_step = {}
    for label, out in (("phase_47_resnet50_o2", amp47),
                       ("phase_48_bert_base_o1", amp48)):
        for route in ("fused", "dense"):
            stats = out[route]["operator_stats"]
            n = sum(r["calls"] for r in stats.values())
            per_step[f"{label}_{route}"] = dict(
                ops_dispatched_per_step=n,
                ms_per_step=out[route]["ms_per_step"],
                dispatch_host_ms_per_step=n * res[
                    "O2" if "o2" in label else "off"]["op"] / 1e3)
    return dict(tensor="16 float32 on the card", calls_per_turn=4000,
                order="bare, op, op_facade, op_facade, op, bare",
                host_us_per_call=res, steps=per_step,
                pr20_ms_per_step=dict(phase_47_resnet50_o2_fused=94.45,
                                      phase_48_bert_base_o1_fused=319.82))


USER_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke_user_ckpt")


def _bits_equal(torch, a, b):
    """Two tensors (or facades) equal bit for bit: dtype, shape, values."""
    a = torch.Tensor.as_subclass(a, torch.Tensor).detach()
    b = torch.Tensor.as_subclass(b, torch.Tensor).detach()
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _state_bits_equal(torch, sd_a, sd_b):
    """Names of the entries of two state dicts that differ (a missing
    name included); tensors bit for bit, other values by ==."""
    bad = sorted(set(sd_a) ^ set(sd_b))
    for k in set(sd_a) & set(sd_b):
        a, b = sd_a[k], sd_b[k]
        if isinstance(a, torch.Tensor):
            if not (isinstance(b, torch.Tensor) and _bits_equal(torch, a, b)):
                bad.append(k)
        elif a != b:
            bad.append(k)
    return bad


def _grad_split(counts, steps_of_backward):
    """bert_launches' counts with the backward kernels run
    ``steps_of_backward`` times (paddle.grad, then .backward(), on one
    graph)."""
    return {k: n * (steps_of_backward if k in (
        "flash_dq", "flash_dkv", "flash_bwd_prep", "fused_mlp_dx",
        "fused_mlp_dw", "fused_proj_ln_bwd", "fused_ln_bwd") else 1)
        for k, n in counts.items()}


def user_bert(torch, cfg, b, s):
    """Phase 54 (a): bert-base as a user's script drives it (the
    configuration of phase 23: dropout 0, the padding mask, AdamW at lr
    1e-4 and decay 0.01, bf16 on the card), through nothing but
    ``import paddle_tpu_torch as paddle``. Two steps (the second takes
    ``paddle.grad`` and ``.backward()`` of one loss: bit for bit the same
    gradients), a forward under ``paddle.no_grad()`` (the same bits, no
    output requiring a gradient, a lower peak read through
    ``paddle.device.cuda``), a forward under ``stream_guard`` on a second
    stream after an ``Event`` handoff (the same bits), then ``paddle.save``
    of the model's and AdamW's state dicts, ``set_state_dict(paddle.load
    (...))`` into a fresh model from another seed and a fresh AdamW (every
    tensor bit for bit, nothing missing or unexpected), and one more step
    from each (the same loss and parameters, bit for bit)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import bert

    def build(seed):
        with paddle.utils.unique_name.guard():
            model = bert.BertForPretraining(cfg, seed=seed)
        opt = paddle.optimizer.AdamW(learning_rate=BERT_LR, weight_decay=0.01,
                                     parameters=model.parameters())
        return model, opt

    rng = np.random.default_rng(0)
    lengths = bert_lengths(b, s, 0)
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int64)
    mlm = np.where((rng.random((b, s)) < 0.15) & (mask == 1), ids, -100)
    ids, mask, mlm, nsp = (paddle.to_tensor(a) for a in (
        ids, mask, mlm, rng.integers(0, 2, (b,))))

    def step(model, opt):
        loss = model.loss(ids, mlm, nsp, attention_mask=mask)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    out = {}
    model, opt = build(0)
    want = bert_launches(cfg, fused=True)
    reset_launches()
    losses = [float(step(model, opt))]
    counts = read_launches()
    check(counts == {k: want.get(k, 0) for k in counts},
          f"user bert step 1 launches {counts}, want {want}")
    out["routes"] = dict(
        flash_fwd=fwd_routes_reading(counts, "user bert"),
        flash_bwd=bwd_routes_reading(counts, "user bert"),
        proj_ln=pl_routes_reading(counts, "user bert"),
        mlp_fwd=mlp_fwd_routes_reading(counts, "user bert"),
        mlp_bwd=mlp_bwd_routes_reading(counts, "user bert"),
        ln_bwd=ln_bwd_routes_reading(counts, "user bert"))
    out["launches_step_1"] = counts
    # step 2: paddle.grad beside .backward() on one graph
    reset_launches()
    loss = model.loss(ids, mlm, nsp, attention_mask=mask)
    params = model.parameters()
    grads = paddle.grad(loss, params, retain_graph=True)
    loss.backward()
    differ = [p.name for g, p in zip(grads, params)
              if not _bits_equal(torch, g, p.grad)]
    check(not differ, f"paddle.grad differs from .backward() at {differ}")
    opt.step()
    opt.clear_grad()
    losses.append(float(loss))
    counts = read_launches()
    want2 = _grad_split(want, 2)
    check(counts == {k: want2.get(k, 0) for k in counts},
          f"user bert step 2 launches {counts}, want {want2}")
    out["launches_step_2"] = counts
    out["grad_equals_backward"] = dict(parameters=len(params), differing=0)
    # the forward in grad mode, under paddle.no_grad(), on a second stream
    mem = paddle.device.cuda
    mem.reset_max_memory_allocated()
    outs = model(ids, attention_mask=mask)
    peak_grad = mem.max_memory_allocated()
    # the models' entry points hand back plain tensors (core/tensor.py)
    check(all(o.requires_grad for o in outs), "grad-mode outputs")
    outs = [o.detach() for o in outs]
    mem.reset_max_memory_allocated()
    with paddle.no_grad():
        outs_ng = model(ids, attention_mask=mask)
    peak_ng = mem.max_memory_allocated()
    check(not any(o.requires_grad for o in outs_ng),
          "a no_grad output requires a gradient")
    check(all(_bits_equal(torch, a, b) for a, b in zip(outs, outs_ng)),
          "the no_grad forward differs from the grad-mode forward")
    out["no_grad"] = dict(peak_gb=peak_ng / 1e9,
                          grad_mode_peak_gb=peak_grad / 1e9,
                          torch_peak_gb=torch.cuda.max_memory_allocated()
                          / 1e9)
    check(peak_ng < peak_grad and peak_ng == torch.cuda.max_memory_allocated(),
          f"no_grad peak memory {out['no_grad']}")
    side = paddle.device.Stream()
    ready = paddle.device.Event()
    ready.record()
    side.wait_event(ready)
    reset_launches()
    with paddle.device.stream_guard(side), paddle.no_grad():
        check(paddle.device.current_stream() == side,
              "stream_guard did not make the stream current")
        outs_s = model(ids, attention_mask=mask)
        done = side.record_event()
    paddle.device.current_stream().wait_event(done)
    counts = read_launches()
    fwd = {k: n for k, n in want.items() if k in (
        "flash_fwd", "fused_mlp_fwd", "fused_proj_ln_fwd", "fused_ln_fwd")}
    check({k: n for k, n in counts.items() if n} == fwd,
          f"side-stream forward launches {counts}, want {fwd}")
    check(all(_bits_equal(torch, a, b) for a, b in zip(outs_ng, outs_s)),
          "the forward on a second stream differs from the default stream's")
    out["stream"] = dict(launches=fwd, equal=True)
    del outs_s
    del outs, outs_ng
    # save, restore into a fresh model and AdamW, resume
    os.makedirs(USER_CKPT, exist_ok=True)
    t0 = time.perf_counter()
    paddle.save(model.state_dict(), os.path.join(USER_CKPT, "bert.pdparams"))
    paddle.save(opt.state_dict(), os.path.join(USER_CKPT, "bert.pdopt"))
    save_s = time.perf_counter() - t0
    fresh, fresh_opt = build(1)
    t0 = time.perf_counter()
    missing, unexpected = fresh.set_state_dict(paddle.load(
        os.path.join(USER_CKPT, "bert.pdparams")))
    fresh_opt.set_state_dict(paddle.load(os.path.join(USER_CKPT,
                                                      "bert.pdopt")))
    load_s = time.perf_counter() - t0
    check(missing == [] and unexpected == [],
          f"set_state_dict: missing {missing}, unexpected {unexpected}")
    bad = (_state_bits_equal(torch, model.state_dict(), fresh.state_dict())
           + _state_bits_equal(torch, opt.state_dict(),
                               fresh_opt.state_dict()))
    check(not bad, f"restored state differs at {bad[:8]}")
    resumed = float(step(fresh, fresh_opt))
    uninterrupted = float(step(model, opt))
    pbad = _state_bits_equal(torch, model.state_dict(), fresh.state_dict())
    check(np.isfinite(losses).all() and resumed == uninterrupted
          and not pbad,
          f"the resumed step differs: loss {resumed} vs {uninterrupted}, "
          f"parameters {pbad[:8]}")
    out.update(losses=losses, resumed_loss=resumed,
               uninterrupted_loss=uninterrupted,
               state_tensors=len(model.state_dict()),
               optimizer_tensors=len(opt.state_dict()) - 1,
               save_s=save_s, load_s=load_s, missing=missing,
               unexpected=unexpected)
    return out


def user_resnet(torch, b, hw):
    """Phase 54 (b): phase 47's loop as a user's script (resnet50, f32
    parameters under auto_cast O2 bf16, Momentum(0.1, 0.9), the BN kernels
    15-18): two steps, ``paddle.save`` of the model's state dict (the BN
    running statistics among its buffers) and Momentum's (the velocity),
    restore into a fresh model and optimizer, bit for bit, then one more
    step from each. The resumed loss must equal the uninterrupted one
    within the spread of two forwards from one in-memory state (0 when
    the forward is deterministic: then bit for bit); the parameters within
    lr times the spread of two backwards from one state (plus two ulps of
    the largest parameter), as cuDNN's backward may not be
    deterministic."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F

    def build(seed):
        with paddle.utils.unique_name.guard():
            net = paddle.vision.models.resnet50(num_classes=RESNET_CLASSES,
                                                dtype=torch.float32,
                                                seed=seed)
        opt = paddle.optimizer.Momentum(RESNET_LR, momentum=RESNET_MOMENTUM,
                                        parameters=net.parameters())
        return net, opt

    rng = np.random.default_rng(0)
    x = paddle.to_tensor(rng.standard_normal((b, 3, hw, hw)).astype(
        np.float32))
    y = paddle.to_tensor(rng.integers(0, RESNET_CLASSES, (b, 1)))

    def forward(net):
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = net(x)
        return F.cross_entropy(paddle.cast(logits, "float32"), y)

    def step(net, opt):
        loss = forward(net)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss.detach())

    net, opt = build(0)
    reset_launches()
    losses = [step(net, opt), step(net, opt)]
    counts = read_launches()
    out = dict(losses=losses)
    want = {"fused_bn_fwd": 2 * RESNET_BNS, "fused_bn_bwd": 2 * RESNET_BNS}
    check({k: n for k, n in counts.items() if n} == want,
          f"user resnet launches {counts}, want {want}")
    out["bn_routes"] = dict(
        forward=bn_fwd_routes_reading(counts, "user resnet"),
        backward=bn_bwd_routes_reading(counts, "user resnet"))
    out["launches_two_steps"] = {k: n for k, n in counts.items() if n}
    os.makedirs(USER_CKPT, exist_ok=True)
    t0 = time.perf_counter()
    paddle.save(net.state_dict(), os.path.join(USER_CKPT, "resnet.pdparams"))
    paddle.save(opt.state_dict(), os.path.join(USER_CKPT, "resnet.pdopt"))
    save_s = time.perf_counter() - t0
    fresh, fresh_opt = build(1)
    missing, unexpected = fresh.set_state_dict(paddle.load(
        os.path.join(USER_CKPT, "resnet.pdparams")))
    fresh_opt.set_state_dict(paddle.load(os.path.join(USER_CKPT,
                                                      "resnet.pdopt")))
    check(missing == [] and unexpected == [],
          f"resnet set_state_dict: missing {missing}, unexpected {unexpected}")
    sd = net.state_dict()
    buffers = [k for k in sd if k.endswith(("_mean", "_variance"))]
    check(len(buffers) == 2 * RESNET_BNS, f"resnet buffers {len(buffers)}")
    bad = (_state_bits_equal(torch, sd, fresh.state_dict())
           + _state_bits_equal(torch, opt.state_dict(),
                               fresh_opt.state_dict()))
    check(not bad, f"restored resnet state differs at {bad[:8]}")
    # the spread of two forwards and of two backwards from one state
    params = net.parameters()
    la, lb = forward(net), forward(net)
    ga = paddle.grad(la, params)
    gb = paddle.grad(lb, params)
    loss_spread = abs(float(la) - float(lb))
    grad_spread = max(float((torch.Tensor.as_subclass(g, torch.Tensor)
                             - torch.Tensor.as_subclass(h, torch.Tensor))
                            .abs().max()) for g, h in zip(ga, gb))
    del la, lb, ga, gb
    resumed = step(fresh, fresh_opt)
    uninterrupted = step(net, opt)
    pdiff = max(float((torch.Tensor.as_subclass(p, torch.Tensor)
                       - torch.Tensor.as_subclass(q, torch.Tensor))
                      .abs().max()) for p, q in
                zip(net.parameters(), fresh.parameters()))
    top = max(float(p.detach().abs().max()) for p in net.parameters())
    bound = RESNET_LR * grad_spread + 2 * np.spacing(np.float32(top))
    check(all(np.isfinite(losses)) and np.isfinite(resumed)
          and abs(resumed - uninterrupted) <= loss_spread and pdiff <= bound,
          f"the resumed resnet step differs: loss {resumed} vs "
          f"{uninterrupted} (spread {loss_spread}), parameters by {pdiff} "
          f"(bound {bound})")
    out.update(resumed_loss=resumed, uninterrupted_loss=uninterrupted,
               forward_spread=loss_spread, backward_grad_spread=grad_spread,
               resumed_params_max_abs_diff=pdiff,
               bitwise=resumed == uninterrupted and pdiff == 0.0,
               state_tensors=len(sd), running_stat_buffers=len(buffers),
               optimizer_tensors=len(opt.state_dict()) - 1, save_s=save_s,
               missing=missing, unexpected=unexpected)
    return out


def user_pylayer(torch, device):
    """Phase 54 (c): a PyLayer with its own backward (y = x·tanh(x), its
    derivative written by hand) on ``device``: the outputs and gradients
    of a [64, 256] f32 input."""
    import paddle_tpu_torch as paddle

    class XTanh(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            t = paddle.tanh(x)
            ctx.save_for_backward(x, t)
            return x * t

        @staticmethod
        def backward(ctx, g):
            x, t = ctx.saved_tensor()
            return g * (t + x * (1.0 - t * t))

    rng = np.random.default_rng(5)
    x = paddle.to_tensor(rng.standard_normal((64, 256)).astype(np.float32),
                         place=device, stop_gradient=False)
    w = paddle.to_tensor(rng.standard_normal((64, 256)).astype(np.float32),
                         place=device)
    y = XTanh.apply(x)
    (y * w).sum().backward()
    return y.numpy(), x.grad.numpy()


def phase_user_script(torch):
    """Phase 54: a Paddle user's script on the card: (a) user_bert at
    bert-base's full width and depth, B=32, S=512; (b) user_resnet at
    B=256, 224²; (c) user_pylayer on the card against the CPU."""
    from paddle_tpu_torch import set_flags
    t0 = time.perf_counter()
    set_flags({"FLAGS_fused_norm": True, "FLAGS_fused_mlp": True})
    from paddle_tpu_torch.models import bert
    cfg = bert.CONFIGS["bert-base"]._replace(
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    out = dict(bert=user_bert(torch, cfg, BERT_B, BERT_S))
    free_card(torch)
    out["resnet50"] = user_resnet(torch, RESNET_B, RESNET_HW)
    free_card(torch)
    (yc, gc_), (yp, gp) = user_pylayer(torch, "gpu"), user_pylayer(torch,
                                                                   "cpu")
    atol, rtol = TOL["float32"]
    err = max(float(np.abs(yc - yp).max()), float(np.abs(gc_ - gp).max()))
    check(np.allclose(yc, yp, atol=atol, rtol=rtol)
          and np.allclose(gc_, gp, atol=atol, rtol=rtol),
          f"PyLayer on the card differs from the CPU by {err}")
    out["pylayer"] = dict(max_abs_err=err, tolerance=TOL["float32"])
    shutil.rmtree(USER_CKPT, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def free_card(torch):
    """Drop what the phases before left for the collector, return the
    cached blocks and restart the peak count."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import bert, gpt, llama

    # full-precision matmuls for every comparison below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = gpu_line()
    phase(1, "environment", torch=torch.__version__, cuda=torch.version.cuda,
          device=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=card,
          allow_tf32=False, allow_bf16_reduced_precision_reduction=False)
    print(card, flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    phase(2, "build", seconds=time.perf_counter() - t0,
          libraries=[str(p.name) for p in libs.values()],
          ptxas=[ln.strip() for log in _build.build_log.values()
                 for ln in log.splitlines() if "registers" in ln],
          flash_wgmma_ptxas=wgmma_ptxas(_build.build_log),
          proj_ln_cluster_ptxas=pl_cluster_ptxas(_build.build_log),
          fused_mlp_wgmma_ptxas=mlp_wgmma_ptxas(_build.build_log),
          decode_split_ptxas=route_ptxas(
              _build.build_log, "decode_attn_proj.cu",
              "decode_attn_split_kernel|decode_proj_kernel"),
          ln_persistent_ptxas=route_ptxas(_build.build_log, "norm_fusion.cu",
                                          "ln_bwd_persist"),
          bn_persistent_ptxas=route_ptxas(_build.build_log, "norm_fusion.cu",
                                          "bn_bwd_persist"),
          bn_cluster_ptxas=route_ptxas(_build.build_log, "norm_fusion.cu",
                                       "bn_fwd_cluster"))

    kern = phase_kernel_vs_plain(torch)
    phase(3, "decode_attn_proj vs plain", tolerance=TOL, **kern)

    model = gpt.GPTForCausalLM(gpt.CONFIGS["gpt3-1.3b"], seed=0)
    serve1, eng = phase_serve_b1(torch, model)
    phase(4, "serve gpt3-1.3b bf16 max_batch=1 kernel on", **serve1)
    prof = phase_profile_b1(torch, eng, model.cfg.vocab_size)
    phase(5, "profile of the B=1 decode step", **prof)
    del eng
    serve4 = phase_serve_b4(torch, model)
    phase(6, "serve gpt3-1.3b bf16 max_batch=4 k=4", **serve4)
    del model
    torch.cuda.empty_cache()
    par = phase_parity_fp32(torch)
    phase(7, "parity fp32 kernel vs composite", **par)
    torch.cuda.empty_cache()

    flash = phase_flash_vs_plain(torch)
    phase(8, "flash attention kernels vs plain", **flash)
    mlp = phase_mlp_vs_plain(torch)
    phase(9, "fused MLP kernels vs plain", **mlp)
    cfg = gpt.CONFIGS["gpt3-1.3b"]._replace(
        remat_policy="save_small", opt_dtype=torch.bfloat16, lm_head="auto")
    train, params, opt, batch = phase_train(torch, cfg, fused=True)
    phase(10, "train gpt3-1.3b bf16 B=4 S=2048 save_small fused MLP",
          **train)
    prof11 = phase_profile_train(torch, cfg, params, opt, batch)
    phase(11, "profile of the training step", **prof11)
    phase(12, "remat full launches",
          **phase_remat_full(torch, cfg, params, opt, batch))
    del params, opt, batch
    torch.cuda.empty_cache()
    dense, params, opt, batch = phase_train(torch, cfg, fused=False, steps=2)
    del params, opt, batch
    torch.cuda.empty_cache()
    # the fused route may hold its kernels' workspace beyond what the
    # dense route needs, no more
    work_gb = mlp_workspace_gb(TRAIN_B * TRAIN_S, cfg.hidden_size, cfg.ffn, 2)
    extra_gb = train["peak_memory_gb"] - dense["peak_memory_gb"]
    check(extra_gb <= work_gb, f"fused MLP step peaks {extra_gb} GB above "
          f"the dense one (workspace {work_gb} GB)")
    phase(13, "train gpt3-1.3b bf16 B=4 S=2048 save_small dense MLP",
          fused_peak_minus_dense_gb=extra_gb, mlp_workspace_gb=work_gb,
          **dense)
    set_flags({"FLAGS_fused_mlp": True})
    phase(14, "training parity fp32 fused vs dense MLP, flash vs dense "
          "attention", **phase_train_parity_fp32(torch))

    free_card(torch)
    swiglu = phase_swiglu_vs_plain(torch)
    phase(15, "fused SwiGLU kernels vs plain", **swiglu)
    free_card(torch)
    lcfg = llama.CONFIGS["llama-7b"]
    ltrain, lmodel, lopt, lstep = phase_train_llama(torch, lcfg, fused=True)
    phase(16, "train llama-7b bf16 B=1 S=2048 fused SwiGLU, Layer model + "
          "AdamW", **ltrain)
    prof17 = phase_profile_llama(torch, lstep)
    phase(17, "profile of the llama-7b training step", **prof17)
    del lmodel, lopt, lstep
    free_card(torch)
    ldense, lmodel, lopt, lstep = phase_train_llama(torch, lcfg, fused=False,
                                                    steps=2)
    del lmodel, lopt, lstep
    free_card(torch)
    # as for GPT: the fused route may hold its kernels' workspace beyond
    # what the dense route needs, no more
    work_gb = swiglu_workspace_gb(LLAMA_S, lcfg.hidden_size,
                                  lcfg.intermediate_size, 2)
    extra_gb = ltrain["peak_memory_gb"] - ldense["peak_memory_gb"]
    check(extra_gb <= work_gb, f"fused SwiGLU step peaks {extra_gb} GB above "
          f"the dense one (workspace {work_gb} GB)")
    phase(18, "train llama-7b bf16 B=1 S=2048 dense SwiGLU",
          fused_peak_minus_dense_gb=extra_gb, swiglu_workspace_gb=work_gb,
          **ldense)
    set_flags({"FLAGS_fused_mlp": True})
    phase(19, "llama training parity fp32 SwiGLU kernels vs dense, flash vs "
          "dense attention", **phase_llama_parity_fp32(torch))

    free_card(torch)
    ln = phase_ln_vs_plain(torch)
    phase(20, "LayerNorm kernels vs plain", **ln)
    pl = phase_proj_ln_vs_plain(torch)
    phase(21, "projection-LayerNorm kernels vs plain", **pl)
    fbias = phase_flash_bias_vs_plain(torch)
    phase(22, "flash kernels, key-padding bias, vs plain", **fbias)
    free_card(torch)
    bcfg = bert.CONFIGS["bert-base"]._replace(
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    btrain, bmodel, bstep = phase_train_bert(torch, bcfg, fused=True)
    phase(23, "train bert-base bf16 B=32 S=512 (padded) MLM+NSP, fused "
          "kernels, Layer model + AdamW", **btrain)
    prof24 = phase_profile_bert(torch, bstep)
    phase(24, "profile of the bert-base training step", **prof24)
    del bmodel, bstep
    free_card(torch)
    bdense, bmodel, bstep = phase_train_bert(torch, bcfg, fused=False,
                                             steps=2)
    del bmodel, bstep
    free_card(torch)
    phase(25, "train bert-base bf16 B=32 S=512 dense norms, projection and "
          "MLP (flash kept)", fused_ms_per_step=btrain["ms_per_step"],
          **bdense)
    phase(26, "bert training parity fp32 fused vs dense",
          **phase_bert_parity_fp32(torch))

    free_card(torch)
    bn = phase_bn_vs_plain(torch)
    phase(27, "fused BatchNorm kernels vs plain", **bn)
    free_card(torch)
    rtrain, rnet, rstep = phase_train_resnet(torch, fused=True)
    phase(28, "train resnet50 bf16 B=256 224x224 fused BatchNorm, Layer "
          "model + Momentum", **rtrain)
    phase(29, "profile of the resnet50 training step",
          **phase_profile_resnet_turns(torch, rstep))
    del rnet, rstep
    free_card(torch)
    rdense, rnet, rstep = phase_train_resnet(torch, fused=False, steps=2)
    del rnet, rstep
    free_card(torch)
    set_flags({"FLAGS_fused_norm": True})
    phase(30, "train resnet50 bf16 B=256 224x224 dense BatchNorm",
          fused_ms_per_step=rtrain["ms_per_step"], **rdense)
    phase(31, "resnet50 parity fp32 fused vs dense BatchNorm",
          **phase_resnet_parity_fp32(torch))

    free_card(torch)
    phase(32, "dropout keep-mask: the device hash vs plain, bit for bit",
          **phase_dropout_bits(torch))
    free_card(torch)
    dcfg = bert.CONFIGS["bert-base"]        # the default rates, 0.1 / 0.1
    dtrain, dmodel, dstep = phase_train_bert(torch, dcfg, fused=True)
    phase(33, "train bert-base bf16 B=32 S=512 (padded) MLM+NSP at the "
          "default dropout 0.1/0.1, fused kernels, Layer model + AdamW",
          **dtrain)
    phase(34, "profile of the bert-base step at the default dropout",
          embeddings_dropout_mask_ms=dropout_mask_ms(torch),
          **phase_profile_bert(torch, dstep))
    del dmodel, dstep
    free_card(torch)
    ddense, dmodel, dstep = phase_train_bert(torch, dcfg, fused=False,
                                             steps=2)
    del dmodel, dstep
    free_card(torch)
    set_flags({"FLAGS_fused_norm": True, "FLAGS_fused_mlp": True})
    phase(35, "train bert-base bf16 B=32 S=512 at the default dropout, "
          "dense norms, projection and MLP (flash kept)",
          fused_ms_per_step=dtrain["ms_per_step"], **ddense)
    phase(36, "bert parity fp32 at dropout 0.1/0.1: card kernels vs CPU "
          "plain versions", **phase_bert_dropout_parity_fp32(torch))
    free_card(torch)
    mdrop = phase_mlp_dropout_vs_plain(torch)
    phase(37, "fused MLP dropout kernels vs plain", **mdrop)
    mpar = phase_mlp_dropout_parity_fp32(torch)
    phase(38, "F.fused_mlp at dropout 0.1: card kernels vs the CPU's plain "
          "versions, fp32", **mpar)

    free_card(torch)
    smodel = llama.LlamaForCausalLM(
        lcfg._replace(num_hidden_layers=LLAMA_SERVE_LAYERS), seed=0,
        dtype=torch.bfloat16)
    serve39, plain_streams = phase_serve_llama_b4(torch, smodel)
    phase(39, f"serve llama-7b bf16 ({LLAMA_SERVE_LAYERS} of 32 layers) "
          f"max_batch=4 k=4", layers=LLAMA_SERVE_LAYERS, **serve39)
    free_card(torch)
    phase(40, f"serve llama-7b bf16 ({LLAMA_SERVE_LAYERS} of 32 layers) "
          f"fast path", layers=LLAMA_SERVE_LAYERS,
          **phase_serve_llama_fast(torch, smodel, plain_streams,
                                   serve39["fast_traffic_plain"]))
    del smodel
    free_card(torch)
    gmodel = gpt.GPTForCausalLM(gpt.CONFIGS["gpt3-1.3b"], seed=0)
    gfast = phase_serve_gpt_fast(torch, gmodel)
    phase(41, "serve gpt3-1.3b bf16 fast path, decode kernel in the draft",
          **gfast)
    del gmodel
    free_card(torch)
    phase(42, "fast-path parity fp32", **phase_fastpath_parity_fp32(torch))

    free_card(torch)
    phase(43, "ppyoloe-s eval stream, mixed sizes on the bucket ladder, f32",
          **phase_ppyoloe_eval_stream(torch))
    free_card(torch)
    ptrain = phase_train_ppyoloe(torch)
    phase(44, "train ppyoloe-l f32 B=8 640x640 fused BatchNorm, Layer model "
          "+ Momentum", **ptrain)
    free_card(torch)
    pbn = phase_ppyoloe_bn_vs_plain(torch)
    phase(45, "fused BatchNorm kernels vs plain at ppyoloe's shapes", **pbn)
    free_card(torch)
    phase(46, "ppyoloe-s parity fp32: card kernels vs CPU plain versions",
          **phase_ppyoloe_parity_fp32(torch))

    free_card(torch)
    amp47 = phase_train_resnet_amp(torch)
    phase(47, "train resnet50 B=256 224x224 under AMP O2 bf16, f32 "
          "parameters, fused and dense BatchNorm in turns, Layer model + "
          "Momentum", **amp47)
    free_card(torch)
    amp48 = phase_train_bert_amp(torch)
    phase(48, "train bert-base B=64 S=512 under AMP O1 bf16, f32 "
          "parameters, dropout 0.1/0.1, fused and dense in turns, Layer "
          "model + AdamW", **amp48)
    free_card(torch)
    phase(49, "AMP parity: card vs CPU route, resnet50 O2 and bert-base O1",
          **phase_amp_parity(torch))
    free_card(torch)
    phase(50, "AMP tools: GradScaler, decorate O2, schedulers, clipping, "
          "apply_decay_param_fun", **phase_amp_tools(torch))
    free_card(torch)
    phase(51, "train bert-base B=32 S=512 (padded) under AMP O2 bf16, f32 "
          "parameters, one step: bf16 loss arithmetic, the CPU's operator "
          "table", **phase_train_bert_o2(torch))
    free_card(torch)
    phase(52, "ops_vs_cpu: the ported ops on the card against the CPU",
          **phase_ops_vs_cpu(torch))
    phase(53, "dispatch host cost: ops.add against torch.add, the ops a "
          "step of phases 47 and 48", **phase_dispatch_cost(torch, amp47,
                                                           amp48))
    free_card(torch)
    phase(54, "a Paddle user's script on the card: bert-base and resnet50 "
          "train, paddle.grad, no_grad, a second stream, save, restore, "
          "resume; a PyLayer", **phase_user_script(torch))

    kernels = [{
        "name": "decode_attn_proj", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": serve1["kernel_launches"],
        "max_abs_err": kern["max_abs_err"], "max_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"]}]
    kernels[0].update(
        route_fields(kern),
        source_kernels="decode_attn_split_kernel, then decode_proj_kernel "
                       "(programmatic dependent launch)",
        cuda_launches_per_call=kern["main"]["cuda_launches_per_call"],
        pos_1023_ms=kern["pos_1023"]["ms"],
        pos_1023_library_ms=kern["pos_1023"]["library_ms"],
        kvh_4_ms=kern["kvh_4"]["ms"],
        kvh_4_library_ms=kern["kvh_4"]["library_ms"],
        spec_draft_launches=gfast["kernel_launches"],
        spec_draft_launches_per_round=gfast["kernel_launches_per_round"])
    # the dX and dW kernels run in one backward call and share its times
    # and bound
    for name, src, replaces, res, key in (
            *((n, FLASH_SOURCE, FLASH_REPLACES[n], flash, n)
              for n in ("flash_fwd", "flash_dq", "flash_dkv")),
            ("fused_mlp_fwd", MLP_SOURCE, MLP_REPLACES["fused_mlp_fwd"], mlp,
             "forward"),
            *((n, MLP_SOURCE, MLP_REPLACES[n], mlp, "backward")
              for n in ("fused_mlp_dx", "fused_mlp_dw"))):
        t = res[key]
        err = res["worst"]["bfloat16"][name]["max_abs_err"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": train["launches"][name],
            "max_abs_err": err, "max_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        kernels[-1].update(route_fields(t))
        if key == "forward":
            bert = mlp["bert_base"]["forward"]
            kernels[-1].update(
                source_kernels="per chunk wgmma_gemm_kernel (gemm_core.cuh) "
                               "P1 EpiGelu, then P2 EpiBias / EpiSum",
                cuda_launches_per_call=prof11.get("fused_mlp_fwd_launches"),
                bert_base=dict(ms=bert["ms"], earlier_ms=bert["earlier_ms"],
                               plain_ms=bert["plain_ms"],
                               bound_ms=bert["bound_ms"],
                               library_ms=bert["library_ms"],
                               cuda_launches_per_call=prof24.get(
                                   "fused_mlp_fwd_launches")))
        if key == "backward":
            bert = mlp["bert_base"]["backward"]
            kernels[-1].update(
                source_kernels="colsum_kernel, then per chunk "
                               "gelu_dact_wgmma_kernel (P1) and "
                               "wgmma_gemm_kernel (P2-P4; gemm_core.cuh), "
                               "then sum_parts_kernel",
                composite_backward_ms=t["library_bwd_ms"],
                bert_base=dict(ms=bert["ms"], earlier_ms=bert["earlier_ms"],
                               plain_ms=bert["plain_ms"],
                               bound_ms=bert["bound_ms"],
                               composite_backward_ms=bert["library_bwd_ms"]),
                note="dX and dW run in one backward call, fused_mlp_bwd "
                     "(the wgmma route on the gpt3-1.3b and bert-base "
                     "paths): ms, plain_ms and bound_ms are that call's at "
                     "gpt3-1.3b's shape, bert_base at bert-base's; "
                     "composite_backward_ms the dense composite's autograd "
                     "backward")
        if name == "flash_dkv":
            kernels[-1]["whole_backward"] = flash["backward"]
    # the wgmma backward's pre-pass (qs, ks, delta) at the GPT shape and at
    # bert-base's key-padding shape; its launches are the training steps'
    for label, res, launched in (("", flash, train), ("_kv_bias", fbias,
                                                      btrain)):
        t = res["flash_bwd_prep"]
        err = list(flash["prep"].values())[1 if label else 0][
            "delta_max_abs_err"]
        kernels.append({
            "name": f"flash_bwd_prep{label}", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": FLASH_PREP_REPLACES,
            "launches": launched["launches"]["flash_bwd_prep"],
            "max_abs_err": err, "max_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "note": "qs and ks bit for bit; max_abs_err is delta's"})
    # the SwiGLU kernels' launches are llama-7b training's (phase 16); the
    # dX and dW kernels run in one backward call (fused_swiglu_bwd)
    for name in SWIGLU_REPLACES:
        t = swiglu["forward" if name == "fused_swiglu_fwd" else "backward"]
        err = swiglu["worst"]["bfloat16"][name]["max_abs_err"]
        kernels.append({
            "name": name, "route": "cuda", "source": MLP_SOURCE,
            "replaces": SWIGLU_REPLACES[name],
            "launches": ltrain["launches"][name], "max_abs_err": err,
            "max_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
        kernels[-1].update(route_fields(t))
        if name == "fused_swiglu_fwd":
            kernels[-1].update(
                source_kernels="per chunk wgmma_gemm_kernel (gemm_core.cuh) "
                               "P1 EpiSwiglu on the paired B, then P2 "
                               "EpiSum / EpiSumLast",
                cuda_launches_per_call=prof17.get("swiglu_fwd_launches"))
        else:
            kernels[-1].update(
                source_kernels="swiglu_dact_wgmma_kernel (P1), "
                               "wgmma_gemm_kernel (P2-P4; gemm_core.cuh)",
                composite_backward_ms=t["library_bwd_ms"],
                note="dX and dW run in one backward call, fused_swiglu_bwd "
                     "(the wgmma route on llama-7b's path): ms, plain_ms and "
                     "bound_ms are that call's; composite_backward_ms the "
                     "dense composite's autograd backward")
    # the LayerNorm and projection-LN kernels' launches are bert-base
    # training's (phase 23); each backward's second launch (the fixed-order
    # sum of the column partials) counts under its backward
    for name, res, key in (("fused_ln_fwd", ln["times"]["residual"],
                            "fused_ln_fwd"),
                           ("fused_ln_bwd", ln["times"]["residual"],
                            "fused_ln_bwd"),
                           ("fused_proj_ln_fwd", pl, "fused_proj_ln_fwd"),
                           ("fused_proj_ln_bwd", pl, "fused_proj_ln_bwd")):
        t = res[key]
        if name.startswith("fused_ln"):
            err = ln["worst"]["bfloat16"][name]["max_abs_err"]
        else:   # the cluster route's kernels: bert-base's path
            err = pl["cluster"]["worst"]["plain"][name]["max_abs_err"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": LN_SOURCE if name.startswith("fused_ln") else PL_SOURCE,
            "replaces": LN_REPLACES[name],
            "launches": btrain["launches"][name], "max_abs_err": err,
            "max_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
        kernels[-1].update(route_fields(t))
        if "kernel_ms" in t:    # the LayerNorm backward's kernels alone
            kernels[-1].update(kernel_ms=t["kernel_ms"], note=t["note"])
        if name == "fused_proj_ln_bwd":
            kernels[-1].update(pl_whole_fields(pl))
    # the flash kernels' key-padding variant at bert-base's attention; its
    # launches are bert-base training's, counted under the flash kernels
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        t = fbias[name]
        err = fbias["worst"]["bfloat16"][name]["max_abs_err"]
        kernels.append({
            "name": f"{name}_kv_bias", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES[name],
            "launches": btrain["launches"][name], "max_abs_err": err,
            "max_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
        kernels[-1].update(route_fields(t))
        if name == "flash_dkv":
            kernels[-1]["whole_backward"] = fbias["backward"]
    # the BatchNorm kernels' launches are resnet50 training's (phase 28),
    # ppyoloe_launches ppyoloe-l training's (phase 44); one op call counts
    # once (the forward: one cluster launch; the backward: its launch and
    # the memset of its counters)
    for name in ("fused_bn_fwd", "fused_bn_bwd"):
        t = bn["times"]["layer1.bn3"][name]
        err = bn["worst"]["bfloat16"][name]["max_abs_err"]
        stem = pbn["times"]["stem_f32"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": LN_SOURCE,
            "replaces": BN_REPLACES[name][0],
            "also_replaces": BN_REPLACES[name][1],
            "launches": rtrain["launches"][name], "max_abs_err": err,
            "max_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "ppyoloe_launches": ptrain["launches"][name],
            "ppyoloe_stem_f32": {k: stem[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "ppyoloe_max_abs_err": {
                d: pbn["worst"][d][name]["max_abs_err"]
                for d in ("float32", "bfloat16")},
            # AMP's O2 casts: bf16 weight and bias at layer 1's bn3, in
            # turns with the same values in f32; the O2 step's launches
            "bf16_vectors_layer1_bn3": {
                k: bn["bf16_vectors"]["layer1.bn3"][name][k]
                for k in ("ms", "ms_f32_vectors")},
            "amp_o2_launches_per_step": amp47["fused"][
                "bn_launches_per_step"]["weight_dtypes"][
                "forward" if name == "fused_bn_fwd" else "backward"]})
        if name == "fused_bn_fwd":
            # the cluster route: its kernel alone against the generic
            # route's four launches (earlier_ms) in turns at each shape
            kernels[-1].update(
                route_fields(t), kernel_ms=t["kernel_ms"],
                cuda_launches_per_call=t["kernel_launches_per_call"],
                memsets_per_call=t["memsets_per_call"],
                source_kernels="bn_fwd_cluster (one launch of thread-block "
                               "clusters)",
                ppyoloe_stem_f32_route=dict(
                    kernel_ms=stem["kernel_ms"],
                    earlier_ms=stem["earlier_ms"]),
                stem_bf16={k: bn["times"]["stem"][name][k] for k in (
                    "ms", "kernel_ms", "earlier_ms", "plain_ms", "bound_ms",
                    "library_ms")},
                shapes={pre + case: {k: v["forward"][k] for k in (
                    "ms", "earlier_ms", "plain_ms", "library_ms", "bound_ms",
                    "x_read_over_x", "k")}
                    for pre, res in (("", bn["shapes"]),
                                     ("ppyoloe_", pbn["shapes"]))
                    for case, v in res["cases"].items()},
                note=t["note"])
        if name == "fused_bn_bwd":
            # the persistent route: its kernel alone against the generic route's four
            # launches (earlier_ms) in turns at each shape
            kernels[-1].update(
                route_fields(t), kernel_ms=t["kernel_ms"],
                cuda_launches_per_call=t["kernel_launches_per_call"],
                memsets_per_call=t["memsets_per_call"],
                source_kernels="bn_bwd_persist (one cooperative launch "
                               "after a memset of the counters)",
                ppyoloe_stem_f32_route=dict(
                    kernel_ms=stem["kernel_ms"],
                    earlier_ms=stem["earlier_ms"]),
                stem_bf16={k: bn["times"]["stem"][name][k] for k in (
                    "ms", "kernel_ms", "earlier_ms", "plain_ms", "bound_ms",
                    "library_ms")},
                host_us_per_call=pbn["host_us_per_call"],
                shapes={pre + case: {k: v["backward"][k] for k in (
                    "persistent_ms", "generic_ms", "bound_ms")}
                    for pre, res in (("", bn["shapes"]),
                                     ("ppyoloe_", pbn["shapes"]))
                    for case, v in res["cases"].items()},
                note=t["note"])
    # the dropout variants (kernels 1-3, 10, 11, 13, 14) at bert-base's
    # shapes; their launches are the default-dropout bert-base training's
    # (phase 33), counted apart from the dropout-free kernels'
    for name, res, times, src in (
            *((n, fbias["dropout"], fbias["dropout"], FLASH_SOURCE)
              for n in ("flash_fwd", "flash_dq", "flash_dkv")),
            *((n, ln["dropout"], ln["dropout"]["times"], LN_SOURCE)
              for n in ("fused_ln_fwd", "fused_ln_bwd")),
            *((n, pl["dropout"], pl["dropout"], PL_SOURCE)
              for n in ("fused_proj_ln_fwd", "fused_proj_ln_bwd"))):
        t = times[name]
        if name.startswith("fused_proj_ln"):
            err = pl["cluster"]["worst"]["dropout"][name]["max_abs_err"]
        else:
            err = res["worst"]["bfloat16"][name]["max_abs_err"]
        kernels.append({
            "name": DROP_NAMES[name], "route": "cuda", "source": src,
            "replaces": (FLASH_REPLACES.get(name) or LN_REPLACES[name]),
            "launches": dtrain["launches"][f"dropout_{name}"],
            "max_abs_err": err, "max_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        kernels[-1].update(route_fields(t))
        if "kernel_ms" in t:
            kernels[-1].update(kernel_ms=t["kernel_ms"], note=t["note"])
        if name == "fused_proj_ln_bwd":
            kernels[-1].update(pl_whole_fields(pl["dropout"]))
    # the fused MLP's dropout variants (kernels 4-6) at gpt3-1.3b's width;
    # their launches are phase 38's (two F.fused_mlp calls at p = 0.1)
    for name in ("fused_mlp_fwd", "fused_mlp_dx", "fused_mlp_dw"):
        t = mdrop["times"]["gpt3-1.3b"][
            "forward" if name == "fused_mlp_fwd" else "backward"]
        err = mdrop["worst"]["bfloat16"][name]["max_abs_err"]
        kernels.append({
            "name": DROP_NAMES[name], "route": "cuda", "source": MLP_SOURCE,
            "replaces": MLP_REPLACES[name],
            "launches": mpar["launches"][f"dropout_{name}"],
            "max_abs_err": err, "max_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        kernels[-1].update(route_fields(t))
        kernels[-1]["note"] = (
            ("dX and dW run in one backward call: ms, plain_ms and bound_ms "
             "are that call's" if name != "fused_mlp_fwd" else "ms")
            + " (bf16, the wgmma route); the launches are phase 38's f32 "
              "calls (the generic route)")
    print(card, flush=True)     # again here: the top of the log may be cut
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
