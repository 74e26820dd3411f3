#!/usr/bin/env python3
"""Drive the PyTorch port's sampling and training paths once on one NVIDIA
GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (numbered by the slice that added them; main() runs each kernel's
check before the paths that use it, so phases 24-25 run after 19 and 21);
any failure exits non-zero and no phase's failure is caught:

1. device: a CUDA device must be present; prints torch, CUDA, the card and
   its power limit (nvidia-smi);
2. build: compiles qiddm_tpu_torch/csrc/*.cu (all twenty-one kernels:
   the fifteen chain kernels, #5's rows variant among them, and the six
   probes; one
   nvcc per source, started together, then one link) for sm_90a into
   build/qiddm_tpu_torch/ and loads the library;
3. gate-chain forward kernel against plain: kernel #1 against its plain
   PyTorch version on the card, at w in {1, 4, 6, 8, 10} x B in
   {1, 16, 80} (L*k = 28, k = 2), (w=6, B=16, L*k=42, k=3), the slice's
   shapes (w=10, B in {80, 16}, L*k=18: QIDDM-A's training and sampling
   batches; w=8, B=10, L*k=18, k=3: QIDDM_bias_false and QIDDM_L_B) and
   the edges
   of its launch plan (FWD_PLAN_EDGES at L*k = 28:
   gate_kernel.chain_fwd_plan's samples a CTA, up to the engine's largest
   batch 2^w - 1), max |diff| <= 1e-5, and a second call giving the same
   bits (each plan printed);
4. gate-chain backward kernel against plain: kernel #2 against its plain
   version at the same shapes and at the edges of its launch plan
   (BWD_PLAN_EDGES at L*k = 28: gate_kernel.chain_bwd_plan's samples a
   CTA, the largest batch one cluster sums in the launch and the first
   that takes a second launch, at every class of its layout) with N(0, 1)
   cotangents, dpr, dpi and dg each within 1e-5 * max(1, max|plain|), and
   a second call giving the same bits (each plan printed); at one shape
   also dg against torch autograd through the plain forward;
5. SEL-chain forward kernel against plain: kernel #5 at w in
   {1, 2, 4, 6, 8, 10} x B in {1, 10, 16, 80} x ring in {cz, cnot}, depth
   14, and (w=6, B=16, depth 60, cnot), at the trajectory route's
   widths, w in {11, 12} x B in {1, 10, 1000} x depth in {2, 14} x both
   rings, and at the edges of its and #6's launch plans (SEL_PLAN_EDGES,
   WIDE_SEL_PLAN_EDGES: sel_kernel.sel_fwd_plan / sel_bwd_plan at each
   class of the layout, 1 to 16 warps a sample, to 2^w - 1 samples), from
   random normalized start states, max |diff| <= 1e-5, and a second call
   giving the same bits (each shape's plans printed); then the rows
   kernel #5 (sel_chain_rows, the trajectory route's (N, d) complex64
   entry) at all those shapes against its plain version (max |diff| <=
   1e-5) and against the planes' kernel on the same states, which must
   give the same bits;
6. SEL-chain backward kernel against plain: kernel #6 at the same shapes
   with N(0, 1) cotangents, dsr, dsi and dg each within
   1e-5 * max(1, max|plain|), a second call giving the same bits, and one
   launch a call with a second for dg's batch sum only where the plan says
   the batch outgrows a cluster (sel_kernel.SEL_BWD_BATCH_SUMS); at one
   shape per ring also against torch autograd through the plain forward;
7. RY-chain forward kernel against plain: kernel #3 at w in {1, 3, 6} x
   B in {1, 5} x (L*k, k) in {(4, 2), (12, 3), (12, 2)}, QIDDM_PL_noise1's
   (w=8, L*k=12) at B=10 and 16, (w=10, B=80, L*k=28) and the JAX package's
   A/B shape (w=6, B=11, L*k=28), and at the plan's edges
   (FWD_PLAN_EDGES at L*k = 12), max |diff| <= 1e-5, and a second call
   giving the same bits;
8. RY-chain backward kernel against plain: kernel #4 at the same shapes
   and at the plan's edges (BWD_PLAN_EDGES at L*k = 12) with N(0, 1)
   cotangents, dcs and dg each within 1e-5 * max(1, max|plain|), and a
   second call giving the same bits; at (w=8, B=10, L*k=12) also against
   torch autograd through the plain forward;
9. sampling: QIDDM_LL_noise(784, 6, 14, 2), QNN_noise(784, 8, 14),
   QDenseUndirected_old_noise(60, 8) and QIDDM_PL_noise1(784, 8, 6, 2)
   with seeded random weights, each saved as a checkpoint and sampled
   through qiddm_tpu_torch.cli.sample (16 images x 15 iterations x 3
   batches on cuda): finite images, at least 90 gate-chain launches (QIDDM,
   two blocks), 45 SEL-chain launches (QNN, Qdense) or 90 RY-chain
   launches (QIDDM_PL_noise1, two blocks), and the last batch within 1e-4
   of the same weights and start images run on the CPU plain path. For
   QIDDM_PL_noise1, which refits a PCA on every batch, first the PCA
   projection of the first start batch, fitted on the card (cuSOLVER) and
   on the CPU, within 1e-4; then its sampling is held step by step: the
   last batch's 15 iterations rerun on the card give the CLI's batch, and
   at every iteration the CPU plain path maps the card's batch to the
   card's next within 1e-4. Its free-running drift is printed, not held:
   each PCA refit carries the last step's float32 rounding into the next
   fit, so two float32 implementations part after a few iterations
   (ROADMAP Queue 3);
10. training: a seeded mnist_28.npz (500 images, 50 per label) in a
   temporary data directory, then qiddm_tpu_torch.cli.mnist_exm with no
   --model, so both default models, QIDDM_LL_noise 784 6 14 2 and
   QNN_noise 784 8 14, train in turn, and again with --model
   QIDDM_PL_noise1 784 8 6 2, each run with --epochs 2 --checkpoint-every 1
   --device cuda and mnist_exm's defaults otherwise (batch 1, tau 10,
   label 4): finite epoch losses, at least 2 forward and 2 backward
   gate-chain launches per QIDDM step, 1 forward and 1 backward SEL-chain
   launch per QNN step and 2 forward and 2 backward RY-chain launches per
   QIDDM_PL_noise1 step, and every checkpoint served by the sampling CLI;
   then, for each of the three models, 3 training steps on the card from
   seeded weights, each step's loss and gradients (each block of qweights
   on its own) within 1e-4 of the CPU plain path at the same weights,
   batch and noise (gradients relative to their own max norm, or to the
   model's largest where a gradient is zero up to rounding, as QNN's
   linear_down);
11. profile: 10 steady QIDDM_LL_noise(784, 6, 14, 2), then
   QNN_noise(784, 8, 14), then QIDDM_PL_noise1 training steps (batch 1,
   tau 10) under torch.profiler: device events, busy time and idle share
   per step, the chain kernels' share, #1's, #5's or #3's and #2's, #6's or
   #4's device time a step, each on its own (2 forward and 2 backward
   launches a step, 1 and 1 for QNN_noise, none a second launch for dg's
   batch sum, by the counters and the profile); the steps, and for
   QIDDM_PL_noise1 the PCA fit and eigh alone, on the host clock; the
   training runs of phase 10 also counted no second launch;
12. density-matrix kernel against plain: kernel #8 against its plain
   PyTorch version at w in {1, 2, 4, 6, 7, 8} x B in {1, 10} x channel
   kinds {amplitude damping, depolarizing, phase damping} x encodes {RZ, RY}
   x strengths {0.05, 0.8}, (L, k) = (6, 2), at the two QIDDM shapes of
   the sweep, (w=6, B=10, L=14, RZ) and (w=8, B=10, L=6, RY), and at the
   kernel's widest, (w=9, B=2, L=2) and (w=10, B=1, L=1), both encodes, at
   strength 0.3: max |rho_kernel - rho_plain| <= 1e-5, rho Hermitian and
   of trace 1 within 1e-5; each shape's cluster plan printed
   (dm_kernel.cluster_plan: CTAs a sample, rows a CTA, shared memory a
   CTA, rho in shared or device memory, and the clusters the card holds
   at once);
13. the noisy sweep: a seeded fashion_28.npz (500 images, 50 per label) in
   the temporary data directory, then qiddm_tpu_torch.cli.fashion_noise
   --all-noise-types --device cuda with QIDDM_LL_noise 784 6 14 2,
   QIDDM_PL_noise1 784 8 6 2 and QNN_noise 784 8 6, --epochs 1 and a fresh
   save path: each model trains clean, then samples 10 start images x 20
   iterations under phase damping, amplitude damping and depolarizing at
   intensities 0.1, 0.2, 0.3, 0.5, 0.8 on the density-matrix backend, and
   each grid is scored (SSIM, PSNR, cosine, FID). Every score must be
   finite, and each QIDDM model must launch kernel #8 at least 600 times
   (2 blocks x 20 iterations x 15 settings), QNN_noise the SEL chain at
   least 600 times (both sides of rho x 20 x 15). Then, at intensity 0.3 of
   each channel, the first 3 iterations from the same trained weights and
   start images on the CPU plain path, within 1e-4 of the card's
   (QIDDM_PL_noise1 step by step, as in phase 9);
14. profile: 5 steady noisy QIDDM_PL_noise1 denoise iterations (10 images,
   amplitude damping at 0.3, seeded weights) under torch.profiler: device
   events, busy time and idle share per iteration, kernel #8's share of the
   busy time; the iteration on the host clock;
15. amplitude-damping kernel against plain: kernel #7 against its plain
   twin on the same uniforms at w in {1, 2, 4, 6, 8, 10, 12} x N in
   {1, 10, 1000} states x strengths {0.05, 0.3, 0.8}, each width's launch
   plan printed (amp_damp_kernel.amp_damp_plan): max |diff| <= 1e-5,
   the branch picks equal (the count of differing picks printed, 0
   required), with the picks forced the same states bit for bit, and the
   gradient of a weighted readout through the autograd
   Function (its backward replays the twin with the kernel's picks) with
   respect to the states and the strength within 1e-5 relative of autograd
   through the twin;
16. 12-wire trajectory sampling (path A, the JAX package's
   bench_traj_noisy_sampling, bench.py:599-632): QIDDM_LL_noise(784, 12,
   6, 2) with seeded weights under amplitude damping 0.05 on 100
   Monte-Carlo trajectories, 10 start images x 15 iterations through
   Diffusion.sample with a generator on the card whose draws are recorded:
   finite images, kernel #7 launched at least 12 times an iteration (2
   blocks x 6 spectrum layers) and the rows kernel #5 exactly 12 times an
   iteration with no launch of the planes' #5, the steady images/s (median
   of 3 runs after the recorded one), and the first iteration (the first
   three when the first takes the CPU under 20 s) rerun on the CPU plain
   path from the card's batch with the card's draws and branch picks,
   within 1e-4; then 5 steady iterations under torch.profiler: device
   events, busy time, idle share, and the shares of #7 and the rows #5
   (again exactly 12 rows launches an iteration, no planes' #5);
17. the noisy sweep on the trajectory backend (path B):
   qiddm_tpu_torch.cli.fashion_noise --all-noise-types --noise-backend traj
   --n-traj 100 --device cuda with QIDDM_PL_noise1 784 8 6 2 and QNN_noise
   784 8 6, --epochs 1: finite scores, the *_traj.pt caches, and kernel #7
   launched while sampling at least 1200 times by QIDDM_PL_noise1 (2 blocks
   x 6 x 20 iterations x 5 intensities) and 100 times by QNN_noise. Then, at
   intensity 0.3 of each channel, the first 3 iterations are rerun on the
   card with the driver's generator, recorded, and held against the cached
   grid, and on the CPU plain path with those draws and picks within 1e-4
   (QIDDM_PL_noise1 step by step, as in phase 13);
18. times: median of 20 runs of each kernel and of its plain version (of 3
   where a plain call takes 10 ms or more), better of two rounds (the
   gate-chain forward at w=6, B=16, L*k=28 and its backward at B=10 and
   B=16 and at QIDDM-A's w=10, B=80, L*k=28 (#1-#4 also behind a spin
   kernel, with their plans); the SEL chain forward and backward at w=8, depth 14, B=10 and 16,
   CZ, at w=6, depth 60, B=10, CNOT, and at path A's w=12, depth 2,
   B=1000, CZ and CNOT, there also the rows kernel on the same states;
   the RY chain forward and backward at w=8, B=10, L*k=12 and
   at w=6, B=11, L*k=28; the density-matrix block, depolarizing, at the
   sweep's two QIDDM shapes and at w=10, B=1, L=1, each with its cluster
   plan, and at the sweep's shapes (printed only) in turns with every
   other cluster whose rows fit in shared memory; the amplitude-damping
   pass at N=1000 and w=12 and 8, and its device time: the median of 20
   calls behind a spin kernel, without the host's enqueue), each beside
   its bound (the larger of
   its arithmetic over 67 TFLOP/s and its bytes, each input read once and
   each output written once, over 3.35 TB/s), the sampling images/s of
   each model, the training images/s of each trained model in its second
   epoch, and each sweep's noisy sampling images/s per model and its wall
   split into training, sampling and scoring;
19. wide kernels against plain: kernels #11 (the grouped sublayer) and #12
   (its adjoint backward) against their plain versions at (w, B, L*k) in
   WIDE_CASES, k = 2, up to w = 20, and at the main path's full-depth
   shapes (16, 16, 28), (16, 8, 28) and (20, 8, 28): forwards
   max |diff| <= 1e-5, backwards
   (dpr, dpi, each group's dG) within WIDE_BWD_TOL = 2e-5 of
   max(1, max|plain|); at (11, 10, 4) also against torch autograd through
   the plain forward;
20. 16-wire sampling: QIDDM_LL_noise(784, 16, 14, 2) through
   qiddm_tpu_torch.cli.sample as in phase 9: finite images, at least 168
   #11 launches an iteration (one per wire group (6, 5, 5) of 2 blocks x
   14 x 2 sublayers), and the first 3 iterations
   of the last batch, rerun on the card, held step by step against the CPU
   plain path within 1e-4 (a CPU iteration of 16 images at 16 wires is
   ~60 GFLOP, so not all 15);
21. 16-wire training: mnist_exm --model QIDDM_LL_noise 784 16 14 2 as in
   phase 10: at least 168 #11 and 168 #12 launches a step, every checkpoint
   served, and 3 steps' loss and gradients within 1e-4 of the CPU; then 10
   steady steps profiled: device busy time, idle share, #11's and #12's
   shares;
22. the JAX benchmark's bare block (bench.py's bench_wide_reupload) at
   w = 16 (50 steps) and w = 20 (5 steps) through engine.reupload_block,
   under both kernel variants in turn from the same seeded weights (the
   card's tools/bench_wide_kernel_ab.py): fwd+bwd+SGD steps/s, finite
   losses, with "scan" 84 #11 and 84 #12 launches a step (28 sublayers x 3
   wire groups at both widths) and no #9/#10, with "monolith" one #9 and
   one #10 a step and no group kernel, and the two variants' losses within
   1e-5 step for step;
23. times of #11 and #12, and of #9 and #10, at the model's (w=16, B=10,
   L*k=28) and at (w=20, B=8, L*k=4), beside the plain versions, the bound
   on their datapath (3xTF32 on the tensor cores) and the library
   yardstick (the group products as complex64 torch.matmul calls,
   cuBLAS), all in the same calls; printed only, the four at (w=11, B=1,
   L*k=28), one column tile a group pass, which shows a pass's fixed
   cost; the split of a #11 and a #12 chain call by launch kind at both
   shapes (phase 32); and ROADMAP item 5's crossover, printed only: the
   gate chain #1/#2 against the wide chain #11/#12 at w = 9 and 10,
   B = 80, L*k = 28, whose outputs must agree within 1e-5;
24. monolithic wide kernels against plain: kernels #9 (the whole chain in
   one cooperative launch) and #10 (its adjoint walk in one launch) at
   phase 19's shapes, forwards max |diff| <= 1e-5, backwards within
   WIDE_BWD_TOL of max(1, max|plain|), and bit for bit equal to #11/#12
   on the same inputs (they run the same units on the same tiles; the
   largest difference is printed); then each kernel's grid and
   co-resident blocks at (16, 10) and (20, 8), as its launch plans them;
25. the 16-wire model with config.set_wide_kernel_variant("monolith"):
   sampling as in phase 20 (the first 3 iterations of the last batch step
   by step against the CPU within 1e-4) and 3 training steps (batch 1, tau
   10) against the CPU within 1e-4 as in phase 10, each at exactly 2 #9
   launches an iteration or step, 2 #10 a training step and no
   group-kernel launch; then mnist_exm trains it for 2 epochs as in phase
   21, at exactly 2 #9 and 2 #10 launches a step (and 2 #9 for each of its
   15 closing sampling iterations) and no group-kernel launch, and its
   checkpoint is served; then the training step on the host clock under
   each variant in turns (scan, monolith, monolith, scan);
26. unitary-streaming kernels against plain: kernels #13 (the re-upload
   chain through dense layer unitaries, a layer one 3xTF32 tensor-core
   product over the batch, a thread-block cluster a tile of samples) and
   #14 (its adjoint walk on the same units, a layer one 3xTF32 product of
   U_l^H with the state and the cotangent side by side, then dU_l = C_l
   T_l^H as a fixed-order 3xTF32 product over the batch) at w in
   {1, 3, 6, 8} x B in {1, 16, 80} (L*k = 28, k = 2), (w=8, B=255,
   L*k=28), (w=6, B=16, L*k=42, k=3) and (w=3, B=4, L*k=4, k=1), each with
   both rings' unitaries, each shape's #13 and #14 plans printed
   (unitary_kernel.unitary_plan, unitary_bwd_plan: CTAs a cluster, samples
   a tile, tiles, shared memory, and the clusters the card holds at
   once): forwards max |diff| <= 1e-5, backwards (dpr, dpi, dur, dui)
   within 1e-5 of max(1, max|plain|), each call twice with the same bits;
   at (6, 16, 28) also #14 against torch autograd
   through the plain forward; where the worst errors land against the
   reference's on-chip bar (6.1e-6 relative);
27. the CNOT-ring route (the slice's main path): the library entry
   engine.reupload_block(..., imprimitive="cnot") at (w, L, k, B) =
   (8, 14, 2, 80) and (6, 14, 2, 16), rz (expvalz) and rz_halfpi (probs),
   forward and backward on the card with the counts set to 0 just before:
   exactly one #13 and one #14 launch a call and no other kernel; each
   call's values within 1e-5 and gradients within 1e-4 relative of the
   same inputs on the CPU. Then an RY-encoded CNOT block at (8, 80) on the
   per-layer route in complex matmuls (no launch), a damped CNOT block at
   w = 6 with and without autograd (the SEL chain #5, and #6 under
   autograd; no #8), and complex128 at (8, 80) with both rings (no
   launch), each against the CPU (1e-5, 1e-5, 1e-10);
28. times of #13 and #14 at (8, 80, 28) and (6, 16, 28) beside the plain
   versions, the bound (on their 3xTF32 datapath; #14's earlier float32
   bound printed beside it) and the library yardstick (the chain as one
   complex64 torch.matmul a layer with the phase multiplies, and
   autograd's backward of it), and their device times behind a spin;
   printed only: #13 and #14 at tiles of 8 and 16 samples, each with its
   plan, at (8, 80) and (8, 255), and a CZ chain at (8, 80, 28)
   on the gate chain #1/#2 against #13/#14, whose outputs must agree
   within 1e-5;
29. the ceiling probes' kernels against plain (qiddm_tpu_torch.tools.
   probe_kernels, csrc/probes.cu) at the tools' default shapes and at a
   small one: P1 gives exactly 2 x at 8 KB, 48 KB and the card's opt-in
   shared memory a block, alone (a plain launch) and in clusters of 2 and
   16, and is refused 512 bytes above the opt-in at each; P2 (128, 8192)
   and P3 (8192, 128), 50 steps, bit for bit (P2 also at its plan's
   edges: the tallest strip, 132 strips and more strips than SMs; P3 also
   at (1001, 13) x 7 and (5, 7) x 4, with a tail past the last float4;
   each plan printed); P5 (3xTF32 wgmma) (128, 128) @ (128, 8192), 50
   products, and at every card test's shape ((64, 1024) x 10, (16, 64) x
   3, (8, 64) x 2, (100, 128) x 5, (1, 64) x 2, (128, 128) x 0), each with
   its plan (columns a block, blocks, threads, shared memory) printed,
   within 5e-5 relative and the same bits on a second call; P4 (128, 128,
   64) and at every card test's shape (a in {1, 3, 128} x m in {8, 64,
   128} x w in {4, 64, 128}, m = w = 128 must be refused; and (4, 16, 8),
   (3, 24, 8), (2, 96, 32), (2, 200, 8): 2, 3, 3 and 25 chunks of k), each
   with its plan (blocks, threads, shared memory) printed, within 1e-5
   relative and equal bit for bit to probe_kernels.in_order_matmul; the
   FMA probe at
   (1024, B, 4096) for B in {80, 128} x chains in {1, 4, 8}, within 1e-5
   relative;
30. the probe tools (the slice's main path), with the counts set to 0 just
   before: python -m qiddm_tpu_torch.tools.vpu_ceiling at its defaults and
   at --iters 8192, and qiddm_tpu_torch.tools.wide_probe at its defaults,
   through their main(); the largest P1 scratch that runs equals the
   card's shared_memory_per_block_optin (every smaller size of the sweep
   runs, every larger one is refused); doubling iters takes 1.8-2.2x the
   time (the tool's device times) at chains 1, 4 and 8 for both batches;
   no GFLOP/s above 1.05 x the 67 TFLOP/s float32 peak (P5's three TF32
   products: none above 1.05 x the 495 TFLOP/s TF32 peak); P4 ok; every
   probe counter non-zero;
31. times of the six probe kernels at the tools' shapes beside their
   plain versions, the bound and, for P1-P5, the library yardstick (P1: torch.add(x, x); P2: a strided torch.mul into a
   transposed buffer and a copy back a step; P3: the step as torch.mul
   on the contiguous views, 100 calls; P4 and P5: torch.matmul, TF32
   off), and P2's device time behind a spin beside its shared-memory
   floor (2 x 50 transposes of 8 MB at 128 B a clock an SM, at the card's
   clocks.max.sm) and its DRAM bound; P3's bound counts each of its 100
   multiplies an element as one FMA lane-slot (two flops of the float32
   peak), printed with the same floor at clocks.max.sm; P5's bound is its
   three TF32 products at the TF32 peak, the float32 one printed beside
   it, with its plan; P4 (128, 128, 64) must
   equal probe_kernels.in_order_matmul bit for bit (the sum in order over
   k from zero, one FMA a term, as P4 always summed; P5 left that sum for
   the tensor cores, so it is held to its tolerance in phase 29 instead);
   then every kernel
   with a library time against its library call in turns, 20 pairs, each
   call behind a spin kernel that outlasts the host's enqueue of either
   call (its cycles printed): P1 at the opt-in and at 8 KB against
   torch.add(x, x), P2, P3, P4 and P5 at the tools' shapes, #9-#12 at
   (16, 10, 28) against _library_wide_fwd / _library_wide_bwd, #13/#14 at
   (8, 80, 28) against _library_unitary and autograd's backward of it,
   and (printed only) P1 at the opt-in in clusters of 2: each median and
   the median kernel / library ratio with its range, printed;
32. the split of #11 and #12 (printed only, run with phase 23): 3 chain
   calls of each at (16, 10, 28) and (20, 8, 4) under torch.profiler, the
   kernel time a call by wire group (#11) and by launch kind (#12: the
   two-right-hand-side rebuild and push by wire group, the dG product, its
   fixed-order sum, the un-encode);
33. #9-#14's registers and spills from ptxas's report, and the TF32
   tensor-core instructions in their SASS (cuobjdump -sass of the built
   library): every group and dG product kernel, both monolithic kernels,
   both #13 instances, both #14 walk instances and #14's dU product must
   hold some, and no #14 instance may spill (run after phase 24); #7's
   registers and spills at each width; P5's and P3's registers and spills,
   and the TF32 wgmma instructions (HGMMA ... TF32) in every P5 instance's
   SASS (fails on none);
34. #1-#6's registers and spills from ptxas's report at each of their
   1-10-wire instances, 1-12 for #5/#6 (fails unless all sixty-four are
   there, if #1 or #3 spills at 6, 8 or 10 wires, or if #5 or #6 spills
   at 6 or 8 wires);
35. QIDDM-A (run after phase 11): differN_noise 28 9 2, the JAX bench's
   reference model (qiddm_tpu's bench_qiddm_a: 10 wires, 2 blocks of
   L*k = 18), through qiddm_tpu_torch.cli.mnist_exm --device cuda at the
   bench's configuration (label 4, batch 8, tau 10, lr 0.0459, 30 epochs,
   here in 2 segments of 15 for a steady wall) on the seeded mnist_28.npz:
   30 finite epoch losses, exactly 2 #1 and 2 #2 launches a step and 2 #1
   an iteration of the driver's 15 sampling iterations, no other kernel;
   its checkpoint sampled through the sampling CLI as in phase 9 (16
   images x 15 iterations x 3 batches, each iteration of the last batch
   held against the CPU plain path within 1e-4); 3 training steps of 8
   images held against the CPU as in phase 10; 10 steady steps profiled
   as in phase 11 (#2's dg summed by a second launch: 80 rows outgrow a
   cluster); training and sampling images/s with the card's name and
   power limit;
36. the zoo (run after phase 35): the other 16 dense classes built on cuda
   at full width, the differN family, QIDDM_A_sameN and the two
   QIDDM_A_differN classes at (28, 9, 2) (10 wires) and the QIDDM-L, CL
   and PP families at (784, 8, 6, 2) (8 wires; k = 3 for QIDDM_bias_false
   and QIDDM_L_B): for each, 3 training steps of 8 images held against
   the CPU as in phase 10, BatchNorm running statistics included; then a
   batch of 16 sampled for 15 iterations from the trained weights, each
   iteration held against the CPU plain path from the card's batch within
   1e-4; exactly 2 #1 and 2 #2 launches a step, 2 #1 an iteration, no
   other kernel. The classes that refit a PCA on every batch are held at
   each iteration with the card's fit of the batch given to the CPU (the
   CPU's own fit printed beside); the gradients of the classes that
   post-process after each block, and the sampled iterations of the three
   that also refit a PCA, are printed beside their float32 floor, not
   held (phase_zoo says why);
37. the quantum U-Net (run after phase 36): UNetUndirected 3 8 3, the JAX
   bench's quantum-convolution U-Net (qiddm_tpu's bench_unet at qdepth 3:
   13 QConv2d sites of 3 to 9 wires, each composing its SEL unitary every
   forward), through qiddm_tpu_torch.cli.mnist_exm --device cuda at the
   bench's configuration (label 4, batch 8, tau 10, lr 0.01, 5 epochs, a
   checkpoint each epoch) on the seeded mnist_28.npz: 5 finite epoch
   losses; its checkpoint sampled through the sampling CLI as in phase 9
   (16 images x 15 iterations x 3 batches, each iteration of the last
   batch from the card's batch against the CPU plain path, printed, and
   held against its float64 step within the larger of 1e-4 and 8 times
   the iterations' float32 floor, the CPU's float32 step's distance from
   that float64 step, printed beside, the card's steps with TF32 on
   found outside that limit, and the card's float64 steps within 1e-10
   of the CPU's: phase_unet says why); 3 training steps
   of 8 images against the CPU as in phase 10
   (losses and BatchNorm statistics held; the card's float64 gradients
   held against the CPU's within 1e-8 relative; the float32 gradients
   printed beside their float32 floor, the CPU's float32 step's distance
   from its float64 step, which must exceed 1e-4: phase_unet says why);
   TF32 still off for
   cuBLAS and cuDNN; no kernel of the port launched in any of it (every counter
   of read_counts() 0: the U-Net runs plain torch ops); 10 steady steps
   profiled (device events, busy ms, idle share, the largest device ops
   by name, peak device memory); training and sampling images/s with the
   card's name and power limit;
38. the classical U-Net (run after phase 37): UNetUndirected 3 8 0, the
   reference's strongest classical baseline (bench_unet's default, cuDNN
   convolutions), as phase 37 at 10 epochs, but with the sampled
   iterations held against the CPU's float32 step within 1e-4;
39. the rebuttal drivers (run after phase 17): qiddm_tpu_torch.cli.fruit_360
   with its default models, QDenseUndirected_old_noise 60 64 (12 wires,
   depth 60, a CNOT ring: #5/#6) and QIDDM_LL_noise 4096 6 14 2 (#1/#2),
   its three labels on the 64x64 texture fallback (--ds-size 60, so every
   label has images, 1 epoch; each label's training split augmented to
   100 images), then qiddm_tpu_torch.cli.bloodmnist (Qdense at 10 wires)
   on one label at 28x28, both at batch 1, tau 10, --device cuda: finite
   SSIM scores (PSNR and cosine NaN: the rebuttal drivers score SSIM
   only), exactly one #5 and one #6 launch a Qdense step and one #5 an
   iteration of its 5 sampling iterations (two #1 and two #2 an LL step,
   two #1 an iteration), no other kernel; both Qdense widths' 3 training
   steps held against the CPU within 1e-4 and their sampling step by step
   (phase_train_parity, phase_sample); #6's shared memory at depth 60
   printed; the SSIM scores, training and sampling images/s and the
   phase's wall printed;
40. the FashionMNIST and EMNIST drivers at their defaults but 1 epoch:
   qiddm_tpu_torch.cli.fashion_exm on the seeded fashion_28.npz (tau_test
   20) and qiddm_tpu_torch.cli.emnist_exm on a seeded emnist_letters_28.npz
   (26 classes, tau_test 5), both default models (QIDDM_LL_noise 784 6 14
   2 and QNN_noise 784 8 14), the EMNIST run under --profile: finite
   scores, the launches of every step and iteration counted exactly, and
   the profile's Chrome trace naming #1 and #2;
41. the sweep: qiddm_tpu_torch.cli.mnist_ray at full width (hidden 6, N 2,
   batch 8, tau 10) on the seeded mnist_28.npz: --num-samples 4 --L-min 14
   --L-max 14 --epochs 2 (one group of 4 trials; the halving at epoch 1
   must stop 3 of them), then --L-min 16 --L-max 16 (L*k = 32, the
   sweep's deepest) at 1 epoch; the launches counted exactly: a training
   step's 80 rows are at least 2^6, so it composes each block's unitaries
   (plain torch matmuls, as the JAX package composes them in XLA) and
   launches no port kernel, and each scoring iteration (15 rows) 2 #1; the
   tune_results artifacts checked against their schema, and trial 0's
   first three steps (its seed and learning rate) held against the CPU
   within 1e-4;
42-46. the simulator past the kernels' widths, the routes no kernel takes,
   which the JAX package runs in XLA (engine.ROUTE_CALLS counts their
   calls: "wide" the grouped chain, "adjoint" the per-gate adjoint chain,
   "gates" sel_apply_gates, "amp_xla" the PyTorch amplitude-damping pass):
42. QNN_noise 784 16 14 through mnist_exm (batch 1, tau 10, one epoch) and
   sampled through the CLI: sel_chain_wide at 16 wires, one call a step and
   an iteration, no #5/#6 launch; 3 training steps and the sampled batch
   held against the CPU within 1e-4;
43. QIDDM_PL_noise1 784 12 6 2 through mnist_exm --batch_size 8 (80 rows,
   below 2^12) and sampled: the grouped chain's RY encode, 2 calls a step
   and an iteration, no #3/#4 launch; 3 steps of 8 images held against the
   CPU, and every sampled iteration step by step given the card's PCA fit
   of the batch (as phase 36 holds the refit classes);
44. bench_wide_reupload's block (RZ, CZ, L 14, k 2, batch 8, PauliZ, the
   MSE, SGD 0.01) at 22 wires, the first width past #11/#12, 5 steps on the
   grouped chain: steps/s, the peak device memory within 12 states (one is
   2^22 x 8 x 8 B), no kernel launch, TF32 off; the same block at L 1, k 1,
   batch 1 against the CPU's float64 (forward 1e-5, gradients 1e-4
   relative), with the CPU's float32 and the card's TF32 forward printed; a CNOT ring at 16 wires
   (L 2, k 2, batch 8) on the grouped chain and, under
   config.set_wide_mode("off"), on the per-gate adjoint chain, the two held
   within 1e-5 on the card (loss and gradients), steps/s for each;
45. path A at 14 wires (bench_traj_noisy_sampling(wires=14)):
   QIDDM_LL_noise 784 14 6 2, amplitude damping 0.05, 10 images x 100
   trajectories x 15 iterations through Diffusion.sample: sel_apply_gates
   and the PyTorch amplitude-damping pass 12 times an iteration each, no
   #5 or #7 launch; images/s; one iteration at 10 trajectories held
   against the CPU on the card's recorded draws and picks within 1e-4;
46. (a) the density-matrix backend at 12 wires: QIDDM_LL_noise 784 12 6 2
   with amplitude damping 0.3, 2 images x 3 iterations: #5 on both sides
   of rho, 24 launches an iteration, no #8; one image's iteration held
   within 1e-4 against the same model in complex128 on the card (the dm
   route's sel_apply_gates; the CPU would take ~3 min), and one spectrum
   layer (L 1, k 2, one image) against the CPU within 1e-5; (b) QIDDM-A (differN_noise 28 9 2) under
   config.enable_x64(True): the complex128 grouped chain at 10 wires, a
   forward and a training step's loss and gradients against the CPU's
   float64 within 1e-10 and 1e-8 relative; the five phases' walls;
47. AOT serving artifacts (qiddm_tpu_torch/export.py; the forward kernels
   are torch.library operators, qiddm::*, sim/ops.py): (1) phase 10's
   QIDDM_LL_noise 784 6 14 2 checkpoint exported through the sampling CLI
   (--export, 16 x 15) and served with --from-export, 3 batches, against
   the live CLI within 1e-6, #1 launched 2 an iteration by both; the
   artifact's and the live sampler's images/s at batch 16, in turns; the
   trained sampler at batch 16 and 1024 under config.enable_x64(True) (the
   complex128 routes, as phase 46b) on the card against the CPU: each
   iteration from the card's batch held within 1e-10; the free-running
   runs over 15 iterations printed by iteration beside the CPU's own
   float64 run from the batch moved by one ulp (the trained map amplifies
   a difference ~30-100x an iteration: not held); in float32 each of the
   card's iterations from the CPU's float64 batch held against the CPU's
   float64 step within max(1e-4, 8 x the CPU's float32 floor, its float32
   step against its float64 step), with TF32 on as the control that must
   fail, and the free-running float32 figures printed beside the CPU's
   own; (2) the JAX bench's AOT row
   (bench.py:322-345, fresh seeded weights): batch 1024, 15 iterations,
   the composed route (no port kernel), against the live sampler within
   1e-6, against the CPU free-running within 1e-4 and an iteration at a
   time within 1e-5, images/s of both in turns; (3) a bundle of buckets
   1, 8 and 64 serving n = 5, 16 and 100, each against the live sampler
   within 1e-4 (printed against 1e-5), n = 100 (the 64-bucket, composed)
   also against the CPU; (4) an artifact for each other operator, seeded
   weights, against the live sampler within 1e-5 with the same launches:
   QIDDM-A (#1 at 10 wires, the PCA refit inside the program), QNN_noise
   784 8 14 (#5), QIDDM_PL_noise1 784 8 6 2 (#3), the dm-noise
   QIDDM_LL_noise 784 6 14 2 at amplitude damping 0.3, 2 images x 3
   iterations (#8), QIDDM_LL_noise 784 16 14 2 under both wide variants,
   2 iterations (#11, #9), and phase 27's CNOT block at the block level
   (#13); (5) the model built and exported on the CPU with
   platforms=("cuda",), run on the card against its live sampler within
   1e-5; (6) a trajectory model refused; then the host us a call of #1
   through its launch function, its torch.library operator and a
   torch.library.custom_op registration of the same function, in turns;
48. the application layer at QIDDM_LL_noise 784 6 14 2 (after phase 47):
   (a) the torch-style training call, Diffusion.attach_optimizer(Adam at
   the driver's rate) and the reference's loop opt.zero_grad(); diff(x=...,
   T=10); opt.step() for 3 calls at batch 1 on the seeded mnist_28.npz:
   losses and parameters bit-equal to make_train_step's on the same draws
   (the outer step moves nothing), each call's loss and make_train_step's
   gradients within 1e-4 of the CPU's at the card's weights, exactly 2 #1
   and 2 #2 launches a call, loss_only moving nothing; (b) the net saved
   as the reference's .pt (save_reference_checkpoint, its keys printed),
   loaded into a fresh model on the card, 16 images x 15 iterations on #1
   bit-equal to the trained net's; (c) mnist_exm --model QIDDM_LL_noise
   784 6 14 2 --ckpt-backend orbax (a torch.distributed.checkpoint
   directory, .dcp) and the same under pt, 2 epochs, --checkpoint-every 1:
   restored variables and losses bit-equal (else the first differing
   tensor named); a run cut at epoch 1 and resumed to 2, its first loss
   the same; cli.sample --ckpt <.dcp> bit-equal to the .pt's; (d)
   parameter_shift_grad of sum(reupload_block(x, w, rz, cz, expvalz) @
   coeff) at 6 wires, L 14, k 2, 16 inputs: exactly 1,008 #1 launches (2P),
   within 2e-4 of torch.autograd through #1/#2, chunks of 64 within 1e-6
   of unchunked; (e) circuit_to_qasm -> repeat_qasm (ancilla reset, 3
   reps) at 10 wires, depth 4: run_qasm on the card in complex128 within
   1e-12 of the native engine on the host (run_qasm_native), and
   sample_from_qasm's 10,000 shots (seed 0) equal to the native draw of
   the host's probabilities;
49. the mesh (qiddm_tpu_torch/parallel, sim/sharded.py) on one card, after
   phase 48, no process group before it and none after it: (b) first
   cli.sample --mesh-devices 1 on phase 10's QIDDM_LL_noise 784 6 14 2
   checkpoint, 16 x 15 (the CLI forms a one-rank NCCL group and destroys
   it), the same bits and #1 launches as the command without the flag,
   and --mesh-devices 2 refused with the device-count ValueError before
   any group is formed; then on one one-rank NCCL group, through
   qiddm_tpu_torch/tools/mesh_check.py's checks (which torchrun runs on N
   cards), after one all-reduce that sets the communicator up, timed: (a)
   train_diffusion_scan(mesh=make_mesh(1)) of QIDDM_LL_noise 784 6 14 2 at
   batch 1, tau 10, 2 epochs over the seeded 40 images of the label,
   losses and weights the same bits as without the mesh (the runs in
   turns: none, mesh, mesh, none), the same #1/#2 launches, one all-reduce
   a step, every step's loss from the same weights the same bits, the
   step times, and a witness without a mesh (each step's rows summed as 4
   ranks would take them) printed; Diffusion.sample(mesh=...) 16 x 15 the
   same bits and #1 launches as without it; (c)
   engine.reupload_block(mesh=...) at QIDDM_LL_noise(784, 16, 14, 2)'s
   block (16 wires, L 14, k 2, 10 rows), expvalz and probs, within 1e-4 of
   #11/#12 and the adjoint gradients within 2e-3 relative, launching no
   kernel, and its steps/s; at 12 wires (L 6, k 2) an RY/CNOT
   block against the grouped chain, and amplitude damping on 8
   trajectories against the dense trajectory backend (#7) on one
   generator seed's draws, within 1e-4; (d) sweep_lr over a one-rank
   "trial" mesh, 2 trials for 1 epoch, losses, SSIMs and each trial's DCP
   checkpoint the same bits as the sweep without a mesh, and the trials'
   stacked weights restored from DCP onto the "trial" placement, the same
   bits.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. In the record, a wide row's
``launches`` counts the runs at its width (the 16-wire model and bench
block, or the 20-wire bench block): for #11/#12 launches of the group
kernel, once per wire group of each sublayer (the backward's dG sums and
un-encodes are helpers and not counted, as #2's dg sum is not); for #9/#10
one a chain call. Its ``max_abs_err`` is the largest error checked at its
width in phase 19 (#11/#12) or 24 (#9/#10): max |diff| forward,
max |diff| / max(1, max|plain|) backward. The rows kernel's row
(``sel_rows_fwd_w12``) counts its launches in every run (path A's, 12 an
iteration), its error is phase 5's worst against plain, its times phase
18's at (12, 1000, 2, CZ). The unitary rows' launches are
phase 27's (one a chain call; #14's dU product is a helper and not
counted), their errors phase 26's worst, their times phase 28's at
(8, 80, 28). The probe rows' launches are phase 30's (one a wrapper
call), their errors phase 29's largest max |diff|, their times phase 31's. Every row names its ``datapath``: ``3xtf32``
for #9-#12 and #13, ``simt`` (float32 on the CUDA cores) for the others;
its ``bound_ms`` is taken at that datapath's peak.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import functools
import io
import json
import math
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from qiddm_tpu_torch import config
from qiddm_tpu_torch import export as export_mod
from qiddm_tpu_torch import native
from qiddm_tpu_torch.ckpt import (export_jax_variables, load_checkpoint,
                                  load_dcp, load_diffusion,
                                  load_jax_variables,
                                  load_reference_checkpoint, save_checkpoint,
                                  save_dcp, save_reference_checkpoint)
from qiddm_tpu_torch import data as data_mod
from qiddm_tpu_torch.cli import common
from qiddm_tpu_torch.cli import (bloodmnist, emnist_exm, fashion_exm,
                                 fashion_noise, fruit_360, mnist_exm,
                                 mnist_ray, noise_common)
from qiddm_tpu_torch.cli import sample as sample_cli
from qiddm_tpu_torch.diffusion import Diffusion
from qiddm_tpu_torch.noise import add_normal_noise_multiple
from qiddm_tpu_torch.nn import core as nn_core
from qiddm_tpu_torch.parallel import NamedSharding, distributed, make_mesh
from qiddm_tpu_torch.pca import (PCAState, pca_fit, pca_fit_transform,
                                 pca_transform)
from qiddm_tpu_torch.sim import (amp_damp_kernel, dm_kernel, engine,
                                 gate_kernel, ops, ry_kernel, sel_kernel,
                                 unitary_kernel, wide, wide_kernel)
from qiddm_tpu_torch.sim import qasm
from qiddm_tpu_torch.sim.gates import rot_matrix
from qiddm_tpu_torch.sim.gradients import parameter_shift_grad
from qiddm_tpu_torch.sim.sel import sel_layer_unitaries
from qiddm_tpu_torch.sim.statevector import rz_phase_planes, rz_phases
from qiddm_tpu_torch.sim.trajectories import RecordedDraws, ReplayDraws
from qiddm_tpu_torch.tools import mesh_check, probe_kernels, vpu_ceiling
from qiddm_tpu_torch.tools import wide_probe
from qiddm_tpu_torch.tools import common as tools_common
from qiddm_tpu_torch.sweep import sweep_lr

SEED = 0
KERNEL_TOL = 1e-5   # unit-norm f32 states over up to 60 layers
BWD_TOL = 1e-5      # relative to max(1, max|plain|): dg sums over rows and B
SAMPLE_TOL = 1e-4   # 15 iterations of a linear or pixel scaling over a chain
# the quantum U-Net's sampled iterations against the CPU's float64 step: at
# most this many times the CPU's own float32 distance from it (phase_sample's
# floor64). Over 24 checkpoints trained on the card its float32 steps lay
# 0.680-2.298 times as far from it as the CPU's (median 1.502), and its TF32
# steps at least 562.9 times (qiddm_tpu_torch/tools/unet_precision.py on an
# H100); one run of this script read 3.56
FLOOR_FACTOR = 8
TRAIN_TOL = 1e-4    # relative; one float32 step's loss and gradients
# relative; the quantum U-Net's float64 gradients, the card against the CPU:
# its float32 floor (~3e-2) is ~5e5 float32 unit roundoffs, which in float64
# come to ~6e-11
GRAD64_TOL = 1e-8
GRAD_FLOOR = 1e-6   # below this share of the largest, a gradient is ~zero
MODEL = ["QIDDM_LL_noise", "784", "6", "14", "2"]
QNN_MODEL = ["QNN_noise", "784", "8", "14"]
QDENSE_MODEL = ["QDenseUndirected_old_noise", "60", "8"]
PL_MODEL = ["QIDDM_PL_noise1", "784", "8", "6", "2"]
# the wide chain (kernels #11/#12): mnist_exm's first model at 16 wires
WIDE_MODEL = ["QIDDM_LL_noise", "784", "16", "14", "2"]
# #11 (and, training, #12) launches an iteration or step: one per wire
# group (6, 5, 5) of each of the 2 blocks x 14 x 2 sublayers
WIDE_PER_ITER = 2 * 14 * 2 * len(wide.group_sizes(16))
N, ITERS, BATCHES = 16, 15, 3
# (model, image side, launch counter, launches per denoise iteration,
# iterations held step by step: 0 holds the free-running last batch)
SAMPLED = [(MODEL, 28, "gate", 2, 0), (QNN_MODEL, 28, "sel", 1, 0),
           (QDENSE_MODEL, 8, "sel", 1, 0), (PL_MODEL, 28, "ry", 2, ITERS),
           (WIDE_MODEL, 28, "wide", WIDE_PER_ITER, 3)]
EPOCHS, TAU, LABEL = 2, 10, 4  # mnist_exm's defaults but epochs
CASES = ([(w, b, 28, 2) for w in (1, 4, 6, 8, 10) for b in (1, 16, 80)]
         + [(6, 16, 42, 3)]
         # QIDDM-A's (10 wires, L*k = 9 x 2) at its training batch (8
         # images x tau 10) and sampling batch, and the k = 3 classes'
         # (QIDDM_bias_false, QIDDM_L_B at 784 8 6 2) at batch 1 x tau 10
         + [(10, 80, 18, 2), (10, 16, 18, 2), (8, 10, 18, 3)]
         # the sweep's (mnist_ray: 6 wires, batch 8 x tau 10 = 80 rows,
         # L*k = 2L for L 6-16; 15 start images to score): its shallowest
         # and deepest, and the deepest at the scoring batch
         + [(6, 80, 12, 2), (6, 80, 32, 2), (6, 15, 32, 2)])
# the backward walk's launch plan at its edges (gate_kernel.chain_bwd_plan;
# #2 at L*k = 28, #4 at 12): the last batch of one sample a CTA and the
# first of two, the largest batch one cluster holds (32 samples up to 7
# wires, 16 from 8) and the first that takes a second launch, at each class
# of the layout (lanes only, register bits, two warps, four warps)
BWD_PLAN_EDGES = [(1, 8), (1, 9), (5, 32), (5, 33), (7, 31), (7, 32),
                  (7, 33), (8, 8), (8, 9), (8, 16), (8, 17), (9, 16),
                  (9, 17), (10, 9), (10, 16), (10, 17)]
# the forwards' launch plan at its edges (gate_kernel.chain_fwd_plan; #1 at
# L*k = 28, #3 at 12): fewer samples than a CTA's slots, a last CTA with
# one live sample, and the engine's largest batch 2^w - 1 at each class of
# the layout (lanes only, register bits, the widest warp, two warps, four)
FWD_PLAN_EDGES = [(1, 1), (2, 3), (3, 5), (5, 31), (6, 133), (7, 127),
                  (8, 1), (8, 9), (8, 255), (9, 511), (10, 1023)]
SEL_CASES = ([(w, b, 14, ring) for w in (1, 2, 4, 6, 8, 10)
              for b in (1, 10, 16, 80) for ring in ("cz", "cnot")]
             + [(6, 16, 60, "cnot")]
             # the rebuttal drivers' Qdense (QDenseUndirected_old_noise 60
             # side) at 28x28 and 64x64: batch 1 x tau 10 and 10 samples
             + [(10, 10, 60, "cnot"), (12, 10, 60, "cnot")])
# the trajectory route's widths, at path A's batch (100 trajectories x 10
# images) and depth (k = 2 a spectrum layer), and at QNN's depth
WIDE_SEL_CASES = [(w, b, depth, ring) for w in (11, 12) for b in (1, 10, 1000)
                  for depth in (2, 14) for ring in ("cz", "cnot")]
# #5's and #6's launch plans at their edges (sel_kernel.sel_fwd_plan,
# sel_bwd_plan; depth 14), at each class of the layout (lanes only, a warp,
# 2, 4, 8 and 16 warps a sample): fewer samples than a CTA's slots, a last
# CTA with one live sample, the largest batch one cluster sums in the
# launch and the first that takes a second launch, and the engine's
# largest batch 2^w - 1; up to 10 wires, and at 11-12
SEL_PLAN_EDGES = [(w, b, 14, ring) for w, b in (
    (1, 1), (3, 5), (5, 32), (5, 33), (7, 127), (8, 9), (8, 16), (8, 17),
    (9, 511), (10, 17), (10, 1023)) for ring in ("cz", "cnot")]
WIDE_SEL_PLAN_EDGES = [(w, b, 14, ring) for w, b in (
    (11, 8), (11, 9), (12, 8), (12, 9)) for ring in ("cz", "cnot")]
RY_CASES = ([(w, b, n, k) for w in (1, 3, 6) for b in (1, 5)
             for n, k in ((4, 2), (12, 3), (12, 2))]
            + [(8, 10, 12, 2), (8, 16, 12, 2), (10, 80, 28, 2),
               (6, 11, 28, 2)])
DM_KINDS = ("amplitude_damping", "depolarizing", "phase_damping")
# (w, B, L, k, RY encode, strengths)
DM_CASES = ([(w, b, 6, 2, ry, (0.05, 0.8)) for w in (1, 2, 4, 6, 7, 8)
             for b in (1, 10) for ry in (False, True)]
            + [(6, 10, 14, 2, False, (0.3,)), (8, 10, 6, 2, True, (0.3,))]
            + [(w, b, n, 2, ry, (0.3,)) for w, b, n in ((9, 2, 2), (10, 1, 1))
               for ry in (False, True)])
DM_TOL = 1e-5       # rho of trace 1 through up to 14 spectrum layers
SWEEP_MODELS = [MODEL, PL_MODEL, ["QNN_noise", "784", "8", "6"]]
SWEEP_TYPES = (1, 2, 3)
SWEEP_ITERS = 20    # tau_test = 2 tau
SWEEP_CHECK = 0.3   # the intensity held against the CPU
AMP_CASES = [(w, n) for w in (1, 2, 4, 6, 8, 10, 12) for n in (1, 10, 1000)]
AMP_STRENGTHS = (0.05, 0.3, 0.8)
# path A: qiddm_tpu's bench_traj_noisy_sampling (bench.py:599-632)
TRAJ_MODEL = ["QIDDM_LL_noise", "784", "12", "6", "2"]
TRAJ_CODE, TRAJ_STRENGTH = 2, 0.05  # amplitude damping
N_TRAJ, TRAJ_IMAGES, TRAJ_ITERS = 100, 10, 15
TRAJ_PER_ITER = 12  # #7 and #5 calls an iteration: 2 blocks x 6 layers
CPU_REPLAY_S = 20   # replay 3 iterations when the first takes under this
# path B: fashion_noise on the trajectory backend
TRAJ_SWEEP_MODELS = [PL_MODEL, ["QNN_noise", "784", "8", "6"]]
# #11/#12 against plain, (w, B, L*k) at k = 2: a one-group width, the
# crossover widths at the bench batch, 11-13 wires, the model's shape and
# the widest
WIDE_CASES = [(4, 16, 4), (9, 80, 28), (10, 80, 28), (11, 10, 4),
              (13, 10, 4), (16, 10, 28), (20, 8, 4)]
# relative to max(1, max|plain|): dG sums 2^w B / 2^s products a sublayer
# (164k at w=20, B=8, s=6) in column tiles and splits on the card, in
# cuBLAS's order in the plain version; ~1e-6 relative apart at that length
WIDE_BWD_TOL = 2e-5
# bench.py's bench_wide_reupload: (wires, steps) at L=14, k=2, batch 8
WIDE_BENCH = ((16, 50), (20, 5))
# the wide kernels against plain also at the main path's full-depth shapes:
# the 16-wire model's sampling batch and the bench blocks, where the
# backward rebuilds the state through 28 sublayers
WIDE_PATH_CASES = [(16, 16, 28), *((w, 8, 28) for w, _ in WIDE_BENCH)]
# the wide chain's kernel variants (config.set_wide_kernel_variant):
# #11/#12 a wire group a launch, #9/#10 a whole chain a launch
VARIANTS = ("scan", "monolith")
# #9 and #10 launches an iteration or step of the 16-wire model: one
# chain call of each of its 2 blocks
MONO_PER_ITER = 2
# the sampling iterations mnist_exm runs after training (run_labels'
# tau_test), one forward each
TAU_TEST = 15
# QIDDM-A, qiddm_tpu's bench_qiddm_a (bench.py:118-149): differN_noise
# 28 9 2 (10 wires, 2 blocks of L*k = 18) at its batch, tau, rate and
# epochs; 15 epochs a segment, so the second segment's wall is steady
QIDDM_A = ["differN_noise", "28", "9", "2"]
QIDDM_A_BATCH, QIDDM_A_LR, QIDDM_A_EPOCHS, QIDDM_A_SEGMENT = 8, 0.0459, 30, 15
QIDDM_A_FLAGS = ["--label", str(LABEL), "--batch_size", str(QIDDM_A_BATCH),
                 "--tau", str(TAU), "--lr", str(QIDDM_A_LR), "--epochs",
                 str(QIDDM_A_EPOCHS)]
# the rest of the dense zoo at full width: the differN family at QIDDM-A's
# (28, 9, 2), 10 wires; the QIDDM-L, CL and PP families at
# QIDDM_PL_noise1's (784, 8, 6, 2), 8 wires. Each trains 3 steps of
# ZOO_IMAGES images (x tau 10 rows) and samples a batch of N.
ZOO = ([[name, "28", "9", "2"] for name in (
    "differN_old_pca", "differN_new_pca", "differN_new_conv",
    "differN_old_conv", "QIDDM_A_sameN", "QIDDM_A_differN_basePL",
    "QIDDM_A_differN_NEW")]
       + [[name, "784", "8", "6", "2"] for name in (
           "QIDDM_LL_relu_noise", "QIDDM_LL_old", "QIDDM_L",
           "QIDDM_bias_false", "QIDDM_L_B", "QIDDM_CL_new", "QIDDM_CL_old",
           "QIDDM_PP_noise", "QIDDM_PP_old")])
ZOO_IMAGES = 8
# the U-Nets, qiddm_tpu's bench_unet (bench.py:558-596, :752-755): the
# quantum-convolution U-Net at 5 epochs and the classical one at 10, both
# at batch 8, tau 10, lr 0.01 (the drivers' UNetUndirected rate)
UNETS = [(["UNetUndirected", "3", "8", "3"], 5),
         (["UNetUndirected", "3", "8", "0"], 10)]
UNET_BATCH, UNET_LR = 8, 0.01
# kernels #13/#14 against plain, (w, B, L, k): L*k = 28 at k = 2 over the
# widths to the kernels' 8, the route's largest batch at 8 wires (255 <
# 2^8), and k = 3 and k = 1; each with both rings
UNITARY_CASES = ([(w, b, 14, 2) for w in (1, 3, 6, 8) for b in (1, 16, 80)]
                 + [(8, 255, 14, 2), (6, 16, 14, 3), (3, 4, 4, 1)])
RINGS = ("cz", "cnot")
# the per-layer-unitary route's main path: reupload_block(...,
# imprimitive="cnot") at (w, L, k, B): its widest block on #13/#14 at the
# mnist driver's depth and the JAX bench's batch (8 images x tau 10), and
# QIDDM_LL_noise 784 6 14 2's width at the sampling batch
UNITARY_PATH = [(8, 14, 2, 80), (6, 14, 2, 16)]
# the reference's on-chip bar for its Mosaic kernels against their plain
# versions, relative (results/onchip_parity.json)
ONCHIP_BAR = 6.1e-6
X64_TOL = 1e-10     # complex128 on the card against the CPU
# the card's published peaks (H100 SXM, 700 W): float32 outside the tensor
# cores, TF32 on the tensor cores (dense), and device memory
PEAK_FLOPS = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# the ceiling probes (rows 15a-15e, 16) at the tools' default shapes
PROBE_ITERS = 50
PROBE_SHAPE = (128, 8192)
DOT3D_SHAPE = (128, 128, 64)
# P4 also at every card test's shape (tests/test_torch_probe_kernels.py);
# m = w = 128 is refused (512 threads of 8 x 4); the last four stage k in
# 2, 3, 3 and 25 chunks
DOT3D_CARD_SHAPES = [(a, m, w) for a in (1, 3, 128) for m in (8, 64, 128)
                     for w in (4, 64, 128)] + [
                         (4, 16, 8), (3, 24, 8), (2, 96, 32), (2, 200, 8)]
SMEM_CLUSTERS = (1, 2, 16)  # P1's sizes held at each, and its boundary
FMA_SHAPES = [(1024, b, 4096, c) for b in (80, 128) for c in (1, 4, 8)]
FMA_TIMED = (1024, 80, 4096, 8)
# P3's shapes held bit for bit besides the tools': a tail of 1 and of 3
# elements past the last float4
P3_SHAPES = [((1001, 13), 7), ((5, 7), 4)]
# P2's plan edges (shape, iterations): the tallest strip that fits, exactly
# 132 strips, more strips than SMs; held bit for bit
P2_EDGES = [((864, 64), 2), ((32, 32 * 264), 3), ((256, 64 * 396), 2)]
SLAB_TOL = 1e-5     # P4, relative: 128-term float32 sums in two orders
# P5, relative: 3xTF32 products whose large terms the tensor cores sum
# toward zero (its CPU emulation, tests/test_torch_probe_tf32.py, lies
# 9.7e-6 from plain at the tools' shape cut to 512 columns)
TF32_TOL = 5e-5
# P5 at every card test's (m, n, n_iters) besides the tools'
# (tests/test_torch_probe_kernels.py)
P5_CARD_SHAPES = [(64, 1024, 10), (16, 64, 3), (8, 64, 2), (100, 128, 5),
                  (1, 64, 2), (128, 128, 0)]
FMA_TOL = 1e-5      # relative: fmaf against a float64 product and sum, rounded
PEAK_CAP = 1.05     # no measured rate above 1.05 x PEAK_FLOPS
FMA_RATIO = (1.8, 2.2)  # time at 2 x iters over time at iters
# the rebuttal drivers (phase 39): --ds-size so that every label of the
# textures has images (at the default 5 a label may have none, and the run
# raises, as the JAX package's does), 1 epoch; the training split of each
# label augmented to this many images; 5 sampling iterations
REBUTTAL_DS, REBUTTAL_AUGMENTED, REBUTTAL_ITERS = 60, 100, 5
# the driver's sampling batch, the rows of every forward while sampling
DRIVER_IMAGES = 10
# the sweep (phase 41): mnist_ray's batch 8 x tau 10, its 15 start images
# scored for 5 iterations; 40 training images of LABEL (80% of 50)
SWEEP_BATCH, SWEEP_SCORE_ITERS = 8, 5
SWEEP_RESULT_KEYS = {"loss", "ssim", "training_iteration", "time_total_s",
                     "node_ip", "trial_id", "early_stopped"}
# phases 42-46: the routes no kernel takes
QNN16 = ["QNN_noise", "784", "16", "14"]          # sel_chain_wide
PL12 = ["QIDDM_PL_noise1", "784", "12", "6", "2"]  # the RY grouped chain
PL12_BATCH = 8
# bench_wide_reupload's block past #11/#12: (wires, L, k, batch), 5 steps
WIDE22, WIDE22_STEPS = (22, 14, 2, 8), 5
WIDE22_STATES = 12  # the step's peak device memory, in states
CNOT16, CNOT16_STEPS = (16, 2, 2, 8), 5
TRAJ14_MODEL = ["QIDDM_LL_noise", "784", "14", "6", "2"]
TRAJ14_HELD = 10    # trajectories in the CPU hold of one iteration
DM12_MODEL = ["QIDDM_LL_noise", "784", "12", "6", "2"]
DM12_STRENGTH, DM12_IMAGES, DM12_ITERS = 0.3, 2, 3
PAIRS = 20          # each kernel against its library call, in turns
WIDE_PAIRED = (16, 10, 28)  # #9-#12's (w, B, L*k) in the pairs
# phase 47: AOT serving artifacts (qiddm_tpu_torch/export.py). An artifact
# calls the live sampler's operators in the same order: held to 1e-6 where
# both run one batch on one device; 1e-5 for one iteration against the CPU
# and for the other operators' artifacts; a free-running batch on another
# route (a padded bucket, the CPU) to SAMPLE_TOL, as every sampled batch
# here, its figure printed against 1e-5
EXPORT_TOL, STEP_TOL = 1e-6, 1e-5
EXPORT_REPS = 5     # rounds of 4 timed batches, in turns
AOT_BATCH, AOT_REPS = 1024, 3  # bench.py:322-345's AOT serving row
BUNDLE_BUCKETS, BUNDLE_NS = (1, 8, 64), (5, 16, 100)
CROSS_ITERS = 5     # the CPU-emitted CUDA artifact's iterations
# (label, model, image side, with_noise args, wide variant, batch,
# iterations, operator, its counter): one artifact for each other forward
# operator, seeded weights
EXPORT_MODELS = [
    ("QIDDM-A " + " ".join(QIDDM_A), QIDDM_A, 28, None, "scan", N, 3,
     "gate_chain", "gate"),
    (" ".join(QNN_MODEL), QNN_MODEL, 28, None, "scan", N, 3, "sel_chain",
     "sel"),
    (" ".join(PL_MODEL), PL_MODEL, 28, None, "scan", N, 3, "ry_chain", "ry"),
    ("dm " + " ".join(MODEL) + f" amplitude damping {SWEEP_CHECK}", MODEL,
     28, (2, SWEEP_CHECK), "scan", 2, 3, "dm_chain", "dm"),
    (" ".join(WIDE_MODEL) + " (scan)", WIDE_MODEL, 28, None, "scan", N, 2,
     "wide_chain", "wide"),
    (" ".join(WIDE_MODEL) + " (monolith)", WIDE_MODEL, 28, None, "monolith",
     N, 2, "wide_mono", "wide_mono"),
]
# phase 48: the application layer at MODEL's width. The training call runs
# APP_CALLS calls at batch 1; the parameter shift differentiates
# reupload_block at (wires, L, k, inputs), 16 inputs below 2^6 rows so #1,
# within tests/test_gradients.py's bound, chunked in PSHIFT_CHUNK; the QASM
# circuit is (wires, depth, reps) with the ancilla reset
APP_CALLS = 3
PSHIFT, PSHIFT_CHUNK = (6, 14, 2, 16), 64
PSHIFT_TOL, CHUNK_TOL = 2e-4, 1e-6
QASM, QASM_SHOTS, QASM_TOL = (10, 4, 3), 10_000, 1e-12
# phase 49: the mesh on a one-rank NCCL group. Training and the sweep take
# the seeded mnist_28.npz's first MESH_IMAGES images of LABEL (the sweep's
# 80%); the witness without a mesh splits each step's rows as
# MESH_WITNESS_SPLIT ranks would; the route's blocks are (wires, L):
# QIDDM_LL_noise(784, 16, 14, 2)'s and QIDDM_LL_noise(784, 12, 6, 2)'s at
# mesh_check's k 2 and 10 rows, held against the routes without a mesh
# within MESH_TOL and, gradients, within MESH_GRAD_TOL relative
# (results/onchip_parity.json's bar)
MESH_IMAGES, MESH_TRAJ, MESH_WITNESS_SPLIT = 40, 8, 4
MESH16, MESH12 = (16, 14), (12, 6)
MESH_TOL, MESH_GRAD_TOL = mesh_check.ROUTE_TOL, mesh_check.GRAD_TOL
MESH_SWEEP_LRS = [0.0255, 0.05]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def reset_counts() -> None:
    gate_kernel.LAUNCHES = gate_kernel.BWD_LAUNCHES = 0
    gate_kernel.BWD_BATCH_SUMS = ry_kernel.RY_BWD_BATCH_SUMS = 0
    sel_kernel.SEL_BWD_BATCH_SUMS = 0
    sel_kernel.SEL_LAUNCHES = sel_kernel.SEL_BWD_LAUNCHES = 0
    sel_kernel.SEL_ROW_LAUNCHES = 0
    ry_kernel.RY_LAUNCHES = ry_kernel.RY_BWD_LAUNCHES = 0
    dm_kernel.DM_LAUNCHES = 0
    amp_damp_kernel.AMP_DAMP_LAUNCHES = 0
    wide_kernel.WIDE_LAUNCHES = wide_kernel.WIDE_BWD_LAUNCHES = 0
    wide_kernel.WIDE_MONO_LAUNCHES = wide_kernel.WIDE_MONO_BWD_LAUNCHES = 0
    unitary_kernel.UNITARY_LAUNCHES = 0
    unitary_kernel.UNITARY_BWD_LAUNCHES = 0
    probe_kernels.reset_launches()
    engine.reset_route_calls()


def read_counts() -> dict:
    return {"gate": gate_kernel.LAUNCHES, "gate_bwd": gate_kernel.BWD_LAUNCHES,
            "gate_bwd_sums": gate_kernel.BWD_BATCH_SUMS,
            "ry_bwd_sums": ry_kernel.RY_BWD_BATCH_SUMS,
            "sel_bwd_sums": sel_kernel.SEL_BWD_BATCH_SUMS,
            "sel": sel_kernel.SEL_LAUNCHES,
            "sel_bwd": sel_kernel.SEL_BWD_LAUNCHES,
            "sel_rows": sel_kernel.SEL_ROW_LAUNCHES,
            "ry": ry_kernel.RY_LAUNCHES, "ry_bwd": ry_kernel.RY_BWD_LAUNCHES,
            "dm": dm_kernel.DM_LAUNCHES,
            "amp": amp_damp_kernel.AMP_DAMP_LAUNCHES,
            "wide": wide_kernel.WIDE_LAUNCHES,
            "wide_bwd": wide_kernel.WIDE_BWD_LAUNCHES,
            "wide_mono": wide_kernel.WIDE_MONO_LAUNCHES,
            "wide_mono_bwd": wide_kernel.WIDE_MONO_BWD_LAUNCHES,
            "unitary": unitary_kernel.UNITARY_LAUNCHES,
            "unitary_bwd": unitary_kernel.UNITARY_BWD_LAUNCHES,
            # calls of the routes no kernel takes (engine.ROUTE_CALLS)
            **{f"route_{k}": n for k, n in engine.ROUTE_CALLS.items()}}


def chain_inputs(rng, wires: int, batch: int, n_layers: int, device):
    """Random phase planes and per-wire rotations for one chain call."""
    ang = torch.as_tensor(rng.normal(size=(n_layers, wires, 3)),
                          dtype=torch.float32, device=device)
    x = torch.as_tensor(rng.normal(size=(2**wires, batch)),
                        dtype=torch.float32, device=device)
    mats = rot_matrix(ang[..., 0], ang[..., 1], ang[..., 2])
    return torch.cos(x), torch.sin(x), mats


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one "
             "NVIDIA GPU")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    import scipy

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, numpy "
          f"{np.__version__}, scipy {scipy.__version__}, device {kind}, "
          f"count {torch.cuda.device_count()}")
    print(smi)
    return kind, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = gate_kernel.build_library()
    gate_kernel._library()
    print(f"build: {lib.name} ready in {time.perf_counter() - t0:.2f} s")
    log = lib.with_suffix(".log")
    if log.exists():
        print("nvcc -Xptxas -v:\n" + log.read_text().strip())


def _fwd_plan_line(wires: int, batch: int) -> str:
    plan = gate_kernel.chain_fwd_plan(wires, batch)
    return (f"plan {plan.warps} warp(s) a sample, {plan.samples} a CTA, "
            f"{plan.grid} CTAs")


def phase_kernel_vs_plain(dev) -> float:
    """Returns the worst max |kernel - plain| over the shapes: CASES and the
    forward's plan edges, each also called twice for the same bits."""
    rng = np.random.default_rng(SEED)
    worst = 0.0
    for w, b, n_layers, k in CASES + [(w, b, 28, 2)
                                      for w, b in FWD_PLAN_EDGES]:
        pr, pi, mats = chain_inputs(rng, w, b, n_layers, dev)
        kr, ki = gate_kernel.gate_chain_planes(pr, pi, mats, k, w)
        again = gate_kernel.gate_chain_planes(pr, pi, mats, k, w)
        qr, qi = gate_kernel.gate_chain_planes_plain(pr, pi, mats, k, w)
        torch.cuda.synchronize()
        err = max((kr - qr).abs().max().item(), (ki - qi).abs().max().item())
        worst = max(worst, err)
        same = torch.equal(kr, again[0]) and torch.equal(ki, again[1])
        print(f"kernel vs plain w={w} B={b} L*k={n_layers} k={k}: "
              f"max|diff| {err:.3e}; two calls "
              f"{'the same bits' if same else 'DIFFER'}; "
              + _fwd_plan_line(w, b))
        if not err <= KERNEL_TOL:
            fail(f"kernel disagrees with plain at w={w} B={b} "
                 f"L*k={n_layers} k={k}: {err:.3e} > {KERNEL_TOL}")
        if not same:
            fail(f"kernel gave other bits on a second call at w={w} B={b} "
                 f"L*k={n_layers} k={k}")
    return worst


def bwd_inputs(rng, wires: int, batch: int, n_layers: int, k: int, dev):
    """Forward inputs, forward output and N(0, 1) cotangents for one
    backward call: (pr, pi, g8, signs, fr, fi, gr, gi)."""
    pr, pi, mats = chain_inputs(rng, wires, batch, n_layers, dev)
    g8 = gate_kernel._to_g8(mats)
    signs = gate_kernel._sign_planes_on(k, wires, dev)
    fr, fi = gate_kernel._chain_plain(pr, pi, g8, signs, k, wires)
    gr, gi = (torch.as_tensor(rng.normal(size=(2**wires, batch)),
                              dtype=torch.float32, device=dev)
              for _ in range(2))
    return pr, pi, g8, signs, fr, fi, gr, gi


def _rel(got, want) -> float:
    return ((got - want).abs().max()
            / max(1.0, want.abs().max().item())).item()


def _plan_line(wires: int, batch: int) -> str:
    plan = gate_kernel.chain_bwd_plan(wires, batch)
    return (f"plan {plan.warps} warp(s) a sample, {plan.samples} a CTA, "
            f"{plan.cluster} CTAs a cluster x {plan.clusters}, dg summed "
            + ("in the launch" if plan.in_launch else "by a second launch"))


def phase_bwd_vs_plain(dev) -> float:
    """Returns the worst max |kernel - plain| over the shapes: CASES and the
    walk's plan edges, each also called twice for the same bits."""
    rng = np.random.default_rng(SEED + 2)
    worst = 0.0
    cases = CASES + [(w, b, 28, 2) for w, b in BWD_PLAN_EDGES]
    for w, b, n_layers, k in cases:
        args = bwd_inputs(rng, w, b, n_layers, k, dev)
        with torch.no_grad():
            got = gate_kernel._gate_chain_bwd_cuda(*args, k, w)
            again = gate_kernel._gate_chain_bwd_cuda(*args, k, w)
            want = gate_kernel.gate_chain_bwd_plain(*args, k, w)
        torch.cuda.synchronize()
        errs = [_rel(g, p) for g, p in zip(got, want)]
        worst = max(worst, *((g - p).abs().max().item()
                             for g, p in zip(got, want)))
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        print(f"backward kernel vs plain w={w} B={b} L*k={n_layers} k={k}: "
              f"dpr, dpi, dg max|diff| / max(1, max|plain|) "
              + ", ".join(f"{e:.3e}" for e in errs)
              + f"; two calls {'the same bits' if same else 'DIFFER'}; "
              + _plan_line(w, b))
        if not max(errs) <= BWD_TOL:
            fail(f"backward kernel disagrees with plain at w={w} B={b} "
                 f"L*k={n_layers} k={k}: {max(errs):.3e} > {BWD_TOL}")
        if not same:
            fail(f"backward kernel gave other bits on a second call at w={w} "
                 f"B={b} L*k={n_layers} k={k}")
    # a third formulation: autograd through the plain forward
    pr, pi, g8, signs, _, _, gr, gi = bwd_inputs(rng, 6, 16, 28, 2, dev)
    g8 = g8.requires_grad_(True)
    sr, si = gate_kernel._chain_plain(pr, pi, g8, signs, 2, 6)
    (sr * gr + si * gi).sum().backward()
    with torch.no_grad():
        fr, fi = gate_kernel._gate_chain_cuda(pr, pi, g8, signs, 2, 6)
        _, _, dg = gate_kernel._gate_chain_bwd_cuda(
            pr, pi, g8.detach(), signs, fr, fi, gr, gi, 2, 6)
    err = _rel(dg, g8.grad)
    print(f"backward kernel dg vs autograd of the plain forward w=6 B=16 "
          f"L*k=28: {err:.3e}")
    if not err <= BWD_TOL:
        fail(f"backward kernel dg disagrees with autograd: {err:.3e} > "
             f"{BWD_TOL}")
    return worst


def sel_inputs(rng, wires: int, batch: int, depth: int, dev):
    """Random normalized start-state planes (d, B) and per-wire rotations
    for one SEL-chain call: (sr, si, mats)."""
    st = rng.normal(size=(2, 2**wires, batch))
    st /= np.sqrt((st ** 2).sum(axis=(0, 1), keepdims=True))
    ang = torch.as_tensor(rng.normal(size=(depth, wires, 3)),
                          dtype=torch.float32, device=dev)
    sr, si = (torch.as_tensor(p, dtype=torch.float32, device=dev)
              for p in st)
    return sr, si, rot_matrix(ang[..., 0], ang[..., 1], ang[..., 2])


def sel_bwd_inputs(rng, wires: int, batch: int, depth: int, ring: str, dev):
    """Gates, forward output and N(0, 1) cotangents for one SEL backward
    call, (g8, fr, fi, gr, gi), and the start planes (sr, si)."""
    sr, si, mats = sel_inputs(rng, wires, batch, depth, dev)
    g8 = gate_kernel._to_g8(mats)
    fr, fi = sel_kernel._sel_plain(sr, si, g8, wires, ring)
    gr, gi = (torch.as_tensor(rng.normal(size=(2**wires, batch)),
                              dtype=torch.float32, device=dev)
              for _ in range(2))
    return (g8, fr, fi, gr, gi), (sr, si)


def _sel_plan_line(wires: int, batch: int) -> str:
    fwd = sel_kernel.sel_fwd_plan(wires, batch)
    bwd = sel_kernel.sel_bwd_plan(wires, batch)
    return (f"plans {fwd.warps} warp(s) a sample, {fwd.samples} a CTA x "
            f"{fwd.grid} forward, {bwd.samples} a CTA, {bwd.cluster} CTAs "
            f"a cluster x {bwd.clusters} backward, dg summed "
            + ("in the launch" if bwd.in_launch else "by a second launch"))


def phase_sel_vs_plain(dev, cases, seed: int) -> float:
    """Returns the worst max |kernel - plain| over the shapes, each also
    called twice for the same bits."""
    rng = np.random.default_rng(seed)
    worst = 0.0
    for w, b, depth, ring in cases:
        sr, si, mats = sel_inputs(rng, w, b, depth, dev)
        kr, ki = sel_kernel.sel_chain_planes(sr, si, mats, w, ring)
        again = sel_kernel.sel_chain_planes(sr, si, mats, w, ring)
        qr, qi = sel_kernel.sel_chain_planes_plain(sr, si, mats, w, ring)
        torch.cuda.synchronize()
        err = max((kr - qr).abs().max().item(), (ki - qi).abs().max().item())
        worst = max(worst, err)
        same = torch.equal(kr, again[0]) and torch.equal(ki, again[1])
        print(f"SEL kernel vs plain w={w} B={b} depth={depth} {ring}: "
              f"max|diff| {err:.3e}; two calls "
              f"{'the same bits' if same else 'DIFFER'}; "
              + _sel_plan_line(w, b))
        if not err <= KERNEL_TOL:
            fail(f"SEL kernel disagrees with plain at w={w} B={b} "
                 f"depth={depth} {ring}: {err:.3e} > {KERNEL_TOL}")
        if not same:
            fail(f"SEL kernel gave other bits on a second call at w={w} "
                 f"B={b} depth={depth} {ring}")
    return worst


def phase_sel_rows_vs_plain(dev, cases, seed: int) -> tuple[float, float]:
    """The rows kernel #5 (sel_chain_rows, the trajectory route's entry)
    against its plain version on (N, d) complex64 rows and against the
    planes' kernel on the same states as (d, N) planes; returns the worst
    max |diff| of each. The two kernels do the same 2x2 arithmetic per
    pair (gate_pair's fmaf order) in the same wire order and the rings
    exactly, so they give the same bits: the largest difference is printed
    and must be 0."""
    rng = np.random.default_rng(seed)
    worst, worst_cols = 0.0, 0.0
    for w, b, depth, ring in cases:
        sr, si, mats = sel_inputs(rng, w, b, depth, dev)
        states = torch.complex(sr, si).T.contiguous()
        got = sel_kernel.sel_chain_rows(states, mats, w, ring)
        want = sel_kernel.sel_chain_rows_plain(states, mats, w, ring)
        kr, ki = sel_kernel.sel_chain_planes(sr, si, mats, w, ring)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        cols = max((got.real - kr.T).abs().max().item(),
                   (got.imag - ki.T).abs().max().item())
        worst, worst_cols = max(worst, err), max(worst_cols, cols)
        print(f"SEL rows kernel w={w} N={b} depth={depth} {ring}: max|diff| "
              f"{err:.3e} against plain, {cols:.3e} against the planes' "
              f"kernel")
        if not (err <= KERNEL_TOL and cols == 0):
            fail(f"SEL rows kernel disagrees at w={w} N={b} depth={depth} "
                 f"{ring}: {err:.3e} against plain (bar {KERNEL_TOL}), "
                 f"{cols:.3e} against the planes' kernel (bar 0: the same "
                 f"bits)")
    print(f"SEL rows kernel against the planes' kernel: largest difference "
          f"{worst_cols:.3e} over {len(cases)} shapes (the same bits)")
    return worst, worst_cols


def phase_sel_bwd_vs_plain(dev, cases, seed: int,
                           check: tuple[int, int, int]) -> float:
    """Returns the worst max |kernel - plain| over the shapes, each also
    called twice for the same bits, and each taking one launch (and a
    second for dg's batch sum only past one cluster, SEL_BWD_BATCH_SUMS);
    ``check`` is the (w, B, depth) also held against autograd."""
    rng = np.random.default_rng(seed)
    worst = 0.0
    for w, b, depth, ring in cases:
        args, _ = sel_bwd_inputs(rng, w, b, depth, ring, dev)
        with torch.no_grad():
            sums = sel_kernel.SEL_BWD_BATCH_SUMS
            got = sel_kernel._sel_chain_bwd_cuda(*args, w, ring)
            sums = sel_kernel.SEL_BWD_BATCH_SUMS - sums
            again = sel_kernel._sel_chain_bwd_cuda(*args, w, ring)
            want = sel_kernel.sel_chain_bwd_plain(*args, w, ring)
        torch.cuda.synchronize()
        errs = [_rel(g, p) for g, p in zip(got, want)]
        worst = max(worst, *((g - p).abs().max().item()
                             for g, p in zip(got, want)))
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        in_launch = sel_kernel.sel_bwd_plan(w, b).in_launch
        print(f"SEL backward kernel vs plain w={w} B={b} depth={depth} "
              f"{ring}: dsr, dsi, dg max|diff| / max(1, max|plain|) "
              + ", ".join(f"{e:.3e}" for e in errs)
              + f"; two calls {'the same bits' if same else 'DIFFER'}; "
              f"{sums} second launch(es); " + _sel_plan_line(w, b))
        if not max(errs) <= BWD_TOL:
            fail(f"SEL backward kernel disagrees with plain at w={w} B={b} "
                 f"depth={depth} {ring}: {max(errs):.3e} > {BWD_TOL}")
        if not same:
            fail(f"SEL backward kernel gave other bits on a second call at "
                 f"w={w} B={b} depth={depth} {ring}")
        if sums != (0 if in_launch else 1):
            fail(f"SEL backward kernel at w={w} B={b}: {sums} second "
                 f"launches for dg's batch sum, want "
                 f"{0 if in_launch else 1}")
    # a third formulation: autograd through the plain forward
    w, b, depth = check
    for ring in ("cz", "cnot"):
        (g8, _, _, gr, gi), (sr, si) = sel_bwd_inputs(rng, w, b, depth, ring,
                                                      dev)
        leaves = [t.clone().requires_grad_(True) for t in (sr, si, g8)]
        out_r, out_i = sel_kernel._sel_plain(*leaves, w, ring)
        (out_r * gr + out_i * gi).sum().backward()
        with torch.no_grad():
            fr, fi = sel_kernel._sel_chain_cuda(sr, si, g8, w, ring)
            got = sel_kernel._sel_chain_bwd_cuda(g8, fr, fi, gr, gi, w, ring)
        err = max(_rel(g, leaf.grad) for g, leaf in zip(got, leaves))
        print(f"SEL backward kernel vs autograd of the plain forward w={w} "
              f"B={b} depth={depth} {ring}: {err:.3e}")
        if not err <= BWD_TOL:
            fail(f"SEL backward kernel disagrees with autograd ({ring}): "
                 f"{err:.3e} > {BWD_TOL}")
    return worst


def ry_bwd_inputs(rng, wires: int, batch: int, n_layers: int, k: int, dev):
    """Encode columns, gates, sign planes, forward output and N(0, 1)
    cotangents for one RY backward call: (cs, g8, signs, fr, fi, gr, gi)."""
    x = torch.as_tensor(2 * rng.normal(size=(batch, wires)),
                        dtype=torch.float32, device=dev)
    ang = torch.as_tensor(rng.normal(size=(n_layers, wires, 3)),
                          dtype=torch.float32, device=dev)
    cs = ry_kernel.ry_cs(x)
    g8 = gate_kernel._to_g8(rot_matrix(ang[..., 0], ang[..., 1], ang[..., 2]))
    signs = gate_kernel._sign_planes_on(k, wires, dev)
    fr, fi = ry_kernel._ry_plain(cs, g8, signs, k, wires)
    gr, gi = (torch.as_tensor(rng.normal(size=(2**wires, batch)),
                              dtype=torch.float32, device=dev)
              for _ in range(2))
    return cs, g8, signs, fr, fi, gr, gi


def phase_ry_vs_plain(dev) -> float:
    """Returns the worst max |kernel - plain| over the shapes: RY_CASES and
    the forward's plan edges, each also called twice for the same bits."""
    rng = np.random.default_rng(SEED + 5)
    worst = 0.0
    for w, b, n_layers, k in RY_CASES + [(w, b, 12, 2)
                                         for w, b in FWD_PLAN_EDGES]:
        cs, g8, signs, *_ = ry_bwd_inputs(rng, w, b, n_layers, k, dev)
        kr, ki = ry_kernel._ry_chain_cuda(cs, g8, signs, k, w)
        again = ry_kernel._ry_chain_cuda(cs, g8, signs, k, w)
        qr, qi = ry_kernel._ry_plain(cs, g8, signs, k, w)
        torch.cuda.synchronize()
        err = max((kr - qr).abs().max().item(), (ki - qi).abs().max().item())
        worst = max(worst, err)
        same = torch.equal(kr, again[0]) and torch.equal(ki, again[1])
        print(f"RY kernel vs plain w={w} B={b} L*k={n_layers} k={k}: "
              f"max|diff| {err:.3e}; two calls "
              f"{'the same bits' if same else 'DIFFER'}; "
              + _fwd_plan_line(w, b))
        if not err <= KERNEL_TOL:
            fail(f"RY kernel disagrees with plain at w={w} B={b} "
                 f"L*k={n_layers} k={k}: {err:.3e} > {KERNEL_TOL}")
        if not same:
            fail(f"RY kernel gave other bits on a second call at w={w} "
                 f"B={b} L*k={n_layers} k={k}")
    return worst


def phase_ry_bwd_vs_plain(dev) -> float:
    """Returns the worst max |kernel - plain| over the shapes: RY_CASES and
    the walk's plan edges, each also called twice for the same bits."""
    rng = np.random.default_rng(SEED + 6)
    worst = 0.0
    cases = RY_CASES + [(w, b, 12, 2) for w, b in BWD_PLAN_EDGES]
    for w, b, n_layers, k in cases:
        args = ry_bwd_inputs(rng, w, b, n_layers, k, dev)
        with torch.no_grad():
            got = ry_kernel._ry_chain_bwd_cuda(*args, k, w)
            again = ry_kernel._ry_chain_bwd_cuda(*args, k, w)
            want = ry_kernel.ry_chain_bwd_plain(*args, k, w)
        torch.cuda.synchronize()
        errs = [_rel(g, p) for g, p in zip(got, want)]
        worst = max(worst, *((g - p).abs().max().item()
                             for g, p in zip(got, want)))
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        print(f"RY backward kernel vs plain w={w} B={b} L*k={n_layers} "
              f"k={k}: dcs, dg max|diff| / max(1, max|plain|) "
              + ", ".join(f"{e:.3e}" for e in errs)
              + f"; two calls {'the same bits' if same else 'DIFFER'}; "
              + _plan_line(w, b))
        if not max(errs) <= BWD_TOL:
            fail(f"RY backward kernel disagrees with plain at w={w} B={b} "
                 f"L*k={n_layers} k={k}: {max(errs):.3e} > {BWD_TOL}")
        if not same:
            fail(f"RY backward kernel gave other bits on a second call at "
                 f"w={w} B={b} L*k={n_layers} k={k}")
    # a third formulation: autograd through the plain forward
    cs, g8, signs, _, _, gr, gi = ry_bwd_inputs(rng, 8, 10, 12, 2, dev)
    leaves = [t.clone().requires_grad_(True) for t in (cs, g8)]
    sr, si = ry_kernel._ry_plain(*leaves, signs, 2, 8)
    (sr * gr + si * gi).sum().backward()
    with torch.no_grad():
        fr, fi = ry_kernel._ry_chain_cuda(cs, g8, signs, 2, 8)
        got = ry_kernel._ry_chain_bwd_cuda(cs, g8, signs, fr, fi, gr, gi, 2,
                                           8)
    err = max(_rel(g, leaf.grad) for g, leaf in zip(got, leaves))
    print(f"RY backward kernel dcs, dg vs autograd of the plain forward w=8 "
          f"B=10 L*k=12: {err:.3e}")
    if not err <= BWD_TOL:
        fail(f"RY backward kernel disagrees with autograd: {err:.3e} > "
             f"{BWD_TOL}")
    return worst


def _density_errors(rho) -> tuple[float, float]:
    """max |rho - rho^dagger| and max |tr rho - 1| over the batch."""
    herm = (rho - rho.conj().transpose(-1, -2)).abs().max().item()
    trace = torch.diagonal(rho, dim1=-2, dim2=-1).sum(-1)
    return herm, (trace - 1).abs().max().item()


def phase_dm_vs_plain(dev) -> float:
    """Kernel #8 against its plain version; returns the worst max |diff|."""
    rng = np.random.default_rng(SEED + 7)
    worst = 0.0
    for w, b, n_spec, k, ry, strengths in DM_CASES:
        ang = torch.as_tensor(rng.normal(size=(n_spec * k, w, 3)),
                              dtype=torch.float32, device=dev)
        x = torch.as_tensor(2 * rng.normal(size=(b, w)), dtype=torch.float32,
                            device=dev)
        mats = rot_matrix(ang[..., 0], ang[..., 1], ang[..., 2])
        enc = x if ry else rz_phases(x, w)
        errs = []
        for kind in DM_KINDS:
            for g in strengths:
                got = dm_kernel.dm_chain(enc, mats, k, w, kind, g, ry=ry)
                want = dm_kernel.dm_chain_plain(enc, mats, k, w, kind, g,
                                                ry=ry)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                herm, trace = _density_errors(got)
                errs.append(err)
                if not (err <= DM_TOL and herm <= DM_TOL
                        and trace <= DM_TOL):
                    fail(f"dm kernel at w={w} B={b} L={n_spec} k={k} "
                         f"{'ry' if ry else 'rz'} {kind} {g}: |diff| "
                         f"{err:.3e}, Hermitian {herm:.3e}, trace "
                         f"{trace:.3e} > {DM_TOL}")
        worst = max(worst, *errs)
        plan = dm_kernel.cluster_plan(w, b, n_spec * k, ry)
        print(f"dm kernel vs plain w={w} B={b} L={n_spec} k={k} "
              f"{'ry' if ry else 'rz'}, 3 kinds x {len(strengths)} "
              f"strengths: max|diff| {max(errs):.3e}; {_plan_text(plan, w, n_spec * k, ry)}")
    return worst


def _plan_text(plan, w: int, n_layers: int, ry: bool) -> str:
    """Kernel #8's cluster plan and how many such clusters the card holds
    at once."""
    held = gate_kernel._library().dm_chain_active_clusters(
        w, n_layers, int(ry), plan.cluster, int(plan.rho_in_smem), 0)
    return (f"plan: cluster {plan.cluster}, {plan.rows_per_cta} rows a CTA, "
            f"{plan.smem_bytes} B of shared memory a CTA, rho in "
            f"{'shared' if plan.rho_in_smem else 'device'} memory, "
            f"{held} clusters resident at once")


def _rel_own(got, want) -> float:
    """max |got - want| relative to max |want|."""
    return ((got - want).abs().max() / want.abs().max()).item()


def phase_amp_vs_plain(dev) -> float:
    """Kernel #7 against its plain twin on the same uniforms; returns the
    worst max |diff| of the states."""
    rng = np.random.default_rng(SEED + 9)
    worst = 0.0
    for w, n in AMP_CASES:
        if n == AMP_CASES[0][1]:
            print(f"amp-damp plan w={w} at N=1000: "
                  f"{amp_damp_kernel.amp_damp_plan(w, 1000)}")
        st = rng.normal(size=(n, 2**w)) + 1j * rng.normal(size=(n, 2**w))
        st /= np.linalg.norm(st, axis=1, keepdims=True)
        states = torch.as_tensor(st, dtype=torch.complex64, device=dev)
        u = torch.as_tensor(rng.uniform(size=(w, n)), dtype=torch.float32,
                            device=dev)
        wgt = torch.linspace(0, 1, 2**w, device=dev)
        errs, differ, grad_errs = [], 0, []
        for g in AMP_STRENGTHS:
            with torch.no_grad():
                got, picks = amp_damp_kernel.amp_damp(states, u, g)
                want, want_picks = amp_damp_kernel.amp_damp_plain(states, u,
                                                                  g)
            torch.cuda.synchronize()
            errs.append((got - want).abs().max().item())
            differ += int((picks != want_picks).sum().item())
            with torch.no_grad():
                forced, again = amp_damp_kernel.amp_damp(states, u, g, picks)
            if not (torch.equal(forced, got) and torch.equal(again, picks)):
                fail(f"amp-damp kernel with its picks forced gives other "
                     f"states at w={w} N={n} g={g}")
            grads = []
            for fn in (amp_damp_kernel.amp_damp,
                       amp_damp_kernel.amp_damp_plain):
                leaves = (states.clone().requires_grad_(True),
                          torch.tensor(g, device=dev, requires_grad=True))
                out, _ = fn(*leaves[:1], u, leaves[1])
                ((out.abs() ** 2) * wgt).sum().backward()
                grads.append([leaf.grad for leaf in leaves])
            grad_errs.append(max(_rel_own(a, b) for a, b in zip(*grads)))
        worst = max(worst, *errs)
        print(f"amp-damp kernel vs plain w={w} N={n}, strengths "
              f"{AMP_STRENGTHS}: max|diff| {max(errs):.3e}, differing picks "
              f"{differ}, gradient (states, strength) max|diff| / max|plain| "
              f"{max(grad_errs):.3e}")
        if not (max(errs) <= KERNEL_TOL and differ == 0
                and max(grad_errs) <= BWD_TOL):
            fail(f"amp-damp kernel disagrees with plain at w={w} N={n}: "
                 f"{max(errs):.3e}, {differ} picks, gradient "
                 f"{max(grad_errs):.3e}")
    return worst


def wide_inputs(rng, wires: int, batch: int, n_layers: int, dev):
    """Phase planes, group planes, the plain forward's output and N(0, 1)
    cotangents for one wide-chain call at k = 2: (pr, pi, gplanes, fr, fi,
    gr, gi)."""
    pr, pi, mats = chain_inputs(rng, wires, batch, n_layers, dev)
    gplanes = wide_kernel._planes_of(
        wide.group_gates(mats, wide.group_sizes(wires)))
    fr, fi = wide_kernel._chain_plain(
        pr, pi, gplanes, gate_kernel._sign_planes_on(2, wires, dev), 2,
        wires)
    gr, gi = (torch.as_tensor(rng.normal(size=(2**wires, batch)),
                              dtype=torch.float32, device=dev)
              for _ in range(2))
    return pr, pi, gplanes, fr, fi, gr, gi


def _flat(bwd) -> tuple:
    """(dpr, dpi, dgplanes) -> (dpr, dpi, dg0r, dg0i, ...)."""
    return (bwd[0], bwd[1], *bwd[2])


def phase_wide_vs_plain(dev) -> dict:
    """Kernels #11 and #12 against their plain versions at WIDE_CASES and
    WIDE_PATH_CASES, and #12 once against autograd through the plain
    forward; returns, by (w, B, L*k), the forward's max |diff| and the
    backward's largest max |diff| / max(1, max|plain|), the values
    checked."""
    rng = np.random.default_rng(SEED + 12)
    by_shape = {}
    for w, b, n in WIDE_CASES + WIDE_PATH_CASES:
        pr, pi, gplanes, fr, fi, gr, gi = wide_inputs(rng, w, b, n, dev)
        with torch.no_grad():
            kr, ki = wide_kernel._wide_chain_cuda(pr, pi, gplanes, 2, w)
            got = _flat(wide_kernel._wide_chain_bwd_cuda(
                pr, pi, gplanes, fr, fi, gr, gi, 2, w))
            want = _flat(wide_kernel.wide_chain_bwd_plain(
                pr, pi, gplanes, fr, fi, gr, gi, 2, w))
        torch.cuda.synchronize()
        err = max((kr - fr).abs().max().item(), (ki - fi).abs().max().item())
        errs = [_rel(g, q) for g, q in zip(got, want)]
        by_shape[(w, b, n)] = (err, max(errs))
        print(f"wide kernels vs plain w={w} B={b} L*k={n} groups "
              f"{wide.group_sizes(w)}: forward max|diff| {err:.3e}; backward "
              f"dpr, dpi, dG max|diff| / max(1, max|plain|) "
              + ", ".join(f"{e:.3e}" for e in errs))
        if not (err <= KERNEL_TOL and max(errs) <= WIDE_BWD_TOL):
            fail(f"wide kernels disagree with plain at w={w} B={b} L*k={n}: "
                 f"forward {err:.3e} > {KERNEL_TOL} or backward "
                 f"{max(errs):.3e} > {WIDE_BWD_TOL}")
    # a third formulation: autograd through the plain forward
    w, b, n = 11, 10, 4
    pr, pi, gplanes, _, _, gr, gi = wide_inputs(rng, w, b, n, dev)
    leaves = [t.clone().requires_grad_(True) for t in (pr, pi, *gplanes)]
    sr, si = wide_kernel._chain_plain(
        leaves[0], leaves[1], leaves[2:],
        gate_kernel._sign_planes_on(2, w, dev), 2, w)
    (sr * gr + si * gi).sum().backward()
    with torch.no_grad():
        fr, fi = wide_kernel._wide_chain_cuda(pr, pi, gplanes, 2, w)
        got = _flat(wide_kernel._wide_chain_bwd_cuda(pr, pi, gplanes, fr, fi,
                                                     gr, gi, 2, w))
    err = max(_rel(g, leaf.grad) for g, leaf in zip(got, leaves))
    print(f"wide backward kernel vs autograd of the plain forward w={w} "
          f"B={b} L*k={n}: {err:.3e}")
    if not err <= WIDE_BWD_TOL:
        fail(f"wide backward kernel disagrees with autograd: {err:.3e} > "
             f"{WIDE_BWD_TOL}")
    return by_shape


@contextlib.contextmanager
def wide_variant(name: str):
    """Run the block with the wide chain's kernel variant ``name``, then
    restore the one before."""
    prev = config.wide_kernel_variant()
    config.set_wide_kernel_variant(name)
    try:
        yield
    finally:
        config.set_wide_kernel_variant(prev)


def phase_wide_bench(smi: str) -> tuple[dict, dict]:
    """bench.py's bench_wide_reupload on the card through the engine's
    entry: reupload_block at L=14, k=2, batch 8, RZ encode, CZ ring, PauliZ
    readout, the MSE to a target, autograd and an SGD step (lr 0.01) per
    step, host-looped after a warm step; at each width under both kernel
    variants in turn, from the same seeded weights (the card's counterpart
    of the JAX package's tools/bench_wide_kernel_ab.py). Returns the launch
    counts of the timed steps and the steps/s, by variant and width; fails
    if the two variants' losses part by more than KERNEL_TOL."""
    rates = {v: {} for v in VARIANTS}
    counts = {v: {} for v in VARIANTS}
    for wires, steps in WIDE_BENCH:
        losses = {}
        for variant in VARIANTS:
            gen = torch.Generator().manual_seed(SEED)
            w = (torch.randn((14, 2, wires, 3), generator=gen) * 0.4).to(
                "cuda")
            x = torch.rand((8, wires), generator=gen).to("cuda")
            tgt = torch.rand((8, wires), generator=gen).to("cuda")

            def step(w):
                w = w.detach().requires_grad_(True)
                out = engine.reupload_block(x, w, encode="rz",
                                            imprimitive="cz",
                                            readout="expvalz")
                loss = ((out - tgt) ** 2).mean()
                loss.backward()
                return (w - 0.01 * w.grad).detach(), loss.detach()

            with wide_variant(variant):
                w, _ = step(w)  # warm-up
                torch.cuda.synchronize()
                run = []
                reset_counts()
                t0 = time.perf_counter()
                for _ in range(steps):
                    w, loss = step(w)
                    run.append(loss)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = read_counts()
            losses[variant] = [v.item() for v in run]
            counts[variant][wires] = got
            rates[variant][wires] = steps / wall
            print(f"wide bench w={wires} {variant}: {steps} fwd+bwd steps "
                  f"(L=14, k=2, batch 8) in {wall:.4f} s, "
                  f"{rates[variant][wires]:.3f} steps/s; loss "
                  f"{losses[variant][0]:.6f} -> {losses[variant][-1]:.6f}; "
                  f"launches {got} ({smi})")
            if not all(math.isfinite(v) for v in losses[variant]):
                fail(f"the {wires}-wire bench block's losses are not finite "
                     f"({variant})")
            # scan: a group-kernel launch per wire group of each of the 28
            # sublayers; monolith: one launch a chain call
            groups = 28 * len(wide.group_sizes(wires)) * steps
            want = ({"wide": groups, "wide_bwd": groups, "wide_mono": 0,
                     "wide_mono_bwd": 0} if variant == "scan" else
                    {"wide": 0, "wide_bwd": 0, "wide_mono": steps,
                     "wide_mono_bwd": steps})
            if any(got[c] != n for c, n in want.items()):
                fail(f"{wires}-wire bench block ({variant}): launches {got}, "
                     f"not {want}")
        apart = max(abs(a - b) for a, b in zip(*losses.values()))
        print(f"wide bench w={wires}: scan against monolith, {steps} steps' "
              f"losses max|diff| {apart:.3e}")
        if not apart <= KERNEL_TOL:
            fail(f"the {wires}-wire bench block's losses differ between the "
                 f"kernel variants: {apart:.3e} > {KERNEL_TOL}")
    return counts, rates


def phase_mono_vs_plain(dev) -> dict:
    """Kernels #9 and #10 against their plain versions at WIDE_CASES and
    WIDE_PATH_CASES, and against #11/#12 on the same inputs, which they
    must equal bit for bit; returns, by (w, B, L*k), the forward's
    max |diff| and the backward's largest max |diff| / max(1, max|plain|)
    against plain, the values checked."""
    rng = np.random.default_rng(SEED + 14)
    by_shape = {}
    for w, b, n in WIDE_CASES + WIDE_PATH_CASES:
        args = wide_inputs(rng, w, b, n, dev)
        pr, pi, gplanes, fr, fi = args[:5]
        with torch.no_grad():
            mr, mi = wide_kernel._wide_mono_cuda(pr, pi, gplanes, 2, w)
            got = _flat(wide_kernel._wide_mono_bwd_cuda(*args, 2, w))
            sr, si = wide_kernel._wide_chain_cuda(pr, pi, gplanes, 2, w)
            scan = _flat(wide_kernel._wide_chain_bwd_cuda(*args, 2, w))
            want = _flat(wide_kernel.wide_chain_bwd_plain(*args, 2, w))
        torch.cuda.synchronize()
        err = max((mr - fr).abs().max().item(), (mi - fi).abs().max().item())
        errs = [_rel(g, q) for g, q in zip(got, want)]
        vs_scan = max((mr - sr).abs().max().item(),
                      (mi - si).abs().max().item())
        vs_scan_bwd = max((g - q).abs().max().item()
                          for g, q in zip(got, scan))
        by_shape[(w, b, n)] = (err, max(errs))
        print(f"monolith kernels vs plain w={w} B={b} L*k={n} groups "
              f"{wide.group_sizes(w)}: forward max|diff| {err:.3e}; backward "
              f"dpr, dpi, dG max|diff| / max(1, max|plain|) "
              + ", ".join(f"{e:.3e}" for e in errs)
              + f"; against #11/#12 max|diff| forward {vs_scan:.3e}, "
              f"backward {vs_scan_bwd:.3e}")
        if not (err <= KERNEL_TOL and max(errs) <= WIDE_BWD_TOL):
            fail(f"monolith kernels disagree with plain at w={w} B={b} "
                 f"L*k={n}: forward {err:.3e} > {KERNEL_TOL} or backward "
                 f"{max(errs):.3e} > {WIDE_BWD_TOL}")
        same = (torch.equal(mr, sr) and torch.equal(mi, si),
                all(torch.equal(g, q) for g, q in zip(got, scan)))
        if not all(same):
            fail(f"monolith kernels differ from #11/#12 at w={w} B={b} "
                 f"L*k={n} (forward, backward bit-equal: {same})")
    return by_shape


def _at_width(errs: dict, wires: int) -> tuple[float, float]:
    """The largest forward and backward errors of a wide-kernel phase's
    result among its shapes of ``wires`` wires."""
    return tuple(max(e[i] for (w, _, _), e in errs.items() if w == wires)
                 for i in (0, 1))


def phase_mono_config() -> None:
    """The grids of the cooperative launches #9 and #10 at the model's and
    the widest shapes, as their launches plan them."""
    lib = gate_kernel._library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for w, b in ((16, 10), (20, 8)):
        _, sizes = wide_kernel._group_args((), wide.group_sizes(w))
        for bwd in (False, True):
            out = (ctypes.c_int * 2)()
            gate_kernel._raise_on(
                lib.wide_mono_plan(int(bwd), *sizes, w, b, 0, out), lib,
                "wide-chain monolith plan")
            print(f"monolith #{10 if bwd else 9} at w={w} B={b}: grid "
                  f"{out[0]} blocks, {out[1]} co-resident blocks an SM x "
                  f"{sms} SMs")


# #9-#14's kernels in the built library: #11/#12's templates with their
# arguments (mangled: I, then Li<n>E each), #9/#10 as they are; #13, and
# #14's walk and its dU product
_WIDE_SASS = re.compile(
    r"(wide_(?:group_mma|dg_mma|mono_fwd|mono_bwd)_kernel"
    r"|unitary_chain_(?:fwd|bwd|du)_kernel)(?:I((?:Li\d+E)+))?")
_UNITARY_BWD = re.compile(r"unitary_chain_(?:bwd|du)_kernel")
# P5's instances (row tiles, strip width) and P3's kernel
_PROBE_SASS = re.compile(r"probe_(?:matmul2_kernelILi(\d)E|reshape_kernel)")
_AMP_PTXAS = re.compile(r"amp_damp_fwd_kernelILi(\d+)E")


def phase_wide_sass() -> None:
    """#9-#14's registers and spills from ptxas's report in the build log,
    and the TF32 tensor-core instructions (HMMA ... TF32) in their SASS
    (cuobjdump -sass of the built library, from nvcc's toolkit); fails
    unless each of the seven kernels (#14's walk and its dU product
    apart) is there and every instance holds some, or if an instance of
    #14 spills. Also #7's registers and spills at each width (no tensor
    cores), P5's and P3's registers and spills, and the TF32 wgmma
    instructions (HGMMA ... TF32) in each of P5's two instances (fails
    unless both are there, each with some)."""
    lib = gate_kernel.build_library()
    lines = lib.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and _WIDE_SASS.search(line):
            print("ptxas " + " | ".join(t.strip() for t in lines[i:i + 4]))
            spill = re.search(r"(\d+) bytes spill stores",
                              " ".join(lines[i + 1:i + 4]))
            if _UNITARY_BWD.search(line) and (not spill
                                             or int(spill.group(1))):
                fail(f"#14 spills registers (or ptxas did not say): "
                     f"{lines[i:i + 4]}")
    amp = {}
    for i, line in enumerate(lines):
        found = _AMP_PTXAS.search(line)
        if "Compiling entry function" in line and found:
            text = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores", text)
            amp[int(found.group(1))] = (regs and regs.group(1),
                                        spill and spill.group(1))
    print("ptxas #7 (amp_damp_fwd_kernel<w>) registers / spill-store bytes: "
          + ", ".join(f"w={w} {r} / {b}" for w, (r, b) in sorted(amp.items())))
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and _PROBE_SASS.search(line):
            print("ptxas P5/P3 " + " | ".join(t.strip()
                                              for t in lines[i:i + 4]))
    tool = pathlib.Path(gate_kernel._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    counts, p5, name = {}, {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            if _WIDE_SASS.search(name):
                counts[name] = 0
            probe = _PROBE_SASS.search(name)
            if probe and probe.group(1):
                p5[name] = 0
        elif name in counts and "HMMA" in line and "TF32" in line:
            counts[name] += 1
        elif name in p5 and "HGMMA" in line and "TF32" in line:
            p5[name] += 1
    print("SASS TF32 HGMMA (wgmma) instructions by P5 instance "
          "(probe_matmul2_kernel<row tiles>): " + ", ".join(
              f"<{_PROBE_SASS.search(n).group(1)}> {c}"
              for n, c in p5.items()))
    if len(p5) != 2 or not all(p5.values()):
        fail(f"P5 instances without TF32 HGMMA in their SASS: {p5}")

    def label(mangled: str) -> str:
        kernel, args = _WIDE_SASS.search(mangled).groups()
        return kernel + ("<" + ", ".join(re.findall(r"\d+", args)) + ">"
                         if args else "")

    print("SASS TF32 HMMA instructions by kernel: " + ", ".join(
        f"{label(n)} {c}" for n, c in counts.items()))
    kinds = {_WIDE_SASS.search(n).group(1) for n in counts}
    if len(kinds) < 7 or not all(counts.values()):
        fail(f"#9-#14 kernels without TF32 HMMA in their SASS: {counts}")


# #1-#6's instances in ptxas's report: gate_, ry_ or sel_, fwd or bwd, the
# width
_WALK_PTXAS = re.compile(
    r"(gate|ry|sel)_chain_(fwd|bwd)_regs_kernelILi(\d+)E")
_WALK_KERNELS = {("gate", "fwd"): "#1", ("gate", "bwd"): "#2",
                 ("ry", "fwd"): "#3", ("ry", "bwd"): "#4",
                 ("sel", "fwd"): "#5", ("sel", "bwd"): "#6"}
NO_SPILL_WIRES = (6, 8, 10)  # the forwards spill nothing at these widths
SEL_NO_SPILL_WIRES = (6, 8)  # #5 and #6 at the models' widths
# the width instances of each: 1-10 wires, 1-12 for the SEL chain
WALK_WIDTHS = {"#1": 10, "#2": 10, "#3": 10, "#4": 10, "#5": 12, "#6": 12}


def phase_walk_registers() -> dict:
    """#1-#6's registers and spill-store bytes from ptxas's report in the
    build log, for every width instance (1-10 wires, 1-12 for #5/#6); fails
    unless all sixty-four instances are there, if a forward (#1, #3) spills
    at 6, 8 or 10 wires, or if #5 or #6 spills at 6 or 8 wires. Returns
    {(kernel, wires): (registers, spill-store bytes)}."""
    lib = gate_kernel.build_library()
    lines = lib.with_suffix(".log").read_text().splitlines()
    found = {}
    for i, line in enumerate(lines):
        match = _WALK_PTXAS.search(line)
        if "Compiling entry function" in line and match:
            text = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores", text)
            if regs and spill:
                found[_WALK_KERNELS[match.group(1), match.group(2)],
                      int(match.group(3))] = (int(regs.group(1)),
                                              int(spill.group(1)))
    for (name, kind), kernel in _WALK_KERNELS.items():
        print(f"ptxas {kernel} ({name}_chain_{kind}_regs_kernel<w>) "
              f"registers / spill-store bytes: " + ", ".join(
                  f"w={w} {found[kernel, w][0]} / {found[kernel, w][1]}"
                  for w in range(1, WALK_WIDTHS[kernel] + 1)
                  if (kernel, w) in found))
    want = {(kernel, w) for kernel, top in WALK_WIDTHS.items()
            for w in range(1, top + 1)}
    if set(found) != want:
        fail(f"ptxas reported {len(found)} of the {len(want)} #1-#6 "
             f"instances; missing {sorted(want - set(found))}")
    spilled = {key: v for key, v in found.items() if v[1] and (
        (key[0] in ("#1", "#3") and key[1] in NO_SPILL_WIRES)
        or (key[0] in ("#5", "#6") and key[1] in SEL_NO_SPILL_WIRES))}
    if spilled:
        fail(f"instances spill registers: {spilled}")
    return found


def phase_mono_model(tmp: pathlib.Path, n_train: int,
                     smi: str) -> tuple[dict, float, float]:
    """The 16-wire model under the "monolith" variant: sampling through the
    sampling CLI as phase 20 does (the first 3 iterations of the last batch
    held step by step against the CPU), 3 training steps (batch 1, tau 10)
    held against the CPU at the card's weights as phase 21 does, and
    mnist_exm's 2 epochs with its checkpoint served as phase 21 does; each
    run at exactly MONO_PER_ITER #9 launches an iteration or step,
    MONO_PER_ITER #10 a training step, and no group-kernel launch. Then
    the host-clock training step under each variant in turns (scan,
    monolith, monolith, scan). Returns the launch counts of the three runs
    summed, the steady sampling images/s and mnist_exm's training images/s
    in its second epoch."""
    with wide_variant("monolith"):
        with torch.no_grad():
            sampled, rate = phase_sample(tmp, WIDE_MODEL, 28, "wide_mono",
                                         MONO_PER_ITER, 3)
        reset_counts()
        phase_train_parity(tmp, WIDE_MODEL, 1)
        trained = read_counts()
        per_step = {"wide_mono": MONO_PER_ITER, "wide_mono_bwd": MONO_PER_ITER}
        driven, train_rate = phase_train(tmp, n_train, [WIDE_MODEL], per_step,
                                         default=False, prefix="mono_")
    iters = ITERS * BATCHES
    steps = EPOCHS * n_train
    want = ({"wide": 0, "wide_bwd": 0, "wide_mono": MONO_PER_ITER * iters,
             "wide_mono_bwd": 0},
            {"wide": 0, "wide_bwd": 0, "wide_mono": MONO_PER_ITER * 3,
             "wide_mono_bwd": MONO_PER_ITER * 3},
            {"wide": 0, "wide_bwd": 0,
             "wide_mono": MONO_PER_ITER * (steps + TAU_TEST),
             "wide_mono_bwd": MONO_PER_ITER * steps})
    for what, got, need in (("sampling", sampled, want[0]),
                            ("training", trained, want[1]),
                            ("mnist_exm training", driven, want[2])):
        print(f"monolith 16-wire {what}: launches {got}")
        if any(got[c] != n for c, n in need.items()):
            fail(f"16-wire {what} under the monolith variant: launches "
                 f"{got}, not {need}")
    z = np.load(tmp / "data" / "mnist_28.npz")
    x = torch.as_tensor(z["x"][z["y"] == LABEL][:1] / 255.0,
                        dtype=torch.float32, device="cuda").reshape(1, -1)
    net = common.build_model(WIDE_MODEL, seed=SEED, device="cuda")
    diff = Diffusion(net).train()
    step = diff.make_train_step(
        torch.optim.Adam(diff.parameters(), lr=common.FALLBACK_LR), TAU)
    gen = torch.Generator().manual_seed(SEED)
    ms = {v: [] for v in VARIANTS}
    for variant in (*VARIANTS, *VARIANTS[::-1]):
        with wide_variant(variant):
            step(x, gen)  # warm-up
            ms[variant].append(_host_ms(lambda: step(x, gen)))
    print(f"16-wire training step (batch 1, tau {TAU}; {smi}), host clock, "
          f"median of 20 each ending in a synchronise, in turns: "
          + "; ".join(f"{v} {', '.join(f'{t:.3f}' for t in ms[v])} ms"
                      for v in VARIANTS))
    return ({c: sampled[c] + trained[c] + driven[c] for c in sampled}, rate,
            train_rate[WIDE_MODEL[0]])


def _is_wide_fwd(name: str) -> bool:
    """Kernel #11's launches: the one-right-hand-side group product
    (templated, as the profiler demangles it or not)."""
    return ("wide_group_mma_kernel<1," in name
            or "wide_group_mma_kernelILi1E" in name)


def phase_profile_wide(tmp: pathlib.Path, smi: str) -> None:
    """Where a 16-wire training step's time goes (batch 1, tau 10): 10
    steady Adam steps under torch.profiler give the device events, busy
    time and idle share per step and the device time of #11 and #12 (the
    backward's group products, dG products and sums, and un-encodes); the
    step is also timed on the host clock without the profiler."""
    z = np.load(tmp / "data" / "mnist_28.npz")
    x = torch.as_tensor(z["x"][z["y"] == LABEL][:1] / 255.0,
                        dtype=torch.float32, device="cuda").reshape(1, -1)
    net = common.build_model(WIDE_MODEL, seed=SEED, device="cuda")
    diff = Diffusion(net).train()
    step = diff.make_train_step(
        torch.optim.Adam(diff.parameters(), lr=common.FALLBACK_LR), TAU)
    gen = torch.Generator().manual_seed(SEED)
    step_ms = _host_ms(lambda: step(x, gen))
    steps = 10

    def run():
        for _ in range(steps):
            step(x, gen)

    dev, busy, wall_us, counts = _device_profile(run)
    fwd = sum(e.time_range.elapsed_us() for e in dev if _is_wide_fwd(e.name))
    bwd = sum(e.time_range.elapsed_us() for e in dev
              if "wide_" in e.name and not _is_wide_fwd(e.name))
    want = WIDE_PER_ITER * steps
    if (counts["wide"] < want or counts["wide_bwd"] < want or not fwd
            or not bwd):
        fail(f"{counts['wide']} #11 and {counts['wide_bwd']} #12 launches "
             f"in {steps} profiled 16-wire training steps, not {want} each, "
             f"or no wide-chain kernel among the profiled events: "
             f"{sorted({e.name for e in dev})[:20]}")
    print(f"profile {' '.join(WIDE_MODEL)} training ({smi}), {steps} steps: "
          f"{len(dev) / steps:.1f} device events per step, device busy "
          f"{busy / steps / 1e3:.4f} ms per step, idle share "
          f"{1 - busy / wall_us:.3f} of {wall_us / steps / 1e3:.3f} ms per "
          f"profiled step; #11 {fwd / steps:.1f} us per step ({fwd / busy:.3f} "
          f"of busy), #12 {bwd / steps:.1f} us per step ({bwd / busy:.3f} of "
          f"busy); step without the profiler {step_ms:.3f} ms (host clock, "
          f"median of 20, each ending in a synchronise)")


def phase_pca_on_card(side: int) -> None:
    """QIDDM_PL_noise1 refits a PCA on every forward batch: the projection
    of the sampler's first start batch (16 random images, 8 components),
    fitted by cuSOLVER on the card and by LAPACK on the CPU."""
    gen = torch.Generator().manual_seed(SEED)
    x = (torch.rand((N, side * side), generator=gen) * 0.75 + 0.5)
    _, got = pca_fit_transform(x.to("cuda"), int(PL_MODEL[2]))
    _, want = pca_fit_transform(x, int(PL_MODEL[2]))
    err = (got.cpu() - want).abs().max().item()
    print(f"PCA projection of {N} start images, card against the CPU: "
          f"max|diff| {err:.3e}")
    if not err <= SAMPLE_TOL:
        fail(f"the PCA projection on the card differs from the CPU's: "
             f"{err:.3e} > {SAMPLE_TOL}")


@contextlib.contextmanager
def _tf32():
    """TF32 on for cuBLAS and cuDNN (a float32 hold's control), then off
    again, as qiddm_tpu_torch.config sets it."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def phase_sample(tmp: pathlib.Path, margs: list, side: int, counter: str,
                 per_iter: int, held: int,
                 ckpt: pathlib.Path | None = None,
                 floor64: bool = False,
                 shared_fit: bool = False) -> tuple[dict, float]:
    """Sample ``margs`` through the sampling CLI on cuda, from ``ckpt`` or
    from the seeded model's weights; returns the launch counts of the run
    and the steady images/s. With ``held`` = 0 the CPU plain path is held
    to the last batch from the start images; otherwise to each of the
    first ``held`` iterations from the card's batch (and the free-running
    drift is printed when that is all of them). With ``floor64`` the
    card's iterations are held against the CPU plain path's float64 step
    from the same batch, within the larger of SAMPLE_TOL and FLOOR_FACTOR
    times their float32 floor (the CPU's float32 step's distance from that
    float64 step), and the free-running drift is not computed; the same
    steps on the card with TF32 on must lie outside that limit, and the
    card's float64 steps within X64_TOL of the CPU's: the card runs the same
    function, and float32 rounding is all that parts the two. With
    ``shared_fit`` (a model that refits a PCA on every batch) each held
    iteration is the card's step from the batch against the CPU's given
    the card's PCA fit of it, as phase_zoo holds the refit classes:
    cuSOLVER's and LAPACK's float32 ``eigh`` part where the spectrum is
    close (ROADMAP Queue 3); the CPU's steps from its own fit are printed
    beside."""
    net = common.build_model(margs, seed=SEED, device="cuda")
    if ckpt is None:
        ckpt = save_checkpoint(tmp / f"{net.save_name()}.pt",
                               export_jax_variables(net), [], 0)
    else:
        load_jax_variables(net, load_checkpoint(ckpt)["model_state_dict"])
    out = tmp / f"samples_{margs[0]}"
    argv = ["--ckpt", str(ckpt), "--model", *margs, "--img_size", str(side),
            "--n", str(N), "--iters", str(ITERS), "--batches", str(BATCHES),
            "--device", "cuda", "--format", "npz", "--seed", str(SEED),
            "--out", str(out)]
    printed = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(printed):
        imgs = sample_cli.main(argv)
    counts = read_counts()
    print(printed.getvalue().strip())
    print(f"sample {margs[0]}: launches {counts}")
    if imgs.shape != (N * BATCHES, 1, side, side):
        fail(f"{margs[0]} samples have shape {imgs.shape}")
    if not np.isfinite(imgs).all():
        fail(f"{margs[0]} samples are not finite")
    saved = np.load(out / "samples.npz")["images"]
    if not np.array_equal(saved, imgs):
        fail("samples.npz does not hold the returned images")
    want = per_iter * ITERS * BATCHES
    if counts[counter] < want:
        fail(f"{margs[0]}: {counts[counter]} {counter} kernel launches < "
             f"{want}: the sampling path did not run the kernel")

    # the same weights and start images on the CPU plain path
    cpu_net = common.build_model(margs, seed=SEED, device="cpu")
    load_jax_variables(cpu_net, load_checkpoint(ckpt)["model_state_dict"])
    gen = torch.Generator().manual_seed(SEED)
    for _ in range(BATCHES):
        first_x = torch.rand((N, 1, side, side), generator=gen) * 0.75 + 0.5
    if held == 0 or (held == ITERS and not floor64):
        ref = Diffusion(cpu_net, prediction_goal="data",
                        shape=(side, side)).sample(
            n_iters=ITERS, first_x=first_x, only_last=True).numpy()
        err = float(np.abs(ref - imgs[-N:]).max())
        print(f"sample {margs[0]}: last batch against the CPU plain path "
              f"max|diff| {err:.3e}" + (" (free-running, not held)" if held
                                        else ""))
    if held:
        stack = Diffusion(net, shape=(side, side)).sample_stack_fn(
            first_x.to("cuda"), ITERS).cpu()
        if not np.array_equal(stack[-1].numpy(), imgs[-N:]):
            fail(f"{margs[0]}: rerunning the last batch on the card does not "
                 f"give the CLI's images")
        cpu_steps = [cpu_net(stack[t]) for t in range(held)]
        err = max((want - stack[t + 1]).abs().max().item()
                  for t, want in enumerate(cpu_steps))
        if shared_fit:
            own, err = err, 0.0
            for t in range(held):
                x = stack[t].to("cuda")
                fit = pca_fit(x.reshape(N, -1), net.module.hidden)
                with _shared_pca(PCAState(fit.mean.cpu(),
                                          fit.components.cpu())):
                    want = cpu_net(stack[t])
                err = max(err, (want - net(x).cpu()).abs().max().item())
            print(f"sample {margs[0]}: from the CPU's own PCA fit of each "
                  f"batch {own:.3e}, not held")
        print(f"sample {margs[0]}: each of the first {held} iterations from "
              f"the card's batch against the CPU plain path"
              + (" given the card's PCA fit of the batch" if shared_fit
                 else "") + f" max|diff| {err:.3e}")
    tol = SAMPLE_TOL
    if floor64:
        cpu64 = copy.deepcopy(cpu_net).double()
        card64 = copy.deepcopy(net).double()
        exact = [cpu64(stack[t].double()) for t in range(held)]
        same = max((e - card64(stack[t].to("cuda").double()).cpu()).abs()
                   .max().item() for t, e in enumerate(exact))
        floor = max((e - want).abs().max().item()
                    for e, want in zip(exact, cpu_steps))
        err = max((e - stack[t + 1]).abs().max().item()
                  for t, e in enumerate(exact))
        tol = max(SAMPLE_TOL, FLOOR_FACTOR * floor)
        with _tf32():
            control = max((e - net(stack[t].to("cuda")).cpu()).abs().max()
                          .item() for t, e in enumerate(exact))
        print(f"sample {margs[0]}: the same iterations in float64, the card "
              f"against the CPU plain path, max|diff| {same:.3e} (held "
              f"within {X64_TOL}); in float32, the card against the CPU's "
              f"float64 step max|diff| {err:.3e}, held within {tol:.3e}: "
              f"{FLOOR_FACTOR} x their float32 floor (the CPU's float32 step "
              f"against its float64 step) {floor:.3e} (the card at "
              f"{err / floor:.3f} x), or {SAMPLE_TOL}; control, the card's "
              f"steps with TF32 on for cuBLAS and cuDNN, {control:.3e}")
        if not same <= X64_TOL:
            fail(f"{margs[0]}: the card's float64 steps differ from the CPU's: "
                 f"{same:.3e} > {X64_TOL}")
        if not control > tol:
            fail(f"{margs[0]}: the float64 hold does not tell TF32 from "
                 f"float32: {control:.3e} <= {tol:.3e}")
    if not err <= tol:
        fail(f"{margs[0]} cuda samples differ from the CPU plain path: "
             f"{err:.3e} > {tol:.3e}")
    m = re.search(r"steady ([0-9.]+) images/s", printed.getvalue())
    if m is None:
        fail("the sampler printed no steady images/s")
    return counts, float(m.group(1))


def write_dataset(data_dir: pathlib.Path) -> int:
    """A seeded stand-in for MNIST: 500 28x28 uint8 images, labels 0-9 in
    turn, as ``mnist_28.npz``; returns mnist_exm's training-image count
    for LABEL (80% of its 50)."""
    rng = np.random.default_rng(SEED)
    x = (rng.uniform(size=(500, 28, 28)) ** 3 * 255).astype(np.uint8)
    y = np.arange(500) % 10
    data_dir.mkdir(parents=True, exist_ok=True)
    np.savez(data_dir / "mnist_28.npz", x=x, y=y)
    data_mod.DATA_DIR = data_dir
    return int((y == LABEL).sum() * 0.8)


def write_fashion(data_dir: pathlib.Path) -> None:
    """A seeded stand-in for FashionMNIST: 500 28x28 uint8 images, labels
    0-9 in turn, as ``fashion_28.npz`` beside ``mnist_28.npz``."""
    rng = np.random.default_rng(SEED + 8)
    x = (rng.uniform(size=(500, 28, 28)) ** 2 * 255).astype(np.uint8)
    np.savez(data_dir / "fashion_28.npz", x=x, y=np.arange(500) % 10)


_SAMPLED = re.compile(
    r"noise sweep (\S+): sampled (\d+) intensities x (\d+) images x (\d+) "
    r"iterations on (\S+) in ([0-9.]+) s \(([0-9.]+) images/s\)")
_SCORED = re.compile(r"noise sweep (\S+): scored \d+ intensities in "
                     r"([0-9.]+) s")


class _Forward(io.StringIO):
    """Keeps what a driver prints, and passes its progress lines on."""

    def write(self, text):
        for line in text.splitlines():
            if line.startswith(("noise sweep", "trained ")):
                print(line, file=sys.__stdout__, flush=True)
        return super().write(text)


def phase_sweep(tmp: pathlib.Path, prefix: str, models: list, extra: list,
                wants: dict) -> tuple[dict, dict, dict]:
    """fashion_noise --all-noise-types on the card with ``models`` and the
    flags ``extra``, saving under ``tmp/prefix``; returns the launch counts
    of the run, each model's launches while it sampled (by save name), and
    the sweep's rates and walls. ``wants`` maps a model's name to the
    counter and the least launches it must make while sampling."""
    argv = ["--all-noise-types", "--device", "cuda", "--epochs", "1",
            "--save-path", f"{tmp}/{prefix}", "--load-path", f"{tmp}/{prefix}",
            *extra]
    for margs in models:
        argv += ["--model", *margs]
    sampling = {}
    real = noise_common._sample_grids

    def counted(diff, *args, **kwargs):
        before = read_counts()
        out = real(diff, *args, **kwargs)
        acc = sampling.setdefault(diff.save_name(), {})
        for c, n in read_counts().items():
            acc[c] = acc.get(c, 0) + n - before[c]
        return out

    printed = _Forward()
    noise_common._sample_grids = counted
    try:
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed), contextlib.chdir(tmp):
            results = fashion_noise.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        noise_common._sample_grids = real
    text = printed.getvalue()
    print(f"sweep {' '.join(extra) or '(dm)'}: launches {counts}; while "
          f"sampling, by model {sampling}")
    names = [m[0] for m in models]
    if sorted(results) != sorted(names):
        fail(f"fashion_noise scored {sorted(results)}, not {names}")
    for name, per_type in results.items():
        if sorted(per_type) != list(SWEEP_TYPES):
            fail(f"{name}: noise types {sorted(per_type)}")
        for scores in per_type.values():
            for metric, values in scores.items():
                if len(values) != 5 or not np.isfinite(values).all():
                    fail(f"{name} {metric}: {values} are not 5 finite scores")
    for margs in models:
        key = common.build_model(margs, device="cpu").save_name()
        counter, want = wants[margs[0]]
        got = sampling.get(key, {}).get(counter, 0)
        if got < want:
            fail(f"{margs[0]}: {got} {counter} launches while sampling < "
                 f"{want}: the noisy sweep did not run the kernel")
    sampled = _SAMPLED.findall(text)
    if len(sampled) != len(names) * len(SWEEP_TYPES) or not all(
            m[4].startswith("cuda") for m in sampled):
        fail(f"the sweep printed {len(sampled)} sampling lines on "
             f"{sorted(set(m[4] for m in sampled))}")
    rates = {}
    for name, *_, rate in sampled:
        rates.setdefault(name, []).append(float(rate))
    walls = {"total": wall,
             "sampling": sum(float(m[5]) for m in sampled),
             "scoring": sum(float(w) for _, w in _SCORED.findall(text))}
    return counts, sampling, {"rates": rates, "walls": walls}


def _grid_stack(grid, iters: int, n: int, side: int) -> torch.Tensor:
    """A sampler grid ((iters+1)*side, n*side) as its (iters+1, n, 1, side,
    side) stack."""
    return torch.as_tensor(grid).reshape(iters + 1, side, n, side).permute(
        0, 2, 1, 3)[:, :, None]


def _replay(rec, iters: int, first: int, last: int):
    """The card's recorded draws and branch picks of iterations first..last-1
    (of ``iters`` recorded) for a replay on the CPU; None without a
    record."""
    if rec is None:
        return None
    nd, npk = len(rec.draws) // iters, len(rec.picks) // iters
    return ReplayDraws([d.cpu() for d in rec.draws[first * nd:last * nd]],
                       [p.cpu() for p in rec.picks[first * npk:last * npk]]
                       if npk else None)


def _card_traj_rerun(margs, ckpt, code: int, first_x, args):
    """The first 3 iterations of a trajectory sweep's sampler on the card,
    from its checkpoint, with the driver's generator, recording the draws
    and picks; returns the record and the (4, n, 1, 28, 28) stack."""
    net = common.build_model(margs, device="cuda")
    load_jax_variables(net, load_checkpoint(ckpt)["model_state_dict"])
    noisy = common.with_noise(net, code, SWEEP_CHECK,
                              noise_trajectories=N_TRAJ)
    rec = RecordedDraws(noise_common.traj_generator(args, "cuda"))
    with torch.no_grad():
        stack = Diffusion(noisy, shape=(28, 28)).sample_stack_fn(
            first_x.to("cuda"), 3, traj_rng=rec)
    return rec, stack.cpu()


def phase_sweep_parity(tmp: pathlib.Path, prefix: str, models: list,
                       n_traj: int = 0) -> None:
    """At intensity SWEEP_CHECK of each channel, the first 3 iterations of
    each swept model on the CPU plain path, from the sweep's trained
    checkpoint and start images, against the card's cached grid. With
    ``n_traj`` (the trajectory backend) the card reruns those iterations
    with the driver's generator, recording its draws and picks, which the
    CPU then replays."""
    args = fashion_noise.parse_args([])
    first_x = common.make_first_x(args)
    backend = "traj" if n_traj else "dm"
    for margs in models:
        net = common.build_model(margs, device="cpu")
        name = net.save_name()
        ckpt = tmp / f"{prefix}0/noise_0/{name}_0.pt"
        load_jax_variables(net, load_checkpoint(ckpt)["model_state_dict"])
        stepwise = margs[0] == "QIDDM_PL_noise1"
        for code in SWEEP_TYPES:
            noisy = common.with_noise(net, code, SWEEP_CHECK,
                                      noise_trajectories=n_traj)
            diff = Diffusion(noisy, shape=(28, 28))
            with contextlib.redirect_stdout(io.StringIO()):
                grid = common.load_outp(diff, tmp / f"{prefix}0/noise_{code}",
                                        SWEEP_CHECK, backend)
            if grid is None:
                fail(f"no {backend} cached grid of {name} at "
                     f"add_noise={code}")
            card = _grid_stack(grid, SWEEP_ITERS, len(first_x), 28)
            rec = None
            if n_traj:
                rec, rerun = _card_traj_rerun(margs, ckpt, code, first_x,
                                              args)
                again = (rerun - card[:4]).abs().max().item()
                print(f"sweep traj {margs[0]} add_noise={code}: the card's "
                      f"rerun with the driver's generator against its cached "
                      f"grid max|diff| {again:.3e}")
                if not again <= SAMPLE_TOL:
                    fail(f"{margs[0]} add_noise={code}: rerunning the "
                         f"trajectory sampler on the card does not give the "
                         f"driver's grid: {again:.3e}")
            with torch.no_grad():
                ref = diff.sample_stack_fn(first_x, 3,
                                           traj_rng=_replay(rec, 3, 0, 3))
                drift = (ref[1:] - card[1:4]).abs().max().item()
                if stepwise:
                    err = max((noisy(card[t], traj_rng=_replay(rec, 3, t,
                                                               t + 1))
                               - card[t + 1]).abs().max().item()
                              for t in range(3))
                else:
                    err = drift
            print(f"sweep {backend} {margs[0]} add_noise={code} at "
                  f"{SWEEP_CHECK}: 3 iterations against the CPU plain path "
                  f"max|diff| {err:.3e}" + (f" step by step (free-running "
                                            f"{drift:.3e}, not held)"
                                            if stepwise else ""))
            if not err <= SAMPLE_TOL:
                fail(f"{margs[0]} add_noise={code}: the card's noisy "
                     f"iterations differ from the CPU plain path: "
                     f"{err:.3e} > {SAMPLE_TOL}")


def phase_train(tmp: pathlib.Path, n_train: int, models: list,
                per_step: dict, default: bool,
                prefix: str = "", epochs: int = EPOCHS,
                batch: int = 1) -> tuple[dict, dict]:
    """mnist_exm on ``models`` (its default model list with ``default``,
    else given with --model) for ``epochs`` epochs at ``batch`` images a
    step, saving under ``tmp``/``prefix``; returns the launch counts of the
    training run and each model's training images/s in its last epoch.
    ``per_step`` is the least number of launches of each counter per
    training step."""
    argv = ["--epochs", str(epochs), "--checkpoint-every", "1", "--device",
            "cuda", "--save-path", f"{tmp}/{prefix}", "--load-path",
            f"{tmp}/{prefix}", "--batch_size", str(batch)]
    if not default:
        for margs in models:
            argv += ["--model", *margs]
    printed = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(printed), contextlib.chdir(tmp):
        results = mnist_exm.main(argv)
    counts = read_counts()
    print(printed.getvalue().strip())
    steps = epochs * -(-n_train // batch)
    print(f"train: {steps} steps per model, launches {counts}")
    names = [margs[0] for margs in models]
    if sorted(results) != sorted(names):
        fail(f"mnist_exm trained {sorted(results)}, not {names}")
    for name in names:
        losses = results[name]["loss"][0]
        print(f"train: {name} epoch losses {losses}")
        if len(losses) != epochs or not all(math.isfinite(v) for v in losses):
            fail(f"{name} epoch losses {losses} are not {epochs} finite "
                 f"values")
    for counter, per in per_step.items():
        if counts[counter] < per * steps:
            fail(f"{counts}: fewer than {per * steps} {counter} launches in "
                 f"{steps} steps: {names} did not train through the kernels")
    for margs in models:
        name = common.build_model(margs, device="cpu").save_name()
        ckpt = tmp / f"{prefix}{LABEL}/noise_0/{name}_{LABEL}.pt"
        if not ckpt.exists():
            fail(f"no checkpoint at {ckpt}")
        with contextlib.redirect_stdout(io.StringIO()):
            imgs = sample_cli.main(["--ckpt", str(ckpt), "--model", *margs,
                                    "--n", "4", "--iters", "3", "--device",
                                    "cuda", "--format", "npz", "--out",
                                    str(tmp / "served")])
        if imgs.shape != (4, 1, 28, 28) or not np.isfinite(imgs).all():
            fail(f"the trained {margs[0]} checkpoint did not serve 4 finite "
                 f"images")
    walls = re.findall(r"trained 1 epochs in ([0-9.]+)s", printed.getvalue())
    if len(walls) != len(models) * epochs:
        fail(f"mnist_exm printed {len(walls)} epoch times, not "
             f"{len(models) * epochs}")
    # the models train in turn, each for ``epochs`` epochs
    rates = {name: n_train / float(walls[(i + 1) * epochs - 1])
             for i, name in enumerate(names)}
    return counts, rates


def _grads(net) -> dict:
    """Each parameter's gradient on the CPU; a re-uploading model's qweights
    (N, L, k, wires, 3) split into its N blocks, each held on its own: the
    first block's gradient reaches it only through the later blocks' encode
    gradients (the chain kernels' dpr, dpi or dcs)."""
    out = {}
    for n, p in net.named_parameters():
        g = p.grad.detach().cpu().clone()
        if n.endswith("qweights") and g.ndim == 5:
            out.update({f"{n}[{b}]": g[b] for b in range(len(g))})
        else:
            out[n] = g
    return out


def _grad_err(got: dict, want: dict) -> float:
    """Max over parameters of |got - want|, relative to the parameter's
    own max norm, or to the model's largest gradient norm where the
    parameter's is below GRAD_FLOOR of it. QNN's linear_down gradient is
    zero up to rounding on both devices (its circuit RZ-encodes |0...0>,
    so the input is a global phase): relative to its own ~1e-9 norm the
    rounding would read as a disagreement."""
    return max(_grad_errs(got, want).values())


def _grad_errs(got: dict, want: dict) -> dict:
    """:func:`_grad_err`'s terms, one a parameter."""
    top = max(g.abs().max().item() for g in want.values())
    errs = {}
    for n, w in want.items():
        scale = w.abs().max().item()
        errs[n] = ((got[n] - w).abs().max().item()
                   / (scale if scale >= GRAD_FLOOR * top else top))
    return errs


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """``x`` moved by one float32 ulp, up or down at random (seeded): the
    size of the rounding that two float32 implementations differ by."""
    gen = torch.Generator().manual_seed(SEED + 7)
    sign = torch.where(torch.rand(x.shape, generator=gen) < 0.5, -1.0, 1.0)
    return x * (1.0 + 2.0**-23 * sign.to(x.device))


def _grads64(net, x: torch.Tensor, state: torch.Tensor,
             device: str = "cpu") -> dict:
    """:func:`_grads` of ``net``'s training loss in float64 on ``device``
    (the CPU plain path by default), on the batch ``x`` and the noise image
    that a generator at ``state`` draws (drawn in float32 on the CPU, as the
    float32 steps draw it)."""
    net64 = copy.deepcopy(net).to(device, torch.float64)

    def noise_f(gen, data, tau, decay_mod):
        draw = 0.5 + 0.2 * torch.randn(data.shape, generator=gen)
        return add_normal_noise_multiple(
            gen, data, tau, decay_mod, noise=draw.to(data.device,
                                                     torch.float64))

    config.enable_x64(True)
    try:
        net64.zero_grad()
        loss, _ = Diffusion(net64, noise_f=noise_f).train().loss_fn(
            x.to(device, torch.float64), TAU,
            generator=torch.Generator().set_state(state))
        loss.backward()
    finally:
        config.enable_x64(False)
    return _grads(net64)


def phase_train_parity(tmp: pathlib.Path, margs: list, images: int = 1,
                       lr: float | None = None, held_grads: bool = True,
                       exact: bool = False, seed: int = SEED,
                       x: torch.Tensor | None = None) -> tuple:
    """Three Adam steps of ``margs`` on the card, ``images`` images per
    step, from weights seeded with ``seed`` and seeded noise, at ``lr``
    (the driver's rate for the model if None), on the batches ``x`` (3,
    images, pixels), by default LABEL's images of mnist_28.npz. Before each step the CPU plain path takes the
    card's current weights and buffers and evaluates the same batch with
    the same noise; the loss, every gradient and every buffer after the
    step (a BatchNorm's running statistics) must agree. With ``exact`` the
    gradients are held against the CPU plain path's float64 step on the
    same weights, batch and noise (``_grads64``) instead, and the CPU's
    own float32 distance from it, their float32 floor, is printed beside.
    With ``held_grads`` False the gradients are printed beside their
    float32 floor, not held: a model whose gradients float32 cannot hold
    to TRAIN_TOL (phase_zoo, and the U-Nets: phase_unet). Without
    ``exact`` that floor is the CPU's own gradients moved by one ulp of
    the batch (``_ulp``); with it, the run fails if the floor is within
    TRAIN_TOL, where float32 could hold them, and the card's own float64
    step is held against the CPU's within GRAD64_TOL. Returns the card's
    net and the launch counts of its 3 steps.

    Two independent trajectories are not compared: Adam's first steps
    move each weight by about lr * sign(g), so a gradient entry within
    float noise of zero takes a different step on each device. The PCA
    model takes 10 distinct images a step, scaled by 0.7^j: one image's
    noise chain spans fewer directions than the 8 components, and a float32
    fit keeps rounding noise for the rest; independent random images have
    nearly equal singular values, so which ones the 8 components keep would
    be left to rounding on either device (ROADMAP Queue 3)."""
    if x is None:
        z = np.load(tmp / "data" / "mnist_28.npz")
        x = torch.as_tensor(z["x"][z["y"] == LABEL][:3 * images] / 255.0,
                            dtype=torch.float32).reshape(3, images, -1)
        x = x * (0.7 ** torch.arange(images, dtype=torch.float32))[:, None]
    nets = {d: common.build_model(margs, seed=seed, device=d)
            for d in ("cuda", "cpu")}
    diffs = {d: Diffusion(net, shape=net.img_shape).train()
             for d, net in nets.items()}
    gens = {d: torch.Generator().manual_seed(SEED) for d in nets}
    if lr is None:
        lr = common.DEFAULT_LRS.get(margs[0], common.FALLBACK_LR)
    step = diffs["cuda"].make_train_step(
        torch.optim.Adam(diffs["cuda"].parameters(), lr=lr), TAU)
    loss_err = grad_err = buf_err = floor = err32 = err64 = 0.0
    grad_worst = ""
    reset_counts()
    for i in range(3):
        if exact:
            state = gens["cpu"].get_state()
            grads64 = _grads64(nets["cuda"], x[i], state)
            if not held_grads:
                err64 = max(err64, _grad_err(
                    _grads64(nets["cuda"], x[i], state, "cuda"), grads64))
        elif not held_grads:
            nets["cpu"].load_state_dict(nets["cuda"].state_dict())
            nets["cpu"].zero_grad()
            same_noise = torch.Generator().set_state(gens["cpu"].get_state())
            moved, _ = diffs["cpu"].loss_fn(_ulp(x[i]), TAU,
                                            generator=same_noise)
            moved.backward()
            moved_grads = _grads(nets["cpu"])
        nets["cpu"].load_state_dict(nets["cuda"].state_dict())
        nets["cpu"].zero_grad()
        want, _ = diffs["cpu"].loss_fn(x[i], TAU, generator=gens["cpu"])
        want.backward()
        if exact:
            floor = max(floor, _grad_err(_grads(nets["cpu"]), grads64))
        elif not held_grads:
            floor = max(floor, _grad_err(moved_grads, _grads(nets["cpu"])))
        got = step(x[i].to("cuda"), gens["cuda"]).item()
        loss_err = max(loss_err, abs(got - want.item()) / abs(want.item()))
        if exact:
            err32 = max(err32, _grad_err(_grads(nets["cuda"]),
                                         _grads(nets["cpu"])))
        errs = _grad_errs(_grads(nets["cuda"]),
                          grads64 if exact else _grads(nets["cpu"]))
        worst = max(errs, key=errs.get)
        if errs[worst] >= grad_err:
            grad_err, grad_worst = errs[worst], worst
        cpu_bufs = dict(nets["cpu"].named_buffers())
        for name, b in nets["cuda"].named_buffers():
            buf_err = max(buf_err, _rel(b.cpu(), cpu_bufs[name]))
        print(f"train {margs[0]}: step {i + 1} loss on cuda {got:.8f}, on "
              f"the CPU plain path {want.item():.8f}")
    counts = read_counts()
    bufs = [n for n, _ in nets["cuda"].named_buffers()]
    if exact:
        against = (f"against the CPU plain path's float64 step "
                   f"{grad_err:.3e} ({grad_worst}), against its float32 "
                   f"step {err32:.3e}; the float32 floor, the CPU's float32 "
                   f"step against its float64 step, is {floor:.3e}") + (
            "" if held_grads else f"; the card's float64 step against the "
                                  f"CPU's {err64:.3e} (held within "
                                  f"{GRAD64_TOL})")
    else:
        against = f"{grad_err:.3e} ({grad_worst})" + (
            "" if held_grads else f"; their float32 floor, the CPU's own "
                                  f"gradients at one ulp of the batch, is "
                                  f"{floor:.3e}")
    print(f"train {margs[0]}: 3 steps of {images} image(s), cuda against the "
          f"CPU plain path at the same weights: losses max relative "
          f"{loss_err:.3e}; gradients max relative (max norm, per parameter "
          f"and per qweights block; floored at {GRAD_FLOOR} of the largest) "
          f"{against}" + ("" if held_grads else " (gradients not held)")
          + (f"; buffers after each step ({', '.join(bufs)}) max|diff| / "
             f"max(1, max|cpu|) {buf_err:.3e}" if bufs else ""))
    if not (loss_err <= TRAIN_TOL and buf_err <= TRAIN_TOL
            and (grad_err <= TRAIN_TOL or not held_grads)):
        fail(f"training {margs[0]} on cuda differs from the CPU plain path: "
             f"losses {loss_err:.3e}, gradients {grad_err:.3e}, buffers "
             f"{buf_err:.3e} > {TRAIN_TOL}")
    if not err64 <= GRAD64_TOL:
        fail(f"{margs[0]}'s float64 gradients on cuda differ from the CPU "
             f"plain path's: {err64:.3e} > {GRAD64_TOL}")
    if exact and not held_grads and floor <= TRAIN_TOL:
        fail(f"{margs[0]}'s gradients are not held, but float32 holds them: "
             f"the CPU's float32 step lies {floor:.3e} <= {TRAIN_TOL} from "
             f"its float64 step")
    return nets["cuda"], counts


def _host_ms(fn, runs: int = 20) -> float:
    """Median host-clock ms of ``fn`` followed by a synchronise."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, -math.inf
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def _train_step(tmp: pathlib.Path, margs: list, images: int = 1,
                lr: float = common.FALLBACK_LR):
    """A seeded model's training step (tau 10, Adam; batch 1 by default,
    mnist_exm's) on the first ``images`` images of LABEL, and the step's
    arguments."""
    z = np.load(tmp / "data" / "mnist_28.npz")
    x = torch.as_tensor(z["x"][z["y"] == LABEL][:images] / 255.0,
                        dtype=torch.float32,
                        device="cuda").reshape(images, -1)
    net = common.build_model(margs, seed=SEED, device="cuda")
    diff = Diffusion(net).train()
    step = diff.make_train_step(
        torch.optim.Adam(diff.parameters(), lr=lr), TAU)
    return step, x, torch.Generator().manual_seed(SEED)


def _walk_step_check(name: str, dev: list, counts: dict, fwd: str,
                     counter: str, sums: str, steps: int,
                     per_step: int = 2) -> None:
    """Fails unless the profiled steps ran ``per_step`` forwards (counter
    ``fwd``) and backward walks a step and each walk summed dg in its own
    launch: no second launch (counter ``sums``, and no dg_batch_sum_kernel
    record)."""
    second = sum(1 for e in dev if "dg_batch_sum" in e.name)
    want = per_step * steps
    if (counts[fwd] != want or counts[counter] != want or counts[sums]
            or second):
        fail(f"{name}: {counts[fwd]} forwards and {counts[counter]} "
             f"backward walks in {steps} steps (want {want} each), "
             f"{counts[sums]} batch sums counted and {second} profiled in a "
             f"second launch (want 0)")


def phase_profile_ll(tmp: pathlib.Path, smi: str) -> None:
    """Where a QIDDM_LL_noise(784, 6, 14, 2) training step's time goes: 10
    steady steps under torch.profiler from counts of 0 give the device
    events, the device busy time and idle share per step, and the gate
    chain's kernels' time a step, #1's and #2's each on its own; each
    backward is one launch (dg summed over the batch in it)."""
    step, x, gen = _train_step(tmp, MODEL)
    step_ms = _host_ms(lambda: step(x, gen))
    steps = 10
    dev, busy, wall_us, counts = _device_profile(
        lambda: [step(x, gen) for _ in range(steps)])
    _walk_step_check("QIDDM_LL_noise training", dev, counts, "gate",
                     "gate_bwd", "gate_bwd_sums", steps)
    chain_us = sum(e.time_range.elapsed_us() for e in dev
                   if "gate_chain" in e.name)
    bwd_us = sum(e.time_range.elapsed_us() for e in dev
                 if "gate_chain_bwd" in e.name)
    fwd_us = sum(e.time_range.elapsed_us() for e in dev
                 if "gate_chain_fwd" in e.name)
    print(f"profile {' '.join(MODEL)} training ({smi}), {steps} steps: "
          f"{len(dev) / steps:.1f} device events per step, device busy "
          f"{busy / steps / 1e3:.4f} ms per step, idle share "
          f"{1 - busy / wall_us:.3f} of {wall_us / steps / 1e3:.3f} ms per "
          f"profiled step; gate chain kernels {chain_us / steps:.1f} us per "
          f"step ({chain_us / busy:.3f} of busy), #1 {fwd_us / steps:.1f} us "
          f"per step ({fwd_us / busy:.3f} of busy, "
          f"{counts['gate'] // steps} launches a step), #2 "
          f"{bwd_us / steps:.1f} us per step ({bwd_us / busy:.3f} of busy, "
          f"{counts['gate_bwd'] // steps} launches a step); step without "
          f"the profiler {step_ms:.3f} ms")


def phase_profile_qnn(tmp: pathlib.Path, smi: str) -> None:
    """Where a QNN_noise(784, 8, 14) training step's time goes (batch 1, tau
    10, the driver's default): 10 steady steps under torch.profiler from
    counts of 0 give the device events, the device busy time and idle
    share per step, and the SEL chain's kernels' time a step, #5's and
    #6's each on its own; one forward and one backward launch a step, the
    backward's dg summed over the batch in it (no second launch)."""
    step, x, gen = _train_step(tmp, QNN_MODEL)
    step_ms = _host_ms(lambda: step(x, gen))
    steps = 10
    dev, busy, wall_us, counts = _device_profile(
        lambda: [step(x, gen) for _ in range(steps)])
    _walk_step_check("QNN_noise training", dev, counts, "sel", "sel_bwd",
                     "sel_bwd_sums", steps, per_step=1)
    fwd_us = sum(e.time_range.elapsed_us() for e in dev
                 if "sel_chain_fwd" in e.name)
    bwd_us = sum(e.time_range.elapsed_us() for e in dev
                 if "sel_chain_bwd" in e.name)
    chain_us = fwd_us + bwd_us
    print(f"profile {' '.join(QNN_MODEL)} training ({smi}), {steps} steps: "
          f"{len(dev) / steps:.1f} device events per step, device busy "
          f"{busy / steps / 1e3:.4f} ms per step, idle share "
          f"{1 - busy / wall_us:.3f} of {wall_us / steps / 1e3:.3f} ms per "
          f"profiled step; SEL chain kernels {chain_us / steps:.1f} us per "
          f"step ({chain_us / busy:.3f} of busy), #5 {fwd_us / steps:.1f} us "
          f"per step ({fwd_us / busy:.3f} of busy, "
          f"{counts['sel'] // steps} launch a step), #6 "
          f"{bwd_us / steps:.1f} us per step ({bwd_us / busy:.3f} of busy, "
          f"{counts['sel_bwd'] // steps} launch a step); step without "
          f"the profiler {step_ms:.3f} ms")


def phase_profile_pl(tmp: pathlib.Path, smi: str) -> None:
    """Where a QIDDM_PL_noise1 training step's time goes (batch 1, tau 10,
    the driver's default): 10 steady Adam steps under torch.profiler give
    the device events per step, the device busy time (the union of kernel
    and copy intervals, user annotations dropped), the idle share of the
    profiled wall and the RY kernels' device time, #3's and #4's each on
    its own (one launch a backward, dg summed in it); the step, the PCA fit
    and ``eigh`` alone are also timed on the host clock without the
    profiler, each ending in a synchronise."""
    from torch.profiler import ProfilerActivity, profile

    step, x, gen = _train_step(tmp, PL_MODEL)
    step_ms = _host_ms(lambda: step(x, gen))
    steps = 10
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(x, gen)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in dev)
    counts = read_counts()
    _walk_step_check("QIDDM_PL_noise1 training", dev, counts, "ry",
                     "ry_bwd", "ry_bwd_sums", steps)
    ry_us = sum(e.time_range.elapsed_us() for e in dev
                if "ry_chain" in e.name)
    ry_bwd_us = sum(e.time_range.elapsed_us() for e in dev
                    if "ry_chain_bwd" in e.name)
    ry_fwd_us = sum(e.time_range.elapsed_us() for e in dev
                    if "ry_chain_fwd" in e.name)
    top = prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12)
    rows = torch.rand((TAU, 784), generator=gen).to("cuda")
    pca_ms = _host_ms(lambda: pca_fit_transform(rows, int(PL_MODEL[2])))
    gram = rows @ rows.T
    eigh_ms = _host_ms(lambda: torch.linalg.eigh(gram))
    print(f"profile QIDDM_PL_noise1 training ({smi}), {steps} steps: "
          f"{len(dev) / steps:.1f} device events per step, device busy "
          f"{busy / steps / 1e3:.4f} ms per step, idle share "
          f"{1 - busy / wall_us:.3f} of {wall_us / steps / 1e3:.3f} ms per "
          f"profiled step; RY kernels {ry_us / steps:.1f} us per step "
          f"({ry_us / busy:.3f} of busy), #3 {ry_fwd_us / steps:.1f} us per "
          f"step ({ry_fwd_us / busy:.3f} of busy, "
          f"{counts['ry'] // steps} launches a step), #4 "
          f"{ry_bwd_us / steps:.1f} us per step ({ry_bwd_us / busy:.3f} of "
          f"busy)")
    print(f"profile QIDDM_PL_noise1 ({smi}): step without the profiler "
          f"{step_ms:.3f} ms; PCA fit and projection of {TAU} rows "
          f"{pca_ms:.3f} ms, eigh of their {TAU}x{TAU} Gram matrix alone "
          f"{eigh_ms:.3f} ms (host clock, median of 20, each ending in a "
          f"synchronise)")
    print(top)


def _only_gate(counts: dict, fwd: int, bwd: int, what: str) -> None:
    """Fails unless ``counts`` hold exactly ``fwd`` #1 and ``bwd`` #2
    launches and no other kernel's: the re-uploading models run the gate
    chain and nothing else. dg's batch sum (a helper launch after #2 where
    the batch outgrows a cluster: 80 rows at 8 and 10 wires) may run."""
    others = {c: n for c, n in counts.items()
              if n and c not in ("gate", "gate_bwd", "gate_bwd_sums")}
    if counts["gate"] != fwd or counts["gate_bwd"] != bwd or others:
        fail(f"{what}: {counts['gate']} #1 and {counts['gate_bwd']} #2 "
             f"launches (want {fwd} and {bwd}), other counters {others}")


def phase_qiddm_a(tmp: pathlib.Path, n_train: int, smi: str) -> tuple:
    """QIDDM-A (differN_noise 28 9 2) through mnist_exm on cuda at the JAX
    bench's configuration (QIDDM_A_FLAGS, 2 segments of 15 epochs): 30
    finite epoch losses, exactly 2 #1 and 2 #2 launches a step (N = 2
    blocks) and 2 #1 an iteration of the driver's sampling, a checkpoint
    the sampling CLI serves (N images x ITERS iterations x BATCHES, each
    iteration of the last batch held against the CPU step by step), 3
    training steps held against the CPU, and a steady step profiled (10
    steps from counts of 0). Returns the launch counts of the driver's and
    the CLI's runs, and the training and sampling images/s."""
    name = common.build_model(QIDDM_A, device="cpu").save_name()
    argv = ["--model", *QIDDM_A, *QIDDM_A_FLAGS, "--checkpoint-every",
            str(QIDDM_A_SEGMENT), "--device", "cuda", "--save-path",
            f"{tmp}/qa_", "--load-path", f"{tmp}/qa_"]
    printed = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(printed), contextlib.chdir(tmp):
        results = mnist_exm.main(argv)
    counts = read_counts()
    print(printed.getvalue().strip())
    losses = results[QIDDM_A[0]]["loss"][0]
    print(f"QIDDM-A {' '.join(QIDDM_A)}: epoch losses {losses}")
    if (len(losses) != QIDDM_A_EPOCHS
            or not all(math.isfinite(v) for v in losses)):
        fail(f"QIDDM-A epoch losses {losses} are not {QIDDM_A_EPOCHS} "
             f"finite values")
    steps = QIDDM_A_EPOCHS * -(-n_train // QIDDM_A_BATCH)
    _only_gate(counts, 2 * steps + 2 * TAU_TEST, 2 * steps,
               f"QIDDM-A: {steps} training steps and {TAU_TEST} sampling "
               f"iterations")
    walls = re.findall(rf"trained {QIDDM_A_SEGMENT} epochs in ([0-9.]+)s",
                       printed.getvalue())
    if len(walls) != QIDDM_A_EPOCHS // QIDDM_A_SEGMENT:
        fail(f"mnist_exm printed the walls {walls}")
    train_rate = n_train * QIDDM_A_SEGMENT / float(walls[-1])
    ckpt = tmp / f"qa_{LABEL}/noise_0/{name}_{LABEL}.pt"
    if not ckpt.exists():
        fail(f"no checkpoint at {ckpt}")
    with torch.no_grad():
        sampled, sample_rate = phase_sample(tmp, QIDDM_A, 28, "gate", 2,
                                            ITERS, ckpt=ckpt)
    _only_gate(sampled, 2 * ITERS * BATCHES, 0, "QIDDM-A sampling")
    _, parity = phase_train_parity(tmp, QIDDM_A, QIDDM_A_BATCH, QIDDM_A_LR)
    _only_gate(parity, 6, 6, "QIDDM-A's 3 held steps")
    step, x, gen = _train_step(tmp, QIDDM_A, QIDDM_A_BATCH, QIDDM_A_LR)
    step_ms = _host_ms(lambda: step(x, gen))
    n = 10
    dev, busy, wall_us, prof_counts = _device_profile(
        lambda: [step(x, gen) for _ in range(n)])
    _only_gate(prof_counts, 2 * n, 2 * n, f"QIDDM-A's {n} profiled steps")
    # 80 rows outgrow one cluster of #2: dg is summed by a second launch
    plan = gate_kernel.chain_bwd_plan(10, QIDDM_A_BATCH * TAU)
    sums = sum(1 for e in dev if "dg_batch_sum" in e.name)
    if prof_counts["gate_bwd_sums"] != (0 if plan.in_launch else 2 * n):
        fail(f"QIDDM-A: {prof_counts['gate_bwd_sums']} dg batch sums in "
             f"{n} steps, against the plan {plan}")
    fwd_us = sum(e.time_range.elapsed_us() for e in dev
                 if "gate_chain_fwd" in e.name)
    bwd_us = sum(e.time_range.elapsed_us() for e in dev
                 if "gate_chain_bwd" in e.name)
    print(f"profile QIDDM-A {' '.join(QIDDM_A)} training ({smi}), {n} steps "
          f"of batch {QIDDM_A_BATCH} x tau {TAU} (80 rows): "
          f"{len(dev) / n:.1f} device events per step, device busy "
          f"{busy / n / 1e3:.4f} ms per step, idle share "
          f"{1 - busy / wall_us:.3f} of {wall_us / n / 1e3:.3f} ms per "
          f"profiled step; #1 {fwd_us / n:.1f} us per step "
          f"({fwd_us / busy:.3f} of busy, {prof_counts['gate'] // n} "
          f"launches a step), #2 {bwd_us / n:.1f} us per step "
          f"({bwd_us / busy:.3f} of busy, {prof_counts['gate_bwd'] // n} "
          f"launches a step), dg's batch sum {sums / n:.1f} profiled "
          f"launches a step ({_plan_line(10, QIDDM_A_BATCH * TAU)}); step "
          f"without the profiler {step_ms:.3f} ms")
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile QIDDM-A: the device time a step by kernel, largest "
          f"first: " + "; ".join(f"{name[:60]} {us / n:.1f} us "
                                 f"({us / busy:.3f})" for name, us in top))
    print(f"QIDDM-A {' '.join(QIDDM_A)}: training {train_rate:.1f} images/s "
          f"in epochs 16-30 (batch {QIDDM_A_BATCH}, tau {TAU}, "
          f"{n_train} images an epoch; {smi}); sampling {sample_rate:.1f} "
          f"images/s ({N} images x {ITERS} iterations per batch; {smi})")
    return ({c: counts[c] + sampled[c] for c in counts}, train_rate,
            sample_rate)


@contextlib.contextmanager
def _shared_pca(state):
    """Inside, every per-batch PCA refit of a model (``nn/core.py``'s
    ``pca_fit_transform``) takes ``state``, a fit made elsewhere, and
    projects on it."""
    orig = nn_core.pca_fit_transform
    nn_core.pca_fit_transform = lambda x, n: (state,
                                              pca_transform(state, x))
    try:
        yield
    finally:
        nn_core.pca_fit_transform = orig


def phase_zoo(tmp: pathlib.Path) -> dict:
    """The 16 classes of ZOO built on cuda at full width: for each, 3
    training steps of ZOO_IMAGES images held against the CPU (loss,
    gradients and BatchNorm statistics: phase_train_parity), then a batch
    of N sampled for ITERS iterations from the trained weights, each
    iteration held against the CPU from the card's batch; exactly 2 #1 and
    2 #2 launches a step and 2 #1 an iteration (N = 2 blocks), no other
    kernel. Returns the launch counts of the card's counted runs (not the
    refit classes' comparison steps below).

    Float32 cannot make three kinds of comparison at 1e-4 (ROADMAP Queue
    3; my chip runs of PR 21 on an NVIDIA H100 80GB HBM3, 700.00 W):
    - A class that refits a PCA on every batch: cuSOLVER's and LAPACK's
      float32 ``eigh`` of a 16-row batch differ where its spectrum is
      close, and the circuits amplify that to 5.8e-4 (differN_old_pca)
      and 2.4e-1 (QIDDM_PP_noise) by the 15th iteration. Each iteration
      is held with the card's fit of the batch given to the CPU
      (``_shared_pca``), against the card's step from the same contiguous
      batch; the images from the CPU's own fit are printed beside.
    - A class that post-processes after each block (clamp(784 p) between
      the blocks): its gradients switch at the clamp's edges and carry
      the probabilities' rounding times 784, twice. They are printed
      beside their float32 floor (the CPU's own at one ulp of the batch),
      not held; its losses are held.
    - Both at once (differN_new_pca, QIDDM_A_differN_basePL and _NEW):
      even with the shared fit, the kernels' ~1e-7 rounding of the
      probabilities reaches 2.4e-4-1.2e-3 in the images. Their sampled
      iterations are printed beside the same floor at one ulp of the
      batch, not held; the launch counts and finite images are held."""
    total = {}
    for margs in ZOO:
        module = common.build_model(margs, device="cpu").module
        refit = module.down == "pca" and not module.pca_lazy
        net, counts = phase_train_parity(
            tmp, margs, ZOO_IMAGES, held_grads=not module.post_each_block)
        _only_gate(counts, 6, 6, f"{margs[0]}'s 3 steps")
        side = net.img_shape[0]
        cpu_net = common.build_model(margs, seed=SEED, device="cpu")
        cpu_net.load_state_dict(net.state_dict())
        gen = torch.Generator().manual_seed(SEED)
        first_x = torch.rand((N, 1, side, side), generator=gen) * 0.75 + 0.5
        reset_counts()
        with torch.no_grad():
            stack = Diffusion(net, shape=(side, side)).sample_stack_fn(
                first_x.to("cuda"), ITERS).cpu()
        sampled = read_counts()
        _only_gate(sampled, 2 * ITERS, 0, f"{margs[0]}'s sampling")
        if not torch.isfinite(stack).all():
            fail(f"{margs[0]}: sampled images are not finite")
        cpu = Diffusion(cpu_net, shape=(side, side))
        card = Diffusion(net, shape=(side, side))
        held = not (refit and module.post_each_block)
        err = own = floor = 0.0
        with torch.no_grad():
            for t in range(ITERS):
                want = cpu.sample_stack_fn(stack[t], 1)[1]
                own = max(own, (want - stack[t + 1]).abs().max().item())
                got = stack[t + 1]
                if refit:
                    # the card's step and fit from the same (contiguous)
                    # batch, so the fit is the one its step used
                    x = stack[t].to("cuda")
                    got = card.sample_stack_fn(x, 1)[1].cpu()
                    fit = pca_fit(x.reshape(N, -1), module.hidden)
                    with _shared_pca(PCAState(fit.mean.cpu(),
                                              fit.components.cpu())):
                        want = cpu.sample_stack_fn(stack[t], 1)[1]
                        if not held:
                            moved = cpu.sample_stack_fn(_ulp(stack[t]), 1)
                            floor = max(floor, (moved[1] - want).abs()
                                        .max().item())
                err = max(err, (want - got).abs().max().item())
        print(f"zoo {' '.join(margs)}: sampled {N} images x {ITERS} "
              f"iterations from the trained weights, each iteration from "
              f"the card's batch against the CPU plain path"
              + (" given the card's PCA fit of the batch" if refit else "")
              + f": max|diff| {err:.3e}"
              + ("" if held else f" (not held: the float32 floor, the "
                 f"CPU's own images at one ulp of the batch with the same "
                 f"fit, is {floor:.3e})")
              + (f"; from the CPU's own fit {own:.3e}, not held" if refit
                 else "")
              + f"; launches: 3 steps {counts['gate']} #1, "
              f"{counts['gate_bwd']} #2; sampling {sampled['gate']} #1")
        if held and not err <= SAMPLE_TOL:
            fail(f"{margs[0]} cuda samples differ from the CPU plain path: "
                 f"{err:.3e} > {SAMPLE_TOL}")
        for c in counts:
            total[c] = total.get(c, 0) + counts[c] + sampled[c]
    return total


def _no_kernel(counts: dict, what: str) -> None:
    """Fails unless no kernel of the port launched: the U-Net runs plain
    torch ops (unfold, matmul, cuDNN convolutions, pooling, interpolation),
    as the JAX package runs it in XLA outside any Pallas kernel."""
    launched = {c: n for c, n in counts.items() if n}
    if launched:
        fail(f"{what}: port kernels launched on the U-Net's path: {launched}")


def phase_unet(tmp: pathlib.Path, n_train: int, margs: list, epochs: int,
               smi: str) -> tuple:
    """A U-Net through mnist_exm on cuda at the JAX bench's configuration
    (batch UNET_BATCH, tau 10, UNET_LR, ``epochs`` epochs, a checkpoint
    each epoch, so the last epoch's wall is steady): finite epoch losses,
    a checkpoint the sampling CLI serves (N images x ITERS iterations x
    BATCHES, each iteration of the last batch held against the CPU step by
    step), 3 training steps held against the CPU, no port kernel launched
    anywhere, and a steady step profiled (10 steps). Returns the training
    and sampling images/s.

    The classical U-Net's sampled iterations are held against the CPU's
    float32 step within SAMPLE_TOL. The quantum U-Net's are held against
    the CPU's float64 step within the larger of SAMPLE_TOL and FLOOR_FACTOR
    times their float32 floor (phase_sample's ``floor64``, with its TF32
    control), and the card's float64 steps against the CPU's within
    X64_TOL: a trained U-Net's BatchNorms divide by running variances far
    below 1, which scales float32 rounding up, and the trained quantum
    U-Net's floor reaches ~1e-4 (printed beside), where two float32
    implementations, each about that far from the float64 step, cannot be
    held to 1e-4 of each other.

    The 3 steps hold losses and BatchNorm statistics against the CPU's
    float32 step, and the card's float64 gradients against the CPU's
    float64 step within GRAD64_TOL (phase_train_parity's ``exact``). The
    float32 gradients are printed beside their floor, the CPU's float32
    step's distance from its float64 step, not held: each BatchNorm makes
    its input's gradient sum to zero over 6,272-62,720 positions a
    channel, and a weight's gradient is what is left of such sums, so it
    depends on the order of float32 sums. The CPU's float32 step lies
    ~1e-3 (classical) and ~3e-2 (quantum) from float64 here, and the
    card's float32 step up to 4e-3 and 7e-2 over 12 seeded weights
    (qiddm_tpu_torch/tools/unet_precision.py), so float32 cannot hold
    them to TRAIN_TOL (the run fails if the floor says it could)."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        fail(f"TF32 is on (cuBLAS {torch.backends.cuda.matmul.allow_tf32}, "
             f"cuDNN {torch.backends.cudnn.allow_tf32}): qiddm_tpu_torch's "
             f"config pins full float32")
    t_phase = time.perf_counter()
    label = " ".join(margs)
    name = common.build_model(margs, device="cpu").save_name()
    prefix = f"unet{margs[-1]}_"
    argv = ["--model", *margs, "--label", str(LABEL), "--batch_size",
            str(UNET_BATCH), "--tau", str(TAU), "--lr", str(UNET_LR),
            "--epochs", str(epochs), "--checkpoint-every", "1", "--device",
            "cuda", "--save-path", f"{tmp}/{prefix}", "--load-path",
            f"{tmp}/{prefix}"]
    printed = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(printed), contextlib.chdir(tmp):
        results = mnist_exm.main(argv)
    counts = read_counts()
    print(printed.getvalue().strip())
    _no_kernel(counts, f"{label}'s training and sampling in mnist_exm")
    losses = results[margs[0]]["loss"][0]
    print(f"U-Net {label}: epoch losses {losses}")
    if len(losses) != epochs or not all(math.isfinite(v) for v in losses):
        fail(f"U-Net {label} epoch losses {losses} are not {epochs} finite "
             f"values")
    walls = re.findall(r"trained 1 epochs in ([0-9.]+)s", printed.getvalue())
    if len(walls) != epochs:
        fail(f"mnist_exm printed the walls {walls}")
    train_rate = n_train / float(walls[-1])
    ckpt = tmp / f"{prefix}{LABEL}/noise_0/{name}_{LABEL}.pt"
    if not ckpt.exists():
        fail(f"no checkpoint at {ckpt}")
    classical = margs[-1] == "0"
    with torch.no_grad():
        sampled, sample_rate = phase_sample(tmp, margs, 28, "gate", 0, ITERS,
                                            ckpt=ckpt,
                                            floor64=not classical)
    _no_kernel(sampled, f"{label}'s sampling CLI")
    _, parity = phase_train_parity(tmp, margs, UNET_BATCH, UNET_LR,
                                   held_grads=False, exact=True)
    _no_kernel(parity, f"{label}'s 3 held steps")
    step, x, gen = _train_step(tmp, margs, UNET_BATCH, UNET_LR)
    step_ms = _host_ms(lambda: step(x, gen))
    torch.cuda.reset_peak_memory_stats()
    n = 10
    dev, busy, wall_us, prof_counts = _device_profile(
        lambda: [step(x, gen) for _ in range(n)])
    peak = torch.cuda.max_memory_allocated()
    _no_kernel(prof_counts, f"{label}'s {n} profiled steps")
    print(f"profile U-Net {label} training ({smi}), {n} steps of batch "
          f"{UNET_BATCH} x tau {TAU} (80 rows): {len(dev) / n:.1f} device "
          f"events per step, device busy {busy / n / 1e3:.4f} ms per step, "
          f"idle share {1 - busy / wall_us:.3f} of {wall_us / n / 1e3:.3f} "
          f"ms per profiled step; step without the profiler {step_ms:.3f} "
          f"ms; peak device memory {peak / 2**20:.1f} MiB")
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile U-Net {label}: the device time a step by op, largest "
          f"first: " + "; ".join(f"{op[:60]} {us / n:.1f} us "
                                 f"({us / busy:.3f})" for op, us in top))
    print(f"U-Net {label}: training {train_rate:.1f} images/s in epoch "
          f"{epochs} (batch {UNET_BATCH}, tau {TAU}, {n_train} images an "
          f"epoch; {smi}); sampling {sample_rate:.1f} images/s ({N} images "
          f"x {ITERS} iterations per batch; {smi}); phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    return train_rate, sample_rate


def phase_profile_noisy_pl(smi: str) -> None:
    """Where a noisy QIDDM_PL_noise1 denoise iteration's time goes, at the
    sweep's shape (10 start images, amplitude damping at SWEEP_CHECK,
    seeded weights): 5 steady iterations of the sampler under
    torch.profiler give the device events, the device busy time and the
    idle share per iteration and kernel #8's share of the busy time; the
    iteration is also timed on the host clock without the profiler."""
    net = common.build_model(SWEEP_MODELS[1], seed=SEED, device="cuda")
    diff = Diffusion(common.with_noise(net, 2, SWEEP_CHECK), shape=(28, 28))
    first_x = common.make_first_x(fashion_noise.parse_args([])).to("cuda")
    iters = 5
    diff.sample(first_x=first_x, n_iters=1)  # warm-up
    iter_ms = _host_ms(lambda: diff.sample(first_x=first_x,
                                           n_iters=iters)) / iters
    dev, busy, wall_us, counts = _device_profile(
        lambda: diff.sample(first_x=first_x, n_iters=iters))
    dm = [e.time_range.elapsed_us() for e in dev if "dm_chain" in e.name]
    if counts["dm"] < 2 * iters or not dm:
        fail(f"{counts['dm']} dm-chain launches ({len(dm)} profiled) in "
             f"{iters} profiled noisy QIDDM_PL_noise1 iterations, not "
             f"{2 * iters}")
    print(f"profile noisy QIDDM_PL_noise1 sampling ({smi}), {iters} "
          f"iterations of {len(first_x)} images, amplitude damping at "
          f"{SWEEP_CHECK}: {len(dev) / iters:.1f} device events per "
          f"iteration, device busy {busy / iters / 1e3:.4f} ms per "
          f"iteration, idle share {1 - busy / wall_us:.3f} of "
          f"{wall_us / iters / 1e3:.3f} ms per profiled iteration; kernel #8 "
          f"{counts['dm'] / iters:.1f} calls ({len(dm)} of {counts['dm']} "
          f"profiled), {sum(dm) / iters:.1f} us per "
          f"iteration ({sum(dm) / busy:.3f} of busy); iteration without the "
          f"profiler {iter_ms:.3f} ms (host clock, median of 20 runs of "
          f"{iters}, each ending in a synchronise)")


def phase_traj_sample(smi: str) -> tuple[dict, float, float, tuple]:
    """Path A: the JAX package's 12-wire trajectory noisy sampler on the
    card through ``Diffusion.sample``, its draws recorded; returns the
    launch counts of that run, the steady images/s, the worst max |diff|
    of the CPU plain path's replayed iterations, and the sampler with its
    start images."""
    net = common.build_model(TRAJ_MODEL, seed=SEED, device="cuda")
    noisy = common.with_noise(net, TRAJ_CODE, TRAJ_STRENGTH,
                              noise_trajectories=N_TRAJ)
    diff = Diffusion(noisy, prediction_goal="data", shape=(28, 28))
    gen = torch.Generator().manual_seed(SEED + 3)
    first_x = (torch.rand((TRAJ_IMAGES, 1, 28, 28), generator=gen) * 0.75
               + 0.5).to("cuda")
    rec = RecordedDraws(torch.Generator(device="cuda").manual_seed(SEED + 5))
    reset_counts()
    t0 = time.perf_counter()
    grid = diff.sample(first_x=first_x, n_iters=TRAJ_ITERS, traj_rng=rec)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counts()
    stack = _grid_stack(grid.cpu(), TRAJ_ITERS, TRAJ_IMAGES, 28)
    print(f"traj sample {TRAJ_MODEL}: {TRAJ_IMAGES} images x {TRAJ_ITERS} "
          f"iterations x {N_TRAJ} trajectories in {first_s:.3f} s (first "
          f"run); launches {counts}")
    if not torch.isfinite(stack).all():
        fail("the 12-wire trajectory samples are not finite")
    want = TRAJ_PER_ITER * TRAJ_ITERS
    for counter in ("amp", "sel_rows"):
        if counts[counter] < want:
            fail(f"12-wire trajectory sampling: {counts[counter]} {counter} "
                 f"launches < {want}: the path did not run the kernel")
    if counts["sel_rows"] != want or counts["sel"]:
        fail(f"12-wire trajectory sampling: {counts['sel_rows']} rows and "
             f"{counts['sel']} planes SEL launches, not {want} and 0")
    if len(rec.draws) != want or len(rec.picks) != want:
        fail(f"{len(rec.draws)} draws and {len(rec.picks)} picks recorded, "
             f"not {want}")
    walls = []
    for _ in range(3):
        g = torch.Generator(device="cuda").manual_seed(SEED + 5)
        t0 = time.perf_counter()
        diff.sample(first_x=first_x, n_iters=TRAJ_ITERS, only_last=True,
                    traj_rng=g)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    rate = TRAJ_IMAGES / float(np.median(walls))
    print(f"traj sample: steady {rate:.2f} images/s (10 images x "
          f"{TRAJ_ITERS} iterations, median of 3 walls "
          f"{', '.join(f'{w:.4f}' for w in walls)} s; {smi})")

    # the CPU plain path from the card's batches, with the card's draws
    cpu = common.build_model(TRAJ_MODEL, device="cpu")
    cpu.load_state_dict(net.state_dict())
    cpu = common.with_noise(cpu, TRAJ_CODE, TRAJ_STRENGTH,
                            noise_trajectories=N_TRAJ)

    def step_err(t: int) -> float:
        with torch.no_grad():
            out = cpu(stack[t], traj_rng=_replay(rec, TRAJ_ITERS, t, t + 1))
        return (out - stack[t + 1]).abs().max().item()

    t0 = time.perf_counter()
    err = step_err(0)
    first_cpu_s = time.perf_counter() - t0
    steps = 3 if first_cpu_s < CPU_REPLAY_S else 1
    for t in range(1, steps):
        err = max(err, step_err(t))
    print(f"traj sample: {steps} iteration(s) from the card's batch on the "
          f"CPU plain path with the card's draws and picks max|diff| "
          f"{err:.3e} (the first took the CPU {first_cpu_s:.1f} s)")
    if not err <= SAMPLE_TOL:
        fail(f"12-wire trajectory sampling on the card differs from the "
             f"CPU plain path: {err:.3e} > {SAMPLE_TOL}")
    return counts, rate, err, (diff, first_x)


def _device_profile(fn) -> tuple[list, float, float, dict]:
    """Runs ``fn`` under torch.profiler with the launch counters set to 0
    just before it; returns its device events (user annotations dropped),
    the device busy time (the union of their intervals), the profiled wall,
    both in us, and the launch counts of the run. The counters, not the
    profiler, show what launched: the profiler can lose a device record
    (it kept 59 of 60 #7 launches in one run on the card)."""
    from torch.profiler import ProfilerActivity, profile

    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    counts = read_counts()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in dev)
    return dev, busy, wall_us, counts


def phase_profile_traj(sampler, smi: str) -> None:
    """Where a path-A denoise iteration's time goes: 5 steady iterations
    under torch.profiler give the device events, the device busy time and
    the idle share per iteration, and the shares of kernels #7 and #5 in
    the busy time; the iteration is also timed on the host clock without
    the profiler."""
    diff, first_x = sampler
    iters = 5

    def run():
        diff.sample(first_x=first_x, n_iters=iters, only_last=True,
                    traj_rng=torch.Generator(device="cuda").manual_seed(7))

    iter_ms = _host_ms(run, runs=5) / iters
    dev, busy, wall_us, counts = _device_profile(run)
    amp = [e.time_range.elapsed_us() for e in dev if "amp_damp" in e.name]
    sel = [e.time_range.elapsed_us() for e in dev
           if "sel_rows_fwd" in e.name]
    want = TRAJ_PER_ITER * iters
    if (counts["amp"] < want or counts["sel_rows"] != want or counts["sel"]
            or not amp or not sel):
        fail(f"{counts['amp']} amp-damp, {counts['sel_rows']} SEL rows and "
             f"{counts['sel']} SEL planes launches ({len(amp)} and "
             f"{len(sel)} profiled) in {iters} profiled trajectory "
             f"iterations, not {want}, {want} and 0")
    print(f"profile 12-wire trajectory sampling ({smi}), {iters} iterations "
          f"of {TRAJ_IMAGES} images x {N_TRAJ} trajectories: "
          f"{len(dev) / iters:.1f} device events per iteration, device busy "
          f"{busy / iters / 1e3:.4f} ms per iteration, idle share "
          f"{1 - busy / wall_us:.3f} of {wall_us / iters / 1e3:.3f} ms per "
          f"profiled iteration; kernel #7 {counts['amp'] / iters:.1f} calls "
          f"({len(amp)} of {counts['amp']} profiled), "
          f"{sum(amp) / iters:.1f} us per iteration ({sum(amp) / busy:.3f} "
          f"of busy); kernel #5 (rows) {counts['sel_rows'] / iters:.1f} "
          f"calls ({len(sel)} of {counts['sel_rows']} profiled), "
          f"{sum(sel) / iters:.1f} us per iteration ({sum(sel) / busy:.3f} "
          f"of busy); iteration without the profiler {iter_ms:.3f} ms (host "
          f"clock, median of 5 runs of {iters}, each ending in a "
          f"synchronise)")


def _median_ms(fn, runs: int = 20) -> float:
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# A plain version of SLOW_PLAIN_MS or more a call (the Python walks over
# the gates take up to 1.5 s) is timed over SLOW_PLAIN_RUNS calls a round:
# 41 calls of each cost the script over 300 s, and that time only stands
# beside its kernel's, hundreds of times shorter.
SLOW_PLAIN_MS = 10.0
SLOW_PLAIN_RUNS = 3


def _paired_ms(kernel, plain) -> tuple[float, float]:
    """Median-of-20 ms of each (of SLOW_PLAIN_RUNS for a slow plain
    version), plain-kernel-kernel-plain, better of two rounds."""
    kernel()  # warm up; the plain's warm-up call also sizes its runs
    runs = 20 if _median_ms(plain, 1) < SLOW_PLAIN_MS else SLOW_PLAIN_RUNS
    torch.cuda.synchronize()
    plain_ms = _median_ms(plain, runs)
    kernel_ms = _median_ms(kernel)
    kernel_ms = min(kernel_ms, _median_ms(kernel))
    plain_ms = min(plain_ms, _median_ms(plain, runs))
    return kernel_ms, plain_ms


_HOW = (f"median of 20 (of {SLOW_PLAIN_RUNS} for a plain version of "
        f"{SLOW_PLAIN_MS:g} ms or more), better of two rounds, "
        f"plain-kernel-kernel-plain")

# Arithmetic of the chains, counted from the algorithm, per sample and per
# d = 2^w amplitudes: a complex 2x2 gate on all d/2 pairs of one wire is
# 14 d flops (28 a pair), a real RY 6 d (12 a pair), a sign plane 2 d, a
# phase plane 6 d. An adjoint step undoes a gate on the state and on the
# cotangent and forms 8 pair products for dg: 40 d. The RZ un-encode is
# 20 d, the RY un-encode 20 d a wire (two real RYs and the dc, ds sums).
# dg's batch sum adds L*k*w*8 values per sample. Bytes: each input read
# once and each output written once, float32 (4 bytes); scratch is not
# counted.


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def bound_tf32(flops: float, nbytes: float) -> tuple[float, str]:
    """_bound for a product of ``flops`` run as three TF32 tensor-core
    products at PEAK_TF32."""
    t_ops, t_bytes = 3 * flops / PEAK_TF32, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def bound_gate(w, b, n, k, bwd: bool) -> tuple[float, str]:
    d, re = 2**w, n // k  # n = L*k layers, re = L encodes
    g = n * w * 8
    if not bwd:
        return _bound(b * d * (14 * n * w + 2 * n + 6 * re),
                      4 * (2 * d * b + g + k * d + 2 * d * b))
    return _bound(b * (d * (n * (4 + 40 * w) + 20 * re) + g),
                  4 * (6 * d * b + g + k * d + 2 * d * b + g))


def bound_ry(w, b, n, k, bwd: bool) -> tuple[float, str]:
    d, re = 2**w, n // k
    g = n * w * 8
    if not bwd:
        return _bound(b * d * (14 * n * w + 2 * n + 6 * re * w),
                      4 * (2 * w * b + g + k * d + 2 * d * b))
    return _bound(b * (d * (n * (4 + 40 * w) + 20 * re * w) + g),
                  4 * (2 * w * b + g + k * d + 4 * d * b + g + 2 * w * b))


# The density-matrix block, per sample and per d^2 elements of rho, per
# spectrum layer: a 2x2 complex gate on both sides of one wire is 28 d^2
# flops (14 an output element a side), the CZ signs 2 d^2 a SEL layer, the
# RY encode on both sides 12 d^2 a wire, the RZ encode 6 d^2 (one complex
# multiply; forming the phase products, 6 d^2, once a call), a channel on
# one wire 2.5 d^2 (amplitude damping), 4.5 d^2 (depolarizing) or d^2
# (phase damping). Bytes: the encode, the gates and the strength read once,
# rho (complex64) written once.
_DM_CHANNEL_FLOPS = {"amplitude_damping": 2.5, "depolarizing": 4.5,
                     "phase_damping": 1.0}


def bound_dm(w, b, n_spec, k, ry, kind) -> tuple[float, str]:
    dd = 4**w
    per_layer = ((12 * w if ry else 6) + _DM_CHANNEL_FLOPS[kind] * w
                 + k * (28 * w + 2))
    flops = b * dd * (n_spec * per_layer + (0 if ry else 6))
    enc = 2 * w * b if ry else 2 * 2**w * b
    return _bound(flops, 4 * (enc + n_spec * k * w * 8 + 1) + 8 * b * dd)


def bound_sel(w, b, depth, ring, bwd: bool) -> tuple[float, str]:
    """#5 / #6 on (d, B) planes: the CZ signs are computed from the index
    (no table); a CNOT ring reads its (p, w) gather columns."""
    d, g = 2**w, depth * w * 8
    sign = 2 if ring == "cz" else 0  # a CNOT ring moves, it computes nothing
    table = max(w - 1, 1) * w if ring == "cnot" else 0
    if not bwd:
        return _bound(b * d * depth * (14 * w + sign),
                      4 * (2 * d * b + g + table + 2 * d * b))
    return _bound(b * (d * depth * (40 * w + 2 * sign) + g),
                  4 * (4 * d * b + g + table + 2 * d * b + g))


def bound_sel_rows(w, n, depth, ring) -> tuple[float, str]:
    """The rows kernel: #5's arithmetic on (N, d) complex64 rows; bytes the
    rows read and written once, the gates, and for CNOT the rings' (p, w)
    gather columns (no (p, d) table)."""
    d, g = 2**w, depth * w * 8
    sign = 2 if ring == "cz" else 0
    cols = max(w - 1, 1) * w if ring == "cnot" else 0
    return _bound(n * d * depth * (14 * w + sign),
                  4 * (4 * d * n + g + cols))


# The amplitude-damping pass, per state and wire, on d = 2^w amplitudes:
# P(wire = 1) is 4 flops a bit-1 amplitude (2 d), the renormalized update 2
# flops an amplitude (2 d); the sums run in float64, a few percent of the
# float32 count at a third of its peak, below the bytes either way. Bytes:
# the states read once and written once (complex64), the (w, N) uniforms
# (float32) read and the picks (uint8) written once.
def bound_amp(w, n) -> tuple[float, str]:
    d = 2**w
    return _bound(4 * d * w * n, 2 * n * d * 8 + w * n * 5 + 4)


# The wide chain, per sample and per amplitude, at k = 2 (n = L*k
# sublayers, L phases): a group of s bits is a complex (2^s x 2^s) product,
# 8 * 2^s flops an amplitude; a sublayer's ring signs 2, the phase 6. The
# backward does three products a group (the state's rebuild, the
# cotangent's push, dG), the signs on state and cotangent (4) and the
# un-encode (20). #9-#12 run the products as three TF32 tensor-core
# products each, at PEAK_TF32 / 3, and the elementwise work as float32 on
# the CUDA cores at PEAK_FLOPS.
# Bytes: each input read once and each output written once, float32: the
# (d, B) planes and the group planes (2 sum 4^s floats a sublayer).
def bound_wide(w, b, n, bwd: bool) -> tuple[float, str]:
    d, sizes = 2**w, wide.group_sizes(w)
    mac = 8 * sum(2**s for s in sizes)
    g = 2 * n * sum(4**s for s in sizes)
    if not bwd:
        prod, elem = b * d * n * mac, b * d * (2 * n + 6 * (n // 2))
        nbytes = 4 * (2 * d * b + g + 2 * d * b)
    else:
        prod, elem = b * d * n * 3 * mac, b * d * (4 * n + 20 * (n // 2))
        nbytes = 4 * (6 * d * b + g + 2 * d * b + g)
    t_ops = prod / (PEAK_TF32 / 3) + elem / PEAK_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _library_wide_fwd(p, gs, signs, w):
    """The forward chain (k = 2) by PyTorch calls on complex64 (d, B)
    states: one torch.matmul (cuBLAS, TF32 off) per group, the phase and
    the signs elementwise. Timed as kernel #11's library yardstick, used nowhere in
    the port."""
    sizes = wide.group_sizes(w)
    d, b = p.shape
    s = torch.zeros_like(p)
    s[0] = 1
    for l in range(gs[0].shape[0]):
        if l % 2 == 0:
            s = s * p
        for g, (off, sz) in enumerate(zip(wide._offsets(sizes), sizes)):
            s = torch.matmul(gs[g][l], s.view(2**off, 2**sz, -1)).view(d, b)
        s = s * signs[l % 2]
    return s


def _library_wide_bwd(p, gs, signs, f, c, w):
    """Kernel #12's yardstick in the same calls: G^H on state and
    cotangent and dG = c s^H, one batched torch.matmul each per group."""
    sizes = wide.group_sizes(w)
    offs = wide._offsets(sizes)
    d, b = p.shape
    s, dp = f, torch.zeros_like(p)
    dg = []
    for l in range(gs[0].shape[0] - 1, -1, -1):
        s, c = s * signs[l % 2], c * signs[l % 2]
        for g in range(len(sizes) - 1, -1, -1):
            view = (2**offs[g], 2**sizes[g], -1)
            gh = gs[g][l].mH
            s = torch.matmul(gh, s.view(view)).view(d, b)
            dg.append(torch.matmul(c.view(view), s.view(view).mH).sum(0))
            c = torch.matmul(gh, c.view(view)).view(d, b)
        if l % 2 == 0:
            s = s * p.conj()
            dp = dp + c * s.conj()
            c = c * p.conj()
    return dp, dg


def _dm_cluster_sweep(enc, g8, w, b, n_layers, ry, plan, smi) -> None:
    """Kernel #8 at every cluster size whose rows fit in shared memory,
    in turns with the plan's (plan, other, other, plan; median of 20 each),
    printed only: what the plan's choice is worth at this shape."""
    d = 2**w
    side = plan.smem_bytes - (d * d * 8 // plan.cluster
                              if plan.rho_in_smem else 0)
    for c in (1, 2, 4, 8, 16):
        if c == plan.cluster or (c > 1 and c > d // 2):
            continue
        if side + d * d * 8 // c > gate_kernel._MAX_SMEM_BYTES:
            continue
        other = dm_kernel.DmPlan(c, d // c, side + d * d * 8 // c, True)
        mine, theirs = _paired_ms(
            lambda: dm_kernel._dm_chain_cuda(enc, g8, 0.3, 2, w, 1, ry,
                                             plan),
            lambda: dm_kernel._dm_chain_cuda(enc, g8, 0.3, 2, w, 1, ry,
                                             other))
        print(f"dm cluster sweep w={w} B={b} L*k={n_layers} ({smi}; {_HOW}, "
              f"the plan's as kernel): plan's cluster {plan.cluster} "
              f"{mine:.4f} ms, cluster {c} {theirs:.4f} ms")


def phase_times(dev, smi: str) -> tuple[dict, dict, dict]:
    """{key: (kernel ms, plain ms, bound ms, bound by)}, for the wide
    chain {key: library ms}, and #9-#12's calls at WIDE_PAIRED with their
    library calls for the pairs of phase 31."""
    rng = np.random.default_rng(SEED + 1)
    w, b, n_layers, k = 6, 16, 28, 2
    pr, pi, mats = chain_inputs(rng, w, b, n_layers, dev)
    g8 = gate_kernel._to_g8(mats)
    signs = gate_kernel._sign_planes_on(k, w, pr.device)
    # #1-#4: also their device time behind a spin, with their plans
    walks = {"fwd": (functools.partial(gate_kernel._gate_chain_cuda, pr, pi,
                                       g8, signs, k, w),
                     _fwd_plan_line(w, b))}
    times = {"fwd": _paired_ms(
        walks["fwd"][0],
        lambda: gate_kernel.gate_chain_planes_plain(pr, pi, mats, k, w))
        + bound_gate(w, b, n_layers, k, False)}
    for w, b in ((6, 10), (6, 16), (10, 80)):
        args = bwd_inputs(rng, w, b, n_layers, k, dev)
        key = f"bwd{b}" if w == 6 else f"bwd_w{w}_b{b}"
        walks[key] = (functools.partial(
            gate_kernel._gate_chain_bwd_cuda, *args, k, w), _plan_line(w, b))
        times[key] = _paired_ms(
            walks[key][0],
            lambda: gate_kernel.gate_chain_bwd_plain(*args, k, w)
        ) + bound_gate(w, b, n_layers, k, True)
    # the sweep's deepest block (mnist_ray at L 16: L*k = 32) at its
    # training batch (8 images x tau 10)
    w, b, n = 6, 80, 32
    pr, pi, mats = chain_inputs(rng, w, b, n, dev)
    g8 = gate_kernel._to_g8(mats)
    walks["fwd6_80_32"] = (functools.partial(
        gate_kernel._gate_chain_cuda, pr, pi, g8, signs, k, w),
        _fwd_plan_line(w, b))
    times["fwd6_80_32"] = _paired_ms(
        walks["fwd6_80_32"][0],
        lambda: gate_kernel.gate_chain_planes_plain(pr, pi, mats, k, w)
    ) + bound_gate(w, b, n, k, False)
    args = bwd_inputs(rng, w, b, n, k, dev)
    walks["bwd6_80_32"] = (functools.partial(
        gate_kernel._gate_chain_bwd_cuda, *args, k, w), _plan_line(w, b))
    times["bwd6_80_32"] = _paired_ms(
        walks["bwd6_80_32"][0],
        lambda: gate_kernel.gate_chain_bwd_plain(*args, k, w)
    ) + bound_gate(w, b, n, k, True)
    # (the rebuttal drivers' Qdense at 28x28 and 64x64: depth 60, a CNOT
    # ring, batch 1 x tau 10)
    for w, depth, b, ring in ((8, 14, 10, "cz"), (8, 14, 16, "cz"),
                              (6, 60, 10, "cnot"), (12, 2, 1000, "cz"),
                              (12, 2, 1000, "cnot"), (10, 60, 10, "cnot"),
                              (12, 60, 10, "cnot")):
        (g8, fr, fi, gr, gi), (sr, si) = sel_bwd_inputs(rng, w, b, depth,
                                                        ring, dev)
        key = f"{w}_{depth}_{b}_{ring}"
        times[f"sel_fwd{key}"] = _paired_ms(
            lambda: sel_kernel._sel_chain_cuda(sr, si, g8, w, ring),
            lambda: sel_kernel._sel_plain(sr, si, g8, w, ring)
        ) + bound_sel(w, b, depth, ring, False)
        times[f"sel_bwd{key}"] = _paired_ms(
            lambda: sel_kernel._sel_chain_bwd_cuda(g8, fr, fi, gr, gi, w,
                                                   ring),
            lambda: sel_kernel.sel_chain_bwd_plain(g8, fr, fi, gr, gi, w,
                                                   ring)
        ) + bound_sel(w, b, depth, ring, True)
        if (w, depth) == (12, 2):  # path A's: the rows kernel, same states
            x = torch.view_as_real(torch.complex(sr, si).T.contiguous())
            times[f"sel_rows_fwd{key}"] = _paired_ms(
                lambda: sel_kernel._sel_rows_cuda(x, g8, w, ring),
                lambda: sel_kernel._sel_rows_plain(x, g8, w, ring)
            ) + bound_sel_rows(w, b, depth, ring)
    for w, b, n_layers, k in ((8, 10, 12, 2), (6, 11, 28, 2)):
        args = ry_bwd_inputs(rng, w, b, n_layers, k, dev)
        key = f"{w}_{b}_{n_layers}"
        walks[f"ry_fwd{key}"] = (functools.partial(
            ry_kernel._ry_chain_cuda, *args[:3], k, w), _fwd_plan_line(w, b))
        times[f"ry_fwd{key}"] = _paired_ms(
            walks[f"ry_fwd{key}"][0],
            lambda: ry_kernel._ry_plain(*args[:3], k, w)
        ) + bound_ry(w, b, n_layers, k, False)
        walks[f"ry_bwd{key}"] = (functools.partial(
            ry_kernel._ry_chain_bwd_cuda, *args, k, w), _plan_line(w, b))
        times[f"ry_bwd{key}"] = _paired_ms(
            walks[f"ry_bwd{key}"][0],
            lambda: ry_kernel.ry_chain_bwd_plain(*args, k, w)
        ) + bound_ry(w, b, n_layers, k, True)
    for key, (fn, plan) in walks.items():
        spun = tools_common.median_ms(fn, dev)
        bound = times[key][2]
        print(f"times {key} device ({smi}): {spun:.4f} ms behind a "
              f"{tools_common.SPIN_CYCLES}-cycle spin (median of 20), "
              f"{bound / spun:.2e} of the bound; {plan}")
    for w, b, n_spec, ry in ((6, 10, 14, False), (8, 10, 6, True),
                             (10, 1, 1, False)):
        ang = torch.as_tensor(rng.normal(size=(n_spec * 2, w, 3)),
                              dtype=torch.float32, device=dev)
        x = torch.as_tensor(rng.normal(size=(b, w)), dtype=torch.float32,
                            device=dev)
        mats = rot_matrix(ang[..., 0], ang[..., 1], ang[..., 2])
        enc = x if ry else rz_phases(x, w)
        g8 = gate_kernel._to_g8(mats)
        times[f"dm_fwd{w}"] = _paired_ms(
            lambda: dm_kernel._dm_chain_cuda(enc, g8, 0.3, 2, w, 1, ry),
            lambda: dm_kernel.dm_chain_plain(enc, mats, 2, w, "depolarizing",
                                             0.3, ry=ry)
        ) + bound_dm(w, b, n_spec, 2, ry, "depolarizing")
        plan = dm_kernel.cluster_plan(w, b, n_spec * 2, ry)
        print(f"times dm_fwd{w} w={w} B={b} L={n_spec}: "
              f"{_plan_text(plan, w, n_spec * 2, ry)}")
        if w < 10:  # printed only: the same call at the other clusters
            _dm_cluster_sweep(enc, g8, w, b, n_spec * 2, ry, plan, smi)
    for w, n in ((12, 1000), (8, 1000)):
        st = torch.randn((n, 2**w), dtype=torch.complex64, device=dev)
        st /= st.abs().square().sum(1, keepdim=True).sqrt()
        u = torch.rand((w, n), device=dev)
        times[f"amp_fwd{w}"] = _paired_ms(
            lambda: amp_damp_kernel._amp_damp_cuda(st, u, TRAJ_STRENGTH,
                                                   None),
            lambda: amp_damp_kernel.amp_damp_plain(st, u, TRAJ_STRENGTH)
        ) + bound_amp(w, n)
        spun = tools_common.median_ms(
            lambda: amp_damp_kernel._amp_damp_cuda(st, u, TRAJ_STRENGTH,
                                                   None), dev)
        bound = times[f"amp_fwd{w}"][2]
        print(f"times amp_fwd{w} device ({smi}): {spun:.4f} ms behind a "
              f"{tools_common.SPIN_CYCLES}-cycle spin (median of 20), "
              f"{bound / spun:.2e} of the bound; plan "
              f"{amp_damp_kernel.amp_damp_plan(w, n)}")
    library, pairs = {}, {}
    for w, b, n in ((16, 10, 28), (20, 8, 4)):
        pr, pi, gplanes, fr, fi, gr, gi = wide_inputs(rng, w, b, n, dev)
        signs = gate_kernel._sign_planes_on(2, w, dev)
        p, f, c = (torch.complex(r, i) for r, i in ((pr, pi), (fr, fi),
                                                    (gr, gi)))
        gs = [torch.complex(gplanes[j], gplanes[j + 1])
              for j in range(0, len(gplanes), 2)]
        lib_f = _library_wide_fwd(p, gs, signs, w)
        err = (lib_f - f).abs().max().item()
        if not err <= KERNEL_TOL:
            fail(f"the wide chain's library formulation is not the chain: "
                 f"{err:.3e}")
        key = f"{w}_{b}_{n}"
        times[f"wide_fwd{key}"] = _paired_ms(
            lambda: wide_kernel._wide_chain_cuda(pr, pi, gplanes, 2, w),
            lambda: wide_kernel._chain_plain(pr, pi, gplanes, signs, 2, w)
        ) + bound_wide(w, b, n, False)
        times[f"wide_bwd{key}"] = _paired_ms(
            lambda: wide_kernel._wide_chain_bwd_cuda(pr, pi, gplanes, fr, fi,
                                                     gr, gi, 2, w),
            lambda: wide_kernel.wide_chain_bwd_plain(pr, pi, gplanes, fr, fi,
                                                     gr, gi, 2, w)
        ) + bound_wide(w, b, n, True)
        # #9/#10 do #11/#12's work on the same units, in one launch
        times[f"wide_mono_fwd{key}"] = _paired_ms(
            lambda: wide_kernel._wide_mono_cuda(pr, pi, gplanes, 2, w),
            lambda: wide_kernel._chain_plain(pr, pi, gplanes, signs, 2, w)
        ) + bound_wide(w, b, n, False)
        times[f"wide_mono_bwd{key}"] = _paired_ms(
            lambda: wide_kernel._wide_mono_bwd_cuda(pr, pi, gplanes, fr, fi,
                                                    gr, gi, 2, w),
            lambda: wide_kernel.wide_chain_bwd_plain(pr, pi, gplanes, fr, fi,
                                                     gr, gi, 2, w)
        ) + bound_wide(w, b, n, True)
        library[f"wide_fwd{key}"] = min(
            _median_ms(lambda: _library_wide_fwd(p, gs, signs, w))
            for _ in range(2))
        library[f"wide_bwd{key}"] = min(
            _median_ms(lambda: _library_wide_bwd(p, gs, signs, f, c, w))
            for _ in range(2))
        library[f"wide_mono_fwd{key}"] = library[f"wide_fwd{key}"]
        library[f"wide_mono_bwd{key}"] = library[f"wide_bwd{key}"]
        if (w, b, n) == WIDE_PAIRED:
            bwd = (pr, pi, gplanes, fr, fi, gr, gi, 2, w)
            fwd_lib = functools.partial(_library_wide_fwd, p, gs, signs, w)
            bwd_lib = functools.partial(_library_wide_bwd, p, gs, signs, f,
                                        c, w)
            pairs.update({
                f"#11 wide_fwd{key}": (functools.partial(
                    wide_kernel._wide_chain_cuda, pr, pi, gplanes, 2, w),
                    fwd_lib, "_library_wide_fwd"),
                f"#12 wide_bwd{key}": (functools.partial(
                    wide_kernel._wide_chain_bwd_cuda, *bwd), bwd_lib,
                    "_library_wide_bwd"),
                f"#9 wide_mono_fwd{key}": (functools.partial(
                    wide_kernel._wide_mono_cuda, pr, pi, gplanes, 2, w),
                    fwd_lib, "_library_wide_fwd"),
                f"#10 wide_mono_bwd{key}": (functools.partial(
                    wide_kernel._wide_mono_bwd_cuda, *bwd), bwd_lib,
                    "_library_wide_bwd")})
    # printed only: a call with one column tile a group pass, whose time
    # is the passes' fixed cost (a barrier or a launch, G and a tile staged
    # from L2, the product's latency), #9 against #11 and #10 against #12
    w, b, n = 11, 1, 28
    pr, pi, gplanes, fr, fi, gr, gi = wide_inputs(rng, w, b, n, dev)
    bwd = (pr, pi, gplanes, fr, fi, gr, gi, 2, w)
    passes = n * len(wide.group_sizes(w))
    mono_f, scan_f = _paired_ms(
        lambda: wide_kernel._wide_mono_cuda(pr, pi, gplanes, 2, w),
        lambda: wide_kernel._wide_chain_cuda(pr, pi, gplanes, 2, w))
    mono_b, scan_b = _paired_ms(
        lambda: wide_kernel._wide_mono_bwd_cuda(*bwd),
        lambda: wide_kernel._wide_chain_bwd_cuda(*bwd))
    print(f"wide pass cost w={w} B={b} L*k={n} ({smi}; {_HOW}, the "
          f"monolith as kernel), {passes} group products a call: #9 "
          f"{mono_f:.4f} ms, #11 {scan_f:.4f} ms ({1e3 * mono_f / passes:.2f}"
          f" / {1e3 * scan_f / passes:.2f} us a group); #10 {mono_b:.4f} ms, "
          f"#12 {scan_b:.4f} ms ({1e3 * mono_b / passes:.2f} / "
          f"{1e3 * scan_b / passes:.2f} us a group)")
    for key, (kern, plain, bound, by) in times.items():
        lib = (f", library {library[key]:.4f} ms (median of 20, better of "
               f"two rounds)" if key in library else "")
        print(f"times {key} ({smi}): kernel {kern:.4f} ms, plain "
              f"{plain:.4f} ms ({_HOW}){lib}; bound {bound:.3e} ms ({by}, "
              f"{datapath_of(key)}), kernel at {bound / kern:.2e} of it")
    return times, library, pairs


def _wide_kind(name: str) -> str:
    """A wide-chain backward launch's kind, by its kernel's name."""
    for part, kind in (("reduce", "dG reduce"), ("unencode", "un-encode"),
                       ("dg", "dG product")):
        if part in name:
            return kind
    return "rebuild and push"


def phase_wide_split(dev, smi: str) -> None:
    """Where a chain call of #11 and of #12 spends its device time, at the
    16-wire model's training shape and the widest timed one: 3 calls each
    under torch.profiler after a warm call; #11's launches, and #12's
    two-right-hand-side rebuild and push, by group width (the kernel's
    rows, from its template name: the profiler may drop a record, so no
    launch is placed by its position), #12's others by kind (the dG
    product, its fixed-order sum, the un-encode). Printed only."""
    rng = np.random.default_rng(SEED + 15)
    calls = 3
    for w, b, n in ((16, 10, 28), (20, 8, 4)):
        pr, pi, gplanes, fr, fi, gr, gi = wide_inputs(rng, w, b, n, dev)

        def fwd():
            return wide_kernel._wide_chain_cuda(pr, pi, gplanes, 2, w)

        def bwd():
            return wide_kernel._wide_chain_bwd_cuda(pr, pi, gplanes, fr, fi,
                                                    gr, gi, 2, w)

        for what, fn in (("#11", fwd), ("#12", bwd)):
            fn()
            torch.cuda.synchronize()
            events, busy, _, _ = _device_profile(
                lambda: [fn() for _ in range(calls)])
            by = {}
            for e in events:
                if "wide_" not in e.name:
                    continue
                kind = "group" if what == "#11" else _wide_kind(e.name)
                rows = re.search(r"group_mma_kernel(?:<\d+, |ILi\dELi)(\d+)",
                                 e.name)
                if rows:
                    kind = f"{kind} D={rows.group(1)}"
                us, count = by.get(kind, (0.0, 0))
                by[kind] = (us + e.time_range.elapsed_us(), count + 1)
            total = sum(us for us, _ in by.values())
            print(f"split {what} w={w} B={b} L*k={n} groups "
                  f"{wide.group_sizes(w)} ({smi}), torch.profiler over "
                  f"{calls} calls: {total / calls / 1e3:.4f} ms of kernels a "
                  f"call (device busy {busy / calls / 1e3:.4f} ms): "
                  + "; ".join(
                      f"{kind} {us / calls / 1e3:.4f} ms ({us / total:.3f}, "
                      f"{count} records, {us / count:.2f} us each)"
                      for kind, (us, count) in sorted(by.items())))


def datapath_of(key: str) -> str:
    """The arithmetic datapath of the kernel timed under ``key``: #9-#12,
    #13, #14 and P5 multiply on the tensor cores in 3xTF32; every other
    kernel of the port runs float32 on the CUDA cores."""
    return ("3xtf32" if key.startswith(("wide_", "unitary_", "probe_matmul2"))
            else "simt")


def phase_crossover(dev, smi: str) -> None:
    """ROADMAP item 5's crossover, printed only (routing at w <= 10 stays
    on the gate chain): the gate chain #1/#2 against the wide chain
    #11/#12 at w = 9 and 10, B = 80, L*k = 28, in turns in one call."""
    rng = np.random.default_rng(SEED + 13)
    for w in (9, 10):
        pr, pi, mats = chain_inputs(rng, w, 80, 28, dev)
        g8 = gate_kernel._to_g8(mats)
        gplanes = wide_kernel._planes_of(
            wide.group_gates(mats, wide.group_sizes(w)))
        signs = gate_kernel._sign_planes_on(2, w, dev)
        fr, fi = wide_kernel._wide_chain_cuda(pr, pi, gplanes, 2, w)
        qr, qi = gate_kernel._gate_chain_cuda(pr, pi, g8, signs, 2, w)
        gr, gi = (torch.as_tensor(rng.normal(size=(2**w, 80)),
                                  dtype=torch.float32, device=dev)
                  for _ in range(2))
        same = max((fr - qr).abs().max().item(), (fi - qi).abs().max().item())
        if not same <= KERNEL_TOL:
            fail(f"the gate chain and the wide chain differ at w={w}: "
                 f"{same:.3e}")
        gate_f, wide_f = _paired_ms(
            lambda: gate_kernel._gate_chain_cuda(pr, pi, g8, signs, 2, w),
            lambda: wide_kernel._wide_chain_cuda(pr, pi, gplanes, 2, w))
        gate_b, wide_b = _paired_ms(
            lambda: gate_kernel._gate_chain_bwd_cuda(pr, pi, g8, signs, fr,
                                                     fi, gr, gi, 2, w),
            lambda: wide_kernel._wide_chain_bwd_cuda(pr, pi, gplanes, fr, fi,
                                                     gr, gi, 2, w))
        print(f"crossover w={w} B=80 L*k=28 ({smi}), outputs {same:.3e} "
              f"apart: gate chain #1 "
              f"{gate_f:.4f} ms, #2 {gate_b:.4f} ms; wide chain #11 "
              f"{wide_f:.4f} ms, #12 {wide_b:.4f} ms ({_HOW})")


def unitary_inputs(rng, wires: int, batch: int, L: int, k: int, ring: str,
                   dev):
    """Block weights (L, k, w, 3) and encoding angles (B, w), and from them
    one chain call's planes: (pr, pi, ur, ui), the RZ phases and the flat
    per-layer unitaries of sel_layer_unitaries."""
    weights = torch.as_tensor(rng.normal(size=(L, k, wires, 3)) * 0.4,
                              dtype=torch.float32, device=dev)
    x = torch.as_tensor(rng.normal(size=(batch, wires)), dtype=torch.float32,
                        device=dev)
    pr, pi = rz_phase_planes(x, wires)
    lus = sel_layer_unitaries(weights, ring).reshape(L * k, 2**wires,
                                                     2**wires)
    return weights, x, (pr, pi, lus.real.contiguous(),
                        lus.imag.contiguous())


def unitary_bwd_inputs(rng, wires, batch, L, k, ring, dev):
    """(pr, pi, ur, ui, fr, fi, gr, gi) with N(0, 1) cotangents."""
    planes = unitary_inputs(rng, wires, batch, L, k, ring, dev)[2]
    fr, fi = unitary_kernel.unitary_chain_planes_plain(*planes, k)
    gr, gi = (torch.as_tensor(rng.normal(size=(2**wires, batch)),
                              dtype=torch.float32, device=dev)
              for _ in range(2))
    return (*planes, fr, fi, gr, gi)


def phase_unitary_vs_plain(dev) -> tuple[float, float]:
    """Kernels #13 and #14 against their plain versions at UNITARY_CASES,
    both rings, each call twice (the same bits both times: fixed-order
    sums, no atomics); at one shape #14 also against torch autograd
    through the plain forward. Returns the forward's worst max |diff| and
    the backward's worst max |diff| / max(1, max|plain|), the values
    checked."""
    rng = np.random.default_rng(SEED + 20)
    worst_f = worst_b = 0.0
    for w, b, L, k in UNITARY_CASES:
        print(f"unitary plan w={w} B={b}: {_unitary_plan_text(w, b)}; "
              f"#14: {_unitary_bwd_plan_text(w, b)}")
        for ring in RINGS:
            args = unitary_bwd_inputs(rng, w, b, L, k, ring, dev)
            with torch.no_grad():
                kr, ki = unitary_kernel._unitary_chain_cuda(*args[:4], k)
                got = unitary_kernel._unitary_chain_bwd_cuda(*args, k)
                again_f = unitary_kernel._unitary_chain_cuda(*args[:4], k)
                again_b = unitary_kernel._unitary_chain_bwd_cuda(*args, k)
                want = unitary_kernel.unitary_chain_bwd_plain(*args, k)
            torch.cuda.synchronize()
            err = max((kr - args[4]).abs().max().item(),
                      (ki - args[5]).abs().max().item())
            errs = [_rel(g, q) for g, q in zip(got, want)]
            worst_f, worst_b = max(worst_f, err), max(worst_b, *errs)
            same = (torch.equal(kr, again_f[0]) and torch.equal(ki, again_f[1])
                    and all(torch.equal(g, a) for g, a in zip(got, again_b)))
            print(f"unitary kernels vs plain w={w} B={b} L*k={L * k} k={k} "
                  f"{ring}: forward max|diff| {err:.3e}; backward dpr, dpi, "
                  f"dur, dui max|diff| / max(1, max|plain|) "
                  + ", ".join(f"{e:.3e}" for e in errs)
                  + f"; two calls {'the same bits' if same else 'DIFFER'}")
            if not (err <= KERNEL_TOL and max(errs) <= BWD_TOL):
                fail(f"unitary kernels disagree with plain at w={w} B={b} "
                     f"L*k={L * k} {ring}: forward {err:.3e} > {KERNEL_TOL} "
                     f"or backward {max(errs):.3e} > {BWD_TOL}")
            if not same:
                fail(f"#13 or #14 gave other bits on a second call at w={w} "
                     f"B={b} {ring}")
    # a third formulation: autograd through the plain forward
    args = unitary_bwd_inputs(rng, 6, 16, 14, 2, "cnot", dev)
    leaves = [t.clone().requires_grad_(True) for t in args[:4]]
    sr, si = unitary_kernel.unitary_chain_planes_plain(*leaves, 2)
    (sr * args[6] + si * args[7]).sum().backward()
    with torch.no_grad():
        got = unitary_kernel._unitary_chain_bwd_cuda(*args, 2)
    err = max(_rel(g, leaf.grad) for g, leaf in zip(got, leaves))
    print(f"unitary backward kernel vs autograd of the plain forward w=6 "
          f"B=16 L*k=28 cnot: {err:.3e}")
    if not err <= BWD_TOL:
        fail(f"unitary backward kernel disagrees with autograd: {err:.3e} "
             f"> {BWD_TOL}")
    print(f"unitary kernels against the reference's on-chip bar "
          f"{ONCHIP_BAR:.1e} relative: forward {worst_f:.3e}, backward "
          f"{worst_b:.3e}")
    return worst_f, worst_b


def _unitary_plan_text(w: int, b: int, cols: int = 0) -> str:
    """#13's plan for (w, b) and the clusters of it the card holds at
    once."""
    plan = unitary_kernel.unitary_plan(w, b, cols)
    active = gate_kernel._library().unitary_chain_fwd_active_clusters(
        w, plan.cols, 0)
    if active < 1:
        fail(f"the card holds no cluster of #13's plan {plan}: {active}")
    return (f"{plan.tiles} clusters of {plan.cluster} CTAs, {plan.cols} "
            f"samples a tile, {plan.smem_bytes} B of shared memory a CTA, "
            f"{plan.warps} warps x {plan.steps_per_warp} 8-deep steps a "
            f"layer; the card holds {active} such clusters at once")


def _unitary_bwd_plan_text(w: int, b: int, cols: int = 0) -> str:
    """#14's plan for (w, b) and the clusters of it the card holds at
    once."""
    plan = unitary_kernel.unitary_bwd_plan(w, b, cols)
    active = gate_kernel._library().unitary_chain_bwd_active_clusters(
        w, plan.cols, 0)
    if active < 1:
        fail(f"the card holds no cluster of #14's plan {plan}: {active}")
    return (f"{plan.tiles} clusters of {plan.cluster} CTAs, {plan.cols} "
            f"samples a tile, {plan.smem_bytes} B of shared memory a CTA, "
            f"{plan.warps} warps x {plan.steps_per_warp} 8-deep steps a "
            f"layer, {plan.resident} clusters resident by the plan and "
            f"{active} by the card, {plan.waves} wave(s); dU "
            f"{plan.du_blocks} blocks a layer over {plan.ws_samples} "
            f"samples")


def _route_call(x, weights, encode, readout, coeff, **kw):
    """reupload_block and the gradients of sum(coeff * out) in the angles
    and the block weights."""
    x = x.detach().clone().requires_grad_(True)
    weights = weights.detach().clone().requires_grad_(True)
    out = engine.reupload_block(x, weights, encode=encode, readout=readout,
                                **kw)
    (coeff * out).sum().backward()
    return out.detach(), x.grad, weights.grad


def _route_errs(card, cpu) -> tuple[float, float]:
    """The forward's max |diff| and the gradients' worst max |diff|
    relative to the CPU gradient's max."""
    fwd = (card[0].cpu() - cpu[0]).abs().max().item()
    grad = max(_rel_own(g.cpu(), q) for g, q in zip(card[1:], cpu[1:]))
    return fwd, grad


def phase_unitary_route(dev) -> dict:
    """The slice's main path: the library entry reupload_block(...,
    imprimitive="cnot") at UNITARY_PATH with the rz and rz_halfpi encodes,
    forward and backward on the card, counted from zero: exactly one #13
    launch a forward and one #14 a backward, no gate-chain launch; each
    call's values within KERNEL_TOL and its gradients within TRAIN_TOL
    relative of the same inputs on the CPU. Then the route's other
    blocks: RY with a CNOT ring at w = 8 (the per-layer route in complex
    matmuls, no #13), a damped CNOT block at w = 6 (the SEL chain #5/#6 on
    both sides of rho, no #8), and complex128 at (8, 80) with both rings
    (no kernel), each against the CPU. Returns the main path's counts."""
    rng = np.random.default_rng(SEED + 21)
    calls = []
    for w, L, k, b in UNITARY_PATH:
        for encode, readout in (("rz", "expvalz"), ("rz_halfpi", "probs")):
            weights, x, _ = unitary_inputs(rng, w, b, L, k, "cnot", dev)
            width = 2**w if readout == "probs" else w
            coeff = torch.as_tensor(rng.normal(size=(b, width)),
                                    dtype=torch.float32, device=dev)
            calls.append((w, L, k, b, encode, readout, x, weights, coeff))
    reset_counts()
    results = []
    for w, L, k, b, encode, readout, x, weights, coeff in calls:
        before = read_counts()
        card = _route_call(x, weights, encode, readout, coeff,
                           imprimitive="cnot")
        torch.cuda.synchronize()
        after = read_counts()
        delta = {c: n - before[c] for c, n in after.items()
                 if n != before[c]}
        if delta != {"unitary": 1, "unitary_bwd": 1}:
            fail(f"reupload_block(imprimitive='cnot') at w={w} B={b} "
                 f"launched {delta}, not one #13 and one #14")
        results.append(card)
    counts = read_counts()
    for (w, L, k, b, encode, readout, x, weights, coeff), card in zip(
            calls, results):
        cpu = _route_call(x.cpu(), weights.cpu(), encode, readout,
                          coeff.cpu(), imprimitive="cnot")
        fwd, grad = _route_errs(card, cpu)
        print(f"unitary route on the card vs the CPU w={w} L={L} k={k} B={b} "
              f"{encode} {readout}: forward max|diff| {fwd:.3e}, gradients "
              f"{grad:.3e} relative")
        if not (fwd <= KERNEL_TOL and grad <= TRAIN_TOL):
            fail(f"the unitary route disagrees with the CPU at w={w} B={b} "
                 f"{encode}: forward {fwd:.3e} > {KERNEL_TOL} or gradients "
                 f"{grad:.3e} > {TRAIN_TOL}")
    print(f"unitary route launches (main path, {len(calls)} forward and "
          f"backward calls): {counts}")

    def held(what, out_card, out_cpu, tol, want_delta, before):
        after = read_counts()
        delta = {c: n - before[c] for c, n in after.items()
                 if n != before[c]}
        err = (out_card.cpu() - out_cpu).abs().max().item()
        print(f"{what}: launches {delta}, max|diff| vs the CPU {err:.3e}")
        if not err <= tol or not want_delta(delta):
            fail(f"{what}: launches {delta} or max|diff| {err:.3e} > {tol}")

    weights, x, _ = unitary_inputs(rng, 8, 80, 14, 2, "cnot", dev)
    before = read_counts()
    with torch.no_grad():
        out = engine.reupload_block(x, weights, encode="ry",
                                    imprimitive="cnot")
        want = engine.reupload_block(x.cpu(), weights.cpu(), encode="ry",
                                     imprimitive="cnot")
    held("RY encode, CNOT ring, w=8 B=80 L=14 (per-layer route in complex "
         "matmuls)", out, want, KERNEL_TOL, lambda d: not d, before)
    weights, x, _ = unitary_inputs(rng, 6, 4, 14, 2, "cnot", dev)
    damped = engine.NoiseModel("amplitude_damping", 0.05, "encode")
    for grad in (True, False):
        before = read_counts()
        with torch.set_grad_enabled(grad):
            wt = weights.clone().requires_grad_(grad)
            out = engine.reupload_block(x, wt, imprimitive="cnot",
                                        noise=damped)
            if grad:
                out.square().sum().backward()
            want = engine.reupload_block(x.cpu(), weights.cpu(),
                                         imprimitive="cnot", noise=damped)
        held(f"damped CNOT block w=6 B=4 L=14 ({'with' if grad else 'no'} "
             f"autograd)", out.detach(), want.detach(), DM_TOL,
             lambda d, g=grad: (d.get("sel", 0) > 0 and "dm" not in d
                                and (d.get("sel_bwd", 0) > 0) == g),
             before)
    config.enable_x64(True)
    try:
        for ring in RINGS:
            weights, x, _ = unitary_inputs(rng, 8, 80, 14, 2, ring, dev)
            weights, x = weights.double(), x.double()
            before = read_counts()
            with torch.no_grad():
                out = engine.reupload_block(x, weights, imprimitive=ring)
                want = engine.reupload_block(x.cpu(), weights.cpu(),
                                             imprimitive=ring)
            if out.dtype != torch.float64:
                fail(f"complex128 block gave {out.dtype}")
            held(f"complex128 {ring} ring w=8 B=80 L=14 (per-layer route)",
                 out, want, X64_TOL, lambda d: not d, before)
    finally:
        config.enable_x64(False)
    return counts


def bound_unitary(w, b, n, bwd: bool) -> tuple[float, str]:
    """The unitary-streaming chain, n = L*k layers at k = 2: a dense
    complex (d, d) product is 8 d^2 flops a sample, the phase 6 d; the
    backward does three products a layer (the state's rebuild, the
    cotangent's push, dU) and the un-encode, 20 d. #13 and #14 run their
    products as three TF32 tensor-core products each, at PEAK_TF32 / 3,
    and the phase and the un-encode on the CUDA cores at PEAK_FLOPS.
    Bytes: each input read once and each output written once, float32:
    the (L*k, d, d) unitary planes (and, backward, dU's), the (d, B)
    planes."""
    d, re = 2**w, n // 2
    u = 2 * n * d * d
    if not bwd:
        t_ops = (b * 8 * n * d * d / (PEAK_TF32 / 3)
                 + b * 6 * re * d / PEAK_FLOPS)
        t_bytes = 4 * (u + 4 * d * b) / PEAK_BYTES
    else:
        t_ops = (b * 24 * n * d * d / (PEAK_TF32 / 3)
                 + b * 20 * re * d / PEAK_FLOPS)
        t_bytes = 4 * (2 * u + 8 * d * b) / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def bound_unitary_f32(w, b, n) -> tuple[float, str]:
    """#14's bound on its earlier datapath, everything float32 at
    PEAK_FLOPS (printed beside the tensor cores' bound)."""
    d, re = 2**w, n // 2
    return _bound(b * (24 * n * d * d + 20 * re * d),
                  4 * (4 * n * d * d + 8 * d * b))


def _library_unitary(p, us, k):
    """The chain by PyTorch calls on complex64 (d, B) states: one
    torch.matmul (cuBLAS, TF32 off) a layer and the phase multiplies, the
    JAX package's own XLA route for this function. Timed as the kernels'
    library yardstick, used nowhere in the port."""
    s = torch.zeros_like(p)
    s[0] = 1
    for l in range(us.shape[0]):
        if l % k == 0:
            s = s * p
        s = torch.matmul(us[l], s)
    return s


@torch.no_grad()
def _no_grad_library_unitary(p, us, k):
    return _library_unitary(p, us, k)


def phase_unitary_times(dev, smi: str) -> tuple[dict, dict, dict]:
    """#13/#14 against plain and the library yardstick at (8, 80, 28) and
    (6, 16, 28), each beside its bound (#14's also on its earlier float32
    datapath), their device times behind a spin, and their calls at (8,
    80, 28) with the library's for the pairs of phase 31; printed only:
    #13 and #14 at both tiles of samples (their plans' choice and the
    other) at (8, 80) and (8, 255), and CZ chains at (8, 80, 28) on the
    gate chain #1/#2 against #13/#14 (routing stays on #1/#2), whose
    outputs must agree."""
    rng = np.random.default_rng(SEED + 22)
    times, library, pairs = {}, {}, {}
    for w, b in ((8, 80), (6, 16)):
        args = unitary_bwd_inputs(rng, w, b, 14, 2, "cnot", dev)
        key = f"{w}_{b}_28"
        times[f"unitary_fwd{key}"] = _paired_ms(
            lambda: unitary_kernel._unitary_chain_cuda(*args[:4], 2),
            lambda: unitary_kernel.unitary_chain_planes_plain(*args[:4], 2)
        ) + bound_unitary(w, b, 28, False)
        spun = tools_common.median_ms(
            lambda: unitary_kernel._unitary_chain_cuda(*args[:4], 2), dev)
        bound = times[f"unitary_fwd{key}"][2]
        print(f"times unitary_fwd{key} device ({smi}): {spun:.4f} ms behind "
              f"a {tools_common.SPIN_CYCLES}-cycle spin (median of 20), "
              f"{bound / spun:.2e} of the bound; plan "
              f"{_unitary_plan_text(w, b)}")
        times[f"unitary_bwd{key}"] = _paired_ms(
            lambda: unitary_kernel._unitary_chain_bwd_cuda(*args, 2),
            lambda: unitary_kernel.unitary_chain_bwd_plain(*args, 2)
        ) + bound_unitary(w, b, 28, True)
        spun = tools_common.median_ms(
            lambda: unitary_kernel._unitary_chain_bwd_cuda(*args, 2), dev)
        bound = times[f"unitary_bwd{key}"][2]
        f32, f32_by = bound_unitary_f32(w, b, 28)
        print(f"times unitary_bwd{key} device ({smi}): {spun:.4f} ms behind "
              f"a {tools_common.SPIN_CYCLES}-cycle spin (median of 20), "
              f"{bound / spun:.2e} of the 3xTF32 bound {bound:.3e} ms "
              f"(earlier float32 bound {f32:.3e} ms, {f32_by}); plan "
              f"{_unitary_bwd_plan_text(w, b)}")
        p = torch.complex(args[0], args[1]).requires_grad_(True)
        us = torch.complex(args[2], args[3]).requires_grad_(True)
        out = _library_unitary(p, us, 2)
        err = max((out.real - args[4]).abs().max().item(),
                  (out.imag - args[5]).abs().max().item())
        if not err <= KERNEL_TOL:
            fail(f"the unitary chain's library formulation is not the "
                 f"chain: {err:.3e}")
        cot = torch.complex(args[6], args[7])
        with torch.no_grad():
            library[f"unitary_fwd{key}"] = min(
                _median_ms(lambda: _library_unitary(p, us, 2))
                for _ in range(2))
        library[f"unitary_bwd{key}"] = min(
            _median_ms(lambda: torch.autograd.grad(out, (p, us), cot,
                                                   retain_graph=True))
            for _ in range(2))
        if (w, b) == (8, 80):
            pairs[f"#13 unitary_fwd{key}"] = (
                functools.partial(unitary_kernel._unitary_chain_cuda,
                                  *args[:4], 2),
                functools.partial(_no_grad_library_unitary, p, us, 2),
                "_library_unitary")
            pairs[f"#14 unitary_bwd{key}"] = (
                functools.partial(unitary_kernel._unitary_chain_bwd_cuda,
                                  *args, 2),
                functools.partial(torch.autograd.grad, out, (p, us), cot,
                                  retain_graph=True),
                "autograd through _library_unitary")
    for w, b in ((8, 80), (8, 255)):
        args = unitary_bwd_inputs(rng, w, b, 14, 2, "cnot", dev)
        fwd = [(cols, tools_common.median_ms(
            lambda: unitary_kernel._unitary_chain_cuda(*args[:4], 2, cols),
            dev)) for cols in unitary_kernel.FWD_COLS]
        bwd = [(cols, tools_common.median_ms(
            lambda: unitary_kernel._unitary_chain_bwd_cuda(*args, 2, cols),
            dev)) for cols in unitary_kernel.FWD_COLS]
        print(f"unitary tiles w={w} B={b} L*k=28 ({smi}): #13 (plan "
              f"{unitary_kernel.unitary_plan(w, b).cols} samples a tile) "
              + "; ".join(f"{c} samples a tile {t:.4f} ms ("
                          f"{_unitary_plan_text(w, b, c)})" for c, t in fwd)
              + "; #14 (plan "
              f"{unitary_kernel.unitary_bwd_plan(w, b).cols} samples a tile) "
              + "; ".join(f"{c} samples a tile {t:.4f} ms ("
                          f"{_unitary_bwd_plan_text(w, b, c)})"
                          for c, t in bwd)
              + " (device, median of 20 behind a spin)")
    # CZ chains: the gate chain #1/#2 against #13/#14, printed only
    w, b, L, k = 8, 80, 14, 2
    weights, x, planes = unitary_inputs(rng, w, b, L, k, "cz", dev)
    flat = weights.reshape(L * k, w, 3)
    g8 = gate_kernel._to_g8(rot_matrix(flat[..., 0], flat[..., 1],
                                       flat[..., 2]))
    signs = gate_kernel._sign_planes_on(k, w, dev)
    pr, pi = planes[:2]
    qr, qi = gate_kernel._gate_chain_cuda(pr, pi, g8, signs, k, w)
    ur_, ui_ = unitary_kernel._unitary_chain_cuda(*planes, k)
    same = max((qr - ur_).abs().max().item(), (qi - ui_).abs().max().item())
    if not same <= KERNEL_TOL:
        fail(f"the gate chain and the unitary chain differ on a CZ block: "
             f"{same:.3e}")
    gr, gi = (torch.as_tensor(rng.normal(size=(2**w, b)),
                              dtype=torch.float32, device=dev)
              for _ in range(2))
    gate_f, uni_f = _paired_ms(
        lambda: gate_kernel._gate_chain_cuda(pr, pi, g8, signs, k, w),
        lambda: unitary_kernel._unitary_chain_cuda(*planes, k))
    gate_b, uni_b = _paired_ms(
        lambda: gate_kernel._gate_chain_bwd_cuda(pr, pi, g8, signs, qr, qi,
                                                 gr, gi, k, w),
        lambda: unitary_kernel._unitary_chain_bwd_cuda(*planes, qr, qi, gr,
                                                       gi, k))
    print(f"CZ chain w={w} B={b} L*k=28 ({smi}), outputs {same:.3e} apart: "
          f"gate chain #1 {gate_f:.4f} ms, #2 {gate_b:.4f} ms; unitary chain "
          f"#13 {uni_f:.4f} ms, #14 {uni_b:.4f} ms ({_HOW})")
    for key, (kern, plain, bound, by) in times.items():
        print(f"times {key} ({smi}): kernel {kern:.4f} ms, plain "
              f"{plain:.4f} ms ({_HOW}), library {library[key]:.4f} ms "
              f"(median of 20, better of two rounds); bound {bound:.3e} ms "
              f"({by}), kernel at {bound / kern:.2e} of it")
    return times, library, pairs


def _held(what: str, got, want, tol: float, errs: dict, key: str) -> None:
    """Fail unless max |diff| / max(1, max|plain|) <= tol; keeps the
    largest max |diff| of each probe in errs."""
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rel = err / max(1.0, want.abs().max().item())
    errs[key] = max(errs.get(key, 0.0), err)
    print(f"{what}: max|diff| {err:.3e} ({rel:.3e} relative)")
    if not rel <= tol:
        fail(f"{what} disagrees with its plain version: {rel:.3e} > {tol}")


def _bits(what: str, got, want, errs: dict, key: str) -> None:
    """Fail unless got is want's bits; the probe's error is then 0."""
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    print(f"{what}: {'the plain bits' if same else 'OTHER BITS'}")
    if not same:
        fail(f"{what} is not the plain version's bits")
    errs.setdefault(key, 0.0)


def phase_probes_vs_plain(dev) -> dict:
    """Each probe kernel against its plain version at the tools' shapes and
    at a small one; returns each probe's largest max |diff|."""
    pk = probe_kernels
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    errs = {}
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    top = optin // pk.ROW_BYTES * pk.ROW_BYTES
    x = torch.rand((8, 128), generator=gen, device=dev)
    for cluster in SMEM_CLUSTERS:  # 1: a plain launch; above: a cluster
        for nbytes in (8 * 1024, 48 * 1024, top):
            out = pk.smem_probe(x, nbytes, cluster)
            torch.cuda.synchronize()
            if out is None or not torch.equal(out,
                                              pk.smem_probe_plain(x, 0)):
                fail(f"P1 at {nbytes} B x {cluster} gave "
                     f"{None if out is None else out.flatten()[:4].tolist()}"
                     f", not 2 x")
        if pk.smem_probe(x, top + pk.ROW_BYTES, cluster) is not None:
            fail(f"P1 ran {top + pk.ROW_BYTES} B a block in a cluster of "
                 f"{cluster}, above the card's opt-in {optin} B")
        print(f"P1 at 8 KB, 48 KB and {top} B in clusters of {cluster}: "
              f"exactly 2 x; {top + pk.ROW_BYTES} B refused")
    errs["smem"] = 0.0
    for shape, n in P2_EDGES:  # the tallest strip, 132 strips, more
        x = torch.rand(shape, generator=gen, device=dev)
        same = torch.equal(pk.transpose_probe(x, n),
                           pk.transpose_probe_plain(x, n))
        print(f"P2 {shape} x {n}, plan {pk.transpose_plan(*shape)}: "
              f"{'the plain bits' if same else 'OTHER BITS'}")
        if not same:
            fail(f"P2 {shape} x {n} is not the plain version's bits")
    for shape, n in ((PROBE_SHAPE, PROBE_ITERS), ((32, 64), 3)):
        x = torch.rand(shape, generator=gen, device=dev)
        _bits(f"P2 {shape} x {n}, plan (strip, blocks, smem bytes) "
              f"{pk.transpose_plan(*shape)}", pk.transpose_probe(x, n),
              pk.transpose_probe_plain(x, n), errs, "transpose")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape, n in ((PROBE_SHAPE[::-1], PROBE_ITERS), *P3_SHAPES):
        x = torch.rand(shape, generator=gen, device=dev)
        _bits(f"P3 {shape} x {n}, plan (elements a thread, blocks, threads) "
              f"{pk.reshape_plan(x.numel(), sms)}", pk.reshape_probe(x, n),
              pk.reshape_probe_plain(x, n), errs, "reshape")
    for m, n, iters in ((*PROBE_SHAPE, PROBE_ITERS), *P5_CARD_SHAPES):
        g = wide_probe.orthogonal(m, dev, SEED + 31)
        x = torch.rand((m, n), generator=gen, device=dev)
        what = (f"P5 ({m}, {m}) @ ({m}, {n}) x {iters}, plan (columns a "
                f"block, blocks, threads, smem bytes) "
                f"{pk.matmul2_plan(m, n)}")
        got = pk.matmul2_probe(g, x, iters)
        _held(what, got, pk.matmul2_probe_plain(g, x, iters), TF32_TOL,
              errs, "matmul2")
        if not torch.equal(pk.matmul2_probe(g, x, iters), got):
            fail(f"{what}: a second call gave other bits")
    for a, m, w in (DOT3D_SHAPE, *DOT3D_CARD_SHAPES):
        g = torch.randn((m, m), generator=gen, device=dev)
        x = torch.rand((a, m, w), generator=gen, device=dev)
        try:
            plan = pk.dot3d_plan(a, m, w)
        except ValueError as exc:  # beyond 256 threads of 8 x 4
            try:
                pk.dot3d_probe(g, x)
            except ValueError:
                print(f"P4 ({m}, {m}) x ({a}, {m}, {w}): refused ({exc})")
                continue
            fail(f"P4 ran ({a}, {m}, {w}), a shape its plan refuses")
        grid, threads, smem = plan
        what = (f"P4 ({m}, {m}) x ({a}, {m}, {w}), plan: {grid} blocks of "
                f"{threads} threads and {smem} B")
        got = pk.dot3d_probe(g, x)
        _held(what, got, pk.dot3d_probe_plain(g, x), SLAB_TOL, errs, "dot3d")
        if not torch.equal(got, pk.in_order_matmul(g, x)):
            fail(f"{what} is not the in-order FMA sum")
    for d, b, iters, chains in [*FMA_SHAPES, (16, 8, 64, 4)]:
        x = torch.rand((d, b), generator=gen, device=dev)
        y = torch.rand((d, b), generator=gen, device=dev)
        _held(f"FMA ({d}, {b}) x {iters}, chains {chains}",
              pk.fma_ceiling(x, y, iters, chains),
              pk.fma_ceiling_plain(x, y, iters, chains), FMA_TOL, errs, "fma")
    return errs


def phase_probe_tools() -> dict:
    """The two probe tools through their main() at their defaults (the
    FMA tool also at twice the iterations), from counts of 0; returns the
    probe counts."""
    reset_counts()
    fma = {it: vpu_ceiling.main([] if it == 4096 else ["--iters", str(it)])
           for it in (4096, 8192)}
    probe = wide_probe.main([])
    counts = dict(probe_kernels.PROBE_LAUNCHES)
    print(f"probe tools: launches {counts}; wide_probe {json.dumps(probe)}")
    if not all(counts.values()):
        fail(f"a probe kernel was not launched by the tools: {counts}")
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    fits = {kb * 1024: ok for kb, ok in probe["smem_kb"].items()}
    top = max((b for b, ok in fits.items() if ok), default=None)
    if top != optin or any(ok != (b <= optin) for b, ok in fits.items()):
        fail(f"P1's sweep {probe['smem_kb']} does not stop at the card's "
             f"opt-in {optin} B a block")
    print(f"P1 boundary {top} B a block = shared_memory_per_block_optin; "
          f"clusters of {top} B blocks: {probe['cluster']}")
    if not probe["cluster"].get(1):
        fail("P1 refused a cluster of one block at the opt-in size")
    rates = [r["gflops"] for r in fma[4096] + fma[8192]]
    rates += [probe["library_matmul_gflops"]]
    if max(rates) > PEAK_CAP * PEAK_FLOPS / 1e9:
        fail(f"a probe rate {max(rates):.0f} GFLOP/s is above "
             f"{PEAK_CAP} x the float32 peak: a loop was shortened")
    # P5 runs three TF32 products for each float32-accurate one
    if 3 * probe["matmul_gflops"] > PEAK_CAP * PEAK_TF32 / 1e9:
        fail(f"P5's TF32 rate {3 * probe['matmul_gflops']:.0f} GFLOP/s is "
             f"above {PEAK_CAP} x the TF32 peak: a loop was shortened")
    for lo, hi in zip(fma[4096], fma[8192]):
        ratio = hi["wall_us"] / lo["wall_us"]
        print(f"FMA ({lo['d']}, {lo['batch']}) chains {lo['chains']}: "
              f"{lo['wall_us']:.3f} us at 4096 iters, {hi['wall_us']:.3f} us "
              f"at 8192: {ratio:.3f}x")
        if not FMA_RATIO[0] <= ratio <= FMA_RATIO[1]:
            fail(f"doubling the FMA iterations took {ratio:.3f}x the time, "
                 f"outside {FMA_RATIO}")
    if not probe["dot3d_ok"]:
        fail(f"P4 disagrees with its plain version: {probe['dot3d_err']:.3e}")
    return counts


def _spin_cycles_per_ms() -> float:
    """Cycles of torch.cuda._sleep a millisecond of the device's clock
    (median of 5 spins of the tools' length)."""
    rates = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(tools_common.SPIN_CYCLES)
        end.record()
        end.synchronize()
        rates.append(tools_common.SPIN_CYCLES / start.elapsed_time(end))
    return float(np.median(rates))


def _enqueue_ms(fn) -> float:
    """The host's time to enqueue one fn() on an idle stream (the largest of
    3 calls)."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return max(times)


def _spun_ms(fn, cycles: int) -> tuple[float, bool]:
    """One call's device time behind a spin kernel of ``cycles``, and
    whether the spin was still running when the host had enqueued the call
    (else the events may hold host time)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    fn()
    end.record()
    hidden = not start.query()
    end.synchronize()
    return start.elapsed_time(end), hidden


def _spun_pairs(kernel, library, cycles: int) -> tuple[list, list, int]:
    """PAIRS pairs of (kernel, library) calls in turns, each behind a spin
    of ``cycles``: each call's ms and the count of calls whose enqueue
    outlasted the spin."""
    ks, ls, exposed = [], [], 0
    for i in range(PAIRS):
        order = ((kernel, ks), (library, ls))
        for fn, out in (order if i % 2 == 0 else order[::-1]):
            ms, hidden = _spun_ms(fn, cycles)
            out.append(ms)
            exposed += not hidden
    return ks, ls, exposed


def phase_pairs(pairs: dict, smi: str) -> dict:
    """Each kernel against its library call, PAIRS pairs in turns after a
    warm-up, each call behind a spin kernel that outlasts the host's
    enqueue of either call (twice the longer enqueue, at least the tools'
    SPIN_CYCLES; doubled while any call's enqueue outlasted it, up to 4
    times); returns {key: (kernel median ms, library median ms, median
    ratio, least ratio, largest ratio)}."""
    rate = _spin_cycles_per_ms()
    out = {}
    for key, (kernel, library, what) in pairs.items():
        kernel()
        library()
        enqueue = max(_enqueue_ms(kernel), _enqueue_ms(library))
        cycles = max(tools_common.SPIN_CYCLES, int(2 * enqueue * rate))
        for _ in range(4):
            ks, ls, exposed = _spun_pairs(kernel, library, cycles)
            if not exposed:
                break
            cycles *= 2
        ratios = [k / lib for k, lib in zip(ks, ls)]
        out[key] = (float(np.median(ks)), float(np.median(ls)),
                    float(np.median(ratios)), min(ratios), max(ratios))
        print(f"pairs {key} against {what} ({smi}; {PAIRS} pairs in turns, "
              f"each call behind a {cycles}-cycle spin, {cycles / rate:.3f} "
              f"ms at {rate:.0f} cycles a ms; host enqueue up to "
              f"{enqueue:.3f} ms; {exposed} of {2 * PAIRS} calls enqueued "
              f"past the spin): kernel median {out[key][0]:.4f} ms, library "
              f"median {out[key][1]:.4f} ms; kernel / library median "
              f"{out[key][2]:.3f}, range {out[key][3]:.3f}-{out[key][4]:.3f}")
    return out


def phase_in_order_bits(dev) -> None:
    """P4 at the tools' shape against in_order_matmul, the sum in order
    over k from zero with one FMA a term: the bits of P4's first design,
    which summed so. Equal, or the run fails. P5 no longer sums so: its
    products run on the tensor cores as 3xTF32, held to plain within
    TF32_TOL and to its own bits call after call in phase 29."""
    pk = probe_kernels
    gen = torch.Generator(device=dev).manual_seed(SEED + 34)
    m = DOT3D_SHAPE[1]
    g = torch.randn((m, m), generator=gen, device=dev)
    x = torch.rand(DOT3D_SHAPE, generator=gen, device=dev)
    got, want = pk.dot3d_probe(g, x), pk.in_order_matmul(g, x)
    diff = (got - want).abs().max().item()
    print(f"P4 at the tools' shape against the in-order FMA sum: "
          f"{'the same bits' if torch.equal(got, want) else diff}")
    if not torch.equal(got, want):
        fail(f"P4 is not the in-order FMA sum: max |diff| {diff:.3e}")


def phase_probe_times(dev, smi: str) -> tuple[dict, dict, dict]:
    """The probe kernels beside their plain versions, their bounds and, for
    P1-P5, the library yardstick, at the tools' shapes; and those five's
    calls with their library calls for phase_pairs."""
    pk = probe_kernels
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    times, library = {}, {}
    f32 = 4
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    x = x8 = torch.rand((8, 128), generator=gen, device=dev)
    times["smem"] = _paired_ms(
        lambda: pk.smem_probe(x, optin // pk.ROW_BYTES * pk.ROW_BYTES),
        lambda: pk.smem_probe_plain(x, optin)) + _bound(
            x.numel(), 2 * x.numel() * f32)
    library["smem"] = min(_median_ms(lambda: torch.add(x, x))
                          for _ in range(2))
    n = PROBE_ITERS
    x = torch.rand(PROBE_SHAPE, generator=gen, device=dev)
    y = torch.empty(PROBE_SHAPE[::-1], device=dev)
    z = torch.empty_like(x)

    def library_transpose():
        src = x
        for _ in range(n):
            torch.mul(src.t(), 1.000001, out=y)
            z.copy_(y.t())
            src = z

    library_transpose()
    if not torch.equal(z, pk.transpose_probe_plain(x, n)):
        fail("P2's library formulation is not the probe")
    times["transpose"] = _paired_ms(
        lambda: pk.transpose_probe(x, n),
        lambda: pk.transpose_probe_plain(x, n)) + _bound(
            n * x.numel(), 2 * x.numel() * f32)
    library["transpose"] = min(_median_ms(library_transpose)
                               for _ in range(2))
    clock = tools_common.max_sm_clock_mhz(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    moved = 2 * n * 2 * x.numel() * f32  # each transpose reads and writes
    floor = 1e3 * moved / (sms * 128 * clock * 1e6)
    spun = tools_common.median_ms(lambda: pk.transpose_probe(x, n), dev)
    print(f"P2 ({smi}): {spun:.4f} ms behind a spin (median of 20); "
          f"shared-memory floor {floor:.4f} ms (2 x {n} transposes x "
          f"{moved / (2 * n) / 1e6:.2f} MB at 128 B a clock on {sms} SMs at "
          f"{clock:.0f} MHz, clocks.max.sm), {floor / spun:.2f} of it; DRAM "
          f"bound {times['transpose'][2]:.3e} ms; plan (strip, blocks, "
          f"smem bytes) {pk.transpose_plan(*PROBE_SHAPE)}")
    xr = torch.rand(PROBE_SHAPE[::-1], generator=gen, device=dev)
    ya = torch.empty(PROBE_SHAPE, device=dev)
    yb = torch.empty_like(xr)

    def library_reshape():
        # a step as torch.mul on the contiguous views: 2 n calls
        src = xr
        for _ in range(n):
            torch.mul(src.view(PROBE_SHAPE), 1.000001, out=ya)
            torch.mul(ya.view(xr.shape), 0.999999, out=yb)
            src = yb

    library_reshape()
    if not torch.equal(yb, pk.reshape_probe_plain(xr, n)):
        fail("P3's library formulation is not the probe")
    # 2 n multiplies an element, each one lane-slot of the FMA pipes, which
    # the float32 peak counts as an FMA's two flops
    muls = 2 * n * xr.numel()
    times["reshape"] = _paired_ms(
        lambda: pk.reshape_probe(xr, n),
        lambda: pk.reshape_probe_plain(xr, n)) + _bound(
            2 * muls, 2 * xr.numel() * f32)
    library["reshape"] = min(_median_ms(library_reshape) for _ in range(2))
    print(f"P3 bound ({smi}): {muls:.4e} multiplies ({2 * n} an element), "
          f"each one FMA lane-slot, two flops of the {PEAK_FLOPS / 1e12:.0f}"
          f" TFLOP/s float32 peak: {times['reshape'][2]:.4e} ms; at "
          f"{clock:.0f} MHz clocks.max.sm, 128 lanes x {sms} SMs: "
          f"{1e3 * muls / (128 * sms * clock * 1e6):.4e} ms; plan (elements "
          f"a thread, blocks, threads) {pk.reshape_plan(xr.numel(), sms)}")
    m, cols = PROBE_SHAPE
    g = wide_probe.orthogonal(m, dev, SEED + 33)
    xm = torch.rand(PROBE_SHAPE, generator=gen, device=dev)
    flops = 2 * m * m * cols * n
    times["matmul2"] = _paired_ms(
        lambda: pk.matmul2_probe(g, xm, n),
        lambda: pk.matmul2_probe_plain(g, xm, n)) + bound_tf32(
            flops, (m * m + 2 * m * cols) * f32)
    library["matmul2"] = min(
        _median_ms(lambda: [torch.matmul(g, xm) for _ in range(n)])
        for _ in range(2))
    print(f"P5 bound ({smi}): three TF32 products of {flops:.4e} flops at "
          f"{PEAK_TF32 / 1e12:.0f} TFLOP/s: {times['matmul2'][2]:.4e} ms; "
          f"float32 on the CUDA cores at {PEAK_FLOPS / 1e12:.0f}: "
          f"{_bound(flops, 0)[0]:.4e} ms; plan (columns a block, blocks, "
          f"threads, smem bytes) {pk.matmul2_plan(m, cols)}")
    a, m3, w3 = DOT3D_SHAPE
    g3 = torch.randn((m3, m3), generator=gen, device=dev)
    x3 = torch.rand(DOT3D_SHAPE, generator=gen, device=dev)
    times["dot3d"] = _paired_ms(
        lambda: pk.dot3d_probe(g3, x3),
        lambda: pk.dot3d_probe_plain(g3, x3)) + _bound(
            2 * a * m3 * m3 * w3, (m3 * m3 + 2 * x3.numel()) * f32)
    library["dot3d"] = min(_median_ms(lambda: torch.matmul(g3, x3))
                           for _ in range(2))
    d, b, iters, chains = FMA_TIMED
    xf = torch.rand((d, b), generator=gen, device=dev)
    yf = torch.rand((d, b), generator=gen, device=dev)
    # the recurrence's FMAs, the chains' first scales and the fold
    times["fma"] = _paired_ms(
        lambda: pk.fma_ceiling(xf, yf, iters, chains),
        lambda: pk.fma_ceiling_plain(xf, yf, iters, chains)) + _bound(
            d * b * (2 * iters * chains + 2 * chains - 1), 3 * d * b * f32)
    # P1 (at the opt-in and at the least scratch), P2-P5 against their
    # library calls, paired in phase_pairs
    top = optin // pk.ROW_BYTES * pk.ROW_BYTES
    pairs = {
        f"probe smem {top} B": (lambda: pk.smem_probe(x8, top),
                                lambda: torch.add(x8, x8), "torch.add(x, x)"),
        f"probe smem {pk.MIN_SMEM_BYTES} B": (
            lambda: pk.smem_probe(x8, pk.MIN_SMEM_BYTES),
            lambda: torch.add(x8, x8), "torch.add(x, x)"),
        "probe transpose": (lambda: pk.transpose_probe(x, n),
                            library_transpose,
                            "a strided torch.mul and a copy a step"),
        "probe reshape": (lambda: pk.reshape_probe(xr, n), library_reshape,
                          f"{2 * n} torch.mul on the contiguous views"),
        "probe dot3d": (lambda: pk.dot3d_probe(g3, x3),
                        lambda: torch.matmul(g3, x3), "torch.matmul"),
        # printed only: the cluster route at the opt-in
        f"probe smem {top} B in clusters of 2": (
            lambda: pk.smem_probe(x8, top, 2), lambda: torch.add(x8, x8),
            "torch.add(x, x)"),
        "probe matmul2": (lambda: pk.matmul2_probe(g, xm, n),
                          lambda: [torch.matmul(g, xm) for _ in range(n)],
                          f"{n} torch.matmul"),
    }
    for key, (kern, plain, bound, by) in times.items():
        lib = library.get(key)
        print(f"times probe {key} ({smi}): kernel {kern:.4f} ms, plain "
              f"{plain:.4f} ms ({_HOW}), library "
              f"{'-' if lib is None else f'{lib:.4f} ms'}; bound "
              f"{bound:.3e} ms ({by}), kernel at {bound / kern:.2e} of it")
    return times, library, pairs


def _exact(counts: dict, want: dict, what: str) -> None:
    """Fails unless ``counts`` hold exactly ``want`` launches of each of
    its counters and none of any other kernel (dg's batch sums, helper
    launches after #2, #4 or #6, are not held here)."""
    others = {c: n for c, n in counts.items()
              if n and c not in want and not c.endswith("_sums")}
    wrong = {c: (counts[c], n) for c, n in want.items() if counts[c] != n}
    if wrong or others:
        fail(f"{what}: launches (counted, wanted) {wrong}, other counters "
             f"{others}")


def _rates(printed: str) -> tuple[list, list]:
    """The training and sampling images/s a driver printed."""
    train = [float(v) for v in re.findall(
        r"trained \d+ epochs in [0-9.]+s incl\. set-up \(([0-9.]+) "
        r"images/s\)", printed)]
    sample = [float(v) for v in re.findall(
        r"sampled \d+ images x \d+ iterations on \S+ in [0-9.]+ s "
        r"\(([0-9.]+) images/s\)", printed)]
    return train, sample


def _run_driver(tmp: pathlib.Path, module, argv: list) -> tuple:
    """``module.main(argv)`` in ``tmp`` from counts of 0; returns its
    results, launch counts and printed output."""
    printed = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(printed), contextlib.chdir(tmp):
        results = module.main(argv)
    counts = read_counts()
    print(printed.getvalue().strip())
    return results, counts, printed.getvalue()


def _driver_scores(name: str, results: dict, labels: int,
                   psnr_cos: bool) -> None:
    """Each model's scores: ``labels`` finite SSIM values, and PSNR and
    cosine finite, or NaN under a protocol without them."""
    for model, entry in results.items():
        print(f"{name} {model}: SSIM {entry['ssim']}, PSNR {entry['psnr']}, "
              f"cosine {entry['cos']}, epoch losses {entry['loss']}")
        others = entry["psnr"] + entry["cos"]
        if (len(entry["ssim"]) != labels
                or not all(math.isfinite(v) for v in entry["ssim"])
                or not all(math.isfinite(v) == psnr_cos for v in others)):
            fail(f"{name} {model}: scores {entry}")


def phase_rebuttal(tmp: pathlib.Path, smi: str) -> dict:
    """Phase 39: fruit_360 (three labels, 64x64, Qdense at 12 wires) and
    bloodmnist (one label, 28x28, Qdense at 10 wires) through their
    drivers on cuda with their default models, then each Qdense width's
    training held against the CPU step by step and its sampling held
    iteration by iteration. Returns the launch counts of the drivers'
    runs."""
    t_phase = time.perf_counter()
    for w in (10, 12):
        plan = sel_kernel.sel_bwd_plan(w, TAU)
        smem = gate_kernel._library().sel_chain_bwd_smem_bytes(
            w, 60, plan.samples, 0)
        print(f"rebuttal: #6 at (w={w}, B={TAU}, depth 60, cnot) takes "
              f"{smem} B of shared memory a CTA (limit "
              f"{gate_kernel._MAX_SMEM_BYTES}); {_sel_plan_line(w, TAU)}")
    runs = {}
    for module, labels, side in ((fruit_360, 3, 64), (bloodmnist, 1, 28)):
        name = module.__name__.rsplit(".", 1)[-1]
        argv = ["--ds-size", str(REBUTTAL_DS), "--epochs", "1", "--device",
                "cuda", "--save-path", f"{tmp}/{name}_", "--load-path",
                f"{tmp}/{name}_"]
        results, counts, printed = _run_driver(tmp, module, argv)
        args = module.parse_args([])
        qdense, ll = args.model
        if (qdense[:3] != ["QDenseUndirected_old_noise", "60", str(side)]
                or ll[:2] != ["QIDDM_LL_noise", str(side * side)]):
            fail(f"{name}'s default models are {args.model}")
        sizes = re.findall(r"After augmentation, x_train shape: \((\d+),",
                           printed)
        if sizes != [str(REBUTTAL_AUGMENTED)] * labels:
            fail(f"{name}: augmented training sets {sizes}")
        steps = labels * REBUTTAL_AUGMENTED
        iters = labels * REBUTTAL_ITERS
        _exact(counts, {"sel": steps + iters, "sel_bwd": steps,
                        "gate": 2 * (steps + iters), "gate_bwd": 2 * steps},
               f"{name}: {steps} steps and {iters} sampling iterations of "
               f"each model")
        plan = sel_kernel.sel_bwd_plan(12 if side == 64 else 10, TAU)
        if counts["sel_bwd_sums"] != (0 if plan.in_launch else steps):
            fail(f"{name}: {counts['sel_bwd_sums']} second launches for "
                 f"#6's dg batch sum in {steps} steps, against the plan "
                 f"{plan}")
        _driver_scores(name, results, labels, psnr_cos=False)
        train, sample = _rates(printed)
        print(f"rebuttal {name} ({smi}): training {train} images/s (a model "
              f"a label, Qdense first; batch 1, tau {TAU}, "
              f"{REBUTTAL_AUGMENTED} images, first epoch incl. set-up), "
              f"sampling {sample} images/s ({DRIVER_IMAGES} images x "
              f"{REBUTTAL_ITERS} iterations); launches {counts}")
        runs[name] = counts
        # the Qdense width held against the CPU: 3 training steps on the
        # driver's data, its sampling iteration by iteration
        x_all, _, _, _ = common.load_dataset(
            module.parse_args(["--ds-size", str(REBUTTAL_DS)]))
        x = torch.as_tensor(x_all[:3], dtype=torch.float32).reshape(3, 1, -1)
        _, parity = phase_train_parity(tmp, qdense, 1, x=x)
        _exact(parity, {"sel": 3, "sel_bwd": 3},
               f"{' '.join(qdense)}'s 3 held steps")
        with torch.no_grad():
            phase_sample(tmp, qdense, side, "sel", 1, 3)
    print(f"rebuttal phase wall {time.perf_counter() - t_phase:.1f} s "
          f"({smi})")
    return runs


def write_letters(data_dir: pathlib.Path) -> None:
    """A seeded stand-in for EMNIST letters: 520 28x28 uint8 images,
    labels 0-25 in turn, as ``emnist_letters_28.npz``."""
    rng = np.random.default_rng(SEED + 9)
    x = (rng.uniform(size=(520, 28, 28)) ** 2 * 255).astype(np.uint8)
    np.savez(data_dir / "emnist_letters_28.npz", x=x, y=np.arange(520) % 26)


def phase_exm(tmp: pathlib.Path, smi: str) -> dict:
    """Phase 40: fashion_exm and emnist_exm at their defaults but 1 epoch
    on cuda (both default models), emnist_exm under --profile. Returns the
    launch counts of the runs."""
    write_letters(tmp / "data")
    runs = {}
    for module, data, label, classes, iters in (
            (fashion_exm, "fashion_28.npz", 4, 10, 2 * TAU),
            (emnist_exm, "emnist_letters_28.npz", 2, 26, 5)):
        name = module.__name__.rsplit(".", 1)[-1]
        argv = ["--epochs", "1", "--device", "cuda", "--save-path",
                f"{tmp}/{name}_", "--load-path", f"{tmp}/{name}_"]
        trace = tmp / f"{name}_trace"
        if module is emnist_exm:
            argv += ["--profile", str(trace)]
        results, counts, printed = _run_driver(tmp, module, argv)
        z = np.load(tmp / "data" / data)
        n_label = int((z["y"][:500] == label).sum())
        steps = int(n_label * 0.8)
        if z["y"].max() + 1 != classes:
            fail(f"{data} holds {z['y'].max() + 1} classes")
        _exact(counts, {"gate": 2 * (steps + iters), "gate_bwd": 2 * steps,
                        "sel": steps + iters, "sel_bwd": steps},
               f"{name}: {steps} steps and {iters} sampling iterations of "
               f"each default model")
        _driver_scores(name, results, 1, psnr_cos=True)
        train, sample = _rates(printed)
        print(f"{name} ({smi}): training {train} images/s (batch 1, tau "
              f"{TAU}, {steps} images, first epoch incl. set-up), sampling "
              f"{sample} images/s ({DRIVER_IMAGES} images x {iters} "
              f"iterations); launches {counts}")
        if module is emnist_exm:
            traces = sorted(trace.glob("trace_*.json"))
            if len(traces) != 2:  # one a model's training run
                fail(f"--profile wrote {traces}")
            names = {e.get("name", "") for t in traces
                     for e in json.loads(t.read_text())["traceEvents"]}
            kernels = sorted(n for n in names if "chain" in n)
            print(f"{name} --profile: {len(traces)} Chrome traces, the "
                  f"chain kernels named: {kernels}")
            for k in ("gate_chain_fwd", "gate_chain_bwd"):
                if not any(k in n for n in names):
                    fail(f"the --profile trace names no {k} kernel")
        runs[name] = counts
    return runs


def _check_trials(root: pathlib.Path, trials: int, epochs: int,
                  stopped: int) -> list:
    """The tune_results artifacts of one sweep group: ``trials`` trial
    directories with params.json, result.json (SWEEP_RESULT_KEYS) and
    progress.csv, ``stopped`` of them stopped by a rung at epoch 1, the
    others trained ``epochs`` epochs with a checkpoint the sampling CLI's
    loader reads. Returns the results."""
    dirs = sorted(p for p in root.iterdir() if p.is_dir())
    recs = []
    for td in dirs:
        params = json.loads((td / "params.json").read_text())
        rec = json.loads((td / "result.json").read_text())
        lines = (td / "progress.csv").read_text().splitlines()
        ckpts = list(td.glob("*.pt"))
        if (set(rec) != SWEEP_RESULT_KEYS
                or set(params) != {"lr", "batch_size", "epochs", "T"}
                or lines[0] != "training_iteration,loss"
                or len(lines) - 1 != rec["training_iteration"]
                or not math.isfinite(rec["loss"])
                or not math.isfinite(rec["ssim"])
                or len(ckpts) != (0 if rec["early_stopped"] else 1)):
            fail(f"sweep artifacts of {td}: {params}, {rec}, {lines[:2]}, "
                 f"{ckpts}")
        if ckpts:
            load_checkpoint(ckpts[0])["model_state_dict"]
        recs.append(rec)
    its = sorted(r["training_iteration"] for r in recs)
    want = sorted([1] * stopped + [epochs] * (trials - stopped))
    if len(dirs) != trials or its != want:
        fail(f"sweep {root}: {len(dirs)} trials trained {its} epochs, want "
             f"{want}")
    return recs


def phase_ray(tmp: pathlib.Path, n_train: int, smi: str) -> dict:
    """Phase 41: mnist_ray at full width on cuda: one group of 4 trials at
    L 14 for 2 epochs (the halving at epoch 1 keeps one), then 4 trials at
    L 16 for 1 epoch; trial 0 of the first held against the CPU. A
    training step's batch (8 images x tau 10 = 80 rows) is at least
    2^6, so the engine composes each block's unitaries (no port kernel,
    as the JAX package composes them); the scoring's 15 rows run #1.
    Returns the launch counts of the two runs."""
    t_phase = time.perf_counter()
    steps_epoch = -(-n_train // SWEEP_BATCH)
    runs = {}
    for L, epochs, trials, kept in ((14, 2, 4, 1), (16, 1, 4, 4)):
        local = tmp / f"tune_L{L}"
        argv = ["--num-samples", str(trials), "--L-min", str(L), "--L-max",
                str(L), "--epochs", str(epochs), "--device", "cuda",
                "--local-dir", str(local)]
        (rows, best), counts, printed = _run_driver(tmp, mnist_ray, argv)
        args = mnist_ray.parse_args(argv)
        if (args.hidden, args.N, args.batch_size, args.tau) != (6, 2,
                                                                SWEEP_BATCH,
                                                                TAU):
            fail(f"mnist_ray's defaults {args}")
        if len(rows) != trials or best["ssim"] != max(r["ssim"]
                                                      for r in rows):
            fail(f"mnist_ray rows {rows}, best {best}")
        # every trial trains the first segment; the kept ones the rest
        steps = steps_epoch * (trials + kept * (epochs - 1))
        scored = SWEEP_SCORE_ITERS * (trials + (kept if epochs > 1 else 0))
        _exact(counts, {"gate": 2 * scored, "gate_bwd": 0},
               f"mnist_ray L={L}: {steps} steps on the composed-unitary "
               f"route and {scored} scoring iterations")
        recs = _check_trials(local / f"train_mnist28_L{L}", trials, epochs,
                             trials - kept)
        walls = re.findall(r"trained epochs \d+-\d+ one after another on "
                           r"\S+ in ([0-9.]+) s \(([0-9.]+) training "
                           r"images/s\)", printed)
        print(f"mnist_ray L={L} (L*k = {2 * L}; {smi}): {trials} trials, "
              f"{epochs} epoch(s), kept {kept}; segments (wall s, training "
              f"images/s incl. scoring set-up) {walls}; results "
              f"{[(r['loss'], r['ssim'], r['early_stopped']) for r in recs]};"
              f" launches {counts}")
        runs[f"L{L}"] = counts
    # trial 0 of the L 14 group: its seed (--seed + 0) and learning rate
    trial0 = next((tmp / "tune_L14" / "train_mnist28_L14").glob(
        "trial_00000_*"))
    lr = json.loads((trial0 / "params.json").read_text())["lr"]
    seed = mnist_ray.parse_args([]).seed
    _, parity = phase_train_parity(tmp, MODEL, SWEEP_BATCH, lr, seed=seed)
    _exact(parity, {"gate": 0, "gate_bwd": 0}, "the sweep's 3 held steps")
    print(f"mnist_ray phase wall {time.perf_counter() - t_phase:.1f} s "
          f"({smi})")
    return runs


def _routes(counts: dict) -> dict:
    """The route counters of ``counts`` that moved."""
    return {c[len("route_"):]: n for c, n in counts.items()
            if c.startswith("route_") and n}


def _kernels(counts: dict) -> dict:
    """The kernel launch counters of ``counts`` that moved."""
    return {c: n for c, n in counts.items()
            if n and not c.startswith("route_")}


def phase_wide_qnn(tmp: pathlib.Path, n_train: int, smi: str) -> tuple:
    """Phase 42: QNN_noise 784 16 14, past the SEL chain's 12 wires, trained
    through mnist_exm for one epoch and sampled through the CLI on
    ``wide.sel_chain_wide``; returns the training and sampling counts and
    images/s."""
    t0 = time.perf_counter()
    counts, rates = phase_train(tmp, n_train, [QNN16], {"route_wide": 1},
                                default=False, prefix="qnn16_", epochs=1)
    if _kernels(counts) or set(_routes(counts)) != {"wide"}:
        fail(f"QNN_noise at 16 wires trained with launches {counts}: not on "
             f"the grouped chain alone")
    with torch.no_grad():
        sampled, rate = phase_sample(tmp, QNN16, 28, "route_wide", 1, 0)
    if _kernels(sampled) or set(_routes(sampled)) != {"wide"}:
        fail(f"QNN_noise at 16 wires sampled with launches {sampled}")
    _, parity = phase_train_parity(tmp, QNN16, 1)
    if _kernels(parity):
        fail(f"QNN_noise's held steps launched {_kernels(parity)}")
    train_rate = rates[QNN16[0]]
    print(f"phase 42 {' '.join(QNN16)}: sel_chain_wide at 16 wires, no #5/#6 "
          f"launch; training {train_rate:.1f} images/s in its first epoch "
          f"(batch 1, tau {TAU}), sampling {rate:.1f} images/s ({N} images x "
          f"{ITERS} iterations a batch); phase wall "
          f"{time.perf_counter() - t0:.1f} s ({smi})")
    return counts, sampled, train_rate, rate


def phase_wide_pl(tmp: pathlib.Path, n_train: int, smi: str) -> tuple:
    """Phase 43: QIDDM_PL_noise1 784 12 6 2 at batch 8 (80 rows < 2^12):
    past the RY chain's 10 wires, the grouped chain's RY encode; trained
    through mnist_exm for one epoch, sampled and held step by step (the
    PCA is refit on every batch)."""
    t0 = time.perf_counter()
    counts, rates = phase_train(tmp, n_train, [PL12], {"route_wide": 2},
                                default=False, prefix="pl12_", epochs=1,
                                batch=PL12_BATCH)
    if _kernels(counts) or set(_routes(counts)) != {"wide"}:
        fail(f"QIDDM_PL_noise1 at 12 wires trained with launches {counts}: "
             f"not on the grouped chain alone")
    with torch.no_grad():
        sampled, rate = phase_sample(tmp, PL12, 28, "route_wide", 2, ITERS,
                                     shared_fit=True)
    if _kernels(sampled) or set(_routes(sampled)) != {"wide"}:
        fail(f"QIDDM_PL_noise1 at 12 wires sampled with launches {sampled}")
    _, parity = phase_train_parity(tmp, PL12, PL12_BATCH)
    if _kernels(parity):
        fail(f"QIDDM_PL_noise1's held steps launched {_kernels(parity)}")
    train_rate = rates[PL12[0]]
    print(f"phase 43 {' '.join(PL12)}: the RY grouped chain at 12 wires, no "
          f"#3/#4 launch; training {train_rate:.1f} images/s in its first "
          f"epoch (batch {PL12_BATCH}, tau {TAU}), sampling {rate:.1f} "
          f"images/s; phase wall {time.perf_counter() - t0:.1f} s ({smi})")
    return counts, sampled, train_rate, rate


def _block_step(x, tgt, imprimitive: str):
    """bench_wide_reupload's step: the block's PauliZ readout, the MSE to
    ``tgt``, autograd and an SGD step at 0.01. Returns (new weights, loss,
    gradient)."""
    def step(w):
        w = w.detach().requires_grad_(True)
        out = engine.reupload_block(x, w, encode="rz",
                                    imprimitive=imprimitive,
                                    readout="expvalz")
        loss = ((out - tgt) ** 2).mean()
        loss.backward()
        return (w - 0.01 * w.grad).detach(), loss.detach(), w.grad
    return step


def _block_inputs(wires, L, k, b, device="cuda"):
    gen = torch.Generator().manual_seed(SEED)
    w = (torch.randn((L, k, wires, 3), generator=gen) * 0.4).to(device)
    x = torch.rand((b, wires), generator=gen).to(device)
    tgt = torch.rand((b, wires), generator=gen).to(device)
    return w, x, tgt


def _timed_steps(step, w, n: int) -> tuple:
    """``n`` steps after a warm one, from counts of 0; returns (weights,
    losses, counts, wall s, peak device bytes in the timed steps)."""
    w, _, _ = step(w)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(n):
        w, loss, _ = step(w)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    return (w, [v.item() for v in losses], counts, wall,
            torch.cuda.max_memory_allocated())


def phase_wide_block(smi: str) -> tuple:
    """Phase 44: bench_wide_reupload's block at 22 wires on the grouped
    chain (steps/s, peak memory, the CPU hold at L 1, k 1, batch 1, TF32
    off) and a CNOT ring at 16 wires on the grouped and the per-gate
    adjoint chains."""
    t0_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on for float32 products: the grouped chain would "
             "round its products to TF32")
    wires, L, k, b = WIDE22
    w, x, tgt = _block_inputs(wires, L, k, b)
    base = torch.cuda.memory_allocated()
    w_end, losses, counts, wall, peak = _timed_steps(
        _block_step(x, tgt, "cz"), w, WIDE22_STEPS)
    state = b * 2**wires * 8
    rate = WIDE22_STEPS / wall
    print(f"phase 44 wide block w={wires} (L={L}, k={k}, batch {b}, RZ, CZ, "
          f"PauliZ, MSE, SGD 0.01): {WIDE22_STEPS} steps in {wall:.3f} s, "
          f"{rate:.3f} steps/s; losses {losses[0]:.6f} -> {losses[-1]:.6f}; "
          f"peak device memory {peak / 2**20:.1f} MiB = {peak / state:.2f} "
          f"states of {state / 2**20:.1f} MiB ({(peak - base) / state:.2f} "
          f"above the {base / 2**20:.1f} MiB held before the steps; autograd "
          f"through the gates would keep L*k*w = {L * k * wires}); launches "
          f"{counts} ({smi})")
    if not all(math.isfinite(v) for v in losses):
        fail(f"the {wires}-wire block's losses are not finite: {losses}")
    if _kernels(counts) or _routes(counts) != {"wide": WIDE22_STEPS}:
        fail(f"the {wires}-wire block ran {counts}, not {WIDE22_STEPS} "
             f"grouped chains and no kernel")
    if not peak <= WIDE22_STATES * state:
        fail(f"the {wires}-wire step's peak device memory {peak} B is above "
             f"{WIDE22_STATES} states ({WIDE22_STATES * state} B)")
    # the same block at L 1, k 1, batch 1 against the CPU plain path in
    # float64 (the readout sums 2^22 float32 terms: the CPU's own float32
    # sum is printed beside as its floor)
    outs, grads = {}, {}
    for dev, x64 in (("cuda", False), ("cpu", False), ("cpu", True)):
        dtype = torch.float64 if x64 else torch.float32
        ww = w[:1, :1].detach().to(dev, dtype).requires_grad_(True)
        config.enable_x64(x64)
        try:
            out = engine.reupload_block(x[:1].to(dev, dtype), ww,
                                        readout="expvalz")
            ((out - tgt[:1].to(dev, dtype)) ** 2).mean().backward()
        finally:
            config.enable_x64(False)
        outs[dev, x64] = out.detach().cpu().double()
        grads[dev, x64] = ww.grad.cpu().double()
    exact = ("cpu", True)
    fwd_err = (outs["cuda", False] - outs[exact]).abs().max().item()
    floor = (outs["cpu", False] - outs[exact]).abs().max().item()
    grad_err = _rel(grads["cuda", False], grads[exact])
    with torch.no_grad(), _tf32():
        control = (engine.reupload_block(x[:1], w[:1, :1], readout="expvalz")
                   .cpu().double() - outs[exact]).abs().max().item()
    print(f"phase 44 wide block w={wires} at L 1, k 1, batch 1 against the "
          f"CPU plain path's float64: forward max|diff| {fwd_err:.3e} (held "
          f"within {KERNEL_TOL}; the CPU's float32 {floor:.3e}), gradient "
          f"max|diff| / max(1, max|cpu|) {grad_err:.3e} (within "
          f"{TRAIN_TOL}); control, the card's forward with TF32 on, "
          f"{control:.3e}")
    if not control > KERNEL_TOL:
        fail(f"phase 44's control passed the hold: the card's forward with "
             f"TF32 on lies {control:.3e} <= {KERNEL_TOL} from float64, so "
             f"the hold cannot tell TF32 from float32")
    if not (fwd_err <= KERNEL_TOL and grad_err <= TRAIN_TOL):
        fail(f"the {wires}-wire block on the card differs from the CPU: "
             f"forward {fwd_err:.3e}, gradient {grad_err:.3e}")
    del w, w_end, x, tgt, outs, grads
    # a CNOT ring at 16 wires: the grouped chain, then the per-gate adjoint
    # chain (wide_mode "off"), from the same weights
    wires, L, k, b = CNOT16
    w, x, tgt = _block_inputs(wires, L, k, b)
    step = _block_step(x, tgt, "cnot")
    runs, rates = {}, {}
    for mode, route in (("auto", "wide"), ("off", "adjoint")):
        config.set_wide_mode(mode)
        try:
            _, loss, grad = step(w)
            torch.cuda.synchronize()
            reset_counts()
            step(w)
            one = read_counts()
            _, losses, counts, wall, _ = _timed_steps(step, w, CNOT16_STEPS)
        finally:
            config.set_wide_mode("auto")
        runs[route] = (loss.item(), grad.cpu())
        rates[route] = CNOT16_STEPS / wall
        print(f"phase 44 CNOT ring w={wires} (L={L}, k={k}, batch {b}) on "
              f"the {route} route (wide_mode {mode!r}): {rates[route]:.3f} "
              f"steps/s; launches {counts} ({smi})")
        if _kernels(one) or _routes(one) != {route: 1}:
            fail(f"the {wires}-wire CNOT block under wide_mode {mode!r} ran "
                 f"{one}, not one {route} chain and no kernel")
    loss_err = abs(runs["wide"][0] - runs["adjoint"][0])
    grad_err = _rel(runs["adjoint"][1], runs["wide"][1])
    print(f"phase 44 CNOT ring w={wires}: the per-gate adjoint chain against "
          f"the grouped chain on the card, loss |diff| {loss_err:.3e}, "
          f"gradient max|diff| / max(1, max|grouped|) {grad_err:.3e} (held "
          f"within {KERNEL_TOL}); phase wall "
          f"{time.perf_counter() - t0_phase:.1f} s")
    if not (loss_err <= KERNEL_TOL and grad_err <= KERNEL_TOL):
        fail(f"the adjoint and grouped chains differ on the card: loss "
             f"{loss_err:.3e}, gradients {grad_err:.3e}")
    return counts, rate, peak / state, rates


def phase_traj14(smi: str) -> tuple:
    """Phase 45: path A at 14 wires (bench_traj_noisy_sampling(wires=14)),
    past #5's and #7's 12: sel_apply_gates and the PyTorch
    amplitude-damping pass. Returns the launch counts, images/s and the
    CPU hold's max |diff|."""
    t0_phase = time.perf_counter()
    net = common.build_model(TRAJ14_MODEL, seed=SEED, device="cuda")
    noisy = common.with_noise(net, TRAJ_CODE, TRAJ_STRENGTH,
                              noise_trajectories=N_TRAJ)
    diff = Diffusion(noisy, prediction_goal="data", shape=(28, 28))
    gen = torch.Generator().manual_seed(SEED + 3)
    first_x = (torch.rand((TRAJ_IMAGES, 1, 28, 28), generator=gen) * 0.75
               + 0.5).to("cuda")
    walls, counts = [], None
    for _ in range(2):
        g = torch.Generator(device="cuda").manual_seed(SEED + 5)
        reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = diff.sample(first_x=first_x, n_iters=TRAJ_ITERS,
                              only_last=True, traj_rng=g)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if counts is None:
            counts = read_counts()
    rate = TRAJ_IMAGES / walls[-1]
    per_run = TRAJ_PER_ITER * TRAJ_ITERS
    print(f"phase 45 traj sample {' '.join(TRAJ14_MODEL)}: {TRAJ_IMAGES} "
          f"images x {TRAJ_ITERS} iterations x {N_TRAJ} trajectories "
          f"(amplitude damping {TRAJ_STRENGTH}; {N_TRAJ * TRAJ_IMAGES} rows "
          f"of 2^14 amplitudes) in {walls[0]:.3f} s first, {walls[1]:.3f} s "
          f"again: {rate:.2f} images/s; launches {counts} ({smi})")
    if not torch.isfinite(out).all():
        fail("the 14-wire trajectory samples are not finite")
    if _kernels(counts) or _routes(counts) != {"gates": per_run,
                                               "amp_xla": per_run}:
        fail(f"14-wire trajectory sampling ran {counts}, not {per_run} "
             f"sel_apply_gates and amplitude-damping passes and no kernel")
    # one iteration at TRAJ14_HELD trajectories, the CPU on the card's draws
    held = common.with_noise(net, TRAJ_CODE, TRAJ_STRENGTH,
                             noise_trajectories=TRAJ14_HELD)
    rec = RecordedDraws(torch.Generator(device="cuda").manual_seed(SEED + 6))
    with torch.no_grad():
        card = held(first_x, traj_rng=rec).cpu()
    cpu = common.build_model(TRAJ14_MODEL, device="cpu")
    cpu.load_state_dict(net.state_dict())
    cpu = common.with_noise(cpu, TRAJ_CODE, TRAJ_STRENGTH,
                            noise_trajectories=TRAJ14_HELD)
    t0 = time.perf_counter()
    with torch.no_grad():
        want = cpu(first_x.cpu(), traj_rng=ReplayDraws(
            [d.cpu() for d in rec.draws], [p.cpu() for p in rec.picks]))
    err = (card - want).abs().max().item()
    print(f"phase 45: one iteration at {TRAJ14_HELD} trajectories, the card "
          f"against the CPU plain path on the card's draws and picks "
          f"max|diff| {err:.3e} (held within {SAMPLE_TOL}; the CPU took "
          f"{time.perf_counter() - t0:.1f} s); phase wall "
          f"{time.perf_counter() - t0_phase:.1f} s")
    if not err <= SAMPLE_TOL:
        fail(f"14-wire trajectory sampling on the card differs from the CPU: "
             f"{err:.3e} > {SAMPLE_TOL}")
    return counts, rate, err


def phase_dm12(smi: str) -> tuple:
    """Phase 46 (a): the density-matrix backend at 12 wires, #5 on both
    sides of rho past #8's 10 wires; returns the launch counts and
    images/s."""
    t0_phase = time.perf_counter()
    net = common.build_model(DM12_MODEL, seed=SEED, device="cuda")
    noisy = common.with_noise(net, TRAJ_CODE, DM12_STRENGTH)
    diff = Diffusion(noisy, prediction_goal="data", shape=(28, 28))
    gen = torch.Generator().manual_seed(SEED + 4)
    first_x = (torch.rand((DM12_IMAGES, 1, 28, 28), generator=gen) * 0.75
               + 0.5).to("cuda")
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = diff.sample(first_x=first_x, n_iters=DM12_ITERS, only_last=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    # 2 blocks x 6 spectrum layers, the SEL chain on both sides of rho
    want_sel = 2 * 6 * 2 * DM12_ITERS
    print(f"phase 46a dm {' '.join(DM12_MODEL)}: {DM12_IMAGES} images x "
          f"{DM12_ITERS} iterations (amplitude damping {DM12_STRENGTH}; rho "
          f"{DM12_IMAGES * 4**12 * 8 / 2**20:.0f} MiB) in {wall:.3f} s, "
          f"{DM12_IMAGES / wall:.3f} images/s ({DM12_ITERS} iterations); "
          f"launches {counts} ({smi})")
    if not torch.isfinite(out).all():
        fail("the 12-wire dm samples are not finite")
    if (_kernels(counts) != {"sel": want_sel}) or _routes(counts):
        fail(f"12-wire dm sampling ran {counts}, not {want_sel} #5 launches "
             f"and nothing else")
    # one image's iteration against the same model in complex128 on the
    # card: the density matrix's SEL chains through sel_apply_gates there,
    # code apart from #5 (on the CPU plain path the iteration takes ~3 min)
    config.enable_x64(True)
    try:
        with torch.no_grad():
            exact = copy.deepcopy(noisy).double()(first_x[:1].double())
    finally:
        config.enable_x64(False)
    reset_counts()
    with torch.no_grad():
        card = noisy(first_x[:1])
    one = read_counts()
    err = (card.double() - exact).abs().max().item()
    # one spectrum layer of the block (L 1, k 2, one image) against the CPU
    # plain path: #5 on both sides of rho and the channel at 12 wires
    gen = torch.Generator().manual_seed(SEED + 9)
    wires = int(DM12_MODEL[2])
    x = torch.rand((1, wires), generator=gen)
    w = torch.randn((1, 2, wires, 3), generator=gen) * 0.4
    noise = engine.NoiseModel("amplitude_damping", DM12_STRENGTH, "encode")
    t0 = time.perf_counter()
    with torch.no_grad():
        got = engine.reupload_block(x.cuda(), w.cuda(), noise=noise).cpu()
        want = engine.reupload_block(x, w, noise=noise)
    layer_err = (got - want).abs().max().item()
    print(f"phase 46a: one image's iteration, float32 on the card (#5 "
          f"launches {one['sel']}) against complex128 on the card "
          f"(sel_apply_gates on both sides of rho) max|diff| {err:.3e} "
          f"(held within {SAMPLE_TOL}); one spectrum layer at {wires} wires "
          f"against the CPU plain path, probabilities max|diff| "
          f"{layer_err:.3e} (within {KERNEL_TOL}; "
          f"{time.perf_counter() - t0:.1f} s); phase wall "
          f"{time.perf_counter() - t0_phase:.1f} s")
    if one["sel"] != want_sel // DM12_ITERS:
        fail(f"one image's 12-wire dm iteration launched {one}")
    # #5 at the route's shape (both sides of rho: the b * d column states,
    # a spectrum layer's k = 2 layers), CUDA events over single calls
    cols = DM12_IMAGES * 2**wires
    sr, si, mats = sel_inputs(np.random.default_rng(SEED + 12), wires, cols,
                              2, "cuda")
    with torch.no_grad():
        ms = _median_ms(lambda: sel_kernel.sel_chain_planes(
            sr, si, mats, wires, "cz"))
    bound, by = bound_sel(wires, cols, 2, "cz", False)
    print(f"phase 46a: #5 at the dm route's ({wires}, {cols}, depth 2, CZ): "
          f"{ms:.4f} ms a call (median of 20, CUDA events), bound "
          f"{bound:.3e} ms ({by}), {bound / ms:.3f} of it ({smi})")
    if not (err <= SAMPLE_TOL and layer_err <= KERNEL_TOL):
        fail(f"12-wire dm on the card differs from its float64 route or the "
             f"CPU: iteration {err:.3e}, layer {layer_err:.3e}")
    return counts, DM12_IMAGES / wall


def _loss_grads64(net, x: torch.Tensor, device: str) -> tuple:
    """``net``'s training loss (tau 10, seeded noise) and gradients in
    float64 on ``device``."""
    net64 = copy.deepcopy(net).to(device, torch.float64)
    loss, _ = Diffusion(net64).train().loss_fn(
        x.to(device, torch.float64), TAU,
        generator=torch.Generator().manual_seed(SEED))
    loss.backward()
    return loss.item(), _grads(net64)


def phase_x64_qiddm_a(tmp: pathlib.Path, smi: str) -> dict:
    """Phase 46 (b): QIDDM-A (differN_noise 28 9 2) under
    config.enable_x64(True), the complex128 grouped chain at 10 wires: a
    forward and a training step's loss and gradients, the card against the
    CPU plain path in float64."""
    t0 = time.perf_counter()
    z = np.load(tmp / "data" / "mnist_28.npz")
    x = torch.as_tensor(z["x"][z["y"] == LABEL][:QIDDM_A_BATCH] / 255.0,
                        dtype=torch.float64).reshape(QIDDM_A_BATCH, -1)
    net = common.build_model(QIDDM_A, seed=SEED, device="cpu")
    config.enable_x64(True)
    try:
        with torch.no_grad():
            fwd = {dev: copy.deepcopy(net).to(dev, torch.float64)(
                x.reshape(-1, 1, 28, 28).to(dev)).cpu()
                for dev in ("cuda", "cpu")}
        reset_counts()
        card_loss, card = _loss_grads64(net, x, "cuda")
        counts = read_counts()
        cpu_loss, cpu = _loss_grads64(net, x, "cpu")
    finally:
        config.enable_x64(False)
    fwd_err = (fwd["cuda"] - fwd["cpu"]).abs().max().item()
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_err = _grad_err(card, cpu)
    print(f"phase 46b QIDDM-A {' '.join(QIDDM_A)} in complex128 (the grouped "
          f"chain at 10 wires): forward of {QIDDM_A_BATCH} images max|diff| "
          f"{fwd_err:.3e} (held within {X64_TOL}); a training step (tau "
          f"{TAU}), loss relative {loss_err:.3e}, gradients max relative "
          f"{grad_err:.3e} (within {GRAD64_TOL}); launches {counts}; "
          f"{time.perf_counter() - t0:.1f} s ({smi})")
    if _kernels(counts) or set(_routes(counts)) != {"wide"}:
        fail(f"QIDDM-A in complex128 ran {counts}, not the grouped chain "
             f"alone")
    if not (fwd_err <= X64_TOL and loss_err <= X64_TOL
            and grad_err <= GRAD64_TOL):
        fail(f"QIDDM-A in complex128 on the card differs from the CPU: "
             f"forward {fwd_err:.3e}, loss {loss_err:.3e}, gradients "
             f"{grad_err:.3e}")
    return counts


# --- phase 47: AOT serving artifacts ------------------------------------------

def _curve(a: torch.Tensor, b: torch.Tensor) -> list:
    """max |diff| of two (iters + 1, ...) stacks at each iteration."""
    return [(a[t].cpu() - b[t].cpu()).abs().max().item()
            for t in range(1, len(a))]


def _spread(card, cpu, x, iters: int) -> tuple[float, list]:
    """(each iteration from ``card``'s batch run by ``cpu``, at worst; the
    free-running runs' max |diff| at each of ``iters`` iterations) of two
    samplers from the batch ``x`` on the card."""
    stack = card.sample_stack_fn(x, iters)
    step = max((cpu.sample_fn(stack[t].cpu(), 1, only_last=True)
                - stack[t + 1].cpu()).abs().max().item()
               for t in range(iters))
    return step, _curve(stack, cpu.sample_stack_fn(x.cpu(), iters))


def _fmt(curve: list) -> str:
    return "[" + ", ".join(f"{v:.1e}" for v in curve) + "]"


def trained_x64(ckpt: pathlib.Path, smi: str) -> None:
    """The trained MODEL sampler (phase 10's checkpoint) at batch N on the
    gate chain and AOT_BATCH on the composed route, the card against the
    CPU. Under config.enable_x64(True) (complex128, the routes no kernel
    takes, as phase 46b) each iteration from the card's batch is held
    within X64_TOL of the CPU's. The free-running runs over ITERS are
    printed, not held, beside their floor, the CPU's own float64 run
    against itself from the start batch moved by one float64 ulp: the
    trained map amplifies a difference ~30-100x an iteration, so after a
    few iterations no precision holds two free-running runs together.
    In float32 each of the card's iterations from the CPU's float64 batch
    is held against the CPU's float64 step within max(SAMPLE_TOL,
    FLOOR_FACTOR x the CPU's float32 floor, its float32 step against that
    float64 step), as phase_sample's ``floor64`` holds the U-Net; the
    card's steps with TF32 on are the control, which must fail the hold.
    The card's float32 run against the CPU's float32 run, an iteration and
    free-running, is printed beside the floor."""
    samplers = {d: _sampler_of(MODEL, d, ckpt) for d in ("cuda", "cpu")}
    gen = torch.Generator().manual_seed(SEED + 48)
    for batch in (N, AOT_BATCH):
        x = _start(batch, SEED + 48, torch.device("cuda", 0))
        step32, free32 = _spread(samplers["cuda"], samplers["cpu"], x, ITERS)
        sign = torch.where(torch.rand(x.shape, generator=gen) < 0.5, -1.0,
                           1.0).double()
        config.enable_x64(True)
        try:
            s64 = {d: copy.deepcopy(s) for d, s in samplers.items()}
            for d, s in s64.items():
                s.net = s.net.to(d, torch.float64)
            step64, free64 = _spread(s64["cuda"], s64["cpu"], x.double(),
                                     ITERS)
            stack = s64["cpu"].sample_stack_fn(x.double().cpu(), ITERS)
            ulp64 = _curve(stack, s64["cpu"].sample_stack_fn(
                x.double().cpu() * (1.0 + 2.0**-52 * sign), ITERS))
        finally:
            config.enable_x64(False)
        # the CPU's float32 floor: its float32 run against its own float64
        # run, an iteration from each float64 batch and free-running from x
        cpu32 = samplers["cpu"]
        floor_step = max((cpu32.sample_fn(stack[t].float(), 1,
                                          only_last=True).double()
                          - stack[t + 1]).abs().max().item()
                         for t in range(ITERS))
        floor_free = _curve(stack, cpu32.sample_stack_fn(x.cpu(), ITERS))

        def card_err():
            return max((samplers["cuda"].sample_fn(
                stack[t].float().to(x.device), 1, only_last=True).double()
                .cpu() - stack[t + 1]).abs().max().item()
                for t in range(ITERS))

        held32 = card_err()
        with _tf32():
            control = card_err()
        tol32 = max(SAMPLE_TOL, FLOOR_FACTOR * floor_step)
        print(f"export: the trained {' '.join(MODEL)} at batch {batch}, the "
              f"card against the CPU: in float64 {step64:.3e} at worst an "
              f"iteration from the card's batch (held within {X64_TOL}); "
              f"free-running by iteration {_fmt(free64)}, beside the CPU's "
              f"own float64 run from the batch moved by one ulp "
              f"{_fmt(ulp64)} (printed); in float32 against the CPU's "
              f"float64 step {held32:.3e} at worst an iteration, held within "
              f"{tol32:.3e}: {FLOOR_FACTOR} x the CPU's float32 floor (its "
              f"float32 step against its float64 step) {floor_step:.3e} "
              f"(the card at {held32 / floor_step:.3f} x), or {SAMPLE_TOL}; "
              f"control, the card's steps with TF32 on, {control:.3e}; "
              f"against the CPU's float32 run {step32:.3e} an iteration and "
              f"{_fmt(free32)} free-running, beside the CPU's float32 run "
              f"against its float64 run {_fmt(floor_free)} ({smi})")
        if not step64 <= X64_TOL:
            fail(f"the trained {' '.join(MODEL)} at batch {batch} in "
                 f"float64 on the card differs from the CPU by "
                 f"{step64:.3e} an iteration (> {X64_TOL})")
        if not held32 <= tol32:
            fail(f"the trained {' '.join(MODEL)} at batch {batch} in "
                 f"float32 on the card is {held32:.3e} from the CPU's "
                 f"float64 step (> {tol32:.3e})")
        if not control > tol32:
            fail(f"the trained {' '.join(MODEL)} at batch {batch}: the "
                 f"float32 hold does not tell TF32 from float32: "
                 f"{control:.3e} <= {tol32:.3e}")


def _sampler_of(margs, device, ckpt=None, seed: int = SEED):
    """A Diffusion of ``margs`` on ``device``: the checkpoint's weights, or
    seeded random ones."""
    net = common.build_model(margs, seed=seed, device=device)
    if ckpt is not None:
        load_jax_variables(net, load_checkpoint(ckpt)["model_state_dict"])
    return Diffusion(net=net, shape=(28, 28)).eval()


def _start(n: int, seed: int, device, side: int = 28) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        (rng.uniform(size=(n, 1, side, side)) * 0.75 + 0.5).astype(
            np.float32), device=device)


def _counted(fn) -> tuple:
    """``fn()`` from counts of 0, synchronised: (its result, the counters
    that moved)."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {c: n for c, n in read_counts().items() if n}


def _turns(live, artifact, images: int, reps: int) -> tuple[float, float]:
    """Steady images/s of the live sampler and of an artifact, timed in
    turns (live, artifact, artifact, live) over ``reps`` rounds after one
    warm call each, host clock to a synchronise."""
    for fn in (live, artifact):
        fn()
    torch.cuda.synchronize()
    walls = {"live": [], "artifact": []}
    for _ in range(reps):
        for name, fn in (("live", live), ("artifact", artifact),
                         ("artifact", artifact), ("live", live)):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    return (images / float(np.median(walls["live"])),
            images / float(np.median(walls["artifact"])))


def _held_artifact(what: str, got, want, tol: float) -> float:
    err = (got.float().cpu() - want.float().cpu()).abs().max().item()
    if not (math.isfinite(err) and err <= tol):
        fail(f"{what}: the artifact is {err:.3e} from its reference "
             f"(> {tol})")
    return err


def _against(err: float) -> str:
    within = "within" if err <= STEP_TOL else "over"
    return f"{err:.3e} ({within} {STEP_TOL})"


def _op_overhead(reps: int = 500) -> dict:
    """Host us a call of #1 at (6, 16, 28) through its launch function,
    through ``qiddm::gate_chain`` (torch.library.Library, the port's
    registration) and through the same launch function registered with
    torch.library.custom_op; in turns, twice."""
    dev = torch.device("cuda", 0)
    pr, pi, mats = chain_inputs(np.random.default_rng(SEED + 47), 6, 16, 28,
                                dev)
    g8 = gate_kernel._to_g8(mats)
    signs = gate_kernel._sign_planes_on(2, 6, dev)

    @torch.library.custom_op("qiddm_probe::gate_chain", mutates_args=())
    def custom(pr: torch.Tensor, pi: torch.Tensor, g8: torch.Tensor, k: int,
               wires: int) -> tuple[torch.Tensor, torch.Tensor]:
        return gate_kernel._gate_chain_cuda(pr, pi, g8, signs, k, wires)

    @custom.register_fake
    def _(pr, pi, g8, k, wires):
        return torch.empty_like(pr), torch.empty_like(pi)

    calls = {
        "direct": lambda: gate_kernel._gate_chain_cuda(pr, pi, g8, signs, 2,
                                                       6),
        "library": lambda: ops.gate_chain(pr, pi, g8, 2, 6),
        "custom_op": lambda: torch.ops.qiddm_probe.gate_chain(pr, pi, g8, 2,
                                                              6),
    }
    us = {name: [] for name in calls}
    for name, fn in calls.items():
        fn()
    for _ in range(2):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            us[name].append(1e6 * (time.perf_counter() - t0) / reps)
    return us


class _Block(torch.nn.Module):
    """#13's path at the block level: reupload_block with a CNOT ring, its
    weights a program input."""

    def forward(self, inputs, x):
        return engine.reupload_block(x, inputs[0], encode="rz",
                                     imprimitive="cnot")


def phase_export(tmp: pathlib.Path, smi: str) -> dict:
    """AOT serving artifacts (qiddm_tpu_torch/export.py) on the card: the
    CLI's --export and --from-export on the trained MODEL checkpoint, the
    JAX bench's AOT row, a bundle, one artifact for each other forward
    operator, a CPU-emitted CUDA artifact and the trajectory refusal.
    Returns the launch counts of every artifact and live run."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = common.build_model(MODEL, device="cpu").save_name()
    ckpt = tmp / f"{LABEL}/noise_0/{name}_{LABEL}.pt"
    total = {c: 0 for c in read_counts()}
    through = {}  # op -> launches through artifacts

    def add(counts, artifact_op=None, counter=None):
        for c, n in counts.items():
            total[c] += n
        if artifact_op:
            through[artifact_op] = through.get(artifact_op, 0) + counts.get(
                counter, 0)

    # (1) the CLI round trip at batch N, ITERS iterations
    art = tmp / "aot_ll.qta"
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        sample_cli.main(["--ckpt", str(ckpt), "--model", *MODEL, "--n",
                         str(N), "--iters", str(ITERS), "--device", "cuda",
                         "--export", str(art)])
    t_export = time.perf_counter() - t0
    print(printed.getvalue().strip() + f" in {t_export:.2f} s")
    serve = ["--n", str(N), "--device", "cuda", "--format", "npz",
             "--batches", str(BATCHES)]
    with contextlib.redirect_stdout(io.StringIO()):
        served, got = _counted(lambda: sample_cli.main(
            ["--from-export", str(art), *serve, "--out", str(tmp / "aot_s")]))
        direct, live = _counted(lambda: sample_cli.main(
            ["--ckpt", str(ckpt), "--model", *MODEL, "--iters", str(ITERS),
             *serve, "--out", str(tmp / "aot_d")]))
    add(got, "gate_chain", "gate")
    add(live)
    want = {"gate": 2 * ITERS * BATCHES}
    if got != want or live != want:
        fail(f"--from-export launched {got}, the live sampler {live}; both "
             f"should launch {want}")
    err = float(np.abs(served - direct).max())
    print(f"export: --from-export {N} x {ITERS} iterations x {BATCHES} "
          f"batches against the live CLI: max|diff| {err:.3e}, launches "
          f"{got} (live {live})")
    if not err <= EXPORT_TOL:
        fail(f"--from-export is {err:.3e} from the live sampler "
             f"(> {EXPORT_TOL})")
    diff = _sampler_of(MODEL, dev, ckpt)
    fn = export_mod.load_sampler(art.read_bytes())
    x16 = _start(N, SEED + 47, dev)
    live16, art16 = _turns(
        lambda: diff.sample_fn(x16, ITERS, only_last=True),
        lambda: fn(x16), N, EXPORT_REPS)
    print(f"export: {' '.join(MODEL)} at batch {N}, {ITERS} iterations: "
          f"live {live16:.1f} images/s, artifact {art16:.1f} images/s "
          f"({art16 / live16:.3f}x; in turns; {smi})")

    # the trained sampler on the card against the CPU, on the gate chain
    # (batch N) and the composed route (AOT_BATCH >= 2^6): held in float64
    trained_x64(ckpt, smi)

    # (2) the JAX bench's AOT row (bench.py:322-345, fresh weights): batch
    # 1024, the composed-unitary route, held against the CPU too
    x = _start(AOT_BATCH, SEED + 48, dev)
    diff = _sampler_of(MODEL, dev)
    cpu = _sampler_of(MODEL, "cpu")
    t0 = time.perf_counter()
    blob = export_mod.export_sampler(diff, batch=AOT_BATCH, n_iters=ITERS)
    t_aot = time.perf_counter() - t0
    fn = export_mod.load_sampler(blob)
    out, got = _counted(lambda: fn(x))
    add(got)
    if got:
        fail(f"the batch-{AOT_BATCH} artifact launched {got}: the composed "
             f"route runs no port kernel")
    stack = diff.sample_stack_fn(x, ITERS)
    e_live = _held_artifact("AOT row", out, stack[-1], EXPORT_TOL)
    e_cpu = _held_artifact("AOT row against the CPU", out, cpu.sample_fn(
        x.cpu(), ITERS, only_last=True), SAMPLE_TOL)
    # the composed route's own error: each iteration on the CPU from the
    # card's batch, against the card's next
    e_step = max(_held_artifact(
        f"AOT row iteration {t} on the CPU", cpu.sample_fn(
            stack[t].cpu(), 1, only_last=True), stack[t + 1], STEP_TOL)
        for t in range(ITERS))
    live_r, art_r = _turns(lambda: diff.sample_fn(x, ITERS, only_last=True),
                           lambda: fn(x), AOT_BATCH, AOT_REPS)
    print(f"export: AOT row {' '.join(MODEL)} at batch {AOT_BATCH}, {ITERS} "
          f"iterations (composed route, exported in {t_aot:.2f} s, "
          f"{len(blob) / 1e6:.2f} MB): artifact {art_r:.1f} images/s, live "
          f"{live_r:.1f} images/s ({art_r / live_r:.3f}x; in turns; {smi}); "
          f"max|diff| {e_live:.3e} against the live sampler, "
          f"{_against(e_cpu)} against the CPU's over {ITERS} iterations, "
          f"{e_step:.3e} at worst an iteration from the card's batch")

    # (3) a bundle of buckets BUNDLE_BUCKETS serving BUNDLE_NS
    t0 = time.perf_counter()
    blob = export_mod.export_sampler_bundle(diff, batches=BUNDLE_BUCKETS,
                                            n_iters=ITERS)
    t_bundle = time.perf_counter() - t0
    serve_fn = export_mod.load_sampler_bundle(blob)
    for n in BUNDLE_NS:
        x = _start(n, SEED + 49 + n, dev)
        out, got = _counted(lambda: serve_fn(x))
        add(got, "gate_chain", "gate")
        e = _held_artifact(f"bundle n={n}", out,
                           diff.sample_fn(x, ITERS, only_last=True),
                           SAMPLE_TOL)
        line = (f"export: bundle {list(BUNDLE_BUCKETS)} (exported in "
                f"{t_bundle:.2f} s) n={n}: max|diff| {_against(e)} against "
                f"the live sampler, launches {got}")
        if n > BUNDLE_BUCKETS[-2]:
            e = _held_artifact(f"bundle n={n} against the CPU", out,
                               cpu.sample_fn(x.cpu(), ITERS, only_last=True),
                               SAMPLE_TOL)
            line += (f", {_against(e)} against the CPU (the 64-bucket, "
                     f"composed)")
        print(line)

    # (4) one artifact for each other forward operator, against the live
    # sampler on the card, each counter moving as the live run's does
    for what, margs, side, noise, variant, batch, iters, op, counter in (
            EXPORT_MODELS):
        config.set_wide_kernel_variant(variant)
        try:
            d = _sampler_of(margs, dev, seed=SEED + 5)
            if noise:
                d.net = common.with_noise(d.net, *noise)
            t0 = time.perf_counter()
            fn = export_mod.load_sampler(export_mod.export_sampler(
                d, batch=batch, n_iters=iters))
            t_op = time.perf_counter() - t0
            x = _start(batch, SEED + 50, dev, side)
            out, got = _counted(lambda: fn(x))
            want, live = _counted(
                lambda: d.sample_fn(x, iters, only_last=True))
        finally:
            config.set_wide_kernel_variant("scan")
        add(got, op, counter)
        add(live)
        if got != live or not got.get(counter):
            fail(f"{what}: the artifact launched {got}, the live sampler "
                 f"{live}")
        e = _held_artifact(what, out, want, STEP_TOL)
        print(f"export: {what} ({batch} x {iters} iterations, export and "
              f"load {t_op:.2f} s): qiddm::{op} launches {got} (live "
              f"{live}), max|diff| {e:.3e}")
    w, L, k, b = UNITARY_PATH[1]
    weights, x, _ = unitary_inputs(np.random.default_rng(SEED + 51), w, b, L,
                                   k, "cnot", dev)
    seg = export_mod._program_segment(_Block(), ([weights], x), dev)
    call = export_mod._bind(seg, [weights], 1)[0]
    out, got = _counted(lambda: call(x))
    with torch.no_grad():
        want, live = _counted(lambda: engine.reupload_block(
            x, weights, encode="rz", imprimitive="cnot"))
    add(got, "unitary_chain", "unitary")
    add(live)
    if got != {"unitary": 1} or live != got:
        fail(f"#13's block artifact launched {got}, the live block {live}")
    e = _held_artifact("#13's block", out, want, STEP_TOL)
    print(f"export: reupload_block CNOT (w={w}, L={L}, k={k}, B={b}) at the "
          f"block level: qiddm::unitary_chain launches {got}, max|diff| "
          f"{e:.3e}")

    # (5) a CUDA artifact emitted from the CPU
    t0 = time.perf_counter()
    blob = export_mod.export_sampler(cpu, batch=N, n_iters=CROSS_ITERS,
                                     platforms=("cuda",))
    t_cross = time.perf_counter() - t0
    fn = export_mod.load_sampler(blob)
    x = _start(N, SEED + 52, dev)
    out, got = _counted(lambda: fn(x))
    add(got, "gate_chain", "gate")
    if got != {"gate": 2 * CROSS_ITERS}:
        fail(f"the CPU-emitted CUDA artifact launched {got}")
    e = _held_artifact("CPU-emitted CUDA artifact", out, diff.sample_fn(
        x, CROSS_ITERS, only_last=True), STEP_TOL)
    print(f"export: {' '.join(MODEL)} built and exported on the CPU for cuda "
          f"in {t_cross:.2f} s, run on the card: launches {got}, max|diff| "
          f"{e:.3e} against the card's live sampler")

    # (6) trajectory models are not exportable
    traj = _sampler_of(MODEL, dev, ckpt)
    traj.net = common.with_noise(traj.net, 2, 0.05, noise_trajectories=16)
    try:
        export_mod.export_sampler(traj, batch=2, n_iters=2)
    except ValueError as e:
        if "trajectory" not in str(e):
            raise
        print(f"export: a trajectory model refused: {e}")
    else:
        fail("a trajectory model was exported")

    us = _op_overhead()
    print(f"export: host us a call of #1 at (6, 16, 28), in turns: "
          + ", ".join(f"{k} {', '.join(f'{v:.2f}' for v in vs)}"
                      for k, vs in us.items()) + f" ({smi})")
    print(f"export: launches through artifacts by operator {through}")
    print(f"phase 47 wall {time.perf_counter() - t_phase:.1f} s ({smi})")
    return total

# --- phase 48: the application layer ------------------------------------------

def _first_difference(a: dict, b: dict) -> str:
    """The first tensor of two state dicts that differs, or ""."""
    for k in a:
        if not torch.equal(a[k], b[k]):
            return (f"{k} (max|diff| "
                    f"{(a[k] - b[k]).abs().max().item():.3e})")
    return ""


def _state_of(net) -> dict:
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def _app_call(tmp: pathlib.Path, smi: str) -> tuple:
    """(a) The torch-style training call on the card: the reference's loop
    ``opt.zero_grad(); diff(x=..., T=TAU); opt.step()`` for APP_CALLS calls
    at batch 1, against make_train_step on the same draws (losses and
    parameters bit-equal) and against the CPU plain path at the card's
    weights (losses and make_train_step's gradients within TRAIN_TOL);
    exactly 2 #1 and 2 #2 launches a call; loss_only moves nothing.
    Returns the trained Diffusion, its losses and the calls' launches."""
    z = np.load(tmp / "data" / "mnist_28.npz")
    x = torch.as_tensor(z["x"][z["y"] == LABEL][:APP_CALLS] / 255.0,
                        dtype=torch.float32).reshape(APP_CALLS, 1, 28, 28)
    lr = common.DEFAULT_LRS[MODEL[0]]
    diffs = {name: Diffusion(common.build_model(MODEL, seed=SEED,
                                                device=dev), shape=(28, 28))
             for name, dev in (("call", "cuda"), ("step", "cuda"),
                               ("cpu", "cpu"))}
    opt = torch.optim.Adam(diffs["call"].parameters(), lr=lr)
    diffs["call"].attach_optimizer(opt).train()
    step = diffs["step"].make_train_step(
        torch.optim.Adam(diffs["step"].parameters(), lr=lr), TAU)
    counts = {c: 0 for c in read_counts()}
    losses, loss_err, grad_err = [], 0.0, 0.0
    for i in range(APP_CALLS):
        cpu = diffs["cpu"]
        cpu.net.load_state_dict(diffs["call"].net.state_dict())
        cpu.net.zero_grad()
        want, _ = cpu.loss_fn(x[i].reshape(1, -1), TAU,
                              generator=torch.Generator().manual_seed(i))
        want.backward()
        xi = x[i:i + 1].to("cuda")
        reset_counts()
        opt.zero_grad()
        (got,) = diffs["call"](x=xi, T=TAU)
        opt.step()
        torch.cuda.synchronize()
        for c, n in read_counts().items():
            counts[c] += n
        ref = step(xi.reshape(1, -1), torch.Generator().manual_seed(i))
        losses.append(got.item())
        if got.item() != abs(ref.item()):
            fail(f"training call {i + 1}: loss {got.item()!r}, "
                 f"make_train_step's {ref.item()!r}")
        moved = _first_difference(_state_of(diffs["call"].net),
                                  _state_of(diffs["step"].net))
        if moved:
            fail(f"training call {i + 1}: the parameters differ from "
                 f"make_train_step's at {moved}")
        if any(p.grad is not None for p in diffs["call"].parameters()):
            fail(f"training call {i + 1} left a gradient for the outer "
                 f"opt.step()")
        loss_err = max(loss_err, abs(got.item() - want.item())
                       / abs(want.item()))
        grad_err = max(grad_err, _grad_err(_grads(diffs["step"].net),
                                           _grads(cpu.net)))
    counts = {c: n for c, n in counts.items() if n}
    per_call = {"gate": 2 * APP_CALLS, "gate_bwd": 2 * APP_CALLS}
    if counts != per_call:
        fail(f"{APP_CALLS} training calls launched {counts}, not "
             f"{per_call}")
    if not (loss_err <= TRAIN_TOL and grad_err <= TRAIN_TOL):
        fail(f"the training call on the card differs from the CPU: losses "
             f"{loss_err:.3e}, gradients {grad_err:.3e} > {TRAIN_TOL}")
    before = _state_of(diffs["call"].net)
    probe = Diffusion(diffs["call"].net, shape=(28, 28)).train()
    (only,) = probe(x=x[:1].to("cuda"), T=TAU, loss_only=True)
    cpu.net.load_state_dict(before)
    (cpu_only,) = diffs["cpu"].train()(x=x[:1], T=TAU, loss_only=True)
    only_err = abs(only.item() - cpu_only.item()) / cpu_only.item()
    if _first_difference(before, _state_of(diffs["call"].net)) or not (
            only_err <= TRAIN_TOL):
        fail(f"loss_only moved a parameter or differs from the CPU by "
             f"{only_err:.3e}")
    print(f"phase 48 (a) {' '.join(MODEL)}: {APP_CALLS} calls of the "
          f"reference loop (opt.zero_grad(); diff(x=..., T={TAU}); "
          f"opt.step()) at batch 1, lr {lr}: losses {losses}, bit-equal to "
          f"make_train_step's with its parameters (the outer step moved "
          f"nothing); against the CPU at the card's weights losses max "
          f"relative {loss_err:.3e}, gradients {grad_err:.3e} (within "
          f"{TRAIN_TOL}); launches {counts}; loss_only {only.item():.6f}, "
          f"{only_err:.3e} from the CPU's, no parameter moved ({smi})")
    return diffs["call"], losses, counts


def _app_reference_pt(tmp: pathlib.Path, diff, losses, smi: str) -> dict:
    """(b) The reference's .pt: (a)'s net saved by save_reference_checkpoint
    and loaded by load_reference_checkpoint into a fresh model on the
    card; N images x ITERS iterations on #1 from both, bit-equal. Returns
    the reloaded sampler's launches."""
    path = save_reference_checkpoint(diff.net, tmp / "reference_ll.pt",
                                     losses, APP_CALLS)
    keys = list(torch.load(path, weights_only=True)["model_state_dict"])
    fresh = common.build_model(MODEL, seed=SEED + 48, device="cuda")
    meta = load_reference_checkpoint(fresh, path)
    x = _start(N, SEED + 53, torch.device("cuda", 0))
    want = diff.eval().sample_fn(x, ITERS, only_last=True)
    got, counts = _counted(lambda: Diffusion(fresh, shape=(28, 28))
                           .eval().sample_fn(x, ITERS, only_last=True))
    if not torch.equal(got, want) or counts != {"gate": 2 * ITERS}:
        fail(f"the reloaded reference .pt sampled {counts}, max|diff| "
             f"{(got - want).abs().max().item():.3e} from the trained net")
    print(f"phase 48 (b) reference .pt {path.name}: keys {keys}, "
          f"(loss_values, epochs) {meta}; {N} images x {ITERS} iterations "
          f"from the reloaded model bit-equal to the trained net's, "
          f"launches {counts} ({smi})")
    return counts


def _app_driver(tmp: pathlib.Path, prefix: str, backend: str,
                epochs: int) -> None:
    argv = ["--model", *MODEL, "--epochs", str(epochs), "--checkpoint-every",
            "1", "--ckpt-backend", backend, "--device", "cuda",
            "--save-path", f"{tmp}/{prefix}", "--load-path",
            f"{tmp}/{prefix}"]
    with contextlib.redirect_stdout(io.StringIO()), contextlib.chdir(tmp):
        mnist_exm.main(argv)


def _app_dcp(tmp: pathlib.Path, smi: str) -> dict:
    """(c) --ckpt-backend orbax (a DCP directory) through mnist_exm at
    MODEL, 2 epochs with --checkpoint-every 1 (the mid-training save in
    the background), against the same run under pt: the restored
    variables and the losses bit-equal; an interrupted run (1 epoch, then
    resumed to 2) whose first epoch's loss is the same; then cli.sample
    --ckpt <.dcp> against --ckpt <.pt>, bit-equal. Returns the launches of
    the two sampling runs."""
    t0 = time.perf_counter()
    name = common.build_model(MODEL, device="cpu").save_name()
    for prefix, backend, epochs in (("dcp_", "orbax", EPOCHS),
                                    ("pt_", "pt", EPOCHS),
                                    ("cut_", "orbax", 1),
                                    ("cut_", "orbax", EPOCHS)):
        _app_driver(tmp, prefix, backend, epochs)
    t_runs = time.perf_counter() - t0
    dcp = tmp / f"dcp_{LABEL}/noise_0/{name}_{LABEL}.dcp"
    pt = tmp / f"pt_{LABEL}/noise_0/{name}_{LABEL}.pt"
    loaded = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for what, path in (("dcp", dcp), ("pt", pt),
                           ("cut", tmp / f"cut_{LABEL}/noise_0")):
            d = Diffusion(common.build_model(MODEL, seed=SEED + 9,
                                             device="cuda"), shape=(28, 28))
            loaded[what] = (load_diffusion(d, path, LABEL), _state_of(d.net))
    (dcp_losses, dcp_epochs), dcp_state = loaded["dcp"]
    (pt_losses, _), pt_state = loaded["pt"]
    (cut_losses, cut_epochs), _ = loaded["cut"]
    differs = _first_difference(dcp_state, pt_state)
    if differs or dcp_losses != pt_losses or dcp_epochs != EPOCHS:
        fail(f"the orbax (DCP) run and the pt run differ: first tensor "
             f"{differs or 'none'}, losses {dcp_losses} against "
             f"{pt_losses}, epochs {dcp_epochs}")
    if cut_epochs != EPOCHS or cut_losses[0] != pt_losses[0]:
        fail(f"the interrupted DCP run resumed to {cut_epochs} epochs with "
             f"losses {cut_losses}; its first must be {pt_losses[0]!r}")
    served = {}
    for what, path in (("dcp", dcp), ("pt", pt)):
        with contextlib.redirect_stdout(io.StringIO()):
            served[what] = _counted(lambda: sample_cli.main(
                ["--ckpt", str(path), "--model", *MODEL, "--n", str(N),
                 "--iters", str(ITERS), "--device", "cuda", "--format",
                 "npz", "--out", str(tmp / f"app_{what}")]))
    if not np.array_equal(served["dcp"][0], served["pt"][0]):
        fail("cli.sample from the .dcp differs from the .pt: max|diff| "
             f"{np.abs(served['dcp'][0] - served['pt'][0]).max():.3e}")
    counts = {c: served["dcp"][1].get(c, 0) + served["pt"][1].get(c, 0)
              for c in read_counts()}
    print(f"phase 48 (c) mnist_exm --ckpt-backend orbax against pt "
          f"({EPOCHS} epochs, --checkpoint-every 1): {dcp.name} and "
          f"{pt.name} restore bit-equal variables, losses {dcp_losses} "
          f"equal; interrupted at epoch 1 and resumed: losses {cut_losses} "
          f"(the first equal); cli.sample --ckpt {dcp.name} bit-equal to "
          f"the .pt's, {N} x {ITERS}, launches {served['dcp'][1]}; the four "
          f"driver runs {t_runs:.1f} s ({smi})")
    return counts


def _app_shift(smi: str) -> dict:
    """(d) parameter_shift_grad of a linear functional of PauliZ
    expectations, reupload_block at PSHIFT's (wires, L, k, inputs) on #1
    (fewer inputs than 2^wires), against torch.autograd through #1/#2
    within PSHIFT_TOL, with exactly 2P #1 launches; chunked against
    unchunked within CHUNK_TOL. Returns the unchunked run's launches."""
    wires, L, k, b = PSHIFT
    rng = np.random.default_rng(SEED + 54)
    dev = torch.device("cuda", 0)
    w = torch.as_tensor(rng.normal(size=(L, k, wires, 3)) * 0.4,
                        dtype=torch.float32, device=dev)
    x = torch.as_tensor(rng.normal(size=(b, wires)), dtype=torch.float32,
                        device=dev)
    coeff = torch.as_tensor(rng.normal(size=(wires,)), dtype=torch.float32,
                            device=dev)

    def f(w):
        ev = engine.reupload_block(x, w, encode="rz", imprimitive="cz",
                                   readout="expvalz")
        return torch.sum(ev @ coeff)

    t0 = time.perf_counter()
    shift, counts = _counted(lambda: parameter_shift_grad(f, w))
    t_shift = time.perf_counter() - t0
    chunked, chunk_counts = _counted(
        lambda: parameter_shift_grad(f, w, chunk=PSHIFT_CHUNK))
    wr = w.clone().requires_grad_(True)
    (auto,), auto_counts = _counted(
        lambda: torch.autograd.grad(f(wr), wr))
    err = (shift - auto).abs().max().item()
    chunk_err = (shift - chunked).abs().max().item()
    want = {"gate": 2 * w.numel()}
    print(f"phase 48 (d) parameter shift at (wires, L, k, inputs) "
          f"{PSHIFT}: {w.numel()} parameters, launches {counts} in "
          f"{t_shift:.2f} s (chunks of {PSHIFT_CHUNK}: {chunk_counts}); "
          f"against autograd through #1/#2 ({auto_counts}) max|diff| "
          f"{err:.3e} (within {PSHIFT_TOL}), chunked against unchunked "
          f"{chunk_err:.3e} (within {CHUNK_TOL}) ({smi})")
    if counts != want or chunk_counts != want or auto_counts != {
            "gate": 1, "gate_bwd": 1}:
        fail(f"parameter shift launched {counts} and {chunk_counts}, "
             f"autograd {auto_counts}; want {want}")
    if not (err <= PSHIFT_TOL and chunk_err <= CHUNK_TOL):
        fail(f"parameter shift is {err:.3e} from autograd, chunked "
             f"{chunk_err:.3e} from unchunked")
    return counts


def _app_qasm(smi: str) -> None:
    """(e) circuit_to_qasm -> repeat_qasm (ancilla reset) at QASM's
    (wires, depth, reps): run_qasm on the card in complex128 within
    QASM_TOL of the native engine on the host; sample_from_qasm's
    QASM_SHOTS counts equal to the native draw of the host's
    probabilities. The host reference computes the gates (the C++
    engine) and the resets (a numpy projection) apart from the card's
    run; the QASM parse is the same code in both, held against the JAX
    package's on the CPU by tests/test_torch_qasm.py."""
    wires, depth, reps = QASM
    rng = np.random.default_rng(SEED + 55)
    w = rng.normal(size=(depth, wires, 3)).astype(np.float32)
    inp = rng.normal(size=wires).astype(np.float32)
    text = qasm.repeat_qasm(qasm.circuit_to_qasm(w, wires, inp), wires, True,
                            reps)
    t0 = time.perf_counter()
    probs = qasm.run_qasm(text)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    host = qasm.run_qasm_native(text)
    err = float(np.abs(probs.cpu().numpy() - host).max())
    counts = qasm.sample_from_qasm(text, shots=QASM_SHOTS, seed=0)
    want = native.sample_counts(qasm.qiskit_order(host), QASM_SHOTS, 0)
    print(f"phase 48 (e) QASM at {wires} wires, depth {depth}, {reps} reps "
          f"with the ancilla reset ({len(text.splitlines())} lines): "
          f"run_qasm on {probs.device} in {t_card:.3f} s, max|diff| "
          f"{err:.3e} from the native engine (within {QASM_TOL}); "
          f"{QASM_SHOTS} shots, counts equal to the native draw: "
          f"{bool(np.array_equal(counts, want))} ({smi})")
    if probs.device.type != "cuda" or not err <= QASM_TOL:
        fail(f"run_qasm on {probs.device} is {err:.3e} from the native "
             f"engine")
    if not np.array_equal(counts, want):
        fail("sample_from_qasm's counts differ from the native draw")


def phase_app(tmp: pathlib.Path, smi: str) -> dict:
    """Phase 48: the application layer at MODEL's full width on the card
    (after phase 47): (a)-(e) above. Returns the launches of its runs."""
    t0 = time.perf_counter()
    diff, losses, call_counts = _app_call(tmp, smi)
    runs = [call_counts, _app_reference_pt(tmp, diff, losses, smi),
            _app_dcp(tmp, smi), _app_shift(smi)]
    _app_qasm(smi)
    total = {c: sum(r.get(c, 0) for r in runs) for c in read_counts()}
    print(f"phase 48 wall {time.perf_counter() - t0:.1f} s, launches "
          f"{ {c: n for c, n in total.items() if n} } ({smi})")
    return total


# --- phase 49: the mesh ---------------------------------------------------------

def _mesh_images(tmp: pathlib.Path) -> torch.Tensor:
    """The seeded mnist_28.npz's first MESH_IMAGES images of LABEL, flat."""
    z = np.load(tmp / "data" / "mnist_28.npz")
    x = z["x"][z["y"] == LABEL][:MESH_IMAGES] / 255.0
    return torch.as_tensor(x, dtype=torch.float32).reshape(len(x), -1)


def _mesh_sampling(tmp: pathlib.Path, smi: str) -> dict:
    """(b) The sampling CLI on phase 10's checkpoint at N x ITERS with
    --mesh-devices 1 (the CLI forms a one-rank NCCL group and destroys
    it) against the same command without the flag: the same bits and
    launches; --mesh-devices 2 raises the device-count ValueError (the
    command's exit 1) before any group is formed. Returns the mesh run's
    launches."""
    name = common.build_model(MODEL, device="cpu").save_name()
    base = ["--ckpt", str(tmp / f"{LABEL}/noise_0/{name}_{LABEL}.pt"),
            "--model", *MODEL, "--n", str(N), "--iters", str(ITERS),
            "--device", "cuda", "--format", "npz"]
    imgs, counts = {}, {}
    for flag in ([], ["--mesh-devices", "1"]):
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            imgs[len(flag)] = sample_cli.main(
                base + ["--out", str(tmp / f"mesh_served{len(flag)}"), *flag])
        counts[len(flag)] = read_counts()
        if dist.is_initialized():
            fail("the sampling CLI left its process group behind")
    print(f"phase 49 (b) {printed.getvalue().strip()}")
    if not np.array_equal(imgs[0], imgs[2]):
        fail(f"--mesh-devices 1 differs from the run without a mesh by "
             f"{np.abs(imgs[0] - imgs[2]).max():.3e}")
    if counts[0] != counts[2] or counts[2]["gate"] != 2 * ITERS:
        fail(f"--mesh-devices 1 launched {counts[2]}, without it "
             f"{counts[0]}")
    try:
        sample_cli.main(base + ["--out", str(tmp / "mesh_served_2"),
                                "--mesh-devices", "2"])
        fail("--mesh-devices 2 ran on one card")
    except ValueError as err:
        refused = str(err)
    if ("requested a 2-device mesh but only 1 device(s)" not in refused
            or dist.is_initialized()):
        fail(f"--mesh-devices 2: {refused!r}, group left "
             f"{dist.is_initialized()}")
    print(f"phase 49 (b) cli.sample --mesh-devices 1: {N} x {ITERS} the "
          f"same bits as without the flag, #1 {counts[2]['gate']} launches "
          f"each; --mesh-devices 2: {refused} ({smi})")
    return counts[2]


def _take_counts() -> dict:
    """The launches since the counts were last set to 0; sets them to 0."""
    counts = read_counts()
    reset_counts()
    return counts


def _mesh_training(tmp: pathlib.Path, mesh, smi: str) -> dict:
    """(a) mesh_check.check_training on the one-rank NCCL data mesh: MODEL
    at batch 1, tau TAU, EPOCHS epochs over MESH_IMAGES images, against the
    run without a mesh from the same seed, the runs in turns (none, mesh,
    mesh, none): the same losses, weights and #1/#2 launches, one
    all-reduce a step; every step's loss from the same weights the same
    bits too. The witness without a mesh (the loss summed over the rows
    MESH_WITNESS_SPLIT ranks would take) is printed, not held. Then
    mesh_check.check_sampling: the same bits and launches. Returns the
    mesh runs' launches."""
    dev = torch.device("cuda", torch.cuda.current_device())
    t = mesh_check.check_training(mesh, dev, MODEL, _mesh_images(tmp),
                                  EPOCHS, split=MESH_WITNESS_SPLIT,
                                  counts=_take_counts)
    steps = EPOCHS * MESH_IMAGES
    runs, ms = t["launches"], t["step_ms"]
    mc, fixed = runs["mesh"][0], t["fixed_weights"]
    if not t["bit_equal"] or fixed["loss_rel"] or fixed["grad_rel"]:
        fail(f"training over the one-rank mesh differs from the run "
             f"without it: {t['run']}, from the same weights {fixed}")
    if (any(c != mc for c in runs["mesh"] + runs["one_device"])
            or mc["gate"] < 2 * steps or mc["gate_bwd"] < 2 * steps):
        fail(f"the mesh runs launched {runs['mesh']}, the runs without it "
             f"{runs['one_device']}")
    if t["collectives"]["all_reduce"] != steps:
        fail(f"{t['collectives']['all_reduce']} all-reduces in {steps} "
             f"steps")
    run = t["run"]
    print(f"phase 49 (a) {' '.join(MODEL)} over a one-rank NCCL data mesh: "
          f"{steps} steps (batch 1, tau {TAU}), epoch losses "
          f"{run['losses']['mesh']} the same bits as without the mesh, "
          f"weights the same bits, from the same weights every step's loss "
          f"and the gradients the same bits, #1 {mc['gate']} and #2 "
          f"{mc['gate_bwd']} launches each run; collectives "
          f"{t['collectives']}; a step (ms, host clock, in turns) without "
          f"the mesh {ms['one_device'][0]:.3f}, with it {ms['mesh'][0]:.3f} "
          f"and {ms['mesh'][1]:.3f}, without {ms['one_device'][1]:.3f} "
          f"({smi})")
    print(f"phase 49 (a) witness without a mesh, the loss summed over the "
          f"rows of {run['split']} ranks: epoch losses "
          f"{run['losses']['row_split']}, {run['row_split_rel']:.3e} "
          f"relative from the plain run's (printed, not held)")
    s = mesh_check.check_sampling(mesh, dev, MODEL, counts=_take_counts)
    sc = s["launches"]["mesh"]
    if s["err"] or sc != s["launches"]["one_device"] or not sc["gate"]:
        fail(f"sampling over the one-rank mesh: {s}")
    print(f"phase 49 (a) Diffusion.sample over the one-rank mesh: "
          f"{mesh_check.SAMPLE} x {mesh_check.ITERS} the same bits and #1 "
          f"launches ({sc['gate']}) as without it, "
          f"{s['images_per_s']['mesh']:.1f} images/s against "
          f"{s['images_per_s']['one_device']:.1f} (host clock)")
    return {c: mc[c] + sc[c] for c in mc}


def _mesh_traj_rng() -> torch.Generator:
    """The trajectories' generator on the card: the same seed for the
    mesh and the dense backend, so the same draws."""
    return torch.Generator(device="cuda").manual_seed(SEED + 49)


def _mesh_route(mesh, smi: str) -> None:
    """(c) mesh_check.check_route on the card: at MESH16
    (QIDDM_LL_noise(784, 16, 14, 2)'s block) both readouts against #11/#12
    within MESH_TOL, the adjoint gradients within MESH_GRAD_TOL relative,
    and the route's steps/s; at MESH12 an RY/CNOT block against the
    grouped chain, and an amplitude-damping trajectory estimate against
    the dense trajectory backend (#7) on one generator seed's draws."""
    dev = torch.device("cuda", torch.cuda.current_device())
    wires, L = MESH16
    for readout, r in mesh_check.check_route(
            mesh, dev, wires, L, counts=_take_counts).items():
        c_mesh, c_one = r["launches"]["mesh"], r["launches"]["one_device"]
        if _kernels(c_mesh) or not (c_one["wide"] and c_one["wide_bwd"]):
            fail(f"the mesh route launched {_kernels(c_mesh)}, the route "
                 f"without it {_kernels(c_one)}")
        print(f"phase 49 (c) mesh route w={wires} (L {L}, k "
              f"{mesh_check.K}, {mesh_check.ROWS} rows) {readout}: "
              f"{r['err']:.3e} from #11/#12 (<= {MESH_TOL}), gradients "
              f"{r['grad_rel']:.3e} relative (<= {MESH_GRAD_TOL})")
        if not (r["err"] <= MESH_TOL and r["grad_rel"] <= MESH_GRAD_TOL):
            fail(f"the {wires}-wire mesh route differs from #11/#12")
    rates = mesh_check.route_rates(mesh, dev, wires, L)
    print(f"phase 49 (c) mesh route w={wires}: "
          f"{rates['steps_per_s_mesh']:.3f} steps/s (fwd + adjoint bwd, "
          f"host clock) against {rates['steps_per_s_one_device']:.3f} "
          f"through #11/#12; collectives a step "
          f"{rates['collectives_a_step']} ({smi})")

    wires, L = MESH12
    r = mesh_check.check_route(mesh, dev, wires, L, readouts=("expvalz",),
                               encode="ry", imprimitive="cnot")["expvalz"]
    x, w, _ = mesh_check.route_inputs(wires, L, dev)
    damp = engine.NoiseModel("amplitude_damping", TRAJ_STRENGTH, "encode")
    traj = {}
    for name, m in (("mesh", mesh), ("dense", None)):
        reset_counts()
        with torch.no_grad():
            traj[name] = (engine.reupload_block(
                x, w, noise=damp, readout="expvalz", mesh=m, n_traj=MESH_TRAJ,
                traj_rng=_mesh_traj_rng()), read_counts())
    terr = float((traj["mesh"][0] - traj["dense"][0]).abs().max())
    print(f"phase 49 (c) mesh route w={wires} (L {L}, k {mesh_check.K}, "
          f"{mesh_check.ROWS} rows): RY/CNOT {r['err']:.3e} from the grouped "
          f"chain, gradients {r['grad_rel']:.3e} relative; amplitude damping "
          f"{TRAJ_STRENGTH}, {MESH_TRAJ} trajectories, {terr:.3e} from the "
          f"dense backend (#7 {traj['dense'][1]['amp']} launches) on the "
          f"same draws")
    if not (r["err"] <= MESH_TOL and r["grad_rel"] <= MESH_GRAD_TOL
            and terr <= MESH_TOL and traj["dense"][1]["amp"] == L
            and not traj["mesh"][1]["amp"]):
        fail(f"the {wires}-wire mesh route differs from the dense routes")


def _mesh_sweep(tmp: pathlib.Path, smi: str) -> None:
    """(d) sweep_lr over a one-rank NCCL "trial" mesh against the sweep
    without a mesh (losses, SSIMs and each trial's DCP checkpoint, the
    same bits), then the trials' weights stacked, saved and restored onto
    the "trial" placement: the same bits."""
    trials = make_mesh(1, ("trial",))
    x = _mesh_images(tmp)
    kw = dict(shape=(28, 28), epochs=1, batch_size=SWEEP_BATCH, T=TAU,
              sample_iters=SWEEP_SCORE_ITERS, seed=SEED, ckpt_backend="orbax")
    like = export_jax_variables(common.build_model(MODEL, device="cpu"))
    res, saved = {}, {}
    for name, m in (("mesh", trials), ("plain", None)):
        res[name] = sweep_lr(
            lambda s: common.build_model(MODEL, seed=s, device="cuda"),
            MESH_SWEEP_LRS, x, mesh=m, local_dir=str(tmp / f"sweep_{name}"),
            **kw)
        saved[name] = [load_dcp(path, like)["variables"] for path in sorted(
            (tmp / f"sweep_{name}").glob("sweep/trial_*/*.dcp"))]
    got, want = res["mesh"], res["plain"]
    if not (np.array_equal(got.loss_curves, want.loss_curves)
            and np.array_equal(got.ssim, want.ssim)
            and "trial" in (got.param_sharding or "")):
        fail(f"the sweep over a one-rank trial mesh: {got} against {want}")
    flat = [_flat_tree(v) for v in saved["mesh"]]
    if len(flat) != len(MESH_SWEEP_LRS) or any(
            not all(np.array_equal(a, b) for a, b in zip(f, _flat_tree(g)))
            for f, g in zip(flat, saved["plain"])):
        fail("the trials' checkpoints differ between the mesh and no mesh")
    stacked = _stack_trees(saved["mesh"])
    save_dcp(tmp / "mesh_trials.dcp", stacked)
    back = load_dcp(tmp / "mesh_trials.dcp", stacked,
                    sharding=NamedSharding(trials, "trial"))["variables"]
    leaves = [t.to_local().cpu().numpy() for t in _flat_tree(back)]
    if not all(np.array_equal(a, b)
               for a, b in zip(leaves, _flat_tree(stacked))):
        fail("the DCP restore onto the trial placement differs")
    print(f"phase 49 (d) sweep_lr, {len(MESH_SWEEP_LRS)} trials at "
          f"{' '.join(MODEL)}, 1 epoch, over a one-rank trial mesh: losses "
          f"{got.loss_curves.ravel().tolist()}, SSIMs {got.ssim.tolist()} and "
          f"checkpoints the same bits as without the mesh, weights "
          f"{got.param_sharding}; a DCP restore onto the trial placement "
          f"({_flat_tree(back)[0].placements}) the same bits ({smi})")


def _flat_tree(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flat_tree(tree[k])]
    return [tree]


def _stack_trees(trees):
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def phase_mesh(tmp: pathlib.Path, smi: str) -> dict:
    """Phase 49: the mesh on one card (after phase 48): (b), then on one
    one-rank NCCL group (a), (c), (d); the group is destroyed before the
    phase ends. Returns the launches of the mesh's main-path runs."""
    t0 = time.perf_counter()
    if dist.is_initialized():
        fail("a process group exists before phase 49")
    sampled = _mesh_sampling(tmp, smi)
    mesh = make_mesh(1)
    try:
        first = mesh_check.first_all_reduce_ms(
            mesh, torch.device("cuda", torch.cuda.current_device()))
        print(f"phase 49 the new group's first all-reduce (the NCCL "
              f"communicator's set-up) {first:.3f} ms, host clock")
        trained = _mesh_training(tmp, mesh, smi)
        _mesh_route(mesh, smi)
        _mesh_sweep(tmp, smi)
    finally:
        distributed.shutdown()
    if dist.is_initialized():
        fail("phase 49 left its process group behind")
    total = {c: sampled[c] + trained[c] for c in sampled}
    print(f"phase 49 wall {time.perf_counter() - t0:.1f} s, launches "
          f"{ {c: n for c, n in total.items() if n} } ({smi})")
    return total


def main() -> None:
    t_start = time.perf_counter()
    kind, smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    with torch.no_grad():
        max_err = phase_kernel_vs_plain(dev)
    bwd_err = phase_bwd_vs_plain(dev)
    with torch.no_grad():
        sel_err = phase_sel_vs_plain(dev, SEL_CASES + SEL_PLAN_EDGES,
                                     SEED + 3)
        sel_wide_err = phase_sel_vs_plain(
            dev, WIDE_SEL_CASES + WIDE_SEL_PLAN_EDGES, SEED + 10)
        rows_err, _ = phase_sel_rows_vs_plain(
            dev, SEL_CASES + WIDE_SEL_CASES + SEL_PLAN_EDGES
            + WIDE_SEL_PLAN_EDGES, SEED + 16)
    sel_bwd_err = phase_sel_bwd_vs_plain(dev, SEL_CASES + SEL_PLAN_EDGES,
                                         SEED + 4, (8, 10, 14))
    sel_bwd_wide_err = phase_sel_bwd_vs_plain(
        dev, WIDE_SEL_CASES + WIDE_SEL_PLAN_EDGES, SEED + 11, (12, 10, 2))
    with torch.no_grad():
        ry_err = phase_ry_vs_plain(dev)
    ry_bwd_err = phase_ry_bwd_vs_plain(dev)
    with torch.no_grad():
        dm_err = phase_dm_vs_plain(dev)
    wide_errs = phase_wide_vs_plain(dev)
    mono_errs = phase_mono_vs_plain(dev)
    phase_mono_config()
    phase_wide_sass()
    phase_walk_registers()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        sampled, rates = {}, {}
        with torch.no_grad():
            phase_pca_on_card(28)
            for margs, side, counter, per_iter, held in SAMPLED:
                key = " ".join(margs)
                sampled[key], rates[key] = phase_sample(
                    tmp, margs, side, counter, per_iter, held)
        n_train = write_dataset(tmp / "data")
        trained, train_rates = phase_train(
            tmp, n_train, [MODEL, QNN_MODEL],
            {"gate": 2, "gate_bwd": 2, "sel": 1, "sel_bwd": 1}, default=True)
        pl_trained, pl_rates = phase_train(
            tmp, n_train, [PL_MODEL], {"ry": 2, "ry_bwd": 2}, default=False)
        # the models' batches (tau 10 rows) fit one cluster of #2, #4 and
        # #6: one launch a backward, no second launch for dg's batch sum
        if (trained["gate_bwd_sums"] or trained["sel_bwd_sums"]
                or pl_trained["ry_bwd_sums"]):
            fail(f"a training backward summed dg in a second launch: "
                 f"{trained}, {pl_trained}")
        train_rates.update(pl_rates)
        wide_trained, wide_rates = phase_train(
            tmp, n_train, [WIDE_MODEL],
            {"wide": WIDE_PER_ITER, "wide_bwd": WIDE_PER_ITER},
            default=False)
        train_rates.update({" ".join(WIDE_MODEL): r
                            for r in wide_rates.values()})
        for margs, images in ((MODEL, 1), (QNN_MODEL, 1), (PL_MODEL, 10),
                              (WIDE_MODEL, 1)):
            phase_train_parity(tmp, margs, images)
        export_counts = phase_export(tmp, smi)
        app_counts = phase_app(tmp, smi)
        mesh_counts = phase_mesh(tmp, smi)
        phase_profile_ll(tmp, smi)
        phase_profile_qnn(tmp, smi)
        phase_profile_pl(tmp, smi)
        phase_profile_wide(tmp, smi)
        qa_counts, qa_train_rate, qa_sample_rate = phase_qiddm_a(
            tmp, n_train, smi)
        zoo_counts = phase_zoo(tmp)
        unet_rates = {" ".join(margs): phase_unet(tmp, n_train, margs,
                                                  epochs, smi)
                      for margs, epochs in UNETS}
        mono_model, mono_rate, mono_train_rate = phase_mono_model(
            tmp, n_train, smi)
        write_fashion(tmp / "data")
        settings = len(SWEEP_TYPES) * 5
        swept, sweep_sampling, sweep = phase_sweep(
            tmp, "sweep_", SWEEP_MODELS, [],
            {"QIDDM_LL_noise": ("dm", 2 * SWEEP_ITERS * settings),
             "QIDDM_PL_noise1": ("dm", 2 * SWEEP_ITERS * settings),
             "QNN_noise": ("sel", 2 * SWEEP_ITERS * settings)})
        phase_sweep_parity(tmp, "sweep_", SWEEP_MODELS)
        phase_profile_noisy_pl(smi)
        amp_err = phase_amp_vs_plain(dev)
        traj_counts, traj_rate, traj_err, sampler = phase_traj_sample(smi)
        phase_profile_traj(sampler, smi)
        # kernel #7 only samples amplitude damping: 1 of the 3 types
        traj_swept, traj_sampling, traj_sweep = phase_sweep(
            tmp, "traj_", TRAJ_SWEEP_MODELS,
            ["--noise-backend", "traj", "--n-traj", str(N_TRAJ)],
            {"QIDDM_PL_noise1": ("amp", 2 * 6 * SWEEP_ITERS * 5),
             "QNN_noise": ("amp", SWEEP_ITERS * 5)})
        for margs in TRAJ_SWEEP_MODELS:
            name = common.build_model(margs, device="cpu").save_name()
            for code in SWEEP_TYPES:
                for v in (0.1, 0.2, 0.3, 0.5, 0.8):
                    cache = tmp / f"traj_0/noise_{code}/{name}_outp_{v}_traj.pt"
                    if not cache.is_file():
                        fail(f"no trajectory cache {cache}")
        phase_sweep_parity(tmp, "traj_", TRAJ_SWEEP_MODELS, N_TRAJ)
        rebuttal_counts = phase_rebuttal(tmp, smi)
        exm_counts = phase_exm(tmp, smi)
        ray_counts = phase_ray(tmp, n_train, smi)
        t_wide = time.perf_counter()
        qnn16 = phase_wide_qnn(tmp, n_train, smi)
        pl12 = phase_wide_pl(tmp, n_train, smi)
        block_counts, block_rate, block_states, cnot_rates = (
            phase_wide_block(smi))
        traj14_counts, traj14_rate, _ = phase_traj14(smi)
        dm12_counts, dm12_rate = phase_dm12(smi)
        x64_counts = phase_x64_qiddm_a(tmp, smi)
        wide_wall = time.perf_counter() - t_wide
        print(f"phases 42-46 wall {wide_wall:.1f} s ({smi})")
    bench_counts, bench_rates = phase_wide_bench(smi)
    with torch.no_grad():
        times, library, pairs = phase_times(dev, smi)
        phase_wide_split(dev, smi)
        phase_crossover(dev, smi)
    uni_err, uni_bwd_err = phase_unitary_vs_plain(dev)
    unitary_counts = phase_unitary_route(dev)
    uni_times, uni_library, uni_pairs = phase_unitary_times(dev, smi)
    times.update(uni_times)
    library.update(uni_library)
    pairs.update(uni_pairs)
    with torch.no_grad():
        probe_errs = phase_probes_vs_plain(dev)
        probe_counts = phase_probe_tools()
        probe_times, probe_library, probe_pairs = phase_probe_times(dev, smi)
        phase_in_order_bits(dev)
    phase_pairs({**probe_pairs, **pairs}, smi)
    times.update({f"probe_{k}": v for k, v in probe_times.items()})
    library.update({f"probe_{k}": v for k, v in probe_library.items()})
    for name, rate in rates.items():
        print(f"sample {name}: steady sampling {rate:.1f} images/s ({N} "
              f"images x {ITERS} iterations per batch; {smi})")
    for name, rate in train_rates.items():
        print(f"train {name}: {rate:.1f} training images/s in epoch 2 "
              f"(batch 1, tau {TAU}; {smi})")
    print(f"traj sample {TRAJ_MODEL[0]} {' '.join(TRAJ_MODEL[1:])}: 12-wire "
          f"noisy sampling on the trajectory backend {traj_rate:.2f} images/s "
          f"({TRAJ_IMAGES} images x {TRAJ_ITERS} iterations, {N_TRAJ} "
          f"trajectories, amplitude damping {TRAJ_STRENGTH}; {smi})")
    print(f"sample {' '.join(WIDE_MODEL)} (monolith): steady sampling "
          f"{mono_rate:.1f} images/s ({N} images x {ITERS} iterations per "
          f"batch; {smi})")
    print(f"train {' '.join(WIDE_MODEL)} (monolith): {mono_train_rate:.1f} "
          f"training images/s in epoch 2 (batch 1, tau {TAU}; {smi})")
    for variant, by_width in bench_rates.items():
        for wires, rate in by_width.items():
            print(f"wide bench {wires} wires ({variant}): {rate:.3f} training "
                  f"steps/s (reupload_block L=14, k=2, batch 8, fwd+bwd; "
                  f"{smi})")
    for backend, run in (("dm", sweep), ("traj", traj_sweep)):
        for name, per_type in run["rates"].items():
            print(f"sweep {name}: noisy sampling on the {backend} backend "
                  f"{np.mean(per_type):.2f} images/s (10 images x "
                  f"{SWEEP_ITERS} iterations x 5 intensities per type; per "
                  f"type {', '.join(f'{r:.2f}' for r in per_type)}; {smi})")
        walls = run["walls"]
        print(f"sweep ({backend}) wall {walls['total']:.1f} s: sampling "
              f"{walls['sampling']:.1f} s, scoring on the host "
              f"{walls['scoring']:.1f} s, the rest (loading, clean training) "
              f"{walls['total'] - walls['sampling'] - walls['scoring']:.1f} s "
              f"({smi})")
    print(f"QIDDM-A {' '.join(QIDDM_A)}: {qa_train_rate:.1f} training "
          f"images/s, {qa_sample_rate:.1f} sampled images/s ({smi})")
    for label, (train_rate, sample_rate) in unet_rates.items():
        print(f"U-Net {label}: {train_rate:.1f} training images/s, "
              f"{sample_rate:.1f} sampled images/s, no port kernel ({smi})")
    for label, (_, _, train_rate, sample_rate) in (("QNN_noise 784 16 14",
                                                    qnn16),
                                                   (" ".join(PL12), pl12)):
        print(f"past the kernels' widths, {label}: {train_rate:.1f} training "
              f"images/s (first epoch), {sample_rate:.1f} sampled images/s "
              f"({smi})")
    print(f"past the kernels' widths: the {WIDE22[0]}-wire block "
          f"{block_rate:.3f} steps/s, peak {block_states:.2f} states; the "
          f"{CNOT16[0]}-wire CNOT block {cnot_rates['wide']:.3f} steps/s "
          f"grouped, {cnot_rates['adjoint']:.3f} per-gate adjoint; path A at "
          f"14 wires {traj14_rate:.2f} images/s; dm at 12 wires "
          f"{dm12_rate:.3f} images/s over {DM12_ITERS} iterations ({smi})")
    past_widths = [*qnn16[:2], *pl12[:2], block_counts, traj14_counts,
                   dm12_counts, x64_counts]
    runs = [*sampled.values(), trained, pl_trained, wide_trained, qa_counts,
            zoo_counts, swept, traj_counts, traj_swept, mono_model,
            unitary_counts, export_counts, app_counts, mesh_counts,
            *rebuttal_counts.values(),
            *exm_counts.values(),
            *ray_counts.values(), *past_widths,
            *(c for by_width in bench_counts.values()
              for c in by_width.values())]
    launches = {c: sum(r[c] for r in runs) for c in trained}
    # each wide row counts its own width's runs: the 16-wire model and
    # bench block, and the 20-wire bench block
    wide16 = (sampled[" ".join(WIDE_MODEL)], wide_trained, mono_model,
              export_counts,
              *(by_width[16] for by_width in bench_counts.values()))
    for c in ("wide", "wide_bwd", "wide_mono", "wide_mono_bwd"):
        launches[f"{c}16"] = sum(r[c] for r in wide16)
        launches[f"{c}20"] = sum(by_width[20][c]
                                 for by_width in bench_counts.values())
    launches.update({f"probe_{k}": v for k, v in probe_counts.items()})
    print(f"launches: sampling {sampled}, training {trained}, "
          f"QIDDM_PL_noise1 training {pl_trained}, 16-wire training "
          f"{wide_trained}, 16-wire monolith sampling and training "
          f"{mono_model}, QIDDM-A training and sampling {qa_counts}, the "
          f"zoo's steps and sampling {zoo_counts}, wide bench "
          f"{bench_counts}, noisy sweep {swept} "
          f"(while sampling, by model {sweep_sampling}), 12-wire trajectory "
          f"sampling {traj_counts}, trajectory sweep {traj_swept} (while "
          f"sampling, by model {traj_sampling}), the CNOT-ring route "
          f"{unitary_counts}, the rebuttal drivers {rebuttal_counts}, "
          f"fashion_exm and emnist_exm {exm_counts}, the sweep "
          f"{ray_counts}, past the kernels' widths (phases 42-46) "
          f"{past_widths}, the AOT artifacts and their live runs (phase 47) "
          f"{export_counts}, the application layer (phase 48) {app_counts}, "
          f"the mesh (phase 49) {mesh_counts}")
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s ({smi})")
    csrc = "qiddm_tpu_torch/csrc/"
    tpu = "qiddm_tpu/sim/pallas_gate_kernel.py:"
    wide_tpu = "qiddm_tpu/sim/pallas_wide_kernel.py:"
    rows = [  # name, source, TPU kernel file:line, counter, error, times key
        ("gate_chain_fwd", "gate_chain.cu", f"{tpu}130", "gate", max_err,
         "fwd"),
        ("gate_chain_bwd", "gate_chain.cu", f"{tpu}197", "gate_bwd", bwd_err,
         "bwd10"),
        ("sel_chain_fwd", "sel_chain.cu", f"{tpu}365", "sel", sel_err,
         "sel_fwd8_14_10_cz"),
        ("sel_chain_bwd", "sel_chain.cu", f"{tpu}384", "sel_bwd", sel_bwd_err,
         "sel_bwd8_14_10_cz"),
        ("sel_chain_fwd_w12", "sel_chain.cu", f"{tpu}365", "sel",
         sel_wide_err, "sel_fwd12_2_1000_cz"),
        ("sel_chain_bwd_w12", "sel_chain.cu", f"{tpu}384", "sel_bwd",
         sel_bwd_wide_err, "sel_bwd12_2_1000_cz"),
        ("sel_rows_fwd_w12", "sel_chain.cu", f"{tpu}365", "sel_rows",
         rows_err, "sel_rows_fwd12_2_1000_cz"),
        ("ry_chain_fwd", "ry_chain.cu", f"{tpu}703", "ry", ry_err,
         "ry_fwd8_10_12"),
        ("ry_chain_bwd", "ry_chain.cu", f"{tpu}732", "ry_bwd", ry_bwd_err,
         "ry_bwd8_10_12"),
        ("dm_chain_fwd", "dm_chain.cu",
         "qiddm_tpu/sim/pallas_dm_kernel.py:167", "dm", dm_err, "dm_fwd8"),
        ("amp_damp_fwd", "amp_damp.cu", f"{tpu}521", "amp", amp_err,
         "amp_fwd12"),
        # the backward rows carry the error relative to max(1, max|plain|)
        ("wide_chain_fwd", "wide_chain.cu", f"{wide_tpu}313", "wide16",
         _at_width(wide_errs, 16)[0], "wide_fwd16_10_28"),
        ("wide_chain_bwd", "wide_chain.cu", f"{wide_tpu}332", "wide_bwd16",
         _at_width(wide_errs, 16)[1], "wide_bwd16_10_28"),
        ("wide_chain_fwd_w20", "wide_chain.cu", f"{wide_tpu}313", "wide20",
         _at_width(wide_errs, 20)[0], "wide_fwd20_8_4"),
        ("wide_chain_bwd_w20", "wide_chain.cu", f"{wide_tpu}332",
         "wide_bwd20", _at_width(wide_errs, 20)[1], "wide_bwd20_8_4"),
        ("wide_mono_fwd_w16", "wide_mono.cu", f"{wide_tpu}143", "wide_mono16",
         _at_width(mono_errs, 16)[0], "wide_mono_fwd16_10_28"),
        ("wide_mono_bwd_w16", "wide_mono.cu", f"{wide_tpu}206",
         "wide_mono_bwd16", _at_width(mono_errs, 16)[1],
         "wide_mono_bwd16_10_28"),
        ("wide_mono_fwd_w20", "wide_mono.cu", f"{wide_tpu}143", "wide_mono20",
         _at_width(mono_errs, 20)[0], "wide_mono_fwd20_8_4"),
        ("wide_mono_bwd_w20", "wide_mono.cu", f"{wide_tpu}206",
         "wide_mono_bwd20", _at_width(mono_errs, 20)[1],
         "wide_mono_bwd20_8_4"),
        ("unitary_chain_fwd", "unitary_chain.cu",
         "qiddm_tpu/sim/pallas_kernels.py:36", "unitary", uni_err,
         "unitary_fwd8_80_28"),
        ("unitary_chain_bwd", "unitary_chain.cu",
         "qiddm_tpu/sim/pallas_kernels.py:72", "unitary_bwd", uni_bwd_err,
         "unitary_bwd8_80_28"),
        *((f"probe_{key}", "probes.cu", line, f"probe_{key}", probe_errs[key],
           f"probe_{key}")
          for key, line in (
              ("smem", "tools/bench_pallas_wide_probe.py:48"),
              ("transpose", "tools/bench_pallas_wide_probe.py:81"),
              ("reshape", "tools/bench_pallas_wide_probe.py:100"),
              ("matmul2", "tools/bench_pallas_wide_probe.py:124"),
              ("dot3d", "tools/bench_pallas_wide_probe.py:149"),
              ("fma", "tools/vpu_ceiling.py:33"))),
    ]
    # no single PyTorch call computes a gate chain, the dm block or the
    # amplitude-damping pass: their library_ms is null. The wide chain's
    # is its group products as complex64 torch.matmul calls (cuBLAS), the
    # unitary chain's its layer products (torch.matmul) with the phase
    # multiplies, and autograd's backward of those. The probes' is null for
    # the FMA probe: a chain of 4,096 torch calls would time launches, not
    # the FMA pipe.
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": csrc + src,
        "replaces": line, "launches": launches[counter],
        "max_abs_err": err, "ms": times[key][0], "plain_ms": times[key][1],
        "bound_ms": times[key][2], "bound_by": times[key][3],
        "datapath": datapath_of(key), "library_ms": library.get(key),
    } for name, src, line, counter, err, key in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
