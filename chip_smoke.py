#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (matchnerf_tpu_torch): the DTU eval
render of configs/test.yaml, its fused-cosine route and its bf16 decoder
route, the video entry of configs/demo_own.yaml and of
configs/test_video_own.yaml, the training step and the training loop
(`python -m matchnerf_tpu_torch.train`) of configs/train.yaml and
configs/train_fast.yaml, the eval entry (`python -m
matchnerf_tpu_torch.test`) of configs/test.yaml, test_video.yaml and
test_strict.yaml over DTU, LLFF, Blender and T&T test sets, and the
training entry of configs/train_ibrnet.yaml at 1008x756, and the render
server (`python -m matchnerf_tpu_torch.serve`) over HTTP, and the parallel
layer (process groups of one and two ranks, the training entry as 2
processes), and two to sixteen source views (`--n_src_views`: the
training entry at 2, 4, 6, 8 and 10, the eval entry at 2, 4, 8, 10 and
16, the fused route at 8 and 10), and the convergence run (the training
recipes learn a small scene and, at full width, phase 12's DTU scan, held
to their all-plain twins), and the variants config keys reach
(`nerf.view_dep: false`, the local-radius sampler, attention without
window splits, the fused route at 2 and 4 views; LPIPS and the training
entry's profile trace), on one NVIDIA card, through the hand-written CUDA
kernels; the images (the in-repo printer scene's JPEGs, the T&T tree's)
decode and resize on the host without PIL.

    python3 chip_smoke.py [--seed 0] [--profile]

Phases, any failure ends the run with a non-zero exit:
1. device: requires CUDA; prints the card (nvidia-smi name, power limit),
   torch and CUDA versions; builds the host library csrc/image_io.cpp (the
   host C++ compiler: the JPEG decoder and the resampler), then the kernels
   from csrc/ (nvcc), and prints both build times. TF32 is switched
   off for matmuls and cuDNN, so every f32 comparison is full f32.
2. scene: 4 cameras on an arc around the port's numpy raytracer scene
   (matchnerf_tpu_torch/data/synth.py), 640x512 images with DTU-like
   intrinsics and near/far; the model at full width (6 transformer layers,
   128 features, decoder width 128) from a seeded torch.Generator.
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes, with max |d|, tolerance, CUDA-event times, the bound (the
   larger of bytes over 3.35 TB/s and operations over the peak rate of the
   input type; for the tensor-core kernels the route's tensor-core rate,
   split TF32 at 495/3 TFLOP/s or bf16 at 989: Kernels A and A', and Kernel
   C's wide products plus its rest over the 67 TFLOP/s of f32) and, for
   Kernels A and E, one PyTorch library call computing the same function
   (scaled_dot_product_attention, grid_sample): window attention on 24 x
   1280 x 128 windows (bf16 and f32), timed with and without the training
   forward's logsumexp, which is held against torch.logsumexp of the plain
   masked scores, beside SDPA's time, its max |d| against the plain version
   and the names of its kernels (torch.profiler); on a 20480-ray slice built
   from the encoder's real tables and the pose's real buckets, the per-ray
   cosine prior (B), the block-union cosine prior (D, also held against B,
   with its union sizes and buckets; it builds its unions itself, so one
   call runs no device kernel but D's, which the profiler must show, and
   only the plain twin's torch union build is timed apart), the supercell
   colour sample (E, which reads no union), and the decoder (C) on both
   operand routes (split TF32 against the f32 plain version at 1e-4 / 1e-3
   / 1e-4 for rgb / depth / opacity; bf16 against the bf16 plain twin at
   1e-2 / 1e-2 / 1e-3, with its mean |d| under a tenth of the mean gap
   between the two twins: a sum
   in another order flips the bf16 rounding of an activation now and
   then, and the rays that meet one set the max), and again
   at S=256 on a 5012-ray slice with configs/test_video_own.yaml's decoder;
   on the first 8192 rays (one chunk of the fused route), the fused interp
   + grouped cosine (F) on the tap rows of the int8 tables at both scales
   (also held against B) and of bf16 and f32 tables built from the same
   features, with the row gather timed apart; Kernels B and D on bf16
   tables built from the same features (configs/train.yaml's validation
   and test renders), at the eval slice and at the 4096-ray validation
   slice, against their plain twins at 1e-4 and D against B; Kernel B's
   int4 form on the int4 tables `prepare_sampling_tables` builds from the
   same features (precision.cond_sample_dtype int4) at the eval slice,
   against its plain twin at 1e-4, timed beside its bound (int8's
   operations, half its table bytes) and its plain twin.
4. block path, configs/test.yaml as shipped: `Renderer.forward(batch,
   mode="test")` renders the full 640x512 target at S=128. The pose must
   take Kernel D at both scales and Kernel E for the colours; A, C, D and E
   must launch and no plain version may run on CUDA tensors; outputs
   finite, rgb in [0,1]; the same view with every kernel replaced by its
   plain version must agree at >= 50 dB PSNR.
5. per-ray path, block_kernel off: the same view through A, B and C (its
   f32 route only), which must each launch; it must agree with the block
   path at >= 60 dB. Then the same path with
   precision.decoder_matmul_dtype: bf16: C's bf16 route (only) must launch,
   and the image must agree with the all-plain bf16 render at >= 50 dB; its
   PSNR against the f32 image is printed.
6. fused path, configs/test.yaml with precision.fused_cosine: the same
   view with every feature scale through F (2 launches per slice), B and D
   never launched; it must agree with the block path at >= 60 dB. Then
   the f32 encoder of configs/test_strict.yaml (precision.strict): the
   scene's source views encoded through Kernel A's f32 route (12 launches
   of it and nothing else) and through the plain encoder, features within
   1e-4 (of the largest, at least 1), encode seconds of both.
7. video, configs/demo_own.yaml with precision.fused_cosine (the IBR
   decoder variant, S=128) at 256x160 on the in-repo printer scene
   (docs/demo_data, the COLMAP loader): first each printer JPEG decoded and
   resized to 256x160 by the port, held to PIL's sha256 of it
   (PRINTER_SHA256); then `Coach.test_model_video` renders the 24 frames of
   the interpolate path and writes them under build/chip_smoke/. A, C and F must launch (E
   on the frames whose colour union fits its bucket), B and D not, no plain
   version on CUDA; frames finite with rgb in [0,1]; frame 0 must agree
   with the all-plain frame at >= 50 dB. Prints frames/s and rays/s.
8. video, configs/test_video_own.yaml (S=256, 5012-ray slices) at 960x640
   on the printer scene (its JPEGs resized to 960x640 with LANCZOS): 3
   frames; A, B (2 per slice) and C (1 per slice) must launch and nothing
   else, no plain version on CUDA; frames finite with rgb in [0,1]; the
   first 2 slices of frame 0 must agree with all-plain at >= 50 dB.
9. training kernels at training shapes, each against autograd through its
   plain version, on the scene's real training rays (1024 random pixels,
   or 128 8-pixel strips for D'), stratified depths and the f32 tables of
   the bf16 training encoder: A' (window attention forward with logsumexp
   and backward, bf16 and f32, shifted and not; library yardstick SDPA
   with the float mask, its backward alone and forward + backward, with the
   names of its backward kernels), the B' table gradient per scale (and
   Kernel B's f32 forward at these shapes), D' f32 forward and backward
   per scale (also held against B and B', the same function; the largest
   training union is printed against its bucket). The A' backward also prints its TFLOP/s, counted as the
   function's 5 products (the kernels do 7); SDPA's backward, a call whose
   host work through autograd outlasts its kernels, is timed on the device
   (torch.profiler) beside its CUDA-event time.
10. configs/train.yaml step (`Coach.train_iteration`) on the 640x512 scene
   at full width, 1024 rays, S=128: a first step from one set of weights,
   rays and jitter through the kernels and all-plain (loss and per-tensor
   gradient error), with the recipe's bf16 policy and with the f32 policy;
   then 7 steps: finite losses, moving parameters, 12 A' forward, 12 A'
   backward, 2 B forward and 2 B' backward launches in each step and no
   plain version on CUDA tensors; ms per warm step and peak memory. After
   phase 11, 7 more train.yaml steps under the f32 policy (A and A' on
   their f32 route), checked and timed the same way.
11. configs/train_fast.yaml step: the same, with the pose's route through
   D' at both scales (2 D' forward and 2 D' backward launches per step).
12. the training loop: a synthetic DTU tree (6 views of the scene at
   640x512, PNGs written without PIL with each row's filter chosen as
   encoders choose it, so rows mix Up, Sub and Paeth, cameras with
   depth_min 425 and interval 2.5, 1200x1600 depth maps, its own meta
   dir); then per recipe (train.yaml, train_fast.yaml) the training CLI's
   `build_coach` and `train_model` for 4 steps of one epoch, validation and
   the mid-epoch checkpoint every 2 steps, the DTU test view and the epoch
   checkpoint; steps/s outside the hooks beside the loader's own seconds
   per sample: finite losses, `latest.ckpt` and `ep1_it4.ckpt`, PSNR and SSIM in
   scalars.jsonl, the table gradient through B' (train.yaml) or D'
   (train_fast.yaml) twice a step, no plain version on CUDA; one more
   validation image
   with its launches counted: Kernel D's bf16 form where the pose takes
   the block route (Kernel B's where a scale does not), no other table
   type; for train.yaml that image against the all-plain render (>= 50
   dB) and through Kernel B's bf16 form (block_kernel off) against the
   block route (>= 60 dB). Then `python -m matchnerf_tpu_torch.train` in a
   subprocess gets SIGTERM once its first mid-epoch checkpoint is on disk:
   exit 143 and `latest.ckpt` at an iteration inside the epoch; the resumed
   run (`--resume`) restores the model and the AdamW and schedule state
   bit for bit, starts at that iteration, skips the loaded batches and ends
   at the epoch's last. Steps per second (outside the hooks), validation
   seconds and peak memory are printed with the card's name and limit.
13. the eval entry: synthetic DTU (640x512), LLFF (960x640, eval_mode
   mvsnerf, forward-facing cameras), Blender (800x800, RGBA with a real
   alpha) and T&T (5 views as 1920x1056 4:2:0 JPEGs of the port's encoder,
   written by a process started after the kernel build; loaded at 960x640)
   test trees, one target view each, written by data/synth.py with
   their own meta dirs; then `matchnerf_tpu_torch.test.main(["--config",
   "test", "--load=", ...])` in this process at full
   width (6 transformer layers, decoder 128 x 6, S=128, seeded weights):
   per set A, C, D and E must launch (B too where a scale's union
   overflows its bucket, printed with the pose and scale), Kernel C with
   setbg on every Blender launch and nowhere else, no plain version on
   CUDA, rgb finite in [0,1], the whole image >= 50 dB against the
   all-plain render, the JAX package's output files; the render seconds,
   rays/s, route per scale, launches, and each eval kernel's device ms and
   launches in one more (profiled) render of the set (Kernel A's windows
   are L = 1280, 2400, 2500 and 2400 tokens; D's scale-1 tables 160x128,
   240x160, 200x200 and 240x160 cells). Then `--config test_video` (3 frames) on
   the LLFF tree (the spiral) and the Blender tree (interpolated, white
   background), frame 0 >= 50 dB against all-plain; then `--config
   test_strict` on the DTU tree: Kernel A's f32 route (12 launches), the
   cond query and decoder in torch ops (their plain versions on CUDA, as
   precision.strict asks), finite, its PSNR against the shipped-config
   render printed.
14. configs/train_ibrnet.yaml: a synthetic IBRNet tree (two groups of one
   scene, 8 forward-facing views each, PNGs at 1008x756) and an LLFF tree
   of its second scene, written by a process started after the kernel
   build, and a synthetic GMFlow checkpoint (a seeded encoder under
   `module.`, a 7th transformer layer, the flow upsampler and refinement);
   `train.build_coach` + `train_model` with `--encoder.pretrain_weight` on
   it (the backbone and transformer from the checkpoint, featup_net and the
   decoder from the seed): the sanity validation and LLFF gpnr test, 6
   steps (A and A' at [96,768,128]: the encoder resizes to 768x1024; B' at
   both scales), validation, test and the epoch checkpoint, losses finite,
   no plain version on CUDA; the resume, bit-equal; one validation and one
   test image alone: 94 slices of 8192 rays (the card caps the recipe's
   23552), A 12, C 94, D 188 on bf16 tables (or B where a scale
   overflows), E 94 launches, the first 2 slices >= 50 dB against
   all-plain, each kernel's device ms; C, D and E on one 23552-ray slice
   (on the weights before the steps, the same in every run) and B' on the
   96x128 / 192x256 f32 tables against their plain twins;
   the first step against all-plain (bf16-policy tolerances) and the warm
   step's ms, peak memory and launches with remat_encoder off and on (24
   A launches a step with it); A and A' bf16 at [96,768,128], unmasked and
   shifted, against their plain versions beside SDPA, with their bounds.
15. the render server: `matchnerf_tpu_torch.serve.serve` with
   configs/test.yaml as shipped and phase 2's model, max_scenes 2, on a
   daemon thread, driven over HTTP on 127.0.0.1 in the JSON + base64 wire
   format: /healthz reports cuda; POST /scenes with phase 2's 3 source
   views (Kernel A in a torch.profiler trace of the request); POST /render
   in float32 at phase 2's target and 2 more cameras of the arc, each
   bit-equal to a direct `Renderer.render_by_slices` on the scene's stored
   tables, the first >= 50 dB against the all-plain render, C, D and E in a
   trace of one request and their device ms in another, and uint8 equal
   to the float32 render quantised;
   POST /render_path, 9 frames interpolated and 8 of the spiral around the
   scene's 4 cameras (its stored c2ws_all), bit-equal to direct frames; 4
   concurrent /render requests bit-equal to the serial ones; DELETE (200,
   then 404) back to the device memory before the scene; 3 more scenes:
   the first evicted (404 on /render, its tensors freed), the level before
   them again once the others are deleted. Then tools/serve_smoke.py's
   printer run: the printer scene at 512x384 through the port's COLMAP
   loader, POST /scenes with its 3 source views (Kernel A), one /render at
   its target view (Kernel C) bit-equal to the direct render, DELETE.
   Prints /scenes seconds, each /render's round trip, render and pose_prep
   seconds, frames/s of each path, peak memory, with the card's name and
   power limit.
16. the parallel layer (matchnerf_tpu_torch/parallel/) at full width and
   640x512: (a) a process group of one rank on the card, which the backend
   rule must give NCCL, and one configs/train.yaml step through the
   gradient average: the gradients bit-equal before and after it and the
   parameters bit-equal to AdamW on the gradients without it. (b) two
   ranks spawned on the one card, which the rule must give gloo: 3 steps
   each of train.yaml and train_fast.yaml in rays mode with the encoder's
   streams split (Kernel A / A' at [12,1280,128] in each rank), the ranks'
   losses and parameter sums equal, every step launching A, A' and B, B'
   (train.yaml) or D', D' (train_fast.yaml) in each rank as often as a
   one-process step does, no plain version on CUDA; the first step against
   the one-process step from the same weights and draws at
   first_step_check's bf16-policy tolerances (loss, the averaged
   gradients), and the parameters where AdamW's first update is lr *
   sign(g) in both (|g| > 1e-4, one sign) within 1e-3 lr + 1e-6 |p|. (c)
   both ranks render phase 2's target with configs/test.yaml as shipped
   (4096 of every 8192-ray slice each, gathered): A, C, D and E in each
   rank, the ranks' images bit-equal, bit-equal to phase 4's render with
   the eval encoder's streams whole and >= 60 dB with them split. (d)
   `python -m matchnerf_tpu_torch.train --config train` as 2 processes
   (MATCHNERF_* set) on phase 12's DTU tree: 4 steps, a validation and the
   epoch checkpoint; both exit 0, rank 1's output_root stays empty, rank
   0's scalars hold 4 finite losses and the last is the loss both ranks
   log. Seconds per step and per render print beside the card's name and
   power limit; two ranks sharing one card say nothing about scaling.
17. the host's image I/O (no PIL: data/jpeg.py, data/resample.py): ms per
   decode of a printer JPEG and of encoder-made JPEGs (`seeded_photo`, 4:2:0,
   quality 95) at 1920x1056 and 4032x3024, ms per LANCZOS and per BILINEAR
   resize of each to 960x640 (means of 5 calls), the T&T loader's seconds
   per sample on phase 13's tree, and the decoded 1920x1056 JPEG held to
   PIL's sha256 of it (ROUNDTRIP_SHA256), with the card's name and limit;
   progressive JPEGs (SOF2): the committed fixtures (tests/data/
   jpeg_progressive/, PIL-written) each decoded and held to PIL's sha256
   (PROGRESSIVE_SHA256), the progressive printer (504x378) and photo
   (1920x1056) timed as the baseline files are, and the printer scene
   re-saved progressive as a COLMAP tree under build/, loaded by
   COLMAPDataset at 256x160 with each image held to PIL's decode and
   LANCZOS (PROGRESSIVE_TREE_SHA256); the phase's seconds.
18. two to sixteen source views (n_src_views), at full width, 640x512, S =
   128: (a) for V = 2, 4, 5, 6 and 8, a scene of V sources spread over
   -16..16 degrees of phase 2's arc and the target at 8 degrees, one encode
   of it, its eval tables ([V,64,80,(V-1)128] at G = 2 and
   [V,128,160,(V-1)128] at G = 8) and the pose's buckets: Kernel B on int8
   (`views_rays(V)` rays: 20480 to V = 4, 12288, 8192 and 4384 at V = 5, 6
   and 8, so the plain twins' f32 samples stay at their V = 4 size) and
   bf16 (4096 rays) tables, Kernel D on both at the pose's buckets, each
   against its plain twin at 1e-4, Kernel E on the supercell table at 1e-5
   and, past V = 4, Kernel F on one fused-route chunk (`fused_chunk_rays(V)`
   rays) as in 19 (a); on f32 tables of the same features at 1024 rays, B's
   f32 forward and D''s forward (8-pixel strips, their bucket, or the
   widest D' takes where it takes none: an overflowed union, against the
   plain twin at that bucket) at 1e-5, and B' and D' backward at 1e-5 of
   the largest gradient; each timed with CUDA events beside its bound
   (`prior_flops`, `prior_bwd_flops` at V). (b) `train.build_coach` +
   `train_model` with `--config train --n_src_views=2` and `--config
   train_fast --n_src_views=2` on phase 12's DTU tree from a written GMFlow
   checkpoint, 3 steps each without validation: the first step against the
   all-plain step (bf16-policy tolerances), B' (train.yaml) or D'
   (train_fast.yaml) twice a step, no plain version on CUDA, finite losses,
   `latest.ckpt` written. (c) `matchnerf_tpu_torch.test.main(["--config",
   "test", "--n_src_views=V", ...])` on the tree's DTU test view, V = 2
   with train.yaml's checkpoint (`--load`) and V = 4 with seeded weights
   (`--load=`): A, C, D and E launch, no plain version on CUDA, the image
   >= 50 dB against the all-plain render; the prior kernel each scale
   took, image seconds, rays/s and each eval kernel's device ms per launch.
   (d) on an 11-view synthetic DTU tree (`synth.write_dtu_scene(...,
   n_views=11)`), the eval entry as in (c) at V = 8 with seeded weights
   (V = 5's image gave way to V = 10 and 16, for time), and at V = 8
   with `--precision.fused_cosine=true` (A, C, E and F launch, B and D do
   not; held to the V = 8 image's all-plain render, the same weights, view
   and function); then (b) at V = 8 on that tree,
   and at V = 4 and 6 on a 9-view tree whose views lie half as far apart
   (`spread=MID_TREE_SPREAD`; phase 12's six views hold the V + 3 a
   training sample draws from only to V = 3, and on the 11-view tree every
   union at V = 4 and 6 overflows D''s buckets), where train_fast.yaml's
   scales take D' or B' as the route says (two of them a step, checked step
   by step, each step's scales logged; D' at one scale at least on the
   narrow tree), with the peak device memory of the steps. (e) past eight
   views (the run-time-V forms of B, B', D, D', F and E to 16): (a) at
   V = 10, 12 and 16 (`views_rays(V)`: 2728, 1856 and 1024 rays, B' and
   D' at `views_train_rays(V)`: 1024, 696, 384), Kernel D and D' at S =
   128 at the pose's buckets (the pair layout where every view's taps do
   not fit), and at V = 16 D and B at S = 256 on one slice of scale 1
   (`S256_RAYS`); then on a 17-view 320x256 tree at half the
   arc's angles (`WIDE_TREE_*`, `WIDE_EVAL_WH`) the eval entry at V = 10
   (A, C, E, and D or B per scale as `takes_table` routes it) and V = 16
   (A, Kernel Cg for the shipped decoder, C not launched, E, D at both
   scales, B not launched), each
   held to its all-plain render (slices of `plain_slice_rays(V)` rays),
   the fused image at V = 10 (held to the V = 10 all-plain render), and
   (b) at V = 10 on a 13-view 640x512 tree at the same angles with peak
   memory (`views_wide`; seeded weights whose density head is kept live,
   `live_density`, through `--load`). Each part's seconds under
   "part_s"; the phase's seconds on a line of their own.
19. the variants config keys reach, at full width, 640x512, S = 128: (a)
   Kernel F at V = 2 and 4 on the tap rows of one fused-route chunk (8192
   and 4096 rays, `fused_chunk_rays(V)`) of a
   V-source scene, gathered from its int8 tables (also against Kernel B)
   and from bf16 and f32 tables of the same features, against its plain
   twin at 1e-5, timed beside its bound (the rows' bytes over 3.35 TB/s).
   (b) `matchnerf_tpu_torch.test.main(["--config", "test", ...])` on phase
   12's DTU test view with `--nerf.view_dep=false` (seeded weights whose
   output layer is scaled to 0.01 with a density bias of 1: its outputs are
   raw), `--encoder.feature_sample_local_radius=1
   --encoder.feature_sample_local_dilation=2`,
   `--encoder.attn_splits_list=[1]`, `--precision.fused_cosine=true` at
   `--n_src_views=2` and 4, and int4 tables: `--precision.
   cond_sample_dtype=int4` (both scales on Kernel B's int4 form),
   `=[int8,int4]` (scale 0 on D, scale 1 on B's int4 form) and, with
   `--precision.fused_cosine=true`, `=[int8,int4p99.9]` (scale 0 on F,
   scale 1 on B's int4 form), and `--encoder.feature_upsampler=none`
   (both tables the transformer's 1/8 scale, A, C, D, E; held as the int4
   images: >= 50 dB on the plain encoder's features, >= INT4_WHOLE_DB
   whole, A's bf16 rounding reaching the cosines unsmoothed) (seeded
   weights): the kernels each route
   takes launch and the ones it skips do not (C under view_dep: false; A
   at one split; B, D and E on the local radius, which builds no table; B
   and D on the fused route; D and F on int4, D on the fused int4 route,
   F on [int8, int4]; B's int4 entry on every int4 route), no plain
   version on CUDA, finite outputs, the image >= 50 dB against the
   all-plain render; render seconds, rays/s and the launches of A-F; each
   int4 image's PSNR against the same route on int8 tables (the quality
   cost at seeded weights, no threshold). (c) `train.build_coach` + `train_model` with
   `--config train` and `--nerf.view_dep=false` (the same weights,
   `--load`, under `--profile_trace_dir`: the trace must exist and name A's
   forward and A''s dq and dkv kernels) and with the local radius, 3 steps
   each: the first step against the all-plain step (bf16-policy
   tolerances), finite losses, A' every step, B' twice a step (never on
   the local radius), no plain version on CUDA. (d) LPIPS(VGG) of a
   256x320 crop of the one-split image against its target on the card and
   on the CPU, from seeded weights in a temporary npz: within 1e-4.
20. Kernel Cg, the decoder at every other shape (`cg_phase`): (a) against
   its plain twin on CG_DECODERS (8192 rays x 128, 2048 x 512 at S = 512,
   both routes, Kernel C's tolerances), its CUDA-event time beside its
   bound and their ratio; (b) the eval entry's DTU image with the NeRF MLP
   and with standard coordinates + GELU through Cg, held to the same
   kernels with the plain decoder and to its CG_EVAL floor against
   all-plain; (c) 3 train.yaml steps with the NeRF MLP and (d) their
   checkpoint's image; (e) the shipped decoder still on Kernel C.
21. training repeats itself (`determinism_phase`): two same-seed runs of
   DET_STEPS steps each of train.yaml and train_fast.yaml at V = 3 on phase
   12's tree and of train.yaml at V = 8 on phase 18's 11-view tree, through
   `train.build_coach` + `train_model`: equal losses, 0 as the largest
   difference of any parameter and of any AdamW moment, and each run's
   checkpoint rendered by the eval entry, the two images bit-equal.
22. the convergence run (`convergence_phase`): (a) `python -m
   matchnerf_tpu_torch.convergence` at its defaults (32x48, 2 transformer
   layers, 128 features, decoder 128x6, S = 32, 256 rays, CONV_STEPS
   steps) for the tiny, train and train_fast recipes, each on the kernels
   and all-plain from one seed: the losses at 1 / 50 / 100 / 150 / 200,
   the target view's PSNR (each kernel run >= CONV_FLOOR_DB and within
   CONV_TWIN_DB of its twin; the tiny run beside the JAX tool's CPU figure,
   CONV_JAX_CPU_DB, not a bar), A' every step, B' every train step, B' or
   D' at each scale as `Coach.train_route` names it every train_fast step,
   no plain version on CUDA in the train and train_fast runs (the tiny
   recipe sets no banded or block kernel, so its matching prior takes the
   plain direct path, as in the JAX package); (b) `train.build_coach` +
   `train_model` with `--config train` and `--config train_fast` at full
   width on phase 12's tree from a written GMFlow checkpoint,
   CONV_FULL_STEPS steps, validation of view 24 before the first step and
   after the last and no other hook, on the kernels and again all-plain
   (`build_coach(kernel=False)`) from the same seed: each kernel run's
   validation PSNR up by CONV_FULL_GAIN_DB and within CONV_TWIN_DB of the
   all-plain run's, the mean loss of its last 20 steps at most half that
   of its first 20, the launches as in (a) step by step.
Every launch count is reset just before a path (a step, in 10 and 11; a
training run and a validation image, in 12; each test set's render, in
13; the training run, each image and the timed steps, in 14; each served
request, in 15; each rank's step and render, in 16; each training run and
image, in 18 to 21; each step and render in 22) and read just after it. With --profile, one more warm render of each eval path
(the bf16 decoder path too) and of each video, and one warm step of each
training recipe run under torch.profiler and print the device time by
kernel (the A' backward's dq and dkv kernels always by name), the device
busy time and the wall time.
The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""
import argparse
import copy
import gc
import json
import math
import os
import re
import signal
import subprocess
import sys
import time
import weakref

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
H, W = 512, 640
DTU_NEAR_FAR = (2.125, 4.525)
SLICE_RAYS = 20480
VAL_RAYS = 4096                    # configs/train.yaml nerf.rand_rays_test (val and test renders)
TRAIN_RAYS = 1024
TRAIN_STEPS = 7                    # steps per recipe; the first is warm-up
VIDEO_FRAMES = 24                  # configs/demo_own.yaml nerf.video_n_frames
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, f32 without tensor cores
# the tensor-core rate of a kernel's operand route (Kernel C's wide products,
# Kernels A and A'): bf16 at the bf16 peak; split TF32 takes three TF32
# products (495 TFLOP/s) for each f32 one
TC_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
OWN_FRAMES = 3                     # frames of the configs/test_video_own.yaml phase
OWN_PLAIN_SLICES = 2               # slices of its frame 0 held to all-plain
LOOP_STEPS = 4                     # training steps per recipe in the loop phase
PREEMPT_STEPS = 8                  # steps of the run that is sent SIGTERM
PROFILE_PAD_S = 0.005              # idle host seconds at each end of a kernel trace
# the in-repo demo scene (configs/demo_own.yaml): 3 baseline 4:2:0 JPEGs at
# 504x378, resized to 256x160 with LANCZOS; sha256 of each decoded uint8
# image and of it resized, as PIL gives them (tests/test_torch_image_io.py)
PRINTER_DIR = os.path.join(REPO, "docs", "demo_data", "printer", "images")
PRINTER_WH = (256, 160)
PRINTER_SHA256 = {
    "0.jpeg": ("a0edc9f82a41400d7dfc22eeb8abcc541ebe7e135a704ee01f818be83f73fe5e",
               "9ec07d8522b795785ca79e2ff3aad5f5be8f937064d95c0279231b54e6863972"),
    "1.jpeg": ("f705715eff8277e97415a263ef777880acf7d059cd177919629db64f6f744b51",
               "6063ab3b232b2d4a857e108bd93c1a903348b665ab798f130de94f61520e2146"),
    "2.jpeg": ("da3ec1825d20314ec21b9e2711ab592c66d04870a53e66966380be5275539d66",
               "8d2b4bc96ea96bafa528cb66d9d8bbc1b4c3e19bff5be8240a6a45750d3a343d"),
}
# progressive JPEGs (SOF2) written with PIL (tests/test_torch_image_io_progressive.py
# `write_fixtures`): the sha256 of each decoded uint8 image as PIL gives it,
# and of the printer ones resized to PRINTER_WH with LANCZOS, as the COLMAP
# loader gives them from the printer scene re-saved progressive
PROGRESSIVE_DIR = os.path.join(REPO, "tests", "data", "jpeg_progressive")
PROGRESSIVE_SHA256 = {
    "grey.jpg":
        "3f1f51026d6f91494914937ed9fdcfe1a679edeae8514726284f57e674af6092",
    "photo_1920x1056.jpg":
        "2a9a1682281d458663c0e38d1d9856125ff44621838010ff7333b856939566d0",
    "printer_0.jpg":
        "53ccb218e54b7b2689f8c76bffb3ab9ed1d548e0aa267373a60443bd89332577",
    "printer_0_dc_only.jpg":
        "9b829d1258c11dc0477e36c465c4dccb68e16b4ea9b2b96f537ae04e4b65a7fe",
    "printer_0_no_refine.jpg":
        "071ea4362436cb3d3375ffb1eb2217c8a9062e8bf34ac1fa6c9e5880eb5d6192",
    "printer_1.jpg":
        "544631cc272f33ca00b58d99d610546fe16ce96faf95b6ff3ac1197c2f879762",
    "printer_2.jpg":
        "1e30c197fc640fc40ed9ee3edd9c0a9b069aa7bd2cb72622dcf491c7ec97fee6",
    "restart_444.jpg":
        "29b39bab80762df8c6135634f1bed28c4f1cce5078205fca8a054f8009c2538d",
}
PROGRESSIVE_TREE_SHA256 = {
    "printer_0.jpg": "c30253e732531885fea22d108d144d946ea759ebb167a947749a4b1d2078f7a3",
    "printer_1.jpg": "b890c3df6a27595c85b08092067ac2af876314dad8c8f6a22d22ea55b59caa1a",
    "printer_2.jpg": "77f43c03dd78c9c985290cbf3318b3ed0269876485352d98965bdde58abd67f3",
}
# decode(encode_jpeg(seeded_photo(1920, 1056), quality 95)), as PIL decodes it
ROUNDTRIP_WH = (1920, 1056)
ROUNDTRIP_SHA256 = "1380d86de3744f0826d4e0ca1422b65d1ccadf63aff0c678b6fab6dd50c28549"
TNT_JPEG_WH = (1920, 1056)         # the T&T tree's JPEGs; configs/test.yaml loads 960x640
HOST_IO_WH = ((1920, 1056), (4032, 3024))   # encoder-made JPEGs timed in the host phase


def log(msg):
    print(msg, flush=True)


def seeded_photo(w, h, seed=0):
    """A [h, w, 3] uint8 image in integer arithmetic only (the same bytes on
    every machine): bilinear between random colours 32 pixels apart, plus
    uniform noise in [-6, 6], like a photo's smooth areas and grain."""
    rng = np.random.default_rng(seed)
    cell = 32
    low = rng.integers(0, 256, (h // cell + 2, w // cell + 2, 3)).astype(np.int64)
    y, x = np.arange(h), np.arange(w)
    y0, fy = y // cell, (y % cell)[:, None, None]
    x0, fx = x // cell, (x % cell)[None, :, None]
    top = low[y0][:, x0] * (cell - fx) + low[y0][:, x0 + 1] * fx
    bottom = low[y0 + 1][:, x0] * (cell - fx) + low[y0 + 1][:, x0 + 1] * fx
    img = (top * (cell - fy) + bottom * fy + cell * cell // 2) // (cell * cell)
    return np.clip(img + rng.integers(-6, 7, img.shape), 0, 255).astype(np.uint8)


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters):
    """Mean milliseconds per call from CUDA events, after two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters):
    """Mean device milliseconds per call: the summed time of the kernels
    `fn` launches (torch.profiler), after two warm-up calls. For a call
    whose host work outlasts its kernels, where CUDA events around a run of
    calls measure the host."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_time_total > 0) / 1e3 / iters


def kernel_names(torch, fn, iters=3, attempts=3):
    """The names of the device kernels `fn` runs (torch.profiler). The calls
    sit inside the traced window with PROFILE_PAD_S of idle host time at
    both ends, and a trace that recorded no device kernel at all is taken
    again, up to `attempts` times: the profiler can come back empty for a
    window that holds only a kernel or two of well under a millisecond."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        names = sorted({e.key[:120] for e in prof.key_averages()
                        if e.device_type.name == "CUDA" and e.device_time_total > 0})
        if names:
            return names
        log(f"torch.profiler recorded no device kernel in trace {attempt} of {attempts}")
    return []


def only_kernel(torch, fn, name):
    """The device kernels three calls of `fn` run; fails unless there is one
    and every one is the named kernel (a wrapper that launches nothing but
    its kernel)."""
    names = kernel_names(torch, fn)
    if not names or any(name not in k for k in names):
        raise AssertionError(f"{name}: the call ran {names}, not only its kernel")
    return names


def bound(nbytes, flops, dtype="float32", rates=PEAK_FLOPS):
    """(bound ms, 'bytes' or 'operations'): the least time for the work,
    its operations at rates[dtype]."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rates[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def prior_flops(n_samples, scaled, n_views=3):
    """Operations of Kernel B / D's function with V = n_views source views:
    7 flops per (sample, view, channel) of the V (V-1) 128-channel rows for
    the four bilinear taps (4 multiplies, 3 adds), one more to dequantise
    rows that carry a scale (int8), and 6 per (sample, pair, chunk channel)
    of the V (V-1) / 2 pairs for the grouped cosine."""
    V = n_views
    return n_samples * (V * (V - 1) * 128 * (7 + bool(scaled)) + V * (V - 1) // 2 * 128 * 6)


def prior_bwd_flops(n_samples, n_views=3):
    """Operations of the B' / D' backward's function with V = n_views: 16
    flops per (sample, view, channel) (the interpolation again and the
    scatter of each side's gradient to four taps), 12 per (sample, pair,
    chunk channel) (the cosine and its gradient)."""
    V = n_views
    return n_samples * (V * (V - 1) * 128 * 16 + V * (V - 1) // 2 * 128 * 12)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def arc_eye(angle):
    """A camera centre on the scene's arc (radius 3.7 at height -1) at
    `angle` radians; the cameras look at synth.make_scene_views's target."""
    return (3.7 * math.sin(angle), -1.0, -3.7 * math.cos(angle))


def make_scene(seed, n_src=3):
    """n_src + 1 posed 640x512 views of the synthetic scene: the sources
    spread evenly over -16..16 degrees of the arc, the last view the target
    at 8 degrees."""
    from matchnerf_tpu_torch.data import synth
    rng = np.random.default_rng(seed)
    angles = (np.deg2rad(list(np.linspace(-16.0, 16.0, n_src)) + [8.0])
              + rng.uniform(-0.02, 0.02, n_src + 1))
    eyes = [arc_eye(a) for a in angles]
    views = synth.make_scene_views(W, H, focal=1.8 * W, eyes=eyes)
    near_fars = np.tile(np.asarray(DTU_NEAR_FAR, np.float32), (n_src + 1, 1))
    return {"images": views["images"][None],
            "extrinsics": views["w2cs"][None],
            "intrinsics": views["intrinsics"][None],
            "near_fars": near_fars[None]}


def psnr(a, b):
    """PSNR in dB on the [0, 1] scale; identical images give 999.0 (a
    number that strict JSON readers accept)."""
    mse = float(((a.double() - b.double()) ** 2).mean())
    return 999.0 if mse == 0.0 else -10.0 * math.log10(mse)


def profile_call(torch, name, fn, top=12, keep=()):
    """One warm call of `fn` under torch.profiler: device time by kernel
    (top `top`, and every kernel whose name contains one of `keep`), summed
    device time, and the wall time around it."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    if not rows:       # older profilers report device time on the CPU-side ops
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    n_ops = sum(r[2] for r in rows)
    log(f"profile {name}: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({100.0 * (1.0 - busy / (wall * 1e3)):.1f} % idle), {n_ops} device operations")
    shown = rows[:top] + [r for r in rows[top:] if any(k in r[0] for k in keep)]
    for key, ms, count in shown:
        log(f"profile {name}:   {ms:9.2f} ms  {count:5d}x  {key[:100]}")
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy, "device_ops": n_ops,
            "top": [[k[:100], ms, c] for k, ms, c in shown]}


def check_close(name, err, tol):
    if not err <= tol:
        raise AssertionError(f"{name}: max|d| {err} > {tol}")


def max_abs(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max())


def grad_errors(model_a, model_b):
    """Per parameter tensor, ||grad_a - grad_b|| / ||grad_b|| in float64,
    the denominator floored at 1e-3 of the largest gradient norm."""
    pairs = [(n, pa.grad.double(), pb.grad.double())
             for (n, pa), (_, pb) in zip(model_a.named_parameters(), model_b.named_parameters())]
    floor = 1e-3 * max(float(gb.norm()) for _, _, gb in pairs)
    return {n: float((ga - gb).norm()) / max(float(gb.norm()), floor) for n, ga, gb in pairs}


def decoder_flops(dec, S):
    """Kernel C's operations per sample: (the wide products, 2 per weight of
    pts_bias, the pts_linears, alpha_linear, feature_linear, views_linears.0
    and rgb_linear; the f32 remainder, 2 per weight of w_qs, w_ks, w_vs, fc
    and out_alpha_linear, the ray attention's QK and PV over S samples and
    the 60 sin/cos of the encoding)."""
    wide = [dec.pts_bias, *dec.pts_linears, dec.alpha_linear[0], dec.feature_linear,
            dec.views_linears[0], dec.rgb_linear]
    ra = dec.ray_attention
    rest = [ra.w_qs, ra.w_ks, ra.w_vs, ra.fc, dec.out_alpha_linear[0], dec.out_alpha_linear[2]]
    return (2 * sum(m.weight.numel() for m in wide),
            2 * sum(m.weight.numel() for m in rest) + 4 * S * 16 + 60)


def decoder_bound(nbytes_, flops, N, route):
    """A decoder kernel's bound on one route for N samples, `flops` its
    (wide, remainder) operations per sample: the wide products over the
    route's tensor-core rate plus the remainder over the f32 CUDA-core rate,
    against the bytes over the memory rate."""
    wide, rest = flops
    t_ops = (N * wide / TC_FLOPS[route] + N * rest / PEAK_FLOPS["float32"]) * 1e3
    t_bytes = nbytes_ / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decoder_case(torch, kc, dev, args, label):
    """Kernel C on both operand routes against its plain twins on one slice:
    max |d| per output and tolerance, for bf16 also the mean |d| against a
    tenth of the mean gap between the f32 and bf16 twins; CUDA-event times
    and the per-route bound."""
    dec = args[0]
    R, S = args[2].shape[1], args[2].shape[2]
    N = R * S                                   # samples
    ins = [args[2], args[3], *args[4].values(), args[5], args[6]]
    out = {}
    with torch.no_grad():
        twins = {r: kc.cond_nerf_decode_plain(*args, matmul_dtype=getattr(torch, r))
                 for r in ("float32", "bfloat16")}
        gap = float(torch.cat([(a - b).abs().flatten() for a, b in
                               zip(twins["float32"], twins["bfloat16"])]).mean())
        # bf16: a product summed in another order than the twin's rounds an
        # activation to the neighbouring bf16 value now and then; the few
        # rays that meet such flips set the max, the mean |d| (held under a
        # tenth of the twins' gap) shows the function
        for route, tols in (("float32", (1e-4, 1e-3, 1e-4)), ("bfloat16", (1e-2, 1e-2, 1e-3))):
            md = getattr(torch, route)
            got = kc.cond_nerf_decode(*args, matmul_dtype=md)
            ref = twins[route]
            torch.cuda.synchronize()
            errs = [max_abs(g, r) for g, r in zip(got, ref)]
            diffs = torch.cat([(g - r).abs().flatten() for g, r in zip(got, ref)])
            mean_err = float(diffs.mean())
            n_over = int((diffs > 1e-3).sum())
            ms = cuda_ms(torch, lambda: kc.cond_nerf_decode(*args, matmul_dtype=md), 10)
            plain_ms = cuda_ms(torch, lambda: kc.cond_nerf_decode_plain(*args, matmul_dtype=md), 3)
            small, frag = kc.kernel_weights(dec, md, dev)
            wide, rest = decoder_flops(dec, S)
            b_ms, b_by = decoder_bound(nbytes(*ins, *got, small, frag), (wide, rest), N, route)
            log(f"kernel C cond_nerf_decode {label} R={R} S={S} {route} route: max|d| rgb "
                f"{errs[0]:.3e} depth {errs[1]:.3e} opacity {errs[2]:.3e} (tol {tols}), {n_over} "
                f"of {diffs.numel()} above 1e-3, mean|d| {mean_err:.3e} (f32 vs bf16 twins "
                f"{gap:.3e}), {ms:.3f} ms vs plain "
                f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}: {N * wide / 1e12:.3f} TFLOP "
                f"of wide products at {TC_FLOPS[route] / 1e12:.0f} TFLOP/s + "
                f"{N * rest / 1e12:.4f} TFLOP at 67)")
            for name, err, tol in zip(("rgb", "depth", "opacity"), errs, tols):
                check_close(f"cond_nerf_decode {label} {route} {name}", err, tol)
            if route == "bfloat16" and not mean_err < 0.1 * gap:
                raise AssertionError(f"cond_nerf_decode {label} bf16: mean|d| {mean_err} is not "
                                     f"under a tenth of the f32-bf16 gap {gap}")
            out[route] = dict(R=R, S=S, max_abs_err=max(errs), max_abs_err_rgb_depth_opacity=errs,
                              tol=list(tols), mean_abs_err=mean_err, n_above_1e3=n_over,
                              twin_gap_mean=gap, ms=ms,
                              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            del got
    return out


def train_kernel_phase(torch, F, dev, batch, seed, block_ut, res):
    """Phase 9: A', B' and D' at the training shapes against autograd
    through their plain versions."""
    from matchnerf_tpu_torch import camera
    from matchnerf_tpu_torch.config import dtu_train_config
    from matchnerf_tpu_torch.models.matchnerf import (encode, init_matchnerf,
                                                      prepare_sampling_tables,
                                                      project_to_views, sample_depth)
    from matchnerf_tpu_torch.ops import block_cosine_prior as kd
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    from matchnerf_tpu_torch.ops import window_attention as ka
    from matchnerf_tpu_torch.ops.attention import shift_region_ids
    from matchnerf_tpu_torch.renderer import Renderer, extract_poses
    from matchnerf_tpu_torch.train_step import sample_ray_indices

    grad = torch.autograd.grad
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    # A': 24 windows (2 streams x 3 pairs x 2x2 splits) of the 1/8-scale map
    h8, w8 = H // 8, W // 8
    BW, L = 24, h8 * w8 // 4
    rid = shift_region_ids(h8, w8, 2, device=dev)
    rows = rid[torch.arange(BW, device=dev) % rid.shape[0]]
    res["A_bwd"] = {}
    prod = 2 * BW * L * L * 128                  # flops of one score-sized product
    for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
        name = str(dt).replace("torch.", "")
        for shift in (False, True):
            r = rid if shift else None
            q, k, v, do = (torch.randn(BW, L, 128, generator=gen, device=dev).to(dt)
                           for _ in range(4))
            qk = [t.clone().requires_grad_() for t in (q, k, v)]
            qp = [t.clone().requires_grad_() for t in (q, k, v)]
            out = ka.window_attention(*qk, r)
            outp = ka.window_attention_plain(*qp, r)
            gk = grad(out, qk, do, retain_graph=True)
            gp = grad(outp, qp, do, retain_graph=True)
            torch.cuda.synchronize()
            err = max(max_abs(a, b) for a, b in zip(gk, gp))
            tol_abs = tol * max(float(b.float().abs().max()) for b in gp)
            err_out = max_abs(out, outp)
            fwd_ms = cuda_ms(torch, lambda: ka.window_attention(*qk, r), 10)
            # the backward kernels timed alone; through autograd the host's
            # own time per call comes near the kernels' and is timed apart
            o, lse = out.detach(), ka.window_attention_forward(q, k, v, r, with_lse=True)[1]
            ms = cuda_ms(torch, lambda: ka.window_attention_backward(q, k, v, o, lse, do, r), 20)
            autograd_ms = cuda_ms(torch, lambda: grad(out, qk, do, retain_graph=True), 10)
            plain_ms = cuda_ms(torch, lambda: grad(outp, qp, do, retain_graph=True), 5)
            ql = [t[:, None].detach().clone().requires_grad_() for t in (q, k, v)]
            mask = None
            if shift:
                mask = torch.where(rows[:, :, None] != rows[:, None, :], -100.0, 0.0)
                mask = mask[:, None].to(dt)
            outl = F.scaled_dot_product_attention(*ql, attn_mask=mask)
            gl = grad(outl, ql, do[:, None], retain_graph=True)
            lib_err = max(max_abs(a[:, 0], b) for a, b in zip(gl, gp))
            # the library's backward through autograd: the host's time per
            # call is near its kernels', so its device time is the yardstick
            lib_bwd = lambda: grad(outl, ql, do[:, None], retain_graph=True)
            lib_ms = device_ms(torch, lib_bwd, 10)
            lib_events_ms = cuda_ms(torch, lib_bwd, 10)
            lib_kernels = kernel_names(torch, lib_bwd)
            # forward + backward together, the kernels' and the library's
            fb_ms = cuda_ms(torch, lambda: ka.window_attention_backward(
                q, k, v, *ka.window_attention_forward(q, k, v, r, with_lse=True), do, r), 20)
            lib_fb_ms = device_ms(torch, lambda: grad(
                F.scaled_dot_product_attention(*ql, attn_mask=mask), ql, do[:, None]), 10)
            b_ms, b_by = bound(nbytes(q, k, v, out, do, lse, *gk), 5 * prod, name, TC_FLOPS)
            tag = f"{name}_{'shift' if shift else 'noshift'}"
            tflops = 5 * prod / ms / 1e9             # the function's 5 products
            log(f"kernel A' window_attention backward {name} [{BW},{L},128] "
                f"{'shift-masked' if shift else 'unmasked'}: max|d| dq/dk/dv {err:.3e} "
                f"(tol {tol_abs:.3e}), out {err_out:.3e}; forward with logsumexp "
                f"{fwd_ms:.3f} ms; backward {ms:.4f} ms ({tflops:.1f} TFLOP/s, 5 products; "
                f"through autograd {autograd_ms:.4f} ms) vs plain {plain_ms:.3f} ms, "
                f"library SDPA backward {lib_ms:.4f} ms on the device (CUDA events around "
                f"the autograd call {lib_events_ms:.4f} ms; max|d| {lib_err:.3e}); forward + "
                f"backward {fb_ms:.3f} ms vs SDPA {lib_fb_ms:.3f} ms on the device; bound "
                f"{b_ms:.4f} ms ({b_by}, 5 products at {TC_FLOPS[name] / 1e12:.0f} TFLOP/s); "
                f"SDPA's backward kernels {lib_kernels}")
            check_close(f"window_attention backward {tag}", err, tol_abs)
            res["A_bwd"][tag] = dict(max_abs_err=err, tol=tol_abs, ms=ms, tflops=tflops,
                                     autograd_ms=autograd_ms, fwd_ms=fwd_ms,
                                     plain_ms=plain_ms, library_ms=lib_ms,
                                     library_events_ms=lib_events_ms,
                                     library_max_abs_err=lib_err, library_kernels=lib_kernels,
                                     fwd_bwd_ms=fb_ms,
                                     library_fwd_bwd_ms=lib_fb_ms, bound_ms=b_ms,
                                     bound_by=b_by)
            del q, k, v, do, qk, qp, out, outp, gk, gp, ql, outl, gl, mask, o, lse, lib_bwd

    # B' and D' on the scene's training rays with the training f32 tables
    tcfg = dtu_train_config()
    tmodel = init_matchnerf(tcfg, torch.Generator().manual_seed(seed)).to(dev)
    r0 = Renderer(tcfg, tmodel, dev)
    ref_images = r0.tensor(batch["images"][:, :3])
    with torch.no_grad():
        ttables = prepare_sampling_tables(tcfg, encode(tmodel, tcfg, ref_images), ref_images)
    poses = extract_poses(batch)
    tgt_intr, c2w, tgt_nf, ref_w2c, ref_intr, ref_nf = r0._pose_tensors(poses)
    R = TRAIN_RAYS

    def train_grids(patches):
        idx = sample_ray_indices(H * W, R, patches, dev, gen)
        pix = torch.stack([(idx % W).float(), (idx // W).float()], -1)[None]
        center, ray = camera.get_center_and_ray(pix, tgt_intr, c2w)
        depth = sample_depth(tcfg, tgt_nf, 1, R, stratified=True, generator=gen)
        pts = camera.get_3d_points_from_depth(center, ray, depth, multi_samples=True)
        return (project_to_views(pts, ref_w2c, ref_intr, ref_nf, H, W)[..., :2]
                * 2.0 - 1.0)[:, 0].contiguous()

    grids_ray, grids_strip = train_grids(False), train_grids(True)
    S = grids_ray.shape[2]
    N = R * S
    for key in ("B_f32", "B_bwd", "D_f32", "D_bwd"):
        res[key] = []
    for s, G in enumerate(tcfg.encoder.cos_n_group):
        table = ttables["view_feats"][s][0]
        h, w = table.shape[1:3]
        gcot = torch.randn(R, S, G, generator=gen, device=dev)
        fwd_flops = prior_flops(N, scaled=False)          # f32 tables
        bwd_flops = prior_bwd_flops(N)
        bwd_bound = bound(2 * nbytes(table) + nbytes(grids_ray, gcot), bwd_flops)

        def backward_pair(fn_k, fn_p, grids):
            tk = table.clone().requires_grad_()
            tp = table.clone().requires_grad_()
            ok, op = fn_k(tk, grids), fn_p(tp, grids)
            dk, dp = grad(ok, tk, gcot, retain_graph=True)[0], grad(op, tp, gcot,
                                                                  retain_graph=True)[0]
            torch.cuda.synchronize()
            err = max_abs(dk, dp)
            tol = 1e-5 * float(dp.abs().max())
            ms = cuda_ms(torch, lambda: grad(ok, tk, gcot, retain_graph=True), 10)
            plain_ms = cuda_ms(torch, lambda: grad(op, tp, gcot, retain_graph=True), 3)
            return dk, err, tol, ms, plain_ms

        # Kernel B's f32 forward at the training shapes (the forward of B')
        with torch.no_grad():
            fb = lambda: kb.cosine_prior(table, grids_ray, None, G)
            fbp = lambda: kb.cosine_prior_plain(table, grids_ray, None, G)
            out_b = fb()
            err = max_abs(out_b, fbp())
            b_ms, b_by = bound(nbytes(table, grids_ray, out_b), fwd_flops)
            res["B_f32"].append(dict(scale=s, max_abs_err=err, ms=cuda_ms(torch, fb, 10),
                                     plain_ms=cuda_ms(torch, fbp, 3), bound_ms=b_ms,
                                     bound_by=b_by))
        check_close(f"B f32 forward scale {s}", err, 1e-5)
        dk_b, err, tol, ms, plain_ms = backward_pair(
            lambda t, g_: kb.cosine_prior(t, g_, None, G),
            lambda t, g_: kb.cosine_prior_plain(t, g_, None, G), grids_ray)
        log(f"kernel B cosine_prior f32 forward scale {s} table {list(table.shape)} G={G} "
            f"R={R} S={S}: max|d| {res['B_f32'][-1]['max_abs_err']:.3e} (tol 1e-5), "
            f"{res['B_f32'][-1]['ms']:.3f} ms vs plain {res['B_f32'][-1]['plain_ms']:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        log(f"kernel B' cosine_prior backward scale {s}: max|d| d_table {err:.3e} (tol "
            f"{tol:.3e}), {ms:.3f} ms vs plain {plain_ms:.3f} ms, bound "
            f"{bwd_bound[0]:.4f} ms ({bwd_bound[1]})")
        check_close(f"B' scale {s}", err, tol)
        res["B_bwd"].append(dict(scale=s, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bwd_bound[0], bound_by=bwd_bound[1]))

        # D' on the 8-pixel strips: the pose's bucket, the training union
        ut = block_ut[s]
        if not kd.takes_f32(ut, S, G):
            raise AssertionError(f"D' does not take ut={ut} G={G} S={S}")
        gp = kd.pad_rays(grids_strip)
        union = kd.block_union_size_raw(gp, h, w)
        with torch.no_grad():
            fd = lambda: kd.block_cosine_prior(table, grids_strip, None, G, ut)
            fdp = lambda: kd.block_cosine_prior_plain(table, grids_strip, None, G, ut)
            out_d = fd()
            err = max_abs(out_d, fdp())
            err_b = max_abs(out_d, kb.cosine_prior(table, grids_strip, None, G))
            d_ms, d_by = bound(nbytes(table, grids_strip, out_d), fwd_flops)
            entry = dict(scale=s, max_abs_err=err, max_abs_err_vs_kernel_b=err_b,
                         ms=cuda_ms(torch, fd, 10), plain_ms=cuda_ms(torch, fdp, 3),
                         plain_union_ms=cuda_ms(torch, lambda: kd.block_unions(gp, h, w, ut),
                                                10),
                         bound_ms=d_ms, bound_by=d_by, ut=ut, train_union_size=union)
        log(f"kernel D' block_cosine_prior f32 forward scale {s} G={G} R={R} S={S} (strips): "
            f"training union {union} rows vs bucket {ut} (pose_prep, eval-spaced "
            f"depths){' OVERFLOW: missing taps add 0' if union > ut else ''}; max|d| "
            f"{err:.3e} (tol 1e-5), vs kernel B {err_b:.3e} (tol 1e-5), {entry['ms']:.3f} ms "
            f"(the kernel builds its union; the plain twin's torch build "
            f"{entry['plain_union_ms']:.3f} ms) vs plain {entry['plain_ms']:.3f} ms, bound "
            f"{d_ms:.4f} ms ({d_by})")
        check_close(f"D' forward scale {s}", err, 1e-5)
        check_close(f"D' vs B forward scale {s}", err_b, 1e-5)
        res["D_f32"].append(entry)
        dk_d, err, tol, ms, plain_ms = backward_pair(
            lambda t, g_: kd.block_cosine_prior(t, g_, None, G, ut),
            lambda t, g_: kd.block_cosine_prior_plain(t, g_, None, G, ut), grids_strip)
        tk = table.clone().requires_grad_()
        dk_b = grad(kb.cosine_prior(tk, grids_strip, None, G), tk, gcot)[0]
        err_b = max_abs(dk_d, dk_b) if union <= ut else None
        log(f"kernel D' block_cosine_prior backward scale {s}: max|d| d_table {err:.3e} "
            f"(tol {tol:.3e}), vs kernel B' {err_b if err_b is None else f'{err_b:.3e}'}, "
            f"{ms:.3f} ms vs plain {plain_ms:.3f} ms, bound {bwd_bound[0]:.4f} ms "
            f"({bwd_bound[1]})")
        check_close(f"D' backward scale {s}", err, tol)
        if err_b is not None:
            check_close(f"D' vs B' backward scale {s}", err_b, tol)
        res["D_bwd"].append(dict(scale=s, max_abs_err=err, tol=tol, max_abs_err_vs_kernel_b=err_b,
                                 ms=ms, plain_ms=plain_ms, bound_ms=bwd_bound[0],
                                 bound_by=bwd_bound[1]))
        del table, out_b, out_d, dk_b, dk_d
    del tmodel, ttables


def first_step_check(torch, dev, cfg, batch, seed, label, tol, img_hw=(H, W), model_fn=None,
                     plain_remat=False):
    """One step's loss and gradients from one set of weights, rays and
    jitter, through the kernels and all-plain, on an img_hw image; tol =
    (loss rtol, worst and median per-tensor gradient error). The weights are
    seeded, or `model_fn(cfg)`'s (a model on the CPU) where given. With
    `plain_remat` the all-plain step recomputes each transformer layer in
    its backward (precision.remat_encoder; the same function): past eight
    views the plain attention's saved scores of every layer outgrow the
    card (10 views: 90 pair streams, 4.7 GB of f32 scores a layer)."""
    from matchnerf_tpu_torch.engine import Coach
    from matchnerf_tpu_torch.models.matchnerf import init_matchnerf
    from matchnerf_tpu_torch.train_step import sample_ray_indices
    model_k = (model_fn(cfg) if model_fn is not None
               else init_matchnerf(cfg, torch.Generator().manual_seed(seed))).to(dev)
    model_p = copy.deepcopy(model_k)
    cfg_p = copy.deepcopy(cfg)
    if plain_remat:
        cfg_p.precision.remat_encoder = True
    coaches = []
    for m, kern, cfg_ in ((model_k, True, cfg), (model_p, False, cfg_p)):
        c = Coach(cfg_, m, dev, kernel=kern)
        c.setup_optimizer(TRAIN_STEPS)
        coaches.append(c)
    route = coaches[0].train_route(batch)
    bt = coaches[0].batch_tensors(batch)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    patches = bool(cfg.nerf.get("train_ray_patches", False))
    S = int(cfg.nerf.sample_intvs)
    idx = sample_ray_indices(img_hw[0] * img_hw[1], TRAIN_RAYS, patches, dev, gen)
    rand = torch.rand((1, TRAIN_RAYS, S, 1), generator=gen, device=dev)
    losses = []
    for c in coaches:
        loss, _ = c.step.loss(bt, route, idx, rand)
        loss.backward()
        losses.append(float(loss.detach()))
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
    errs = grad_errors(model_k, model_p)
    worst = max(errs, key=errs.get)
    med = float(np.median(list(errs.values())))
    log(f"{label}: first step kernels vs all-plain: loss {losses[0]:.7f} vs {losses[1]:.7f} "
        f"(rel {loss_rel:.3e}, tol {tol[0]:g}); gradient error per tensor: worst "
        f"{errs[worst]:.3e} ({worst}), median {med:.3e} (tol {tol[1]:g} / {tol[2]:g}), "
        f"{len(errs)} tensors")
    if not (loss_rel <= tol[0] and errs[worst] <= tol[1] and med <= tol[2]):
        raise AssertionError(f"{label}: kernel step disagrees with the all-plain step")
    return {"loss_rel": loss_rel, "grad_err_worst": errs[worst], "grad_err_worst_tensor": worst,
            "grad_err_median": med, "tol": list(tol)}


def train_path(torch, dev, cfg, batch, seed, label, counters, must, profile):
    """Phases 10 and 11: TRAIN_STEPS steps of `Coach.train_iteration`; counts
    reset before and read after each step."""
    from matchnerf_tpu_torch.engine import Coach
    from matchnerf_tpu_torch.models.matchnerf import init_matchnerf
    model = init_matchnerf(cfg, torch.Generator().manual_seed(seed)).to(dev)
    coach = Coach(cfg, model, dev)
    coach.setup_optimizer(1000)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, launches, plain, events = [], [], [], []
    t0 = None
    for i in range(TRAIN_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        for c in counters.values():
            c.reset()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        loss = coach.train_iteration(batch)
        e1.record()
        launches.append({k: c.launches for k, c in counters.items()})
        plain.append({k: c.plain_on_cuda for k, c in counters.items()})
        losses.append(loss["all"])
        events.append((e0, e1))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (TRAIN_STEPS - 1)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [a.elapsed_time(b) for a, b in events]
    losses = [float(l) for l in losses]
    log(f"{label}: route {coach.last_route} (None: Kernel B'), losses "
        f"{[round(l, 6) for l in losses]}")
    log(f"{label}: ms per step (CUDA events) {[round(t, 3) for t in step_ms]}, warm mean "
        f"{float(np.mean(step_ms[1:])):.3f} ms, host wall {wall_ms:.3f} ms per warm step, "
        f"peak device memory {peak_gib:.2f} GiB")
    log(f"{label}: launches per step {launches[-1]}, plain versions on CUDA {plain[-1]}")
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    for group in ("feat_enc", "nerf_dec"):
        if not any(not torch.equal(p.detach(), start[n]) for n, p in model.named_parameters()
                   if n.startswith(group)):
            raise AssertionError(f"{label}: {group} parameters did not move")
    for i, (l, pc) in enumerate(zip(launches, plain)):
        for k, want in must.items():
            if l[k] != want:
                raise AssertionError(f"{label} step {i}: {k} launched {l[k]} times, "
                                     f"expected {want}")
        if any(pc.values()):
            raise AssertionError(f"{label} step {i}: plain versions ran on CUDA: {pc}")
    out = {"step_ms": step_ms, "warm_step_ms": float(np.mean(step_ms[1:])),
           "wall_ms_per_warm_step": wall_ms, "peak_gib": peak_gib, "losses": losses,
           "route": coach.last_route, "launches_per_step": launches[-1],
           "launches_total": {k: sum(l[k] for l in launches) for k in counters}}
    if profile:
        # the A' backward's two kernels by name, whatever their rank
        out["profile"] = profile_call(torch, label, lambda: coach.train_iteration(batch),
                                      keep=("window_attention_dq", "window_attention_dkv"))
    return out


def strict_encode_phase(torch, model, cfg, ref_images, counters):
    """Phase 6, the f32 encode of configs/test_strict.yaml (precision.strict
    makes the encoder f32): one warm encode of the scene's source views
    through Kernel A's f32 route, counted, and through the plain encoder;
    the features against the plain ones and the encode seconds (host clock
    around a synchronised call, mean of 3)."""
    from matchnerf_tpu_torch.models.matchnerf import encode
    from matchnerf_tpu_torch.ops import window_attention as ka

    def run(kernel, n=3):
        seconds = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                feats = encode(model, cfg, ref_images, kernel=kernel)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        return feats, float(np.mean(seconds))

    run(True, 1)                                   # warm
    for c in counters.values():
        c.reset()
    feats, enc_s = run(True, 1)
    routes = dict(ka.COUNTER.by_entry)
    launches = {k: c.launches for k, c in counters.items()}
    plain_cuda = {k: c.plain_on_cuda for k, c in counters.items()}
    _, enc_s = run(True)
    ref, plain_s = run(False)
    err = max(max_abs(a, b) for a, b in zip(feats, ref))
    tol = 1e-4 * max(1.0, max(float(r.abs().max()) for r in ref))
    log(f"strict f32 encode (configs/test_strict.yaml, encoder f32): {enc_s:.4f} s through "
        f"the kernels vs {plain_s:.4f} s plain; Kernel A launches by route {routes}; max|d| "
        f"features vs plain {err:.3e} (tol {tol:.3e}); scales "
        f"{[list(f.shape) for f in feats]}")
    if routes != {"window_attention_f32": 12} or sum(launches.values()) != 12:
        raise AssertionError(f"strict f32 encode: launches {launches}, Kernel A routes {routes}; "
                             "expected 12 f32 launches of Kernel A and nothing else")
    if any(plain_cuda.values()):
        raise AssertionError(f"strict f32 encode: plain versions ran on CUDA: {plain_cuda}")
    if not all(bool(torch.isfinite(f).all()) for f in feats):
        raise AssertionError("strict f32 encode: non-finite features")
    check_close("strict f32 encode features", err, tol)
    return {"encode_s": enc_s, "plain_encode_s": plain_s, "max_abs_err": err, "tol": tol,
            "launches": routes}


def fused_kernel_phase(torch, cfg, feats, ref_images, tables, grids, res):
    """Phase 3, Kernel F: on the first FUSED_CHUNK_RAYS rays of `grids` (one
    chunk of the fused route), the tap rows of the int8 tables (also held
    against Kernel B) and of bf16 and f32 tables from the same features."""
    from matchnerf_tpu_torch.models.matchnerf import (FUSED_CHUNK_RAYS, gather_tap_rows,
                                                      prepare_sampling_tables)
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    from matchnerf_tpu_torch.ops import fused_cosine as kf
    R = FUSED_CHUNK_RAYS
    g = grids[:, :R].contiguous()
    S = g.shape[2]
    N = R * S
    by_dtype = [("int8", tables)]
    for dt in (torch.bfloat16, None):
        by_dtype.append((str(dt or torch.float32).replace("torch.", ""),
                         prepare_sampling_tables(cfg, feats, ref_images, feat_dtype=dt)))
    res["F"] = {}
    for name, tabs in by_dtype:
        res["F"][name] = []
        for s, G in enumerate(cfg.encoder.cos_n_group):
            table = tabs["view_feats"][s][0]
            scales = tabs["view_feat_scales"][s]
            scales = None if scales is None else scales[0]
            rows, wts = gather_tap_rows(table, g)
            fn = lambda: kf.fused_interp_grouped_cosine(rows, wts, G, scales)
            plain = lambda: kf.fused_interp_grouped_cosine_plain(rows, wts, G, scales)
            got = fn()
            err = max_abs(got, plain())
            torch.cuda.synchronize()
            # per (view, channel) 9 flops to lerp 4 taps (+1 to dequantise);
            # per (pair, chunk channel) 6 for the dot product and two norms
            flops = N * (3 * 256 * (9 + (scales is not None)) + 3 * 128 * 6)
            b_ms, b_by = bound(nbytes(rows, wts, got, *([scales] if scales is not None
                                                          else [])), flops)
            entry = dict(scale=s, max_abs_err=err, ms=cuda_ms(torch, fn, 10),
                         plain_ms=cuda_ms(torch, plain, 3), bound_ms=b_ms, bound_by=b_by,
                         gather_ms=cuda_ms(torch, lambda: gather_tap_rows(table, g), 5),
                         rows_gb=nbytes(rows) / 1e9)
            extra = ""
            if name == "int8":
                entry["max_abs_err_vs_kernel_b"] = max_abs(
                    got, kb.cosine_prior(table, g, scales, G).reshape(N, G))
                extra = f", max|d| vs kernel B {entry['max_abs_err_vs_kernel_b']:.3e} (tol 1e-5)"
            log(f"kernel F fused_cosine scale {s} {name} rows [3,{N},{rows.shape[2]}] "
                f"({entry['rows_gb']:.2f} GB) G={G} R={R} S={S}: max|d| {err:.3e} (tol 1e-5)"
                f"{extra}, {entry['ms']:.3f} ms vs plain {entry['plain_ms']:.3f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}); the torch row gather {entry['gather_ms']:.3f} ms")
            check_close(f"F {name} scale {s}", err, 1e-5)
            if name == "int8":
                check_close(f"F vs B scale {s}", entry["max_abs_err_vs_kernel_b"], 1e-5)
            res["F"][name].append(entry)
            del rows, wts, got
        del tabs
    torch.cuda.empty_cache()


def bf16_kernel_phase(torch, cfg, feats, ref_images, grids, block_ut, res):
    """Phase 3, Kernels B and D on bf16 tables (base.yaml's
    cond_sample_dtype, the eval renders of configs/train.yaml) built from
    the same features: each scale at the eval slice (20480 rays) and the
    validation slice of configs/train.yaml (nerf.rand_rays_test, 4096 rays)
    against its plain twin (1e-4, as on int8 tables), D also against B."""
    from matchnerf_tpu_torch.models.matchnerf import prepare_sampling_tables
    from matchnerf_tpu_torch.ops import block_cosine_prior as kd
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    tables = prepare_sampling_tables(cfg, feats, ref_images, feat_dtype=torch.bfloat16)
    res["B_bf16"], res["D_bf16"] = [], []
    for R in (SLICE_RAYS, VAL_RAYS):
        g = grids[:, :R].contiguous()
        S = g.shape[2]
        N = R * S
        for s, G in enumerate(cfg.encoder.cos_n_group):
            table = tables["view_feats"][s][0]
            ut = block_ut[s]
            out_b = kb.cosine_prior(table, g, None, G)
            flops = prior_flops(N, scaled=False)          # bf16 rows have no scales
            b_ms, b_by = bound(nbytes(table, g, out_b), flops)
            for key, fn, plain in (
                    ("B", lambda: kb.cosine_prior(table, g, None, G),
                     lambda: kb.cosine_prior_plain(table, g, None, G)),
                    ("D", lambda: kd.block_cosine_prior(table, g, None, G, ut),
                     lambda: kd.block_cosine_prior_plain(table, g, None, G, ut))):
                got = fn()
                err = max_abs(got, plain())
                torch.cuda.synchronize()
                entry = dict(scale=s, R=R, max_abs_err=err, ms=cuda_ms(torch, fn, 10),
                             plain_ms=cuda_ms(torch, plain, 3), bound_ms=b_ms, bound_by=b_by)
                extra = ""
                if key == "D":
                    entry["ut"] = ut
                    entry["channels_per_pass"] = kd.channels_per_pass(ut, S, G, False, 2)
                    entry["max_abs_err_vs_kernel_b"] = max_abs(got, out_b)
                    entry["device_kernels"] = only_kernel(torch, fn, "block_cosine_prior")
                    extra = (f", bucket {ut}, {entry['channels_per_pass']} channels a pass, "
                             f"max|d| vs kernel B {entry['max_abs_err_vs_kernel_b']:.3e}")
                log(f"kernel {key} {'block_' if key == 'D' else ''}cosine_prior bf16 scale {s} "
                    f"table {list(table.shape)} G={G} R={R} S={S}: max|d| {err:.3e} (tol "
                    f"1e-4), {entry['ms']:.4f} ms vs plain {entry['plain_ms']:.3f} ms, bound "
                    f"{b_ms:.4f} ms ({b_by}){extra}")
                check_close(f"{key} bf16 scale {s} R={R}", err, 1e-4)
                if key == "D":
                    check_close(f"D vs B bf16 scale {s} R={R}",
                                entry["max_abs_err_vs_kernel_b"], 1e-4)
                res[f"{key}_bf16"].append(entry)
                del got
            del out_b
    del tables
    torch.cuda.empty_cache()


def int4_kernel_phase(torch, cfg, feats, plain_feats, ref_images, grids, res):
    """Phase 3, Kernel B's int4 form (precision.cond_sample_dtype int4,
    eval only) on the int4 tables `prepare_sampling_tables` builds from the
    same features: each scale at the eval slice against its plain twin
    (1e-4, as on int8 tables), with its bound (int8's operations: the
    dequantisation after interpolation; half int8's table bytes). Then the
    share of int4 codes that differ between those tables and the tables of
    the plain encoder's features `plain_feats` (Kernel A's plain twin): the
    encoder's rounding, in whole code steps, that keeps phase 19's int4
    images INT4_WHOLE_DB (not 50) from their all-plain renders."""
    from matchnerf_tpu_torch.models.matchnerf import prepare_sampling_tables
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    tables = prepare_sampling_tables(cfg, feats, ref_images, feat_dtype="int4")
    res["B_int4"] = []
    R, S = grids.shape[1:3]
    for s, G in enumerate(cfg.encoder.cos_n_group):
        table = tables["view_feats"][s][0]
        scales = tables["view_feat_scales"][s][0]
        fn = lambda: kb.cosine_prior(table, grids, scales, G)
        plain = lambda: kb.cosine_prior_plain(table, grids, scales, G)
        got = fn()
        err = max_abs(got, plain())
        torch.cuda.synchronize()
        b_ms, b_by = bound(nbytes(table, grids, scales, got), prior_flops(R * S, scaled=True))
        entry = dict(scale=s, max_abs_err=err, ms=cuda_ms(torch, fn, 10),
                     plain_ms=cuda_ms(torch, plain, 3), bound_ms=b_ms, bound_by=b_by,
                     table_bytes=nbytes(table))
        log(f"kernel B cosine_prior int4 scale {s} table {list(table.shape)} uint8 G={G} "
            f"R={R} S={S}: max|d| {err:.3e} (tol 1e-4), {entry['ms']:.4f} ms vs plain "
            f"{entry['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
        check_close(f"B int4 scale {s}", err, 1e-4)
        res["B_int4"].append(entry)
        del got
    ptables = prepare_sampling_tables(cfg, plain_feats, ref_images, feat_dtype="int4")
    for s, entry in enumerate(res["B_int4"]):
        a = kb.unpack_int4(tables["view_feats"][s])
        b = kb.unpack_int4(ptables["view_feats"][s])
        entry["codes_differ_vs_plain_encoder"] = float((a != b).float().mean())
        entry["max_code_step_vs_plain_encoder"] = float((a - b).abs().max())
        log(f"int4 tables scale {s}, Kernel A's features against its plain twin's: "
            f"{entry['codes_differ_vs_plain_encoder']:.5f} of the codes differ, by at most "
            f"{entry['max_code_step_vs_plain_encoder']:.0f} step")
        del a, b
    del tables, ptables
    torch.cuda.empty_cache()


def printer_check():
    """The printer JPEGs of the in-repo demo scene decoded and resized to
    configs/demo_own.yaml's 256x160 by the port (no PIL), each held to its
    sha256 as PIL gives it (PRINTER_SHA256) -> {file: ms of decode, resize}."""
    import hashlib

    from matchnerf_tpu_torch.data import jpeg, resample
    out = {}
    for name, (want_decoded, want_resized) in sorted(PRINTER_SHA256.items()):
        t0 = time.perf_counter()
        img = jpeg.read_jpeg(os.path.join(PRINTER_DIR, name))
        t1 = time.perf_counter()
        small = resample.resize(img, PRINTER_WH, "lanczos")
        t2 = time.perf_counter()
        got = (hashlib.sha256(img.tobytes()).hexdigest(),
               hashlib.sha256(small.tobytes()).hexdigest())
        if img.shape != (378, 504, 3) or got != (want_decoded, want_resized):
            raise AssertionError(f"printer {name}: decoded {img.shape} sha256 {got}, expected "
                                 f"{(want_decoded, want_resized)} (PIL's)")
        out[name] = {"decode_ms": (t1 - t0) * 1e3, "resize_ms": (t2 - t1) * 1e3}
    log(f"printer scene: {len(out)} JPEGs decoded (504x378, 4:2:0) and resized to "
        f"{PRINTER_WH[0]}x{PRINTER_WH[1]} (LANCZOS) by the port, each equal to PIL's "
        f"(sha256); ms {out}")
    return out


def progressive_check():
    """Each progressive fixture (PROGRESSIVE_DIR) decoded by the port (no
    PIL), held to PIL's sha256 of it (PROGRESSIVE_SHA256) -> {"decoded": n,
    "ms": {file: ms of one decode}}."""
    import hashlib

    from matchnerf_tpu_torch.data import jpeg
    out = {"ms": {}}
    for name, want in sorted(PROGRESSIVE_SHA256.items()):
        t0 = time.perf_counter()
        img = jpeg.read_jpeg(os.path.join(PROGRESSIVE_DIR, name))
        out["ms"][name] = (time.perf_counter() - t0) * 1e3
        got = hashlib.sha256(img.tobytes()).hexdigest()
        if got != want:
            raise AssertionError(f"progressive {name}: decoded {img.shape} sha256 {got}, PIL "
                                 f"gives {want}")
    out["decoded"] = len(out["ms"])
    return out


def write_progressive_colmap_tree(work):
    """The printer scene with its images re-saved progressive: the scene's
    poses_bounds.npy and the fixtures printer_{i}.jpg as images/{i}.jpeg
    under work/printer -> the tree's root (`work`)."""
    import shutil
    scene = os.path.join(work, "printer")
    os.makedirs(os.path.join(scene, "images"), exist_ok=True)
    shutil.copy(os.path.join(os.path.dirname(PRINTER_DIR), "poses_bounds.npy"), scene)
    for name in PRINTER_SHA256:
        shutil.copy(os.path.join(PROGRESSIVE_DIR, f"printer_{name.split('.')[0]}.jpg"),
                    os.path.join(scene, "images", name))
    return work


def progressive_tree_check(root):
    """COLMAPDataset (configs/demo_own.yaml's loader) on the progressive
    printer tree at PRINTER_WH: each of the sample's images held to PIL's
    decode-and-LANCZOS sha256 of its fixture (PROGRESSIVE_TREE_SHA256) ->
    {"images": n, "sample_s": seconds to build the sample}."""
    import hashlib

    from matchnerf_tpu_torch.data.colmap import COLMAPDataset
    t0 = time.perf_counter()
    sample = COLMAPDataset(root, "test", n_views=3, img_wh=PRINTER_WH, scene_list=["printer"],
                           test_views_method="fixed", nf_mode="minmax")[0]
    sample_s = time.perf_counter() - t0
    for img, vid in zip(sample["images"], sample["view_ids"]):
        u8 = np.rint(img * 255).astype(np.uint8)
        if not np.array_equal(u8.astype(np.float32) / 255.0, img):
            raise AssertionError(f"progressive tree: view {vid} is not a uint8 image / 255")
        name = f"printer_{int(vid)}.jpg"
        got = hashlib.sha256(u8.tobytes()).hexdigest()
        if got != PROGRESSIVE_TREE_SHA256[name]:
            raise AssertionError(f"progressive tree: {name} at {PRINTER_WH} sha256 {got}, PIL "
                                 f"gives {PROGRESSIVE_TREE_SHA256[name]}")
    return {"images": len(sample["images"]), "sample_s": sample_s}


def plain_frame0(cfg, model, dev, batch, n_slices=None, mode="interpolate", setbg=False):
    """Frame 0 of the batch's `mode` path (interpolate, or the LLFF spiral),
    every kernel replaced by its plain version, onto a white background
    with setbg: dict of [1, H*W, *], or of the first n_slices ray slices
    only."""
    from matchnerf_tpu_torch.renderer import Renderer, extract_poses
    poses = extract_poses(batch)
    frame0 = Renderer(cfg, model, dev, kernel=False).get_video_rendering_path(
        poses, mode, int(cfg.nerf.video_n_frames), batch)[0]
    return plain_render(cfg, model, dev, batch, n_slices, {"tgt": frame0, "ref": poses["ref"]},
                        setbg)


def video_phase(torch, dev, seed, counters, profile, name, n_frames, plain_slices=None):
    """Phases 7 and 8: `Coach.test_model_video` of configs/<name>.yaml on the
    in-repo printer scene (docs/demo_data, the COLMAP loader; demo_own with
    the fused cosine), seeded weights; launches counted around it; frame 0
    (its first plain_slices ray slices, if given) against the all-plain
    render."""
    from matchnerf_tpu_torch.config import CONFIGS
    from matchnerf_tpu_torch.data.loader import collate
    from matchnerf_tpu_torch.engine import Coach
    cfg = CONFIGS[name]()
    fused = name == "demo_own"
    cfg.precision.fused_cosine = fused
    cfg.load = None
    cfg.seed = seed
    cfg.nerf.video_n_frames = n_frames
    cfg.output_root = os.path.join(REPO, "build", "chip_smoke")
    cfg.data_test.colmap.root_dir = os.path.join(REPO, "docs", "demo_data")
    vw, vh = cfg.data_test.colmap.img_wh

    coach = Coach(cfg, device=dev)
    coach.load_dataset(["test"])          # the printer scene through the COLMAP loader
    sample = coach.test_loaders[0].dataset[0]
    coach.build_networks()
    coach.restore_checkpoint_if_needed()
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    videos = coach.test_model_video()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    plain_cuda = {k: c.plain_on_cuda for k, c in counters.items()}
    routes = coach.renderer.frame_routes
    n_slices = math.ceil(vw * vh / coach.renderer.rays_per_slice(1))
    n_color = sum(r["color_ut"] is not None for r in routes)
    frames_s = n_frames / wall
    S = cfg.nerf.sample_intvs
    log(f"video path ({name}.yaml{', fused_cosine' if fused else ''}) Coach.test_model_video "
        f"{vw}x{vh} S={S}, {n_frames} frames, {n_slices} slices of "
        f"{coach.renderer.rays_per_slice(1)} rays per frame: {wall:.4f} s, {frames_s:.3f} "
        f"frames/s, {frames_s * vw * vh:.0f} rays/s (encode, tables, every frame's pose_prep "
        f"and render, writing); colour union in its bucket on {n_color} of {n_frames} frames; "
        f"routes of frames 0 and {n_frames - 1}: {routes[0]}, {routes[-1]}")
    log(f"video path {name}: launches {launches}, plain versions on CUDA {plain_cuda}")
    frames = n_slices * n_frames
    if fused:
        want = dict({k: 0 for k in counters}, window_attention=12, cond_nerf_decode=frames,
                    fused_cosine=2 * frames, supercell_color=n_slices * n_color)
    else:
        # ray slices that are not 8-aligned: Kernel B and the colour gather
        want = dict({k: 0 for k in counters}, window_attention=12, cond_nerf_decode=frames,
                    cosine_prior=2 * frames)
    if launches != want:
        raise AssertionError(f"video path {name} launches {launches}, expected {want}")
    if any(plain_cuda.values()):
        raise AssertionError(f"plain versions ran on CUDA tensors: {plain_cuda}")
    video = videos[0]
    if video.shape != (n_frames, vh, vw, 3) or not np.isfinite(video).all():
        raise AssertionError(f"video frames {video.shape}, finite {np.isfinite(video).all()}")
    if not (video.min() >= -1e-6 and video.max() <= 1.0 + 1e-6):
        raise AssertionError(f"video rgb outside [0,1]: {video.min()} {video.max()}")
    ref = plain_frame0(cfg, coach.model, dev, collate([sample]), plain_slices)["rgb"].cpu()
    agreement = psnr(torch.as_tensor(video[0]).reshape(1, -1, 3)[:, :ref.shape[1]], ref)
    what = "frame 0" if plain_slices is None else f"frame 0's first {ref.shape[1]} rays"
    log(f"video path {name}: {what}, kernels vs all-plain PSNR {agreement:.2f} dB (need >= 50), "
        f"rgb mean {float(video.mean()):.4f}; outputs in {coach.output_path}")
    if not agreement >= 50.0:
        raise AssertionError(f"video {name} {what} agreement PSNR {agreement:.2f} dB < 50")
    out = {"seconds": wall, "frames_per_s": frames_s, "rays_per_s": frames_s * vw * vh,
           "frames": n_frames, "img_wh": [vw, vh], "samples_per_ray": S,
           "slices_per_frame": n_slices, "color_ut_frames": n_color,
           "frame0_psnr_vs_plain_db": agreement, "frame0_rays_compared": int(ref.shape[1]),
           "launches": launches}
    if profile:
        out["profile"] = profile_call(torch, f"video {name}", coach.test_model_video)
    return out


def timed_hook(torch, fn, times):
    """`fn` with its synchronised wall seconds appended to `times`."""
    def run(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn(*a, **k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return r
    return run


def loop_args(label, name, runs, root, meta, max_len, **over):
    """The training CLI's arguments for one run on the synthetic DTU tree
    (the DTU test split only: the port has no LLFF or Blender loader)."""
    args = {"name": name, "output_root": runs, "max_epoch": 1, "tb": "false",
            "encoder.pretrain_weight": "", "freq.scalar": 1, "freq.val_it": 0.5,
            "freq.ckpt_it": 0.5, "data_train.max_len": max_len, "data_val.max_len": 1,
            "data_test.dtu.max_len": 1, "data_test.llff": "", "data_test.blender": ""}
    for block in ("data_train", "data_val", "data_test.dtu"):
        args[f"{block}.root_dir"] = root
        args[f"{block}.meta_dir"] = meta
    args.update(over)
    return ["--config", label] + [f"--{k}={v}" for k, v in args.items()]


def loop_phase(torch, dev, counters):
    """Phase 12: the training loop of configs/train.yaml and train_fast.yaml
    (`python -m matchnerf_tpu_torch.train`'s `build_coach` and `train_model`)
    on a synthetic 640x512 DTU tree: 4 steps, validation every 2 (4096-ray
    slices on bf16 tables through Kernels A, C, D and E), a mid-epoch
    checkpoint every 2, the DTU test view and the epoch checkpoint; then
    SIGTERM to a run in a subprocess after its first checkpoint, and the
    resume."""
    import tempfile

    from matchnerf_tpu_torch.data import png, synth
    from matchnerf_tpu_torch.ops import block_cosine_prior as kd
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    from matchnerf_tpu_torch.renderer import Renderer
    from matchnerf_tpu_torch.train import build_coach
    from matchnerf_tpu_torch.utils.checkpoint import load_checkpoint
    work = tempfile.mkdtemp(prefix="chip_smoke_dtu_", dir=os.path.join(REPO, "build"))
    root, meta, runs = (os.path.join(work, d) for d in ("DTU", "meta", "runs"))
    t0 = time.perf_counter()
    synth.write_dtu_scene(root, meta)
    rect = os.path.join(root, "Rectified", "scan1_train")
    filters = np.bincount(np.concatenate([
        png._read_filtered(os.path.join(rect, f))[1] for f in sorted(os.listdir(rect))]),
        minlength=5)
    log(f"loop phase: synthetic DTU tree {H}x{W}, views {list(synth.DTU_SCENE_VIEW_IDS)} "
        f"(val/test 24) in {time.perf_counter() - t0:.1f} s under {work}; PNG rows by filter "
        f"(None, Sub, Up, Average, Paeth) {filters.tolist()}")
    if np.count_nonzero(filters[[1, 3, 4]]) == 0:
        raise AssertionError(f"the tree's PNGs use no filter with a left neighbour: {filters}")
    out = {}
    for label in ("train", "train_fast"):
        coach = build_coach(loop_args(label, f"loop_{label}", runs, root, meta, LOOP_STEPS))
        timed = {"validate_s": [], "test_s": []}
        coach.validate_model = timed_hook(torch, coach.validate_model, timed["validate_s"])
        coach.test_model = timed_hook(torch, coach.test_model, timed["test_s"])
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        coach.train_model()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_launches = {k: c.launches for k, c in counters.items()}
        plain_cuda = {k: c.plain_on_cuda for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        with open(coach.scalars_path) as f:
            recs = [json.loads(line) for line in f]
        losses = [r["loss_render"] for r in recs if r["split"] == "train"]
        vals = [r for r in recs if r["split"] == "val"]
        mdir = os.path.join(coach.output_path, "models")
        ckpts = sorted(os.listdir(mdir))
        hooks_s = sum(timed["validate_s"]) + sum(timed["test_s"])
        steps_per_s = LOOP_STEPS / (wall - hooks_s)
        # the loader alone: seconds to read one training sample (4 PNGs
        # decoded, cameras) on this thread, the most steps/s it can feed
        data = coach.train_loader.dataset
        t0 = time.perf_counter()
        for i in range(LOOP_STEPS):
            data[i]
        sample_s = (time.perf_counter() - t0) / LOOP_STEPS
        log(f"loop {label}.yaml: {LOOP_STEPS} steps in {wall:.3f} s with {len(vals)} "
            f"validations ({[round(t, 3) for t in timed['validate_s']]} s) and "
            f"{len(timed['test_s'])} test ({[round(t, 3) for t in timed['test_s']]} s): "
            f"{steps_per_s:.3f} steps/s outside them; the loader alone {sample_s:.4f} s a "
            f"sample ({1 / sample_s:.3f} samples/s); losses {[round(x, 6) for x in losses]}; "
            f"checkpoints {ckpts}; peak device memory {peak:.2f} GiB; {card_line()}")
        log(f"loop {label}.yaml: launches {run_launches}, plain versions on CUDA {plain_cuda}, "
            f"B by route {kb.COUNTER.by_entry}, D by route {kd.COUNTER.by_entry}")
        if len(losses) != LOOP_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"loop {label}: losses {losses}")
        if ckpts != ["ep1_it%d.ckpt" % LOOP_STEPS, "latest.ckpt"]:
            raise AssertionError(f"loop {label}: checkpoints {ckpts}")
        if len(vals) != 2 or not all(math.isfinite(r["PSNR"]) and math.isfinite(r["SSIM"])
                                     for r in vals):
            raise AssertionError(f"loop {label}: validation scalars {vals}")
        if any(plain_cuda.values()):
            raise AssertionError(f"loop {label}: plain versions ran on CUDA: {plain_cuda}")
        # the steps' table gradient: B' on train.yaml's iid rays, D' on
        # train_fast.yaml's strips (the tree's training poses fit its staging)
        bwd = "cosine_prior_bwd" if label == "train" else "block_cosine_prior_bwd"
        if run_launches[bwd] != 2 * LOOP_STEPS:
            raise AssertionError(f"loop {label}: {bwd} launched {run_launches[bwd]} times")

        # one validation image alone: its launches, seconds, and its render
        # (kept) against the all-plain one
        renders = []
        forward = coach.renderer.forward
        coach.renderer.forward = lambda *a, **k: renders.append(forward(*a, **k)) or renders[-1]
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coach.validate_model(iteration=coach.it)
        torch.cuda.synchronize()
        val_s = time.perf_counter() - t0
        coach.renderer.forward = forward
        val_launches = {k: c.launches for k, c in counters.items()}
        routes = {"B": dict(kb.COUNTER.by_entry), "D": dict(kd.COUNTER.by_entry)}
        route = coach.renderer.last_route
        log(f"loop {label}.yaml: training route {coach.last_route} (None: B'); one validation "
            f"image {val_s:.4f} s, route {route}, launches "
            f"{val_launches}, B {routes['B']}, D {routes['D']}")
        n_block = sum(u is not None for u in route["block_ut"] or ())
        if n_block and routes["D"].get("block_cosine_prior_bf16", 0) <= 0:
            raise AssertionError(f"loop {label}: Kernel D's bf16 form did not launch")
        if n_block < 2 and routes["B"].get("cosine_prior_bf16", 0) <= 0:
            raise AssertionError(f"loop {label}: Kernel B's bf16 form did not launch")
        if set(routes["B"]) - {"cosine_prior_bf16"} or set(routes["D"]) - {
                "block_cosine_prior_bf16"}:
            raise AssertionError(f"loop {label}: tables other than bf16 in validation {routes}")
        entry = {"steps": LOOP_STEPS, "wall_s": wall, "steps_per_s": steps_per_s,
                 "loader_sample_s": sample_s, "png_rows_by_filter": filters.tolist(),
                 "validate_s": timed["validate_s"][:-1], "test_s": timed["test_s"],
                 "validation_image_s": val_s, "peak_gib": peak, "losses": losses,
                 "checkpoints": ckpts, "launches": run_launches,
                 "validation_launches": val_launches, "validation_routes": routes,
                 "route": route, "val_psnr": [r["PSNR"] for r in vals],
                 "val_ssim": [r["SSIM"] for r in vals]}
        if label == "train":
            batch = next(iter(coach.val_loader))
            kern = renders[0]["rgb"]
            plain = Renderer(coach.cfg, coach.model, dev, kernel=False).forward(
                batch, mode="val")["rgb"]
            entry["psnr_vs_plain_db"] = psnr(kern, plain)
            # the same view with every scale through Kernel B (block_kernel off)
            ray_cfg = copy.deepcopy(coach.cfg)
            ray_cfg.precision.block_kernel = False
            before = kb.COUNTER.by_entry.get("cosine_prior_bf16", 0)
            ray = Renderer(ray_cfg, coach.model, dev).forward(batch, mode="val")["rgb"]
            entry["per_ray_b_bf16_launches"] = kb.COUNTER.by_entry["cosine_prior_bf16"] - before
            entry["per_ray_psnr_vs_block_db"] = psnr(ray, kern)
            log(f"loop {label}.yaml: validation image kernels vs all-plain PSNR "
                f"{entry['psnr_vs_plain_db']:.2f} dB (need >= 50); through Kernel B's bf16 "
                f"form ({entry['per_ray_b_bf16_launches']} launches) vs the block route "
                f"{entry['per_ray_psnr_vs_block_db']:.2f} dB (need >= 60)")
            if not entry["psnr_vs_plain_db"] >= 50.0:
                raise AssertionError(f"loop validation PSNR {entry['psnr_vs_plain_db']} < 50")
            if not (entry["per_ray_b_bf16_launches"] > 0
                    and entry["per_ray_psnr_vs_block_db"] >= 60.0):
                raise AssertionError(f"loop validation through Kernel B: {entry}")
            del kern, plain, ray
        out[label] = entry
        del coach
        torch.cuda.empty_cache()

    # preemption: SIGTERM to a training run once its first mid-epoch
    # checkpoint is on disk, then the resume
    args = loop_args("train", "loop_preempt", runs, root, meta, PREEMPT_STEPS,
                     **{"freq.ckpt_it": 2 / PREEMPT_STEPS, "freq.val_it": -1,
                        "freq.test_ep": -1, "freq.scalar": 0})
    latest = os.path.join(runs, "loop_preempt", "models", "latest.ckpt")
    log_path = os.path.join(work, "preempt.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen([sys.executable, "-m", "matchnerf_tpu_torch.train", *args],
                                cwd=REPO, stdout=log_file, stderr=subprocess.STDOUT)
        try:
            while proc.poll() is None and not os.path.exists(latest):
                if time.perf_counter() - t0 > 300:
                    raise AssertionError("preemption run wrote no checkpoint in 300 s")
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ckpt = load_checkpoint(latest)
    with open(log_path) as f:
        tail = f.read()[-2000:]
    log(f"loop preemption: SIGTERM after the first checkpoint, exit code {code} after "
        f"{time.perf_counter() - t0:.1f} s, latest.ckpt at epoch {ckpt['epoch']} iteration "
        f"{ckpt['iter']} of {PREEMPT_STEPS}")
    if code != 128 + signal.SIGTERM or not 0 < ckpt["iter"] < PREEMPT_STEPS:
        raise AssertionError(f"preemption: exit {code}, iteration {ckpt['iter']}; log:\n{tail}")
    coach = build_coach(args + ["--resume"])
    if (coach.epoch_start, coach.iter_start) != (ckpt["epoch"], ckpt["iter"]):
        raise AssertionError(f"resume at {coach.epoch_start}, {coach.iter_start}")
    model_equal = all(torch.equal(v.cpu(), ckpt["model"][k])
                      for k, v in coach.model.state_dict().items())
    opt = coach.opt.state_dict()
    adam, adam_ckpt = opt["adamw"]["state"], ckpt["optim"]["adamw"]["state"]
    opt_equal = (opt["count"] == ckpt["optim"]["count"] and adam.keys() == adam_ckpt.keys()
                 and all(torch.equal(adam[i][k].cpu(), adam_ckpt[i][k])
                         for i in adam for k in adam[i]))
    steps = []
    step = coach.step
    coach.step = lambda *a, **k: steps.append(1) or step(*a, **k)
    coach.train_model()
    log(f"loop resume: from iteration {coach.iter_start}, model bit-equal {model_equal}, "
        f"AdamW and schedule state bit-equal {opt_equal}, {len(steps)} steps taken (the "
        f"{coach.iter_start} loaded batches skipped), ending at iteration {coach.it}")
    if not (model_equal and opt_equal and len(steps) == PREEMPT_STEPS - ckpt["iter"]
            and coach.it == PREEMPT_STEPS):
        raise AssertionError("resume did not continue from the checkpoint")
    out["preempt"] = {"exit_code": code, "iter": ckpt["iter"], "steps": PREEMPT_STEPS,
                      "resumed_steps": len(steps), "model_bit_equal": model_equal,
                      "optimizer_bit_equal": opt_equal}
    del coach
    torch.cuda.empty_cache()
    out["tree"] = {"work": work, "root": root, "meta": meta}      # phase 16 trains on it
    return out


EVAL_SETS = {"dtu": (640, 512), "llff": (960, 640), "blender": (800, 800), "tnt": (960, 640)}
ENTRY_FRAMES = 3                   # frames of the test_video runs of phase 13
# the device kernels of the eval path, by the start of their __global__'s name
KERNEL_NAMES = {"window_attention": "window_attention_fwd", "cosine_prior": "cosine_prior_kernel",
                "cond_nerf_decode": "cond_nerf_decode_kernel",
                "cond_nerf_decode_any": "cond_nerf_decode_any_kernel",
                "block_cosine_prior": "block_cosine_prior_kernel",
                "supercell_color": "supercell_color_kernel"}
KERNEL_RES = {k: re.compile(r"\b" + v) for k, v in KERNEL_NAMES.items()}


def kernel_device_ms(torch, fn):
    """One warm call of `fn` under torch.profiler -> {kernel: (device ms,
    launches)} for the eval kernels of KERNEL_NAMES."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name, pattern in KERNEL_RES.items():
            if e.device_time_total > 0 and pattern.search(e.key):
                ms, n = out.get(name, (0.0, 0))
                out[name] = (ms + e.device_time_total / 1e3, n + e.count)
    return out


def entry_set_args(name, root, meta):
    return [f"--data_test.{name}.root_dir={root}", f"--data_test.{name}.meta_dir={meta}",
            f"--data_test.{name}.max_len=1"]


def write_eval_trees(work):
    """Synthetic DTU (640x512), LLFF (960x640) and Blender (800x800) test
    trees, one target view each, with their own meta dirs -> the entry's
    --data_test.<set>.root_dir / meta_dir arguments per set (T&T's tree
    comes from `write_host_jpegs`)."""
    from matchnerf_tpu_torch.data import synth
    writers = {"dtu": synth.write_dtu_scene, "llff": synth.write_llff_tree,
               "blender": synth.write_blender_tree}
    args = {}
    for name, write in writers.items():
        root, meta = os.path.join(work, name), os.path.join(work, f"{name}_meta")
        write(root, meta, *EVAL_SETS[name])
        args[name] = entry_set_args(name, root, meta)
    return args


def run_entry(torch, counters, argv):
    """`matchnerf_tpu_torch.test.main(argv)` in this process, with every
    `Renderer.forward` it makes (one per test set) recorded: the counts set
    to 0 just before it and read just after, its timings, route, background
    and output -> (main's result, the records)."""
    from matchnerf_tpu_torch import test as entry
    from matchnerf_tpu_torch.ops import decoder as kc
    from matchnerf_tpu_torch.renderer import Renderer
    records = []
    forward = Renderer.forward

    def recorded(self, batch, *a, **k):
        for c in counters.values():
            c.reset()
        t = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward(self, batch, *a, timings=t, **k)
        torch.cuda.synchronize()
        records.append({
            "renderer": self, "batch": batch, "out": out, "kwargs": k,
            "seconds": time.perf_counter() - t0, "timings": t,
            "launches": {n: c.launches for n, c in counters.items()},
            "plain_cuda": {n: c.plain_on_cuda for n, c in counters.items()},
            "routes": {n: dict(c.by_entry) for n, c in counters.items() if c.by_entry},
            "setbg_launches": kc.COUNTER.by_variant.get("setbg", 0),
            "setbg": self.setbg_opaque, "route": self.last_route,
            "frame_routes": list(self.frame_routes)})
        return out
    Renderer.forward = recorded
    try:
        result = entry.main(argv)
    finally:
        Renderer.forward = forward
    return result, records


def check_entry_record(name, rec, must, label, decoder="cond_nerf_decode"):
    """The checks every set's render passes: the kernels of `must` launched,
    none of the plain versions on CUDA, the shipped decoder on `decoder`
    alone (Kernel C; Kernel Cg past its width, from V = 14), Kernel C with
    setbg on Blender (every launch) and nowhere else, rgb finite in [0, 1]."""
    launches, out = rec["launches"], rec["out"]
    for k in must:
        if launches[k] <= 0:
            raise AssertionError(f"{label} {name}: kernel {k} was not launched: {launches}")
    if any(rec["plain_cuda"].values()):
        raise AssertionError(f"{label} {name}: plain versions ran on CUDA: {rec['plain_cuda']}")
    other = ({"cond_nerf_decode", "cond_nerf_decode_any"} - {decoder}).pop()
    if launches[other] or launches[decoder] <= 0:
        raise AssertionError(f"{label} {name}: the shipped decoder took {other}, not "
                             f"{decoder}: {launches}")
    want_bg = launches["cond_nerf_decode"] if name == "blender" else 0
    if rec["setbg"] != (name == "blender") or rec["setbg_launches"] != want_bg:
        raise AssertionError(f"{label} {name}: setbg {rec['setbg']}, {rec['setbg_launches']} "
                             f"Kernel C launches with setbg of {launches['cond_nerf_decode']}")
    for k, v in out.items():
        if not bool(v.isfinite().all()):
            raise AssertionError(f"{label} {name}: non-finite {k}")
    rgb = out["rgb"]
    if not (float(rgb.min()) >= -1e-6 and float(rgb.max()) <= 1.0 + 1e-6):
        raise AssertionError(f"{label} {name}: rgb outside [0,1]: {float(rgb.min())} "
                             f"{float(rgb.max())}")


def eval_entry_phase(torch, dev, seed, host_jpegs):
    """Phase 13: `python -m matchnerf_tpu_torch.test --config test` (its
    `main`, in this process, on the card) over synthetic DTU, LLFF, Blender
    and T&T test trees, at configs/test.yaml's sizes (T&T's 1920x1056 JPEGs
    decoded and resized to 960x640 without PIL), full width, seeded
    weights; then `--config test_video` (3 frames) on the LLFF and Blender
    trees and `--config test_strict` on the DTU tree. `host_jpegs` is the
    future of `write_host_jpegs`."""
    import tempfile

    from matchnerf_tpu_torch.ops import block_cosine_prior as kd
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    from matchnerf_tpu_torch.ops import decoder as kc
    from matchnerf_tpu_torch.ops import fused_cosine as kf
    from matchnerf_tpu_torch.ops import supercell_color as ke
    from matchnerf_tpu_torch.ops import window_attention as ka
    from matchnerf_tpu_torch.renderer import Renderer
    counters = {"window_attention": ka.COUNTER, "cosine_prior": kb.COUNTER,
                "cond_nerf_decode": kc.COUNTER, "cond_nerf_decode_any": kc.COUNTER_ANY,
                "block_cosine_prior": kd.COUNTER, "supercell_color": ke.COUNTER,
                "fused_cosine": kf.COUNTER}
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_eval_", dir=os.path.join(REPO, "build"))
    t0 = time.perf_counter()
    trees = write_eval_trees(work)
    tnt_root, tnt_meta, _, jpeg_s = host_jpegs.result()
    trees["tnt"] = entry_set_args("tnt", tnt_root, tnt_meta)
    log(f"eval entry: synthetic test trees {EVAL_SETS} (one target view each) in "
        f"{time.perf_counter() - t0:.1f} s under {work}; T&T's {TNT_JPEG_WH[0]}x"
        f"{TNT_JPEG_WH[1]} JPEGs (the port's encoder) under {tnt_root}, written in {jpeg_s:.1f} "
        "s beside the earlier phases")
    runs = os.path.join(work, "runs")
    common = ["--load=", f"--output_root={runs}", f"--seed={seed}"]
    card = card_line()
    out = {"sets": {}, "card": card}

    # configs/test.yaml: DTU, LLFF, Blender and T&T
    argv = ["--config", "test", "--name=test", *common] + sum(trees.values(), [])
    t0 = time.perf_counter()
    sums, records = run_entry(torch, counters, argv)
    wall = time.perf_counter() - t0
    if len(records) != len(EVAL_SETS):
        raise AssertionError(f"eval entry: {len(records)} renders for {list(EVAL_SETS)}")
    test_dir = os.path.join(runs, "test", "test")
    for name, rec in zip(EVAL_SETS, records):
        w, h = EVAL_SETS[name]
        check_entry_record(name, rec, ["window_attention", "cond_nerf_decode",
                                       "block_cosine_prior", "supercell_color"], "eval entry")
        renderer, route = rec["renderer"], rec["route"]
        overflow = [i for i, u in enumerate(route["block_ut"] or ()) if u is None]
        if rec["launches"]["cosine_prior"]:
            log(f"eval entry {name}: Kernel B took scale(s) {overflow} of the target pose "
                f"(view {int(rec['batch']['view_ids'][0][-1])}): its block union overflowed "
                f"the buckets, route {route}")
        plain = Renderer(renderer.cfg, renderer.model, dev, kernel=False)
        plain.setbg_opaque = rec["setbg"]
        plain_t = {}
        ref = plain.forward(rec["batch"], mode="test", timings=plain_t)
        agreement = psnr(rec["out"]["rgb"], ref["rgb"])
        del ref
        files = sorted(os.listdir(os.path.join(test_dir, name)))
        if not (files and os.path.isfile(os.path.join(test_dir, f"0results_{name}.txt"))):
            raise AssertionError(f"eval entry {name}: outputs {files} in {test_dir}")
        kms = kernel_device_ms(torch, lambda: renderer.forward(rec["batch"], mode="test"))
        t = rec["timings"]
        n_rays = w * h
        # Kernel A's windows: 6 streams x 2x2 windows of the 1/8-scale map,
        # bf16 operands; its bound as in phase 3 (4 BW L^2 C operations)
        L = (h // 16) * (w // 16)
        a_bound, a_by = bound(4 * 24 * L * 128 * 2, 4 * 24 * L * L * 128, "bfloat16",
                              TC_FLOPS)
        entry = {"img_wh": [w, h], "render_s": t["render"], "encode_s": t["encode"],
                 "tables_s": t["tables"], "pose_prep_s": t.get("pose_prep", 0.0),
                 "rays_per_s_render": n_rays / t["render"], "forward_s": rec["seconds"],
                 "plain_render_s": plain_t["render"], "psnr_vs_plain_db": agreement,
                 "route": route, "setbg": rec["setbg"], "setbg_launches": rec["setbg_launches"],
                 "launches": rec["launches"], "launches_by_route": rec["routes"],
                 "kernel_device_ms": {k: {"ms": ms, "launches": n, "ms_per_launch": ms / n}
                                      for k, (ms, n) in kms.items()},
                 "window_attention_shape": {"BW": 24, "L": L, "C": 128, "bound_ms": a_bound,
                                            "bound_by": a_by},
                 "psnr_vs_gt": sums[name]["PSNR"], "outputs": files}
        out["sets"][name] = entry
        log(f"eval entry {name} {w}x{h} S={renderer.cfg.nerf.sample_intvs}: render "
            f"{t['render']:.4f} s (pose_prep {entry['pose_prep_s']:.4f}), encode "
            f"{t['encode']:.4f}, tables {t['tables']:.4f}, {entry['rays_per_s_render']:.0f} "
            f"rays/s (render); route per scale {route['block_ut']} (None: Kernel B), colour "
            f"{route['color_ut']}; setbg {rec['setbg']} ({rec['setbg_launches']} C launches); "
            f"launches {rec['launches']}; kernels vs all-plain PSNR {agreement:.2f} dB "
            f"(need >= 50; plain render {plain_t['render']:.3f} s); device ms (launches) "
            + ", ".join(f"{k} {ms:.3f} ({n})" for k, (ms, n) in sorted(kms.items()))
            + f"; Kernel A at [24,{L},128] bf16, bound {a_bound:.4f} ms ({a_by}); {card}")
        if not agreement >= 50.0:
            raise AssertionError(f"eval entry {name}: agreement PSNR {agreement:.2f} dB < 50")
    out["wall_s"] = wall
    out["tnt_tree"] = [tnt_root, tnt_meta]
    dtu_rgb = records[0]["out"]["rgb"]
    del records
    torch.cuda.empty_cache()

    # configs/test_video.yaml: the LLFF spiral and Blender's interpolated path
    argv = (["--config", "test_video", "--name=test_video", *common, "--data_test.dtu=",
             "--data_test.tnt=", f"--nerf.video_n_frames={ENTRY_FRAMES}"]
            + trees["llff"] + trees["blender"])
    videos, records = run_entry(torch, counters, argv)
    out["video"] = {}
    for name, rec, video in zip(("llff", "blender"), records, videos):
        check_entry_record(name, rec, ["window_attention", "cond_nerf_decode"], "eval video")
        mode = rec["kwargs"]["render_path_mode"]
        if mode != ("spiral" if name == "llff" else "interpolate"):
            raise AssertionError(f"eval video {name}: path mode {mode}")
        renderer = rec["renderer"]
        ref = plain_frame0(renderer.cfg, renderer.model, dev, rec["batch"], mode=mode,
                           setbg=rec["setbg"])["rgb"]
        agreement = psnr(rec["out"]["rgb"][:1], ref)
        log(f"eval video {name} ({mode}, {ENTRY_FRAMES} frames): {rec['seconds']:.3f} s, "
            f"frame routes {[r['block_ut'] for r in rec['frame_routes']]}, launches "
            f"{rec['launches']}, setbg {rec['setbg']} ({rec['setbg_launches']} C launches); "
            f"frame 0 vs all-plain PSNR {agreement:.2f} dB (need >= 50); {card}")
        if video.shape[0] != ENTRY_FRAMES or not agreement >= 50.0:
            raise AssertionError(f"eval video {name}: {video.shape[0]} frames, frame 0 "
                                 f"agreement {agreement:.2f} dB")
        out["video"][name] = {"mode": mode, "seconds": rec["seconds"],
                              "psnr_vs_plain_db": agreement, "launches": rec["launches"],
                              "setbg_launches": rec["setbg_launches"]}
    del records
    torch.cuda.empty_cache()

    # configs/test_strict.yaml on the DTU tree: Kernel A's f32 route, the cond
    # query and the decoder in torch ops (precision.strict)
    argv = (["--config", "test_strict", "--name=test_strict", *common, "--data_test.llff=",
             "--data_test.blender=", "--data_test.tnt="] + trees["dtu"])
    _, records = run_entry(torch, counters, argv)
    rec = records[0]
    rgb = rec["out"]["rgb"]
    finite = all(bool(v.isfinite().all()) for v in rec["out"].values())
    vs_shipped = psnr(rgb, dtu_rgb)
    log(f"eval strict dtu (configs/test_strict.yaml): render {rec['timings']['render']:.4f} s, "
        f"encode {rec['timings']['encode']:.4f} s; Kernel A by route {rec['routes']}, launches "
        f"{rec['launches']}, plain versions on CUDA (the strict cond query) "
        f"{rec['plain_cuda']}; finite {finite}; vs the shipped-config render PSNR "
        f"{vs_shipped:.2f} dB; {card}")
    if rec["routes"].get("window_attention") != {"window_attention_f32": 12} or not finite:
        raise AssertionError(f"eval strict: Kernel A routes {rec['routes']}, finite {finite}")
    out["strict"] = {"render_s": rec["timings"]["render"], "encode_s": rec["timings"]["encode"],
                     "launches": rec["launches"], "routes": rec["routes"],
                     "psnr_vs_shipped_db": vs_shipped}
    del records, dtu_rgb
    torch.cuda.empty_cache()
    return out


IBR_WH = (1008, 756)               # configs/train_ibrnet.yaml img_wh
IBR_STEPS = 6                      # training steps of the train_ibrnet phase
IBR_SLICE = 23552                  # its nerf.rand_rays_val and rand_rays_test
IBR_TIMED_STEPS = 3                # warm steps timed with and without remat


def write_ibrnet_trees(work):
    """A synthetic IBRNet tree (two groups of one scene, 8 forward-facing
    views each at 1008x756) and an LLFF tree holding a copy of its second
    scene (eval_mode gpnr: view 0 the target, the other 7 its candidates;
    the validation image is the first scene's view 0) under `work` ->
    (IBRNet root, LLFF root, seconds)."""
    import shutil
    from matchnerf_tpu_torch.data import synth
    t0 = time.perf_counter()
    ibr, llff = os.path.join(work, "IBRNet"), os.path.join(work, "nerf_llff_data")
    synth.write_ibrnet_tree(ibr, *IBR_WH)
    shutil.copytree(os.path.join(ibr, "real_iconic_noface", "scene1"),
                    os.path.join(llff, "scene1"))
    return ibr, llff, time.perf_counter() - t0


def start_ibrnet_trees():
    """Phase 14's trees, written by one spawned process while the phases
    before it run -> (the process pool, the future of write_ibrnet_trees).
    The caller shuts the pool down once it has the result."""
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_ibrnet_", dir=os.path.join(REPO, "build"))
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(write_ibrnet_trees, work)


def write_host_jpegs(work):
    """Phase 13's T&T tree (5 views at TNT_JPEG_WH, 4:2:0 JPEGs of the
    port's encoder, no PIL) and phase 17's encoder-made JPEGs of
    `seeded_photo` at HOST_IO_WH, under `work` -> (T&T root, its meta dir,
    {"WxH": JPEG path}, seconds)."""
    from matchnerf_tpu_torch.data import synth
    t0 = time.perf_counter()
    root, meta = os.path.join(work, "tnt"), os.path.join(work, "tnt_meta")
    synth.write_tnt_tree(root, meta, *TNT_JPEG_WH)
    photos = {}
    for w, h in HOST_IO_WH:
        photos[f"{w}x{h}"] = os.path.join(work, f"photo_{w}x{h}.jpg")
        with open(photos[f"{w}x{h}"], "wb") as f:
            f.write(synth.encode_jpeg(seeded_photo(w, h), 95))
    return root, meta, photos, time.perf_counter() - t0


def start_host_jpegs():
    """`write_host_jpegs` in one spawned process while the phases before 13
    run -> (the process pool, the future). The caller shuts the pool down."""
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_jpeg_", dir=os.path.join(REPO, "build"))
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(write_host_jpegs, work)


def write_gmflow_checkpoint(torch, cfg, seed, path):
    """A GMFlow flow checkpoint as the reference saves it, from an encoder
    of `cfg` with weights from the seed: its backbone and transformer under
    `module.`, one transformer layer more than the model has, the flow
    upsampler and the flow refinement (none of which the model loads), no
    featup_net -> the encoder's state_dict."""
    from matchnerf_tpu_torch.models.matchnerf import init_matchnerf
    enc = init_matchnerf(cfg, torch.Generator().manual_seed(seed + 7)).feat_enc
    state = enc.state_dict()
    sd = {f"module.{k}": v for k, v in state.items() if not k.startswith("featup_net.")}
    n = len(enc.transformer.layers)
    last = f"transformer.layers.{n - 1}."
    sd.update({f"module.transformer.layers.{n}.{k[len(last):]}": v + 1.0
               for k, v in state.items() if k.startswith(last)})
    gen = torch.Generator().manual_seed(seed + 8)
    sd["module.upsampler.0.weight"] = torch.randn(256, 129, 3, 3, generator=gen)
    sd["module.upsampler.0.bias"] = torch.randn(256, generator=gen)
    sd["module.feature_flow_attn.q_proj.weight"] = torch.randn(128, 128, generator=gen)
    torch.save({"model": sd}, path)
    return state


def ibrnet_attention(torch, F, dev, seed):
    """Kernels A and A' at the encoder's shape at 1008x756: [96,768,128]
    bf16 (6 streams x 4x4 windows of 24 x 32 tokens), unmasked and shifted,
    each against its plain version, beside SDPA with the float mask."""
    from matchnerf_tpu_torch.ops import window_attention as ka
    from matchnerf_tpu_torch.ops.attention import shift_region_ids
    grad = torch.autograd.grad
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    BW, L, C = 96, 768, 128
    rid = shift_region_ids(96, 128, 4, device=dev)
    rows = rid[torch.arange(BW, device=dev) % rid.shape[0]]
    prod = 2 * BW * L * L * C                    # flops of one score-sized product
    out = {"A": {}, "A_bwd": {}}
    for shift in (False, True):
        tag = "shift" if shift else "noshift"
        r = rid if shift else None
        q, k, v, do = (torch.randn(BW, L, C, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        mask = None
        if shift:
            mask = torch.where(rows[:, :, None] != rows[:, None, :], -100.0, 0.0)
            mask = mask[:, None].to(torch.bfloat16)
        with torch.no_grad():
            got = ka.window_attention(q, k, v, r)
            ref = ka.window_attention_plain(q, k, v, r)
            torch.cuda.synchronize()
            err = max_abs(got, ref)
            tol = 3e-2 * max(1.0, float(ref.float().abs().max()))
            lib = lambda: F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None],
                                                         attn_mask=mask)
            b_ms, b_by = bound(nbytes(q, k, v, got), 2 * prod, "bfloat16", TC_FLOPS)
            a = dict(shape=[BW, L, C], max_abs_err=err, tol=tol,
                     ms=cuda_ms(torch, lambda: ka.window_attention(q, k, v, r), 50),
                     plain_ms=cuda_ms(torch, lambda: ka.window_attention_plain(q, k, v, r), 5),
                     library_ms=cuda_ms(torch, lib, 50),
                     library_max_abs_err=max_abs(lib()[:, 0], ref), bound_ms=b_ms,
                     bound_by=b_by)
        log(f"train_ibrnet kernel A window_attention bf16 [{BW},{L},{C}] {tag}: max|d| "
            f"{err:.3e} (tol {tol:.3e}), {a['ms']:.4f} ms vs plain {a['plain_ms']:.3f} ms, "
            f"library SDPA {a['library_ms']:.4f} ms (max|d| {a['library_max_abs_err']:.3e}), "
            f"bound {b_ms:.4f} ms ({b_by})")
        check_close(f"train_ibrnet window_attention {tag}", err, tol)
        out["A"][tag] = a
        qk = [t.clone().requires_grad_() for t in (q, k, v)]
        qp = [t.clone().requires_grad_() for t in (q, k, v)]
        o_k = ka.window_attention(*qk, r)
        gk = grad(o_k, qk, do, retain_graph=True)
        gp = grad(ka.window_attention_plain(*qp, r), qp, do)
        torch.cuda.synchronize()
        err = max(max_abs(x, y) for x, y in zip(gk, gp))
        tol = 3e-2 * max(float(y.float().abs().max()) for y in gp)
        o, lse = ka.window_attention_forward(q, k, v, r, with_lse=True)
        ql = [t[:, None].detach().clone().requires_grad_() for t in (q, k, v)]
        ol = F.scaled_dot_product_attention(*ql, attn_mask=mask)
        lib_bwd = lambda: grad(ol, ql, do[:, None], retain_graph=True)
        b_ms, b_by = bound(nbytes(q, k, v, o, do, lse, *gk), 5 * prod, "bfloat16", TC_FLOPS)
        ab = dict(shape=[BW, L, C], max_abs_err=err, tol=tol,
                  ms=cuda_ms(torch, lambda: ka.window_attention_backward(q, k, v, o, lse, do, r),
                             20),
                  fwd_ms=cuda_ms(torch, lambda: ka.window_attention_forward(q, k, v, r, True),
                                 20),
                  plain_ms=cuda_ms(torch, lambda: grad(
                      ka.window_attention_plain(*qp, r), qp, do), 5),
                  library_ms=device_ms(torch, lib_bwd, 10),
                  library_max_abs_err=max(max_abs(x[:, 0], y) for x, y in
                                          zip(lib_bwd(), gp)),
                  bound_ms=b_ms, bound_by=b_by)
        log(f"train_ibrnet kernel A' window_attention backward bf16 [{BW},{L},{C}] {tag}: "
            f"max|d| dq/dk/dv {err:.3e} (tol {tol:.3e}), {ab['ms']:.4f} ms (forward with the "
            f"logsumexp {ab['fwd_ms']:.4f} ms) vs plain {ab['plain_ms']:.3f} ms, library SDPA "
            f"backward {ab['library_ms']:.4f} ms on the device (max|d| "
            f"{ab['library_max_abs_err']:.3e}), bound {b_ms:.4f} ms ({b_by}, 5 products)")
        check_close(f"train_ibrnet window_attention backward {tag}", err, tol)
        out["A_bwd"][tag] = ab
        del q, k, v, do, qk, qp, gk, gp, o, lse, ql, ol, mask, got, ref
    return out


def ibrnet_train_tables(torch, dev, cfg, model, batch, seed):
    """B' at the step's f32 tables (96x128 and 192x256 cells at 1008x756)
    on 1024 iid training rays of the sample, S = 128, stratified: the
    forward and the table gradient against autograd through the plain
    twin."""
    from matchnerf_tpu_torch import camera
    from matchnerf_tpu_torch.models.matchnerf import (encode, prepare_sampling_tables,
                                                      project_to_views, sample_depth)
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    from matchnerf_tpu_torch.renderer import Renderer, extract_poses
    from matchnerf_tpu_torch.train_step import sample_ray_indices
    grad = torch.autograd.grad
    W_, H_ = IBR_WH
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    r0 = Renderer(cfg, model, dev)
    ref_images = r0.tensor(batch["images"][:, :3])
    with torch.no_grad():
        tables = prepare_sampling_tables(cfg, encode(model, cfg, ref_images), ref_images)
    tgt_intr, c2w, tgt_nf, ref_w2c, ref_intr, ref_nf = r0._pose_tensors(extract_poses(batch))
    R = TRAIN_RAYS
    idx = sample_ray_indices(H_ * W_, R, False, dev, gen)
    pix = torch.stack([(idx % W_).float(), (idx // W_).float()], -1)[None]
    center, ray = camera.get_center_and_ray(pix, tgt_intr, c2w)
    depth = sample_depth(cfg, tgt_nf, 1, R, stratified=True, generator=gen)
    pts = camera.get_3d_points_from_depth(center, ray, depth, multi_samples=True)
    grids = (project_to_views(pts, ref_w2c, ref_intr, ref_nf, H_, W_)[..., :2]
             * 2.0 - 1.0)[:, 0].contiguous()
    S = grids.shape[2]
    N = R * S
    out = []
    for s, G in enumerate(cfg.encoder.cos_n_group):
        table = tables["view_feats"][s][0]
        gcot = torch.randn(R, S, G, generator=gen, device=dev)
        tk, tp = table.clone().requires_grad_(), table.clone().requires_grad_()
        ok, op = kb.cosine_prior(tk, grids, None, G), kb.cosine_prior_plain(tp, grids, None, G)
        dk = grad(ok, tk, gcot, retain_graph=True)[0]
        dp = grad(op, tp, gcot, retain_graph=True)[0]
        torch.cuda.synchronize()
        fwd_err, err = max_abs(ok, op), max_abs(dk, dp)
        tol = 1e-5 * float(dp.abs().max())
        b_ms, b_by = bound(2 * nbytes(table) + nbytes(grids, gcot),
                           N * (3 * 256 * 16 + 3 * 128 * 12))
        e = dict(scale=s, table=list(table.shape), G=G, R=R, S=S, forward_max_abs_err=fwd_err,
                 max_abs_err=err, tol=tol,
                 ms=cuda_ms(torch, lambda: grad(ok, tk, gcot, retain_graph=True), 10),
                 plain_ms=cuda_ms(torch, lambda: grad(op, tp, gcot, retain_graph=True), 3),
                 bound_ms=b_ms, bound_by=b_by)
        log(f"train_ibrnet kernel B' cosine_prior backward scale {s} table {e['table']} f32 "
            f"G={G} R={R} S={S}: forward max|d| {fwd_err:.3e} (tol 1e-5), d_table max|d| "
            f"{err:.3e} (tol {tol:.3e}), {e['ms']:.3f} ms vs plain {e['plain_ms']:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        check_close(f"train_ibrnet B forward scale {s}", fwd_err, 1e-5)
        check_close(f"train_ibrnet B' scale {s}", err, tol)
        out.append(e)
        del tk, tp, ok, op, dk, dp, gcot
    if [e["table"][1:3] for e in out] != [[96, 128], [192, 256]]:
        raise AssertionError(f"train_ibrnet training tables {[e['table'] for e in out]}")
    return out


def ibrnet_eval_slice(torch, dev, cfg, renderer, batch):
    """C, D and E on one 23552-ray slice (nerf.rand_rays_val) of the
    validation pose, with the validation render's bf16 tables, its route
    and the IBR decoder, each against its plain twin; D also against B."""
    from matchnerf_tpu_torch import camera
    from matchnerf_tpu_torch.models.matchnerf import (project_to_views, query_cond_info,
                                                      sample_depth)
    from matchnerf_tpu_torch.ops import block_cosine_prior as kd
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    from matchnerf_tpu_torch.ops import decoder as kc
    from matchnerf_tpu_torch.ops import supercell_color as ke
    from matchnerf_tpu_torch.renderer import extract_poses
    W_, H_ = IBR_WH
    out = {"D": []}
    with torch.no_grad():
        ref_images = renderer.tensor(batch["images"][:, :3])
        tables = renderer.build_tables(ref_images, renderer.encode(ref_images))
        poses = extract_poses(batch)
        scale_hws = [(t.shape[2], t.shape[3]) for t in tables["view_feats"]]
        block_ut, color_ut = renderer.pose_prep(poses, scale_hws, H_, W_, measure_color=True)
        R = IBR_SLICE
        pix = camera.pixel_grid(H_, W_, legacy=True, device=dev)[:R][None]
        tgt_intr, c2w, tgt_nf, ref_w2c, ref_intr, ref_nf = renderer._pose_tensors(poses)
        center, ray = camera.get_center_and_ray(pix, tgt_intr, c2w)
        depth = sample_depth(cfg, tgt_nf, 1, R)
        pts = camera.get_3d_points_from_depth(center, ray, depth, multi_samples=True)
        grids = (project_to_views(pts, ref_w2c, ref_intr, ref_nf, H_, W_)[..., :2]
                 * 2.0 - 1.0)[:, 0].contiguous()
        S = grids.shape[2]
        for s, G in enumerate(cfg.encoder.cos_n_group):
            ut = (block_ut or (None, None))[s]
            if ut is None:
                continue
            table = tables["view_feats"][s][0]
            fn = lambda: kd.block_cosine_prior(table, grids, None, G, ut)
            plain = lambda: kd.block_cosine_prior_plain(table, grids, None, G, ut)
            got = fn()
            err, err_b = max_abs(got, plain()), max_abs(got, kb.cosine_prior(table, grids, None, G))
            b_ms, b_by = bound(nbytes(table, grids, got), prior_flops(R * S, scaled=False))
            e = dict(scale=s, table=list(table.shape), dtype=str(table.dtype), R=R, ut=ut,
                     max_abs_err=err, max_abs_err_vs_kernel_b=err_b, ms=cuda_ms(torch, fn, 10),
                     plain_ms=cuda_ms(torch, plain, 3), bound_ms=b_ms, bound_by=b_by)
            log(f"train_ibrnet kernel D block_cosine_prior scale {s} table {e['table']} "
                f"{e['dtype']} G={G} R={R} S={S} bucket {ut}: max|d| {err:.3e} (tol 1e-4), vs "
                f"kernel B {err_b:.3e}, {e['ms']:.3f} ms vs plain {e['plain_ms']:.3f} ms, "
                f"bound {b_ms:.4f} ms ({b_by})")
            check_close(f"train_ibrnet D scale {s}", err, 1e-4)
            check_close(f"train_ibrnet D vs B scale {s}", err_b, 1e-4)
            out["D"].append(e)
            del got
        if color_ut is not None and tables.get("colors_sc") is not None:
            csc = tables["colors_sc"][0]
            e_fn = lambda: ke.supercell_color_sample(csc, grids, H_, W_)
            e_plain = lambda: ke.supercell_color_sample_plain(csc, grids, H_, W_)
            got = e_fn()
            err = max_abs(got, e_plain())
            b_ms, b_by = bound(nbytes(csc, grids, got), R * S * 3 * 3 * 9)
            out["E"] = dict(R=R, max_abs_err=err, ms=cuda_ms(torch, e_fn, 20),
                            plain_ms=cuda_ms(torch, e_plain, 3), bound_ms=b_ms, bound_by=b_by)
            log(f"train_ibrnet kernel E supercell_color R={R} S={S}: max|d| {err:.3e} (tol "
                f"1e-5), {out['E']['ms']:.4f} ms vs plain {out['E']['plain_ms']:.3f} ms, bound "
                f"{b_ms:.4f} ms ({b_by})")
            check_close("train_ibrnet supercell_color", err, 1e-5)
            del got
        cond, ndc0 = query_cond_info(cfg, pts, ref_w2c, ref_intr, ref_nf, tables, H_, W_,
                                     block_ut=block_ut, color_ut=color_ut)
        ray_unit = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
        ray_ref = (ray_unit @ ref_w2c[:, 0, :3, :3].transpose(-1, -2))[:, :, None] \
            .expand(*pts.shape[:3], 3).contiguous()
        out["C"] = decoder_case(torch, kc, dev, (renderer.model.nerf_dec, cfg, ndc0.contiguous(),
                                                 ray_ref, cond, depth, ray),
                                f"train_ibrnet {R}-ray slice")
        out["route"] = {"block_ut": block_ut, "color_ut": color_ut}
        del cond, ndc0, pts, grids, tables
    return out


def plain_render(cfg, model, dev, batch, n_slices=None, pose=None, setbg=False):
    """The batch's target (or `pose`) with every kernel replaced by its
    plain version, onto a white background with setbg: dict of [1, H*W, *],
    or {"rgb": [1, rays, 3]} of the first n_slices ray slices only."""
    import torch
    from matchnerf_tpu_torch import camera
    from matchnerf_tpu_torch.models.matchnerf import render_rays
    from matchnerf_tpu_torch.renderer import Renderer, extract_poses
    plain = Renderer(cfg, model, dev, kernel=False)
    plain.setbg_opaque = setbg
    pose = pose or extract_poses(batch)
    ref_images = plain.tensor(batch["images"][:, :3])
    tables = plain.build_tables(ref_images, plain.encode(ref_images))
    vw, vh = (int(x) for x in batch["img_wh"][0])
    if n_slices is None:
        return plain.render_by_slices(pose, tables, vh, vw)
    R = plain.rays_per_slice(1)
    grid = camera.pixel_grid(vh, vw, legacy=cfg.nerf.legacy_coord, device=plain.device)
    outs = []
    with torch.no_grad():
        for s0 in range(0, n_slices * R, R):
            outs.append(render_rays(plain.model, cfg, grid[s0:s0 + R][None],
                                    *plain._pose_tensors(pose), tables, vh, vw,
                                    kernel=False, setbg_opaque=setbg)["rgb"])
    return {"rgb": torch.cat(outs, dim=1)}


def ibrnet_phase(torch, F, dev, seed, counters, trees):
    """Phase 14: `python -m matchnerf_tpu_torch.train --config train_ibrnet`
    (`train.build_coach` and `train_model`) at 1008x756 on synthetic IBRNet
    and LLFF trees with the encoder from a synthetic GMFlow checkpoint: the
    sanity validation and test, IBR_STEPS steps, validation, the LLFF test
    and the checkpoint, then the resume; one validation and one test image
    with their launches, the first slices of each against all-plain, the
    eval kernels' device ms; the first-step check with and without remat,
    the warm step's ms and peak memory with and without remat; A and A' at
    [96,768,128], B' at the 96x128 and 192x256 f32 tables, and C, D and E
    on a 23552-ray slice, each against its plain twin (C, D and E on the
    weights before the steps, the same in every run). `trees` is the
    future of `write_ibrnet_trees` (`start_ibrnet_trees`)."""
    t_phase = time.perf_counter()
    from matchnerf_tpu_torch.config import ibrnet_train_config
    from matchnerf_tpu_torch.engine import Coach
    from matchnerf_tpu_torch.models.matchnerf import init_matchnerf
    from matchnerf_tpu_torch.ops import block_cosine_prior as kd
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    from matchnerf_tpu_torch.train import build_coach
    from matchnerf_tpu_torch.utils.checkpoint import load_checkpoint
    W_, H_ = IBR_WH
    card = card_line()
    out = {"card": card, "img_wh": [W_, H_], "steps": IBR_STEPS}
    t0 = time.perf_counter()
    ibr, llff, out["trees_s"] = trees.result()
    out["trees_wait_s"] = time.perf_counter() - t0
    work = os.path.dirname(ibr)
    pth = os.path.join(work, "gmflow_synthetic.pth")
    src = write_gmflow_checkpoint(torch, ibrnet_train_config(), seed, pth)
    log(f"train_ibrnet: synthetic IBRNet tree (2 scenes x 8 views) and LLFF gpnr tree at "
        f"{W_}x{H_} written in {out['trees_s']:.1f} s by a process started before phase 1 "
        f"(waited {out['trees_wait_s']:.1f} s for it), GMFlow checkpoint under {work}")
    args = ["--config", "train_ibrnet", "--name=ibrnet", f"--output_root={work}/runs",
            f"--encoder.pretrain_weight={pth}", f"--data_train.root_dir={ibr}",
            f"--data_val.root_dir={ibr}", f"--data_test.llff.root_dir={llff}", "--max_epoch=1",
            f"--data_train.max_len={IBR_STEPS}", "--data_val.max_len=1",
            "--data_test.llff.max_len=1", "--freq.test_ep=1", "--freq.ckpt_ep=1",
            "--freq.scalar=1", "--tb=false"]
    coach = build_coach(args)
    state = coach.model.state_dict()
    seeded = init_matchnerf(coach.cfg, torch.Generator().manual_seed(0)).state_dict()
    loaded = all(torch.equal(state[f"feat_enc.{k}"].cpu(), v) for k, v in src.items()
                 if not k.startswith("featup_net."))
    kept = all(torch.equal(v.cpu(), seeded[k]) for k, v in state.items()
               if k.startswith(("feat_enc.featup_net.", "nerf_dec.")))
    log(f"train_ibrnet: encoder from the GMFlow checkpoint {loaded}, featup_net and decoder "
        f"from the seed {kept}")
    if not (loaded and kept):
        raise AssertionError("train_ibrnet: the GMFlow encoder init did not load as it should")
    # C, D and E against their plain twins on the weights before the steps:
    # these are the same in every run, while the trained ones differ from run
    # to run through the backward's atomic sums
    out["eval_slice"] = ibrnet_eval_slice(torch, dev, coach.cfg, coach.renderer,
                                          next(iter(coach.val_loader)))

    # the run: sanity validation and test, the steps, validation, test, checkpoint
    timed = {"validate_s": [], "test_s": []}
    coach.validate_model = timed_hook(torch, coach.validate_model, timed["validate_s"])
    coach.test_model = timed_hook(torch, coach.test_model, timed["test_s"])
    events = []
    step = coach.step

    def timed_step(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        r = step(*a, **k)
        e1.record()
        events.append((e0, e1))
        return r
    coach.step = timed_step
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coach.train_model()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_launches = {k: c.launches for k, c in counters.items()}
    plain_cuda = {k: c.plain_on_cuda for k, c in counters.items()}
    coach.step = step
    step_ms = [a.elapsed_time(b) for a, b in events]
    with open(coach.scalars_path) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss_render"] for r in recs if r["split"] == "train"]
    vals = [r for r in recs if r["split"] == "val"]
    tests = [r for r in recs if r["split"] == "llff"]
    mdir = os.path.join(coach.output_path, "models")
    ckpts = sorted(os.listdir(mdir))
    log(f"train_ibrnet loop: {IBR_STEPS} steps in {wall:.3f} s with validations "
        f"{[round(t, 3) for t in timed['validate_s']]} s and LLFF tests "
        f"{[round(t, 3) for t in timed['test_s']]} s (the sanity check first); step ms (CUDA "
        f"events) {[round(t, 2) for t in step_ms]}; losses {[round(x, 6) for x in losses]}; "
        f"val PSNR {[round(r['PSNR'], 3) for r in vals]}, LLFF PSNR "
        f"{[round(r['PSNR'], 3) for r in tests]}; checkpoints {ckpts}; route "
        f"{coach.last_route} (None: B'); launches {run_launches}; {card}")
    if len(losses) != IBR_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train_ibrnet: losses {losses}")
    if ckpts != [f"ep1_it{IBR_STEPS}.ckpt", "latest.ckpt"]:
        raise AssertionError(f"train_ibrnet: checkpoints {ckpts}")
    if len(vals) != 2 or len(tests) != 2 or not all(
            math.isfinite(r["PSNR"]) and math.isfinite(r["SSIM"]) for r in vals + tests):
        raise AssertionError(f"train_ibrnet: validation {vals}, test {tests}")
    if any(plain_cuda.values()):
        raise AssertionError(f"train_ibrnet: plain versions ran on CUDA: {plain_cuda}")
    # 12 A' launches a step and 12 A launches an encode (2 validations, 2 tests);
    # B' at both scales (iid rays)
    want = {"window_attention": 12 * (IBR_STEPS + 4), "window_attention_bwd": 12 * IBR_STEPS,
            "cosine_prior_bwd": 2 * IBR_STEPS}
    if any(run_launches[k] != v for k, v in want.items()) or not run_launches["cond_nerf_decode"]:
        raise AssertionError(f"train_ibrnet: launches {run_launches}, expected {want} and C")
    out.update(loop_wall_s=wall, step_ms=step_ms,
               warm_step_ms=float(np.mean(step_ms[1:])), losses=losses,
               validate_s=list(timed["validate_s"]), test_s=list(timed["test_s"]),
               val_psnr=[r["PSNR"] for r in vals], llff_psnr=[r["PSNR"] for r in tests],
               checkpoints=ckpts, launches=run_launches)

    # the resume: the model, Adam(W) and schedule state, epoch and iteration
    ckpt = load_checkpoint(os.path.join(mdir, "latest.ckpt"))
    resumed = build_coach(args + ["--resume"])
    model_equal = all(torch.equal(v.cpu(), ckpt["model"][k])
                      for k, v in resumed.model.state_dict().items())
    opt, opt_ckpt = resumed.opt.state_dict(), ckpt["optim"]
    adam, adam_ckpt = opt["adamw"]["state"], opt_ckpt["adamw"]["state"]
    opt_equal = (opt["count"] == opt_ckpt["count"] == IBR_STEPS
                 and adam.keys() == adam_ckpt.keys()
                 and all(torch.equal(adam[i][k].cpu(), adam_ckpt[i][k])
                         for i in adam for k in adam[i]))
    at = (resumed.epoch_start, resumed.iter_start)
    log(f"train_ibrnet resume: at epoch {at[0]} iteration {at[1]}, model bit-equal "
        f"{model_equal}, optimizer and schedule state bit-equal {opt_equal}")
    if not (model_equal and opt_equal and at == (1, IBR_STEPS)):
        raise AssertionError("train_ibrnet: the resume did not restore the checkpoint")
    out["resume"] = {"epoch": at[0], "iter": at[1], "model_bit_equal": model_equal,
                     "optimizer_bit_equal": opt_equal}
    del resumed, ckpt

    # one validation image and one LLFF test image alone: launches, seconds,
    # the first 2 slices against all-plain, the eval kernels' device ms
    renderer = coach.renderer
    n_slices = math.ceil(W_ * H_ / renderer.rays_per_slice(1))
    images = {}
    for name, run in (("validation", lambda: coach.validate_model(iteration=coach.it)),
                      ("llff_test", lambda: coach.test_model(ep=1, save_images=False))):
        renders = []
        forward = renderer.forward
        renderer.forward = lambda *a, **k: renders.append((a, forward(*a, **k))) or renders[-1][1]
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        renderer.forward = forward
        launches = {k: c.launches for k, c in counters.items()}
        routes = {"B": dict(kb.COUNTER.by_entry), "D": dict(kd.COUNTER.by_entry)}
        route = renderer.last_route
        (batch, *_), rendered = renders[0]
        mode = "val" if name == "validation" else "test"
        ref = plain_render(coach.cfg, coach.model, dev, batch, 2)["rgb"]
        agreement = psnr(rendered["rgb"][:, :ref.shape[1]], ref)
        kms = kernel_device_ms(torch, lambda: renderer.forward(batch, mode=mode))
        n_block = sum(u is not None for u in route["block_ut"] or ())
        log(f"train_ibrnet {name} image {W_}x{H_}: {seconds:.4f} s, {n_slices} slices of "
            f"{renderer.rays_per_slice(1)} rays, route {route}, launches {launches}, B "
            f"{routes['B']}, D {routes['D']}; first 2 slices vs all-plain PSNR {agreement:.2f} dB "
            f"(need >= 50); device ms (launches) "
            + ", ".join(f"{k} {ms:.3f} ({n})" for k, (ms, n) in sorted(kms.items()))
            + f"; {card}")
        expect = {"window_attention": 12, "cond_nerf_decode": n_slices,
                  "block_cosine_prior": n_block * n_slices,
                  "cosine_prior": (2 - n_block) * n_slices,
                  "supercell_color": n_slices if route["color_ut"] is not None else 0}
        if any(launches[k] != v for k, v in expect.items()):
            raise AssertionError(f"train_ibrnet {name}: launches {launches}, expected {expect}")
        if set(routes["B"]) - {"cosine_prior_bf16"} or set(routes["D"]) - {
                "block_cosine_prior_bf16"}:
            raise AssertionError(f"train_ibrnet {name}: tables other than bf16: {routes}")
        if not agreement >= 50.0 or not bool(rendered["rgb"].isfinite().all()):
            raise AssertionError(f"train_ibrnet {name}: agreement {agreement:.2f} dB")
        images[name] = {"seconds": seconds, "slices": n_slices,
                        "rays_per_slice": renderer.rays_per_slice(1), "route": route,
                        "launches": launches, "launches_by_route": routes,
                        "psnr_first_2_slices_vs_plain_db": agreement,
                        "kernel_device_ms": {k: {"ms": ms, "launches": n, "ms_per_launch": ms / n}
                                             for k, (ms, n) in kms.items()}}
        del renders, rendered, ref
    out["images"] = images
    train_batch = next(iter(coach.train_loader))
    out["B_bwd"] = ibrnet_train_tables(torch, dev, coach.cfg, coach.model, train_batch, seed)
    del coach
    torch.cuda.empty_cache()

    # the first step through the kernels vs all-plain, remat off and on; then
    # warm steps: ms, peak memory and launches per step
    cfg = ibrnet_train_config()
    cfg.encoder.pretrain_weight = None
    out["first_step"], out["remat"] = {}, {}
    for remat in (False, True):
        tag = "remat_on" if remat else "remat_off"
        rcfg = copy.deepcopy(cfg)
        rcfg.precision.remat_encoder = remat
        out["first_step"][tag] = first_step_check(
            torch, dev, rcfg, train_batch, seed, f"train_ibrnet.yaml bf16 policy, {tag}",
            (1e-2, 0.5, 0.1), img_hw=(H_, W_))
        torch.cuda.empty_cache()
        model = init_matchnerf(rcfg, torch.Generator().manual_seed(seed)).to(dev)
        c = Coach(rcfg, model, dev)
        c.setup_optimizer(100)
        c.train_iteration(train_batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in counters.values():
            k.reset()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(IBR_TIMED_STEPS):
            c.train_iteration(train_batch)
        e1.record()
        torch.cuda.synchronize()
        per_step = {k: v.launches / IBR_TIMED_STEPS for k, v in counters.items()}
        r = {"warm_step_ms": e0.elapsed_time(e1) / IBR_TIMED_STEPS,
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
             "launches_per_step": per_step}
        log(f"train_ibrnet step {tag}: {r['warm_step_ms']:.3f} ms per warm step (CUDA events, "
            f"{IBR_TIMED_STEPS} steps), peak device memory {r['peak_gib']:.3f} GiB, launches per "
            f"step {per_step}; {card}")
        must = {"window_attention": 24 if remat else 12, "window_attention_bwd": 12,
                "cosine_prior": 2, "cosine_prior_bwd": 2}
        if any(per_step[k] != v for k, v in must.items()):
            raise AssertionError(f"train_ibrnet step {tag}: launches {per_step}, expected {must}")
        out["remat"][tag] = r
        del model, c
        torch.cuda.empty_cache()
    out.update(ibrnet_attention(torch, F, dev, seed))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"train_ibrnet phase: {out['phase_s']:.1f} s")
    return out


SERVE_TARGET_DEG = (-8.0, 4.0)     # /render cameras beside phase 2's target, between its sources
# frames of each /render_path trajectory: the interpolated path has
# V * (n // 3) poses and fails for any other count (ROADMAP Queue 3), so 9
SERVE_FRAMES = {"interpolate": 9, "spiral": 8}
SERVE_CONCURRENT = 4               # /render requests in flight at once
MIB = 2 ** 20


def arc_w2c(deg):
    """World-to-camera [4,4] of a camera on the scene's arc at `deg`
    degrees, made as synth.make_scene_views makes its cameras."""
    from matchnerf_tpu_torch.data import synth
    c2w = np.eye(4)
    c2w[:3] = synth.look_at_opencv(arc_eye(math.radians(deg)), (0.0, 0.1, 0.0))
    return np.linalg.inv(c2w).astype(np.float32)


def wire(port, method, path, obj=None):
    """One HTTP request to the render server on 127.0.0.1 -> (status, JSON
    body, round-trip seconds: the request's JSON out, the answer's JSON in)."""
    import urllib.error
    import urllib.request
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method, data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            code, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, body = e.code, json.loads(e.read())
    return code, body, time.perf_counter() - t0


def to_u8(rgb):
    """The server's uint8 quantisation of a float32 image."""
    return np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8)


def allocated(torch):
    """Bytes of live device tensors, after a garbage collection (garbage
    that earlier phases left, freed at some later point, would move the
    level) and with cuBLAS's per-handle workspaces (which the caching
    allocator counts, and each new handler thread's handle can add)
    released."""
    gc.collect()
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated()


def tree_tensors(x):
    """The tensors of a nested dict / list of tables."""
    if isinstance(x, dict):
        return [t for v in x.values() for t in tree_tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tree_tensors(v)]
    return [x] if hasattr(x, "element_size") else []


SERVE_PRINTER_WH = (512, 384)      # tools/serve_smoke.py's default --img_wh


def serve_printer(request, svc, counters, served):
    """The port-side twin of tools/serve_smoke.py's printer run: the in-repo
    printer scene through the port's COLMAP loader at 512x384 (its JPEGs
    decoded without PIL), POST /scenes with its 3 source views, one POST
    /render at its target view, bit-equal to a direct render of the stored
    tables, then DELETE. `request` counts each request's launches into
    `served`."""
    from matchnerf_tpu_torch.data.colmap import COLMAPDataset
    from matchnerf_tpu_torch.serve import decode_array, encode_array
    pw, ph = SERVE_PRINTER_WH
    t0 = time.perf_counter()
    ps = COLMAPDataset(os.path.join(REPO, "docs", "demo_data"), "test", n_views=3,
                       img_wh=SERVE_PRINTER_WH, scene_list=["printer"])[0]
    load_s = time.perf_counter() - t0
    before = dict(served)
    body, scenes_s = request("POST", "/scenes", {k: encode_array(ps[k][:3]) for k in (
        "images", "extrinsics", "intrinsics", "near_fars")})
    sid = body["scene_id"]
    scene_launches = {k: served[k] - before[k] for k in served}
    sc = svc.scenes[sid]
    pose = {k: ps[k][3][None] for k in ("extrinsics", "intrinsics", "near_fars")}
    before = dict(served)
    body, render_s = request("POST", "/render", {
        "scene_id": sid, "extrinsic": encode_array(ps["extrinsics"][3]),
        "intrinsic": encode_array(ps["intrinsics"][3]),
        "near_far": encode_array(ps["near_fars"][3]), "out_dtype": "float32"})
    render_launches = {k: served[k] - before[k] for k in served}
    rgb, depth = decode_array(body["rgb"]), decode_array(body["depth"])
    with svc.device_lock:
        o = svc.renderer.render_by_slices({"tgt": dict(pose, extrinsics=pose["extrinsics"][:, :3]),
                                           "ref": sc["ref"]}, sc["tables"], ph, pw)
        want_rgb = o["rgb"].reshape(ph, pw, 3).float().cpu().numpy()
        want_depth = o["depth"].reshape(ph, pw).float().cpu().numpy()
    del sc, o
    request("DELETE", f"/scenes/{sid}")
    if rgb.shape != (ph, pw, 3) or not (np.isfinite(rgb).all() and np.isfinite(depth).all()):
        raise AssertionError(f"serve printer /render: {rgb.shape}, finite "
                             f"{np.isfinite(rgb).all()} {np.isfinite(depth).all()}")
    if not (np.array_equal(rgb, want_rgb) and np.array_equal(depth, want_depth)):
        raise AssertionError(f"serve printer /render: not bit-equal to the direct render (max|d| "
                             f"rgb {np.abs(rgb - want_rgb).max():.3e})")
    for k, n in (("window_attention", scene_launches["window_attention"]),
                 ("cond_nerf_decode", render_launches["cond_nerf_decode"])):
        if n <= 0:
            raise AssertionError(f"serve printer: kernel {k} was not launched: /scenes "
                                 f"{scene_launches}, /render {render_launches}")
    out = {"img_wh": [pw, ph], "load_s": load_s, "scenes_s": scenes_s, "render_s": render_s,
           "route": dict(svc.renderer.last_route), "scenes_launches": scene_launches,
           "render_launches": render_launches, "rgb_mean": float(rgb.mean())}
    log(f"serve printer (docs/demo_data, COLMAP loader, {pw}x{ph}, tools/serve_smoke.py's run): "
        f"loaded in {load_s:.4f} s, /scenes {scenes_s:.4f} s (launches {scene_launches}), "
        f"/render at the target view {render_s:.4f} s, route {out['route']}, launches "
        f"{render_launches}; bit-equal to the direct render, rgb mean {out['rgb_mean']:.4f}")
    return out


def serve_phase(torch, dev, model, batch, counters):
    """Phase 15: `matchnerf_tpu_torch.serve.serve` with configs/test.yaml as
    shipped and phase 2's model on the card, max_scenes 2, on a daemon
    thread, driven over HTTP on 127.0.0.1: /healthz, /scenes (Kernel A in
    its trace), /render at 3 cameras (bit-equal to direct renders, >= 50 dB
    against all-plain, C, D and E in a trace, uint8 against float32),
    /render_path interpolate and spiral (bit-equal to direct frames),
    concurrent renders against serial ones, LRU eviction and DELETE with
    the device memory they free. The launches of every served request are
    counted (set to 0 just before it, read just after); the direct and
    plain renders they are compared with are not."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from matchnerf_tpu_torch.config import CONFIGS
    from matchnerf_tpu_torch.serve import decode_array, encode_array, serve

    t_phase = time.perf_counter()
    card = card_line()
    cfg = CONFIGS["test"]()
    served = {k: 0 for k in counters}
    plain_cuda = {k: 0 for k in counters}

    def counted(fn):
        for c in counters.values():
            c.reset()
        result = fn()
        for k, c in counters.items():
            served[k] += c.launches
            plain_cuda[k] += c.plain_on_cuda
        return result

    def request(method, path, obj=None, want=200):
        code, body, secs = counted(lambda: wire(port, method, path, obj))
        if code != want:
            raise AssertionError(f"serve {method} {path}: {code} {str(body)[:400]} "
                                 f"(expected {want})")
        return body, secs

    def has(names, kernel):
        return any(KERNEL_RES[kernel].search(n) for n in names)

    extr, intr, nfs = (batch[k][0] for k in ("extrinsics", "intrinsics", "near_fars"))
    c2ws = np.linalg.inv(extr.astype(np.float64)).astype(np.float32)   # all 4 cameras
    scene = {"images": encode_array(batch["images"][0, :3]),
             "extrinsics": encode_array(extr[:3]), "intrinsics": encode_array(intr[:3]),
             "near_fars": encode_array(nfs[:3]), "c2ws_all": encode_array(c2ws)}
    targets = [extr[3]] + [arc_w2c(a) for a in SERVE_TARGET_DEG]

    httpd = serve(cfg, model, port=0, host="127.0.0.1", max_scenes=2, device=dev)
    port, svc = httpd.server_address[1], httpd.service
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    out = {"card": card, "img_wh": [W, H], "max_scenes": 2, "renders": []}
    try:
        torch.cuda.reset_peak_memory_stats()
        health, _ = request("GET", "/healthz")
        if health.get("backend") != "cuda":
            raise AssertionError(f"serve /healthz: {health}")

        def add_drop():
            sid_ = request("POST", "/scenes", scene)[0]["scene_id"]
            request("DELETE", f"/scenes/{sid_}")
        out["scenes_trace"] = kernel_names(torch, add_drop, iters=1)
        if not has(out["scenes_trace"], "window_attention"):
            raise AssertionError(f"serve /scenes: no Kernel A in its trace {out['scenes_trace']}")
        mem0 = allocated(torch)
        body, out["scenes_s"] = request("POST", "/scenes", scene)
        sid = body["scene_id"]
        out["encode_s"] = svc.last_timings["encode_s"]
        sc = svc.scenes[sid]
        out["scene_mib"] = nbytes(*tree_tensors(sc["tables"])) / MIB
        log(f"serve /scenes {sid}: 3 views {W}x{H} float32 over the wire in "
            f"{out['scenes_s']:.4f} s (upload, encode and tables {out['encode_s']:.4f} s), "
            f"tables {out['scene_mib']:.1f} MiB on the device; Kernel A in the trace of a "
            f"/scenes request: {[n for n in out['scenes_trace'] if has([n], 'window_attention')]}"
            f" ({card})")

        def tgt(e, dtype="float32", scene_id=None):
            return {"scene_id": scene_id or sid, "extrinsic": encode_array(e),
                    "intrinsic": encode_array(intr[3]), "near_far": encode_array(nfs[3]),
                    "out_dtype": dtype}

        def direct(tgt_pose):
            with svc.device_lock:
                o = svc.renderer.render_by_slices({"tgt": tgt_pose, "ref": sc["ref"]},
                                                  sc["tables"], H, W)
                return (o["rgb"].reshape(H, W, 3).float().cpu().numpy(),
                        o["depth"].reshape(H, W).float().cpu().numpy())

        serial = []
        for i, e in enumerate(targets):
            body, secs = request("POST", "/render", tgt(e))
            rgb, depth = decode_array(body["rgb"]), decode_array(body["depth"])
            t, route = dict(svc.last_timings), dict(svc.renderer.last_route)
            want_rgb, want_depth = direct({"extrinsics": e[None, :3],
                                           "intrinsics": intr[3][None],
                                           "near_fars": nfs[3][None]})
            if rgb.shape != (H, W, 3) or depth.shape != (H, W) or rgb.dtype != np.float32:
                raise AssertionError(f"serve /render {i}: {rgb.shape} {rgb.dtype} {depth.shape}")
            if not (np.isfinite(rgb).all() and np.isfinite(depth).all()
                    and rgb.min() >= -1e-6 and rgb.max() <= 1.0 + 1e-6):
                raise AssertionError(f"serve /render {i}: non-finite or out of [0,1]")
            if not (np.array_equal(rgb, want_rgb) and np.array_equal(depth, want_depth)):
                raise AssertionError(
                    f"serve /render {i}: not bit-equal to the direct render (max|d| rgb "
                    f"{np.abs(rgb - want_rgb).max():.3e}, depth "
                    f"{np.abs(depth - want_depth).max():.3e})")
            serial.append((rgb, depth))
            r = {"wire_s": secs, "render_s": t["render_s"], "pose_prep_s": t["pose_prep_s"],
                 "wire_overhead_s": secs - t["render_s"], "route": route}
            out["renders"].append(r)
            log(f"serve /render {i} (float32, {W}x{H}): wire round trip {secs:.4f} s, render "
                f"{t['render_s']:.4f} s of it (pose_prep {t['pose_prep_s']:.4f} s), the rest "
                f"{r['wire_overhead_s']:.4f} s; route {route}; bit-equal to the direct render "
                f"({card})")

        plain = plain_render(cfg, model, dev, dict(batch, img_wh=np.array([[W, H]])))
        out["agreement_psnr_db"] = psnr(torch.from_numpy(serial[0][0]).reshape(1, -1, 3),
                                        plain["rgb"].cpu())
        del plain
        log(f"serve /render 0 vs the all-plain render: {out['agreement_psnr_db']:.2f} dB "
            "(need >= 50)")
        if not out["agreement_psnr_db"] >= 50.0:
            raise AssertionError(f"serve: agreement PSNR {out['agreement_psnr_db']:.2f} dB < 50")
        out["render_trace"] = kernel_names(
            torch, lambda: request("POST", "/render", tgt(targets[0])), iters=1)
        missing = [k for k in ("cond_nerf_decode", "block_cosine_prior", "supercell_color")
                   if not has(out["render_trace"], k)]
        if missing:
            raise AssertionError(f"serve /render: {missing} not in its trace "
                                 f"{out['render_trace']}")
        # where one request's device time goes: the eval kernels' device ms
        kms = kernel_device_ms(torch, lambda: request("POST", "/render", tgt(targets[0])))
        out["render_kernel_ms"] = {k: {"ms": ms, "launches": n} for k, (ms, n) in kms.items()}
        log(f"serve /render 0, device ms and launches by kernel (one request under "
            f"torch.profiler): {out['render_kernel_ms']} ({card})")
        body, _ = request("POST", "/render", tgt(targets[0], "uint8"))
        rgb8 = decode_array(body["rgb"])
        if rgb8.dtype != np.uint8 or not np.array_equal(rgb8, to_u8(serial[0][0])):
            raise AssertionError("serve /render uint8: not the float32 render quantised")

        path_pose = {"ref": sc["ref"], "tgt": {"intrinsics": sc["ref"]["intrinsics"][0, :1],
                                               "near_fars": sc["ref"]["near_fars"][0, :1]}}
        out["paths"] = {}
        for mode, vbatch in (("interpolate", None), ("spiral", {"c2ws_all": c2ws[None]})):
            n = SERVE_FRAMES[mode]
            body, secs = request("POST", "/render_path", {"scene_id": sid, "n_frames": n,
                                                          "mode": mode})
            frames, t = decode_array(body["frames"]), dict(svc.last_timings)
            want = np.stack([to_u8(direct(fp)[0]) for fp in svc.renderer.get_video_rendering_path(
                path_pose, mode, n, batch=vbatch)])
            if frames.shape != want.shape or not np.array_equal(frames, want):
                raise AssertionError(f"serve /render_path {mode}: {frames.shape} frames not "
                                     f"bit-equal to the direct frames {want.shape}")
            out["paths"][mode] = {"frames": n, "wire_s": secs, "frames_per_s": n / secs,
                                  "render_s": t["render_s"], "pose_prep_s": t["pose_prep_s"]}
            log(f"serve /render_path {mode}: {n} frames {W}x{H} in {secs:.4f} s, "
                f"{n / secs:.3f} frames/s over the wire (render {t['render_s']:.4f} s,"
                f" pose_prep {t['pose_prep_s']:.4f} s of it); bit-equal to the direct frames "
                f"({card})")

        jobs = [i % len(targets) for i in range(SERVE_CONCURRENT)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=SERVE_CONCURRENT) as ex:
            results = counted(lambda: [f.result() for f in [
                ex.submit(wire, port, "POST", "/render", tgt(targets[j])) for j in jobs]])
        out["concurrent_s"] = time.perf_counter() - t0
        for j, (code, body, _) in zip(jobs, results):
            if code != 200 or not (np.array_equal(decode_array(body["rgb"]), serial[j][0]) and
                                   np.array_equal(decode_array(body["depth"]), serial[j][1])):
                raise AssertionError(f"serve: a concurrent /render of camera {j} ({code}) is "
                                     "not bit-equal to its serial render")
        log(f"serve: {SERVE_CONCURRENT} concurrent /render requests in "
            f"{out['concurrent_s']:.4f} s, each bit-equal to its serial render ({card})")

        request("DELETE", f"/scenes/{sid}")
        body, _ = request("DELETE", f"/scenes/{sid}", want=404)
        del sc
        out["mem_after_delete_mib"] = (allocated(torch) - mem0) / MIB
        m0, levels, ids = allocated(torch), [], []
        for _ in range(3):                                  # max_scenes 2: the first goes
            ids.append(request("POST", "/scenes", scene)[0]["scene_id"])
            levels.append(allocated(torch))
            if len(ids) == 1:
                first = [weakref.ref(t_) for t_ in tree_tensors(svc.scenes[ids[0]]["tables"])]
        if ids[0] in svc.scenes or list(svc.scenes) != ids[1:]:
            raise AssertionError(f"serve LRU: scenes {list(svc.scenes)} after adding {ids}")
        alive = sum(r() is not None for r in first)
        if alive:
            raise AssertionError(f"serve LRU: {alive} of the evicted scene's {len(first)} "
                                 "device tensors are still referenced")
        body, _ = request("POST", "/render", tgt(targets[0], scene_id=ids[0]), want=404)
        if body.get("error") != f"unknown scene '{ids[0]}'":
            raise AssertionError(f"serve LRU: {body}")
        for s_ in ids[1:]:
            request("DELETE", f"/scenes/{s_}")
        m_end = allocated(torch)
        out["lru_mib"] = {"scene": (levels[0] - m0) / MIB, "two_scenes": (levels[1] - m0) / MIB,
                          "after_eviction": (levels[2] - m0) / MIB, "after_delete": (m_end - m0) / MIB}
        log(f"serve LRU (max_scenes 2): the evicted scene's {len(first)} device tensors "
            f"freed; device memory over the level before the scenes, MiB: {out['lru_mib']} "
            "(a level with scenes counts the allocator's blocks, each up to 1 MiB past its "
            f"tensor); after DELETE of the first scene {out['mem_after_delete_mib']:.3f} MiB "
            "over its level before it")
        for name, d in (("after DELETE of the rest", m_end - m0),
                        ("after DELETE of the first scene", out["mem_after_delete_mib"] * MIB)):
            if abs(d) > MIB:
                raise AssertionError(f"serve: device memory {name}: {d / MIB:.3f} MiB (> 1)")
        out["printer"] = serve_printer(request, svc, counters, served)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("serve: the server thread did not stop")
    out["launches"], out["plain_cuda"] = served, plain_cuda
    for k in ("window_attention", "cond_nerf_decode", "block_cosine_prior", "supercell_color"):
        if served[k] <= 0:
            raise AssertionError(f"serve: kernel {k} was not launched: {served}")
    if any(plain_cuda.values()):
        raise AssertionError(f"serve: plain versions ran on CUDA tensors: {plain_cuda}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"serve: launches of the served requests {served}; peak device memory "
        f"{out['peak_gib']:.2f} GiB; phase {out['phase_s']:.1f} s ({card})")
    return out


HOST_IO_OUT_WH = (960, 640)        # configs/test.yaml's T&T and LLFF img_wh
HOST_IO_REPEATS = 5                # timed calls per decode or resize


def host_io_phase(tnt_tree, photos):
    """Phase 17: the host's image I/O without PIL (data/jpeg.py,
    data/resample.py in the host library): ms per decode of a printer JPEG
    and of the encoder-made JPEGs at HOST_IO_WH, ms per LANCZOS and
    BILINEAR resize of each to 960x640, the T&T loader's seconds per sample
    (phase 13's tree: 4 JPEGs decoded and resized), and the decoded
    1920x1056 JPEG held to PIL's sha256 of it (ROUNDTRIP_SHA256); then the
    progressive JPEGs: every fixture held to PIL's sha256
    (`progressive_check`), the progressive printer and photo timed as the
    baseline files, and the COLMAP loader on the progressive printer tree
    (`progressive_tree_check`)."""
    import hashlib
    import importlib.util
    import shutil
    import tempfile

    from matchnerf_tpu_torch.data import jpeg, resample
    from matchnerf_tpu_torch.data.common import LOAD_THREADS
    from matchnerf_tpu_torch.data.tnt import TNTDataset
    t_phase = time.perf_counter()
    card = card_line()
    out = {"card": card, "pil_installed": importlib.util.find_spec("PIL") is not None,
           "repeats": HOST_IO_REPEATS, "images": {}}

    def timed(fn):
        fn()                                         # warm: caches, the thread pool
        t0 = time.perf_counter()
        for _ in range(HOST_IO_REPEATS):
            r = fn()
        return r, (time.perf_counter() - t0) / HOST_IO_REPEATS * 1e3

    rw, rh = ROUNDTRIP_WH
    files = {"printer_504x378": os.path.join(PRINTER_DIR, "0.jpeg"),
             **{f"photo_{k}": v for k, v in photos.items()},
             "progressive_printer_504x378": os.path.join(PROGRESSIVE_DIR, "printer_0.jpg"),
             f"progressive_photo_{rw}x{rh}": os.path.join(PROGRESSIVE_DIR,
                                                          f"photo_{rw}x{rh}.jpg")}
    for label, path in files.items():
        with open(path, "rb") as f:
            data = f.read()
        img, decode_ms = timed(lambda: jpeg.decode_jpeg(data, path))
        _, lanczos_ms = timed(lambda: resample.resize(img, HOST_IO_OUT_WH, "lanczos"))
        _, bilinear_ms = timed(lambda: resample.resize(img, HOST_IO_OUT_WH, "bilinear"))
        h, w = img.shape[:2]
        out["images"][label] = {"wh": [w, h], "bytes": len(data), "decode_ms": decode_ms,
                                "megapixels_per_s": w * h / decode_ms / 1e3,
                                "lanczos_to_960x640_ms": lanczos_ms,
                                "bilinear_to_960x640_ms": bilinear_ms}
        log(f"host io {label}: {len(data)} bytes, decode {decode_ms:.3f} ms "
            f"({w * h / decode_ms / 1e3:.1f} Mpixel/s), resize to {HOST_IO_OUT_WH[0]}x"
            f"{HOST_IO_OUT_WH[1]} LANCZOS {lanczos_ms:.3f} ms, BILINEAR {bilinear_ms:.3f} ms "
            f"(host CPU, mean of {HOST_IO_REPEATS}; {card})")
        if label == f"photo_{rw}x{rh}":
            sha = hashlib.sha256(img.tobytes()).hexdigest()
            if sha != ROUNDTRIP_SHA256:
                raise AssertionError(f"host io: decode(encode(seeded_photo)) sha256 {sha}, PIL "
                                     f"gives {ROUNDTRIP_SHA256}")
            out["roundtrip_sha256_ok"] = True
    if not out.get("roundtrip_sha256_ok"):
        raise AssertionError(f"host io: no {ROUNDTRIP_WH} JPEG among {list(photos)}")
    root, meta = tnt_tree
    ds = TNTDataset(root, "test", n_views=3, img_wh=HOST_IO_OUT_WH, meta_dir=meta,
                    nf_mode="minmax")
    sample, ms = timed(lambda: ds[0])
    if sample["images"].shape != (4, HOST_IO_OUT_WH[1], HOST_IO_OUT_WH[0], 3):
        raise AssertionError(f"host io: T&T sample images {sample['images'].shape}")
    out["tnt_sample_s"] = ms / 1e3
    log(f"host io: T&T loader {ms / 1e3:.4f} s per sample (4 JPEGs at {TNT_JPEG_WH[0]}x"
        f"{TNT_JPEG_WH[1]} decoded and resized to {HOST_IO_OUT_WH[0]}x{HOST_IO_OUT_WH[1]} "
        f"with LANCZOS in {LOAD_THREADS} threads); decode(encode(seeded_photo"
        f"{ROUNDTRIP_WH})) equals PIL's (sha256); PIL installed: {out['pil_installed']} "
        f"(unused); {card}")
    out["progressive"] = progressive_check()
    tree = write_progressive_colmap_tree(tempfile.mkdtemp(prefix="chip_smoke_progressive_",
                                                          dir=os.path.join(REPO, "build")))
    out["progressive_tree"] = progressive_tree_check(tree)
    shutil.rmtree(tree)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"host io: {out['progressive']['decoded']} progressive JPEGs (SOF2, tests/data/"
        f"jpeg_progressive) each equal to PIL's decode (sha256), ms of one decode "
        f"{ {k: round(v, 3) for k, v in out['progressive']['ms'].items()} }; the printer "
        f"scene re-saved progressive through COLMAPDataset at {PRINTER_WH[0]}x{PRINTER_WH[1]}: "
        f"{out['progressive_tree']['images']} images equal to PIL's decode and LANCZOS "
        f"(sha256), the sample in {out['progressive_tree']['sample_s']:.3f} s; phase "
        f"{out['phase_s']:.1f} s (host CPU; {card})")
    return out


PAR_STEPS = 3                      # training steps per recipe in each rank of phase 16


def free_port():
    from matchnerf_tpu_torch.parallel.distributed import free_port as port
    return port()


def cluster(rank, world, port):
    return {"parallel": {"coordinator_address": f"127.0.0.1:{port}", "num_processes": world,
                         "process_id": rank}}


def counted(counters, fn):
    """fn() with every count set to 0 just before and read just after:
    (result, launches, plain versions on CUDA)."""
    for c in counters.values():
        c.reset()
    out = fn()
    return (out, {k: c.launches for k, c in counters.items()},
            {k: c.plain_on_cuda for k, c in counters.items()})


PAR_RECIPES = (("train", "cosine_prior_bwd"), ("train_fast", "block_cosine_prior_bwd"))


def train_recipe_cfg(label):
    from matchnerf_tpu_torch.config import dtu_train_config, dtu_train_fast_config
    return dtu_train_config() if label == "train" else dtu_train_fast_config()


def nccl_world_of_one(torch, dev, batch, seed, counters):
    """Phase 16 (a): a process group of one rank on the card (NCCL by the
    backend rule) and one configs/train.yaml step through the gradient
    average; the gradients before and after it, and the parameters after the
    update against AdamW applied to the gradients without it, from the same
    weights, both bit for bit."""
    from matchnerf_tpu_torch.engine import Coach
    from matchnerf_tpu_torch.models.matchnerf import init_matchnerf
    from matchnerf_tpu_torch.parallel import distributed as dist
    from matchnerf_tpu_torch.parallel import mesh
    from matchnerf_tpu_torch.utils.containers import DotDict
    from matchnerf_tpu_torch.train_step import TrainOptimizer
    cfg = train_recipe_cfg("train")
    if not dist.maybe_initialize(DotDict(cluster(0, 1, free_port())), DEVICE):
        raise AssertionError("parallel (a): no process group came up")
    try:
        if dist.backend() != "nccl":
            raise AssertionError(f"parallel (a): backend {dist.backend()} for one rank, "
                                 "expected nccl")
        model = init_matchnerf(cfg, torch.Generator().manual_seed(seed)).to(dev)
        twin = copy.deepcopy(model)
        coach = Coach(cfg, model, dev)
        coach.setup_optimizer(1000)
        seen = {}
        average = mesh.average_gradients

        def spy(params):
            params = list(params)
            seen["before"] = [p.grad.clone() for p in params]
            average(params)
            seen["after"] = [p.grad.clone() for p in params]

        mesh.average_gradients = spy
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, launches, plain = counted(counters, lambda: coach.train_iteration(batch))
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
        finally:
            mesh.average_gradients = average
        reductions = int("after" in seen)
        grads_equal = all(torch.equal(a, b) for a, b in zip(seen["before"], seen["after"]))
        opt = TrainOptimizer(cfg, twin, 1000)
        for p, g in zip(twin.parameters(), seen["before"]):
            p.grad = g.clone()
        opt.step()
        params_equal = all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                              twin.parameters()))
    finally:
        dist.shutdown()
    log(f"parallel (a): NCCL, world of 1: one train.yaml step in {step_s:.3f} s through the "
        f"gradient average ({reductions} all-reduce), loss {float(loss['all']):.7f}; gradients "
        f"bit-equal before and after it {grads_equal}; parameters bit-equal to AdamW on the "
        f"gradients without it {params_equal}; launches {launches}")
    if not (reductions == 1 and grads_equal and params_equal):
        raise AssertionError("parallel (a): the NCCL world of one changed the step")
    if any(plain.values()):
        raise AssertionError(f"parallel (a): plain versions ran on CUDA: {plain}")
    return {"backend": "nccl", "step_s": step_s, "reductions": reductions,
            "grads_bit_equal": grads_equal, "params_bit_equal": params_equal,
            "launches": launches}


def parallel_rank(rank, port, seed, out_dir):
    """A rank of phase 16 (b) and (c), spawned: two ranks on the one card.
    PAR_STEPS steps of train.yaml and of train_fast.yaml in rays mode with
    the encoder's streams sharded (rank 0 saves the first step's loss,
    gradients and parameters), then phase 2's target rendered with
    configs/test.yaml, the eval encoder's streams whole and sharded."""
    import torch
    sys.path.insert(0, REPO)
    from matchnerf_tpu_torch import kernels
    from matchnerf_tpu_torch.config import dtu_eval_config
    from matchnerf_tpu_torch.engine import Coach
    from matchnerf_tpu_torch.models.matchnerf import init_matchnerf
    from matchnerf_tpu_torch.parallel import distributed as dist
    from matchnerf_tpu_torch.renderer import Renderer
    from matchnerf_tpu_torch.utils.containers import DotDict
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from matchnerf_tpu_torch.ops import attention
    dist.maybe_initialize(DotDict(cluster(rank, 2, port)), DEVICE)
    kernels.library()
    counters = kernels.counters()
    dev = torch.device(DEVICE)
    batch = make_scene(seed)
    out = {"rank": rank, "backend": dist.backend(), "train": {}, "eval": {}}
    shapes = set()                      # Kernel A / A''s [windows, L, C] in this rank
    window_attention = attention.window_attention

    def spy(q, *args, **kwargs):
        shapes.add(tuple(q.shape))
        return window_attention(q, *args, **kwargs)

    attention.window_attention = spy
    for label, _ in PAR_RECIPES:
        cfg = train_recipe_cfg(label)
        model = init_matchnerf(cfg, torch.Generator().manual_seed(seed)).to(dev)
        coach = Coach(cfg, model, dev)
        coach.setup_optimizer(1000)
        rec = {"mode": coach.parallel_mode, "losses": [], "launches": [], "plain": [], "s": []}
        for i in range(PAR_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, launches, plain = counted(counters, lambda: coach.train_iteration(batch))
            torch.cuda.synchronize()
            rec["s"].append(time.perf_counter() - t0)
            rec["losses"].append(float(loss["all"]))
            rec["launches"].append(launches)
            rec["plain"].append(plain)
            if i == 0 and rank == 0:
                torch.save({"loss": rec["losses"][0],
                            "grads": {n: p.grad.detach().cpu()
                                      for n, p in model.named_parameters()},
                            "params": {n: p.detach().cpu()
                                       for n, p in model.named_parameters()}},
                           os.path.join(out_dir, f"{label}_first_step.pt"))
        rec["route"] = coach.last_route
        rec["attention_shapes"] = sorted(shapes)
        shapes.clear()
        rec["param_sum"] = float(sum(p.detach().double().sum() for p in model.parameters()))
        out["train"][label] = rec
        del coach, model
        torch.cuda.empty_cache()
    for streams in (False, True):
        cfg = dtu_eval_config()
        cfg.parallel.shard_encoder_streams_eval = streams
        model = init_matchnerf(cfg, torch.Generator().manual_seed(seed)).to(dev).eval()
        renderer = Renderer(cfg, model, dev)
        renderer.set_ray_sharding(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ret, launches, plain = counted(counters, lambda: renderer.forward(batch, mode="test"))
        torch.cuda.synchronize()
        out["eval"]["sharded" if streams else "whole"] = {
            "s": time.perf_counter() - t0, "launches": launches, "plain": plain,
            "route": renderer.last_route, "shard_streams": renderer.shard_streams(),
            "attention_shapes": sorted(shapes),
            "rgb": ret["rgb"].cpu(), "depth": ret["depth"].cpu()}
        shapes.clear()
        del renderer, model
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.shutdown()


def step_agreement(torch, start, one, ranks, lrs):
    """The ranks' first step against the one-process step: per tensor the
    relative error of the update; and the parameters, on every entry where
    both gradients have one sign and |g| > 1e-4 (there AdamW's first update
    is lr * sign(g) - lr * wd * p to 1e-4 of lr), within 1e-3 lr + 1e-6 |p|.
    Returns (update errors, entries held, entries past the bound, share of
    entries whose gradient sign differs)."""
    errs, held, bad, flips, total = {}, 0, 0, 0, 0
    for n, p0 in start.items():
        pa, pb = ranks["params"][n].double(), one["params"][n].double()
        ga, gb = ranks["grads"][n], one["grads"][n]
        da, db = pa - p0.double(), pb - p0.double()
        errs[n] = float((da - db).norm()) / max(float(db.norm()), 1e-30)
        same = (torch.sign(ga) == torch.sign(gb)) & (ga.abs() > 1e-4) & (gb.abs() > 1e-4)
        lim = 1e-3 * lrs[n] + 1e-6 * pb.abs()
        held += int(same.sum())
        bad += int(((pa - pb).abs() > lim)[same].sum())
        flips += int((torch.sign(ga) != torch.sign(gb)).sum())
        total += ga.numel()
    return errs, held, bad, flips / total


def parallel_entry(torch, tree, counters):
    """Phase 16 (d): `python -m matchnerf_tpu_torch.train --config train` as
    two processes on the card (MATCHNERF_* set), on the loop phase's DTU
    tree: 4 steps, one validation, the epoch checkpoint; rank 1 gets an
    output_root of its own, which must stay empty."""
    runs = os.path.join(tree["work"], "parallel_runs")
    port = free_port()
    procs, logs = [], []
    t0 = time.perf_counter()
    for rank in range(2):
        args = loop_args("train", "parallel_entry", os.path.join(runs, f"root{rank}"),
                         tree["root"], tree["meta"], LOOP_STEPS,
                         **{"freq.val_it": 1.0, "freq.ckpt_it": -1, "freq.test_ep": -1})
        env = dict(os.environ, MATCHNERF_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   MATCHNERF_NUM_PROCESSES="2", MATCHNERF_PROCESS_ID=str(rank))
        path = os.path.join(runs, f"rank{rank}.log")
        os.makedirs(runs, exist_ok=True)
        logs.append(open(path, "w"))
        procs.append(subprocess.Popen([sys.executable, "-m", "matchnerf_tpu_torch.train",
                                       *args], cwd=REPO, env=env, stdout=logs[-1],
                                      stderr=subprocess.STDOUT))
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.perf_counter() - t0 > 400:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    texts = []
    for rank in range(2):
        with open(os.path.join(runs, f"rank{rank}.log")) as f:
            texts.append(f.read())
    codes = [p.returncode for p in procs]
    if codes != [0, 0]:
        raise AssertionError(f"parallel (d): exit codes {codes}\n" +
                             "\n".join(t[-3000:] for t in texts))
    names = [sorted(os.listdir(os.path.join(runs, f"root{r}"))) for r in range(2)]
    if len(names[0]) != 1 or names[0] != names[1]:
        raise AssertionError(f"parallel (d): run directories {names}")
    run0, run1 = (os.path.join(runs, f"root{r}", names[0][0]) for r in range(2))
    with open(os.path.join(run0, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss_render"] for r in recs if r["split"] == "train"]
    vals = [r for r in recs if r["split"] == "val"]
    ckpts = sorted(os.listdir(os.path.join(run0, "models")))
    rank1_files = sorted(os.listdir(run1))
    epoch_lines = [re.findall(r"\[train\] epoch 1/1.*?loss:(\S+?),", t) for t in texts]
    backends = [re.findall(r"backend (\w+) \(", t) for t in texts]
    log(f"parallel (d): the training entry as 2 processes on the card: exit codes {codes} in "
        f"{wall:.1f} s; rank 0 wrote {sorted(os.listdir(run0))}, checkpoints {ckpts}, train "
        f"losses {[round(x, 6) for x in losses]}, {len(vals)} validation; rank 1 wrote "
        f"{rank1_files}; backends {backends}; last loss logged by each rank {epoch_lines}")
    if not (len(losses) == LOOP_STEPS and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"parallel (d): train losses {losses}")
    if len(vals) != 1 or ckpts != ["ep1_it%d.ckpt" % LOOP_STEPS, "latest.ckpt"]:
        raise AssertionError(f"parallel (d): validations {vals}, checkpoints {ckpts}")
    if not os.path.isfile(os.path.join(run0, "options.json")) or rank1_files:
        raise AssertionError(f"parallel (d): rank 1 wrote {rank1_files}")
    if backends != [["gloo"], ["gloo"]]:
        raise AssertionError(f"parallel (d): backends {backends}")
    # the scalars hold the global loss: each rank logs the same last loss
    # (`loss_train`, 3 digits), which is rank 0's last scalar
    if not (epoch_lines[0] and epoch_lines[0] == epoch_lines[1]
            and epoch_lines[0][0] == f"{losses[-1]:.3e}"):
        raise AssertionError(f"parallel (d): last losses {epoch_lines} vs scalars {losses}")
    return {"wall_s": wall, "losses": losses, "checkpoints": ckpts,
            "validations": len(vals), "rank1_files": rank1_files}


def parallel_phase(torch, dev, batch, seed, block_rgb, tree, counters):
    """Phase 16: the parallel layer on the one card: (a) an NCCL world of
    one, (b) and (c) two ranks sharing the card (gloo by the backend rule)
    training and rendering, (d) the training entry as two processes."""
    import torch.multiprocessing as mp

    from matchnerf_tpu_torch.engine import Coach
    from matchnerf_tpu_torch.models.matchnerf import init_matchnerf
    t_phase = time.perf_counter()
    card = card_line()
    out = {"nccl_world_1": nccl_world_of_one(torch, dev, batch, seed, counters)}
    torch.cuda.empty_cache()

    # (b) and (c): two spawned ranks on this card
    work = os.path.join(REPO, "build", "chip_smoke_parallel")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    mp.start_processes(parallel_rank, args=(free_port(), seed, work), nprocs=2, join=True,
                       start_method="spawn")
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    if [r["backend"] for r in ranks] != ["gloo", "gloo"]:
        raise AssertionError(f"parallel (b): backends {[r['backend'] for r in ranks]} for "
                             "two ranks on one card, expected gloo")
    none = {k: 0 for k in counters}
    musts = {"train": dict(none, window_attention=12, window_attention_bwd=12, cosine_prior=2,
                           cosine_prior_bwd=2),
             "train_fast": dict(none, window_attention=12, window_attention_bwd=12,
                                block_cosine_prior_f32=2, block_cosine_prior_bwd=2)}
    launches = {}
    out["train"] = {}
    for label, _ in PAR_RECIPES:
        recs = [r["train"][label] for r in ranks]
        cfg = train_recipe_cfg(label)
        model = init_matchnerf(cfg, torch.Generator().manual_seed(seed)).to(dev)
        start = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        coach = Coach(cfg, model, dev)
        coach.setup_optimizer(1000)
        loss = float(coach.train_iteration(batch)["all"])
        one = {"loss": loss, "grads": {n: p.grad.detach().cpu() for n, p in
                                       model.named_parameters()},
               "params": {n: p.detach().cpu() for n, p in model.named_parameters()}}
        lrs = {n: coach.opt.schedules["enc" if n.startswith("feat_enc") else "dec"](0)
               for n in start}
        first = torch.load(os.path.join(work, f"{label}_first_step.pt"), weights_only=False)
        tol = (1e-2, 0.5, 0.1)                 # first_step_check's, the recipes' bf16 policy
        loss_rel = abs(first["loss"] - loss) / abs(loss)
        gerr = {n: float((first["grads"][n].double() - one["grads"][n].double()).norm())
                for n in start}
        floor = 1e-3 * max(float(g.double().norm()) for g in one["grads"].values())
        gerr = {n: e / max(float(one["grads"][n].double().norm()), floor)
                for n, e in gerr.items()}
        worst = max(gerr, key=gerr.get)
        med = float(np.median(list(gerr.values())))
        uerr, held, bad, flips = step_agreement(torch, start, one, first, lrs)
        uworst = max(uerr, key=uerr.get)
        log(f"parallel (b) {label}.yaml: 2 ranks, mode {recs[0]['mode']}, route "
            f"{recs[0]['route']}; losses rank 0 {[round(x, 6) for x in recs[0]['losses']]}, "
            f"rank 1 {[round(x, 6) for x in recs[1]['losses']]}; seconds per step rank 0 "
            f"{[round(x, 3) for x in recs[0]['s']]}, rank 1 {[round(x, 3) for x in recs[1]['s']]}"
            f" ({card}; two ranks sharing one card say nothing about scaling); Kernel A / A' "
            f"shapes rank 0 {recs[0]['attention_shapes']}, rank 1 {recs[1]['attention_shapes']}")
        log(f"parallel (b) {label}.yaml: first step vs one process: loss {first['loss']:.7f} vs "
            f"{loss:.7f} (rel {loss_rel:.3e}, tol {tol[0]}); averaged gradient error per tensor "
            f"worst {gerr[worst]:.3e} ({worst}), median {med:.3e} (tol {tol[1]} / {tol[2]}); "
            f"parameters: {held} entries where AdamW's update is lr*sign(g) in both, {bad} past "
            f"1e-3 lr + 1e-6 |p|; gradient sign differs on {100 * flips:.4f} % of entries; "
            f"update error per tensor worst {uerr[uworst]:.3e} ({uworst}), median "
            f"{float(np.median(list(uerr.values()))):.3e}")
        if recs[0]["mode"] != "rays" or recs[1]["mode"] != "rays":
            raise AssertionError(f"parallel (b) {label}: modes {[r['mode'] for r in recs]}")
        if recs[0]["losses"] != recs[1]["losses"] or recs[0]["param_sum"] != recs[1]["param_sum"]:
            raise AssertionError(f"parallel (b) {label}: the ranks disagree: losses "
                                 f"{[r['losses'] for r in recs]}, parameter sums "
                                 f"{[r['param_sum'] for r in recs]}")
        if not all(math.isfinite(x) for x in recs[0]["losses"]):
            raise AssertionError(f"parallel (b) {label}: losses {recs[0]['losses']}")
        if not (loss_rel <= tol[0] and gerr[worst] <= tol[1] and med <= tol[2] and bad == 0
                and held > 0):
            raise AssertionError(f"parallel (b) {label}: the first step disagrees with the "
                                 "one-process step")
        for rank, r in enumerate(recs):
            for i, (l, pc) in enumerate(zip(r["launches"], r["plain"])):
                for k, want in musts[label].items():
                    if l[k] != want:
                        raise AssertionError(f"parallel (b) {label} rank {rank} step {i}: {k} "
                                             f"launched {l[k]} times, expected {want}")
                if any(pc.values()):
                    raise AssertionError(f"parallel (b) {label} rank {rank}: plain versions "
                                         f"ran on CUDA: {pc}")
        launches[f"{label}_{PAR_STEPS}_steps"] = [
            {k: sum(l[k] for l in r["launches"]) for k in counters} for r in recs]
        out["train"][label] = {
            "losses": recs[0]["losses"], "step_s": [r["s"] for r in recs],
            "route": recs[0]["route"],
            "attention_shapes": [r["attention_shapes"] for r in recs], "first_step": {
                "loss_rel": loss_rel, "grad_err_worst": gerr[worst],
                "grad_err_worst_tensor": worst, "grad_err_median": med, "tol": list(tol),
                "params_held": held, "params_past_bound": bad, "grad_sign_flips": flips,
                "update_err_worst": uerr[uworst], "update_err_worst_tensor": uworst,
                "update_err_median": float(np.median(list(uerr.values()))),
                "one_process_loss": loss}}
        del coach, model
        torch.cuda.empty_cache()

    # (c) the ray-sharded eval render against phase 4's
    ev = [r["eval"] for r in ranks]
    out["eval"] = {}
    for key, must_equal in (("whole", True), ("sharded", False)):
        a, b = ev[0][key], ev[1][key]
        same = torch.equal(a["rgb"], b["rgb"]) and torch.equal(a["depth"], b["depth"])
        vs4 = psnr(a["rgb"], block_rgb)
        equal4 = torch.equal(a["rgb"], block_rgb)
        log(f"parallel (c) eval, encoder streams {key} (shard_streams {a['shard_streams']}): "
            f"2 ranks render phase 2's target in {a['s']:.3f} / {b['s']:.3f} s, route "
            f"{a['route']}; ranks bit-equal {same}; vs phase 4's one-process render: bit-equal "
            f"{equal4}, {vs4:.2f} dB; Kernel A shapes {a['attention_shapes']} / "
            f"{b['attention_shapes']}; launches rank 0 {a['launches']}, rank 1 {b['launches']}"
            f" ({card})")
        if not same:
            raise AssertionError(f"parallel (c) {key}: the ranks' images differ")
        if a["shard_streams"] != (key == "sharded"):
            raise AssertionError(f"parallel (c) {key}: shard_streams {a['shard_streams']}")
        if must_equal and not equal4:
            raise AssertionError("parallel (c): with the eval encoder whole the image must be "
                                 "bit-equal to phase 4's")
        if not vs4 >= 60.0:
            raise AssertionError(f"parallel (c) {key}: {vs4:.2f} dB against phase 4 < 60")
        if None in a["route"]["block_ut"] or a["route"]["color_ut"] is None:
            raise AssertionError(f"parallel (c) {key}: route {a['route']}")
        for rank, e in enumerate((a, b)):
            for k in ("window_attention", "cond_nerf_decode", "block_cosine_prior",
                      "supercell_color"):
                if e["launches"][k] <= 0:
                    raise AssertionError(f"parallel (c) {key} rank {rank}: {k} not launched")
            if any(e["plain"].values()):
                raise AssertionError(f"parallel (c) {key} rank {rank}: plain on CUDA")
        launches[f"eval_streams_{key}"] = [a["launches"], b["launches"]]
        out["eval"][key] = {"s": [a["s"], b["s"]], "psnr_vs_phase4_db": vs4,
                            "bit_equal_phase4": equal4, "route": a["route"],
                            "attention_shapes": [a["attention_shapes"], b["attention_shapes"]]}
    out["ranks_s"] = ranks_s

    # (d) the training entry as two processes
    out["entry"] = parallel_entry(torch, tree, counters)
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"parallel phase: {out['phase_s']:.1f} s ({card})")
    return out


VIEW_COUNTS = (2, 4)               # n_src_views of the views phase on phase 12's tree
MANY_VIEWS = (5, 6, 8)             # and past V = 4: the kernels against their plain twins
MANY_EVAL = (8,)                   # the eval entry's image on the many-view tree (V = 5's
                                   # was dropped for time when V = 10 and 16 came in)
MANY_TRAIN = 8                     # the training entry's steps on the many-view tree
MANY_TREE_VIEWS = 11               # its views: V = 8 sources, 2 added candidates, the target
MID_TRAIN = (4, 6)                 # the training entry's steps on the narrow tree
MID_TREE_VIEWS = 9                 # its views: V = 6 sources, 2 added candidates, the target
MID_TREE_SPREAD = 0.5              # its arc's angles over the default's: 4 degrees apart
WIDE_VIEWS = (10, 12, 16)          # past V = 8 (the run-time-V forms): the kernels vs their twins
WIDE_EVAL = (10, 16)               # the eval entry's image on the wide tree
WIDE_FUSED = 10                    # the fused image on the wide tree
WIDE_TRAIN = 10                    # the training entry's steps on the wide tree
WIDE_TREE_VIEWS = 17               # its views: V = 16 sources and the target
WIDE_TRAIN_TREE_VIEWS = 13         # the 640x512 training tree's: V = 10, 2 added, the target
WIDE_TREE_SPREAD = 0.5             # both arcs' angles over the default's: 4 degrees apart
# the wide images' size, their tree's: a quarter of the DTU view's rays, so
# that the all-plain references (54 s at V = 10 and 141 s at V = 16 at
# 640x512, the plain B and D over V(V-1) chunk rows) keep the script in
# its time (the DTU loader's depth mask is its tree's size)
WIDE_EVAL_WH = (320, 256)
S256_RAYS = 512                    # the V = 16 kernel part's S = 256 slice (views_rays(16) / 2)
VIEWS_STEPS = 3                    # training steps per recipe and V
EVAL_MUST = ("window_attention", "cond_nerf_decode", "block_cosine_prior", "supercell_color")


def views_rays(V):
    """Rays of the views phase's eval-slice checks at V views: the slice
    (SLICE_RAYS) to V = 4, then fewer, so that the plain twins' f32 samples
    (R x S x V(V-1) x 128 floats) stay at their V = 4 size: 12288 at V = 5,
    8192 at V = 6, 4384 at V = 8, 2728 at V = 10, 1856 at V = 12, 1024 at
    V = 16. The kernel runs the same slices on the entry's path; these are
    the compared ones."""
    return min(SLICE_RAYS, 8 * (SLICE_RAYS * 12 // (V * (V - 1)) // 8))


def views_train_rays(V):
    """Rays of the views phase's B' and D' checks at V views: TRAIN_RAYS to
    V = 10, then fewer, so that the plain twins' f32 samples and their
    gradients stay at their V = 10 size: 696 at V = 12, 384 at V = 16."""
    return min(TRAIN_RAYS, 8 * (TRAIN_RAYS * 90 // (V * (V - 1)) // 8))


def plain_slice_rays(V):
    """Rays a slice of the all-plain reference render at V views (the
    renderer's max_rays_per_slice): 8192 to V = 8, then fewer, so that the
    plain B's f32 samples of a slice stay at their V = 8 size: 5096 at V =
    10, 1904 at V = 16 (multiples of 8: the same 8-ray blocks)."""
    return min(8192, 8 * (8192 * 56 // (V * (V - 1)) // 8))


def timed_once(torch, fn):
    """(fn(), its CUDA-event milliseconds): one call, timed; for a plain
    twin whose single call is long enough to time and which the caller
    needs the output of anyway."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def prior_case(torch, name, fn, plain, tol, nbytes_, flops, extra=None):
    """One prior kernel call against its plain twin on the same inputs: max
    |d| (fails above tol), CUDA-event ms of both (the kernel's a mean of 10
    warm calls, the plain twin's its one call after the kernel's first: the
    twin runs 10-300 ms), the bound."""
    got = fn()
    ref, plain_ms = timed_once(torch, plain)
    err = max_abs(got, ref)
    b_ms, b_by = bound(nbytes_(got), flops)
    entry = dict(max_abs_err=err, tol=tol, ms=cuda_ms(torch, fn, 10),
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 library_ms=None, **(extra or {}))
    log(f"views {name}: max|d| {err:.3e} (tol {tol:.3e}), {entry['ms']:.4f} ms vs plain "
        f"{entry['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})"
        + "".join(f", {k} {v}" for k, v in (extra or {}).items()))
    check_close(f"views {name}", err, tol)
    del got, ref
    return entry


def views_kernels(torch, dev, seed, V, card, batch=None):
    """The views phase's kernel checks at V source views, from one encode of
    a V-source scene: Kernels B (int8, bf16, f32) and D (int8, bf16) on its
    eval tables at the pose's buckets, S = 128 (D in the layout the route
    takes: the pair layout where every view's taps do not fit; where the
    pose's union is past 512 cells, at bucket 512, an overflowed union), at
    V = 16 also D and B at S = 256 on one slice of scale 1 (`S256_RAYS`),
    E on its supercell table, F (past V = 4; phase 19 holds V = 2 and 4) on
    one fused-route chunk, B' and D' forward and backward on f32 tables of
    the same features at `views_train_rays(V)` training rays, each against
    its plain twin. `batch`: the scene, `make_scene(seed, V)` (raytraced
    here where not given)."""
    from matchnerf_tpu_torch import camera
    from matchnerf_tpu_torch.config import dtu_eval_config, dtu_train_config
    from matchnerf_tpu_torch.models.matchnerf import (fused_chunk_rays, init_matchnerf,
                                                      prepare_sampling_tables,
                                                      project_to_views, sample_depth)
    from matchnerf_tpu_torch.ops import block_cosine_prior as kd
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    from matchnerf_tpu_torch.ops import supercell_color as ke
    from matchnerf_tpu_torch.renderer import Renderer, extract_poses
    from matchnerf_tpu_torch.train_step import sample_ray_indices
    grad = torch.autograd.grad
    cfg = dtu_eval_config()
    cfg.n_src_views = V
    model = init_matchnerf(cfg, torch.Generator().manual_seed(seed)).to(dev).eval()
    renderer = Renderer(cfg, model, dev)
    batch = batch if batch is not None else make_scene(seed, V)
    poses = extract_poses(batch)
    ref_images = renderer.tensor(batch["images"][:, :V])
    out = {"V": V, "card": card}
    with torch.no_grad():
        feats = renderer.encode(ref_images)
        tables = renderer.build_tables(ref_images, feats)
        bf16 = prepare_sampling_tables(cfg, feats, ref_images, feat_dtype=torch.bfloat16)
    scale_hws = [(t.shape[2], t.shape[3]) for t in tables["view_feats"]]
    block_ut, color_ut = renderer.pose_prep(poses, scale_hws, H, W, measure_color=True)
    log(f"views V={V}: pose_prep block_ut {block_ut}, color_ut {color_ut}")
    if V <= 8 and (block_ut is None or None in block_ut):
        raise AssertionError(f"views V={V}: the pose does not take Kernel D at both scales: "
                             f"{block_ut}")
    block_ut = block_ut or (None, None)
    tgt_intr, c2w, tgt_nf, ref_w2c, ref_intr, ref_nf = renderer._pose_tensors(poses)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)

    def grids_of(pix, depth):
        center, ray = camera.get_center_and_ray(pix, tgt_intr, c2w)
        pts = camera.get_3d_points_from_depth(center, ray, depth, multi_samples=True)
        return (project_to_views(pts, ref_w2c, ref_intr, ref_nf, H, W)[..., :2]
                * 2.0 - 1.0)[:, 0].contiguous()                     # [V,R,S,2]

    R_eval = views_rays(V)
    pix = camera.pixel_grid(H, W, legacy=True, device=dev)[:R_eval][None]
    grids = grids_of(pix, sample_depth(cfg, tgt_nf, 1, R_eval))
    S = grids.shape[2]
    for key in ("B", "D", "B_bf16", "D_bf16", "B_f32", "B_bwd", "D_f32", "D_bwd", "B_s256",
                "D_s256"):
        out[key] = []
    with torch.no_grad():
        for s, G in enumerate(cfg.encoder.cos_n_group):
            ut = block_ut[s]
            for dt, tabs, R in (("int8", tables, R_eval),
                                ("bf16", bf16, min(VAL_RAYS, R_eval))):
                table = tabs["view_feats"][s][0]
                scales = tabs["view_feat_scales"][s][0] if dt == "int8" else None
                g = grids[:, :R].contiguous()
                flops = prior_flops(R * S, scaled=dt == "int8", n_views=V)
                nb = lambda o: nbytes(table, g, o) + (0 if scales is None else nbytes(scales))
                sfx = "" if dt == "int8" else "_bf16"
                tag = f"V={V} scale {s} table {list(table.shape)} {dt} G={G} R={R} S={S}"
                out["B" + sfx].append(dict(scale=s, R=R, **prior_case(
                    torch, f"B {tag}", lambda: kb.cosine_prior(table, g, scales, G),
                    lambda: kb.cosine_prior_plain(table, g, scales, G), 1e-4, nb, flops)))
                hw = table.shape[1] * table.shape[2]
                ud = ut if ut is not None else max(kd.UT_BUCKETS)
                how = kd.plan(ud, S, G, False, 2, hw, V)
                out["D" + sfx].append(dict(scale=s, R=R, **prior_case(
                    torch, f"D {tag}" + ("" if ut is not None else
                                         " (the pose's union past 512: the route takes B)"),
                    lambda: kd.block_cosine_prior(table, g, scales, G, ud),
                    lambda: kd.block_cosine_prior_plain(table, g, scales, G, ud), 1e-4, nb,
                    flops, {"ut": ud, "channels_per_pass": how.cp,
                            "layout": "pair" if how.pair else "views", "S": S,
                            "on_path": ut is not None, "pose_ut": ut})))
                del table, g
        if V == max(WIDE_VIEWS):
            # D and B at S = 256 (configs/test_video_own.yaml's samples) on
            # one slice of scale 1's int8 table, at that slice's own bucket
            c256 = copy.deepcopy(cfg)
            c256.nerf.sample_intvs = 256
            g256 = grids_of(pix[:, :S256_RAYS], sample_depth(c256, tgt_nf, 1, S256_RAYS))
            table = tables["view_feats"][1][0]
            scales = tables["view_feat_scales"][1][0]
            G = cfg.encoder.cos_n_group[1]
            h, w = table.shape[1:3]
            u256 = kd.bucket_ut(kd.block_union_size_raw(kd.pad_rays(g256), h, w)) or 512
            how = kd.plan(u256, 256, G, False, 2, h * w, V)
            tag = f"V={V} scale 1 table {list(table.shape)} int8 G={G} R={S256_RAYS} S=256"
            flops = prior_flops(S256_RAYS * 256, scaled=True, n_views=V)
            nb = lambda o: nbytes(table, g256, o) + nbytes(scales)
            out["B_s256"].append(dict(scale=1, R=S256_RAYS, **prior_case(
                torch, f"B {tag}", lambda: kb.cosine_prior(table, g256, scales, G),
                lambda: kb.cosine_prior_plain(table, g256, scales, G), 1e-4, nb, flops)))
            out["D_s256"].append(dict(scale=1, R=S256_RAYS, **prior_case(
                torch, f"D {tag}", lambda: kd.block_cosine_prior(table, g256, scales, G, u256),
                lambda: kd.block_cosine_prior_plain(table, g256, scales, G, u256), 1e-4, nb,
                flops, {"ut": u256, "channels_per_pass": how.cp,
                        "layout": "pair" if how.pair else "views", "S": 256})))
            del table, g256
        # Kernel E on the slice, bit-equal to its plain twin on the 0-255
        # scale; 9 flops per (sample, view, colour)
        csc = tables["colors_sc"][0]
        out["E"] = [dict(R=R_eval, **prior_case(
            torch, f"E V={V} table {list(csc.shape)} uint8 R={R_eval} S={S}",
            lambda: ke.supercell_color_sample(csc, grids, H, W),
            lambda: ke.supercell_color_sample_plain(csc, grids, H, W), 1e-5,
            lambda o: nbytes(csc, grids, o), R_eval * S * V * 3 * 9, {"color_ut": color_ut}))]
    if V > 4:
        out["F"] = fused_cases(torch, cfg, feats, ref_images,
                               grids[:, :fused_chunk_rays(V)].contiguous(), V, card, "views")
    del tables, bf16, model, renderer

    # B' and D' on f32 tables of the same features at 1024 training rays
    tcfg = dtu_train_config()
    tcfg.n_src_views = V
    with torch.no_grad():
        ttables = prepare_sampling_tables(tcfg, feats, ref_images, feat_dtype=torch.float32)
    del feats

    R_train = views_train_rays(V)

    def train_grids(patches):
        idx = sample_ray_indices(H * W, R_train, patches, dev, gen)
        tpix = torch.stack([(idx % W).float(), (idx // W).float()], -1)[None]
        return grids_of(tpix, sample_depth(tcfg, tgt_nf, 1, R_train, stratified=True,
                                           generator=gen))

    grids_ray, grids_strip = train_grids(False), train_grids(True)
    N = R_train * S
    for s, G in enumerate(tcfg.encoder.cos_n_group):
        table = ttables["view_feats"][s][0]
        h, w = table.shape[1:3]
        gcot = torch.randn(R_train, S, G, generator=gen, device=dev)
        tag = f"V={V} scale {s} table {list(table.shape)} f32 G={G} R={R_train} S={S}"
        with torch.no_grad():
            out["B_f32"].append(dict(scale=s, **prior_case(
                torch, f"B {tag}", lambda: kb.cosine_prior(table, grids_ray, None, G),
                lambda: kb.cosine_prior_plain(table, grids_ray, None, G), 1e-5,
                lambda o: nbytes(table, grids_ray, o), prior_flops(N, False, V))))
        # D': the strips' own bucket where D' takes it, else the widest bucket
        # it takes (an overflowed union: the kernel against its plain twin at
        # that bucket; the training route sends such a scale to B')
        union = kd.block_union_size_raw(kd.pad_rays(grids_strip), h, w)
        ut = kd.bucket_ut(union)
        route = "D'" if ut is not None and kd.takes_f32(ut, S, G, h * w, V) else "B'"
        if route == "B'":
            ut = max(u for u in kd.UT_BUCKETS if kd.takes_f32(u, S, G, h * w, V))
        gs = grids_strip
        layouts = {k: ("pair" if how.pair else "views") for k, how in (
            ("forward", kd.plan(ut, S, G, False, 4, h * w, V)),
            ("backward", kd.plan(ut, S, G, True, n_views=V)))}
        with torch.no_grad():
            out["D_f32"].append(dict(scale=s, **prior_case(
                torch, f"D' forward {tag} (strips)",
                lambda: kd.block_cosine_prior(table, gs, None, G, ut),
                lambda: kd.block_cosine_prior_plain(table, gs, None, G, ut), 1e-5,
                lambda o: nbytes(table, gs, o), prior_flops(N, False, V),
                {"ut": ut, "train_union_size": union, "training_route": route,
                 "S": S, "layout": layouts["forward"]})))
        for key, fn_k, fn_p, g_ in (
                ("B_bwd", lambda t, g_: kb.cosine_prior(t, g_, None, G),
                 lambda t, g_: kb.cosine_prior_plain(t, g_, None, G), grids_ray),
                ("D_bwd", lambda t, g_: kd.block_cosine_prior(t, g_, None, G, ut),
                 lambda t, g_: kd.block_cosine_prior_plain(t, g_, None, G, ut), gs)):
            tk, tp = table.clone().requires_grad_(), table.clone().requires_grad_()
            ok, op = fn_k(tk, g_), fn_p(tp, g_)
            gc = gcot[:, :g_.shape[2]].contiguous()
            bwd_k = lambda: grad(ok, tk, gc, retain_graph=True)[0]
            bwd_p = lambda: grad(op, tp, gc, retain_graph=True)[0]
            tol = 1e-5 * float(bwd_p().abs().max())
            name = "B'" if key == "B_bwd" else "D'"
            out[key].append(dict(scale=s, **prior_case(
                torch, f"{name} backward {tag}" + (
                    f" (S={g_.shape[2]})" if g_.shape[2] != S else ""), bwd_k, bwd_p, tol,
                lambda o: 2 * nbytes(table) + nbytes(g_, gc),
                prior_bwd_flops(R_train * g_.shape[2], V),
                {"ut": ut, "S": g_.shape[2], "layout": layouts["backward"]}
                if key == "D_bwd" else None)))
            del tk, tp, ok, op
        del table
    del ttables, ref_images
    torch.cuda.empty_cache()
    return out


def views_train(torch, dev, seed, tree, counters, ckpt, card, V, load=None):
    """The views phase's training at V source views: `python -m
    matchnerf_tpu_torch.train --config train|train_fast --n_src_views=V`
    (`build_coach` + `train_model`) on the DTU tree `tree` from the written
    GMFlow checkpoint, VIEWS_STEPS steps each, no validation; the first step
    against the all-plain step; B' (train.yaml) twice a step, B' or D' at
    each scale as the route takes it (train_fast.yaml; D' at both at V = 2)
    by the counters, step by step, and which scales went to each; the peak
    device memory of the steps; a checkpoint written -> (results, the
    train.yaml run's latest.ckpt). With `load`, every weight from that
    file (`--load`; the GMFlow checkpoint is then not read)."""
    from matchnerf_tpu_torch import kernels
    from matchnerf_tpu_torch.train import build_coach
    runs = os.path.join(tree["work"], "views_runs")
    out, latest = {}, None
    for label in ("train", "train_fast"):
        argv = loop_args(label, f"views_{label}_v{V}", runs, tree["root"], tree["meta"],
                         VIEWS_STEPS, **{"n_src_views": V, "encoder.pretrain_weight": ckpt,
                                         "freq.val_it": -1, "freq.test_ep": -1,
                                         **({"load": load} if load else {})})
        coach = build_coach(argv)
        steps = kernels.record_steps(coach)
        first = first_step_check(torch, dev, coach.cfg, next(iter(coach.train_loader)), seed,
                                 f"views {label}.yaml V={V} bf16 policy", (1e-2, 0.5, 0.1),
                                 model_fn=load and (lambda c: loaded_model(torch, c, load)),
                                 plain_remat=V > 8)
        torch.cuda.empty_cache()
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        coach.train_model()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = {k: c.launches for k, c in counters.items()}
        plain_cuda = {k: c.plain_on_cuda for k, c in counters.items()}
        with open(coach.scalars_path) as f:
            losses = [json.loads(line)["loss_render"] for line in f
                      if json.loads(line)["split"] == "train"]
        mdir = os.path.join(coach.output_path, "models")
        ckpts = sorted(os.listdir(mdir))
        b_, d_ = launches["cosine_prior_bwd"], launches["block_cosine_prior_bwd"]
        scales = [route_scales(st["route"]) if label == "train_fast" else ["B'", "B'"]
                  for st in steps]
        log(f"views {label}.yaml V={V}: {VIEWS_STEPS} steps in {wall:.3f} s "
            f"({VIEWS_STEPS / wall:.3f} steps/s), peak {peak_gib:.2f} GiB, route "
            f"{coach.last_route} (None: B'), the scales' backward kernels by step "
            f"{scales}, B' {b_} and D' {d_} launches, losses "
            f"{[round(x, 6) for x in losses]}, checkpoints {ckpts}, launches {launches}, "
            f"plain versions on CUDA {plain_cuda}; {card}")
        if len(losses) != VIEWS_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"views {label} V={V}: losses {losses}")
        if "latest.ckpt" not in ckpts:
            raise AssertionError(f"views {label} V={V}: checkpoints {ckpts}")
        if any(plain_cuda.values()):
            raise AssertionError(f"views {label} V={V}: plain versions ran on CUDA: {plain_cuda}")
        want = ((2 * VIEWS_STEPS, 0) if label == "train"
                else (0, 2 * VIEWS_STEPS) if V == 2 else None)
        if (b_ + d_ != 2 * VIEWS_STEPS or (want is not None and (b_, d_) != want)
                or launches["window_attention_bwd"] <= 0):
            raise AssertionError(f"views {label} V={V}: B' {b_} and D' {d_} launches")
        check_train_steps(f"views {label}.yaml V={V}", steps, label)
        out[label] = {"V": V, "steps": VIEWS_STEPS, "wall_s": wall, "losses": losses,
                      "route": coach.last_route, "scale_kernels": scales,
                      "launches": launches, "checkpoints": ckpts,
                      "first_step": first, "peak_gib": peak_gib}
        if label == "train":
            latest = os.path.join(mdir, "latest.ckpt")
        del coach
        torch.cuda.empty_cache()
    return out, latest


def views_eval(torch, dev, seed, tree, counters, V, load, card, extra=(), must=EVAL_MUST,
               zero=(), name=None, plain=None, profile=True):
    """The views phase's eval: `python -m matchnerf_tpu_torch.test --config
    test --n_src_views=V --load=...` (and `extra`) on the DTU tree `tree`
    (its test view): the kernels of `must` launch and those of `zero` do
    not, no plain version on CUDA, the image >= 50 dB against the all-plain
    render (`plain`: the all-plain rgb of another route's entry on the same
    tree, V and weights, else rendered here); the kernel each feature scale
    took, the render's seconds, rays/s and, with `profile`, each eval
    kernel's device ms per launch from one more render under torch.profiler
    (the fused route's thousands of gather operations make that ~40 s at
    V = 8). The entry holds the all-plain rgb under "plain_rgb"."""
    from matchnerf_tpu_torch.ops import block_cosine_prior as kd
    from matchnerf_tpu_torch.renderer import Renderer
    name = name or f"views_v{V}"
    argv = ["--config", "test", f"--name={name}", f"--load={load}",
            f"--output_root={os.path.join(tree['work'], 'views_runs')}", f"--seed={seed}",
            f"--n_src_views={V}", "--data_test.llff=", "--data_test.blender=",
            "--data_test.tnt=", *extra] + entry_set_args("dtu", tree["root"], tree["meta"])
    _, records = run_entry(torch, counters, argv)
    rec = records[0]
    decoder = shipped_decoder_kernel(V)
    check_entry_record("dtu", rec, must + (decoder,), f"views {name}", decoder)
    for k in zero:
        if rec["launches"][k]:
            raise AssertionError(f"views {name}: kernel {k} launched: {rec['launches']}")
    renderer = rec["renderer"]
    if renderer.cfg.n_src_views != V:
        raise AssertionError(f"views {name}: the entry rendered {renderer.cfg.n_src_views} "
                             "views")
    fused = bool(renderer.cfg.precision.get("fused_cosine", False))
    block_ut = (rec["route"] or {}).get("block_ut")
    # the route of query_cond_info: D where the pose's bucket fits D's shared
    # memory for the int8 tables of test.yaml (`takes_table`), else B
    S = int(renderer.cfg.nerf.sample_intvs)
    img_h, img_w = np.asarray(rec["batch"]["images"]).shape[2:4]
    hws = ((img_h // 8) * (img_w // 8), (img_h // 4) * (img_w // 4))
    scale_kernels = (["F"] * 2 if fused else
                     ["D" if ut is not None and kd.takes_bf16(ut, S, G, hw, V) else "B"
                      for ut, G, hw in zip(block_ut or (None, None),
                                           renderer.cfg.encoder.cos_n_group, hws)])
    if not fused:
        for k, label in (("block_cosine_prior", "D"), ("cosine_prior", "B")):
            if (rec["launches"][k] > 0) != (label in scale_kernels):
                raise AssertionError(f"views {name}: the scales' route {scale_kernels}, "
                                     f"launches {rec['launches']}")
    plain_t = {"render": None}
    if plain is None:
        pcfg = copy.deepcopy(renderer.cfg)
        pcfg.nerf.max_rays_per_slice = plain_slice_rays(V)
        plain = Renderer(pcfg, renderer.model, dev, kernel=False).forward(
            rec["batch"], mode="test", timings=plain_t)["rgb"]
    agreement = psnr(rec["out"]["rgb"], plain)
    kms = (kernel_device_ms(torch, lambda: renderer.forward(rec["batch"], mode="test"))
           if profile else {})
    t = rec["timings"]
    n_rays = img_h * img_w
    entry = {"V": V, "image_hw": [int(img_h), int(img_w)], "load": load or None,
             "extra": list(extra), "render_s": t["render"],
             "encode_s": t["encode"], "tables_s": t["tables"],
             "pose_prep_s": t.get("pose_prep", 0.0), "image_s": rec["seconds"],
             "rays_per_s_render": n_rays / t["render"], "plain_render_s": plain_t["render"],
             "psnr_vs_plain_db": agreement, "plain_rgb": plain, "route": rec["route"],
             "scale_kernels": scale_kernels, "launches": rec["launches"],
             "launches_by_route": rec["routes"],
             "kernel_device_ms": {k: {"ms": ms, "launches": n, "ms_per_launch": ms / n}
                                  for k, (ms, n) in kms.items()}}
    log(f"views eval {name} V={V} ({'weights ' + load if load else 'seeded weights'}"
        f"{', ' + ' '.join(extra) if extra else ''}): image {rec['seconds']:.4f} s, render "
        f"{t['render']:.4f} s (pose_prep {entry['pose_prep_s']:.4f}), "
        f"{entry['rays_per_s_render']:.0f} rays/s (render), route {rec['route']}, the "
        f"scales' prior kernels {scale_kernels}, launches {rec['launches']}; kernels vs "
        f"all-plain PSNR {agreement:.2f} dB (need >= 50; all-plain render "
        f"{plain_t['render'] or 0.0:.2f} s); device ms (launches) "
        + ", ".join(f"{k} {ms:.3f} ({n})" for k, (ms, n) in sorted(kms.items())) + f"; {card}")
    if not agreement >= 50.0:
        raise AssertionError(f"views {name}: agreement PSNR {agreement:.2f} dB < 50")
    del records, rec
    torch.cuda.empty_cache()
    return entry


def live_density(torch, model):
    """Make the seeded decoder's density head non-negative (in place): its
    last layer (`out_alpha_linear[-1]`, bias 0) takes the ReLU outputs of
    the ray attention's 16 channels, so with weights of one sign every
    density is >= 0 and none is held at 0 by the final ReLU. Seeded at
    V = 10, seed 0 leaves every density of phase 18's training rays at 0
    (the head's weights sum the ReLU outputs to -4.4 .. -0.1): no gradient
    flows, and the first step's check and the image compare zeros."""
    with torch.no_grad():
        model.nerf_dec.out_alpha_linear[-1].weight.abs_()
    return model


def write_live_checkpoint(torch, cfg, seed, path):
    """The seeded model of `cfg` (init_matchnerf, the entries' own seeding)
    with `live_density`, saved as a `.pth` with a "model" entry, the file
    `--load` reads -> path."""
    from matchnerf_tpu_torch.models.matchnerf import init_matchnerf
    model = live_density(torch, init_matchnerf(cfg, torch.Generator().manual_seed(seed)))
    torch.save({"model": model.state_dict()}, path)
    return path


def loaded_model(torch, cfg, path):
    """A model of `cfg` on the CPU with the weights of `path`."""
    from matchnerf_tpu_torch.models.matchnerf import init_matchnerf
    from matchnerf_tpu_torch.utils.checkpoint import load_model_weights
    model = init_matchnerf(cfg, torch.Generator().manual_seed(0))
    load_model_weights(model, path)
    return model


def shipped_decoder_kernel(V):
    """The shipped decoder's kernel at V views (ops/decoder.py::
    decoder_route): Kernel C while its conditioning width Gf + 4V (Gf = 10)
    is at most 64 (V <= 13), Kernel Cg from V = 14."""
    return "cond_nerf_decode" if 10 + 4 * V <= 64 else "cond_nerf_decode_any"


def views_phase(torch, dev, seed, tree, counters):
    """Phase 18: two to sixteen source views. The prior kernels (and E, and
    F past V = 4) at V = 2, 4, 5, 6, 8, 10, 12 and 16 against their plain
    twins; training
    at V = 2 through the training entry and the eval entry at V = 2 (the
    trained weights) and V = 4 (seeded weights) on phase 12's tree; then on
    an 11-view DTU tree the eval entry at V = 8 and the fused route at
    V = 8 (seeded weights; held to the V = 8 image's all-plain render: the
    same weights, view and function; F's device ms come from (a) at the
    route's chunk), and 3 steps of each recipe at V = 8; then 3 steps of
    each recipe at V = 4 and 6 on a 9-view tree at half the arc's angles;
    then `views_wide` on a 17-view (320x256) and a 13-view (640x512) tree
    at half the arc's angles (V = 10 and 16). The kernel parts' scenes and
    the four trees are raytraced by
    spawned processes while the card works. Each part's seconds under
    "part_s" (a tree's: the wait for it; a kernel part's: with the wait for
    its scene)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from matchnerf_tpu_torch.config import dtu_train_config
    from matchnerf_tpu_torch.data import synth
    t_phase = time.perf_counter()
    card = card_line()
    parts = {}
    many = {"work": tree["work"], "root": os.path.join(tree["work"], "views_dtu"),
            "meta": os.path.join(tree["work"], "views_dtu_meta")}
    mid = {"work": tree["work"], "root": os.path.join(tree["work"], "views_dtu_mid"),
           "meta": os.path.join(tree["work"], "views_dtu_mid_meta")}
    wide = {name: {"work": tree["work"], "root": os.path.join(tree["work"], f"views_{name}"),
                   "meta": os.path.join(tree["work"], f"views_{name}_meta")}
            for name in ("wide", "wide_train")}
    pool = ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn"))
    # the kernel parts' scenes first (raytraced on the host: ~1 s a view),
    # then the trees, all while the card works
    scenes = {V: pool.submit(make_scene, seed, V)
              for V in VIEW_COUNTS + MANY_VIEWS + WIDE_VIEWS}
    writes = {"many": pool.submit(synth.write_dtu_scene, many["root"], many["meta"],
                                  n_views=MANY_TREE_VIEWS),
              "mid": pool.submit(synth.write_dtu_scene, mid["root"], mid["meta"],
                                 n_views=MID_TREE_VIEWS, spread=MID_TREE_SPREAD),
              "wide": pool.submit(synth.write_dtu_scene, wide["wide"]["root"],
                                  wide["wide"]["meta"], *WIDE_EVAL_WH, n_views=WIDE_TREE_VIEWS,
                                  spread=WIDE_TREE_SPREAD),
              "wide_train": pool.submit(synth.write_dtu_scene, wide["wide_train"]["root"],
                                        wide["wide_train"]["meta"],
                                        n_views=WIDE_TRAIN_TREE_VIEWS, spread=WIDE_TREE_SPREAD)}

    def part(name, fn):
        t0 = time.perf_counter()
        res = fn()
        parts[name] = time.perf_counter() - t0
        log(f"views: {name} in {parts[name]:.1f} s")
        return res

    out = {"kernels": {V: part(f"kernels_v{V}", lambda: views_kernels(
        torch, dev, seed, V, card, scenes.pop(V).result()))
        for V in VIEW_COUNTS + MANY_VIEWS + WIDE_VIEWS}}
    ckpt = os.path.join(tree["work"], "views_gmflow.pth")
    cfg2 = dtu_train_config()
    cfg2.n_src_views = 2
    write_gmflow_checkpoint(torch, cfg2, seed, ckpt)
    out["train"], latest = part("train_v2", lambda: views_train(
        torch, dev, seed, tree, counters, ckpt, card, 2))
    out["eval"] = {V: part(f"eval_v{V}", lambda: views_eval(
        torch, dev, seed, tree, counters, V, load, card)) for V, load in ((2, latest), (4, ""))}
    part("many_tree", writes["many"].result)
    out["many_tree"] = {"views": list(synth.dtu_scene_view_ids(MANY_TREE_VIEWS)),
                        "wait_s": parts["many_tree"]}
    log(f"views: {MANY_TREE_VIEWS}-view DTU tree at {W}x{H}, views "
        f"{out['many_tree']['views']} (val/test 24)")
    for V in MANY_EVAL:
        out["eval"][V] = part(f"eval_v{V}", lambda: views_eval(
            torch, dev, seed, many, counters, V, "", card))
    out["eval_fused"] = {MANY_TRAIN: part(f"eval_fused_v{MANY_TRAIN}", lambda: views_eval(
        torch, dev, seed, many, counters, MANY_TRAIN, "", card,
        extra=("--precision.fused_cosine=true",),
        must=("window_attention", "cond_nerf_decode", "supercell_color", "fused_cosine"),
        zero=("cosine_prior", "block_cosine_prior"), name=f"views_fused_v{MANY_TRAIN}",
        plain=out["eval"][MANY_TRAIN]["plain_rgb"], profile=False))}
    for e in list(out["eval"].values()) + list(out["eval_fused"].values()):
        del e["plain_rgb"]
    out["train_many"], _ = part(f"train_v{MANY_TRAIN}", lambda: views_train(
        torch, dev, seed, many, counters, ckpt, card, MANY_TRAIN))
    part("mid_tree", writes["mid"].result)
    out["train_mid"] = {V: part(f"train_v{V}", lambda: views_train(
        torch, dev, seed, mid, counters, ckpt, card, V))[0] for V in MID_TRAIN}
    for V, runs in out["train_mid"].items():
        if runs["train_fast"]["launches"]["block_cosine_prior_bwd"] <= 0:
            raise AssertionError(f"views train_fast.yaml V={V} on the {MID_TREE_VIEWS}-view "
                                 f"tree at spread {MID_TREE_SPREAD}: no D' launch (routes "
                                 f"{runs['train_fast']['scale_kernels']})")
    views_wide(torch, dev, seed, wide, counters, ckpt, card, out, part,
               {k: writes[k].result for k in wide})
    pool.shutdown()
    out["part_s"] = parts
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"views phase: {out['phase_s']:.1f} s; {card}")
    return out


def views_wide(torch, dev, seed, trees, counters, ckpt, card, out, part, written):
    """Phase 18 past eight views, on two DTU trees at WIDE_TREE_SPREAD of
    the arc's angles (`trees`; `written[name]` waits for each): on "wide"
    (WIDE_TREE_VIEWS views at WIDE_EVAL_WH) the eval entry's DTU image at
    V = 10 (A, C, E and D or B per scale as the route says)
    and 16 (A, Cg, E and D at both scales, the pair layout; no B), each
    held to its all-plain render; the fused route at V = 10 (F), held
    to the V = 10 image's all-plain render; 3 steps of each recipe at
    V = 10 on "wide_train" (WIDE_TRAIN_TREE_VIEWS views at 640x512), their
    first step against the all-plain step, with peak memory. The weights
    are the seed's with a live density head (`live_density`, through
    `--load`). Into `out`: "wide_tree", "eval" and "eval_fused" entries,
    "train_wide"."""
    from matchnerf_tpu_torch.config import dtu_eval_config, dtu_train_config
    from matchnerf_tpu_torch.data import synth
    live = {}
    for V in sorted(set(WIDE_EVAL) | {WIDE_TRAIN}):
        for kind, make in (("eval", dtu_eval_config), ("train", dtu_train_config)):
            cfg = make()
            cfg.n_src_views = V
            live[kind, V] = write_live_checkpoint(
                torch, cfg, seed, os.path.join(trees["wide"]["work"],
                                               f"views_live_{kind}_v{V}.pth"))
    part("wide_tree", written["wide"])
    wide = trees["wide"]
    out["wide_tree"] = {"views": list(synth.dtu_scene_view_ids(WIDE_TREE_VIEWS)),
                        "spread": WIDE_TREE_SPREAD, "wh": list(WIDE_EVAL_WH)}
    log(f"views: {WIDE_TREE_VIEWS}-view DTU tree at {WIDE_EVAL_WH[0]}x{WIDE_EVAL_WH[1]} at "
        f"{WIDE_TREE_SPREAD} of the arc's angles, views {out['wide_tree']['views']} "
        "(val/test 24)")
    size = "--data_test.dtu.img_wh={},{}".format(*WIDE_EVAL_WH)
    for V in WIDE_EVAL:
        out["eval"][V] = part(f"eval_v{V}", lambda: views_eval(
            torch, dev, seed, wide, counters, V, live["eval", V], card, extra=(size,),
            must=("window_attention", "supercell_color")
            + (("block_cosine_prior",) if V == max(WIDE_EVAL) else ()),
            zero=("cosine_prior",) if V == max(WIDE_EVAL) else ()))
    out["eval_fused"][WIDE_FUSED] = part(f"eval_fused_v{WIDE_FUSED}", lambda: views_eval(
        torch, dev, seed, wide, counters, WIDE_FUSED, live["eval", WIDE_FUSED], card,
        extra=(size, "--precision.fused_cosine=true"),
        must=("window_attention", "supercell_color", "fused_cosine"),
        zero=("cosine_prior", "block_cosine_prior"), name=f"views_fused_v{WIDE_FUSED}",
        plain=out["eval"][WIDE_FUSED]["plain_rgb"], profile=False))
    for V in WIDE_EVAL:
        del out["eval"][V]["plain_rgb"]
    del out["eval_fused"][WIDE_FUSED]["plain_rgb"]
    part("wide_train_tree", written["wide_train"])
    out["train_wide"], _ = part(f"train_v{WIDE_TRAIN}", lambda: views_train(
        torch, dev, seed, trees["wide_train"], counters, ckpt, card, WIDE_TRAIN,
        live["train", WIDE_TRAIN]))


VARIANT_STEPS = 3                  # training steps of each variant run in phase 19
VARIANT_LABELS = {"A": "window_attention", "B": "cosine_prior", "C": "cond_nerf_decode",
                  "D": "block_cosine_prior", "E": "supercell_color", "F": "fused_cosine"}
# phase 19's eval variants: (name, the entry's extra arguments, kernels that
# must launch, kernels that must not); `view_dep: false` decodes in torch
# (no Kernel C), attention without splits runs no Kernel A, the local
# radius builds no table (no B, D, E), the fused route takes F, not B or D;
# an int4 scale takes Kernel B's int4 form, never D or F; without the
# upsampler both tables are the transformer's 1/8 scale
EVAL_VARIANTS = (
    ("view_dep_false", ["--nerf.view_dep=false"], "ADE", "CF"),
    ("local_radius", ["--encoder.feature_sample_local_radius=1",
                      "--encoder.feature_sample_local_dilation=2"], "AC", "BDEF"),
    ("attn_splits_1", ["--encoder.attn_splits_list=[1]"], "CDE", "AF"),
    ("fused_v2", ["--precision.fused_cosine=true", "--n_src_views=2"], "ACF", "BD"),
    ("fused_v4", ["--precision.fused_cosine=true", "--n_src_views=4"], "ACF", "BD"),
    ("int4", ["--precision.cond_sample_dtype=int4"], "ABCE", "DF"),
    ("int8_int4", ["--precision.cond_sample_dtype=[int8,int4]"], "ABCDE", "F"),
    ("fused_int8_int4p", ["--precision.fused_cosine=true",
                          "--precision.cond_sample_dtype=[int8,int4p99.9]"], "ABCEF", "D"),
    ("upsampler_none", ["--encoder.feature_upsampler=none"], "ACDE", "F"),
)
INT4_ENTRY = "cosine_prior_i4"     # Kernel B's int4 launcher (ops/cosine_prior.py ENTRIES)
# an int4 image against its whole all-plain render: its codes, in steps of
# amax / 7, make whole steps of Kernel A's bf16 rounding (PR 20's CG_EVAL
# floor for the same cause); held at 50 dB on the all-plain render's features
INT4_WHOLE_DB = 45.0
# variants held so too: without the upsampler the cosines read the
# transformer's features directly, and A's bf16 rounding reaches the image
# unsmoothed (48.28 dB whole on the card)
ENCODER_ROUNDING = ("upsampler_none",)
LPIPS_CROP = (256, 320)            # the centre crop phase 19 scores with LPIPS
# phase 19: feat_info off by this much (cosines lie in [-1, 1]) must take
# the `view_dep: false` image below 50 dB against all-plain
FEAT_OFFSET = 1e-2


def tame_output(torch, model):
    """Give the `view_dep: false` decoder's raw outputs the view_dep
    decoder's range (in place): its density has no ReLU, and at seeded
    weights a negative density makes the composite's transmittance exp(-sum)
    overflow, where neither an image PSNR nor a loss says anything. The
    density row of `output_linear` is scaled by 0.01 with a bias of 1; the
    rgb rows by 1/4 (the sigmoid's largest slope) with their bias moved by
    0.5, so the image follows the features of Kernels A, D and E as closely
    as the view_dep image does (`variants_eval` checks that it does)."""
    lin = model.nerf_dec.output_linear
    with torch.no_grad():
        lin.weight.mul_(torch.tensor([0.25, 0.25, 0.25, 0.01])[:, None])
        lin.bias.mul_(torch.tensor([0.25, 0.25, 0.25, 0.0])).add_(
            torch.tensor([0.5, 0.5, 0.5, 1.0]))
    return model


def fused_cases(torch, cfg, feats, ref_images, g, V, card, label):
    """Kernel F at V source views on the tap rows of the grids g [V,R,S,2]
    (one fused-route chunk) gathered from int8 tables of the encoder's
    features (also held against Kernel B) and from bf16 and f32 tables of
    the same features, against the plain twin at 1e-5 (in pieces: the f32
    rows of a chunk are 12.9 GB at V = 4 to 8), timed beside the bound."""
    from matchnerf_tpu_torch.models.matchnerf import gather_tap_rows, prepare_sampling_tables
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    from matchnerf_tpu_torch.ops import fused_cosine as kf
    R, S = g.shape[1:3]
    N = R * S
    P = V * (V - 1) // 2
    out = {"V": V, "card": card}
    for name, dt in (("int8", torch.int8), ("bfloat16", torch.bfloat16),
                     ("float32", None)):
        with torch.no_grad():
            tabs = prepare_sampling_tables(cfg, feats, ref_images, feat_dtype=dt)
        out[name] = []
        for s, G in enumerate(cfg.encoder.cos_n_group):
            table = tabs["view_feats"][s][0]
            scales = tabs["view_feat_scales"][s]
            scales = None if scales is None else scales[0]
            rows, wts = gather_tap_rows(table, g)
            fn = lambda: kf.fused_interp_grouped_cosine(rows, wts, G, scales)
            plain = lambda: kf.fused_interp_grouped_cosine_plain(rows, wts, G, scales,
                                                                 piece=2 ** 18)
            got = fn()
            ref, plain_ms = timed_once(torch, plain)
            err = max_abs(got, ref)
            del ref
            Cc = table.shape[-1]
            flops = N * (V * Cc * (9 + (scales is not None)) + P * 128 * 6)
            b_ms, b_by = bound(nbytes(rows, wts, got, *([scales] if scales is not None
                                                         else [])), flops)
            entry = dict(scale=s, G=G, R=R, max_abs_err=err, tol=1e-5,
                         ms=cuda_ms(torch, fn, 10), plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, rows_gb=nbytes(rows) / 1e9,
                         library_ms=None)
            extra = ""
            if name == "int8":
                entry["max_abs_err_vs_kernel_b"] = max_abs(
                    got, kb.cosine_prior(table, g, scales, G).reshape(N, G))
                extra = f", max|d| vs kernel B {entry['max_abs_err_vs_kernel_b']:.3e} (tol 1e-5)"
            log(f"{label}: kernel F fused_cosine V={V} scale {s} {name} rows "
                f"{list(rows.shape)} ({entry['rows_gb']:.2f} GB) G={G} R={R} S={S}: max|d| "
                f"{err:.3e} (tol 1e-5){extra}, {entry['ms']:.4f} ms vs plain "
                f"{entry['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}); {card}")
            check_close(f"{label} F V={V} {name} scale {s}", err, 1e-5)
            if name == "int8":
                check_close(f"{label} F vs B V={V} scale {s}",
                            entry["max_abs_err_vs_kernel_b"], 1e-5)
            out[name].append(entry)
            del rows, wts, got
        del tabs
        torch.cuda.empty_cache()
    return out


def variants_fused_kernel(torch, dev, seed, V, card):
    """Phase 19 (a): Kernel F at V source views on the tap rows of one
    fused-route chunk (the first `fused_chunk_rays(V)` rays of a V-source
    scene): `fused_cases`."""
    from matchnerf_tpu_torch import camera
    from matchnerf_tpu_torch.config import dtu_eval_config
    from matchnerf_tpu_torch.models.matchnerf import (fused_chunk_rays, init_matchnerf,
                                                      project_to_views, sample_depth)
    from matchnerf_tpu_torch.renderer import Renderer, extract_poses
    cfg = dtu_eval_config()
    cfg.n_src_views = V
    model = init_matchnerf(cfg, torch.Generator().manual_seed(seed)).to(dev).eval()
    renderer = Renderer(cfg, model, dev)
    batch = make_scene(seed, V)
    ref_images = renderer.tensor(batch["images"][:, :V])
    R = fused_chunk_rays(V)
    with torch.no_grad():
        feats = renderer.encode(ref_images)
        tgt_intr, c2w, tgt_nf, ref_w2c, ref_intr, ref_nf = renderer._pose_tensors(
            extract_poses(batch))
        pix = camera.pixel_grid(H, W, legacy=True, device=dev)[:R][None]
        center, ray = camera.get_center_and_ray(pix, tgt_intr, c2w)
        pts = camera.get_3d_points_from_depth(center, ray, sample_depth(cfg, tgt_nf, 1, R),
                                              multi_samples=True)
        g = (project_to_views(pts, ref_w2c, ref_intr, ref_nf, H, W)[..., :2]
             * 2.0 - 1.0)[:, 0].contiguous()                             # [V,R,S,2]
    del model, renderer
    out = fused_cases(torch, cfg, feats, ref_images, g, V, card, "variants")
    del feats, ref_images
    torch.cuda.empty_cache()
    return out


def offset_features_psnr(torch, renderer, batch, ref_rgb, delta):
    """PSNR against `ref_rgb` of `renderer`'s image with every feat_info
    value off by `delta` (a pre-hook on the decoder's `pts_bias`, whose input
    is [feat_info, color_info, mask_info])."""
    G = renderer.cfg.encoder.cos_n_group
    G = G if isinstance(G, int) else sum(G)

    def off(module, args):
        x = args[0].clone()
        x[..., :G] += delta
        return (x,)
    hook = renderer.model.nerf_dec.pts_bias.register_forward_pre_hook(off)
    try:
        with torch.no_grad():
            rgb = renderer.forward(batch, mode="test")["rgb"]
    finally:
        hook.remove()
    return psnr(rgb, ref_rgb)


def variants_eval(torch, dev, seed, tree, counters, name, extra, must, zero, load, card):
    """Phase 19 (b): `python -m matchnerf_tpu_torch.test --config test` with
    the variant's arguments on phase 12's DTU test view: the kernels of
    `must` launched and those of `zero` not, no plain version on CUDA,
    finite outputs (rgb in [0, 1] where the decoder ends in a sigmoid), the
    image >= 50 dB against the all-plain render of the same weights, and,
    for `view_dep: false` (tamed output layer), < 50 dB with feat_info off
    by FEAT_OFFSET; the render's seconds, rays/s and launches."""
    from matchnerf_tpu_torch.renderer import Renderer
    argv = ["--config", "test", f"--name=variants_{name}", f"--load={load}",
            f"--output_root={os.path.join(tree['work'], 'variants_runs')}", f"--seed={seed}",
            "--data_test.llff=", "--data_test.blender=", "--data_test.tnt="] + extra \
        + entry_set_args("dtu", tree["root"], tree["meta"])
    _, records = run_entry(torch, counters, argv)
    rec = records[0]
    launches, out = rec["launches"], rec["out"]
    label = f"variants {name}"
    for k in must:
        if launches[VARIANT_LABELS[k]] <= 0:
            raise AssertionError(f"{label}: Kernel {k} was not launched: {launches}")
    for k in zero:
        if launches[VARIANT_LABELS[k]] != 0:
            raise AssertionError(f"{label}: Kernel {k} launched {launches[VARIANT_LABELS[k]]} "
                                 f"times, expected none: {launches}")
    if any(rec["plain_cuda"].values()):
        raise AssertionError(f"{label}: plain versions ran on CUDA: {rec['plain_cuda']}")
    for k, v in out.items():
        if not bool(v.isfinite().all()):
            raise AssertionError(f"{label}: non-finite {k}")
    cfg = rec["renderer"].cfg
    rgb = out["rgb"]
    if cfg.nerf.view_dep and not (float(rgb.min()) >= -1e-6 and float(rgb.max()) <= 1 + 1e-6):
        raise AssertionError(f"{label}: rgb outside [0,1]: {float(rgb.min())} "
                             f"{float(rgb.max())}")
    plain_t = {}
    plain = Renderer(cfg, rec["renderer"].model, dev, kernel=False)
    ref = plain.forward(rec["batch"], mode="test", timings=plain_t)
    agreement = psnr(rgb, ref["rgb"])
    depth_err = float((out["depth"] - ref["depth"]).abs().max())
    int4_launches = rec["routes"].get("cosine_prior", {}).get(INT4_ENTRY, 0)
    int4 = any("cond_sample_dtype" in a for a in extra)
    rounding = int4 or name in ENCODER_ROUNDING
    int8_db = shared_db = None
    if rounding:
        # int4 codes (steps of amax / 7) turn the encoder's rounding (Kernel A's
        # bf16 forward against its plain twin) into whole code steps, and
        # without the upsampler that rounding reaches the cosines unsmoothed:
        # the route's kernels are held on the all-plain render's own features
        shared = Renderer(cfg, rec["renderer"].model, dev)
        shared.encode = plain.encode
        shared_db = psnr(shared.forward(rec["batch"], mode="test")["rgb"], ref["rgb"])
    if int4:
        if not int4_launches > 0:
            raise AssertionError(f"{label}: Kernel B's int4 form was not launched: "
                                 f"{rec['routes']}")
        # the quality cost of int4 at seeded weights: the same route on int8 tables
        icfg = copy.deepcopy(cfg)
        icfg.precision.cond_sample_dtype = "int8"
        int8_db = psnr(rgb, Renderer(icfg, rec["renderer"].model, dev).forward(
            rec["batch"], mode="test")["rgb"])
    whole_db = INT4_WHOLE_DB if rounding else 50.0
    off_db = None
    if not cfg.nerf.view_dep:
        # the check sees the features: feat_info off by FEAT_OFFSET must fail it
        off_db = offset_features_psnr(torch, rec["renderer"], rec["batch"], ref["rgb"],
                                      FEAT_OFFSET)
    del ref
    t = rec["timings"]
    n_rays = H * W
    entry = {"args": extra, "n_src_views": int(cfg.n_src_views), "load": load or None,
             "image_s": rec["seconds"], "encode_s": t["encode"], "tables_s": t["tables"],
             "render_s": t["render"], "rays_per_s_render": n_rays / t["render"],
             "plain_render_s": plain_t["render"], "psnr_vs_plain_db": agreement,
             "depth_max_abs_vs_plain": depth_err, "route": rec["route"],
             "launches": launches, "launches_by_route": rec["routes"],
             "rgb_range": [float(rgb.min()), float(rgb.max())],
             "feat_offset": FEAT_OFFSET, "psnr_feat_offset_db": off_db,
             "int4_launches": int4_launches, "psnr_vs_int8_db": int8_db,
             "psnr_plain_encoder_vs_plain_db": shared_db}
    log(f"{label} ({' '.join(extra)}): image {rec['seconds']:.4f} s, render "
        f"{t['render']:.4f} s, {entry['rays_per_s_render']:.0f} rays/s (render), all-plain "
        f"render {plain_t['render']:.4f} s; launches "
        + ", ".join(f"{k} {launches[v]}" for k, v in VARIANT_LABELS.items())
        + f"; route {rec['route']}; vs all-plain PSNR {agreement:.2f} dB (need >= "
        f"{whole_db:g}), max|d| depth {depth_err:.3e}"
        + ("" if off_db is None else
           f"; feat_info off by {FEAT_OFFSET:g}: {off_db:.2f} dB (need < 50)")
        + ("" if shared_db is None else
           f"; with the plain encoder's features (A's plain twin) vs all-plain "
           f"{shared_db:.2f} dB (need >= 50)")
        + ("" if int8_db is None else
           f"; B's int4 form {int4_launches} launches; vs the int8-table image "
           f"{int8_db:.2f} dB (no threshold)")
        + f"; {card}")
    if not agreement >= whole_db:
        raise AssertionError(f"{label}: agreement PSNR {agreement:.2f} dB < {whole_db:g}")
    if shared_db is not None and not shared_db >= 50.0:
        raise AssertionError(f"{label}: on the all-plain render's features {shared_db:.2f} "
                             "dB < 50")
    if off_db is not None and not off_db < 50.0:
        raise AssertionError(f"{label}: the image ignores its features: feat_info off by "
                             f"{FEAT_OFFSET:g} still gives {off_db:.2f} dB")
    entry["rgb"], entry["gt"] = rgb, rec["batch"]["images"][0, -1]
    del records, rec
    torch.cuda.empty_cache()
    return entry


def variants_train(torch, dev, seed, tree, counters, name, over, load, trace_dir, card):
    """Phase 19 (c): `python -m matchnerf_tpu_torch.train --config train` with
    the variant's keys on phase 12's DTU tree, VARIANT_STEPS steps without
    validation: the first step against the all-plain step (bf16-policy
    tolerances), finite losses, A' every step, B' twice a step where the
    step builds tables and never on the local radius, no plain version on
    CUDA; with `trace_dir`, the run's torch.profiler trace must exist and
    name A's forward and A''s two backward kernels."""
    from matchnerf_tpu_torch.models.matchnerf import init_matchnerf
    from matchnerf_tpu_torch.train import build_coach
    from matchnerf_tpu_torch.utils.checkpoint import load_model_weights
    runs = os.path.join(tree["work"], "variants_runs")
    keys = dict(over, **{"freq.val_it": -1, "freq.test_ep": -1, "load": load})
    if trace_dir:
        keys["profile_trace_dir"] = trace_dir
    argv = loop_args("train", f"variants_train_{name}", runs, tree["root"], tree["meta"],
                     VARIANT_STEPS, **keys)
    coach = build_coach(argv)

    def model_fn(cfg):
        model = init_matchnerf(cfg, torch.Generator().manual_seed(seed))
        if load:
            load_model_weights(model, load)
        return model
    first = first_step_check(torch, dev, coach.cfg, next(iter(coach.train_loader)), seed,
                             f"variants train.yaml {name} bf16 policy", (1e-2, 0.5, 0.1),
                             model_fn=model_fn)
    torch.cuda.empty_cache()
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coach.train_model()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    plain_cuda = {k: c.plain_on_cuda for k, c in counters.items()}
    with open(coach.scalars_path) as f:
        losses = [json.loads(line)["loss_render"] for line in f
                  if json.loads(line)["split"] == "train"]
    local = int(coach.cfg.encoder.feature_sample_local_radius) > 0
    log(f"variants train.yaml {name}: {VARIANT_STEPS} steps in {wall:.3f} s "
        f"({VARIANT_STEPS / wall:.3f} steps/s{', traced' if trace_dir else ''}), losses "
        f"{[round(x, 6) for x in losses]}, launches {launches}, plain versions on CUDA "
        f"{plain_cuda}; {card}")
    if len(losses) != VARIANT_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"variants train {name}: losses {losses}")
    if any(plain_cuda.values()):
        raise AssertionError(f"variants train {name}: plain versions ran on CUDA: {plain_cuda}")
    want_b = 0 if local else 2 * VARIANT_STEPS
    if (launches["window_attention_bwd"] <= 0 or launches["cosine_prior_bwd"] != want_b
            or (local and (launches["cosine_prior"] or launches["block_cosine_prior_f32"]))):
        raise AssertionError(f"variants train {name}: launches {launches}")
    out = {"keys": over, "steps": VARIANT_STEPS, "wall_s": wall, "losses": losses,
           "launches": launches, "first_step": first}
    if trace_dir:
        files = sorted(f for f in os.listdir(trace_dir) if f.endswith(".json"))
        if len(files) != 1:
            raise AssertionError(f"variants train {name}: trace files {files} in {trace_dir}")
        path = os.path.join(trace_dir, files[0])
        with open(path) as f:
            names = {str(e.get("name", "")) for e in json.load(f)["traceEvents"]}
        found = {k: sorted(n[:80] for n in names if k in n)
                 for k in ("window_attention_fwd", "window_attention_dq",
                           "window_attention_dkv")}
        log(f"variants train.yaml {name}: profile trace {path} "
            f"({os.path.getsize(path) / 2**20:.1f} MiB, {len(names)} event names), A and A' "
            f"kernels in it {found}")
        if not all(found.values()):
            raise AssertionError(f"variants train {name}: the trace lacks A / A' kernels: "
                                 f"{found}")
        out["trace"] = {"file": path, "bytes": os.path.getsize(path), "kernels": found}
    del coach
    torch.cuda.empty_cache()
    return out


def write_lpips_weights(path, seed):
    """Seeded VGG16 + LPIPS weights in the layout of
    configs/lpips_vgg_weights.npz (HWIO convolutions, VGG16's widths)."""
    rng = np.random.default_rng(seed)
    arrays, c_in, i = {}, 3, 0
    for c_out, n in ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)):
        for _ in range(n):
            arrays[f"conv{i}_w"] = rng.normal(0, np.sqrt(2.0 / (9 * c_in)),
                                              (3, 3, c_in, c_out)).astype(np.float32)
            arrays[f"conv{i}_b"] = rng.normal(0, 0.05, c_out).astype(np.float32)
            c_in, i = c_out, i + 1
    for s, c in enumerate((64, 128, 256, 512, 512)):
        arrays[f"lin{s}"] = rng.uniform(0, 0.1, c).astype(np.float32)
    np.savez(path, **arrays)


def variants_lpips(torch, dev, seed, work, pred, gt, card):
    """Phase 19 (d): LPIPS(VGG) of one rendered image against its target (a
    LPIPS_CROP centre crop) on the card and on the CPU, from seeded weights
    in a temporary npz that the module is pointed at (never configs/)."""
    from matchnerf_tpu_torch import lpips
    path = os.path.join(work, "lpips_seeded_weights.npz")
    write_lpips_weights(path, seed)
    h, w = LPIPS_CROP
    y0, x0 = (H - h) // 2, (W - w) // 2
    pred = pred.reshape(H, W, 3)[y0:y0 + h, x0:x0 + w].float().cpu().numpy()
    gt = np.asarray(gt)[y0:y0 + h, x0:x0 + w]
    saved = lpips._CACHE
    lpips._CACHE = path
    lpips._state.clear()
    try:
        on_card = lpips.lpips_distance(pred, gt, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = lpips.lpips_distance(pred, gt, dev)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = lpips.lpips_distance(pred, gt, "cpu")
        cpu_s = time.perf_counter() - t0
    finally:
        lpips._CACHE = saved
        lpips._state.clear()
    err = abs(on_card - on_cpu)
    log(f"variants: LPIPS(VGG, seeded weights) of a {h}x{w} crop on the card "
        f"{on_card:.7f} ({card_s * 1e3:.1f} ms warm), on the CPU {on_cpu:.7f} "
        f"({cpu_s * 1e3:.1f} ms), |d| {err:.3e} (tol 1e-4); {card}")
    check_close("variants LPIPS card vs CPU", err, 1e-4)
    return {"crop": [h, w], "card": on_card, "cpu": on_cpu, "abs_diff": err,
            "card_ms": card_s * 1e3, "cpu_ms": cpu_s * 1e3}


def variants_phase(torch, dev, seed, tree, counters):
    """Phase 19: the variants that config keys reach. (a) Kernel F at V = 2
    and 4; (b) the eval entry's DTU image under each of EVAL_VARIANTS
    against its all-plain render; (c) 3 train.yaml steps through the
    training entry with `view_dep: false` (traced under profile_trace_dir)
    and with the local radius; (d) LPIPS on the card against the CPU."""
    from matchnerf_tpu_torch.config import dtu_train_config
    from matchnerf_tpu_torch.models.matchnerf import init_matchnerf
    t_phase = time.perf_counter()
    card = card_line()
    work = os.path.join(tree["work"], "variants")
    os.makedirs(work, exist_ok=True)
    out = {"kernels": {V: variants_fused_kernel(torch, dev, seed, V, card)
                       for V in VIEW_COUNTS}}
    # the view_dep: false weights: seeded, the output layer tamed (`tame_output`)
    cfg = dtu_train_config()
    cfg.nerf.view_dep = False
    tamed = os.path.join(work, "view_dep_false.ckpt")
    torch.save({"model": tame_output(torch, init_matchnerf(
        cfg, torch.Generator().manual_seed(seed))).state_dict()}, tamed)
    out["eval"] = {}
    for name, extra, must, zero in EVAL_VARIANTS:
        load = tamed if name == "view_dep_false" else ""
        out["eval"][name] = variants_eval(torch, dev, seed, tree, counters, name, extra, must,
                                          zero, load, card)
    out["train"] = {
        "view_dep_false": variants_train(torch, dev, seed, tree, counters, "view_dep_false",
                                         {"nerf.view_dep": "false"}, tamed,
                                         os.path.join(work, "trace"), card),
        "local_radius": variants_train(torch, dev, seed, tree, counters, "local_radius",
                                       {"encoder.feature_sample_local_radius": 1,
                                        "encoder.feature_sample_local_dilation": 2}, "", None,
                                       card)}
    shot = out["eval"]["attn_splits_1"]
    out["lpips"] = variants_lpips(torch, dev, seed, work, shot["rgb"], shot["gt"], card)
    for e in out["eval"].values():
        del e["rgb"], e["gt"]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"variants phase: {out['phase_s']:.1f} s; {card}")
    return out


# ---- phase 20: Kernel Cg, every decoder the TPU kernel takes -------------

CG_RAYS = 8192                     # rays of each kernel-level slice at S = 128
# rays of the S = 512 slice: the plain twin's [R, 4, S, S] attention scores
# take 4.3 GB at 2048 rays and would take 34 GB (twice, with the softmax) at 8192
CG_LONG_RAYS = 2048
# phase 20's kernel-level decoders: (label, config keys, S, setbg)
NERF_MLP = {"decoder.net_width": 256, "decoder.net_depth": 8, "decoder.posenc.L_view": 4}
CG_DECODERS = (
    ("nerf_mlp_256x8_lview4", NERF_MLP, 128, False),
    ("w64_d4_skip2", {"decoder.net_width": 64, "decoder.net_depth": 4, "decoder.skip": [2]},
     128, False),
    ("standard_coord_gelu", {"nerf.legacy_coord": False, "decoder.raytrans_act": "GELU"},
     128, False),
    ("cond_72", {"encoder.cos_n_group": [30, 30]}, 128, False),
    ("nerf_mlp_s512_setbg_intervals", dict(NERF_MLP, **{"nerf.wo_render_interval": False}),
     512, True),
)
# the eval entry's DTU image under phase 20's decoders: (name, arguments,
# the floor of its PSNR against all-plain, whether to render it once more
# with Kernel A's plain twin in the encoder). The seeded NeRF MLP's image
# with the shipped bf16 encoder measured 46.65 dB against all-plain, and so
# did the render through the same kernels with the plain decoder: it is
# held to 45 dB, and its render with A's twin shows which kernel sets the
# gap; with the f32 encoder, and with the weights after 3 training steps,
# the image is held to 50 dB
CG_NERF_MLP_ARGS = ["--decoder.net_width=256", "--decoder.net_depth=8",
                    "--decoder.posenc.L_view=4"]
CG_EVAL = (
    ("nerf_mlp", CG_NERF_MLP_ARGS, 45.0, True),
    ("nerf_mlp_f32_encoder", CG_NERF_MLP_ARGS + ["--precision.encoder_compute_dtype=float32"],
     50.0, False),
    ("standard_coord_gelu", ["--nerf.legacy_coord=false", "--decoder.raytrans_act=GELU"], 50.0,
     False),
)
CG_TRAIN_STEPS = 3


def set_keys(cfg, keys):
    """cfg with each dotted key of `keys` set (in place)."""
    for key, value in keys.items():
        sub = cfg
        *path, last = key.split(".")
        for k in path:
            sub = sub[k]
        sub[last] = value
    return cfg


def seeded_decoder(torch, cfg, seed, dev):
    """A CondNeRF of `cfg` from a seeded generator, every bias moved off
    zero (0.05 x a normal draw) so that each bias path shows."""
    from matchnerf_tpu_torch.models.decoder.cond_nerf import CondNeRF
    from matchnerf_tpu_torch.ops.nn import reset_parameters
    g = torch.Generator().manual_seed(seed)
    dec = reset_parameters(CondNeRF(cfg), g)
    with torch.no_grad():
        for p in dec.parameters():
            if p.dim() == 1:
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    return dec.to(dev).eval()


def decoder_inputs(torch, cfg, R, S, seed, dev):
    """The decoder's inputs for R rays of S samples, drawn on the card: NDC
    points in [-1, 1], one unit direction a ray, cosines in [-1, 1], colours
    in [0, 1], masks with samples that 0, 1, 2 and 3 views see (no view:
    maskfill; one view: the masked-query attention), sorted depths."""
    g = torch.Generator(device=dev).manual_seed(seed)
    V = int(cfg.n_src_views)
    Gf = int(sum(cfg.encoder.cos_n_group))
    rnd = lambda *s: torch.rand(*s, generator=g, device=dev)
    ray = torch.randn(1, R, 3, generator=g, device=dev)
    unit = (ray / ray.norm(dim=-1, keepdim=True))[:, :, None].expand(1, R, S, 3)
    cond = {"feat_info": rnd(1, R, S, Gf) * 2 - 1, "color_info": rnd(1, R, S, 3 * V),
            "mask_info": (rnd(1, R, S, V) > 0.4).float()}
    depth = torch.sort(rnd(1, R, S) * 2.4 + 2.1, dim=-1).values[..., None]
    return (rnd(1, R, S, 3) * 2 - 1, unit.contiguous(), cond, depth.contiguous(), ray)


def cg_flops(dec, cfg, S):
    """Kernel Cg's operations per sample, as `decoder_flops` splits them:
    (2 per weight of the wide layers: pts_bias, the pts_linears,
    alpha_linear, feature_linear, views_linears.0, rgb_linear; 2 per weight
    of the 16-wide ray tail, the attention's QK and PV over S samples and
    the 6 (L_3D + L_view) sines and cosines)."""
    from matchnerf_tpu_torch.ops.decoder import _posenc_freqs
    wide, rest = decoder_flops(dec, S)
    L3, Lv = _posenc_freqs(cfg)
    return wide, rest - 60 + 6 * (L3 + Lv)


def cg_case(torch, dev, cfg, dec, R, S, setbg, label, seed, card):
    """Kernel Cg on both operand routes against its plain twins on one slice
    of R rays (Kernel C's tolerances and its bf16 mean check, as
    `decoder_case`), launched through the wrapper's route (Cg, never C);
    CUDA-event times beside the bound, reckoned as Kernel C's
    (`decoder_bound`): the wide products at the route's tensor-core rate
    (split TF32 for f32, bf16), the rest on the f32 CUDA cores."""
    from matchnerf_tpu_torch.ops import decoder as kc
    args = (dec, cfg, *decoder_inputs(torch, cfg, R, S, seed, dev))
    if kc.decoder_route(dec, cfg, S) != "Cg":
        raise AssertionError(f"Cg {label}: the wrapper routes it to "
                             f"{kc.decoder_route(dec, cfg, S)}")
    ins = [args[2], args[3], *args[4].values(), args[5], args[6]]
    N = R * S
    out = {"R": R, "S": S, "setbg": setbg, "decoder": list(kc.decoder_shape(dec)),
           "card": card}
    with torch.no_grad():
        twins = {r: kc.cond_nerf_decode_plain(*args, setbg, matmul_dtype=getattr(torch, r))
                 for r in ("float32", "bfloat16")}
        gap = float(torch.cat([(a - b).abs().flatten() for a, b in
                               zip(twins["float32"], twins["bfloat16"])]).mean())
        for route, tols in (("float32", (1e-4, 1e-3, 1e-4)), ("bfloat16", (1e-2, 1e-2, 1e-3))):
            md = getattr(torch, route)
            c_before, g_before = kc.COUNTER.launches, kc.COUNTER_ANY.launches
            fn = lambda: kc.cond_nerf_decode(*args, setbg, matmul_dtype=md)
            got = fn()
            torch.cuda.synchronize()
            if kc.COUNTER.launches != c_before or kc.COUNTER_ANY.launches != g_before + 1:
                raise AssertionError(f"Cg {label} {route}: C {kc.COUNTER.launches - c_before} "
                                     f"and Cg {kc.COUNTER_ANY.launches - g_before} launches")
            ref = twins[route]
            errs = [max_abs(a, b) for a, b in zip(got, ref)]
            diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(got, ref)])
            mean_err = float(diffs.mean())
            finite = all(bool(t.isfinite().all()) for t in got)
            ms = cuda_ms(torch, fn, 5)
            plain_ms = cuda_ms(torch, lambda: kc.cond_nerf_decode_plain(
                *args, setbg, matmul_dtype=md), 2)
            small, wts = kc.kernel_weights(dec, md, dev, "Cg")
            wide, rest = cg_flops(dec, cfg, S)
            flops = N * (wide + rest)
            b_ms, b_by = decoder_bound(nbytes(*ins, *got, small, wts), (wide, rest), N, route)
            log(f"kernel Cg cond_nerf_decode_any {label} R={R} S={S} setbg={setbg} {route} "
                f"route: max|d| rgb {errs[0]:.3e} depth {errs[1]:.3e} opacity {errs[2]:.3e} "
                f"(tol {tols}), mean|d| {mean_err:.3e} (f32 vs bf16 twins {gap:.3e}), "
                f"{ms:.3f} ms vs plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; "
                f"{ms / b_ms:.2f}x the bound: "
                f"{N * wide / 1e12:.3f} TFLOP of wide products at "
                f"{TC_FLOPS[route] / 1e12:.0f} TFLOP/s + {N * rest / 1e12:.4f} TFLOP at 67, "
                f"{flops / ms / 1e9:.1f} TFLOP/s reached); {card}")
            if not finite:
                raise AssertionError(f"Cg {label} {route}: non-finite output")
            for name, err, tol in zip(("rgb", "depth", "opacity"), errs, tols):
                check_close(f"cond_nerf_decode_any {label} {route} {name}", err, tol)
            if route == "bfloat16" and not mean_err < 0.1 * gap:
                raise AssertionError(f"Cg {label} bf16: mean|d| {mean_err} is not under a "
                                     f"tenth of the f32-bf16 gap {gap}")
            out[route] = dict(max_abs_err=max(errs), max_abs_err_rgb_depth_opacity=errs,
                              tol=list(tols), mean_abs_err=mean_err, twin_gap_mean=gap, ms=ms,
                              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              ratio_to_bound=ms / b_ms, tflops=flops / 1e12, library_ms=None)
            del got
    del args, twins
    torch.cuda.empty_cache()
    return out


def cg_kernel_cases(torch, dev, seed, card):
    """Phase 20 (a): Kernel Cg against its plain twin on CG_DECODERS, both
    routes, on seeded weights with non-zero biases."""
    from matchnerf_tpu_torch.config import dtu_eval_config
    out = {}
    for label, keys, S, setbg in CG_DECODERS:
        cfg = set_keys(dtu_eval_config(), keys)
        dec = seeded_decoder(torch, cfg, seed, dev)
        R = CG_RAYS if S == 128 else CG_LONG_RAYS
        out[label] = dict(cg_case(torch, dev, cfg, dec, R, S, setbg, label, seed + 1, card),
                          keys=keys)
        del dec
    return out


def offset_features_kernel_rgb(torch, renderer, batch, delta):
    """`renderer`'s rgb with every feat_info value off by `delta` on its way
    into the eval decoder's kernel (the kernel reads its packed weights, so
    a hook on `pts_bias` would not reach it: the render's
    `cond_nerf_decode` is wrapped instead)."""
    from matchnerf_tpu_torch.models import matchnerf as mn
    decode = mn.cond_nerf_decode

    def off(dec, cfg, pts, unit, cond, *a, **k):
        cond = dict(cond, feat_info=(cond["feat_info"] + delta).contiguous())
        return decode(dec, cfg, pts, unit, cond, *a, **k)
    mn.cond_nerf_decode = off
    try:
        with torch.no_grad():
            rgb = renderer.forward(batch, mode="test")["rgb"]
    finally:
        mn.cond_nerf_decode = decode
    return rgb


def plain_encoder_psnr(torch, dev, renderer, batch, ref_rgb, counters, kernel, slices, label):
    """PSNR against `ref_rgb` of `renderer`'s image with Kernel A's plain
    twin in the encoder and every other kernel (D, E and the decoder's) as
    the entry runs them: no A launch, `slices` of `kernel`."""
    from matchnerf_tpu_torch.models import matchnerf as mn
    from matchnerf_tpu_torch.renderer import Renderer
    r = Renderer(renderer.cfg, renderer.model, dev)
    r.encode = lambda ref_images: mn.encode(r.model, r.cfg, ref_images, kernel=False)
    names = ("window_attention", kernel, "block_cosine_prior", "supercell_color")
    before = {k: counters[k].launches for k in names}
    with torch.no_grad():
        rgb = r.forward(batch, mode="test")["rgb"]
    torch.cuda.synchronize()
    moved = {k: counters[k].launches - before[k] for k in names}
    if (moved["window_attention"] or moved[kernel] != slices
            or not moved["block_cosine_prior"] or not moved["supercell_color"]):
        raise AssertionError(f"{label}: the render with A's plain twin launched {moved}")
    return psnr(rgb, ref_rgb)


def cg_eval(torch, dev, seed, tree, counters, name, extra, load, card, kernel, offset,
            plain_floor, isolate=False):
    """Phase 20 (b): `python -m matchnerf_tpu_torch.test --config test` with
    `extra` on phase 12's DTU test view: one launch of `kernel` (Cg, or C for
    the shipped decoder) per 8192-ray slice and none of the other, no plain
    version on CUDA, finite rgb in [0, 1]. The image against two renders of
    the same weights: the same kernels with the plain decoder in place of
    the decoder kernel (the decoder alone: >= 50 dB), and all-plain (>=
    `plain_floor` dB); with `offset`, feat_info off by FEAT_OFFSET on its way
    into the kernel must fall below 50 dB against the first and below
    `plain_floor` against all-plain; with `isolate`, the PSNR against
    all-plain of the render with A's plain twin and every other kernel. The
    image's seconds and the kernel's device ms per launch (torch.profiler,
    one more render)."""
    from matchnerf_tpu_torch.models import matchnerf as mn
    from matchnerf_tpu_torch.ops.decoder import cond_nerf_decode_plain, decoder_shape
    from matchnerf_tpu_torch.renderer import Renderer
    argv = ["--config", "test", f"--name=cg_{name}", f"--load={load}",
            f"--output_root={os.path.join(tree['work'], 'cg_runs')}", f"--seed={seed}",
            "--data_test.llff=", "--data_test.blender=", "--data_test.tnt="] + extra \
        + entry_set_args("dtu", tree["root"], tree["meta"])
    _, records = run_entry(torch, counters, argv)
    rec = records[0]
    launches, out, label = rec["launches"], rec["out"], f"Cg eval {name}"
    other = "cond_nerf_decode" if kernel == "cond_nerf_decode_any" else "cond_nerf_decode_any"
    slices = -(-H * W // 8192)
    if launches[kernel] != slices or launches[other] != 0:
        raise AssertionError(f"{label}: {kernel} {launches[kernel]} launches (want {slices}), "
                             f"{other} {launches[other]} (want 0): {launches}")
    if any(rec["plain_cuda"].values()):
        raise AssertionError(f"{label}: plain versions ran on CUDA: {rec['plain_cuda']}")
    rgb = out["rgb"]
    if not (all(bool(v.isfinite().all()) for v in out.values())
            and float(rgb.min()) >= -1e-6 and float(rgb.max()) <= 1 + 1e-6):
        raise AssertionError(f"{label}: rgb not finite in [0, 1]")
    renderer, batch = rec["renderer"], rec["batch"]
    ms, n = kernel_device_ms(torch, lambda: renderer.forward(batch, mode="test")).get(
        kernel, (float("nan"), 0))
    decode = mn.cond_nerf_decode
    mn.cond_nerf_decode = cond_nerf_decode_plain
    try:
        with torch.no_grad():
            iso = renderer.forward(batch, mode="test")
    finally:
        mn.cond_nerf_decode = decode
    plain_t = {}
    ref = Renderer(renderer.cfg, renderer.model, dev, kernel=False).forward(
        batch, mode="test", timings=plain_t)
    vs_iso, vs_plain = psnr(rgb, iso["rgb"]), psnr(rgb, ref["rgb"])
    iso_vs_plain = psnr(iso["rgb"], ref["rgb"])
    depth_err = float((out["depth"] - iso["depth"]).abs().max())
    off_db = off_plain_db = None
    if offset:
        off_rgb = offset_features_kernel_rgb(torch, renderer, batch, FEAT_OFFSET)
        off_db, off_plain_db = psnr(off_rgb, iso["rgb"]), psnr(off_rgb, ref["rgb"])
        del off_rgb
    a_plain_db = (plain_encoder_psnr(torch, dev, renderer, batch, ref["rgb"], counters, kernel,
                                     slices, label) if isolate else None)
    entry = {"args": extra, "load": load or None, "kernel": kernel, "launches": launches,
             "launches_by_route": rec["routes"], "image_s": rec["seconds"],
             "render_s": rec["timings"]["render"], "plain_render_s": plain_t["render"],
             "kernel_device_ms_per_launch": ms / max(n, 1), "profiled_launches": n,
             "psnr_vs_plain_decoder_db": vs_iso, "depth_max_abs_vs_plain_decoder": depth_err,
             "psnr_vs_plain_db": vs_plain, "psnr_plain_decoder_vs_plain_db": iso_vs_plain,
             "plain_floor_db": plain_floor,
             "feat_offset": FEAT_OFFSET if offset else None, "psnr_feat_offset_db": off_db,
             "psnr_feat_offset_vs_plain_db": off_plain_db,
             "psnr_plain_window_attention_vs_plain_db": a_plain_db,
             "opacity_mean": float(out["opacity"].mean()),
             "decoder": list(decoder_shape(renderer.model.nerf_dec)), "card": card}
    log(f"{label} ({' '.join(extra) or 'as shipped'}{', load ' + load if load else ''}): "
        f"image {rec['seconds']:.4f} s (render {rec['timings']['render']:.4f} s, all-plain "
        f"render {plain_t['render']:.4f} s); {kernel} {launches[kernel]} launches, "
        f"{ms / max(n, 1):.3f} device ms per launch ({n} profiled); PSNR vs the same "
        f"kernels with the plain decoder {vs_iso:.2f} dB (need >= 50, max|d| depth "
        f"{depth_err:.3e}), vs all-plain {vs_plain:.2f} dB (need >= {plain_floor:g}; the "
        f"plain-decoder render vs all-plain {iso_vs_plain:.2f} dB), opacity mean "
        f"{entry['opacity_mean']:.4f}"
        + ("" if off_db is None else
           f"; feat_info off by {FEAT_OFFSET:g} into the kernel: {off_db:.2f} dB (need < 50), "
           f"{off_plain_db:.2f} vs all-plain (need < {plain_floor:g})")
        + ("" if a_plain_db is None else
           f"; with A's plain twin and every other kernel: {a_plain_db:.2f} dB vs all-plain")
        + f"; {card}")
    if not vs_iso >= 50.0:
        raise AssertionError(f"{label}: PSNR {vs_iso:.2f} dB < 50 against the plain decoder")
    if not vs_plain >= plain_floor:
        raise AssertionError(f"{label}: agreement PSNR {vs_plain:.2f} dB < {plain_floor:g}")
    if off_db is not None and not (off_db < 50.0 and off_plain_db < plain_floor):
        raise AssertionError(f"{label}: the image ignores its features: feat_info off by "
                             f"{FEAT_OFFSET:g} still gives {off_db:.2f} dB, {off_plain_db:.2f} "
                             f"against all-plain")
    del records, rec, ref, out, iso
    torch.cuda.empty_cache()
    return entry


def cg_train(torch, dev, seed, tree, counters, card):
    """Phase 20 (c): CG_TRAIN_STEPS steps of `python -m
    matchnerf_tpu_torch.train --config train` with the NeRF MLP decoder
    (256x8, L_view 4) on phase 12's DTU tree, no validation: the first step
    against the all-plain step (bf16-policy tolerances), finite losses, the
    plain decoder (no C or Cg launch), A' every step and B' twice a step,
    the peak device memory -> (results, the run's latest.ckpt)."""
    from matchnerf_tpu_torch.train import build_coach
    keys = {k: v for k, v in NERF_MLP.items()}
    argv = loop_args("train", "cg_train_nerf_mlp", os.path.join(tree["work"], "cg_runs"),
                     tree["root"], tree["meta"], CG_TRAIN_STEPS,
                     **dict(keys, **{"freq.val_it": -1, "freq.test_ep": -1}))
    coach = build_coach(argv)
    first = first_step_check(torch, dev, coach.cfg, next(iter(coach.train_loader)), seed,
                             "Cg train.yaml nerf_mlp bf16 policy", (1e-2, 0.5, 0.1))
    torch.cuda.empty_cache()
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    coach.train_model()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {k: c.launches for k, c in counters.items()}
    plain_cuda = {k: c.plain_on_cuda for k, c in counters.items()}
    with open(coach.scalars_path) as f:
        losses = [json.loads(line)["loss_render"] for line in f
                  if json.loads(line)["split"] == "train"]
    latest = os.path.join(coach.output_path, "models", "latest.ckpt")
    log(f"Cg train.yaml nerf_mlp: {CG_TRAIN_STEPS} steps in {wall:.3f} s "
        f"({CG_TRAIN_STEPS / wall:.3f} steps/s), peak {peak_gib:.2f} GiB, losses "
        f"{[round(x, 6) for x in losses]}, launches {launches}, plain versions on CUDA "
        f"{plain_cuda}, checkpoint {os.path.exists(latest)}; {card}")
    if len(losses) != CG_TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"Cg train: losses {losses}")
    if any(plain_cuda.values()) or not os.path.exists(latest):
        raise AssertionError(f"Cg train: plain versions on CUDA {plain_cuda}, {latest}")
    if (launches["window_attention_bwd"] <= 0
            or launches["cosine_prior_bwd"] != 2 * CG_TRAIN_STEPS
            or launches["cond_nerf_decode"] or launches["cond_nerf_decode_any"]):
        raise AssertionError(f"Cg train: launches {launches}")
    out = {"keys": keys, "steps": CG_TRAIN_STEPS, "wall_s": wall, "losses": losses,
           "launches": launches, "first_step": first, "peak_gib": peak_gib, "card": card}
    del coach
    torch.cuda.empty_cache()
    return out, latest


def cg_phase(torch, dev, seed, tree, counters):
    """Phase 20: Kernel Cg. (a) against its plain twin on CG_DECODERS, both
    routes; (b) the eval entry's DTU image with each decoder of CG_EVAL
    through Cg (40 launches, no C), at or above its CG_EVAL floor against
    all-plain, and below it with feat_info offset; (c) 3 train.yaml steps with the NeRF MLP
    decoder, then (d) its checkpoint through the eval entry and Cg; (e)
    `--config test` as shipped still decodes with C, no Cg."""
    t_phase = time.perf_counter()
    card = card_line()
    parts = {}

    def part(name, fn):
        t0 = time.perf_counter()
        result = fn()
        parts[name] = time.perf_counter() - t0
        log(f"Cg: {name} in {parts[name]:.1f} s")
        return result
    out = {"kernels": part("kernel cases", lambda: cg_kernel_cases(torch, dev, seed, card))}
    out["eval"] = {}
    for name, extra, floor, isolate in CG_EVAL:
        out["eval"][name] = part(f"eval {name}", lambda: cg_eval(
            torch, dev, seed, tree, counters, name, extra, "", card, "cond_nerf_decode_any",
            True, floor, isolate))
    out["train"], latest = part("train", lambda: cg_train(torch, dev, seed, tree, counters,
                                                          card))
    out["eval"]["nerf_mlp_trained"] = part("eval trained", lambda: cg_eval(
        torch, dev, seed, tree, counters, "nerf_mlp_trained", CG_NERF_MLP_ARGS, latest, card,
        "cond_nerf_decode_any", False, 50.0))
    out["eval"]["shipped"] = part("eval shipped", lambda: cg_eval(
        torch, dev, seed, tree, counters, "shipped", [], "", card, "cond_nerf_decode", False,
        50.0))
    out["part_s"] = parts
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"Cg phase: {out['phase_s']:.1f} s ({', '.join(f'{k} {v:.1f}' for k, v in parts.items())}"
        f"); {card}")
    return out


DET_STEPS = 3                      # steps of each run in phase 21
# phase 21's runs: (recipe, n_src_views, the tree: phase 12's or phase 18's
# 11-view one)
DET_RUNS = (("train", 3, "dtu"), ("train_fast", 3, "dtu"), ("train", 8, "many"))


def determinism_run(torch, counters, label, V, t, rep, runs):
    """One of phase 21's runs: DET_STEPS steps of `python -m
    matchnerf_tpu_torch.train --config label --n_src_views=V` (build_coach +
    train_model, seeded weights, no validation) on the DTU tree t, then its
    latest.ckpt through the eval entry on the tree's test view -> (losses,
    parameters, AdamW moments, image, launches, seconds)."""
    from matchnerf_tpu_torch.train import build_coach
    t0 = time.perf_counter()
    argv = loop_args(label, f"det_{label}_v{V}_{rep}", runs, t["root"], t["meta"], DET_STEPS,
                     **{"n_src_views": V, "freq.val_it": -1, "freq.test_ep": -1})
    coach = build_coach(argv)
    for c in counters.values():
        c.reset()
    coach.train_model()
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    plain_cuda = {k: c.plain_on_cuda for k, c in counters.items()}
    with open(coach.scalars_path) as f:
        losses = [json.loads(line)["loss_render"] for line in f
                  if json.loads(line)["split"] == "train"]
    names = {id(p): n for n, p in coach.model.named_parameters()}
    params = {n: p.detach().clone() for n, p in coach.model.named_parameters()}
    moments = {(names[id(p)], k): v.detach().clone()
               for p, st in coach.opt.opt.state.items() for k, v in st.items()
               if k in ("exp_avg", "exp_avg_sq")}
    latest = os.path.join(coach.output_path, "models", "latest.ckpt")
    route = coach.last_route
    del coach
    torch.cuda.empty_cache()
    if any(plain_cuda.values()) or len(losses) != DET_STEPS:
        raise AssertionError(f"determinism {label} V={V}: losses {losses}, plain versions on "
                             f"CUDA {plain_cuda}")
    bwd = launches["cosine_prior_bwd"] + launches["block_cosine_prior_bwd"]
    if bwd != 2 * DET_STEPS or launches["window_attention_bwd"] <= 0:
        raise AssertionError(f"determinism {label} V={V}: launches {launches}")
    argv = ["--config", "test", f"--name=det_{label}_v{V}_{rep}_eval", f"--load={latest}",
            f"--output_root={runs}", f"--n_src_views={V}", "--data_test.llff=",
            "--data_test.blender=", "--data_test.tnt="] + entry_set_args("dtu", t["root"],
                                                                         t["meta"])
    _, records = run_entry(torch, counters, argv)
    image = records[0]["out"]["rgb"].detach().clone()
    del records
    torch.cuda.empty_cache()
    return {"losses": losses, "params": params, "moments": moments, "image": image,
            "launches": launches, "route": route, "s": time.perf_counter() - t0}


def determinism_phase(torch, dev, seed, tree, counters):
    """Phase 21: training repeats itself on the card. For each of DET_RUNS
    (train.yaml and train_fast.yaml at V = 3 on phase 12's tree, train.yaml
    at V = 8 on phase 18's 11-view tree) two runs of `determinism_run`: the
    losses equal, the largest difference of any parameter and of any AdamW
    moment 0, and the two checkpoints' images bit-equal; B' and D''s
    launches beside them (two a step)."""
    t_phase = time.perf_counter()
    card = card_line()
    many = {"root": os.path.join(tree["work"], "views_dtu"),
            "meta": os.path.join(tree["work"], "views_dtu_meta")}
    runs = os.path.join(tree["work"], "det_runs")
    out = {}
    for label, V, which in DET_RUNS:
        t = tree if which == "dtu" else many
        a, b = (determinism_run(torch, counters, label, V, t, rep, runs) for rep in (0, 1))
        d_param = max(float((a["params"][n] - b["params"][n]).abs().max()) for n in a["params"])
        d_moment = max(float((a["moments"][k] - b["moments"][k]).abs().max())
                       for k in a["moments"])
        same_image = bool(torch.equal(a["image"], b["image"]))
        key = f"{label}_v{V}"
        out[key] = {"V": V, "steps": DET_STEPS, "losses": [a["losses"], b["losses"]],
                    "max_abs_param_diff": d_param, "max_abs_moment_diff": d_moment,
                    "moments": len(a["moments"]), "parameters": len(a["params"]),
                    "images_bit_equal": same_image,
                    "image_psnr_db": psnr(a["image"], b["image"]) if not same_image else None,
                    "route": a["route"],
                    "launches": {k: a["launches"][k] for k in (
                        "window_attention_bwd", "cosine_prior_bwd", "block_cosine_prior_bwd")},
                    "s": [a["s"], b["s"]], "card": card}
        log(f"determinism {label}.yaml V={V}: two runs of {DET_STEPS} steps, losses "
            f"{a['losses']} / {b['losses']}, route {a['route']} (None: B'), launches "
            f"{out[key]['launches']}; largest difference of any parameter {d_param:g} "
            f"({len(a['params'])} tensors) and of any AdamW moment {d_moment:g} "
            f"({len(a['moments'])} tensors) (need 0); checkpoint images bit-equal "
            f"{same_image}; {a['s']:.1f} + {b['s']:.1f} s; {card}")
        if a["losses"] != b["losses"] or d_param != 0 or d_moment != 0 or not same_image:
            raise AssertionError(f"determinism {label} V={V}: the two runs differ")
        del a, b
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"determinism phase: {out['phase_s']:.1f} s; {card}")
    return out


# ---- phase 22: the convergence run ----------------------------------------

CONV_STEPS = 200                   # steps of each small-shape run (tools/convergence_tpu.py)
CONV_LOG_AT = (1, 50, 100, 150, 200)
CONV_FLOOR_DB = 22.0               # each kernel run's target view, at least
CONV_TWIN_DB = 1.0                 # and within this of its all-plain twin
CONV_JAX_CPU_DB = 25.52            # the JAX tool on the CPU at 200 steps, S = 32 (not a bar)
# steps of each full-width run through the training entry: 200 took 202 s
# for (b) alone (4 runs, 8 validations) on an H100 80GB HBM3 at 700 W, and
# 100 took 133 s in a whole run whose phase 22 took 254 s: cut to keep the
# phase within 240 s and the script inside its limit
CONV_FULL_STEPS = 50
CONV_FULL_EPOCH = 42               # the most steps an epoch (phase 12's tree: 6 views x 7 lights)
CONV_FULL_GAIN_DB = 3.0            # the validation image's rise over its step-0 image
CONV_LOSS_WINDOW = 20              # steps averaged at each end of a full-width run


def route_scales(route):
    """The prior kernel each feature scale's backward takes under a
    training route: D' where the route gives a bucket, else B'."""
    return ["D'" if route is not None and ut is not None else "B'" for ut in
            (route if route is not None else (None, None))]


def check_train_steps(label, steps, recipe, plain_ok=()):
    """Each step launched A' and, per feature scale, B' or D' as its route
    names (B' at both under train.yaml), and no plain version ran on CUDA
    but those of `plain_ok`."""
    for i, st in enumerate(steps):
        l, pc = st["launches"], st["plain_on_cuda"]
        scales = route_scales(st["route"]) if recipe == "train_fast" else ["B'", "B'"]
        want_d = scales.count("D'")
        if l["window_attention_bwd"] <= 0:
            raise AssertionError(f"{label} step {i + 1}: no A' launch: {l}")
        if recipe != "tiny" and (l["block_cosine_prior_bwd"], l["cosine_prior_bwd"]) != (
                want_d, 2 - want_d):
            raise AssertionError(f"{label} step {i + 1}: route {st['route']} wants "
                                 f"{scales}, launched D' {l['block_cosine_prior_bwd']} and "
                                 f"B' {l['cosine_prior_bwd']}")
        bad = {k: v for k, v in pc.items() if v and k not in plain_ok}
        if bad:
            raise AssertionError(f"{label} step {i + 1}: plain versions ran on CUDA: {bad}")


def convergence_small(torch, dev, seed, card):
    """Phase 22 (a): `matchnerf_tpu_torch.convergence` at its defaults (32x48,
    2 layers, S = 32, 256 rays, CONV_STEPS steps) for each recipe, on the
    kernels and all-plain from one seed: the losses at CONV_LOG_AT, the
    target view's PSNR (>= CONV_FLOOR_DB and within CONV_TWIN_DB of the
    all-plain twin), A' every step, B' every train.yaml step, B' or D' at
    each scale as the train_fast route names it, and no plain version on
    CUDA but the tiny recipe's direct matching prior (no banded or block
    kernel in its config, as in the JAX package)."""
    from matchnerf_tpu_torch import convergence
    out = {}
    for recipe in convergence.RECIPES:
        res = {}
        for route in ("kernel", "plain"):
            cfg = convergence.recipe_config(recipe)
            r = convergence.run(cfg, CONV_STEPS, dev, kernel=route == "kernel", seed=seed,
                                log=None)
            torch.cuda.synchronize()
            res[route] = r
        k, p = res["kernel"], res["plain"]
        label = f"convergence {recipe}"
        routes = sorted({str(st["route"]) for st in k["per_step"]})
        scales = sorted({" ".join(route_scales(st["route"])) for st in k["per_step"]})
        render_plain = {n: v for n, v in k["render"]["plain_on_cuda"].items() if v}
        gap = k["psnr"] - p["psnr"]
        out[recipe] = {
            route: {"losses_at": {n: r["losses"][n - 1] for n in CONV_LOG_AT},
                    "psnr_db": r["psnr"], "wall_s": r["wall_s"],
                    "steps_per_s": CONV_STEPS / r["wall_s"], "launches": r["launches"],
                    "plain_on_cuda": r["plain_on_cuda"],
                    "render_launches": r["render"]["launches"],
                    "render_route": r["render_route"]}
            for route, r in res.items()}
        out[recipe].update({"routes": routes, "scale_kernels": scales, "psnr_gap_db": gap,
                            "card": card})
        for route, r in res.items():
            log(f"{label} ({route}): losses " + ", ".join(
                f"{n}: {r['losses'][n - 1]:.5f}" for n in CONV_LOG_AT)
                + f"; target view {r['psnr']:.2f} dB; {CONV_STEPS} steps in {r['wall_s']:.1f}"
                f" s ({CONV_STEPS / r['wall_s']:.2f} steps/s); launches in the steps "
                + str({n: v for n, v in r["launches"].items() if v}) + ", in the render "
                + str({n: v for n, v in r["render"]["launches"].items() if v})
                + f", plain versions on CUDA {({n: v for n, v in r['plain_on_cuda'].items() if v})}")
        log(f"{label}: kernels {k['psnr']:.2f} dB vs all-plain {p['psnr']:.2f} dB (gap "
            f"{gap:+.2f}, need >= {CONV_FLOOR_DB} and within {CONV_TWIN_DB}); routes {routes}, "
            f"the scales' backward kernels {scales}"
            + ("; tiny: A' is the only kernel of a step, the matching prior takes its plain "
               "direct path (no banded or block kernel), as in the JAX package, and JAX's "
               f"CPU run reaches {CONV_JAX_CPU_DB} dB (not a bar)" if recipe == "tiny" else "")
            + f"; {card}")
        check_train_steps(label, k["per_step"], recipe,
                          plain_ok=("cosine_prior",) if recipe == "tiny" else ())
        if recipe != "tiny" and render_plain:
            raise AssertionError(f"{label}: plain versions ran on CUDA in the render: "
                                 f"{render_plain}")
        if not (k["psnr"] >= CONV_FLOOR_DB and abs(gap) <= CONV_TWIN_DB):
            raise AssertionError(f"{label}: {k['psnr']:.2f} dB, all-plain {p['psnr']:.2f}")
        del res, k, p
        torch.cuda.empty_cache()
    return out


def convergence_full(torch, seed, tree, counters, ckpt, card, steps=CONV_FULL_STEPS):
    """Phase 22 (b): `python -m matchnerf_tpu_torch.train --config train|
    train_fast` (`build_coach` + `train_model`) at full width on phase 12's
    DTU tree from the written GMFlow checkpoint, `steps` steps, the
    validation image (view 24) rendered before the first step and after
    the last and no other hook; on the kernels and again all-plain
    (`build_coach(kernel=False)`) from the same seed. Held: each kernel
    run's validation PSNR rises by CONV_FULL_GAIN_DB and ends within
    CONV_TWIN_DB of the all-plain run's; the mean loss of its last
    CONV_LOSS_WINDOW steps is at most half that of its first; A' and B'
    (train.yaml) or B' / D' as the route names (train_fast.yaml) on every
    step, no plain version on CUDA."""
    from matchnerf_tpu_torch import kernels
    from matchnerf_tpu_torch.train import build_coach
    runs_dir = os.path.join(tree["work"], "conv_runs")
    epochs = next(e for e in range(-(-steps // CONV_FULL_EPOCH), steps + 1) if steps % e == 0)
    out = {}
    for label in ("train", "train_fast"):
        res = {}
        for route in ("kernel", "plain"):
            argv = loop_args(label, f"conv_{label}_{route}", runs_dir, tree["root"],
                             tree["meta"], steps // epochs,
                             **{"encoder.pretrain_weight": ckpt, "seed": seed,
                                "max_epoch": epochs, "freq.val_it": -1, "freq.test_ep": -1,
                                "freq.ckpt_it": -1, "freq.ckpt_ep": -1})
            coach = build_coach(argv, kernel=route == "kernel")
            steps_rec = kernels.record_steps(coach)
            psnrs, val_s = [], []
            for c in counters.values():
                c.reset()
            for when in ("before", "train", "after"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if when == "train":
                    coach.train_model()
                else:
                    psnrs.append(float(np.mean(coach.validate_model(iteration=coach.it)["PSNR"])))
                torch.cuda.synchronize()
                if when == "train":
                    wall = time.perf_counter() - t0
                else:
                    val_s.append(time.perf_counter() - t0)
            with open(coach.scalars_path) as f:
                losses = [json.loads(line)["loss_render"] for line in f
                          if json.loads(line)["split"] == "train"]
            first = float(np.mean(losses[:CONV_LOSS_WINDOW]))
            last = float(np.mean(losses[-CONV_LOSS_WINDOW:]))
            by_step = [" ".join(route_scales(st["route"])) for st in steps_rec]
            scales = sorted(set(by_step))
            shares = {k: by_step.count(k) for k in scales}
            totals = {n: sum(st["launches"][n] for st in steps_rec) for n in counters}
            res[route] = {"steps": len(losses), "epochs": epochs, "psnr_db": psnrs,
                          "gain_db": psnrs[1] - psnrs[0], "loss_first": first,
                          "loss_last": last, "loss_ratio": last / first,
                          "losses_at": {n: losses[n - 1] for n in (1, steps // 4, steps // 2,
                                                                   3 * steps // 4, steps)},
                          "wall_s": wall, "steps_per_s": len(losses) / wall,
                          "validation_s": val_s, "scale_kernels": scales,
                          "scale_steps": shares,
                          "launches": totals, "card": card}
            log(f"convergence {label}.yaml full width ({route}): {len(losses)} steps in "
                f"{wall:.1f} s ({len(losses) / wall:.2f} steps/s, {epochs} epochs), validation "
                f"view 24 {psnrs[0]:.2f} -> {psnrs[1]:.2f} dB ({psnrs[1] - psnrs[0]:+.2f}; "
                f"{val_s[0]:.1f} / {val_s[1]:.1f} s), mean loss of the first / last "
                f"{CONV_LOSS_WINDOW} steps {first:.5f} / {last:.5f} (x{last / first:.3f}), the "
                f"scales' backward kernels {scales} (steps at each: {shares}), launches in "
                "the steps "
                + str({n: v for n, v in totals.items() if v}) + f"; {card}")
            if len(losses) != steps or not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"convergence {label} ({route}): losses {losses}")
            if route == "kernel":
                check_train_steps(f"convergence {label}.yaml full width", steps_rec, label)
            del coach
            torch.cuda.empty_cache()
        k, p = res["kernel"], res["plain"]
        gap = k["psnr_db"][1] - p["psnr_db"][1]
        res["psnr_gap_db"] = gap
        log(f"convergence {label}.yaml full width: kernels {k['psnr_db'][1]:.2f} dB vs "
            f"all-plain {p['psnr_db'][1]:.2f} (gap {gap:+.2f}, need within {CONV_TWIN_DB}); "
            f"rise {k['gain_db']:+.2f} dB (all-plain {p['gain_db']:+.2f}; need >= "
            f"{CONV_FULL_GAIN_DB}); loss x{k['loss_ratio']:.3f} (all-plain "
            f"x{p['loss_ratio']:.3f}; need <= 0.5)")
        if not (k["gain_db"] >= CONV_FULL_GAIN_DB and abs(gap) <= CONV_TWIN_DB
                and k["loss_ratio"] <= 0.5):
            raise AssertionError(f"convergence {label}.yaml full width: {res}")
        out[label] = res
    return out


def convergence_phase(torch, dev, seed, tree, counters):
    """Phase 22: the training recipe learns. (a) `convergence_small`; (b)
    `convergence_full` on phase 12's tree. Each part's seconds under
    "part_s"."""
    from matchnerf_tpu_torch.config import dtu_train_config
    t_phase = time.perf_counter()
    card = card_line()
    out, parts = {}, {}
    t0 = time.perf_counter()
    out["small"] = convergence_small(torch, dev, seed, card)
    parts["small"] = time.perf_counter() - t0
    log(f"convergence: (a) in {parts['small']:.1f} s")
    t0 = time.perf_counter()
    ckpt = os.path.join(tree["work"], "conv_gmflow.pth")
    write_gmflow_checkpoint(torch, dtu_train_config(), seed, ckpt)
    out["full"] = convergence_full(torch, seed, tree, counters, ckpt, card)
    parts["full"] = time.perf_counter() - t0
    log(f"convergence: (b) in {parts['full']:.1f} s")
    out["part_s"] = parts
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"convergence phase: {out['phase_s']:.1f} s; {card}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm render of each path")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this test runs on an NVIDIA GPU only")
    sys.path.insert(0, REPO)
    import torch.nn.functional as F

    from matchnerf_tpu_torch import camera, kernels
    from matchnerf_tpu_torch.config import (dtu_eval_config, dtu_eval_per_ray_config,
                                            test_video_own_config)
    from matchnerf_tpu_torch.models.matchnerf import (init_matchnerf,
                                                      project_to_views,
                                                      query_cond_info,
                                                      sample_depth)
    from matchnerf_tpu_torch.ops import block_cosine_prior as kd
    from matchnerf_tpu_torch.ops import cosine_prior as kb
    from matchnerf_tpu_torch.ops import decoder as kc
    from matchnerf_tpu_torch.ops import fused_cosine as kf
    from matchnerf_tpu_torch.ops import supercell_color as ke
    from matchnerf_tpu_torch.ops import window_attention as ka
    from matchnerf_tpu_torch.ops.attention import shift_region_ids
    from matchnerf_tpu_torch.renderer import Renderer, extract_poses

    # ---- 1. device
    dev = torch.device(DEVICE)
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: off for matmuls and cuDNN (torch.backends.cuda.matmul.allow_tf32 "
        "= torch.backends.cudnn.allow_tf32 = False)")
    from matchnerf_tpu_torch import hostio
    t0 = time.perf_counter()
    hostio.library()
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels.library()
    tree_pool, ibr_trees = start_ibrnet_trees()      # phase 14's trees, meanwhile
    jpeg_pool, host_jpegs = start_host_jpegs()       # phase 13's T&T tree, phase 17's JPEGs
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(kernels.NVCC_FLAGS)}); host library (csrc/image_io.cpp, "
        f"{hostio.compiler()} {' '.join(hostio.CXX_FLAGS)}) built before it in {host_s:.1f} s")

    # ---- 2. scene and model
    cfg = dtu_eval_config()
    per_ray_cfg = dtu_eval_per_ray_config()
    t0 = time.perf_counter()
    batch = make_scene(args.seed)
    log(f"scene: {H}x{W}, 3 source views + target, near/far {DTU_NEAR_FAR}, "
        f"{time.perf_counter() - t0:.1f} s")
    model = init_matchnerf(cfg, torch.Generator().manual_seed(args.seed)).to(dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {n_params} parameters, "
        f"{cfg.encoder.num_transformer_layers} transformer layers, "
        f"precision {dict(cfg.precision)}")
    renderer = Renderer(cfg, model, dev)
    plain_renderer = Renderer(cfg, model, dev, kernel=False)
    per_ray_renderer = Renderer(per_ray_cfg, model, dev)

    # ---- 3. kernel phases at the main path's shapes
    res = {}
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    with torch.no_grad():
        # A: 2 * B * P = 6 streams of the 64x80 1/8-scale map, 2x2 windows
        rid = shift_region_ids(64, 80, 2, device=dev)
        for dt, tol, lse_tol in ((torch.bfloat16, 3e-2, 2e-2), (torch.float32, 1e-4, 1e-3)):
            q, k, v = (torch.randn(24, 1280, 128, generator=gen, device=dev).to(dt)
                       for _ in range(3))
            got = ka.window_attention(q, k, v, rid)
            ref = ka.window_attention_plain(q, k, v, rid)
            # the training forward's logsumexp against the plain masked scores
            lse = ka.window_attention_forward(q, k, v, rid, with_lse=True)[1]
            lse_err = max_abs(lse, torch.logsumexp(ka.attention_scores_plain(q, k, rid), -1))
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            tol_abs = tol * max(1.0, float(ref.float().abs().max()))
            ms = cuda_ms(torch, lambda: ka.window_attention(q, k, v, rid), 50)
            lse_ms = cuda_ms(torch, lambda: ka.window_attention_forward(q, k, v, rid, True), 50)
            plain_ms = cuda_ms(torch, lambda: ka.window_attention_plain(q, k, v, rid), 5)
            # library yardstick: SDPA with the -100 region mask as a float mask
            rows = rid[torch.arange(24, device=dev) % rid.shape[0]]
            mask = torch.where(rows[:, :, None] != rows[:, None, :], -100.0, 0.0)
            mask = mask[:, None].to(dt)
            lib = lambda: F.scaled_dot_product_attention(q[:, None], k[:, None],
                                                         v[:, None], attn_mask=mask)
            lib_err = float((lib()[:, 0].float() - ref.float()).abs().max())
            lib_ms = cuda_ms(torch, lib, 50)
            lib_kernels = kernel_names(torch, lib)
            del mask
            name = str(dt).replace("torch.", "")
            flops = 4 * 24 * 1280 * 1280 * 128
            b_ms, b_by = bound(nbytes(q, k, v, got, rid), flops, name, TC_FLOPS)
            log(f"kernel A window_attention {name} [24,1280,128] shift-masked: "
                f"max|d| {err:.3e} (tol {tol_abs:.3e}), {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                f"TFLOP/s); with the logsumexp {lse_ms:.4f} ms, lse max|d| {lse_err:.3e} (tol "
                f"{lse_tol:g}); plain {plain_ms:.3f} ms, library SDPA {lib_ms:.4f} ms (max|d| "
                f"{lib_err:.3e}), bound {b_ms:.4f} ms ({b_by}, at {TC_FLOPS[name] / 1e12:.0f} "
                f"TFLOP/s); SDPA's kernels {lib_kernels}")
            check_close(f"window_attention {name}", err, tol_abs)
            check_close(f"window_attention {name} logsumexp", lse_err, lse_tol)
            res[f"A_{name}"] = dict(max_abs_err=err, ms=ms, lse_ms=lse_ms, lse_max_abs_err=lse_err,
                                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                    library_ms=lib_ms, library_max_abs_err=lib_err,
                                    library_kernels=lib_kernels)
            del q, k, v, got, ref, lse

        # B, D, E and C on the first 20480 rays of the target view, real tables
        ref_images = renderer.tensor(batch["images"][:, :3])
        feats = renderer.encode(ref_images)
        tables = renderer.build_tables(ref_images, feats)
        poses = extract_poses(batch)
        scale_hws = [(t.shape[2], t.shape[3]) for t in tables["view_feats"]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block_ut, color_ut = renderer.pose_prep(poses, scale_hws, H, W, measure_color=True)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        log(f"pose_prep: block_ut {block_ut}, color_ut {color_ut} "
            f"(whole image, {prep_s:.4f} s)")
        if block_ut is None or None in block_ut or color_ut is None:
            raise AssertionError("the scene's pose does not take the block route at "
                                 f"both scales and for colour: {block_ut}, {color_ut}")
        R = SLICE_RAYS
        pix = camera.pixel_grid(H, W, legacy=True, device=dev)[:R][None]
        tgt_intr = renderer.tensor(poses["tgt"]["intrinsics"])
        c2w = renderer.tensor(renderer.prepare_target(poses["tgt"]["extrinsics"]))
        tgt_nf = renderer.tensor(poses["tgt"]["near_fars"])
        ref_w2c = renderer.tensor(poses["ref"]["extrinsics"][..., :3, :])
        ref_intr = renderer.tensor(poses["ref"]["intrinsics"])
        ref_nf = renderer.tensor(poses["ref"]["near_fars"])
        center, ray = camera.get_center_and_ray(pix, tgt_intr, c2w)
        depth = sample_depth(cfg, tgt_nf, 1, R)
        pts = camera.get_3d_points_from_depth(center, ray, depth, multi_samples=True)
        grids = (project_to_views(pts, ref_w2c, ref_intr, ref_nf, H, W)[..., :2]
                 * 2.0 - 1.0)[:, 0].contiguous()                     # [V,R,S,2]
        S = grids.shape[2]
        N = R * S
        for key in ("B", "D"):
            res[key] = []
        for s, G in enumerate(cfg.encoder.cos_n_group):
            table = tables["view_feats"][s][0]
            scales = tables["view_feat_scales"][s][0]
            out_b = kb.cosine_prior(table, grids, scales, G)
            flops = prior_flops(N, scaled=True)
            b_ms, b_by = bound(nbytes(table, grids, scales, out_b), flops)
            for key, fn, plain in (
                    ("B", lambda: kb.cosine_prior(table, grids, scales, G),
                     lambda: kb.cosine_prior_plain(table, grids, scales, G)),
                    ("D", lambda: kd.block_cosine_prior(table, grids, scales, G, block_ut[s]),
                     lambda: kd.block_cosine_prior_plain(table, grids, scales, G,
                                                         block_ut[s]))):
                got, ref = fn(), plain()
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                ms = cuda_ms(torch, fn, 10)
                plain_ms = cuda_ms(torch, plain, 3)
                entry = dict(scale=s, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by)
                extra = ""
                if key == "D":
                    gp = kd.pad_rays(grids)
                    h, w = scale_hws[s]
                    # the kernel builds its unions itself: only the plain
                    # twin's torch build is timed apart
                    entry["plain_union_ms"] = cuda_ms(
                        torch, lambda: kd.block_unions(gp, h, w, block_ut[s]), 10)
                    entry["union_size"] = kd.block_union_size_raw(gp, h, w)
                    entry["ut"] = block_ut[s]
                    entry["max_abs_err_vs_kernel_b"] = float((got - out_b).abs().max())
                    entry["device_kernels"] = only_kernel(torch, fn, "block_cosine_prior")
                    extra = (f", union {entry['union_size']} rows (bucket {block_ut[s]}), "
                             f"the plain twin's torch union build {entry['plain_union_ms']:.3f} "
                             f"ms, max|d| vs kernel B {entry['max_abs_err_vs_kernel_b']:.3e}, "
                             f"device kernels of the call {entry['device_kernels']}")
                log(f"kernel {key} {'block_' if key == 'D' else ''}cosine_prior scale {s} "
                    f"table {list(table.shape)} int8 G={G} R={R} S={S}: max|d| {err:.3e} "
                    f"(tol 1e-4), {ms:.3f} ms vs plain {plain_ms:.3f} ms, "
                    f"bound {b_ms:.4f} ms ({b_by}){extra}")
                check_close(f"{key} scale {s}", err, 1e-4)
                if key == "D":      # pins the union build, shared by D and its plain twin
                    check_close(f"D vs B scale {s}", entry["max_abs_err_vs_kernel_b"], 1e-4)
                res[key].append(entry)
            del out_b, got, ref

        csc = tables["colors_sc"][0]
        e_fn = lambda: ke.supercell_color_sample(csc, grids, H, W)
        e_plain = lambda: ke.supercell_color_sample_plain(csc, grids, H, W)
        got, ref = e_fn(), e_plain()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        # 9 flops per (sample, view, colour): two y blends and one x blend
        b_ms, b_by = bound(nbytes(csc, grids, got), N * 3 * 3 * 9)
        # library yardstick: F.grid_sample (bilinear, border, align_corners)
        # on the source images as f32 on the 0-255 scale, [V,3,R,S]
        img_f = tables["colors"][0].permute(0, 3, 1, 2).float().contiguous()
        lib = lambda: F.grid_sample(img_f, grids, mode="bilinear", padding_mode="border",
                                    align_corners=True)
        lib_err = float((lib().permute(2, 3, 0, 1).reshape(R, S, -1) - ref).abs().max())
        res["E"] = dict(max_abs_err=err, ms=cuda_ms(torch, e_fn, 50),
                        plain_ms=cuda_ms(torch, e_plain, 3), bound_ms=b_ms, bound_by=b_by,
                        library_ms=cuda_ms(torch, lib, 50), library_max_abs_err=lib_err)
        e = res["E"]
        log(f"kernel E supercell_color table {list(csc.shape)} uint8 R={R} S={S}: "
            f"max|d| {err:.3e} (tol 1e-5, 0-255 scale), {e['ms']:.4f} ms vs plain "
            f"{e['plain_ms']:.3f} ms, library grid_sample {e['library_ms']:.4f} ms "
            f"(max|d| {lib_err:.3e}, tol 1e-3), bound {b_ms:.4f} ms ({b_by})")
        check_close("supercell_color", err, 1e-5)
        check_close("supercell_color vs F.grid_sample", lib_err, 1e-3)
        del got, ref, img_f

        cond, ndc0 = query_cond_info(cfg, pts, ref_w2c, ref_intr, ref_nf, tables, H, W,
                                     block_ut=block_ut, color_ut=color_ut)
        ray_unit = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
        ray_ref = (ray_unit @ ref_w2c[:, 0, :3, :3].transpose(-1, -2))[:, :, None] \
            .expand(*pts.shape[:3], 3).contiguous()
        res["C"] = decoder_case(torch, kc, dev, (model.nerf_dec, cfg, ndc0.contiguous(), ray_ref,
                                                 cond, depth, ray), "DTU slice")
        del cond, pts
        # configs/test_video_own.yaml's decoder (ELU, maskfill, posenc) at S=256
        # on one 5012-ray slice of the view, through Kernel B and the colour gather
        own = test_video_own_config()
        vcfg = copy.deepcopy(cfg)
        vcfg.decoder.update({k: own.decoder[k] for k in ("raytrans_posenc", "density_maskfill",
                                                         "raytrans_act")})
        vcfg.nerf.sample_intvs = own.nerf.sample_intvs
        Rv = int(own.nerf.rand_rays_test)
        vray = ray[:, :Rv]
        vdepth = sample_depth(vcfg, tgt_nf, 1, Rv)
        vpts = camera.get_3d_points_from_depth(center[:, :Rv], vray, vdepth, multi_samples=True)
        vcond, vndc0 = query_cond_info(vcfg, vpts, ref_w2c, ref_intr, ref_nf, tables, H, W)
        vref = ray_ref[:, :Rv, :1].expand(*vpts.shape[:3], 3).contiguous()
        # the decoder built for the variant (out_alpha_linear's activation
        # is part of the module)
        vdec = init_matchnerf(vcfg, torch.Generator().manual_seed(args.seed)).nerf_dec
        vdec = vdec.to(dev).eval()
        res["C_S256"] = decoder_case(torch, kc, dev, (vdec, vcfg, vndc0.contiguous(), vref,
                                                      vcond, vdepth, vray), "test_video_own")
        del vcond, vpts, vndc0, vref, vdec
        fused_kernel_phase(torch, cfg, feats, ref_images, tables, grids, res)
        int4_kernel_phase(torch, cfg, feats, plain_renderer.encode(ref_images), ref_images,
                          grids, res)
        bf16_kernel_phase(torch, cfg, feats, ref_images, grids, block_ut, res)
        del feats, tables, grids

    # ---- 4. the block path (configs/test.yaml as shipped), 5. per-ray, 6. fused
    counters = kernels.counters()
    n_rays = H * W

    def drive(name, r, must_launch):
        for c in counters.values():
            c.reset()
        t = {}
        out = r.forward(batch, mode="test", timings=t)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        plain_cuda = {k: c.plain_on_cuda for k, c in counters.items()}
        log(f"{name} path: Renderer.forward {H}x{W} S={r.cfg.nerf.sample_intvs}, "
            f"{r.rays_per_slice(1)} rays/slice, route {r.last_route}: encode "
            f"{t['encode']:.4f} s, tables {t['tables']:.4f} s, render {t['render']:.4f} s "
            f"(pose_prep {t.get('pose_prep', 0.0):.4f} s of it), "
            f"{n_rays / t['render']:.0f} rays/s (render), "
            f"{n_rays / (t['encode'] + t['tables'] + t['render']):.0f} rays/s "
            f"(encode+tables+render)")
        log(f"{name} path: launches {launches}, plain versions on CUDA {plain_cuda}")
        for k in must_launch:
            if launches[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched on the {name} path")
        if any(plain_cuda.values()):
            raise AssertionError(f"plain versions ran on CUDA tensors: {plain_cuda}")
        rgb = out["rgb"]
        if tuple(rgb.shape) != (1, n_rays, 3) or tuple(out["depth"].shape) != (1, n_rays, 1):
            raise AssertionError(f"output shapes {tuple(rgb.shape)} {tuple(out['depth'].shape)}")
        for k, v in out.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"non-finite {k}")
        if not (float(rgb.min()) >= -1e-6 and float(rgb.max()) <= 1.0 + 1e-6):
            raise AssertionError(f"rgb outside [0,1]: {float(rgb.min())} {float(rgb.max())}")
        return out, t, launches

    torch.cuda.reset_peak_memory_stats()
    out, timings, block_launches = drive(
        "block", renderer, ["window_attention", "cond_nerf_decode", "block_cosine_prior",
                            "supercell_color"])
    if None in renderer.last_route["block_ut"] or renderer.last_route["color_ut"] is None:
        raise AssertionError(f"block path route {renderer.last_route}")
    block_rgb = out["rgb"].cpu()          # phase 16 (c) holds its ranks' images to it
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    plain_t = {}
    plain_out = plain_renderer.forward(batch, mode="test", timings=plain_t)
    torch.cuda.synchronize()
    agreement = psnr(out["rgb"], plain_out["rgb"])
    depth_err = float((out["depth"] - plain_out["depth"]).abs().max())
    log(f"block path, all plain: encode {plain_t['encode']:.4f} s, tables "
        f"{plain_t['tables']:.4f} s, render {plain_t['render']:.4f} s, "
        f"{n_rays / plain_t['render']:.0f} rays/s (render)")
    log(f"block path: agreement PSNR kernels vs plain {agreement:.2f} dB (need >= 50), "
        f"max|d| depth {depth_err:.3e}, rgb mean {float(out['rgb'].mean()):.4f}, "
        f"opacity mean {float(out['opacity'].mean()):.4f}, peak device memory "
        f"{peak_gib:.2f} GiB")
    if not agreement >= 50.0:
        raise AssertionError(f"agreement PSNR {agreement:.2f} dB < 50")
    del plain_out

    ray_out, ray_t, ray_launches = drive(
        "per-ray", per_ray_renderer, ["window_attention", "cosine_prior", "cond_nerf_decode"])
    if kc.COUNTER.by_entry != {"cond_nerf_decode_f32": ray_launches["cond_nerf_decode"]}:
        raise AssertionError(f"per-ray path: Kernel C routes {kc.COUNTER.by_entry}")
    vs_ray = psnr(out["rgb"], ray_out["rgb"])
    log(f"block path vs per-ray path: PSNR {vs_ray:.2f} dB (need >= 60)")
    if not vs_ray >= 60.0:
        raise AssertionError(f"block vs per-ray PSNR {vs_ray:.2f} dB < 60")

    # the per-ray path with precision.decoder_matmul_dtype: bf16 (Kernel C's
    # bf16 route), against its all-plain render (the bf16 plain twin)
    bf_cfg = dtu_eval_per_ray_config()
    bf_cfg.precision.decoder_matmul_dtype = "bf16"
    bf_renderer = Renderer(bf_cfg, model, dev)
    bf_out, bf_t, bf_launches = drive(
        "per-ray bf16 decoder", bf_renderer, ["window_attention", "cosine_prior",
                                              "cond_nerf_decode"])
    bf_routes = dict(kc.COUNTER.by_entry)
    if bf_routes != {"cond_nerf_decode_bf16": bf_launches["cond_nerf_decode"]}:
        raise AssertionError(f"bf16 decoder path: Kernel C routes {bf_routes}")
    bf_plain = Renderer(bf_cfg, model, dev, kernel=False).forward(batch, mode="test")
    bf_vs_plain = psnr(bf_out["rgb"], bf_plain["rgb"])
    bf_vs_f32 = psnr(bf_out["rgb"], ray_out["rgb"])
    log(f"per-ray bf16 decoder path: agreement PSNR kernels vs all-plain (bf16 twin) "
        f"{bf_vs_plain:.2f} dB (need >= 50); vs the f32 per-ray render {bf_vs_f32:.2f} dB; "
        f"Kernel C launches by route {bf_routes}")
    if not bf_vs_plain >= 50.0:
        raise AssertionError(f"bf16 decoder agreement PSNR {bf_vs_plain:.2f} dB < 50")
    del bf_plain

    fused_cfg = dtu_eval_config()
    fused_cfg.precision.fused_cosine = True
    fused_renderer = Renderer(fused_cfg, model, dev)
    fused_out, fused_t, fused_launches = drive(
        "fused", fused_renderer, ["window_attention", "cond_nerf_decode", "fused_cosine"])
    n_slices = math.ceil(n_rays / fused_renderer.rays_per_slice(1))
    if (fused_launches["fused_cosine"] != 2 * n_slices or fused_launches["cosine_prior"]
            or fused_launches["block_cosine_prior"]):
        raise AssertionError(f"fused path: F {fused_launches['fused_cosine']} launches "
                             f"(expected {2 * n_slices}), B {fused_launches['cosine_prior']} "
                             f"and D {fused_launches['block_cosine_prior']} (expected 0)")
    vs_fused = psnr(out["rgb"], fused_out["rgb"])
    log(f"fused path vs block path: PSNR {vs_fused:.2f} dB (need >= 60); render rays/s: "
        f"fused {n_rays / fused_t['render']:.0f}, block {n_rays / timings['render']:.0f}, "
        f"per-ray {n_rays / ray_t['render']:.0f}")
    if not vs_fused >= 60.0:
        raise AssertionError(f"fused vs block PSNR {vs_fused:.2f} dB < 60")

    # the f32 encoder of configs/test_strict.yaml
    strict_cfg = dtu_eval_config()
    strict_cfg.precision.strict = True
    strict = strict_encode_phase(torch, model, strict_cfg,
                                 renderer.tensor(batch["images"][:, :3]), counters)
    del out, ray_out, fused_out, bf_out
    torch.cuda.empty_cache()

    # ---- 7. the video entry on the printer scene: its JPEGs against PIL's
    # hashes, configs/demo_own.yaml (fused cosine), then 8.
    # configs/test_video_own.yaml (S = 256, 960x640)
    printer = printer_check()
    video = video_phase(torch, dev, args.seed, counters, args.profile, "demo_own", VIDEO_FRAMES)
    torch.cuda.empty_cache()
    video_own = video_phase(torch, dev, args.seed, counters, args.profile, "test_video_own",
                            OWN_FRAMES, OWN_PLAIN_SLICES)
    torch.cuda.empty_cache()

    # ---- 9. training kernels at training shapes, then 10. and 11. the steps
    from matchnerf_tpu_torch.config import dtu_train_config, dtu_train_fast_config
    torch.cuda.empty_cache()
    train_kernel_phase(torch, F, dev, batch, args.seed, block_ut, res)
    none = {k: 0 for k in counters}
    recipes = (
        ("train", dtu_train_config, dict(none, window_attention=12, window_attention_bwd=12,
                                         cosine_prior=2, cosine_prior_bwd=2)),
        ("train_fast", dtu_train_fast_config,
         dict(none, window_attention=12, window_attention_bwd=12, block_cosine_prior_f32=2,
              block_cosine_prior_bwd=2)))
    train = {}
    for label, make_cfg, must in recipes:
        checks = {"bf16": first_step_check(torch, dev, make_cfg(), batch, args.seed,
                                           f"{label}.yaml bf16 policy", (1e-2, 0.5, 0.1))}
        cfg32 = make_cfg()
        cfg32.precision.encoder_compute_dtype = "float32"
        cfg32.precision.decoder_compute_dtype = "float32"
        checks["f32"] = first_step_check(torch, dev, cfg32, batch, args.seed,
                                         f"{label}.yaml f32 policy", (1e-4, 1e-3, 1e-4))
        torch.cuda.empty_cache()
        train[label] = train_path(torch, dev, make_cfg(), batch, args.seed, f"{label}.yaml",
                                  counters, must, args.profile)
        train[label]["first_step"] = checks
        torch.cuda.empty_cache()
    # warm train.yaml steps under the f32 policy (Kernel A and A' in f32)
    cfg32 = dtu_train_config()
    cfg32.precision.encoder_compute_dtype = "float32"
    cfg32.precision.decoder_compute_dtype = "float32"
    train["train_f32_policy"] = train_path(torch, dev, cfg32, batch, args.seed,
                                           "train.yaml f32 policy", counters, recipes[0][2],
                                           args.profile)
    torch.cuda.empty_cache()
    route = train["train_fast"]["route"]
    if route is None or None in route:
        raise AssertionError(f"train_fast.yaml: the pose must take D' at both scales: {route}")

    # ---- 12. the training loop (train.yaml, train_fast.yaml), preemption, resume
    loop = loop_phase(torch, dev, counters)
    torch.cuda.empty_cache()

    # ---- 13. the eval entry: configs/test.yaml over DTU, LLFF and Blender,
    # test_video.yaml, test_strict.yaml
    test_entry = eval_entry_phase(torch, dev, args.seed, host_jpegs)
    torch.cuda.empty_cache()

    # ---- 14. configs/train_ibrnet.yaml at 1008x756: the loop, the resume,
    # the first-step check with and without remat, A / A' / B' / C / D / E
    # at its shapes
    ibr = ibrnet_phase(torch, F, dev, args.seed, counters, ibr_trees)
    tree_pool.shutdown()
    torch.cuda.empty_cache()

    # ---- 15. the render server (configs/test.yaml as shipped) over HTTP
    served = serve_phase(torch, dev, model, batch, counters)
    torch.cuda.empty_cache()

    # ---- 16. the parallel layer: an NCCL world of one, two ranks on the card
    # (training and the ray-sharded render), the training entry as 2 processes
    tree = loop.pop("tree")               # phase 12's DTU tree, for phases 16 and 18
    parallel = parallel_phase(torch, dev, batch, args.seed, block_rgb, tree, counters)

    # ---- 17. the host's image I/O: decode and resize timings, the T&T
    # loader's seconds per sample, decode(encode(seeded image)) against PIL's,
    # progressive JPEGs against PIL's and through the COLMAP loader
    host_io = host_io_phase(test_entry["tnt_tree"], host_jpegs.result()[2])
    jpeg_pool.shutdown()
    host_io["printer"] = printer
    torch.cuda.empty_cache()

    # ---- 18. two to sixteen source views: B, B', D, D' and E at V = 2, 4,
    # 5, 6, 8, 10, 12 and 16, F at 5 to 16, the training entry at V = 2, 4,
    # 6, 8 and 10, the eval entry at V = 2, 4, 5, 8, 10 and 16, the fused
    # route at V = 8 and 10
    views = views_phase(torch, dev, args.seed, tree, counters)
    torch.cuda.empty_cache()

    # ---- 19. the variants config keys reach: Kernel F at V = 2 and 4, the
    # eval entry's image under each variant, the training entry's steps with
    # view_dep: false (traced) and the local radius, LPIPS on the card
    variants = variants_phase(torch, dev, args.seed, tree, counters)
    torch.cuda.empty_cache()

    # ---- 20. Kernel Cg, every decoder the TPU kernel takes: against its
    # plain twin on five decoders, the eval entry's image with the NeRF MLP
    # and with standard coordinates + GELU, 3 training steps and the render
    # of their checkpoint, and the shipped decoder still on Kernel C
    cg = cg_phase(torch, dev, args.seed, tree, counters)
    torch.cuda.empty_cache()

    # ---- 21. training repeats itself: two same-seed runs of train.yaml and
    # train_fast.yaml at V = 3 and of train.yaml at V = 8, bit for bit
    determinism = determinism_phase(torch, dev, args.seed, tree, counters)
    torch.cuda.empty_cache()

    # ---- 22. the convergence run: the small shape's three recipes on the
    # kernels and all-plain, then train.yaml and train_fast.yaml at full
    # width through the training entry
    conv = convergence_phase(torch, dev, args.seed, tree, counters)

    def per_scale(entries):
        return {"max_abs_err": max(e["max_abs_err"] for e in entries),
                "ms": sum(e["ms"] for e in entries),
                "plain_ms": sum(e["plain_ms"] for e in entries),
                "bound_ms": sum(e["bound_ms"] for e in entries),
                "bound_by": entries[0]["bound_by"], "scales": entries}

    def entry(name, r, launches, by_path, extra=None):
        c = counters[name]
        e = {"name": name, "route": "cuda", "source": c.source, "replaces": c.replaces,
             "launches": launches, "launches_by_path": by_path, "library_ms": None}
        e.update(r if "ms" in r else per_scale(r))
        e.update(extra or {})
        return e

    def bf16_entry(key, c_entry):
        """The bf16 form at the eval slice and the validation slice, and its
        launches per validation image (loop phase) and in the per-ray
        validation render."""
        by_r = {R: per_scale([e for e in res[f"{key}_bf16"] if e["R"] == R])
                for R in (SLICE_RAYS, VAL_RAYS)}
        name = "cosine_prior" if key == "B" else "block_cosine_prior"
        out = dict(by_r[SLICE_RAYS], **{f"R{VAL_RAYS}": by_r[VAL_RAYS]})
        out["launches_per_validation_image"] = {
            k: v["validation_routes"][key].get(c_entry, 0) for k, v in loop.items()
            if k != "preempt"}
        out["launches"] = max(out["launches_per_validation_image"].values())
        if key == "B":
            out["launches_per_ray_validation_image"] = loop["train"]["per_ray_b_bf16_launches"]
            out["launches"] = max(out["launches"], out["launches_per_ray_validation_image"])
        out.update(name=f"{name}_bf16", route="cuda", source=counters[name].source,
                   replaces=counters[name].replaces, library_ms=None)
        return out

    def eval_paths(name):
        return {"block": block_launches[name], "per_ray": ray_launches[name],
                "per_ray_bf16_decoder": bf_launches[name], "fused": fused_launches[name],
                f"video_{VIDEO_FRAMES}_frames": video["launches"][name],
                f"test_video_own_{OWN_FRAMES}_frames": video_own["launches"][name],
                **{f"test_entry_{k}": v["launches"][name] for k, v in test_entry["sets"].items()},
                **{f"test_video_{k}_{ENTRY_FRAMES}_frames": v["launches"][name]
                   for k, v in test_entry["video"].items()},
                "test_strict_dtu": test_entry["strict"]["launches"][name],
                "serve": served["launches"][name]}

    def by_test_set(name):
        """Device ms per launch and launches per image of one eval kernel
        in each test set's render of the eval entry (phase 13), with Kernel
        A's window shape and bound."""
        return {"test_entry": {k: dict(v["kernel_device_ms"].get(name) or {}, **(
            v["window_attention_shape"] if name == "window_attention" else {}))
            for k, v in test_entry["sets"].items()}}

    def train_paths(name):
        return {f"{k}_{TRAIN_STEPS}_steps": v["launches_total"][name] for k, v in train.items()}

    def ibr_paths(name):
        """Launches in the train_ibrnet run (phase 14) and in one of its
        1008x756 validation and LLFF test images."""
        return {f"train_ibrnet_loop_{IBR_STEPS}_steps": ibr["launches"][name],
                **{f"train_ibrnet_{k}_image": v["launches"][name]
                   for k, v in ibr["images"].items()}}

    def ibr_eval(name, slice_entry):
        """An eval kernel at train_ibrnet's shapes: its 23552-ray slice
        against the plain twin, and its device ms per launch in the
        1008x756 images."""
        return {"train_ibrnet": {"slice_23552": slice_entry, **{
            f"{k}_image": v["kernel_device_ms"].get(name) for k, v in ibr["images"].items()}}}

    def views_of(name):
        """The kernel at V = 2, 4, 5, 6, 8, 10, 12 and 16 (phase 18): each
        prior kernel and E against its plain twin with its bound, its
        launches in the V-view eval image (B, C, Cg, D, E, A; at V = 2, 4,
        5, 8, 10 and 16) or the V-view training run (A', B', D'; at V = 2, 8
        and 10), and each eval kernel's device ms per launch in the V-view
        image."""
        key = {"cosine_prior": "B", "cosine_prior_bwd": "B_bwd", "block_cosine_prior": "D",
               "block_cosine_prior_f32": "D_f32", "block_cosine_prior_bwd": "D_bwd",
               "supercell_color": "E"}.get(name)
        run = {"window_attention_bwd": "train", "cosine_prior_bwd": "train",
               "block_cosine_prior_f32": "train_fast",
               "block_cosine_prior_bwd": "train_fast"}.get(name)
        trains = {2: views["train"], MANY_TRAIN: views["train_many"],
                  WIDE_TRAIN: views["train_wide"]}
        out = {}
        for V in VIEW_COUNTS + MANY_VIEWS + WIDE_VIEWS:
            k, ev = views["kernels"][V], views["eval"].get(V)
            e = {"name": name, "V": V, "library_ms": None}
            if key:
                e.update(per_scale(k[key]))
            if key in ("B", "D"):
                e["bfloat16"] = per_scale(k[key + "_bf16"])
            if key == "B":
                e["f32_training_shapes"] = per_scale(k["B_f32"])
            if run:
                if V in trains:
                    e["launches"] = trains[V][run]["launches"][name]
                    e["launches_in"] = f"{run}.yaml V={V}, {VIEWS_STEPS} steps"
                    e["training_route"] = trains[V][run]["route"]
                else:
                    e["launches"] = None
                    e["launches_in"] = f"no training run at V={V}"
            elif ev is not None:
                e["launches"] = ev["launches"][name]
                e["launches_in"] = f"the eval entry's DTU image at V={V}"
                e["image_device_ms"] = ev["kernel_device_ms"].get(name)
            else:
                e["launches"] = None
                e["launches_in"] = f"no eval image at V={V}"
            out[f"V{V}"] = e
        return out

    def fused_views():
        """Kernel F at V = 2 and 4 (phase 19) and 5, 6, 8, 10, 12 and 16
        (phase 18): int8 rows as the entry, bf16 and f32 beside them, and
        its launches in the fused eval image at V = 2, 4, 8 and 10."""
        out = {}
        for V in VIEW_COUNTS + MANY_VIEWS + WIDE_VIEWS:
            k = variants["kernels"][V] if V in VIEW_COUNTS else views["kernels"][V]["F"]
            ev = (variants["eval"][f"fused_v{V}"] if V in VIEW_COUNTS
                  else views["eval_fused"].get(V))
            e = {"name": "fused_cosine", "V": V, "library_ms": None, **per_scale(k["int8"]),
                 "bfloat16": per_scale(k["bfloat16"]), "float32": per_scale(k["float32"]),
                 "launches": ev["launches"]["fused_cosine"] if ev else None,
                 "launches_in": (f"the eval entry's DTU image at V={V}, fused_cosine" if ev
                                 else f"no fused image at V={V}")}
            out[f"V{V}"] = e
        return out

    a_bwd = res["A_bwd"]
    par_paths = {"nccl_world_1_train_step": None, **parallel["launches"]}
    report = {"kernels": [
        entry("window_attention", res["A_bfloat16"], block_launches["window_attention"],
              dict(eval_paths("window_attention"), **train_paths("window_attention"),
                   **ibr_paths("window_attention")),
              {"f32": res["A_float32"],
               "training_forward_ms": {k: v["fwd_ms"] for k, v in a_bwd.items()},
               "train_ibrnet_L768": ibr["A"], **by_test_set("window_attention")}),
        entry("window_attention_bwd", a_bwd["bfloat16_shift"],
              train["train"]["launches_total"]["window_attention_bwd"],
              dict(train_paths("window_attention_bwd"), **ibr_paths("window_attention_bwd")),
              {"variants": a_bwd, "train_ibrnet_L768": ibr["A_bwd"]}),
        entry("cosine_prior", res["B"], ray_launches["cosine_prior"],
              dict(eval_paths("cosine_prior"), **train_paths("cosine_prior")),
              {"f32_training_shapes": per_scale(res["B_f32"]),
               "bfloat16": bf16_entry("B", "cosine_prior_bf16"), **by_test_set("cosine_prior")}),
        entry("cosine_prior_bwd", res["B_bwd"],
              train["train"]["launches_total"]["cosine_prior_bwd"],
              dict(train_paths("cosine_prior_bwd"), **ibr_paths("cosine_prior_bwd")),
              {"train_ibrnet_tables": ibr["B_bwd"]}),
        entry("cond_nerf_decode", res["C"]["float32"], block_launches["cond_nerf_decode"],
              dict(eval_paths("cond_nerf_decode"), **ibr_paths("cond_nerf_decode")),
              {"routes": {"S128": res["C"], "S256_test_video_own": res["C_S256"]},
               "setbg_launches_blender": test_entry["sets"]["blender"]["setbg_launches"],
               **by_test_set("cond_nerf_decode"),
               **ibr_eval("cond_nerf_decode", ibr["eval_slice"]["C"])}),
        entry("cond_nerf_decode_any", cg["kernels"][CG_DECODERS[0][0]]["float32"],
              cg["eval"]["nerf_mlp"]["launches"]["cond_nerf_decode_any"],
              dict(eval_paths("cond_nerf_decode_any"),
                   **{f"cg_eval_{k}": v["launches"]["cond_nerf_decode_any"]
                      for k, v in cg["eval"].items()},
                   **{f"cg_train_{CG_TRAIN_STEPS}_steps":
                      cg["train"]["launches"]["cond_nerf_decode_any"]}),
              {"decoders": cg["kernels"],
               "image_device_ms_per_launch": {
                   k: v["kernel_device_ms_per_launch"] for k, v in cg["eval"].items()
                   if v["kernel"] == "cond_nerf_decode_any"}}),
        entry("block_cosine_prior", res["D"], block_launches["block_cosine_prior"],
              dict(eval_paths("block_cosine_prior"), **ibr_paths("block_cosine_prior")),
              {"plain_union_ms": sum(s["plain_union_ms"] for s in res["D"]),
               "bfloat16": bf16_entry("D", "block_cosine_prior_bf16"),
               **by_test_set("block_cosine_prior"),
               **ibr_eval("block_cosine_prior", ibr["eval_slice"]["D"])}),
        entry("block_cosine_prior_f32", res["D_f32"],
              train["train_fast"]["launches_total"]["block_cosine_prior_f32"],
              train_paths("block_cosine_prior_f32"),
              {"plain_union_ms": sum(s["plain_union_ms"] for s in res["D_f32"])}),
        entry("block_cosine_prior_bwd", res["D_bwd"],
              train["train_fast"]["launches_total"]["block_cosine_prior_bwd"],
              train_paths("block_cosine_prior_bwd")),
        entry("supercell_color", res["E"], block_launches["supercell_color"],
              dict(eval_paths("supercell_color"), **ibr_paths("supercell_color")),
              dict(by_test_set("supercell_color"),
                   **ibr_eval("supercell_color", ibr["eval_slice"].get("E")))),
        entry("fused_cosine", res["F"]["int8"], video["launches"]["fused_cosine"],
              eval_paths("fused_cosine"),
              {"bfloat16": per_scale(res["F"]["bfloat16"]),
               "float32": per_scale(res["F"]["float32"]),
               "gather_ms": sum(e["gather_ms"] for e in res["F"]["int8"]),
               "max_abs_err_vs_kernel_b": max(e["max_abs_err_vs_kernel_b"]
                                              for e in res["F"]["int8"])}),
    ], "paths": {
        "block": {"encode_s": timings["encode"], "tables_s": timings["tables"],
                  "render_s": timings["render"],
                  "rays_per_s_render": n_rays / timings["render"],
                  "plain_render_s": plain_t["render"], "agreement_psnr_db": agreement,
                  "pose_prep_s": timings["pose_prep"], "route": renderer.last_route,
                  "peak_gib": peak_gib},
        "per_ray": {"encode_s": ray_t["encode"], "render_s": ray_t["render"],
                    "rays_per_s_render": n_rays / ray_t["render"],
                    "psnr_vs_block_db": vs_ray},
        "per_ray_bf16_decoder": {"render_s": bf_t["render"],
                                 "rays_per_s_render": n_rays / bf_t["render"],
                                 "agreement_psnr_db": bf_vs_plain, "psnr_vs_f32_db": bf_vs_f32},
        "fused": {"encode_s": fused_t["encode"], "render_s": fused_t["render"],
                  "rays_per_s_render": n_rays / fused_t["render"],
                  "pose_prep_s": fused_t["pose_prep"], "psnr_vs_block_db": vs_fused},
        "strict_f32_encode": strict,
        "video": {k: v for k, v in video.items() if k not in ("profile", "launches")},
        "test_video_own": {k: v for k, v in video_own.items()
                           if k not in ("profile", "launches")},
        "train": {k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                  for k, v in train.items()},
        "loop": loop,
        "test_entry": test_entry,
        "train_ibrnet": {k: v for k, v in ibr.items()
                         if k not in ("A", "A_bwd", "B_bwd", "eval_slice")},
        "serve": served,
        "parallel": {k: v for k, v in parallel.items() if k != "launches"},
        "host_io": host_io}}
    for e in report["kernels"]:
        if e["name"] != "fused_cosine":
            e["views"] = views_of(e["name"])
        else:
            e["views"] = fused_views()
        name = e["name"].replace("_bf16", "")
        if name in counters and not e["name"].endswith("_bf16"):
            for k, v in variants["eval"].items():
                e["launches_by_path"][f"variants_{k}"] = v["launches"][name]
            for k, v in variants["train"].items():
                e["launches_by_path"][f"variants_train_{k}_{VARIANT_STEPS}_steps"] = \
                    v["launches"][name]
            for V, v in views["eval"].items():
                e["launches_by_path"][f"views_eval_v{V}"] = v["launches"][name]
            for V, v in views["eval_fused"].items():
                e["launches_by_path"][f"views_fused_v{V}"] = v["launches"][name]
            for V, runs in ((2, views["train"]), (MANY_TRAIN, views["train_many"]),
                            *views["train_mid"].items(), (WIDE_TRAIN, views["train_wide"])):
                for k, v in runs.items():
                    e["launches_by_path"][f"views_{k}_v{V}_{VIEWS_STEPS}_steps"] = \
                        v["launches"][name]
            for k, v in determinism.items():
                if k != "phase_s" and name in v["launches"]:
                    e["launches_by_path"][f"determinism_{k}_{DET_STEPS}_steps"] = \
                        v["launches"][name]
            for k, v in conv["small"].items():
                e["launches_by_path"][f"convergence_{k}_{CONV_STEPS}_steps"] = \
                    v["kernel"]["launches"][name]
            for k, v in conv["full"].items():
                e["launches_by_path"][f"convergence_{k}_full_{v['kernel']['steps']}_steps"] = \
                    v["kernel"]["launches"][name]
    # Kernel B's int4 form: its own launcher in the wrapper of B; its
    # launches are those of the int4 entry in phase 19's int4 images
    int4_by_path = {f"variants_{k}": v["int4_launches"] for k, v in variants["eval"].items()
                    if v["int4_launches"]}
    report["kernels"].append(dict(
        per_scale(res["B_int4"]), name="cosine_prior_int4", route="cuda",
        source=counters["cosine_prior"].source,
        replaces=kb.INT4_REPLACES, launches=int4_by_path["variants_int4"],
        launches_in="phase 19's int4 DTU entry image (both scales)",
        launches_by_path=int4_by_path, library_ms=None))
    report["paths"]["views"] = {k: views[k] for k in ("train", "eval", "many_tree",
                                                       "eval_fused", "train_many", "train_mid",
                                                       "wide_tree", "train_wide", "part_s",
                                                       "phase_s")}
    report["paths"]["variants"] = {k: v for k, v in variants.items() if k != "kernels"}
    report["paths"]["decoder_any"] = {k: v for k, v in cg.items() if k != "kernels"}
    report["paths"]["determinism"] = determinism
    report["paths"]["convergence"] = conv
    # each kernel's launches in each rank of phase 16, per path
    for e in report["kernels"]:
        name = e["name"].replace("_bf16", "")
        if name in counters and not e["name"].endswith("_bf16"):
            e["launches_by_path"]["parallel"] = {
                path: (parallel["nccl_world_1"]["launches"][name] if ranks is None
                       else [r[name] for r in ranks])
                for path, ranks in par_paths.items()}
    if args.profile:
        report["profile"] = {"train": train["train"]["profile"],
                             "train_fast": train["train_fast"]["profile"],
                             "video": video["profile"],
                             "test_video_own": video_own["profile"]}
        report["profile"].update({
            "block": profile_call(torch, "block", lambda: renderer.forward(batch, mode="test")),
            "per_ray": profile_call(torch, "per-ray",
                                    lambda: per_ray_renderer.forward(batch, mode="test")),
            "per_ray_bf16_decoder": profile_call(
                torch, "per-ray bf16 decoder", lambda: bf_renderer.forward(batch, mode="test")),
            "fused": profile_call(torch, "fused",
                                  lambda: fused_renderer.forward(batch, mode="test"))})
    log(card_line())
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
