"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Checks, in order, and exits nonzero at the first failure (printing no
result line):

1. the card (nvidia-smi name and power limit) and the torch, CUDA, nvcc
   and Triton versions;
2. builds the hand kernels from ``diffdope_tpu_torch/csrc`` (one nvcc per
   source, in parallel, sm_90a) and reports the build time;
3. holds each kernel (K1 pack fwd, K2 pack bwd, K3 raster fwd, K4 raster
   bwd, K5 loss fwd, K6 loss bwd, and the spanning op's bf16 d_rows lane
   of K6 and K4; K7 uniform raster fwd and bwd on the uniform-K table;
   K5/K6 with the depth lane) against its plain torch version on the card,
   at the test scene and at the bench shapes, each hypothesis at a pose of
   its own (K1 bit for bit in all 32 lanes, K3 and K7 ids, slots and rows
   exactly), and times both at the bench shapes; and K3, K7, K8 and K9 at
   a sliver of the default configuration's frame, whose f32 planes cover a
   pixel 8 rows past its vertex bounds (``sliver_checks``: each kernel
   stages by the boxes its planes give, the pixel is the sliver's as in
   the plain twins);
4. drives the bench main path: the bench protocol (B=64, 400x400,
   icosphere(5), rgb+mask, 100 Adam steps) through ``make_fused_loss`` +
   ``refine``, with every launch counter reset just before and read just
   after: K1, K2, K3, K5 and the bf16 lane of K6 and K4 launched (the
   default ``DD_DROWS_BF16``), their f32 instantiations not, every table
   packed by K1 (pack_fwd == raster_fwd); the loss must be finite and
   fall, the best hypothesis must end closer to the gt pose (ADD) than it
   started, and no step may drop bin slots or leak out of the ROI crop;
   at the init the bf16 lane's pose gradients agree with the f32 lane's
   within the contract's bf16 clause (atol 2e-2 of scale);
5. drives ``DiffDope(cfg).run_optimization()`` at the default
   configuration's full size (``DEFAULT_CONFIG``: configs/diffdope.yaml
   with the in-repo stand-in mesh; 960x540, B=8, 61 SGD steps, mask L1),
   the scene the port's own render at the configured pose, the init
   ``INIT_OFFSET`` away: the fused route through K1-K5 and the bf16 lane
   of K6/K4, no overflow or
   crop leak left in the kept run (after at most one recovery re-run,
   logged), the loss falls, ``get_pose()`` ends closer to the gt pose
   (ADD) than the init, and K1-K6 agree with their plain versions on the
   kept run's tables at its last poses;
6. the same with ``tpu.fused_loss: false`` (the unfused render_batch
   route): K1-K4 launched, K5/K6 not, K1-K4 agree with their plain
   versions on its full-frame tables, its step-0 losses equal the fused
   run's at rtol 1e-5, and the loss falls;
7. ``DiffDope`` at the default configuration with the depth loss
   (``losses.l1_depth_with_mask: true``, mask + depth L1) on the fused
   compact route: K1-K4 and K5/K6 with the depth plane launched, K7 and
   the rgb+mask K5/K6 not; the criteria of phase 5; K1-K6 agree with their
   plain versions on its tables; its step-0 'mask_selection' and 'depth'
   logs equal one unfused ``render_batch`` + the loss functions at the
   init, rtol 1e-5;
8. the same with ``tpu.compact_bins: false`` (the uniform-K table, full
   frame): K1, K2, K7 and K5/K6 with the depth plane launched, K3/K4 not;
   the criteria of phase 5; K1, K2, K7, K5, K6 agree with their plain
   versions on its tables, and K7 also on its unfused render's tables;
   its step-0 logs equal phase 7's and, at the init, those of phase 7's
   loss with its ROI crop (on even where the kept run dropped it after a
   leak; no leak there), so the crop is loss-exact; and at the init the
   cropped compact table and the uniform table hold the same slots per
   tile in the same order, and K2 gives the two tables the same sums bit
   for bit under one cotangent on their live slots (timed on each); the
   two runs take the same poses (``mtx_history``) at every step, bit for
   bit (F3), and both final losses and ADDs are printed; where they part,
   the first step and hypothesis, and which stage of the gradients at the
   poses before (the live slots, their cotangents, d_mvp, d_mtx);
9. the nvdiffrast-style API path at the default configuration's frame
   (960x540, B=8 distinct poses around phase 5's init, the stand-in mesh):
   ``xfm_points`` -> ``rasterize(impl='pallas')`` (K8, tile 32x128, K from
   the fullest tile, no pair dropped) -> ``interpolate`` of the vertex
   colours with ``rast_db`` -> ``antialias`` of the mask with ``edge_adj``
   -> L1 against the phase's gt rgb and mask -> the pose gradient; K8
   launched once, its ids equal the brute force's (``impl='reference'``)
   exactly, so do rast and rast_db; the pose gradients repeat bit for bit
   from pass to pass and equal the brute force's bit for bit (rasterize's,
   interpolate's and antialias's gathers sum in a fixed order: the
   segmented sum, launched once for rasterize's setup rows, once for each
   of the clip positions' corner gathers of rasterize and antialias and
   once for each of antialias's two passes), and the coverage differs from
   ``render_batch``'s ids at the same poses on at most 0.5% of the
   foreground; forward and backward times and peak memory printed;
   ``rasterize``'s backward twice at the same poses gives the same clip
   gradient bit for bit, and the segmented sum agrees with its plain twin
   and is timed beside ``index_add_``;
10. ``DiffDope`` with ``tpu.raster_impl: auto`` on icosphere(1) (80
   triangles, vertex colours) at 960x540, B=8, 5 SGD steps (``AUTO_HYPER``):
   auto picks the brute-force rasterizer (the unfused route: the segmented
   sum of its row gather launched once a step, nothing else) and the loss
   falls; run twice, not under torch's deterministic algorithms, the two
   runs equal bit for bit (poses, totals, loss logs);
11. ``DiffDope`` at the default configuration under ``DD_RASTER=v3`` (the
   planar route: K10, then K5/K6; no pack kernel, no bins): K10 and K5/K6
   launched and nothing else, the criteria of phase 5 with no re-run but
   for the total loss, where most hypotheses' losses and the chosen one's
   must fall (at the configuration's loss scales one hypothesis overshoots
   on every run without the cull, which v3 never applies:
   ``tools/port_planar_trajectories.py``), K10
   and K5/K6 held to their plain versions on the kept run's table at its
   last poses, where K10's ids and rows also equal, bit for bit, those of
   K7 over exact per-tile bins gathered from the same table (the
   reference's v3 = v2 contract); its unfused route's step-0 logs (one
   ``render_batch`` through K10) equal the fused run's at rtol 1e-5;
12. the same under ``DD_BINNED=0`` (K7 over the bins gathered from the
   planar table, the gather's backward the segmented sum: each
   triangle's slots in slot order, every occurrence, read in place in
   d_bins): K7, K5/K6 and the segmented sum ('index_rows_bwd', once a
   step for every hypothesis) launched, no K1-K4; the criteria of
   phase 5; K7 and K5/K6 held on its tables; the bins' occupancy logged
   at every step; the segmented sum (``rasterize.slot_sums``) at the last
   poses' bins and a seeded cotangent through K7's backward equal to its
   CPU path (an index_add in slot order) bit for bit; its step-0 logs equal phase 5's and phase 11's at rtol 1e-5,
   or, where its cull changes the render, phase 11's equal its own with
   the cull off;
13. K9, the v1 raster + row gather, at phase 9's frame and poses (tile
   32x128, K from the fullest tile): ``xfm_points`` -> ``triangle_setup``
   -> ``bin_triangles`` -> ``pack_rows`` -> ``raster_gather_rows`` -> the
   shaded rgb and antialiased mask -> L1 against the gt -> the pose
   gradient; K9 forward and backward launched once each (and the
   segmented sum of ``triangle_setup``'s corner gather), its ids equal
   the brute force's on the same coefficients, its rows a plain gather's
   bit for bit, the pose gradients the plain-gather path's at rtol 2e-4,
   atol 1e-6; forward and backward times and peak memory printed, and
   whether the warm-up and the timed pass give bit-identical pose
   gradients, d_rows and d_packed;
14. ``DiffDope`` with exact texture at the default configuration's full
   size (960x540, B=8, 61 SGD steps, mask + rgb L1, ``tpu.texture_mode:
   exact``) on the textured stand-in (``texture_mesh``: the geometry and uv
   of ``data/standins/standin_tex_checker.ply``, which
   ``tools/make_standins.py`` wrote from ``make_asym_uv()``, and its
   ``make_texture('checker')`` 1024x1024 texture quantized to 8 bits, as a
   PNG load gives it, so the packed sampler runs), the scene the port's
   unfused texture render at the configured pose: K1-K4 and the colour lane
   of K5/K6 launched once a step each (of each run the overflow recovery
   makes: no ROI crop here, so an overshooting hypothesis grows the bins)
   and nothing else (no plain pack); step-0 logs equal the unfused texture
   route's at rtol 1e-5 and the pose gradients at the init its at rtol
   2e-4, atol 1e-6; the chosen (step, hypothesis) scores below its start
   and get_pose() ends closer to the gt pose (ADD) (most hypotheses
   overshoot on the checker, on the unfused route too:
   ``tools/port_texture_trajectories.py``; the configured two re-runs
   allowed); the kernels held on its tables at its last poses; then the
   same on ``make_texture('smooth')``, without and with the depth loss
   (the colour lane with the depth plane), where most hypotheses' losses
   must fall with at most one re-run, and with the depth term the init's
   gradients are held with the gt depth moved off the few pixels whose
   depth residual the two routes round to opposite signs (at most
   ``MAX_DEPTH_TIES`` of the gt mask);
15. appearance refinement on the texture leaf: the same scene, the mesh's
   texture flat at 0.4, ``enable_gradients_texture()``, 11 steps: K1-K4
   launched (the static uv takes the pack kernel) and the segmented sum
   four times a step (the bilinear taps), K5/K6 not, the texture moved
   and written back into the mesh, the mean rgb loss falls; time and peak
   memory printed; then the same with the vertex colours of phase 5's
   stand-in and with the textured stand-in's baked corner colours as the
   leaf (the plain pack, K3/K4, the segmented sum twice and once a step);
   each leaf run twice, from sessions of its own and not under torch's
   deterministic algorithms: the two runs equal bit for bit (poses,
   totals, loss logs, the leaf written back, launches);
16. the default configuration from files: the textured stand-in (a copy of
   ``data/standins/standin_tex_checker.ply`` beside its checker texture as
   the PNG its TextureFile names) rendered at the camera's full 1920x1080
   and written as rgb.png (8-bit), depth.png (16-bit) and seg.png, every
   row filter by turns (``testing.write_png``), each file's read time
   printed; ``DiffDope(cfg)`` built from ``DEFAULT_CONFIG`` with only the
   scene's paths, the model path and the init changed (image_resize 0.5:
   960x540): (a) the gt arrays are the files' 2x2 means (rgb, mask) and
   nearest samples (depth); (b) the default losses meet phase 5's
   criteria; (c) with ``tpu.restarts: 1``, the init jitter, precomputed
   bins, ``live_loss: step`` and the rgb + depth losses: 61 steps logged
   with a live line each, no binning inside the refinement, hypothesis 0
   at the unjittered init, the chosen (step, hypothesis) below its start,
   ``get_pose()`` closer to the gt pose, K1-K6 held on its tables; (d) the
   stand-in as binary and ascii STL and as a .glb with its texture
   embedded as PNG, each load held to the PLY's;
17. the BOP evaluation path: (a) the synthesized sweep through
   ``examples.run_bop_sweep.main`` at the JAX package's own defaults
   (``SWEEP_ARGS``: 160x160, B=16, 40 Adam steps, rgb + mask, all three
   levels) on a ``hope/val/000001`` tree of perturbation JSONs written
   here (one frame, three objects at seeded rotations), the stand-in mesh:
   one fused loss with its ground truth fed per call, its compact table
   sized from the 16 probe poses; each level's table, capacity, slots
   needed, ``_bin_overflow`` and re-runs printed, then every object's ADD
   before and after; K1-K6 (the bf16 lane of K6/K4) launched and nothing
   else; every final loss finite, no level's acc@0.1d below its init's,
   K1-K6 held on the last context's full-frame tables at the last poses
   with the last ground truth bound; (b) the real-BOP branch through
   ``examples.run_bop_scene.main`` at the default configuration
   (configs/diffdope.yaml: B=8, 60 SGD steps, mask L1, image_resize 0.5)
   on a 1920x1080 BOP scene written here (``write_bop_scene``: the two
   stand-ins as models by ``save_ply``, rgb / 16-bit depth / mask_visib
   PNGs, cam_K with a depth_scale, scene_gt.json, an error JSON 10 degrees
   and 40 mm off each pose): each object's ADD before and after, its
   diameter and kept hypothesis, the wall time; every object's ADD must
   fall;
18. viz on phase 5's session (960x540, B=8, 61 steps, crop_around_mask):
   ``render_img()`` for rgb, depth and mask from one render (K1 and K3 once
   each), each composite equal byte for byte to the one
   ``_compose_overlay`` builds from the plain twins' render of the same
   poses (``check.plain_render``: no kernel launched); ``make_animation``
   of the argmin hypothesis into an mp4 (final_width 800, chunk 16: K1 and
   K3 four times), read back with cv2: one frame a step, of the composite's
   size; each chunk's ``_bin_overflow`` printed and, where it is not 0, the
   frames that dropped pairs; the wall times; ``plot_losses`` driven only
   where matplotlib is installed (else the reason is printed);
19. the hypotheses sharded over two gloo ranks on the one card (NCCL
   refuses two ranks on a device), spawned: (a) ``DiffDope`` at phase 5's
   configuration with ``tpu.mesh_axis: 2`` on each rank against phase 5's
   unsharded run: ``mtx_history`` at rtol 2e-4, atol 2e-5 and the total
   loss at rtol 2e-4, atol 1e-6 (the reference's tolerances), the same
   argmin, the telemetry phase 5's (the ranks bin over their union, so
   the table's counters are the same on every rank), both ranks the same
   global result, each rank's K1-K6 launched on its 4 hypotheses only
   (K1's batch extent), bit-identity printed; (b) then, on the same two
   ranks, ``examples.multichip_refine.main(["--out", ...])`` in
   torchrun's environment variables (no second launch) at the JAX
   script's defaults (B=64, 400x400, 50 Adam steps, icosphere(3): the
   uniform-K table, K7), rank 0's global histories held to the same
   problem refined unsharded in this process at the same tolerances, the
   same best hypothesis, bit-identity printed; each wall time beside the
   unsharded one for the same work (two ranks sharing one card: the cost
   of the collectives and of the sharing, not a speedup);
20. the reference's last public surface on the card: ``DiffDope`` from
   ``load_config().copy()`` with ``tpu.roi_crop`` deleted (its default
   'auto' applies: the fused loss crops), on the stand-in loaded at scale
   1 and brought to the configured scale by ``Mesh.scaled``, after the
   no-op ``cuda()`` of the session, its camera and its object, 5 SGD
   steps (``AUTO_HYPER``) on the fused route: K1-K6 launched and nothing
   else, the session still on the card, the source config unchanged
   (its YAML text), ``Object3D.forward()`` the scaled vertices, the loss
   falls;
21. the default configuration from JPEG files: phase 16's 1920x1080 scene
   with the rgb frame written by cv2 as a JPEG (``JPEG_QUALITY`` 95, 4:2:0)
   stored turned so that its EXIF orientation (``JPEG_ORIENTATION`` 6:
   transpose, then flip left-right) gives the frame back, depth and seg as
   PNG, and the textured stand-in's texture as a JPEG its PLY names: each
   file read by the port (``png.py``, ``jpeg.py``) equal bit for bit to
   the card host's ``cv2.imread`` (``IMREAD_COLOR`` and
   ``IMREAD_UNCHANGED``), the JPEG and the PNG of the rgb frame's read
   times printed; ``DiffDope(cfg)`` from those files: the gt rgb the 2x2
   mean of cv2's decode, the mesh's texture the JPEG's, then phase 16
   (b): K1-K6 launched and nothing else, phase 5's criteria (the loss
   falls), K1-K6 held on its tables;
22. the default configuration from TIFF, BMP and Netpbm files: every
   variant of ``testing.image_variants`` (TIFF, BMP, PNM/PAM/PFM) read by
   the port from bytes and from a file, equal bit for bit to the card
   host's ``cv2.imdecode`` / ``cv2.imread`` (``tools/port_cv2_formats``);
   then phase 16's 1920x1080 scene written by cv2 as rgb.bmp (24-bit) and
   rgb.ppm, seg.pgm and seg.bmp (8-bit palette), depth.tif (cv2's default:
   LZW, the horizontal predictor, 2-row strips), depth_f32.tif (deflate,
   the floating-point predictor) and depth.pfm of the same values, and
   the checker texture as a TIFF a copy of the PLY names: each read in
   both modes equal to cv2's (None where cv2's is), sizes and read times
   printed (the 16-bit TIFF's beside depth.png's); ``DiffDope(cfg)`` with
   rgb + mask + depth from the BMP, the PGM and the 16-bit TIFF, then the
   same from phase 16's PNGs: equal gt arrays (and the float32 TIFF's and
   the PFM's depth equal to the 16-bit one's), equal loss histories,
   argmin and ``get_pose()`` bit for bit, K1-K6 with the depth lane
   launched and nothing else and held on the kept run's tables, phase 5's
   criteria, the TIFF texture equal to the PNG one;
23. the default configuration from WebP files: every file of the WebP
   corpus (``testing.webp_variants``: lossy, lossless, alpha, animations,
   EXIF orientations, truncated and malformed files) read by the port from
   bytes and from a file in both modes, equal bit for bit to the card
   host's cv2 (None where cv2's is); then (a) phase 16's 1920x1080 scene
   written by cv2 as lossless rgb.webp and seg.webp, lossy rgb at
   qualities 50 and 90, and the checker texture as a lossy WebP: each read
   equal to cv2's, the colour read times printed beside rgb.png's; (b)
   ``DiffDope(cfg)`` with rgb + mask + depth from the lossless rgb.webp
   and seg.webp (depth.png as it is) and from phase 16's PNGs: equal gt
   arrays, loss histories, argmin and ``get_pose()`` bit for bit, K1-K6
   with the depth lane launched and held; (c) ``DiffDope(cfg)`` from the
   quality-90 rgb.webp and a .glb whose texture is the embedded WebP (the
   mesh's texture equal to ``cv2.imdecode``'s): K1-K6 on the compact fused
   route, phase 5's criteria;
24. the masks, depths and images cv2 reads that phase 22 did not: (a)
   every variant of ``testing.format_variants`` (TIFF at 1, 2, 4, 10-14
   bits, signed, 32/64-bit integer and float64 samples, FillOrder 2,
   JPEG-in-TIFF; GIF; Sun Raster; Radiance HDR) read by the port from
   bytes and from a file in both modes, held to the card host's cv2, or
   to cv2 5.0's committed reads (``tests/torch_data/format_variants_cv2
   .json``) for a format the host's cv2 lacks and for the variants that
   file lists as read otherwise by the host's cv2 (whose own reads must
   then be the listed ones), the yardstick printed per format; then phase
   16's 1920x1080 scene as seg.tif (1-bit), seg.gif, depth_i32.tif and
   depth_i16.tif (the depth PNG's values), rgb.ras, rgb.hdr (cv2's
   float32 HDR of the frame) and rgb_jpeg.tif (JPEG-in-TIFF, YCbCr 4:2:0
   from the host cv2's JPEG encoder), each read equal to the host's cv2,
   read times printed beside rgb.png's; (b) ``DiffDope(cfg)`` with rgb +
   mask + depth from rgb.ras, seg.tif and depth_i32.tif, from seg.gif and
   depth_i16.tif, and from the PNGs (seg made two-valued): equal gt
   arrays, loss histories, argmin and ``get_pose()`` bit for bit, K1-K6
   with the depth lane launched and held; (c) ``DiffDope(cfg)`` from
   rgb.hdr and a PLY whose texture is a JPEG-in-TIFF: the gt rgb the
   loader's arithmetic on cv2's read of the HDR, the texture cv2's read,
   K1-K6 on the compact fused route, phase 5's criteria;
25. OpenEXR (cv2 4.13 reads it only with ``OPENCV_IO_ENABLE_OPENEXR`` set,
   which this phase sets and restores): (a) every file of the committed
   corpus (``testing.exr_variants``) read by the port from bytes and from
   a file in both modes, equal bit for bit to the card host's cv2 run in
   a process with the variable set (None where cv2's is; the deep
   scanline file, which cv2 composites, refused by name), and the host's
   reads equal to the committed record (``tests/torch_data/exr_cv2.json``);
   (b) ``DiffDope(cfg)`` with rgb + mask + depth from phase 16's 1920x1080
   scene with the depth as cv2's float32 EXR (ZIP, and PIZ) and as a
   float32 TIFF: equal gt arrays, loss histories, argmin, ``get_pose()``
   and launches, K1-K6 with the depth lane launched and held; a half DWAA
   depth as cv2 4.13 writes it (no data: cv2 and the port read None, the
   loader raises ``FileNotFoundError``); then a half DWAA depth with data
   (``testing.encode_exr``'s lossy DCT, the channel flagged perceptually
   linear) with a float RGB EXR (the frame's
   0..255 values) read as colour: the inputs the loader's arithmetic on
   cv2's reads, phase 5's criteria; (c) the 1080p depth under every
   coding (and the DWAA depth with data, and the float RGB) equal to cv2
   in both modes, its read times (best of three) beside rgb.png's;
26. the compiled refinement (``compiled_refine_phase``): the bench main
   path, phase 5's default configuration and phase 17 (a)'s synthesized
   sweep, each as the eager loop (``cuda_graph=False``) beside graph
   replays with a capture per call (each ``refine`` call, segment or
   object its own) and with the capture kept (the bench's one
   ``optimize.CapturedRefine`` across the warm-up and the timed runs;
   ``DiffDope``'s one a run for its segments; the sweep context's one for
   every object and level; and for phase 5 one kept across runs too), in
   turns: every graph run equal to every eager run bit for bit with
   equal launches, phase 5's the session's own run; printed for each
   mode: the captures in a run, its step 0 and capture times, a replay's
   time, wall time and peak memory, the kept graph's pool, and the device
   busy share; and the set-up ``torch.cuda.graph`` would add to each
   capture (a synchronize, ``empty_cache``, ``gc.collect``), which the
   capture skips.

Every refinement above runs as the port's entry points run it by
default: one ``optimize.CapturedRefine`` a run (the bench main path: one
across its warm-up and timed run; phase 17 (a): one a sweep context),
its step 0 eager, then one captured CUDA graph replayed for every later
step of every segment, restart and call, the launch counts those the
card ran (each run's captures printed); phase 19's ranks, under a
process group, run the eager loop.

K5/K6's colour lane (with and without the depth plane) and K1/K2 at the uv
table's two channels are held to their plain versions at the test scene
and at the bench shapes (``bench_problem(texture=True)``: the bench's
sphere at spherical uv, a 1024x1024 8-bit texture), where both are timed.
K8 (the API's binned id search: a box pre-pass, then one block per 16x16
sub-tile of a bin's tile) is also held to its plain version at the test
scene, at tiles (16, 32) and (32, 128) over a 70x100 frame, and at the
bench shapes (B=64, 400x400, icosphere(5), tile (32, 128), K from the
counts), where both are timed; so are K9 (the same inputs, with packed
rows) and K10 (and K7 on the 'v2' route's gathered bins) on the planar
variants of the test scene's and the bench problem's losses.  K3, K7, K8,
K9 and K10 are bound by the tests inside their slots' boxes (K8's and
K9's rows print the TPU kernel's all-pairs tests beside).  The raster
backwards K4, K7, K9 and K10 are timed beside one PyTorch call of the
same function (``check.bwd_library``, a ``scatter_add_`` by winner slot:
``library_ms``).

The line before the last is the card; before it, one JSON object with a
row per kernel.  The last line is ``{"ok": true, "device": {...}}``.
Needs a CUDA device: it does not fall back to the CPU.
"""

import copy
import json
import os
import struct
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

#: configs/diffdope.yaml, with the in-repo stand-in mesh in place of the
#: AlphabetSoup scan (absent from the repo); the scene is rendered, not read
DEFAULT_CONFIG = {
    "camera": {"fx": 1390.53, "fy": 1386.99, "cx": 964.957, "cy": 522.586,
               "im_width": 1920, "im_height": 1080},
    "scene": {"image_resize": 0.5},
    "object3d": {
        "position": [-161.16877980209404, 206.22094040904116, 747.151333695172],
        "scale": 0.01,
        "rotation": [-0.7913458966114294, 0.07584660081839613, 0.6066456668109877,
                     0.46529349746608056, 0.7183778584745024, 0.5171413865369608,
                     -0.39657739866517305, 0.6915059982370961, -0.6037763006860087],
        "model_path": "data/standins/standin_asym.ply",
    },
    "losses": {"l1_rgb_with_mask": False, "weight_rgb": 0.7,
               "l1_depth_with_mask": False, "weight_depth": 1,
               "l1_mask": True, "weight_mask": 1},
    "hyperparameters": {"nb_iterations": 60, "batchsize": 8, "base_lr": 20,
                        "learning_rates_bound": [0.01, 100],
                        "learning_rate_base": 1, "lr_decay": 0.1},
    "render_images": {"nrow": 4, "final_width_batch": 2000, "add_background": True,
                      "alpha_overlay": 0.7, "add_countour": True,
                      "color_countour": [0.46, 0.73, 0], "flip_result": True,
                      "crop_around_mask": True},
    "tpu": {"seed": 0, "optimizer": "sgd", "raster_impl": "auto", "tile_h": 32,
            "tile_w": 128, "max_tris_per_tile": "auto", "texture_mode": "baked",
            "fused_loss": True, "precompute_bins": False, "bin_margin_px": 24.0,
            "compact_bins": True, "compact_total": None, "cull_backfaces": "auto",
            "scan_segment": 40, "progress": True, "live_loss": "segment",
            "mesh_axis": 1, "init_jitter_deg": 0.0, "init_jitter_trans": 0.0,
            "restarts": 0, "restart_jitter_deg": 10.0, "restart_jitter_trans": 0.02,
            "overflow_recovery": True, "overflow_retries": 2,
            "argmin_rule": "best_step", "roi_crop": "auto"},
}
#: the launch counters of the fused compact route without depth (the bench
#: main path, phase 5): the spanning op's default bf16 d_rows lane of K6
#: and K4; the unfused route runs K1-K4 with f32 d_rows
COMPACT_FUSED = ("pack_fwd", "pack_bwd", "raster_fwd", "raster_bwd_bf16", "loss_fwd",
                 "loss_bwd_bf16")
COMPACT_UNFUSED = ("pack_fwd", "pack_bwd", "raster_fwd", "raster_bwd")
#: the API path's tile (the op's default)
API_TILE = (32, 128)
#: phase 10's run: 5 SGD steps, loss scales in [0.5, 2] (the DiffDope parity
#: tests' bounds): at the configured [0.01, 100] five steps overshoot on the
#: large scales and the total loss ends above its start
AUTO_HYPER = {"nb_iterations": 4, "learning_rates_bound": [0.5, 2.0]}
#: the planar routes' launch counters (phases 11 and 12)
V3_FUSED = ("raster_v3_fwd", "raster_v3_bwd", "loss_fwd", "loss_bwd")
V2_FUSED = ("raster_uniform_fwd", "raster_uniform_bwd", "loss_fwd", "loss_bwd",
            "index_rows_bwd")
#: the exact-texture route's launch counters (phase 14)
TEXTURE_FUSED = ("pack_fwd", "pack_bwd", "raster_fwd", "raster_bwd", "loss_fwd_color",
                 "loss_bwd_color")
#: phases 14/15: mask + rgb L1 (the configured weights), the texture sampled
TEXTURE_TPU = {"texture_mode": "exact"}
TEXTURE_LOSSES = {"l1_rgb_with_mask": True}
#: phase 14's depth variant: the most gt-mask pixels (a share) at which the
#: fused and the unfused route may round the init's depth residual to
#: opposite signs (:func:`depth_ties`); 1 of its 2,983 read on the card and
#: on the CPU at 960x540 (tools/port_texture_gradients.py), whose gradient
#: gap of 10.3x the rtol 2e-4, atol 1e-6 allowance falls to 0.025x with
#: the gt depth moved off it
MAX_DEPTH_TIES = 0.001
#: phase 16 (c): the refinement options of run_optimization, on the rgb +
#: depth + mask losses
FILES_OPTIONS = {"restarts": 1, "init_jitter_deg": 5.0, "init_jitter_trans": 0.005,
                 "precompute_bins": True, "live_loss": "step"}
FILES_LOSSES = {"l1_rgb_with_mask": True, "l1_depth_with_mask": True}
#: phase 21: the rgb frame's JPEG (cv2's quality, 4:2:0) and the EXIF
#: orientation stored with it (6: cv2 transposes, then flips left-right)
JPEG_QUALITY, JPEG_ORIENTATION = 95, 6
#: phase 22: the launch counters of the fused compact route with the depth
#: lane (rgb + mask + depth, FILES_LOSSES)
COMPACT_DEPTH = ("pack_fwd", "pack_bwd", "raster_fwd", "raster_bwd", "loss_fwd_depth",
                 "loss_bwd_depth")
#: phase 23: cv2's ``IMWRITE_WEBP_QUALITY`` above 100 writes lossless WebP
WEBP_LOSSLESS = 101
#: phase 24: the JPEG-in-TIFF frame's and texture's strips (rows) and
#: cv2's JPEG quality for them
JPEG_TIFF_ROWS, JPEG_TIFF_QUALITY = 64, 90
#: the Image default the configuration keeps (``image.py``'s depth_scale)
DEFAULT_DEPTH_SCALE = 100.0
#: the DiffDope phases' init: the configured pose moved by this OpenCV-frame
#: translation (mm, before the 0.01 scale) and rotated by this many degrees
#: about ``axis``; the default SGD configuration recovers it (the phase
#: prints the ADD before and after)
INIT_OFFSET = {"translation_mm": [5.0, -5.0, 0.0], "degrees": 4.0, "axis": [0.0, 1.0, 0.0]}
#: phase 17 (a): the synthesized BOP sweep at the JAX package's defaults
#: (``bop.py:70-94``: 160x160, B=16, 40 Adam steps at base lr 0.02, loss
#: scales in [0.5, 4], weights rgb 0.7 / depth 0 / mask 1, obj_scale 0.01,
#: best_step, all three levels), the stand-in in place of AlphabetSoup
SWEEP_ARGS = ("--resolution", "160x160", "--batchsize", "16", "--iterations", "40")
SWEEP_MESH = "data/standins/standin_asym.ply"
#: phase 17 (b): the BOP scene's two models (stand-ins, millimetres), their
#: true poses in the OpenCV frame (mm, the first the default configuration's
#: object pose) and the perturbation of each init (degrees, mm)
BOP_MODELS = ("data/standins/standin_asym.ply", "data/standins/standin_sym.ply")
BOP_T_MM = ([-161.16877980209404, 206.22094040904116, 747.151333695172],
            [150.0, -120.0, 820.0])
BOP_PERTURB = (10.0, 40.0)
#: scene_camera.json's depth_scale (YCB-V's: the depth PNG in 0.1 mm)
BOP_DEPTH_SCALE = 0.1
#: phase 19: the two ranks' deadline, start to exit ((a) then (b): ~30-40 s)
SPAWN_DEADLINE_S = 300



def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def versions() -> str:
    import torch

    try:
        from torch.utils.cpp_extension import CUDA_HOME

        nvcc_bin = f"{CUDA_HOME}/bin/nvcc" if CUDA_HOME else "nvcc"
        nvcc = subprocess.run([nvcc_bin, "--version"], capture_output=True,
                              text=True).stdout.strip().splitlines()[-1]
    except (OSError, IndexError):
        nvcc = "not found"
    try:
        import triton

        tri = triton.__version__
    except ImportError:
        tri = "not installed"
    return (f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"nvcc {nvcc}, triton {tri}")


def drows_lanes(problem):
    """At the bench init, the pose gradients of the main path's default
    bf16 d_rows lane against those of the f32 lane (the loss rebuilt under
    DD_DROWS_BF16=0): within the contract's bf16 clause, atol 2e-2 of the
    component's largest |value|, and not equal (the lane is taken)."""
    import torch

    from diffdope_tpu_torch.bench import bench_problem, drows_env
    from diffdope_tpu_torch.optimize import pose_matrix

    with drows_env(False):
        fn32 = bench_problem((400, 400), subdiv=5, batch=64, device="cuda")["fn"]

    def grads(fn):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in problem["params0"].items()}
        total, _ = fn(pose_matrix(p)[0])
        return dict(zip(p, torch.autograd.grad(total, list(p.values()))))

    if not problem["fn"].drows_bf16 or fn32.drows_bf16:
        fail("the bench problem's loss is not on the bf16 lane, or its rebuild not on f32")
    g16, g32 = grads(problem["fn"]), grads(fn32)
    gap = max(float((g16[k] - g32[k]).abs().max() / (2e-2 * g32[k].abs().max()))
              for k in g32)
    rel = max(float(((g16[k] - g32[k]).abs() / (1e-6 + 2e-4 * g32[k].abs())).max())
              for k in g32)
    print(f"main path init: bf16 against f32 d_rows pose gradients: largest |diff| "
          f"{gap:.3e} of the bf16 clause (atol 2e-2 x scale), {rel:.3e} of rtol 2e-4, "
          f"atol 1e-6", flush=True)
    if gap > 1.0 or all(torch.equal(g16[k], g32[k]) for k in g32):
        fail("the bf16 lane's gradients break the bf16 clause, or equal the f32 lane's")


def check_all(fn, mtx, d_sums, reps=0):
    """K1-K6 against their plain versions on ``fn``'s tables at ``mtx``."""
    from diffdope_tpu_torch.kernels.check import check_kernels, check_pack

    return check_pack(fn, mtx, reps) + check_kernels(fn, mtx, d_sums, reps)


def diffdope_session(fused: bool, offset=None, tpu=None, losses=None, hyper=None,
                     mesh=None, device="cuda", resize=None, cfg=None):
    """A DiffDope on ``device`` at ``DEFAULT_CONFIG`` or ``cfg`` (a
    ConfigNode the session takes and changes; ``tpu``, ``losses`` and
    ``hyper`` entries overriding its groups; ``mesh`` in place of the
    configured model; ``resize`` in place of the configured image_resize):
    the scene is the port's render at the configured pose, the init that
    pose moved by ``offset`` (default ``INIT_OFFSET``).  Returns the
    session, the mesh's vertices (for ADD) and the gt pose."""
    import numpy as np
    import torch

    from diffdope_tpu_torch.camera import Camera
    from diffdope_tpu_torch.config import ConfigNode
    from diffdope_tpu_torch.diffdope import DiffDope
    from diffdope_tpu_torch.geometry import (
        matrix33_from_quat,
        quat_from_axis_angle,
        quat_from_matrix33,
    )
    from diffdope_tpu_torch.image import Image, Scene
    from diffdope_tpu_torch.object3d import Object3D
    from diffdope_tpu_torch.optimize import pose_matrix
    from diffdope_tpu_torch.render.pipeline import compact_capacity, render_batch

    offset = INIT_OFFSET if offset is None else offset
    cfg = ConfigNode(copy.deepcopy(DEFAULT_CONFIG)) if cfg is None else cfg
    cfg.object3d.model_path = str(HERE / cfg.object3d.model_path)
    cfg.tpu.fused_loss = fused
    for key, value in (tpu or {}).items():
        cfg.tpu[key] = value
    for key, value in (losses or {}).items():
        cfg.losses[key] = value
    for key, value in (hyper or {}).items():
        cfg.hyperparameters[key] = value
    if resize is not None:
        cfg.scene.image_resize = resize
    camera = Camera(**cfg.camera)
    h = int(cfg.camera.im_height * cfg.scene.image_resize)
    w = int(cfg.camera.im_width * cfg.scene.image_resize)
    gt_obj = Object3D(**cfg.object3d, mesh=mesh)
    mesh = gt_obj.mesh
    mtx_gt = pose_matrix(gt_obj.initial_params(1, device))[0]
    # the gt render bins every triangle a tile touches: no capacity to drop
    t_all = len(mesh.pos_idx)
    cap = compact_capacity(camera.cam_proj, mesh.pos, mesh.pos_idx, mtx_gt, (h, w), t_all,
                           device=device)
    with torch.no_grad():
        gt = render_batch(camera.cam_proj, mtx_gt, mesh.pos, mesh.pos_idx, (h, w),
                          vtx_color=mesh.vtx_color, edge_adj=mesh.edge_adj,
                          max_tris_per_tile=t_all, compact_total=cap, tex=mesh.tex,
                          uv=mesh.uv, uv_idx=mesh.uv_idx, device=device)
    dropped = int(gt.get("_bin_overflow", 0))  # none on the brute-force route
    if dropped:
        fail(f"the gt render dropped {dropped} (tile, triangle) pairs")
    scene = Scene(tensor_rgb=Image(img_tensor=gt["rgb"][0].cpu().numpy()),
                  tensor_depth=Image(img_tensor=gt["depth"][0].cpu().numpy(), depth=True),
                  tensor_segmentation=Image(img_tensor=gt["mask"][0].cpu().numpy()))

    # the init: the configured OpenCV-frame pose, offset
    o3 = cfg.object3d
    rot_cv = np.asarray(o3.rotation, np.float64).reshape(3, 3)
    dq = quat_from_axis_angle(np.asarray(offset["axis"]), np.deg2rad(offset["degrees"]))
    dr = matrix33_from_quat(torch.as_tensor(dq)).numpy()
    obj = Object3D(position=np.asarray(o3.position) + offset["translation_mm"],
                   rotation=quat_from_matrix33(dr @ rot_cv),
                   batchsize=cfg.hyperparameters.batchsize, scale=o3.scale, mesh=mesh)
    dd = DiffDope(cfg=cfg, camera=camera, object3d=obj, scene=scene, device=device)
    points = torch.as_tensor(mesh.pos[: mesh.num_vertices], device=device)
    return dd, points, mtx_gt[0]


def texture_mesh(kind: str = "checker", quantized: bool = True):
    """The textured stand-in at the configured scale: the geometry and uv of
    ``data/standins/standin_tex_checker.ply`` (``make_asym_uv()``'s, written
    by ``tools/make_standins.py``; its PNG is not in the repo) and
    ``make_texture(kind)`` quantized to 8 bits (unless ``quantized`` is
    False), built as ``load_mesh`` builds a textured PLY
    (``testing.textured_mesh``: V flip, winding, padding, baked corner
    colours)."""
    from diffdope_tpu_torch.mesh import load_ply
    from diffdope_tpu_torch.testing import quantize8, textured_mesh
    from tools.make_standins import make_texture

    data = load_ply(HERE / "data/standins/standin_tex_checker.ply")
    tex = make_texture(kind)
    return textured_mesh(data["vertices"], data["faces"], data["uv"],
                         quantize8(tex) if quantized else tex.astype("float32"),
                         scale=DEFAULT_CONFIG["object3d"]["scale"])


def add_to(points, mtx_gt, m) -> float:
    """ADD of pose ``m`` (4x4, OpenGL frame) against ``mtx_gt`` on ``points``."""
    import numpy as np
    import torch

    from diffdope_tpu_torch.metrics import add_metric

    m = torch.as_tensor(np.asarray(m), device=points.device, dtype=torch.float64)
    g = mtx_gt.to(device=points.device, dtype=torch.float64)
    return float(add_metric(points.double(), m[:3, :3], m[:3, 3], g[:3, :3], g[:3, 3]))


def diffdope_phase(fused: bool, gpu: str, route: str, tpu=None, losses=None,
                   raster=None, mesh=None, session=None):
    """One default-configuration DiffDope run on the card, then the kernels
    of its route against their plain versions on its tables; returns the
    session, its launch counts, and the ADD of the init and of
    get_pose().  ``raster`` 'v3' or 'v2' selects that planar route (its
    environment in force for the run and the checks; the scene is rendered
    before, on the default route).  ``session`` (dd, points, mtx_gt) is a
    session built elsewhere (phase 16's, from files)."""
    import numpy as np
    import torch

    from diffdope_tpu_torch import kernels
    from diffdope_tpu_torch.bench import raster_env
    from diffdope_tpu_torch.kernels.check import check_kernels

    dd, points, mtx_gt = session or diffdope_session(fused, tpu=tpu, losses=losses,
                                                     mesh=mesh)
    h, w = dd.resolution
    with raster_env(raster):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with Captures() as caps:
            dd.run_optimization()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

        # the kernels at this phase's shapes: the kept run's tables (its
        # final capacities and crop, or the unfused route's full frame) at
        # its last poses, which differ per hypothesis
        use_bins = dd._use_bins()
        fn = (dd._make_fused_loss_fn(dd.gt_tensors, use_bins=use_bins) if fused
              else dd._make_render_fn(with_bins=use_bins))
        mtx_last = torch.as_tensor(dd.mtx_history[-1], device="cuda")
        d_sums = torch.as_tensor(
            np.random.default_rng(2).uniform(0.5, 2.0, (dd.batchsize, 3)),
            dtype=torch.float32, device="cuda")
        rows = (check_kernels(fn, mtx_last, d_sums) if raster
                else check_all(fn, mtx_last, d_sums))
    for row in rows:
        print(f"DiffDope {route} shapes {row['name']}: ok={row['ok']} "
              f"max_abs_err={row['max_abs_err']:.3e} ({row['tolerance']}){slots(row)}, "
              f"bound {row['bound'][0]:.4f} ms ({row['bound'][1]})", flush=True)
        if not row["ok"]:
            fail(f"{row['name']} disagrees with its plain version on the DiffDope "
                 f"{route} tables: {row}")
    stats = dd.last_run_stats
    print(f"DiffDope {route}: {stats['steps']} steps, B={dd.batchsize}, {w}x{h}: "
          f"kept run {stats['wall_time_s']:.4f} s, {stats['steps_per_sec']:.3f} steps/s; "
          f"run_optimization {total_s:.4f} s with {stats['recovery_reruns']} re-run(s); "
          f"peak {peak_gib:.3f} GiB [{gpu}]", flush=True)
    print(f"DiffDope {route} launches: {launches}; {caps.summary()}", flush=True)
    if caps.count != stats["recovery_reruns"] + 1:
        fail(f"DiffDope {route}: {caps.count} captures for {stats['recovery_reruns'] + 1} "
             f"dispatch(es): each run's segments share one")
    return (dd, launches, add_to(points, mtx_gt, dd.object3d.initial_matrix()),
            add_to(points, mtx_gt, dd.get_pose()))


def slots(row) -> str:
    """The slots a raster check walked, of its table's (and those of the
    compact table's tail, past every tile's chunks), and the library call's
    time where one was taken, for its printed line."""
    out = f", {row['slots']} of {row['table_slots']} slots" if "slots" in row else ""
    if "range_tests" in row:
        out += f", {row['range_tests']} tests inside the boxes"
    if "tested_pairs" in row:
        out += f" (the TPU kernel's {row['tested_pairs']})"
    if "tail_slots" in row:
        out += f" ({row['tail_slots']} in the tail)"
    if row.get("library_ms") is not None:
        out += f", library {row['library_ms']:.4f} ms"
    return out


def check_launches(route, launches, on, off) -> None:
    """Fail unless every counter of ``on`` is positive and every counter of
    ``off`` is 0."""
    for counter in on:
        if launches[counter] <= 0:
            fail(f"{route}: {counter} was not launched ({launches})")
    for counter in off:
        if launches[counter]:
            fail(f"{route}: {counter} was launched ({launches})")


def unfused_step0(dd):
    """One unfused render_batch at the session's init poses plus its loss
    functions, no refinement: the logged per-hypothesis terms."""
    import torch

    render_fn = dd._make_render_fn()
    mtx0 = torch.as_tensor(dd.mtx_history[0], device="cuda")
    gt = {k: torch.as_tensor(v, device="cuda") for k, v in dd.gt_tensors.items()}
    logs = {}
    with torch.no_grad():
        renders = render_fn(mtx0)
        for fn in dd.loss_functions:
            _, (key, values) = fn(renders, gt, dd.learning_rates, dd.loss_weights)
            logs[key] = values.cpu().numpy()
    return logs


def agree_step0(route, got, want, keys) -> None:
    import numpy as np

    for key in keys:
        if not np.allclose(got[key], want[key], rtol=1e-5, atol=0.0):
            fail(f"{route}: step-0 '{key}' {got[key]} differs from {want[key]} "
                 "beyond rtol 1e-5")
    print(f"{route}: step-0 {', '.join(keys)} agree at rtol 1e-5", flush=True)


def same_slots(fn_compact, fn_uniform, mtx) -> int:
    """Fail unless, at poses ``mtx``, every tile of the compact table (its
    crop's tiles) holds the same slots in the same order as that tile of
    the uniform table; returns the number of slots compared."""
    import torch

    from diffdope_tpu_torch.render.pipeline import K_CHUNK, TILE_HW, _padded

    with torch.no_grad():
        c, u = fn_compact.binned(mtx), fn_uniform.binned(mtx)
    ntx = _padded(fn_uniform.roi[2:])[1] // TILE_HW[1]
    oy, ox, hc, wc = fn_compact.crop or ((0, 0) + tuple(fn_compact.frame_hw))
    tiles = [(oy // TILE_HW[0] + i) * ntx + ox // TILE_HW[1] + j
             for i in range(hc // TILE_HW[0]) for j in range(wc // TILE_HW[1])]
    k = u.flat.numel() // u.counts.numel()
    c_flat, u_flat = c.flat.cpu(), u.flat.cpu()
    c_counts, u_counts = c.counts.cpu(), u.counts.cpu()
    off, n = c.off_c.cpu() * K_CHUNK, 0
    for i, t in enumerate(tiles):
        m = int(c_counts[i])
        if m != int(u_counts[t]) or not torch.equal(
                c_flat[off[i]: off[i] + m], u_flat[t * k: t * k + m]):
            fail(f"tile {t}: the compact and the uniform table hold other slots")
        n += m
    if int(u_counts.sum()) != n:
        fail("the uniform table holds slots outside the compact table's crop")
    return n


def layout_gradients(fn_a, fn_b, mtx) -> dict:
    """Where two table layouts' pose gradients at poses ``mtx`` part: for
    each of the live slots (in table order), the table's cotangent at them
    (K6 then K4's or K7's per-slot sums), d_mvp (K2's), d_mtx (K2's row 2
    and the depth plane's t_z) and the loss: True where equal bit for bit."""
    import torch

    from diffdope_tpu_torch.render import pipeline
    from diffdope_tpu_torch.render.pack_kernel import _static_table, live_positions

    seen, out = {}, {}
    own = pipeline._pack_dispatch

    def spy(mesh, mvp, mtx_, flat, sil, order):
        packed = own(mesh, mvp, mtx_, flat, sil, order)
        packed.retain_grad()
        mvp.retain_grad()
        seen.update(packed=packed, mvp=mvp, flat=flat,
                    tab=_static_table(flat, mesh.t_count, mesh.static)[0])
        return packed

    pipeline._pack_dispatch = spy
    try:
        for key, fn in (("a", fn_a), ("b", fn_b)):
            m = mtx.detach().clone().requires_grad_(True)
            total, _ = fn(m)
            total.backward()
            pos = live_positions(seen["tab"])
            out[key] = {"slots": seen["flat"][pos], "cotangent": seen["packed"].grad[:, :, pos],
                        "d_mvp": seen["mvp"].grad, "d_mtx": m.grad, "loss": total.detach()}
    finally:
        pipeline._pack_dispatch = own
    return {k: out["a"][k].shape == out["b"][k].shape and torch.equal(out["a"][k], out["b"][k])
            for k in out["a"]}


def same_poses(dd_c, dd_k, adds_c, adds_k) -> None:
    """F3's check: the compact (phase 7) and the uniform-K table (phase 8)
    take the same poses at every step, bit for bit (``mtx_history``).  On
    failure the first step and hypothesis that part, and at the poses
    before it which stage of the two gradients parts
    (:func:`layout_gradients` on the kept runs' losses)."""
    import numpy as np
    import torch

    a, b = dd_c.mtx_history, dd_k.mtx_history
    loss_c, loss_k = (float(dd._result.total_loss[-1]) for dd in (dd_c, dd_k))
    print(f"DiffDope depth compact: final loss {loss_c:.6f}, ADD {adds_c[0]:.6f} -> "
          f"{adds_c[1]:.6f}; uniform: final loss {loss_k:.6f}, ADD {adds_k[0]:.6f} -> "
          f"{adds_k[1]:.6f} (object units)", flush=True)
    if a.shape != b.shape:
        fail(f"DiffDope depth: the compact run's mtx_history {a.shape} and the uniform "
             f"run's {b.shape} differ in shape")
    parted = np.argwhere((a.view(np.int32) != b.view(np.int32)).reshape(
        a.shape[0], a.shape[1], -1).any(-1))
    if not len(parted):
        print(f"DiffDope depth: the compact and the uniform table take the same poses at "
              f"all {a.shape[0]} steps of {a.shape[1]} hypotheses, bit for bit", flush=True)
        return
    step, hyp = (int(v) for v in parted[0])
    print(f"DiffDope depth: the poses part first at step {step}, hypothesis {hyp} "
          f"({len(parted)} (step, hypothesis) pairs differ): compact "
          f"{a[step, hyp].tolist()}, uniform {b[step, hyp].tolist()}", flush=True)
    if step:
        fns = [dd._make_fused_loss_fn(dd.gt_tensors, use_bins=dd._use_bins())
               for dd in (dd_c, dd_k)]
        same = layout_gradients(*fns, torch.as_tensor(a[step - 1], device="cuda"))
        print(f"DiffDope depth: at step {step - 1}'s poses, equal bit for bit: {same}",
              flush=True)
    fail("DiffDope depth: the compact and the uniform table refine to other poses (F3)")


def check_diffdope(dd, route, add0, add1, total_falls: bool = True,
                   max_reruns: int = 1, most_fall: bool = True):
    """Phase 5's criteria on a kept run: no overflow or crop leak left, at
    most ``max_reruns`` re-runs, a finite loss that falls, and get_pose()
    closer to the gt pose than the init.  ``total_falls`` False (phase 11)
    asks instead that most hypotheses' losses fall (unless ``most_fall`` is
    False) and the chosen (step, hypothesis) score below its hypothesis'
    start, and prints the total: at the default configuration's loss scales
    (up to ~90 at base lr 20) one hypothesis overshoots on every cull-free
    run, whose weighted total then ends above its start
    (tools/port_planar_trajectories.py), and on the checker texture most
    do, on the fused and the unfused route alike
    (tools/port_texture_trajectories.py)."""
    telem = dd._result.telemetry or {}
    for key in ("_bin_overflow", "_crop_leak"):
        worst = int(telem[key].max()) if key in telem else 0
        print(f"DiffDope {route} {key}: max {worst} per step", flush=True)
        if worst != 0:
            fail(f"DiffDope {route}: {key} is {worst} after the recovery")
    reruns = dd.last_run_stats["recovery_reruns"]
    print(f"DiffDope {route}: {reruns} recovery re-run(s) (capacity boost "
          f"{getattr(dd, '_capacity_boost', 1.0)}, slots seen "
          f"{getattr(dd, '_slots_seen', 0)}, crop disabled "
          f"{getattr(dd, '_crop_disable', False)})", flush=True)
    if reruns > max_reruns:
        fail(f"DiffDope {route}: {reruns} recovery re-runs (at most {max_reruns} allowed)")
    total = dd._result.total_loss.cpu()
    print(f"DiffDope {route} loss: first {float(total[0]):.6f}, last "
          f"{float(total[-1]):.6f}; argmin {dd.get_argmin()}; ADD {add0:.6f} -> "
          f"{add1:.6f} (object units)", flush=True)
    if not bool(total.isfinite().all()):
        fail(f"DiffDope {route}: non-finite loss")
    if total_falls and not float(total[-1]) < float(total[0]):
        fail(f"DiffDope {route}: the loss did not fall")
    if not total_falls:
        per_hyp = sum(v for v in dd.losses_values.values())  # (steps, B)
        step, hyp = dd._best_indices()
        fell = int((per_hyp[-1] < per_hyp[0]).sum())
        print(f"DiffDope {route}: {fell} of {per_hyp.shape[1]} hypotheses' losses fell "
              f"(first {per_hyp[0].tolist()}, last {per_hyp[-1].tolist()}); the chosen "
              f"step {step}, hypothesis {hyp}: {float(per_hyp[step, hyp]):.6f} from "
              f"{float(per_hyp[0, hyp]):.6f}", flush=True)
        if (most_fall and 2 * fell <= per_hyp.shape[1]) or not (
                per_hyp[step, hyp] < per_hyp[0, hyp]):
            fail(f"DiffDope {route}: the hypotheses' losses did not fall")
    if not add1 < add0:
        fail(f"DiffDope {route}: get_pose() did not end closer to the gt pose")


def k8_check(label, gpu, proj, mtx, pos, tri, resolution, tile_hw, reps=0):
    """K8 against its plain version on the setup rows and bins of the mesh
    at poses ``mtx`` (B, 4, 4); fails on a disagreement.  Returns the row."""
    import torch

    from diffdope_tpu_torch.geometry import matmul44, xfm_points
    from diffdope_tpu_torch.kernels.check import check_raster_ids, raster_ids_inputs

    with torch.no_grad():
        proj = torch.as_tensor(proj, device="cuda")
        pos_clip = xfm_points(torch.as_tensor(pos, device="cuda"), matmul44(proj, mtx))
        tri = torch.as_tensor(tri, device="cuda").long()
        inputs = raster_ids_inputs(pos_clip, tri, resolution, tile_hw)
    row = check_raster_ids(*inputs, resolution, tile_hw, reps)
    times = (f" kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
             f"{row['bound'][0]:.4f} ms ({row['bound'][1]}) [{gpu}]" if reps else "")
    print(f"{label} K8_raster_ids tile {tile_hw}, {resolution[1]}x{resolution[0]}, "
          f"B={mtx.shape[0]}: ok={row['ok']} ({row['tolerance']}; "
          f"{row['id_mismatches']} differ), {row['fg_pixels']} foreground px, "
          f"K {row['k']} (fullest tile {row['fullest']}){slots(row)}{times}", flush=True)
    if not row["ok"]:
        fail(f"K8 disagrees with its plain version ({label}, tile {tile_hw}): {row}")
    return row


def api_path(mesh_t, params, impl: str, k: int, gt):
    """One pass of the nvdiffrast-style API path at poses ``params``:
    xfm_points -> rasterize -> interpolate (rast_db, all channels) ->
    antialias of the mask -> L1 against gt -> the pose gradient; returns
    rast, rast_db, the gradients, the loss and the forward and backward
    seconds (synchronized)."""
    import torch

    from diffdope_tpu_torch import antialias, interpolate, rasterize, xfm_points
    from diffdope_tpu_torch.geometry import matmul44
    from diffdope_tpu_torch.optimize import pose_matrix

    proj, pos, tri, colors, adj = mesh_t
    p = {name: v.detach().clone().requires_grad_(True) for name, v in params.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mtx, _, _ = pose_matrix(p)
    pos_clip = xfm_points(pos, matmul44(proj, mtx))
    rast, db = rasterize(pos_clip, tri, tuple(gt["rgb"].shape[:2]), impl=impl,
                         tile_hw=API_TILE, max_tris_per_tile=k)
    rgb, _ = interpolate(colors, rast, tri, db, diff_attrs="all")
    mask = antialias((rast[..., 3:4] > 0).float(), rast, pos_clip, tri, edge_adj=adj)
    loss = (rgb - gt["rgb"]).abs().mean() + (mask - gt["mask"]).abs().mean()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, list(p.values()))
    torch.cuda.synchronize()
    return dict(rast=rast.detach(), db=db.detach(), loss=float(loss.detach()),
                grads=dict(zip(p, grads)), fwd_s=t1 - t0, bwd_s=time.perf_counter() - t1)


def api_phase(gpu):
    """Phase 9: the API path at the default configuration's frame; returns
    K8's launches on one pass."""
    import numpy as np
    import torch

    from diffdope_tpu_torch import kernels
    from diffdope_tpu_torch.bench import distinct_poses
    from diffdope_tpu_torch.optimize import pose_matrix
    from diffdope_tpu_torch.render.pipeline import compact_capacity, render_batch

    dd, _, _ = diffdope_session(True)
    mesh = dd.object3d.mesh
    res = tuple(dd.resolution)
    cuda = torch.device("cuda")
    mesh_t = (torch.as_tensor(np.asarray(dd.camera.cam_proj, np.float32), device=cuda),
              torch.as_tensor(mesh.pos, device=cuda),
              torch.as_tensor(mesh.pos_idx, device=cuda).long(),
              torch.as_tensor(mesh.vtx_color, device=cuda),
              torch.as_tensor(mesh.edge_adj, device=cuda).long())
    gt_np = dd.gt_tensors
    gt = {"rgb": torch.as_tensor(gt_np["rgb"], device=cuda),
          "mask": torch.as_tensor(gt_np["segmentation"][..., :1], device=cuda)}
    params = distinct_poses(dd.object3d.initial_params(dd.batchsize, cuda), 1e-3)
    mtx, _, _ = pose_matrix(params)
    # K8 on the path's own inputs, timed; K from the fullest tile
    k = k8_check("API path shapes", gpu, dd.camera.cam_proj, mtx.detach(), mesh.pos,
                 mesh.pos_idx, res, API_TILE, reps=20)["k"]
    print(f"API path: {res[1]}x{res[0]}, B={dd.batchsize}, {len(mesh.pos_idx)} triangles, "
          f"tile {API_TILE}, K {k}, no pair dropped", flush=True)

    warm = api_path(mesh_t, params, "pallas", k, gt)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    run = api_path(mesh_t, params, "pallas", k, gt)
    launches = dict(kernels.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"API path (K8): forward {run['fwd_s'] * 1e3:.4f} ms, backward "
          f"{run['bwd_s'] * 1e3:.4f} ms, peak {peak_gib:.3f} GiB, loss {run['loss']:.6f} "
          f"[{gpu}]", flush=True)
    print(f"API path launches: {launches}", flush=True)
    on = ("raster_ids", "setup_rows_bwd", "index_rows_bwd")
    check_launches("API path", launches, on, set(launches) - set(on))
    if (launches["raster_ids"], launches["setup_rows_bwd"], launches["index_rows_bwd"]) != (
            1, 1, 4):
        fail(f"API path: {launches} for one rasterize and its backward (the setup rows' "
             "sum; the clip positions' corner gathers of rasterize and antialias, and "
             "antialias's two passes)")
    for name, g in run["grads"].items():
        if not torch.equal(g, warm["grads"][name]) or not bool(g.abs().max() > 0):
            fail(f"API path: the pose gradient '{name}' does not repeat bit for bit")
    print("API path: the pose gradients repeat bit for bit over two passes", flush=True)

    torch.cuda.reset_peak_memory_stats()
    ref = api_path(mesh_t, params, "reference", k, gt)
    print(f"API path (brute force): forward {ref['fwd_s'] * 1e3:.4f} ms, backward "
          f"{ref['bwd_s'] * 1e3:.4f} ms, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB [{gpu}]", flush=True)
    ids, ids_ref = run["rast"][..., 3], ref["rast"][..., 3]
    n_fg = int((ids > 0).sum())
    print(f"API path: K8 against the brute force: {int((ids != ids_ref).sum())} of "
          f"{ids.numel()} ids differ ({n_fg} foreground)", flush=True)
    if not (torch.equal(run["rast"], ref["rast"]) and torch.equal(run["db"], ref["db"])):
        fail("API path: K8's rast / rast_db differ from the brute force's")
    for name, g in run["grads"].items():
        if not torch.equal(g, ref["grads"][name]):
            fail(f"API path: the pose gradient '{name}' {g.cpu().numpy()} differs from the "
                 f"brute force's {ref['grads'][name].cpu().numpy()}")
    print(f"API path: rast and rast_db equal, pose gradients equal bit for bit; loss "
          f"{run['loss']:.6f} / {ref['loss']:.6f}", flush=True)
    row = rasterize_backward_repeats(mesh_t, mtx.detach(), res, k, gpu)

    # render_batch at the same poses: the same coverage but on silhouette
    # pixels, where its planar coefficients and the API's setup round apart
    t_all = len(mesh.pos_idx)
    cap = compact_capacity(dd.camera.cam_proj, mesh.pos, mesh.pos_idx, mtx.detach(), res,
                           t_all)
    with torch.no_grad():
        rb = render_batch(dd.camera.cam_proj, mtx.detach(), mesh.pos, mesh.pos_idx, res,
                          vtx_color=mesh.vtx_color, edge_adj=mesh.edge_adj,
                          layout="channels", max_tris_per_tile=t_all, compact_total=cap)
    if int(rb["_bin_overflow"]):
        fail("API path: render_batch dropped (tile, triangle) pairs")
    fg_rb = rb["ids"] > 0
    n_diff = int(((ids > 0) != fg_rb).sum())
    print(f"API path: coverage differs from render_batch's on {n_diff} of "
          f"{int(fg_rb.sum())} foreground pixels ({100 * n_diff / int(fg_rb.sum()):.4f}%)",
          flush=True)
    if n_diff > 0.005 * int(fg_rb.sum()):
        fail("API path: coverage differs from render_batch's on more than 0.5% of the "
             "foreground")
    return launches, row


def rasterize_backward_repeats(mesh_t, mtx, res, k, gpu):
    """rasterize's backward at phase 9's poses, twice: the clip positions'
    gradient must repeat bit for bit (the setup rows' segmented sum).  Then
    the segmented sum against its plain twin (an index_add, atomics on the
    card) on a seeded cotangent at the pass's ids, rtol 2e-4, atol 1e-6 +
    1e-6 of the row's sum of |terms|, timed beside the one PyTorch call
    that computes the same sum (``index_add_``); returns its kernel row."""
    import torch

    from diffdope_tpu_torch import rasterize, xfm_points
    from diffdope_tpu_torch.geometry import matmul44
    from diffdope_tpu_torch.kernels.check import _time_ms, bound
    from diffdope_tpu_torch.render.rasterize import (
        segments,
        setup_rows_bwd,
        setup_rows_bwd_plain,
    )

    proj, pos, tri = mesh_t[:3]
    grads = []
    for _ in range(2):
        pos_clip = xfm_points(pos, matmul44(proj, mtx)).requires_grad_(True)
        rast, db = rasterize(pos_clip, tri, res, impl="pallas", tile_hw=API_TILE,
                             max_tris_per_tile=k)
        (g,) = torch.autograd.grad(rast[..., :3].sum() + 1e-3 * db.sum(), pos_clip)
        grads.append(g)
    if not torch.equal(grads[0], grads[1]) or not bool(grads[0].abs().max() > 0):
        fail("API path: rasterize's backward does not repeat bit for bit")
    print("API path: rasterize's pos_clip gradient repeats bit for bit over two "
          "backwards", flush=True)
    b, t_count = mtx.shape[0], tri.shape[0]
    ids = rast[..., 3].detach().to(torch.int32).reshape(b, -1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = torch.randn(ids.shape + (16,), generator=gen, device="cuda")
    got = setup_rows_bwd(d, ids, t_count)
    want = setup_rows_bwd_plain(d, ids, t_count)
    scale = setup_rows_bwd_plain(d.abs(), ids, t_count)
    ok = bool(torch.all((got - want).abs() <= 1e-6 + 2e-4 * want.abs() + 1e-6 * scale))
    fg = int((ids > 0).sum())
    key = torch.where(ids > 0, torch.arange(b, device="cuda")[:, None] * t_count
                      + ids.long() - 1, b * t_count).reshape(-1)
    acc = torch.zeros((b * t_count + 1, 16), device="cuda")
    order, start = segments(ids, t_count)
    row = dict(name="setup_rows_bwd", ok=ok, max_abs_err=float((got - want).abs().max()),
               ms=_time_ms(lambda: setup_rows_bwd(d, ids, t_count), 20),
               plain_ms=_time_ms(lambda: setup_rows_bwd_plain(d, ids, t_count), 2),
               library_ms=_time_ms(lambda: acc.index_add_(0, key, d.reshape(-1, 16)), 20),
               # the foreground rows read, the order and the starts, and the
               # rows written; one add a foreground term
               bound=bound(4 * (16 * fg + order.numel() + start.numel() + got.numel()),
                           16 * fg))
    print(f"API path shapes setup_rows_bwd: ok={ok} max_abs_err={row['max_abs_err']:.3e} "
          f"(rtol 2e-4, atol 1e-6 + 1e-6 x sum |terms|) kernel {row['ms']:.4f} ms "
          f"(the sort and the starts included), plain {row['plain_ms']:.4f} ms, index_add_ "
          f"{row['library_ms']:.4f} ms, bound {row['bound'][0]:.4f} ms ({row['bound'][1]}), "
          f"{fg} foreground px [{gpu}]", flush=True)
    if not ok:
        fail(f"setup_rows_bwd disagrees with its plain version: {row}")
    return row


def auto_phase(gpu):
    """Phase 10: DiffDope with raster_impl auto on an 80-triangle mesh, run
    twice: the brute force's row gather sums in a fixed order (the
    segmented sum, once a step), so the two runs equal bit for bit."""
    import numpy as np
    import torch

    import diffdope_tpu_torch as tdd
    from diffdope_tpu_torch import kernels

    verts, faces = tdd.icosphere(1)
    mesh = tdd.Mesh(pos=verts * 0.5, pos_idx=faces, vtx_normals=verts,
                    num_vertices=len(verts), num_triangles=len(faces),
                    vtx_color=verts * 0.5 + 0.5, edge_adj=tdd.build_edge_adjacency(faces))
    dd, points, mtx_gt = diffdope_session(True, hyper=AUTO_HYPER, mesh=mesh)
    impl = dd._impl(dd._mesh_arrays())
    print(f"DiffDope auto: {len(faces)} triangles -> raster_impl {impl}", flush=True)
    if impl != "reference":
        fail(f"DiffDope auto picked {impl} on {len(faces)} triangles")
    results = []
    for run in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        dd.run_optimization()
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launches.items() if v}
        stats = dd.last_run_stats
        total = dd._result.total_loss.cpu()
        add0 = add_to(points, mtx_gt, dd.object3d.initial_matrix())
        add1 = add_to(points, mtx_gt, dd.get_pose())
        print(f"DiffDope auto run {run}: {stats['steps']} steps, B={dd.batchsize}, "
              f"{dd.resolution[1]}x{dd.resolution[0]}: {stats['wall_time_s']:.4f} s, "
              f"{stats['steps_per_sec']:.3f} steps/s, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; loss first "
              f"{float(total[0]):.6f}, last {float(total[-1]):.6f}; ADD {add0:.6f} -> "
              f"{add1:.6f} [{gpu}]", flush=True)
        print(f"DiffDope auto run {run} launches: {launches}", flush=True)
        runs = stats["steps"] * (1 + stats["recovery_reruns"])
        if launches != {"index_rows_bwd": runs}:
            fail(f"DiffDope auto: {launches} in {runs} steps; the brute force launches the "
                 "segmented sum of its row gather once a step and nothing else")
        if not bool(np.isfinite(total.numpy()).all()) or not float(total[-1]) < float(total[0]):
            fail(f"DiffDope auto: the loss did not fall ({total.numpy()})")
        results.append(dd._result)
    differ = result_diff(*results)
    if differ:
        fail(f"DiffDope auto: two runs differ in {differ}")
    print("DiffDope auto: two runs equal bit for bit (poses, totals, loss logs), without "
          "deterministic algorithms", flush=True)


def k9_check(label, gpu, proj, mtx, pos, tri, colors, adj, resolution, tile_hw, reps=0):
    """K9 forward and backward against their plain versions on the packed
    rows and bins of the mesh at poses ``mtx``; fails on a disagreement.
    Returns the two rows."""
    import torch

    from diffdope_tpu_torch.geometry import matmul44, xfm_points
    from diffdope_tpu_torch.kernels.check import check_gather_rows, gather_rows_inputs

    cuda = torch.device("cuda")
    with torch.no_grad():
        pos_clip = xfm_points(torch.as_tensor(pos, device=cuda),
                              matmul44(torch.as_tensor(proj, device=cuda), mtx))
        inputs = gather_rows_inputs(pos_clip, torch.as_tensor(tri, device=cuda).long(),
                                    resolution, tile_hw,
                                    torch.as_tensor(colors, device=cuda),
                                    torch.as_tensor(adj, device=cuda).long())
    rows = check_gather_rows(*inputs, resolution, tile_hw, reps)
    for row in rows:
        held = (f", held slots only {row['bound_held'][0]:.4f} ms" if "bound_held" in row
                else "")
        times = (f" kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
                 f"{row['bound'][0]:.4f} ms ({row['bound'][1]}){held} [{gpu}]" if reps else "")
        print(f"{label} {row['name']} tile {tile_hw}, {resolution[1]}x{resolution[0]}, "
              f"B={mtx.shape[0]}: ok={row['ok']} max_abs_err={row['max_abs_err']:.3e} "
              f"({row['tolerance']}){slots(row)}{times}", flush=True)
        if not row["ok"]:
            fail(f"{row['name']} disagrees with its plain version ({label}, tile "
                 f"{tile_hw}): {row}")
    return rows


def planar_checks(label, gpu, problem, mtx, d_sums, reps=0):
    """K10 ('v3') or K7 over the gathered bins ('v2'), and K5/K6, against
    their plain versions on a planar bench problem's tables at ``mtx``;
    fails on a disagreement.  Returns the rows by name."""
    from diffdope_tpu_torch.kernels.check import check_kernels

    out = {}
    for row in check_kernels(problem["fn"], mtx, d_sums, reps):
        times = (f" kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
                 f"{row['bound'][0]:.4f} ms ({row['bound'][1]}) [{gpu}]" if reps else "")
        extra = "".join(f", {key} {row[key]}" for key in ("exact_slots", "occupancy")
                        if key in row)
        print(f"{label} {row['name']}: ok={row['ok']} max_abs_err={row['max_abs_err']:.3e} "
              f"({row['tolerance']}){slots(row)}{extra}{times}", flush=True)
        if not row["ok"]:
            fail(f"{row['name']} disagrees with its plain version ({label}): {row}")
        out[row["name"]] = row
    return out


def v3_equals_v2(fn, mtx) -> int:
    """K10's ids and rows on ``fn``'s planar table at poses ``mtx`` against
    K7's over exact per-tile bins gathered from the same table (no
    capacity, no cull): fails unless equal bit for bit; returns the
    foreground pixels compared."""
    import torch

    from diffdope_tpu_torch.render import pipeline
    from diffdope_tpu_torch.render.planar import bin_triangles_planar
    from diffdope_tpu_torch.render.raster import raster_gather_rows_v2
    from diffdope_tpu_torch.render.raster_v3 import raster_gather_rows_v3

    res, t_count = fn.roi[2:], fn.mesh.t_count
    with torch.no_grad():
        packed, cp, det = pipeline._planar_pack(fn.mesh, mtx)
        _, counts, _ = bin_triangles_planar(cp, det, res, pipeline.TILE_HW, t_count)
        k = -(-int(counts.max()) // 128) * 128
        idx, counts, overflow = bin_triangles_planar(cp, det, res, pipeline.TILE_HW, k)
        if int(overflow):
            fail(f"exact bins dropped {int(overflow)} pairs at K={k}")
        ids2, rows2 = raster_gather_rows_v2(packed, idx, counts, None, None, res,
                                            pipeline.TILE_HW, padded=True)
        ids3, rows3 = raster_gather_rows_v3(packed, res, pipeline.TILE_HW, padded=True)
    if not (torch.equal(ids2, ids3) and torch.equal(rows2, rows3)):
        fail(f"K10 and K7 over the gathered bins differ: {int((ids2 != ids3).sum())} ids, "
             f"rows max {float((rows2 - rows3).abs().max()):.3e}")
    return int((ids3 > 0).sum())


def slot_sums_hold(fn, mtx, gpu) -> str:
    """Phase 12's backward sum at its own shapes: the bins ``fn``'s route
    builds at poses ``mtx`` (its capacity and cull), K7's backward of a
    seeded cotangent to d_bins, then ``rasterize.slot_sums`` on the card
    (one launch reading d_bins in place) against its CPU path (an
    index_add in slot order) and against the per-hypothesis sums of d_bins
    transposed into a (slots, 32) buffer (the form before the strides):
    fails unless all three equal bit for bit.  Times the sum (the sort
    and the starts included) beside the transposed form and prints its
    bound: the held slots' 32 lanes read for every hypothesis, their order
    entries, the starts and the (B, T, 32) sums written (the sort of every
    slot by triangle not counted).  Returns the shapes compared."""
    import torch

    from diffdope_tpu_torch import kernels
    from diffdope_tpu_torch.kernels.check import _time_ms, bound
    from diffdope_tpu_torch.render import pipeline
    from diffdope_tpu_torch.render.raster import (
        bins_planar,
        raster_uniform_bwd,
        raster_uniform_fwd,
    )
    from diffdope_tpu_torch.render.rasterize import segments, slot_sums

    res, t_count = fn.roi[2:], fn.mesh.t_count
    with torch.no_grad():
        pl = fn.planar(mtx)
        bins = bins_planar(pl.packed, pl.idx)
        _, rows, win = raster_uniform_fwd(bins, pl.counts, res, pipeline.TILE_HW)
        gen = torch.Generator(device="cuda").manual_seed(12)
        d_rows = torch.randn(rows.shape, generator=gen, device="cuda")
        d_bins = raster_uniform_bwd(d_rows, win, bins.shape[2], pipeline.TILE_HW)
        del bins, rows, win, d_rows
        b, width, n_slots = d_bins.shape
        flat = pl.idx.reshape(1, n_slots)
        ids = torch.where(flat < t_count, flat + 1, 0).to(torch.int32)

        def transposed():
            # the form before the strides: one sort, then each hypothesis's
            # slots copied into one (slots, 32) buffer and summed
            order, start = segments(ids, t_count)
            out = torch.empty((b, t_count, width), device="cuda")
            buf = torch.empty((n_slots, width), device="cuda")
            for i in range(b):
                buf.copy_(d_bins[i].t())
                kernels.launch("dd_segment_sum", "index_rows_bwd", buf.data_ptr(),
                               order.data_ptr(), start.data_ptr(), 1, t_count, width, 0,
                               width, 1, out[i].data_ptr())
            return out.permute(0, 2, 1)

        got = slot_sums(d_bins, pl.idx, t_count)
        old = transposed().cpu()
        ms = _time_ms(lambda: slot_sums(d_bins, pl.idx, t_count), 20)
        old_ms = _time_ms(transposed, 5)
        got = got.cpu()
        want = slot_sums(d_bins.cpu(), pl.idx.cpu(), t_count)
    if not bool(torch.isfinite(got).all()) or not bool((got != 0).any()):
        fail("DiffDope v2: the slot sums are not finite, or all zero")
    for name, other in (("their CPU path", want), ("the transposed buffer's sums", old)):
        if not torch.equal(got, other):
            fail(f"DiffDope v2: the slot sums on the card differ from {name} at "
                 f"{int((got != other).sum())} of {got.numel()} lanes, max "
                 f"{float((got - other).abs().max()):.3e}")
    held = int((pl.idx < t_count).sum())
    lim = bound(4 * (b * width * held + held + t_count + 1 + b * t_count * width),
                b * width * held)
    print(f"DiffDope v2 shapes slot_sums: {ms:.4f} ms a backward (the sort and the starts "
          f"included; the transposed buffer's form {old_ms:.4f} ms), bound {lim[0]:.6f} ms "
          f"({lim[1]}: {held} held slots of {n_slots}, B={b}) [{gpu}]", flush=True)
    return (f"d_bins {tuple(d_bins.shape)}, {t_count} triangles, {held} held slots")


def planar_phases(gpu, step0_f):
    """Phases 11 and 12: DiffDope under DD_RASTER=v3 and DD_BINNED=0;
    returns their launch counts."""
    import numpy as np
    import torch

    from diffdope_tpu_torch.bench import raster_env

    dd3, launches3, add0, add1 = diffdope_phase(True, gpu, "v3", raster="v3")
    check_launches("DiffDope v3", launches3, V3_FUSED, set(launches3) - set(V3_FUSED))
    check_diffdope(dd3, "v3", add0, add1, total_falls=False)
    if dd3.last_run_stats["recovery_reruns"]:
        fail("DiffDope v3: the route bins nothing, yet the run was re-run")
    mtx_last = torch.as_tensor(dd3.mtx_history[-1], device="cuda")
    with raster_env("v3"):
        fn3 = dd3._make_fused_loss_fn(dd3.gt_tensors)
        n_fg = v3_equals_v2(fn3, mtx_last)
        print(f"DiffDope v3: at the last poses K10's ids and rows equal K7's over exact "
              f"bins of the same table bit for bit ({n_fg} foreground px)", flush=True)
        unfused = unfused_step0(dd3)
    step0_3 = {k: v[0] for k, v in dd3.losses_values.items()}
    agree_step0("DiffDope v3 unfused (render_batch through K10) against fused", unfused,
                step0_3, sorted(step0_3))
    del dd3, fn3
    torch.cuda.empty_cache()

    dd2, launches2, add0, add1 = diffdope_phase(True, gpu, "v2", raster="v2")
    check_launches("DiffDope v2", launches2, V2_FUSED, set(launches2) - set(V2_FUSED))
    runs = dd2.last_run_stats["steps"] * (1 + dd2.last_run_stats["recovery_reruns"])
    if launches2["index_rows_bwd"] != runs:
        fail(f"DiffDope v2: the segmented slot sum launched {launches2['index_rows_bwd']} "
             f"times in {runs} steps, not once a step for every hypothesis")
    check_diffdope(dd2, "v2", add0, add1)
    occ = dd2._result.telemetry["_bin_occupancy"]
    print(f"DiffDope v2: bin occupancy at most {int(occ.max())} a step, logged at "
          f"{occ.shape[0]} of {dd2.nb_iterations + 1} steps (the slot-order sum "
          "holds every occurrence)", flush=True)
    if int(occ.min()) <= 0 or occ.shape[0] != dd2.nb_iterations + 1:
        fail("DiffDope v2: a step logged no bin occupancy")
    with raster_env("v2"):
        fn2 = dd2._make_fused_loss_fn(dd2.gt_tensors)
        shapes = slot_sums_hold(fn2, torch.as_tensor(dd2.mtx_history[-1], device="cuda"),
                                gpu)
    print(f"DiffDope v2: at the last poses the segmented slot sums on the card equal "
          f"their CPU path and the transposed buffer's sums bit for bit ({shapes})",
          flush=True)
    del fn2
    torch.cuda.empty_cache()
    step0_2 = {k: v[0] for k, v in dd2.losses_values.items()}
    agree_step0("DiffDope v2 against fused (phase 5)", step0_2, step0_f, sorted(step0_f))
    if all(np.allclose(step0_3[k], step0_2[k], rtol=1e-5, atol=0.0) for k in step0_2):
        agree_step0("DiffDope v3 against v2", step0_3, step0_2, sorted(step0_2))
    else:
        # v3 culls no back face; where phase 12's cull (tpu.cull_backfaces
        # auto) changes the render, its step-0 loss on the same table with
        # the cull off must equal v3's
        print(f"DiffDope v3 against v2: step-0 logs differ ({step0_3} against {step0_2}); "
              "the same on phase 12's table with the cull off:", flush=True)
        dd2.cfg.tpu.cull_backfaces = False
        with raster_env("v2"):
            fn_off = dd2._make_fused_loss_fn(dd2.gt_tensors)
            with torch.no_grad():
                _, logs = fn_off(torch.as_tensor(dd2.mtx_history[0], device="cuda"))
        agree_step0("DiffDope v3 against v2 without the cull", step0_3,
                    {k: logs[k].cpu().numpy() for k in step0_3}, sorted(step0_3))
    return launches3, launches2


def k9_chain(mesh_t, params, k: int, gt, brute: bool):
    """One pass of phase 13's chain at poses ``params``: xfm_points ->
    triangle_setup -> bin_triangles (K ``k``) -> pack_rows -> K9 (or, with
    ``brute``, the brute-force ids and a plain gather of the rows) -> the
    shaded rgb and the antialiased mask -> L1 against gt -> the pose
    gradient; returns ids, rows, the gradients (and those of the rows,
    d_rows, and of the packed rows, d_packed), the loss and the forward and
    backward seconds (synchronized)."""
    import torch

    from diffdope_tpu_torch.geometry import matmul44, xfm_points
    from diffdope_tpu_torch.optimize import pose_matrix
    from diffdope_tpu_torch.render.gather_rows import invert_bins, raster_gather_rows
    from diffdope_tpu_torch.render.rasterize import raster_ids_reference
    from diffdope_tpu_torch.render.setup_tris import bin_triangles, triangle_setup
    from diffdope_tpu_torch.render.shade import (
        antialias_rows,
        attribute_planes,
        pack_rows,
        shade_from_rows,
        shade_rows,
        silhouette_bits,
    )

    proj, pos, tri, colors, adj = mesh_t
    res = tuple(gt["rgb"].shape[:2])
    p = {name: v.detach().clone().requires_grad_(True) for name, v in params.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mtx, _, _ = pose_matrix(p)
    pos_clip = xfm_points(pos, matmul44(proj, mtx))
    setup = triangle_setup(pos_clip, tri)
    b, t = setup.det.shape
    corner_vals = torch.cat([colors[tri].expand(b, t, 3, 3), pos_clip[:, tri, 2:3]], dim=-1)
    packed = pack_rows(setup, silhouette_bits(setup.det, adj),
                       attribute_planes(corner_vals, setup))
    if brute:
        ids = raster_ids_reference(setup.coef.detach(), res)
        rows = shade_rows(ids, packed, res)["rows"]
    else:
        idx, counts, overflow = bin_triangles(pos_clip[:, tri].detach(), setup.det.detach(),
                                              res, API_TILE, k)
        if int(overflow):
            fail(f"phase 13: bin_triangles dropped {int(overflow)} pairs at K={k}")
        ids, rows = raster_gather_rows(packed, idx, counts, *invert_bins(idx, t, "auto"),
                                       res, API_TILE)
    shd = shade_from_rows(ids, rows, res, attr_channels=3)
    mask = antialias_rows((ids > 0).to(rows.dtype), ids, shd["zw"], rows, res)
    rgb = torch.stack(shd["attrs_list"], dim=-1)
    loss = (rgb - gt["rgb"]).abs().mean() + (mask[..., None] - gt["mask"]).abs().mean()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    *grads, d_rows, d_packed = torch.autograd.grad(loss, list(p.values()) + [rows, packed])
    torch.cuda.synchronize()
    return dict(ids=ids, rows=rows.detach(), loss=float(loss.detach()),
                grads=dict(zip(p, grads)), d_rows=d_rows, d_packed=d_packed,
                fwd_s=t1 - t0, bwd_s=time.perf_counter() - t1)


def k9_phase(gpu):
    """Phase 13: K9 on the API-layout chain at phase 9's frame and poses;
    returns K9's launches on one pass."""
    import numpy as np
    import torch

    from diffdope_tpu_torch import kernels
    from diffdope_tpu_torch.bench import distinct_poses
    from diffdope_tpu_torch.optimize import pose_matrix

    dd, _, _ = diffdope_session(True)
    mesh = dd.object3d.mesh
    res = tuple(dd.resolution)
    cuda = torch.device("cuda")
    mesh_t = (torch.as_tensor(np.asarray(dd.camera.cam_proj, np.float32), device=cuda),
              torch.as_tensor(mesh.pos, device=cuda),
              torch.as_tensor(mesh.pos_idx, device=cuda).long(),
              torch.as_tensor(mesh.vtx_color, device=cuda),
              torch.as_tensor(mesh.edge_adj, device=cuda).long())
    gt_np = dd.gt_tensors
    gt = {"rgb": torch.as_tensor(gt_np["rgb"], device=cuda),
          "mask": torch.as_tensor(gt_np["segmentation"][..., :1], device=cuda)}
    params = distinct_poses(dd.object3d.initial_params(dd.batchsize, cuda), 1e-3)
    mtx, _, _ = pose_matrix(params)
    # K9 on the chain's own inputs, timed; K from the fullest tile
    fwd, _ = k9_check("phase 13 shapes", gpu, dd.camera.cam_proj, mtx.detach(), mesh.pos,
                      mesh.pos_idx, mesh.vtx_color, mesh.edge_adj, res, API_TILE, reps=20)
    k = fwd["k"]
    print(f"phase 13: {res[1]}x{res[0]}, B={dd.batchsize}, {len(mesh.pos_idx)} triangles, "
          f"tile {API_TILE}, K {k}, no pair dropped", flush=True)

    warm = k9_chain(mesh_t, params, k, gt, brute=False)  # warm-up, kept on the host
    warm = {"pose gradients": [g.cpu() for g in warm["grads"].values()],
            "d_rows": [warm["d_rows"].cpu()], "d_packed": [warm["d_packed"].cpu()]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    run = k9_chain(mesh_t, params, k, gt, brute=False)
    launches = dict(kernels.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase 13 (K9): forward {run['fwd_s'] * 1e3:.4f} ms, backward "
          f"{run['bwd_s'] * 1e3:.4f} ms, peak {peak_gib:.3f} GiB, loss {run['loss']:.6f} "
          f"[{gpu}]", flush=True)
    print(f"phase 13 launches: {launches}", flush=True)
    same = {name: all(bool(torch.equal(a.view(torch.int32), c.cpu().view(torch.int32)))
                      for a, c in zip(warm[name], got))
            for name, got in (("pose gradients", run["grads"].values()),
                              ("d_rows", [run["d_rows"]]), ("d_packed", [run["d_packed"]]))}
    print(f"phase 13: warm-up and timed pass bit-identical: {same}", flush=True)
    on = ("gather_rows_fwd", "gather_rows_bwd", "index_rows_bwd")
    check_launches("phase 13", launches, on, set(launches) - set(on))
    if [launches[c] for c in on] != [1, 1, 1]:
        fail(f"phase 13: {launches} for one pass (K9 and the segmented sum of "
             "triangle_setup's corner gather once each)")

    torch.cuda.reset_peak_memory_stats()
    ref = k9_chain(mesh_t, params, k, gt, brute=True)
    print(f"phase 13 (brute force + plain gather): forward {ref['fwd_s'] * 1e3:.4f} ms, "
          f"backward {ref['bwd_s'] * 1e3:.4f} ms, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB [{gpu}]", flush=True)
    n_fg = int((run["ids"] > 0).sum())
    print(f"phase 13: K9 against the brute force: {int((run['ids'] != ref['ids']).sum())} "
          f"of {run['ids'].numel()} ids differ ({n_fg} foreground)", flush=True)
    if not torch.equal(run["ids"], ref["ids"]) or n_fg == 0:
        fail("phase 13: K9's ids differ from the brute force's")
    if not torch.equal(run["rows"], ref["rows"]):
        fail("phase 13: K9's rows differ from a plain gather's")
    for name, g in run["grads"].items():
        want = ref["grads"][name].cpu().numpy()
        if not np.allclose(g.cpu().numpy(), want, rtol=2e-4, atol=1e-6):
            fail(f"phase 13: the pose gradient '{name}' {g.cpu().numpy()} differs from the "
                 f"plain-gather path's {want} beyond rtol 2e-4, atol 1e-6")
    print(f"phase 13: ids and rows equal, pose gradients agree at rtol 2e-4, atol 1e-6; "
          f"loss {run['loss']:.6f} / {ref['loss']:.6f}", flush=True)
    return launches["gather_rows_fwd"]


def step0_grads(dd, gt_np=None):
    """The pose gradients at the session's init through its fused loss and
    through its unfused render + loss functions, on the gt arrays ``gt_np``
    (default the session's)."""
    import torch

    from diffdope_tpu_torch.optimize import pose_matrix

    gt_np = dd.gt_tensors if gt_np is None else gt_np
    gt = {k: torch.as_tensor(v, device=dd.device) for k, v in gt_np.items()}
    fused_fn, render_fn = dd._make_fused_loss_fn(gt_np), dd._make_render_fn()

    def grads(objective):
        p = {k: v.requires_grad_(True)
             for k, v in dd.object3d.initial_params(dd.batchsize, dd.device).items()}
        g = torch.autograd.grad(objective(pose_matrix(p)[0]), list(p.values()))
        return {k: v.cpu().numpy() for k, v in zip(p, g)}

    def unfused(mtx):
        renders = render_fn(mtx)
        return sum(fn(renders, gt, dd.learning_rates, dd.loss_weights)[0]
                   for fn in dd.loss_functions)

    return grads(lambda m: fused_fn(m)[0]), grads(unfused)


def grad_gap(got, want) -> float:
    """The largest |got - want| / (1e-6 + 2e-4 |want|) over the pose
    gradients (dicts of arrays): at most 1 where they agree at rtol 2e-4,
    atol 1e-6."""
    import numpy as np

    return max(float(np.max(np.abs(g - want[k]) / (1e-6 + 2e-4 * np.abs(want[k]))))
               for k, g in got.items())


def depth_ties(dd):
    """The real pixels (H, W), any hypothesis, where at the session's init
    the fused and the unfused route differentiate the depth term in
    opposite directions.  The term is |attr_z + gt depth + t_z| * seg0 on
    both, but the fused route adds attr_z to (gt depth + t_z) and the
    unfused one takes (-(attr_z + t_z) - gt depth) * seg0: within a
    rounding of 0 the two residuals can take opposite signs, and at 0
    itself |.|'s derivative (+1 at 0) points opposite ways.  The init
    keeps the configured t_z (``INIT_OFFSET`` has no z), so the
    residual crosses 0 where the offset leaves a surface point's depth
    unchanged."""
    import torch

    from diffdope_tpu_torch.optimize import pose_matrix
    from diffdope_tpu_torch.render.pipeline import _raster
    from diffdope_tpu_torch.render.shade import pixel_ndc, shade_from_rows

    fn = dd._make_fused_loss_fn(dd.gt_tensors)
    mtx0 = pose_matrix(dd.object3d.initial_params(dd.batchsize, dd.device))[0]
    h, w = dd.resolution
    with torch.no_grad():
        ids, rows = _raster(fn.table(mtx0), fn.frame_hw, fn.roi)
        n_ch = 2 if fn.sample is not None else 3  # uv or colours, then z
        shd = shade_from_rows(ids, rows, fn.frame_hw, attr_channels=n_ch + 1,
                              xy=pixel_ndc(fn.frame_hw, fn.roi, device=rows.device))
        attr_z = shd["attrs_list"][n_ch]
        fused = attr_z + fn.dplane(mtx0)
        oy, ox = fn.roi[:2]
        fused = fused[:, : h - oy, : w - ox]
        attr_z = attr_z[:, : h - oy, : w - ox]
        gt = {k: torch.as_tensor(v, device=dd.device) for k, v in dd.gt_tensors.items()}
        gtd = gt["depth"][oy:, ox:][: fused.shape[1], : fused.shape[2]]
        seg0 = gt["segmentation"][oy:, ox:, 0][: fused.shape[1], : fused.shape[2]]
        unfused = (-(attr_z + mtx0[:, 2, 3, None, None]) - gtd) * seg0
        # d/d attr_z: fused +sgn(fused), unfused -sgn(unfused), sgn(0) = +1
        ties = ((fused >= 0) == (unfused >= 0)) & (seg0 > 0)
    out = torch.zeros((h, w), dtype=torch.bool, device=dd.device)
    out[oy: oy + ties.shape[1], ox: ox + ties.shape[2]] = ties.any(dim=0)
    return out


def untie_depth(dd, ties, step: float = 1e-3):
    """The session's gt arrays with the gt depth moved by ``step`` at the
    ``ties`` pixels: both routes then see a residual ~``step`` from 0
    there, far past a rounding, and the same everywhere else."""
    gt = dict(dd.gt_tensors)
    depth = gt["depth"].copy()
    depth[ties.cpu().numpy()] += step
    gt["depth"] = depth
    return gt


def texture_phase(gpu, kind: str, depth: bool):
    """Phase 14: DiffDope with exact texture at the default configuration,
    on the ``kind`` texture, with the depth term if ``depth``.  Each run
    launches K1-K4 and the colour lane once a step, equals the unfused
    texture route's step-0 logs and init pose gradients, and gets closer
    to the gt pose.  On the checker (the main path's run) most hypotheses
    overshoot at the default loss scales, on the fused and the unfused
    route alike (tools/port_texture_trajectories.py), and their bins
    outgrow the init's capacity: the run checks the chosen hypothesis and
    may take the configured re-runs.  On the smooth texture most
    hypotheses' losses must fall, with at most one re-run.  With the depth
    term the gradients are compared with the gt depth moved off the
    pixels where the two routes round the depth residual to opposite signs
    (:func:`depth_ties`; tools/port_texture_gradients.py).  Returns its
    launch counts."""
    losses = dict(TEXTURE_LOSSES, l1_depth_with_mask=depth)
    route = f"texture {kind}" + (" depth" if depth else "")
    checker = kind == "checker"
    dd, launches, add0, add1 = diffdope_phase(True, gpu, route, tpu=TEXTURE_TPU,
                                              losses=losses, mesh=texture_mesh(kind))
    on = tuple(c + "_depth" if c.startswith("loss") and depth else c for c in TEXTURE_FUSED)
    check_launches(f"DiffDope {route}", launches, on, set(launches) - set(on))
    runs = dd.last_run_stats["steps"] * (1 + dd.last_run_stats["recovery_reruns"])
    if any(launches[c] != runs for c in on):
        fail(f"DiffDope {route}: the kernels did not launch once a step ({launches}, "
             f"{runs} steps)")
    fn = dd._make_fused_loss_fn(dd.gt_tensors)
    print(f"DiffDope {route}: texture {dd.object3d.mesh.tex.shape}, packed sampler "
          f"{fn.sample.packed}, gt-seg crop {fn.sample.crop} of {fn.frame_hw}", flush=True)
    if not fn.sample.packed:
        fail(f"DiffDope {route}: the 8-bit texture did not take the packed sampler")
    # the texture route takes no ROI crop, so a hypothesis that overshoots
    # grows the full frame's bins past the init's capacity
    need = dd._result.telemetry["_bin_need"].cpu().numpy()
    print(f"DiffDope {route}: slots a step needs: first {int(need[0])}, most "
          f"{int(need.max())} (step {int(need.argmax())}), last {int(need[-1])}",
          flush=True)
    step0 = {k: v[0] for k, v in dd.losses_values.items()}
    agree_step0(f"DiffDope {route} against its unfused texture route", step0,
                unfused_step0(dd), sorted(step0))
    g_fused, g_unfused = step0_grads(dd)
    gap = grad_gap(g_fused, g_unfused)
    print(f"DiffDope {route}: the init's pose gradients against the unfused route's: "
          f"largest |fused - unfused| / (1e-6 + 2e-4 |unfused|) {gap:.3e}", flush=True)
    if depth:
        ties = depth_ties(dd)
        seg = int((dd.gt_tensors["segmentation"][..., 0] > 0).sum())
        g_fused, g_unfused = step0_grads(dd, untie_depth(dd, ties))
        gap = grad_gap(g_fused, g_unfused)
        print(f"DiffDope {route}: {int(ties.sum())} of {seg} gt-mask pixels round the "
              f"depth residual to opposite signs on the two routes; with the gt depth "
              f"moved off them the gap is {gap:.3e}", flush=True)
        if int(ties.sum()) > MAX_DEPTH_TIES * seg:
            fail(f"DiffDope {route}: {int(ties.sum())} sign ties of the depth residual, "
                 f"more than {MAX_DEPTH_TIES:.1%} of the {seg} gt-mask pixels")
    if gap > 1.0:
        fail(f"DiffDope {route}: the init's pose gradients differ from the unfused "
             f"route's beyond rtol 2e-4, atol 1e-6 ({gap:.3e} of it): fused {g_fused}, "
             f"unfused {g_unfused}")
    max_reruns = int(dd._tpu().get("overflow_retries", 2)) if checker else 1
    check_diffdope(dd, route, add0, add1, total_falls=False, max_reruns=max_reruns,
                   most_fall=not checker)
    return launches


#: phase 15's appearance leaves, each with its segmented sums a step: the
#: texture's four bilinear taps; the vertex colours' corner gather and the
#: plain pack's slot gather of the colours; the corner colours' slot gather
APPEARANCE_GATHERS = {"tex": 4, "vtx_color": 2, "corner_colors": 1}


def appearance_run(gpu, leaf: str):
    """One phase-15 session of the ``leaf`` appearance leaf, run: the leaf
    flat at 0.4 (the scene keeps the mesh's own colours), 11 steps.
    Returns the session, the refined leaf, the launches and the seconds
    run_optimization took."""
    import numpy as np
    import torch

    from diffdope_tpu_torch import kernels

    textured = leaf != "vtx_color"
    dd, _, _ = diffdope_session(True, tpu=TEXTURE_TPU if leaf == "tex" else None,
                                losses=TEXTURE_LOSSES, hyper={"nb_iterations": 10},
                                mesh=texture_mesh() if textured else None)
    mesh = dd.object3d.mesh
    setattr(mesh, leaf, np.full_like(getattr(mesh, leaf), 0.4))
    start = getattr(mesh, leaf)
    mesh.enable_gradients_texture()
    if set(dd._appearance()) != {leaf}:
        fail(f"DiffDope appearance: the session refines {set(dd._appearance())}, not {leaf}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    dd.run_optimization()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    stats = dd.last_run_stats
    refined = getattr(mesh, leaf)
    print(f"DiffDope appearance {leaf}: {stats['steps']} steps, B={dd.batchsize}, leaf "
          f"{refined.shape}: kept run {stats['wall_time_s']:.4f} s, "
          f"{stats['steps_per_sec']:.3f} steps/s; run_optimization {total_s:.4f} s; peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB [{gpu}]", flush=True)
    print(f"DiffDope appearance {leaf} launches: {({k: v for k, v in launches.items() if v})}",
          flush=True)
    if refined is start or not float(np.abs(refined - 0.4).max()) > 1e-5:
        fail(f"DiffDope appearance {leaf}: the leaf did not move or was not written back")
    return dd, refined, launches, total_s


def appearance_phase(gpu):
    """Phase 15: appearance refinement with the pose (the unfused route):
    the texture leaf, then the vertex-colour and the corner-colour leaves,
    each run twice from a session of its own, not under deterministic
    algorithms: the two runs equal bit for bit (poses, totals, loss logs,
    the refined leaf), as the leaves' gathers sum in a fixed order (the
    segmented sum, ``APPEARANCE_GATHERS`` a step); the texture leaf's rgb
    loss falls."""
    import numpy as np

    for leaf, gathers in APPEARANCE_GATHERS.items():
        runs = [appearance_run(gpu, leaf) for _ in range(2)]
        dd, refined, launches, _ = runs[0]
        rgb = dd.losses_values["rgb"].mean(axis=1)
        print(f"DiffDope appearance {leaf}: mean rgb loss {rgb[0]:.6f} -> {rgb[-1]:.6f}; "
              f"the leaf moved up to {float(np.abs(refined - 0.4).max()):.6f} from 0.4",
              flush=True)
        steps = dd.last_run_stats["steps"] * (1 + dd.last_run_stats["recovery_reruns"])
        # the texture's static uv takes the pack kernel; traced colours the
        # plain pack, which launches nothing
        on = (("pack_fwd", "pack_bwd") if leaf == "tex" else ("pack_plain",)) + (
            "raster_fwd", "raster_bwd", "index_rows_bwd")
        check_launches(f"DiffDope appearance {leaf}", launches, on, set(launches) - set(on))
        if launches["index_rows_bwd"] != gathers * steps:
            fail(f"DiffDope appearance {leaf}: the segmented sum launched "
                 f"{launches['index_rows_bwd']} times in {steps} steps, not {gathers} a step")
        if leaf == "tex" and not rgb[-1] < rgb[0]:
            fail("DiffDope appearance tex: the rgb loss did not fall")
        (dd2, refined2, launches2, _) = runs[1]
        differ = result_diff(dd._result, dd2._result)
        if launches2 != launches:
            differ.append(f"launches {launches} / {launches2}")
        if not same_bits(refined, refined2):
            differ.append("the leaf written back")
        if differ:
            fail(f"DiffDope appearance {leaf}: two runs differ in {differ}")
        print(f"DiffDope appearance {leaf}: two runs equal bit for bit (poses, totals, loss "
              "logs, the refined leaf, launches), without deterministic algorithms",
              flush=True)


class BinningInRefine:
    """Counts the per-step binnings (``pipeline.bin_triangles_planar``
    called while a ``optimize.CapturedRefine`` call runs: every segment
    and restart chunk of a run) for as long as it is entered; the capacity
    probes, the precompute and the final-pose check bin outside the
    refinement."""

    def __enter__(self):
        from diffdope_tpu_torch import optimize
        from diffdope_tpu_torch.render import pipeline

        self.count, self._in = 0, False
        self._saved = (pipeline.bin_triangles_planar, optimize.CapturedRefine.__call__)
        bin_fn, refine_fn = self._saved

        def counted_bins(*args, **kwargs):
            self.count += int(self._in)
            return bin_fn(*args, **kwargs)

        def counted_refine(*args, **kwargs):
            self._in = True
            try:
                return refine_fn(*args, **kwargs)
            finally:
                self._in = False

        pipeline.bin_triangles_planar = counted_bins
        optimize.CapturedRefine.__call__ = counted_refine
        return self

    def __exit__(self, *exc):
        from diffdope_tpu_torch import optimize
        from diffdope_tpu_torch.render import pipeline

        pipeline.bin_triangles_planar, optimize.CapturedRefine.__call__ = self._saved


class Captures:
    """The CUDA graphs captured while entered: each capture's host time (s)
    and the bytes its memory pool reserved, read from the public counters
    (``captures``, ``capture_s``, ``pool_bytes``) of every
    ``optimize.CapturedRefine`` call (a call captures at most once)."""

    def __enter__(self):
        from diffdope_tpu_torch import optimize

        self.times, self.pools = [], []
        self._own = own = optimize.CapturedRefine.__call__

        def counted(refine, *args, **kwargs):
            captures, seconds = refine.captures, refine.capture_s
            try:
                return own(refine, *args, **kwargs)
            finally:
                if refine.captures > captures:
                    self.times.append(refine.capture_s - seconds)
                    self.pools.append(refine.pool_bytes)

        optimize.CapturedRefine.__call__ = counted
        return self

    def __exit__(self, *exc):
        from diffdope_tpu_torch import optimize

        optimize.CapturedRefine.__call__ = self._own

    @property
    def count(self) -> int:
        return len(self.times)

    def summary(self) -> str:
        return (f"{self.count} capture(s) of {[round(1e3 * t, 3) for t in self.times]} ms, "
                f"pools {[round(b / 2 ** 20, 1) for b in self.pools]} MiB")


class LogLines:
    """Collects the records of ``DiffDope``'s logger whose message starts
    with ``prefix`` (default: the "step i/N loss x" lines of
    ``tpu.live_loss: step``) or, with ``contains``, holds it."""

    def __init__(self, prefix: str = "step ", contains=None):
        self.prefix, self.contains = prefix, contains

    def __enter__(self):
        import logging

        self.lines = []
        outer = self

        class Handler(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if (msg.startswith(outer.prefix) if outer.contains is None
                        else outer.contains in msg):
                    outer.lines.append(msg)

        self._logger = logging.getLogger("diffdope_tpu_torch.diffdope")
        self._level = self._logger.level
        self._handler = Handler()
        self._logger.addHandler(self._handler)
        self._logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self._handler)
        self._logger.setLevel(self._level)


def write_scene_files(root: Path, gpu: str, label: str = "phase 16"):
    """Phase 16's setup: the textured stand-in (a copy of
    ``data/standins/standin_tex_checker.ply`` beside ``make_texture('checker')``
    as the PNG its TextureFile names) rendered at the camera's full
    1920x1080 at the configured pose, written as rgb.png (8-bit), depth.png
    (16-bit, depth x depth_scale rounded) and seg.png (8-bit), each row
    filtered by turns with all five PNG filters, flipped as the loader
    flips them back.  Returns the paths, the quantised arrays as written
    (unflipped) and the gt pose."""
    import shutil

    import numpy as np
    import torch

    from diffdope_tpu_torch.camera import Camera
    from diffdope_tpu_torch.config import ConfigNode
    from diffdope_tpu_torch.mesh import load_mesh
    from diffdope_tpu_torch.object3d import Object3D
    from diffdope_tpu_torch.optimize import pose_matrix
    from diffdope_tpu_torch.render.pipeline import compact_capacity, render_batch
    from diffdope_tpu_torch.testing import write_png
    from tools.make_standins import make_texture

    ply = root / "standin_tex_checker.ply"
    shutil.copy(HERE / "data/standins/standin_tex_checker.ply", ply)
    tex8 = np.round(make_texture("checker") * 255).astype(np.uint8)
    write_png(root / "standin_checker.png", tex8, filters="cycle")
    cfg = ConfigNode(copy.deepcopy(DEFAULT_CONFIG))
    camera = Camera(**cfg.camera)
    mesh = load_mesh(ply, scale=cfg.object3d.scale)
    if not mesh.has_textured_map:
        fail(f"{label}: the textured PLY loaded without its texture")
    gt_obj = Object3D(position=cfg.object3d.position, rotation=cfg.object3d.rotation,
                      scale=cfg.object3d.scale, mesh=mesh, batchsize=1)
    mtx_gt = pose_matrix(gt_obj.initial_params(1, "cuda"))[0]
    h, w = cfg.camera.im_height, cfg.camera.im_width
    t_all = len(mesh.pos_idx)
    cap = compact_capacity(camera.cam_proj, mesh.pos, mesh.pos_idx, mtx_gt, (h, w), t_all,
                           device="cuda")
    with torch.no_grad():
        gt = render_batch(camera.cam_proj, mtx_gt, mesh.pos, mesh.pos_idx, (h, w),
                          edge_adj=mesh.edge_adj, max_tris_per_tile=t_all, compact_total=cap,
                          tex=mesh.tex, uv=mesh.uv, uv_idx=mesh.uv_idx, device="cuda")
    if int(gt["_bin_overflow"]):
        fail(f"{label}: the full-frame gt render dropped (tile, triangle) pairs")
    scale = float(DEFAULT_DEPTH_SCALE)
    arrays = {
        "rgb": np.round(gt["rgb"][0].cpu().numpy()[::-1] * 255).astype(np.uint8),
        "depth": np.round(gt["depth"][0].cpu().numpy()[::-1] * scale).astype(np.uint16),
        "seg": np.round(gt["mask"][0, ..., 0].cpu().numpy()[::-1] * 255).astype(np.uint8),
    }
    paths = {}
    for name, array in arrays.items():
        paths[name] = root / f"{name}.png"
        write_png(paths[name], array, filters="cycle")
    print(f"{label}: wrote {w}x{h} rgb, depth (16-bit) and seg PNGs and the "
          f"{tex8.shape[1]}x{tex8.shape[0]} texture, every row filter by turns", flush=True)
    return paths, arrays, ply, mtx_gt[0]


def files_session(paths, ply, tpu=None, losses=None):
    """``DiffDope(cfg)`` from ``DEFAULT_CONFIG`` with only the scene's
    paths, the model path and the init (``INIT_OFFSET`` from the
    configured pose) changed; ``tpu`` and ``losses`` override their
    groups.  Returns (dd, points, seconds to build it)."""
    import numpy as np
    import torch

    from diffdope_tpu_torch.config import ConfigNode
    from diffdope_tpu_torch.diffdope import DiffDope
    from diffdope_tpu_torch.geometry import (
        matrix33_from_quat,
        quat_from_axis_angle,
        quat_from_matrix33,
    )

    cfg = ConfigNode(copy.deepcopy(DEFAULT_CONFIG))
    cfg.scene.path_img = str(paths["rgb"])
    cfg.scene.path_depth = str(paths["depth"])
    cfg.scene.path_segmentation = str(paths["seg"])
    cfg.object3d.model_path = str(ply)
    rot_cv = np.asarray(cfg.object3d.rotation, np.float64).reshape(3, 3)
    dq = quat_from_axis_angle(np.asarray(INIT_OFFSET["axis"]),
                              np.deg2rad(INIT_OFFSET["degrees"]))
    dr = matrix33_from_quat(torch.as_tensor(dq)).numpy()
    cfg.object3d.position = (np.asarray(cfg.object3d.position)
                             + INIT_OFFSET["translation_mm"]).tolist()
    cfg.object3d.rotation = quat_from_matrix33(dr @ rot_cv).tolist()
    for key, value in (tpu or {}).items():
        cfg.tpu[key] = value
    for key, value in (losses or {}).items():
        cfg.losses[key] = value
    t0 = time.perf_counter()
    dd = DiffDope(cfg=cfg)
    seconds = time.perf_counter() - t0
    mesh = dd.object3d.mesh
    return dd, torch.as_tensor(mesh.pos[: mesh.num_vertices], device="cuda"), seconds


def files_read_back(dd, arrays) -> None:
    """Phase 16 (a): the session's gt arrays are the written files through
    the reference's rules: rgb and mask the plain 2x2 mean of the
    quantised values (within float32 rounding), depth the nearest
    (top-left) sample within half a unit of depth_scale."""
    import numpy as np

    gt = dd.gt_tensors
    h, w = dd.resolution

    def mean2(q):
        q = q[::-1].astype(np.float64)  # the loader's flip
        return ((q[0::2, 0::2] + q[0::2, 1::2]) + (q[1::2, 0::2] + q[1::2, 1::2])) / 1020.0

    rgb, seg = mean2(arrays["rgb"]), mean2(arrays["seg"])[..., None].repeat(3, -1)
    depth = arrays["depth"][::-1][0::2, 0::2].astype(np.float64) / DEFAULT_DEPTH_SCALE
    worst = {"rgb": float(np.abs(gt["rgb"] - rgb).max()),
             "segmentation": float(np.abs(gt["segmentation"] - seg).max()),
             "depth": float(np.abs(gt["depth"] - depth).max())}
    print(f"phase 16 (a): gt arrays {w}x{h}: largest |read - written| {worst} "
          f"(limits: rgb and mask 1.2e-7, float32 rounding; depth {0.5 / DEFAULT_DEPTH_SCALE})",
          flush=True)
    if gt["rgb"].shape != (h, w, 3) or gt["depth"].shape != (h, w):
        fail(f"phase 16 (a): gt shapes {gt['rgb'].shape}, {gt['depth'].shape}")
    if worst["rgb"] > 1.2e-7 or worst["segmentation"] > 1.2e-7:
        fail("phase 16 (a): the rgb or mask read back is not the 2x2 mean of the file")
    if worst["depth"] > 0.5 / DEFAULT_DEPTH_SCALE + 1e-6:
        fail("phase 16 (a): the depth read back is not the file's nearest sample")


def png_read_times(paths, gpu: str) -> None:
    """Phase 16: each file's read time (best of three)."""
    from diffdope_tpu_torch import png

    for name, path in paths.items():
        read = png.imread_color if name != "depth" else png.imread_unchanged
        best = min(_timed(read, path) for _ in range(3))
        print(f"phase 16: PNG read {name} ({path.stat().st_size} bytes): {best:.4f} s "
              f"[{gpu}; host CPU]", flush=True)


def _timed(fn, *args) -> float:
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def other_formats(root: Path, ply: Path) -> None:
    """Phase 16 (d): the stand-in written as binary STL, ascii STL and a
    .glb with its checker texture embedded as PNG, each loaded and held to
    the PLY load: triangle corners exactly (STL welds its vertices in its
    own order), the glb's vertices, faces, uv, texture and baked corner
    colours exactly."""
    import numpy as np

    from diffdope_tpu_torch.mesh import load_mesh, load_ply
    from diffdope_tpu_torch.testing import png_bytes, write_gltf, write_stl

    scale = DEFAULT_CONFIG["object3d"]["scale"]
    data = load_ply(ply)
    ref = load_mesh(ply, scale=scale)
    corners = ref.pos[ref.pos_idx[: ref.num_triangles]]
    for binary in (True, False):
        path = root / f"standin_{'binary' if binary else 'ascii'}.stl"
        write_stl(path, data["vertices"], data["faces"], binary=binary)
        m = load_mesh(path, scale=scale)
        same = (m.num_triangles == ref.num_triangles and np.array_equal(
            m.pos[m.pos_idx[: m.num_triangles]], corners))
        print(f"phase 16 (d): {path.name}: {m.num_vertices} vertices, {m.num_triangles} "
              f"triangles, corners equal to the PLY's: {same}", flush=True)
        if not same:
            fail(f"phase 16 (d): {path.name} differs from the PLY load")
    tex8 = np.round(ref.tex * 255).astype(np.uint8)
    uv = np.stack([data["uv"][:, 0], 1.0 - data["uv"][:, 1]], -1)  # glTF: v down
    glb = root / "standin.glb"
    write_gltf(glb, data["vertices"], data["faces"], uv=uv, image=png_bytes(tex8, "cycle"))
    m = load_mesh(glb, scale=scale)
    fields = ("pos", "pos_idx", "uv", "uv_idx", "tex", "corner_colors")
    equal = {k: bool(np.array_equal(getattr(m, k), getattr(ref, k))) for k in fields}
    print(f"phase 16 (d): {glb.name} ({glb.stat().st_size} bytes): equal to the PLY "
          f"load: {equal}", flush=True)
    if not all(equal.values()):
        fail("phase 16 (d): the glb differs from the PLY load")


def files_phase(gpu: str):
    """Phase 16: the default configuration from files; returns the
    launches of run (c)."""
    import tempfile

    import numpy as np
    import torch

    from diffdope_tpu_torch.optimize import pose_matrix

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        paths, arrays, ply, mtx_gt = write_scene_files(root, gpu)
        png_read_times(dict(paths, texture=root / "standin_checker.png"), gpu)

        # (a) the files read back, (b) the default losses
        dd, points, build_s = files_session(paths, ply)
        print(f"phase 16: DiffDope(cfg) from files built in {build_s:.4f} s (the three "
              f"PNGs and the textured PLY read, resized to {dd.resolution[1]}x"
              f"{dd.resolution[0]}) [{gpu}]", flush=True)
        files_read_back(dd, arrays)
        dd, launches, add0, add1 = diffdope_phase(True, gpu, "from files", session=(
            dd, points, mtx_gt))
        check_launches("DiffDope from files", launches, COMPACT_FUSED,
                       set(launches) - set(COMPACT_FUSED))
        check_diffdope(dd, "from files", add0, add1)
        del dd
        torch.cuda.empty_cache()

        # (c) restarts, init jitter, precomputed bins, the live loss, rgb + depth
        dd, points, _ = files_session(paths, ply, tpu=FILES_OPTIONS, losses=FILES_LOSSES)
        with BinningInRefine() as binning, LogLines() as live:
            dd, launches_c, add0, add1 = diffdope_phase(True, gpu, "from files, options",
                                                        session=(dd, points, mtx_gt))
        steps = dd.nb_iterations + 1
        reruns = dd.last_run_stats["recovery_reruns"]
        print(f"phase 16 (c): {dd.mtx_history.shape[0]} steps logged, {len(live.lines)} "
              f"live lines over {reruns + 1} run(s) (first {live.lines[:1]}, last "
              f"{live.lines[-1:]}); per-step binnings inside the refinement: "
              f"{binning.count}; bins {tuple(dd._bins.idx.shape)} holding "
              f"{int(dd._bins.counts.sum())} pairs, {dd._bins_escaped} pairs of the "
              f"final poses outside them", flush=True)
        if dd.mtx_history.shape[0] != steps or len(live.lines) != steps * (reruns + 1):
            fail("phase 16 (c): not one logged step and one live line a step")
        if binning.count:
            fail(f"phase 16 (c): the refinement binned {binning.count} times")
        on = ("pack_fwd", "pack_bwd", "raster_fwd", "raster_bwd", "loss_fwd_depth",
              "loss_bwd_depth")
        check_launches("DiffDope from files, options", launches_c, on,
                       set(launches_c) - set(on))
        init = pose_matrix(dd.object3d.initial_params(1, "cuda"))[0][0].cpu().numpy()
        off = float(np.abs(dd.mtx_history[0][0] - init).max())
        print(f"phase 16 (c): hypothesis 0 starts {off:.3e} from the unjittered init, the "
              f"others up to {float(np.abs(dd.mtx_history[0][1:] - init).max()):.3e}",
              flush=True)
        if off > 1e-6:
            fail("phase 16 (c): hypothesis 0 does not start at the unjittered init")
        if np.allclose(dd.mtx_history[0][1:], init[None]):
            fail("phase 16 (c): the other hypotheses start unjittered")
        check_diffdope(dd, "from files, options", add0, add1, total_falls=False,
                       max_reruns=2, most_fall=False)
        del dd
        torch.cuda.empty_cache()

        # (d) STL and glb
        other_formats(root, ply)
    return launches_c


def exif_app1(orientation: int) -> bytes:
    """A JPEG APP1 segment of EXIF holding IFD0's orientation tag alone."""
    tiff = b"MM\x00*\x00\x00\x00\x08\x00\x01" \
        + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0) + b"\x00" * 4
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def write_jpeg_files(root: Path, arrays, ply: Path):
    """Phase 21's files beside phase 16's: rgb.jpg, the frame turned so
    that ``JPEG_ORIENTATION`` 6 (transpose, then flip left-right) gives it
    back, written by cv2 at ``JPEG_QUALITY`` and 4:2:0 with the EXIF APP1
    after SOI; the checker texture as standin_checker.jpg and a copy of
    the PLY naming it.  Returns (rgb.jpg, texture JPEG, PLY)."""
    import cv2
    import numpy as np

    from diffdope_tpu_torch import png

    params = [cv2.IMWRITE_JPEG_QUALITY, JPEG_QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
    stored = np.ascontiguousarray(arrays["rgb"][:, ::-1].swapaxes(0, 1)[..., ::-1])
    ok, enc = cv2.imencode(".jpg", stored, params)
    if not ok:
        fail("phase 21: cv2 did not encode the rgb frame")
    data = enc.tobytes()
    rgb = root / "rgb.jpg"
    rgb.write_bytes(data[:2] + exif_app1(JPEG_ORIENTATION) + data[2:])
    tex = png.imread_color(root / "standin_checker.png")
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(tex[..., ::-1]), params)
    if not ok:
        fail("phase 21: cv2 did not encode the texture")
    tex_jpg = root / "standin_checker.jpg"
    tex_jpg.write_bytes(enc.tobytes())
    ply_jpg = root / "standin_tex_jpeg.ply"
    text = ply.read_text()
    if "standin_checker.png" not in text:
        fail("phase 21: the PLY does not name its PNG texture")
    ply_jpg.write_text(text.replace("standin_checker.png", tex_jpg.name))
    return rgb, tex_jpg, ply_jpg


def jpeg_phase(gpu: str) -> None:
    """Phase 21: the default configuration from JPEG files (rgb and the
    texture), each read held to the card host's cv2 bit for bit, the read
    times of the rgb frame as JPEG and as PNG, then phase 16 (b)."""
    import tempfile

    import cv2
    import numpy as np
    import torch

    from diffdope_tpu_torch import png

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        paths, arrays, ply, mtx_gt = write_scene_files(root, gpu, label="phase 21")
        rgb_jpg, tex_jpg, ply_jpg = write_jpeg_files(root, arrays, ply)
        color = lambda p: cv2.cvtColor(cv2.imread(str(p), cv2.IMREAD_COLOR),  # noqa: E731
                                       cv2.COLOR_BGR2RGB)
        unchanged = lambda p: cv2.imread(str(p), cv2.IMREAD_UNCHANGED)  # noqa: E731
        reads = {"rgb.jpg colour": (rgb_jpg, png.imread_color, color),
                 "rgb.jpg unchanged": (rgb_jpg, png.imread_unchanged, unchanged),
                 "texture jpg colour": (tex_jpg, png.imread_color, color),
                 "seg.png colour": (paths["seg"], png.imread_color, color),
                 "depth.png unchanged": (paths["depth"], png.imread_unchanged, unchanged)}
        for name, (path, read, cv2_read) in reads.items():
            got, want = read(path), cv2_read(path)
            equal = (got.dtype == want.dtype and got.shape == want.shape
                     and bool(np.array_equal(got, want)))
            print(f"phase 21: {name} ({path.stat().st_size} bytes) {got.shape} "
                  f"{got.dtype}: equal to cv2 {cv2.__version__}'s bit for bit: {equal}",
                  flush=True)
            if not equal:
                fail(f"phase 21: the port's read of {name} differs from cv2's")
        frame = png.imread_color(rgb_jpg)
        err = np.abs(frame.astype(np.int64) - arrays["rgb"])
        print(f"phase 21: rgb.jpg as read (EXIF orientation {JPEG_ORIENTATION} applied) "
              f"against the rendered frame: largest difference {int(err.max())}, mean "
              f"{float(err.mean()):.4f} (uint8 steps)", flush=True)
        if frame.shape != arrays["rgb"].shape or float(err.mean()) > 2.0:
            fail("phase 21: the JPEG frame does not read back as the rendered frame")
        times = {}
        for name, path in (("jpeg", rgb_jpg), ("png", paths["rgb"])):
            times[name] = min(_timed(png.imread_color, path) for _ in range(3))
        print(f"phase 21: read of the {arrays['rgb'].shape[1]}x{arrays['rgb'].shape[0]} "
              f"rgb frame: JPEG (quality {JPEG_QUALITY}, 4:2:0, {rgb_jpg.stat().st_size} "
              f"bytes) {times['jpeg']:.4f} s, PNG ({paths['rgb'].stat().st_size} bytes) "
              f"{times['png']:.4f} s, best of three each [{gpu}; host CPU]", flush=True)

        dd, points, build_s = files_session(dict(paths, rgb=rgb_jpg), ply_jpg)
        print(f"phase 21: DiffDope(cfg) from rgb.jpg, depth.png, seg.png and the PLY with "
              f"its JPEG texture built in {build_s:.4f} s [{gpu}]", flush=True)
        q = cv2.cvtColor(cv2.imread(str(rgb_jpg)), cv2.COLOR_BGR2RGB)[::-1].astype(np.float64)
        mean2 = ((q[0::2, 0::2] + q[0::2, 1::2]) + (q[1::2, 0::2] + q[1::2, 1::2])) / 1020.0
        gap = float(np.abs(dd.gt_tensors["rgb"] - mean2).max())
        tex = png.imread_color(tex_jpg).astype(np.float32) / 255.0
        same_tex = bool(np.array_equal(np.asarray(dd.object3d.mesh.tex), tex))
        print(f"phase 21: gt rgb against the 2x2 mean of cv2's decode: {gap:.3e} (limit "
              f"1.2e-7, float32 rounding); the mesh's texture is the JPEG's: {same_tex}",
              flush=True)
        if gap > 1.2e-7 or not same_tex:
            fail("phase 21: the session's rgb or texture is not the JPEG's")
        dd, launches, add0, add1 = diffdope_phase(True, gpu, "from JPEG", session=(
            dd, points, mtx_gt))
        check_launches("DiffDope from JPEG", launches, COMPACT_FUSED,
                       set(launches) - set(COMPACT_FUSED))
        check_diffdope(dd, "from JPEG", add0, add1)
        del dd
        torch.cuda.empty_cache()
    print(f"phase 21: {time.perf_counter() - t_phase:.4f} s [{gpu}]", flush=True)


def write_webp_files(root: Path, arrays, ply: Path):
    """Phase 23's files beside phase 16's, written by the card host's cv2:
    rgb.webp and seg.webp lossless (``IMWRITE_WEBP_QUALITY`` 101), the rgb
    frame lossy at qualities 50 and 90, and a .glb of the stand-in whose
    texture is the checker as a lossy WebP (quality 90) embedded in its
    binary chunk.  Returns (files by name, the .glb, the texture's bytes)."""
    import cv2
    import numpy as np

    from diffdope_tpu_torch import png
    from diffdope_tpu_torch.mesh import load_ply
    from diffdope_tpu_torch.testing import write_gltf

    bgr = np.ascontiguousarray(arrays["rgb"][..., ::-1])
    files = {}
    for name, img, quality in (("rgb.webp", bgr, WEBP_LOSSLESS), ("seg.webp", arrays["seg"],
                                                                   WEBP_LOSSLESS),
                               ("rgb_q50.webp", bgr, 50), ("rgb_q90.webp", bgr, 90)):
        files[name] = root / name
        if not cv2.imwrite(str(files[name]), img, [cv2.IMWRITE_WEBP_QUALITY, quality]):
            fail(f"phase 23: cv2 did not write {name}")
    tex = png.imread_color(root / "standin_checker.png")
    ok, tex_webp = cv2.imencode(".webp", np.ascontiguousarray(tex[..., ::-1]),
                                [cv2.IMWRITE_WEBP_QUALITY, 90])
    if not ok:
        fail("phase 23: cv2 did not encode the texture")
    data = load_ply(ply)
    uv = np.stack([data["uv"][:, 0], 1.0 - data["uv"][:, 1]], -1)  # glTF: v down
    glb = root / "standin_webp.glb"
    write_gltf(glb, data["vertices"], data["faces"], uv=uv, image=tex_webp.tobytes())
    kinds = {name: path.read_bytes()[12:16].decode() for name, path in files.items()}
    print(f"phase 23: cv2 {cv2.__version__} wrote {kinds} and a .glb embedding the "
          f"{tex.shape[1]}x{tex.shape[0]} texture as a {len(tex_webp)}-byte lossy WebP",
          flush=True)
    if kinds["rgb.webp"] != "VP8L" or kinds["rgb_q90.webp"] != "VP8 ":
        fail("phase 23: cv2's WebP files are not lossless and lossy as asked")
    return files, glb, tex_webp.tobytes()


def webp_phase(gpu: str) -> None:
    """Phase 23: the WebP corpus and phase 16's frame as WebP against the
    card host's cv2, the default configuration from lossless WebP files
    against the same from PNGs, and from a lossy rgb.webp with a .glb whose
    texture is an embedded WebP."""
    import tempfile

    import cv2
    import numpy as np
    import torch

    from diffdope_tpu_torch import png
    from diffdope_tpu_torch.testing import BOTH, webp_variants
    from tools.port_cv2_formats import compare

    t_phase = time.perf_counter()
    variants = webp_variants()
    differ = [row["variant"] for row in compare(variants) if row["differ"]]
    print(f"phase 23: {len(variants)} WebP corpus files read by the port from bytes and "
          f"from a file in both cv2 modes: {len(differ)} differ from cv2 {cv2.__version__} "
          f"{differ[:8]} ({time.perf_counter() - t_phase:.2f} s)", flush=True)
    if differ:
        fail(f"phase 23: the port's reads differ from cv2's on {differ}")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        paths, arrays, ply, mtx_gt = write_scene_files(root, gpu, label="phase 23")
        files, glb, tex_webp = write_webp_files(root, arrays, ply)

        # (a) phase 16's frame as WebP, every read against cv2's
        frames = {name: (path.read_bytes(), BOTH) for name, path in files.items()}
        frames["texture.webp"] = (tex_webp, BOTH)
        t0 = time.perf_counter()
        rows = list(compare(frames))
        differ = [row["variant"] for row in rows if row["differ"]]
        print(f"phase 23 (a): {len(frames)} files of phase 16's scene read by the port from "
              f"bytes and from a file in both modes: {len(differ)} differ from cv2 "
              f"{cv2.__version__} {differ} ({time.perf_counter() - t0:.2f} s)", flush=True)
        if differ:
            fail(f"phase 23 (a): the port's reads differ from cv2's on {differ}")
        for name, path in files.items():
            best = min(_timed(png.imread_color, path) for _ in range(3))
            got = png.imread_color(path)
            print(f"phase 23 (a): {name} ({path.stat().st_size} bytes, {got.shape[1]}x"
                  f"{got.shape[0]}) colour read in {best:.4f} s, best of three [{gpu}; "
                  f"host CPU]", flush=True)
        if not same_bits(png.imread_color(files["rgb.webp"]), arrays["rgb"]):
            fail("phase 23 (a): rgb.webp does not read back as the rendered frame")
        best = min(_timed(png.imread_color, paths["rgb"]) for _ in range(3))
        print(f"phase 23 (a): rgb.png ({paths['rgb'].stat().st_size} bytes) colour read in "
              f"{best:.4f} s, best of three [{gpu}; host CPU]", flush=True)

        # (b) lossless rgb and seg against the PNGs, bit for bit
        runs = {}
        for label, scene in (("lossless WebP", dict(paths, rgb=files["rgb.webp"],
                                                    seg=files["seg.webp"])),
                             ("PNG", paths)):
            dd, points, build_s = files_session(scene, ply, losses=FILES_LOSSES)
            print(f"phase 23 (b): DiffDope(cfg) from the {label} files built in "
                  f"{build_s:.4f} s [{gpu}]", flush=True)
            dd, launches, add0, add1 = diffdope_phase(True, gpu, f"from {label}", session=(
                dd, points, mtx_gt))
            check_launches(f"DiffDope from {label}", launches, COMPACT_DEPTH,
                           set(launches) - set(COMPACT_DEPTH))
            check_diffdope(dd, f"from {label}", add0, add1)
            runs[label] = dict(
                gt={k: np.asarray(v) for k, v in dd.gt_tensors.items()},
                losses={k: np.asarray(v) for k, v in dd.losses_values.items()},
                argmin=dd.get_argmin(), pose=np.asarray(dd.get_pose()))
            del dd
            torch.cuda.empty_cache()
        a, b = runs["lossless WebP"], runs["PNG"]
        gt_equal = {k: same_bits(a["gt"][k], b["gt"][k]) for k in b["gt"]}
        run_equal = {"losses": set(a["losses"]) == set(b["losses"]) and all(
            same_bits(a["losses"][k], b["losses"][k]) for k in b["losses"]),
            "argmin": a["argmin"] == b["argmin"], "get_pose": same_bits(a["pose"], b["pose"])}
        print(f"phase 23 (b): the lossless WebP session against the PNG one: gt arrays "
              f"equal {gt_equal}; {run_equal} bit for bit (argmin {a['argmin']})", flush=True)
        if not (all(gt_equal.values()) and set(a["gt"]) == set(b["gt"])):
            fail("phase 23 (b): the gt arrays from lossless WebP differ from the PNGs'")
        if not all(run_equal.values()):
            fail(f"phase 23 (b): the runs from the two sets of files differ: {run_equal}")

        # (c) a lossy rgb.webp and the .glb with its WebP texture
        dd, points, build_s = files_session(dict(paths, rgb=files["rgb_q90.webp"]), glb)
        want = cv2.cvtColor(cv2.imdecode(np.frombuffer(tex_webp, np.uint8), cv2.IMREAD_COLOR),
                            cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        same_tex = same_bits(np.asarray(dd.object3d.mesh.tex), want)
        print(f"phase 23 (c): DiffDope(cfg) from rgb_q90.webp, depth.png, seg.png and the "
              f".glb built in {build_s:.4f} s; the mesh's texture equals cv2.imdecode's of "
              f"the embedded WebP: {same_tex} [{gpu}]", flush=True)
        if not same_tex:
            fail("phase 23 (c): the .glb's texture is not cv2's decode of its WebP")
        dd, launches, add0, add1 = diffdope_phase(True, gpu, "from lossy WebP", session=(
            dd, points, mtx_gt))
        check_launches("DiffDope from lossy WebP", launches, COMPACT_FUSED,
                       set(launches) - set(COMPACT_FUSED))
        check_diffdope(dd, "from lossy WebP", add0, add1)
        del dd
        torch.cuda.empty_cache()
    print(f"phase 23: {time.perf_counter() - t_phase:.4f} s [{gpu}]", flush=True)


def write_format_files(root: Path, arrays, ply: Path):
    """Phase 22's files beside phase 16's, written by cv2: rgb.bmp
    (24-bit), rgb.ppm (binary), seg.pgm (8-bit), seg.bmp (cv2 writes 8-bit
    grey as a palette BMP), depth.tif (cv2's default for 16 bits: LZW, the
    horizontal predictor, 2-row strips, checked in its directory),
    depth_f32.tif (the same values as float32: deflate, the floating-point
    predictor; ``testing.encode_tiff`` writes it where the host's cv2
    does not), depth.pfm (the same values, ``Pf``), the
    checker texture as standin_checker.tif and a copy of the PLY naming
    it.  Returns (files by name, PLY)."""
    import cv2
    import numpy as np

    from diffdope_tpu_torch import png, tiff
    from diffdope_tpu_torch.testing import encode_tiff

    bgr = np.ascontiguousarray(arrays["rgb"][..., ::-1])
    depth = arrays["depth"]
    files = {name: root / name for name in (
        "rgb.bmp", "rgb.ppm", "seg.pgm", "seg.bmp", "depth.tif", "depth_f32.tif",
        "depth.pfm", "standin_checker.tif")}
    writes = (("rgb.bmp", bgr, []), ("rgb.ppm", bgr, []), ("seg.pgm", arrays["seg"], []),
              ("seg.bmp", arrays["seg"], []), ("depth.tif", depth, []),
              ("depth_f32.tif", depth.astype(np.float32),
               [cv2.IMWRITE_TIFF_COMPRESSION, 8, cv2.IMWRITE_TIFF_PREDICTOR, 3]),
              ("depth.pfm", depth.astype(np.float32), []),
              ("standin_checker.tif",
               np.ascontiguousarray(png.imread_color(root / "standin_checker.png")[..., ::-1]),
               []))
    for name, img, params in writes:
        if not cv2.imwrite(str(files[name]), img, params):
            fail(f"phase 22: cv2 did not write {name}")
    head = tiff._header(files["depth.tif"].read_bytes(), None)
    layout = (head["compression"], head["predictor"], head["block"], len(head["offsets"]))
    print(f"phase 22: depth.tif as cv2 {cv2.__version__} writes it: compression, predictor, "
          f"strip (width, rows), strips = {layout}", flush=True)
    if layout[:2] != (5, 2) or layout[2][1] != 2:
        fail("phase 22: cv2's 16-bit TIFF is not LZW with the horizontal predictor in "
             "2-row strips")
    head = tiff._header(files["depth_f32.tif"].read_bytes(), None)
    print(f"phase 22: depth_f32.tif as cv2 {cv2.__version__} writes it with deflate and "
          f"predictor 3 asked: compression {head['compression']}, predictor "
          f"{head['predictor']}", flush=True)
    if (head["compression"], head["predictor"]) != (8, 3):
        # the host's cv2 did not write what it was asked for float32: the
        # port's writer gives the file its deflate and predictor
        files["depth_f32.tif"].write_bytes(encode_tiff(
            depth.astype(np.float32), compression=8, predictor=3, rows_per_strip=2))
        print("phase 22: depth_f32.tif rewritten by testing.encode_tiff (deflate, "
              "predictor 3, 2-row strips)", flush=True)
    ply_tif = root / "standin_tex_tiff.ply"
    text = ply.read_text()
    if "standin_checker.png" not in text:
        fail("phase 22: the PLY does not name its PNG texture")
    ply_tif.write_text(text.replace("standin_checker.png", "standin_checker.tif"))
    return files, ply_tif


def same_bits(a, b) -> bool:
    import numpy as np

    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and bool(np.array_equal(a, b))


def formats_phase(gpu: str) -> None:
    """Phase 22: the variants against the card host's cv2, then the default
    configuration from TIFF, BMP and Netpbm files against the same from
    PNG files."""
    import tempfile

    import cv2
    import numpy as np
    import torch

    from diffdope_tpu_torch import png
    from diffdope_tpu_torch.image import Image
    from diffdope_tpu_torch.testing import image_variants
    from tools.port_cv2_formats import compare

    t_phase = time.perf_counter()
    variants = image_variants()
    differ = [row["variant"] for row in compare(variants) if row["differ"]]
    print(f"phase 22: {len(variants)} TIFF/BMP/Netpbm variants read by the port from bytes "
          f"and from a file in their cv2 modes: {len(differ)} differ from cv2 "
          f"{cv2.__version__} {differ[:8]} ({time.perf_counter() - t_phase:.2f} s)",
          flush=True)
    if differ:
        fail(f"phase 22: the port's reads differ from cv2's on {differ}")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        paths, arrays, ply, mtx_gt = write_scene_files(root, gpu, label="phase 22")
        files, ply_tif = write_format_files(root, arrays, ply)
        modes = (("unchanged", png.imread_unchanged, cv2.IMREAD_UNCHANGED),
                 ("colour", png.imread_color, cv2.IMREAD_COLOR))
        for name, path in list(files.items()) + [("depth.png", paths["depth"])]:
            for mode, read, flag in modes:
                got, want = read(path), cv2.imread(str(path), flag)
                if want is not None and flag == cv2.IMREAD_COLOR:
                    want = cv2.cvtColor(want, cv2.COLOR_BGR2RGB)
                best = min(_timed(read, path) for _ in range(3))
                shape = None if got is None else (tuple(got.shape), got.dtype.name)
                equal = same_bits(got, want)
                print(f"phase 22: {name} {mode} ({path.stat().st_size} bytes) {shape}: read "
                      f"in {best:.4f} s (best of three) [{gpu}; host CPU]; equal to cv2 "
                      f"{cv2.__version__}'s bit for bit: {equal}", flush=True)
                if not equal:
                    fail(f"phase 22: the port's {mode} read of {name} differs from cv2's")
        depth16 = png.imread_unchanged(files["depth.tif"])
        if not same_bits(depth16, arrays["depth"]):
            fail("phase 22: depth.tif does not read back as the written frame")
        # LZW's worst case: a frame of uniform noise, one code per 1-2 bytes
        noise = root / "depth_noise.tif"
        cv2.imwrite(str(noise), np.random.default_rng(0).integers(
            0, 65536, arrays["depth"].shape, dtype=np.uint16))
        t0 = time.perf_counter()
        got = png.imread_unchanged(noise)
        seconds = time.perf_counter() - t0
        equal = same_bits(got, cv2.imread(str(noise), cv2.IMREAD_UNCHANGED))
        print(f"phase 22: depth_noise.tif (uniform 16-bit noise, {noise.stat().st_size} "
              f"bytes) unchanged: read in {seconds:.4f} s (once) [{gpu}; host CPU]; "
              f"equal to cv2's bit for bit: {equal}", flush=True)
        if not equal:
            fail("phase 22: the port's read of depth_noise.tif differs from cv2's")

        runs = {}
        for label, scene, model in (
                ("BMP/PGM/TIFF", dict(rgb=files["rgb.bmp"], seg=files["seg.pgm"],
                                      depth=files["depth.tif"]), ply_tif),
                ("PNG", paths, ply)):
            dd, points, build_s = files_session(scene, model, losses=FILES_LOSSES)
            print(f"phase 22: DiffDope(cfg) from the {label} files built in {build_s:.4f} s "
                  f"[{gpu}]", flush=True)
            dd, launches, add0, add1 = diffdope_phase(True, gpu, f"from {label}", session=(
                dd, points, mtx_gt))
            check_launches(f"DiffDope from {label}", launches, COMPACT_DEPTH,
                           set(launches) - set(COMPACT_DEPTH))
            check_diffdope(dd, f"from {label}", add0, add1)
            runs[label] = dict(
                gt={k: np.asarray(v) for k, v in dd.gt_tensors.items()},
                losses={k: np.asarray(v) for k, v in dd.losses_values.items()},
                argmin=dd.get_argmin(), pose=np.asarray(dd.get_pose()),
                tex=np.asarray(dd.object3d.mesh.tex), resize=dd.cfg.scene.image_resize)
            del dd
            torch.cuda.empty_cache()
        a, b = runs["BMP/PGM/TIFF"], runs["PNG"]
        gt_equal = {k: same_bits(a["gt"][k], b["gt"][k]) for k in b["gt"]}
        depth_equal = {name: same_bits(Image(img_path=str(files[name]), depth=True,
                                             img_resize=a["resize"]).img_tensor,
                                       a["gt"]["depth"])
                       for name in ("depth_f32.tif", "depth.pfm")}
        run_equal = {"losses": set(a["losses"]) == set(b["losses"]) and all(
            same_bits(a["losses"][k], b["losses"][k]) for k in b["losses"]),
            "argmin": a["argmin"] == b["argmin"], "get_pose": same_bits(a["pose"], b["pose"]),
            "texture": same_bits(a["tex"], b["tex"])}
        print(f"phase 22: the BMP/PGM/TIFF session against the PNG one: gt arrays equal "
              f"{gt_equal}; the float32 TIFF's and the PFM's gt depth equal to the 16-bit "
              f"TIFF's {depth_equal}; {run_equal} bit for bit (argmin {a['argmin']})",
              flush=True)
        if not (all(gt_equal.values()) and set(a["gt"]) == set(b["gt"])):
            fail("phase 22: the gt arrays from BMP/PGM/TIFF differ from the PNGs'")
        if not all(depth_equal.values()):
            fail("phase 22: a float32 depth file gives another gt depth than the 16-bit TIFF")
        if not all(run_equal.values()):
            fail(f"phase 22: the runs from the two sets of files differ: {run_equal}")
    print(f"phase 22: {time.perf_counter() - t_phase:.4f} s [{gpu}]", flush=True)


def write_later_files(root: Path, arrays, ply: Path):
    """Phase 24's files beside phase 16's: seg.tif (1-bit MinIsBlack, LZW)
    and seg.gif (two colours) of the seg mask made two-valued (and the
    same as seg_bin.png), depth_i32.tif and depth_i16.tif (the depth PNG's
    values; deflate, the horizontal predictor), rgb.ras (cv2's 24-bit Sun
    Raster), rgb.hdr (cv2's Radiance HDR of the frame / 255 in float32),
    rgb_jpeg.tif and the checker texture as JPEG-in-TIFF (YCbCr 4:2:0 in
    ``JPEG_TIFF_ROWS``-row strips with shared tables, coded by the host
    cv2's JPEG encoder) and a copy of the PLY naming the texture.  Returns
    (files by name, the PLY, the texture's bytes)."""
    import cv2
    import numpy as np

    from diffdope_tpu_torch import png
    from diffdope_tpu_torch.testing import encode_gif, encode_jpeg_tiff, encode_tiff, write_png

    def jpeg(arr):
        ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(arr[..., ::-1]),
                               [cv2.IMWRITE_JPEG_QUALITY, JPEG_TIFF_QUALITY,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
        if not ok:
            fail("phase 24: cv2 did not encode a JPEG strip")
        return buf.tobytes()

    bits = (arrays["seg"] > 127).astype(np.uint8)
    files = {name: root / name for name in (
        "seg.tif", "seg.gif", "seg_bin.png", "depth_i32.tif", "depth_i16.tif", "rgb.ras",
        "rgb.hdr", "rgb_jpeg.tif")}
    files["seg.tif"].write_bytes(encode_tiff(bits, bits=1, compression=5))
    files["seg.gif"].write_bytes(encode_gif([bits], np.array([[0, 0, 0], [255, 255, 255]],
                                                             np.uint8)))
    write_png(files["seg_bin.png"], bits * 255, filters="cycle")
    depth = arrays["depth"]
    if int(depth.max()) > 32767:
        fail(f"phase 24: depth values up to {int(depth.max())} do not fit 16 signed bits")
    for name, dtype in (("depth_i32.tif", np.int32), ("depth_i16.tif", np.int16)):
        files[name].write_bytes(encode_tiff(depth.astype(dtype), compression=8, predictor=2))
    bgr = np.ascontiguousarray(arrays["rgb"][..., ::-1])
    if not cv2.imwrite(str(files["rgb.ras"]), bgr):
        fail("phase 24: cv2 did not write rgb.ras")
    if not cv2.imwrite(str(files["rgb.hdr"]), bgr.astype(np.float32) / np.float32(255)):
        fail("phase 24: cv2 did not write rgb.hdr")
    files["rgb_jpeg.tif"].write_bytes(encode_jpeg_tiff(arrays["rgb"], jpeg,
                                                       rows_per_strip=JPEG_TIFF_ROWS))
    tex = png.imread_color(root / "standin_checker.png")
    tex_tif = encode_jpeg_tiff(tex, jpeg, rows_per_strip=JPEG_TIFF_ROWS)
    (root / "standin_checker_jpeg.tif").write_bytes(tex_tif)
    ply_tif = root / "standin_tex_jpeg_tiff.ply"
    text = ply.read_text()
    if "standin_checker.png" not in text:
        fail("phase 24: the PLY does not name its PNG texture")
    ply_tif.write_text(text.replace("standin_checker.png", "standin_checker_jpeg.tif"))
    print(f"phase 24: wrote seg.tif (1-bit), seg.gif, depth_i32.tif, depth_i16.tif, rgb.ras, "
          f"rgb.hdr and rgb_jpeg.tif of the {depth.shape[1]}x{depth.shape[0]} scene (seg "
          f"two-valued as written: {bool(np.isin(arrays['seg'], (0, 255)).all())}) and the "
          f"{tex.shape[1]}x{tex.shape[0]} texture as a {len(tex_tif)}-byte JPEG-in-TIFF",
          flush=True)
    return files, ply_tif, tex_tif


def later_variants_check(t_phase: float) -> None:
    """Phase 24 (a): ``testing.format_variants`` against the card host's
    cv2, or against cv2 5.0's committed reads where the host's cv2 lacks
    the format or reads the variant otherwise as the record lists."""
    import hashlib

    import cv2

    from diffdope_tpu_torch.testing import format_variants
    from tools.port_cv2_formats import compare, cv2_formats, format_of, load_recorded

    variants = format_variants()
    rec = load_recorded()
    have = cv2_formats()
    moved = [n for n, (data, _) in variants.items()
             if rec["variants"].get(n, {}).get("sha1") != hashlib.sha1(data).hexdigest()]
    if moved or set(variants) != set(rec["variants"]):
        fail(f"phase 24 (a): the variants' bytes differ from the recorded ones: {moved[:8]}")
    yard = {n: rec["variants"][n] for n in variants
            if format_of(n) not in have or n in rec["differs"]}
    by_format = {}
    for n in variants:
        fmt = format_of(n)
        live = format_of(n) in have
        by_format.setdefault(fmt, f"cv2 {cv2.__version__} (live)" if live else
                             f"cv2 {rec['cv2']} (recorded)")
    rows = list(compare(variants, recorded=yard))
    differ = [row["variant"] for row in rows if row["differ"]]
    # a listed variant: the host's own reads must be the ones listed for it
    unlisted = []
    for row in rows:
        listed = rec["differs"].get(row["variant"])
        if listed is None or format_of(row["variant"]) not in have:
            continue
        host = {k: v for k, v in row.items() if k.startswith(("unchanged", "color"))
                and not k.endswith("port_equal")}
        if host != listed.get(cv2.__version__, listed[rec["cv2"]]):
            unlisted.append(row["variant"])
    others = sorted({v for d in rec["differs"].values() for v in d} - {rec["cv2"]})
    print(f"phase 24 (a): {len(variants)} variants of the later formats read by the port "
          f"from bytes and from a file in both modes; yardsticks {by_format}; "
          f"{len(rec['differs'])} listed as read otherwise by cv2 {others}, the port held "
          f"to cv2 {rec['cv2']} on them; {len(differ)} "
          f"differ {differ[:8]}; {len(unlisted)} read by the host's cv2 otherwise than "
          f"listed {unlisted[:8]} ({time.perf_counter() - t_phase:.2f} s)", flush=True)
    if differ:
        fail(f"phase 24 (a): the port's reads differ from the yardstick on {differ}")
    if unlisted:
        fail(f"phase 24 (a): cv2 {cv2.__version__} reads {unlisted} otherwise than listed")


def later_formats_phase(gpu: str) -> None:
    """Phase 24: the later formats' variants against the card host's cv2
    (or cv2 5.0's record), the default configuration from a 1-bit TIFF,
    a GIF, signed depth TIFFs and a Sun Raster frame against the same from
    PNGs, and from a Radiance HDR frame with a JPEG-in-TIFF texture."""
    import tempfile

    import cv2
    import numpy as np
    import torch

    from diffdope_tpu_torch import png
    from diffdope_tpu_torch.testing import BOTH
    from tools.port_cv2_formats import compare

    t_phase = time.perf_counter()
    later_variants_check(t_phase)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        paths, arrays, ply, mtx_gt = write_scene_files(root, gpu, label="phase 24")
        files, ply_tif, tex_tif = write_later_files(root, arrays, ply)

        # (a) the scene's files against the host's cv2, and their read times
        frames = {name: (path.read_bytes(), BOTH) for name, path in files.items()}
        frames["texture_jpeg.tif"] = (tex_tif, BOTH)
        t0 = time.perf_counter()
        differ = [row["variant"] for row in compare(frames) if row["differ"]]
        print(f"phase 24 (a): {len(frames)} files of phase 16's scene read by the port from "
              f"bytes and from a file in both modes: {len(differ)} differ from cv2 "
              f"{cv2.__version__} {differ} ({time.perf_counter() - t0:.2f} s)", flush=True)
        if differ:
            fail(f"phase 24 (a): the port's reads differ from cv2's on {differ}")
        timed = [("rgb.png", paths["rgb"], png.imread_color)] + [
            (name, files[name], png.imread_unchanged if name.startswith("depth")
             else png.imread_color)
            for name in ("seg.tif", "seg.gif", "depth_i32.tif", "rgb_jpeg.tif", "rgb.ras",
                         "rgb.hdr")]
        for name, path, read in timed:
            best = min(_timed(read, path) for _ in range(3))
            mode = "unchanged" if read is png.imread_unchanged else "colour"
            print(f"phase 24 (a): {name} ({path.stat().st_size} bytes) {mode} read in "
                  f"{best:.4f} s, best of three [{gpu}; host CPU]", flush=True)
        checks = {"seg.tif": arrays["seg"] > 127, "seg.gif": arrays["seg"] > 127,
                  "rgb.ras": arrays["rgb"]}
        for name, want in checks.items():
            got = png.imread_color(files[name])
            got = got[..., 0] > 127 if want.dtype == bool else got
            if not same_bits(got, want):
                fail(f"phase 24 (a): {name} does not read back as the written frame")
        for name in ("depth_i32.tif", "depth_i16.tif"):
            if not np.array_equal(png.imread_unchanged(files[name]), arrays["depth"]):
                fail(f"phase 24 (a): {name} does not read back as the depth PNG's values")

        # (b) the 1-bit TIFF, GIF, signed depth TIFFs and Sun Raster against PNGs
        runs = {}
        for label, scene in (
                ("Sun Raster/1-bit TIFF/int32 TIFF", dict(rgb=files["rgb.ras"],
                                                          seg=files["seg.tif"],
                                                          depth=files["depth_i32.tif"])),
                ("Sun Raster/GIF/int16 TIFF", dict(rgb=files["rgb.ras"], seg=files["seg.gif"],
                                                   depth=files["depth_i16.tif"])),
                ("PNG", dict(paths, seg=files["seg_bin.png"]))):
            dd, points, build_s = files_session(scene, ply, losses=FILES_LOSSES)
            print(f"phase 24 (b): DiffDope(cfg) from the {label} files built in "
                  f"{build_s:.4f} s [{gpu}]", flush=True)
            dd, launches, add0, add1 = diffdope_phase(True, gpu, f"from {label}", session=(
                dd, points, mtx_gt))
            check_launches(f"DiffDope from {label}", launches, COMPACT_DEPTH,
                           set(launches) - set(COMPACT_DEPTH))
            check_diffdope(dd, f"from {label}", add0, add1)
            runs[label] = dict(
                gt={k: np.asarray(v) for k, v in dd.gt_tensors.items()},
                losses={k: np.asarray(v) for k, v in dd.losses_values.items()},
                argmin=dd.get_argmin(), pose=np.asarray(dd.get_pose()))
            del dd
            torch.cuda.empty_cache()
        b = runs.pop("PNG")
        for label, a in runs.items():
            gt_equal = {k: same_bits(a["gt"][k], b["gt"][k]) for k in b["gt"]}
            run_equal = {"losses": set(a["losses"]) == set(b["losses"]) and all(
                same_bits(a["losses"][k], b["losses"][k]) for k in b["losses"]),
                "argmin": a["argmin"] == b["argmin"],
                "get_pose": same_bits(a["pose"], b["pose"])}
            print(f"phase 24 (b): the {label} session against the PNG one: gt arrays equal "
                  f"{gt_equal}; {run_equal} bit for bit (argmin {a['argmin']})", flush=True)
            if not (all(gt_equal.values()) and set(a["gt"]) == set(b["gt"])):
                fail(f"phase 24 (b): the gt arrays from {label} differ from the PNGs'")
            if not all(run_equal.values()):
                fail(f"phase 24 (b): the runs from {label} and PNG differ: {run_equal}")

        # (c) a Radiance HDR rgb frame and a JPEG-in-TIFF texture
        dd, points, build_s = files_session(dict(paths, rgb=files["rgb.hdr"]), ply_tif)
        rgb = cv2.cvtColor(cv2.imread(str(files["rgb.hdr"])), cv2.COLOR_BGR2RGB)
        h, w = dd.resolution
        want_rgb = png.resize_linear(rgb[::-1] / 255.0, (w, h)).astype(np.float32)
        want_tex = cv2.cvtColor(cv2.imdecode(np.frombuffer(tex_tif, np.uint8), cv2.IMREAD_COLOR),
                                cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        same = {"gt rgb": same_bits(np.asarray(dd.gt_tensors["rgb"]), want_rgb),
                "texture": same_bits(np.asarray(dd.object3d.mesh.tex), want_tex)}
        print(f"phase 24 (c): DiffDope(cfg) from rgb.hdr, depth.png, seg.png and the PLY with "
              f"a JPEG-in-TIFF texture built in {build_s:.4f} s; equal to the loader's "
              f"arithmetic on cv2 {cv2.__version__}'s reads: {same} [{gpu}]", flush=True)
        if not all(same.values()):
            fail(f"phase 24 (c): the session's inputs are not cv2's reads: {same}")
        dd, launches, add0, add1 = diffdope_phase(True, gpu, "from Radiance HDR", session=(
            dd, points, mtx_gt))
        check_launches("DiffDope from Radiance HDR", launches, COMPACT_FUSED,
                       set(launches) - set(COMPACT_FUSED))
        check_diffdope(dd, "from Radiance HDR", add0, add1)
        del dd
        torch.cuda.empty_cache()
    print(f"phase 24: {time.perf_counter() - t_phase:.4f} s [{gpu}]", flush=True)


#: phase 25: the corpus files the port refuses by name (cv2 4.13 reads a
#: deep scanline file's composite), and the 1080p depth's EXR codings
#: (name, ``IMWRITE_EXR_COMPRESSION``, half samples) whose reads are timed
EXR_REFUSED = {"exr_np_deep_scanline": "OpenEXR deep data"}
EXR_DEPTHS = (("none", 0, False), ("rle", 1, False), ("zips", 2, False), ("zip", 3, False),
              ("piz", 4, False), ("pxr24", 5, False), ("b44_half", 6, True),
              ("b44a_half", 7, True), ("dwaa_half", 8, True), ("dwab_half", 9, True))


def exr_corpus_check(t_phase: float) -> None:
    """Phase 25 (a): every file of the OpenEXR corpus read by the port from
    bytes and from a file in both modes against the card host's cv2 live
    (``tools/port_cv2_formats.py exr_`` in a process with
    ``OPENCV_IO_ENABLE_OPENEXR`` set: cv2 4.13 raises on every EXR read
    without it), and the host's reads against the committed record."""
    import hashlib
    import subprocess

    from diffdope_tpu_torch.testing import exr_variants
    from tools.port_cv2_formats import load_exr_recorded

    variants, rec = exr_variants(), load_exr_recorded()
    moved = [n for n, (data, _) in variants.items()
             if rec["variants"].get(n, {}).get("sha1") != hashlib.sha1(data).hexdigest()]
    if moved or set(variants) != set(rec["variants"]):
        fail(f"phase 25 (a): the corpus differs from the recorded one: {moved[:8]}")
    env = dict(os.environ, OPENCV_IO_ENABLE_OPENEXR="1")
    run = subprocess.run([sys.executable, str(HERE / "tools" / "port_cv2_formats.py"), "exr_"],
                         env=env, cwd=HERE, capture_output=True, text=True, timeout=300)
    lines = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
    if run.returncode or not lines or lines[-1].get("variants") != len(variants):
        fail(f"phase 25 (a): the cv2 comparison did not run to its end (exit "
             f"{run.returncode}): {run.stderr[-500:]}")
    last, rows = lines[-1], lines[:-1]
    differ, refused, unrecorded = [], [], []
    for row in rows:
        name = row["variant"]
        port = {k: v for k, v in row.items() if k.endswith("port_equal")}
        if name in EXR_REFUSED:
            if all(isinstance(v, str) and EXR_REFUSED[name] in v for v in port.values()):
                refused.append(name)
            else:
                differ.append(name)
        elif not port or any(v is not True for v in port.values()):
            differ.append(name)
        host = {k: v for k, v in row.items() if k.startswith(("unchanged", "color"))
                and not k.endswith("port_equal")}
        want = {k: v for k, v in rec["variants"][name].items()
                if k.startswith(("unchanged", "color"))}
        if host != want:
            unrecorded.append(name)
    print(f"phase 25 (a): {len(rows)} OpenEXR corpus files read by the port from bytes and "
          f"from a file in both modes against cv2 {last['cv2']} (OpenEXR "
          f"{last['openexr']}) live, the codec enabled: {len(differ)} differ {differ[:8]}, "
          f"{len(refused)} refused by name as cv2 composites them {refused}; the host's "
          f"reads against the committed record: {len(unrecorded)} differ {unrecorded[:8]} "
          f"({time.perf_counter() - t_phase:.2f} s)", flush=True)
    if differ or unrecorded or set(refused) != set(EXR_REFUSED):
        fail(f"phase 25 (a): port or host reads differ: {differ} {unrecorded} {refused}")


def write_exr_files(root: Path, arrays) -> dict:
    """Phase 25's files beside phase 16's, written by the card host's cv2
    (the codec enabled): the depth PNG's values as float32 EXR at each
    lossless coding, PXR24, and as half at B44, B44A, DWAA and DWAB
    (``EXR_DEPTHS``; cv2 4.13 writes its DWA files without data);
    depth_dwaa_data.exr, the same values as half Y in DWAA coded by
    ``testing.encode_exr`` (OpenEXR's default rules: lossy DCT; the channel
    flagged perceptually linear, so the DCT codes the values themselves,
    not their ``toNonlinear`` logarithm, whose half DC values err by
    ~0.4%: too coarse a depth to refine on); rgb_float.exr, the rgb
    frame's 0..255 values as
    float32 BGR (ZIP); depth_f32.tif as phase 22 writes it."""
    import cv2
    import numpy as np

    from diffdope_tpu_torch.testing import encode_exr, encode_tiff

    depth = arrays["depth"].astype(np.float32)
    files = {}
    for name, comp, half in EXR_DEPTHS:
        files[f"depth_{name}.exr"] = root / f"depth_{name}.exr"
        kind = cv2.IMWRITE_EXR_TYPE_HALF if half else cv2.IMWRITE_EXR_TYPE_FLOAT
        if not cv2.imwrite(str(files[f"depth_{name}.exr"]), depth,
                           [cv2.IMWRITE_EXR_COMPRESSION, comp, cv2.IMWRITE_EXR_TYPE, kind]):
            fail(f"phase 25: cv2 did not write depth_{name}.exr")
    files["depth_dwaa_data.exr"] = root / "depth_dwaa_data.exr"
    files["depth_dwaa_data.exr"].write_bytes(encode_exr({"Y": depth}, 8, linear=("Y",)))
    files["rgb_float.exr"] = root / "rgb_float.exr"
    bgr = np.ascontiguousarray(arrays["rgb"][..., ::-1]).astype(np.float32)
    if not cv2.imwrite(str(files["rgb_float.exr"]), bgr,
                       [cv2.IMWRITE_EXR_COMPRESSION, 3, cv2.IMWRITE_EXR_TYPE,
                        cv2.IMWRITE_EXR_TYPE_FLOAT]):
        fail("phase 25: cv2 did not write rgb_float.exr")
    files["depth_f32.tif"] = root / "depth_f32.tif"
    files["depth_f32.tif"].write_bytes(encode_tiff(depth, compression=8, predictor=3,
                                                   rows_per_strip=2))
    return files


def exr_phase(gpu: str) -> None:
    """Phase 25: the OpenEXR corpus against the card host's cv2 4.13, the
    default configuration from float32 EXR depth (ZIP, PIZ) against the same
    from the float32 depth TIFF, from a half DWAA depth and a float RGB
    EXR, and the 1080p depth's read times under every coding."""
    import tempfile

    import cv2
    import numpy as np
    import torch

    from diffdope_tpu_torch import exr, png

    t_phase = time.perf_counter()
    exr_corpus_check(t_phase)
    before = os.environ.get(exr.GATE)
    os.environ[exr.GATE] = "1"  # cv2 reads it at its first EXR call, the port at each
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            paths, arrays, ply, mtx_gt = write_scene_files(root, gpu, label="phase 25")
            files = write_exr_files(root, arrays)

            # (c) the 1080p depth under each coding against cv2, and the read times
            modes = (("unchanged", png.imread_unchanged, cv2.IMREAD_UNCHANGED),
                     ("colour", png.imread_color, cv2.IMREAD_COLOR))
            for name in [f"depth_{n}.exr" for n, _, _ in EXR_DEPTHS] + [
                    "depth_dwaa_data.exr", "rgb_float.exr"]:
                path = files[name]
                equal = []
                for mode, read, flag in modes:
                    got, want = read(path), cv2.imread(str(path), flag)
                    if want is not None and flag == cv2.IMREAD_COLOR:
                        want = cv2.cvtColor(want, cv2.COLOR_BGR2RGB)
                    equal.append(same_bits(got, want))
                read = png.imread_color if name.startswith("rgb") else png.imread_unchanged
                best = min(_timed(read, path) for _ in range(3))
                got = read(path)
                shape = None if got is None else (tuple(got.shape), got.dtype.name)
                print(f"phase 25 (c): {name} ({path.stat().st_size} bytes) "
                      f"{'colour' if read is png.imread_color else 'unchanged'} read {shape} "
                      f"in {best:.4f} s, best of three [{gpu}; host CPU]; both modes equal to "
                      f"cv2 {cv2.__version__}'s bit for bit: {all(equal)}", flush=True)
                if not all(equal):
                    fail(f"phase 25 (c): the port's read of {name} differs from cv2's")
            best = min(_timed(png.imread_color, paths["rgb"]) for _ in range(3))
            print(f"phase 25 (c): rgb.png ({paths['rgb'].stat().st_size} bytes) colour read "
                  f"in {best:.4f} s, best of three [{gpu}; host CPU]", flush=True)
            for name in ("depth_none.exr", "depth_zip.exr", "depth_piz.exr"):
                if not same_bits(png.imread_unchanged(files[name]),
                                 arrays["depth"].astype(np.float32)):
                    fail(f"phase 25: {name} does not read back as the depth PNG's values")
            if not same_bits(png.imread_color(files["rgb_float.exr"]), arrays["rgb"]):
                fail("phase 25: rgb_float.exr does not read back as the rgb frame")

            # (b) float32 EXR depth (ZIP, PIZ) against the float32 TIFF's session
            runs = {}
            for label, depth in (("float32 TIFF", files["depth_f32.tif"]),
                                 ("float32 EXR (ZIP)", files["depth_zip.exr"]),
                                 ("float32 EXR (PIZ)", files["depth_piz.exr"])):
                dd, points, build_s = files_session(dict(paths, depth=depth), ply,
                                                    losses=FILES_LOSSES)
                print(f"phase 25 (b): DiffDope(cfg) from rgb.png, seg.png and the "
                      f"{label} depth built in {build_s:.4f} s [{gpu}]", flush=True)
                dd, launches, add0, add1 = diffdope_phase(True, gpu, f"from {label}",
                                                          session=(dd, points, mtx_gt))
                check_launches(f"DiffDope from {label}", launches, COMPACT_DEPTH,
                               set(launches) - set(COMPACT_DEPTH))
                check_diffdope(dd, f"from {label}", add0, add1)
                runs[label] = dict(
                    gt={k: np.asarray(v) for k, v in dd.gt_tensors.items()},
                    losses={k: np.asarray(v) for k, v in dd.losses_values.items()},
                    argmin=dd.get_argmin(), pose=np.asarray(dd.get_pose()),
                    launches=launches)
                del dd
                torch.cuda.empty_cache()
            b = runs.pop("float32 TIFF")
            for label, a in runs.items():
                gt_equal = {k: same_bits(a["gt"][k], b["gt"][k]) for k in b["gt"]}
                run_equal = {"losses": set(a["losses"]) == set(b["losses"]) and all(
                    same_bits(a["losses"][k], b["losses"][k]) for k in b["losses"]),
                    "argmin": a["argmin"] == b["argmin"],
                    "get_pose": same_bits(a["pose"], b["pose"]),
                    "launches": a["launches"] == b["launches"]}
                print(f"phase 25 (b): the {label} session against the float32 TIFF one: gt "
                      f"arrays equal {gt_equal}; {run_equal} bit for bit (argmin "
                      f"{a['argmin']})", flush=True)
                if not (all(gt_equal.values()) and set(a["gt"]) == set(b["gt"])):
                    fail(f"phase 25 (b): the gt arrays from the {label} depth differ")
                if not all(run_equal.values()):
                    fail(f"phase 25 (b): the {label} and float32 TIFF runs differ: {run_equal}")

            # (b) cv2 4.13 writes its DWAA file without data: both read None, and
            # the loader raises FileNotFoundError as the reference's None makes it
            dwaa = files["depth_dwaa_half.exr"]
            nones = (cv2.imread(str(dwaa), cv2.IMREAD_UNCHANGED), png.imread_unchanged(dwaa))
            try:
                files_session(dict(paths, depth=dwaa), ply, losses=FILES_LOSSES)
                raised = None
            except FileNotFoundError as err:
                raised = f"FileNotFoundError({err})"
            print(f"phase 25 (b): depth_dwaa_half.exr ({dwaa.stat().st_size} bytes): cv2 "
                  f"reads {nones[0]}, the port {nones[1]}; DiffDope(cfg) from it raises "
                  f"{raised}", flush=True)
            if nones != (None, None) or raised is None:
                fail("phase 25 (b): the DWAA depth is not refused as cv2 refuses it")

            # (b) a half DWAA depth (lossy DCT) and a float RGB EXR read as colour
            scene = dict(paths, rgb=files["rgb_float.exr"], depth=files["depth_dwaa_data.exr"])
            dd, points, build_s = files_session(scene, ply, losses=FILES_LOSSES)
            h, w = dd.resolution
            rgb = cv2.cvtColor(cv2.imread(str(scene["rgb"])), cv2.COLOR_BGR2RGB)
            depth = cv2.imread(str(scene["depth"]), cv2.IMREAD_UNCHANGED)
            want = {"rgb": png.resize_linear(rgb[::-1] / 255.0, (w, h)).astype(np.float32),
                    "depth": png.resize_nearest(depth[::-1].astype(np.float64)
                                                / DEFAULT_DEPTH_SCALE, (w, h)).astype(
                                                    np.float32)}
            same = {k: same_bits(np.asarray(dd.gt_tensors[k]), v) for k, v in want.items()}
            lossy = float(np.abs(depth - arrays["depth"]).max())
            print(f"phase 25 (b): DiffDope(cfg) from rgb_float.exr, depth_dwaa_data.exr "
                  f"(largest |read - written| {lossy}) and seg.png built in {build_s:.4f} s; "
                  f"inputs equal to the loader's arithmetic on cv2 {cv2.__version__}'s reads: "
                  f"{same} [{gpu}]", flush=True)
            if not all(same.values()):
                fail(f"phase 25 (b): the session's inputs are not cv2's reads: {same}")
            dd, launches, add0, add1 = diffdope_phase(True, gpu, "from DWAA/float RGB EXR",
                                                      session=(dd, points, mtx_gt))
            check_launches("DiffDope from DWAA/float RGB EXR", launches, COMPACT_DEPTH,
                           set(launches) - set(COMPACT_DEPTH))
            check_diffdope(dd, "from DWAA/float RGB EXR", add0, add1)
            del dd
            torch.cuda.empty_cache()
    finally:
        if before is None:
            os.environ.pop(exr.GATE, None)
        else:
            os.environ[exr.GATE] = before
    print(f"phase 25: {time.perf_counter() - t_phase:.4f} s [{gpu}]", flush=True)


class RefineRecorder:
    """Records every call of the synthesized sweep's refinement (each
    context's ``optimize.CapturedRefine``): its fused loss, its ground
    truth and its result, in order, with its context's compact capacity
    and per-tile cap (``caps``, by fused loss: the cache keeps the last
    context only)."""

    def __init__(self):
        self.calls, self.caps = [], {}

    def __enter__(self):
        from diffdope_tpu_torch import bop, optimize

        self._cls, self._own = optimize.CapturedRefine, optimize.CapturedRefine.__call__

        def recorded(refine, *args, **kwargs):
            result = self._own(refine, *args, **kwargs)
            fn = refine.fused_loss_fn
            for ctx in bop._synth_ctx_cache.values():
                if ctx["fused"] is fn:
                    self.caps[id(fn)] = (ctx["compact_total"], ctx["max_tris_per_tile"])
            self.calls.append((fn, kwargs["gt"], result))
            return result

        self._cls.__call__ = recorded
        bop._synth_ctx_cache.clear()
        bop._synth_escalation.clear()
        return self

    def __exit__(self, *exc):
        self._cls.__call__ = self._own

    def objects(self):
        """The calls grouped by object (a re-run feeds the same gt), each
        group's last call the kept run."""
        groups = []
        for call in self.calls:
            if groups and groups[-1][-1][1] is call[1]:
                groups[-1].append(call)
            else:
                groups.append([call])
        return groups


def write_error_tree(root: Path, n_obj: int = 3):
    """``hope/val/000001/scene_error_<level>.json`` for every level: one frame
    of ``n_obj`` objects at rotations from a seeded numpy draw, in the
    reference's schema."""
    import numpy as np

    from diffdope_tpu_torch.bop import PERTURBATION_LEVELS
    from diffdope_tpu_torch.geometry import matrix33_from_quat

    import torch

    rng = np.random.default_rng(17)
    q = rng.normal(size=(n_obj, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rots = matrix33_from_quat(torch.tensor(q)).numpy()
    objs = [{"cam_R_m2c": r.reshape(-1).tolist(), "cam_t_m2c": [0.0, 0.0, 700.0],
             "obj_id": i + 1} for i, r in enumerate(rots)]
    scene = root / "hope" / "val" / "000001"
    scene.mkdir(parents=True)
    for level in PERTURBATION_LEVELS:
        with open(scene / f"scene_error_{level}.json", "w") as f:
            json.dump({"0": objs}, f)


def bop_sweep_phase(gpu: str):
    """Phase 17 (a): the synthesized BOP sweep through
    ``examples.run_bop_sweep.main``; returns its launch counts."""
    import tempfile

    import numpy as np
    import torch

    from diffdope_tpu_torch import bop, kernels
    from diffdope_tpu_torch.examples import run_bop_sweep

    with (tempfile.TemporaryDirectory() as tmp, RefineRecorder() as rec,
          Captures() as caps):
        write_error_tree(Path(tmp))
        argv = ["--data-root", tmp, "--mesh", str(HERE / SWEEP_MESH), "--device", "cuda",
                *SWEEP_ARGS]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        results = run_bop_sweep.main(argv)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    groups = rec.objects()
    levels = list(results)
    per_level = len(groups) // len(levels)
    ctxs = list(bop._synth_ctx_cache.values())
    print(f"phase 17 (a): {len(levels)} levels x {per_level} objects, "
          f"{len(rec.calls)} refinements ({len(rec.calls) - len(groups)} re-runs), "
          f"{len(rec.caps)} context(s), {len(ctxs)} kept, {caps.summary()}: "
          f"{sweep_s:.4f} s through run_bop_sweep.main, peak {peak_gib:.3f} GiB "
          f"[{gpu}]", flush=True)
    if caps.count != len(rec.caps):
        fail(f"phase 17 (a): {caps.count} captures for {len(rec.caps)} sweep contexts")
    for i, level in enumerate(levels):
        kept = [g[-1] for g in groups[i * per_level:(i + 1) * per_level]]
        reruns = sum(len(g) - 1 for g in groups[i * per_level:(i + 1) * per_level])
        caps = sorted({rec.caps[id(fn)][0] for fn, _, _ in kept})
        caps_k = sorted({rec.caps[id(fn)][1] for fn, _, _ in kept})
        worst = max(int(r.telemetry["_bin_overflow"].max()) for _, _, r in kept)
        need = max(int(r.telemetry["_bin_need"].max()) for _, _, r in kept)
        r = results[level]
        print(f"phase 17 (a) {level}: compact capacity {caps} slots, per-tile cap "
              f"{caps_k}; most slots a step needed {need}; _bin_overflow max {worst}; "
              f"{reruns} re-run(s); acc@0.1d {r['acc_01d']:.3f} (init "
              f"{r['acc_01d_init']:.3f}), ADD mean {r['add_mean']:.6f} (init "
              f"{r['add_init_mean']:.6f})", flush=True)
        for e in r["per_object"]:
            print(f"phase 17 (a) {level} object {e['i_obj']}: ADD {e['add_init']:.6f} -> "
                  f"{e['add']:.6f}, ADD-S {e['adds_init']:.6f} -> {e['adds']:.6f}, "
                  f"diameter {e['diameter']:.6f}, step {e['best_step']} hypothesis "
                  f"{e['best_hyp']}, final loss {e['final_loss']:.6f}", flush=True)
            if not np.isfinite(e["final_loss"]):
                fail(f"phase 17 (a): {level} object {e['i_obj']}: non-finite final loss")
        if r["acc_01d"] < r["acc_01d_init"]:
            fail(f"phase 17 (a): {level}: acc@0.1d {r['acc_01d']} below the init's "
                 f"{r['acc_01d_init']}")
    print(f"phase 17 (a) launches: {launches}", flush=True)
    check_launches("phase 17 (a)", launches, COMPACT_FUSED,
                   set(launches) - set(COMPACT_FUSED))
    # K1-K6 on the last context's own full-frame tables at the last poses
    fn, gt, result = rec.calls[-1]
    mtx_last = result.mtx_history[-1]
    d_sums = torch.zeros((mtx_last.shape[0], 3), device="cuda")
    d_sums[:, :2] = torch.as_tensor(
        np.random.default_rng(17).uniform(0.5, 2.0, (mtx_last.shape[0], 2)), device="cuda")
    for row in check_all(fn.bind_gt(gt), mtx_last, d_sums):
        print(f"phase 17 (a) shapes {row['name']}: ok={row['ok']} "
              f"max_abs_err={row['max_abs_err']:.3e} ({row['tolerance']}){slots(row)}, "
              f"bound {row['bound'][0]:.4f} ms ({row['bound'][1]})", flush=True)
        if not row["ok"]:
            fail(f"{row['name']} disagrees with its plain version on the sweep's tables: "
                 f"{row}")
    return launches


def _perturbed(r, t_mm, rng, deg, trans_mm):
    """(R, t) moved by ``deg`` about a drawn axis and ``trans_mm`` along a
    drawn direction."""
    import numpy as np
    import torch

    from diffdope_tpu_torch.geometry import matrix33_from_quat, quat_from_axis_angle

    dq = quat_from_axis_angle(rng.normal(size=3), np.deg2rad(deg))
    r0 = matrix33_from_quat(torch.tensor(dq)).numpy() @ r
    d = rng.normal(size=3)
    return r0, np.asarray(t_mm, float) + d / np.linalg.norm(d) * trans_mm


def write_bop_scene(root: Path):
    """Phase 17 (b)'s BOP scene at the default camera's 1920x1080: the
    two stand-ins (millimetres, vertex-coloured) as models/obj_00000{1,2}.ply
    by ``save_ply``; rgb, 16-bit depth (depth_scale ``BOP_DEPTH_SCALE``) and
    mask_visib PNGs of the port's render of both at their true poses
    (``write_png``); scene_camera.json, scene_gt.json and the error JSON
    (each pose ``BOP_PERTURB`` off).  Returns the paths and the objects."""
    import numpy as np
    import torch

    from diffdope_tpu_torch.camera import Camera
    from diffdope_tpu_torch.config import ConfigNode
    from diffdope_tpu_torch.mesh import load_mesh, load_ply, save_ply
    from diffdope_tpu_torch.object3d import Object3D
    from diffdope_tpu_torch.optimize import pose_matrix
    from diffdope_tpu_torch.render.pipeline import render_rgb_mask
    from diffdope_tpu_torch.testing import write_png

    cfg = ConfigNode(copy.deepcopy(DEFAULT_CONFIG))
    cam = Camera(**{k: cfg.camera[k] for k in ("fx", "fy", "cx", "cy", "im_width",
                                               "im_height")})
    h, w = cam.im_height, cam.im_width
    models = root / "models"
    scene = root / "hope" / "val" / "000001"
    for sub in ("rgb", "depth", "mask_visib"):
        (scene / sub).mkdir(parents=True)
    models.mkdir()
    rng = np.random.default_rng(170)
    rots = [np.asarray(cfg.object3d.rotation, float).reshape(3, 3)]
    q = rng.normal(size=4)
    from diffdope_tpu_torch.geometry import matrix33_from_quat

    rots.append(matrix33_from_quat(torch.tensor(q / np.linalg.norm(q))).numpy())
    rgb = np.zeros((h, w, 3), np.float32)
    depth = np.full((h, w), np.inf, np.float32)
    masks, gt_objs, init_objs = [], [], []
    for i, (src, r, t) in enumerate(zip(BOP_MODELS, rots, BOP_T_MM)):
        data = load_ply(HERE / src)
        v = data["vertices"]
        colors = (v - v.min(0)) / (v.max(0) - v.min(0)) * 0.8 + 0.1
        path = models / f"obj_{i + 1:06d}.ply"
        save_ply(path, v, data["faces"], colors=colors)
        mesh = load_mesh(path, scale=0.01)
        obj = Object3D(position=t, rotation=r.reshape(-1).tolist(), scale=0.01, mesh=mesh,
                       batchsize=1)
        mtx = pose_matrix(obj.initial_params(1, "cuda"))[0]
        with torch.no_grad():
            out = render_rgb_mask(cam.cam_proj, mtx, mesh.pos, mesh.pos_idx, (h, w),
                                  edge_adj=mesh.edge_adj, vtx_color=mesh.vtx_color,
                                  device="cuda", cull_backfaces=True)
        m = out["mask"][0, ..., 0].cpu().numpy() > 0.5
        d = out["depth"][0].cpu().numpy()
        near = m & (d < depth)
        rgb[near], depth[near] = out["rgb"][0].cpu().numpy()[near], d[near]
        masks.append(m)
        gt_objs.append({"cam_R_m2c": r.reshape(-1).tolist(), "cam_t_m2c": list(t),
                        "obj_id": i + 1})
        r0, t0 = _perturbed(r, t, rng, *BOP_PERTURB)
        init_objs.append({"cam_R_m2c": r0.reshape(-1).tolist(), "cam_t_m2c": t0.tolist(),
                          "obj_id": i + 1})
    if masks[0].sum() == 0 or masks[1].sum() == 0 or (masks[0] & masks[1]).any():
        fail("phase 17 (b): the two objects are not both visible and apart")
    fr = "000000"
    # the loader flips rows back; depth in mm / depth_scale, 0 off the objects
    write_png(scene / "rgb" / f"{fr}.png", np.round(rgb[::-1] * 255).astype(np.uint8))
    depth_png = np.where(np.isfinite(depth), depth / 0.01 / BOP_DEPTH_SCALE, 0.0)
    write_png(scene / "depth" / f"{fr}.png", np.round(depth_png[::-1]).astype(np.uint16))
    for i, m in enumerate(masks):
        write_png(scene / "mask_visib" / f"{fr}_{i:06d}.png",
                  (m[::-1] * 255).astype(np.uint8))
    k = [cam.fx, 0.0, cam.cx, 0.0, cam.fy, cam.cy, 0.0, 0.0, 1.0]
    files = {"scene_camera.json": {"0": {"cam_K": k, "depth_scale": BOP_DEPTH_SCALE}},
             "scene_gt.json": {"0": gt_objs}, "scene_error.json": {"0": init_objs}}
    for name, body in files.items():
        with open(scene / name, "w") as f:
            json.dump(body, f)
    print(f"phase 17 (b): wrote a {w}x{h} BOP scene: {len(masks)} objects of "
          f"{[int(m.sum()) for m in masks]} visible pixels, each init "
          f"{BOP_PERTURB[0]} degrees and {BOP_PERTURB[1]} mm off", flush=True)
    return scene, models, gt_objs, init_objs


def bop_scene_phase(gpu: str):
    """Phase 17 (b): the real-BOP branch at the default configuration
    through ``examples.run_bop_scene.main``; returns its launch counts."""
    import tempfile

    import numpy as np
    import torch

    from diffdope_tpu_torch import kernels
    from diffdope_tpu_torch.examples import run_bop_scene
    from diffdope_tpu_torch.mesh import load_mesh
    from diffdope_tpu_torch.metrics import add_metric, subsample_points

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        scene, models, gt_objs, init_objs = write_bop_scene(root)
        argv = [f"bop.scene_dir={scene}", f"bop.models_dir={models}",
                f"bop.error_json={scene / 'scene_error.json'}", "bop.frame=0",
                f"bop.out_dir={root}", f"bop.gt_json={scene / 'scene_gt.json'}",
                "--device", "cuda"]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with LogLines(contains="re-running") as reruns:
            results = run_bop_scene.main(argv)
        torch.cuda.synchronize()
        scene_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
        written = json.loads((root / "refined_poses.json").read_text())
        meshes = [load_mesh(models / f"obj_{o['obj_id']:06d}.ply", scale=0.01)
                  for o in gt_objs]
    print(f"phase 17 (b): run_bop_scene.main {scene_s:.4f} s for {len(results)} objects "
          f"(the PNG reads, two DiffDope runs, their re-runs) [{gpu}]; "
          f"{len(reruns.lines)} recovery re-run(s): {reruns.lines}", flush=True)
    if set(written) != set(results):
        fail("phase 17 (b): refined_poses.json differs from the returned poses")
    f32 = torch.float32
    for k, entry in results.items():
        i = int(k)
        mesh = meshes[i]
        pts = subsample_points(mesh.pos[: mesh.num_vertices])

        def rt(o):
            return (torch.tensor(o["cam_R_m2c"], dtype=f32).reshape(3, 3),
                    torch.tensor(o["cam_t_m2c"], dtype=f32) * 0.01)

        add0 = float(add_metric(pts, *rt(init_objs[i]), *rt(gt_objs[i])))
        print(f"phase 17 (b) object {i} (obj_id {entry['obj_id']}): ADD {add0:.6f} -> "
              f"{entry['add']:.6f} (ADD-S {entry['adds']:.6f}), diameter "
              f"{entry['diameter']:.6f}, kept hypothesis {entry['argmin']}, final loss "
              f"{entry['final_loss']:.6f}", flush=True)
        if not np.isfinite(entry["final_loss"]) or not entry["add"] < add0:
            fail(f"phase 17 (b): object {i}: ADD {entry['add']} not below the init's {add0}")
    print(f"phase 17 (b) launches: {launches}", flush=True)
    check_launches("phase 17 (b)", launches, COMPACT_FUSED, set(launches) - set(COMPACT_FUSED))
    return launches


def viz_phase(dd, gpu: str) -> None:
    """Phase 18: render_img and make_animation on phase 5's kept run."""
    import importlib.util
    import tempfile

    import cv2
    import torch

    from diffdope_tpu_torch import kernels
    from diffdope_tpu_torch.diffdope import RenderHistory
    from diffdope_tpu_torch.kernels.check import plain_render

    if not dd.cfg.render_images.crop_around_mask:
        fail("phase 18: the configuration does not crop around the mask")
    dd._render_fn, dd.optimization_results = None, RenderHistory(dd)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    imgs = {sel: dd.render_img(render_selection=sel) for sel in ("rgb", "depth", "mask")}
    img_s = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.launches.items() if v}
    print(f"phase 18: render_img rgb/depth/mask {imgs['rgb'].shape}: {img_s:.4f} s "
          f"(one render of B={dd.batchsize}); launches {launches} [{gpu}]", flush=True)
    if launches != {"pack_fwd": 1, "raster_fwd": 1}:
        fail(f"phase 18: render_img launched {launches}, not K1 and K3 once")

    mtx = torch.as_tensor(dd.mtx_history[-1], device="cuda")
    kernels.reset_launches()
    with plain_render(), torch.no_grad():
        plain = dd._make_render_fn(layout="stacked")(mtx)
    if any(kernels.launches.values()):
        fail(f"phase 18: the plain twins' render launched {dict(kernels.launches)}")
    for sel, img in imgs.items():
        want = dd._compose_overlay(plain[sel].cpu().numpy(), None, sel)
        if img.shape != want.shape or img.tobytes() != want.tobytes():
            diff = (-1 if img.shape != want.shape
                    else int((img != want).sum()))
            fail(f"phase 18: render_img({sel!r}) differs from the plain twins' composite "
                 f"({diff} bytes)")
    print("phase 18: render_img's rgb, depth and mask composites equal the plain twins' "
          "byte for byte", flush=True)

    # the animation, each chunk's render recorded for its dropped pairs
    render_fn, chunks = dd._make_render_fn(layout="stacked"), []

    def recording(mtxs):
        out = render_fn(mtxs)
        chunks.append((mtxs, int(out["_bin_overflow"])))
        return out

    dd._render_fn = recording
    steps, chunk, width = dd.mtx_history.shape[0], 16, 800
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "animation.mp4"
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        dd.make_animation(str(path), chunk=chunk, final_width=width)
        anim_s = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launches.items() if v}
        cap = cv2.VideoCapture(str(path))
        frames, size = 0, None
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames, size = frames + 1, frame.shape[:2]
        cap.release()
        mp4_bytes = path.stat().st_size
    want_size = dd._compose_overlay(plain["rgb"][:1].cpu().numpy(), None, "rgb",
                                    final_width=width).shape[:2]
    n_chunks = -(-steps // chunk)
    overflow = [ov for _, ov in chunks]
    print(f"phase 18: make_animation of hypothesis {dd.get_argmin()}: {frames} frames of "
          f"{size}, {mp4_bytes} bytes, {anim_s:.4f} s ({steps} steps, {n_chunks} renders of "
          f"{chunk}); launches {launches}; _bin_overflow per render {overflow} [{gpu}]",
          flush=True)
    if frames != steps or tuple(size or ()) != tuple(want_size):
        fail(f"phase 18: the mp4 holds {frames} frames of {size}, not {steps} of "
             f"{tuple(want_size)}")
    if launches != {"pack_fwd": n_chunks, "raster_fwd": n_chunks}:
        fail(f"phase 18: make_animation launched {launches}, not K1 and K3 {n_chunks} times")
    dropped = 0
    with torch.no_grad():
        for mtxs, ov in chunks:
            if ov:
                dropped += sum(int(render_fn(m[None])["_bin_overflow"]) > 0 for m in mtxs)
    if dropped:
        print(f"phase 18: {dropped} of {steps} frames dropped (tile, triangle) pairs at the "
              "init's capacities", flush=True)
    dd._render_fn = None
    if importlib.util.find_spec("matplotlib") is None:
        print("phase 18: plot_losses left out: this host has no matplotlib (tested on the "
              "CPU: tests/test_torch_viz.py)", flush=True)
    else:
        plot = dd.plot_losses()
        print(f"phase 18: plot_losses {None if plot is None else plot.shape}", flush=True)


def sharded_rank(rank: int, root: str, port: int) -> None:
    """Phase 19 on one of two gloo ranks sharing the card: (a) DiffDope at
    phase 5's configuration with ``tpu.mesh_axis: 2``, what it got to
    ``root/rank<r>.pt``; then (b) ``multichip_refine.main(["--out",
    ...])`` in torchrun's environment (rendezvous at ``port``), its
    printed lines and wall time to ``root/rank<r>_b.pt`` and rank 0's
    histories to ``root/multichip.npz``."""
    import contextlib
    import datetime
    import io
    import os

    import torch
    import torch.distributed as dist

    from diffdope_tpu_torch import kernels
    from diffdope_tpu_torch.examples import multichip_refine
    from diffdope_tpu_torch.render import pack_kernel

    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=120))
    dd, _, _ = diffdope_session(True, tpu={"mesh_axis": 2})
    kernels.library()
    extents, pack_fwd = [], pack_kernel.pack_fwd

    def spy(mvpm, *args):
        extents.append(int(mvpm.shape[0]))
        return pack_fwd(mvpm, *args)

    pack_kernel.pack_fwd = spy
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    dd.run_optimization()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    torch.save({"mtx": dd.mtx_history, "total": dd._result.total_loss.cpu().numpy(),
                "telemetry": {k: v.cpu().numpy() for k, v in dd._result.telemetry.items()},
                "argmin": dd.get_argmin(), "pose": dd.get_pose(), "wall": wall,
                "kept_s": dd.last_run_stats["wall_time_s"],
                "reruns": dd.last_run_stats["recovery_reruns"],
                "launches": dict(kernels.launches), "extents": sorted(set(extents)),
                "device": str(dd.device)}, f"{root}/rank{rank}.pt")
    dist.destroy_process_group()
    pack_kernel.pack_fwd = pack_fwd
    del dd

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        multichip_refine.main(["--out", f"{root}/multichip.npz"])
    dist.destroy_process_group()
    torch.save({"stdout": out.getvalue(), "run_s": time.perf_counter() - t0},
               f"{root}/rank{rank}_b.pt")


def sharded_phase(dd_f, gpu: str) -> None:
    """Phase 19, on two spawned ranks: (a) DiffDope sharded over them
    against phase 5's unsharded run; (b) then the multichip example's
    ``main`` on the same ranks against its problem refined unsharded."""
    import socket
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from diffdope_tpu_torch.examples import multichip_refine
    from diffdope_tpu_torch.optimize import argmin_hypothesis, refine

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ctx = mp.spawn(sharded_rank, args=(root, port), nprocs=2, join=False)
        while not ctx.join(timeout=5):  # raises when a rank fails
            if time.perf_counter() - t0 > SPAWN_DEADLINE_S:
                for proc in ctx.processes:
                    proc.terminate()
                fail(f"phase 19: the ranks did not finish within {SPAWN_DEADLINE_S} s")
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(Path(root) / f"rank{r}.pt", weights_only=False) for r in range(2)]
        b0 = torch.load(Path(root) / "rank0_b.pt", weights_only=False)
        out = Path(root) / "multichip.npz"
        if not out.exists():
            fail(f"phase 19 (b): rank 0 wrote no result: {b0['stdout'][-2000:]}")
        with np.load(out) as saved:
            got_b = {k: saved[k] for k in saved.files}
    want_mtx, want_total = dd_f.mtx_history, dd_f._result.total_loss.cpu().numpy()
    for r, got in enumerate(ranks):
        print(f"phase 19 (a) rank {r} ({got['device']}): run_optimization {got['wall']:.4f} s, "
              f"kept run {got['kept_s']:.4f} s, {got['reruns']} re-run(s); K1 batch extents "
              f"{got['extents']}; launches "
              f"{ {k: v for k, v in got['launches'].items() if v} }", flush=True)
        check_launches(f"phase 19 (a) rank {r}", got["launches"], COMPACT_FUSED,
                       set(got["launches"]) - set(COMPACT_FUSED))
        if got["extents"] != [dd_f.batchsize // 2]:
            fail(f"phase 19 (a): rank {r}'s K1 saw batches {got['extents']}, not "
                 f"{dd_f.batchsize // 2}")
        if got["mtx"].shape != want_mtx.shape:
            fail(f"phase 19 (a): rank {r}'s history is {got['mtx'].shape}, not "
                 f"{want_mtx.shape}")
        gap_mtx = float(np.max(np.abs(got["mtx"] - want_mtx)
                               / (2e-5 + 2e-4 * np.abs(want_mtx))))
        gap_tot = float(np.max(np.abs(got["total"] - want_total)
                               / (1e-6 + 2e-4 * np.abs(want_total))))
        print(f"phase 19 (a) rank {r} against phase 5: mtx_history {gap_mtx:.3e} and total "
              f"loss {gap_tot:.3e} of their allowances; argmin {got['argmin']} against "
              f"{dd_f.get_argmin()}", flush=True)
        if gap_mtx > 1.0 or gap_tot > 1.0 or got["argmin"] != dd_f.get_argmin():
            fail(f"phase 19 (a): rank {r}'s sharded run differs from phase 5's")
        want_tel = {k: v.cpu().numpy() for k, v in dd_f._result.telemetry.items()}
        if set(got["telemetry"]) != set(want_tel) or not all(
                np.array_equal(got["telemetry"][k], v) for k, v in want_tel.items()):
            fail(f"phase 19 (a): rank {r}'s telemetry {sorted(got['telemetry'])} differs "
                 f"from phase 5's {sorted(want_tel)}")
    if not (np.array_equal(ranks[0]["mtx"], ranks[1]["mtx"])
            and np.array_equal(ranks[0]["total"], ranks[1]["total"])
            and np.array_equal(ranks[0]["pose"], ranks[1]["pose"])):
        fail("phase 19 (a): the two ranks returned different global results")
    print(f"phase 19: DiffDope, then multichip_refine, over 2 ranks on one card: spawn "
          f"to results {spawn_s:.4f} s; (a) run_optimization "
          f"{max(r['wall'] for r in ranks):.4f} s, kept "
          f"run {max(r['kept_s'] for r in ranks):.4f} s, against phase 5's unsharded kept run "
          f"{dd_f.last_run_stats['wall_time_s']:.4f} s; bit-identical to phase 5: mtx_history "
          f"{np.array_equal(ranks[0]['mtx'], want_mtx)}, total loss "
          f"{np.array_equal(ranks[0]['total'], want_total)} [{gpu}]", flush=True)

    got, run_s = got_b, b0["run_s"]
    lines = b0["stdout"].splitlines()
    wall = [ln for ln in lines if " steps on 2 rank(s): " in ln]
    best = [ln for ln in lines if ln.startswith("best hypothesis")]
    if len(wall) != 1 or len(best) != 1:
        fail(f"phase 19 (b): unexpected output: {b0['stdout'][-2000:]}")
    sharded_s = float(wall[0].split(": ")[1].split("s")[0])

    args = multichip_refine.parse_args([])
    problem = multichip_refine.build_problem(args, torch.device("cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = refine(*problem, nb_iterations=args.iterations, **multichip_refine.REFINE_KW)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    want_mtx, want_total = res.mtx_history.cpu().numpy(), res.total_loss.cpu().numpy()
    want_best = int(argmin_hypothesis(res.losses_values))
    if got["mtx_history"].shape != want_mtx.shape or got["total_loss"].shape != want_total.shape:
        fail(f"phase 19 (b): the sharded histories are {got['mtx_history'].shape} and "
             f"{got['total_loss'].shape}, not {want_mtx.shape} and {want_total.shape}")
    # the reference's tolerances (tests/test_parallel.py:47-54)
    gap_mtx = float(np.max(np.abs(got["mtx_history"] - want_mtx)
                           / (2e-5 + 2e-4 * np.abs(want_mtx))))
    gap_tot = float(np.max(np.abs(got["total_loss"] - want_total)
                           / (1e-6 + 2e-4 * np.abs(want_total))))
    print(f"phase 19 (b): multichip_refine (B={args.batchsize}, {args.resolution}, "
          f"{args.iterations} Adam steps) over 2 ranks on one card: {lines[0]}; refinement "
          f"{sharded_s:.4f} s (the ranks' first launches included), main() on rank 0 "
          f"{run_s:.4f} s; "
          f"{best[0]}; unsharded in this process {whole_s:.4f} s, best hypothesis "
          f"{want_best}, final loss {float(want_total[-1]):.5f}; against it: mtx_history "
          f"{gap_mtx:.3e} and total loss {gap_tot:.3e} of their allowances, bit-identical: "
          f"mtx_history {np.array_equal(got['mtx_history'], want_mtx)}, total loss "
          f"{np.array_equal(got['total_loss'], want_total)} [{gpu}]", flush=True)
    if not (gap_mtx <= 1.0 and gap_tot <= 1.0) or int(got["best"]) != want_best:
        fail("phase 19 (b): the sharded multichip_refine differs from its unsharded run")


def host_api_phase(gpu: str) -> None:
    """Phase 20: DiffDope from ``load_config().copy()`` with
    ``tpu.roi_crop`` deleted (its default applies), on the stand-in loaded
    at scale 1 and brought to the configured scale by ``Mesh.scaled``,
    after ``cuda()`` on the session, its camera and its object (no-ops:
    the session stays on the card), ``AUTO_HYPER``'s 5 SGD steps on the
    fused route: K1-K6 launched and nothing else, the source config
    unchanged, ``Object3D.forward()`` the scaled arrays, the loss falls."""
    import numpy as np
    import torch

    from diffdope_tpu_torch import kernels
    from diffdope_tpu_torch.config import load_config
    from diffdope_tpu_torch.mesh import load_mesh

    t_phase = time.perf_counter()
    src = load_config()
    text = src.yaml()
    cfg = src.copy()
    del cfg.tpu.roi_crop
    unit = load_mesh(HERE / DEFAULT_CONFIG["object3d"]["model_path"])
    mesh = unit.scaled(cfg.object3d.scale)
    dd, points, mtx_gt = diffdope_session(True, hyper=AUTO_HYPER, mesh=mesh, cfg=cfg)
    for part in (dd, dd.camera, dd.object3d):
        part.cuda()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    dd.run_optimization()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    total = dd._result.total_loss.cpu()
    add0 = add_to(points, mtx_gt, dd.object3d.initial_matrix())
    add1 = add_to(points, mtx_gt, dd.get_pose())
    crop = dd._make_fused_loss_fn(dd.gt_tensors).crop
    print(f"phase 20: DiffDope from load_config().copy() without tpu.roi_crop (crop "
          f"{crop}), the stand-in by Mesh.scaled({cfg.object3d.scale}), {total.shape[0]} "
          f"steps on {dd.device}: run_optimization {wall:.4f} s, phase "
          f"{time.perf_counter() - t_phase:.4f} s; loss {float(total[0]):.6f} -> "
          f"{float(total[-1]):.6f}; ADD {add0:.6f} -> {add1:.6f}; launches "
          f"{ {k: v for k, v in launches.items() if v} } [{gpu}]", flush=True)
    check_launches("phase 20", launches, COMPACT_FUSED, set(launches) - set(COMPACT_FUSED))
    if dd.device.type != "cuda":
        fail(f"phase 20: the session runs on {dd.device} after cuda()")
    if crop is None:
        fail("phase 20: without tpu.roi_crop the fused loss has no crop (default 'auto')")
    if src.yaml() != text or "roi_crop" not in src.tpu or "roi_crop" in cfg.tpu:
        fail("phase 20: the copy's deleted key, or the session, changed the source config")
    pos = dd.object3d.forward()["pos"]
    if not np.array_equal(pos, unit.pos * cfg.object3d.scale) or np.array_equal(pos, unit.pos):
        fail("phase 20: Object3D.forward() does not return the scaled vertices")
    if not bool(total.isfinite().all()) or not float(total[-1]) < float(total[0]):
        fail("phase 20: the loss did not fall")


def session_settings(dd) -> dict:
    """What ``DiffDope.run_optimization`` builds its
    ``optimize.CapturedRefine`` from for a plain session (no jitter,
    restarts, appearance or sharding), on the capacities and crop its last
    run kept: the loss, the schedule and the optimizer."""
    use_bins = dd._use_bins()
    fn = dd._make_fused_loss_fn(dd.gt_tensors, use_bins=use_bins)
    return dict(render_fn=dd._make_render_fn(with_bins=use_bins) if fn is None else None,
                loss_fns=tuple(dd.loss_functions), weights=dd.loss_weights,
                nb_iterations=dd.nb_iterations, base_lr=dd.base_lr, lr_decay=dd.lr_decay,
                optimizer=dd.optimizer_name, fused_loss_fn=fn)


def session_refine(dd, cuda_graph: bool = True, **refine_kw):
    """The refinement ``DiffDope.run_optimization`` dispatches for a plain
    session: ``refine_segmented`` over :func:`session_settings`, with
    ``cuda_graph`` as given, so the eager loop and the graph run side by
    side (phase 26, ``tools/port_profile_diffdope.py``,
    ``tools/port_step_times.py``).  ``refine_kw`` go to
    ``refine_segmented``: a ``jit_refine`` that every segment calls in
    place of the run's own captured refinement, a ``step_callback``."""
    import torch

    from diffdope_tpu_torch.optimize import refine_segmented

    settings = session_settings(dd)
    gt = {k: torch.tensor(v, device=dd.device) for k, v in dd.gt_tensors.items()}
    return refine_segmented(
        dd.object3d.initial_params(dd.batchsize, dd.device), settings.pop("render_fn"),
        settings.pop("loss_fns"), gt, dd.learning_rates, settings.pop("weights"),
        segment_steps=int(dd._tpu().get("scan_segment", 40)), cuda_graph=cuda_graph,
        **settings, **refine_kw)


def result_diff(a, b) -> list:
    """The fields of two RefineResults that differ in a bit (or a shape)."""
    import torch

    pairs = [("mtx_history", a.mtx_history, b.mtx_history),
             ("total_loss", a.total_loss, b.total_loss)]
    for group in ("losses_values", "telemetry", "params"):
        x, y = getattr(a, group) or {}, getattr(b, group) or {}
        if set(x) != set(y):
            return [f"{group} keys {sorted(x)} / {sorted(y)}"]
        pairs += [(f"{group}[{k}]", x[k], y[k]) for k in x]
    return [name for name, x, y in pairs
            if x.dtype != y.dtype or not torch.equal(x, y)]


def timed_run(go, label: str, gpu: str):
    """One run of ``go()`` on the card: its result, launches and captures;
    its wall time, peak and reserved memory printed under ``label``."""
    import torch

    from diffdope_tpu_torch import kernels

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with Captures() as caps:
        t0 = time.perf_counter()
        res = go()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    launches = {k: v for k, v in kernels.launches.items() if v}
    steps = (sum(r.total_loss.shape[0] for r in res) if isinstance(res, list)
             else res.total_loss.shape[0])
    print(f"{label}: {steps} steps {wall:.4f} s, {1e3 * wall / steps:.3f} ms/step, "
          f"{caps.summary()}, peak {peak:.3f} GiB, reserved {reserved:.3f} GiB, launches "
          f"{launches} [{gpu}]", flush=True)
    return res, launches, caps.count


def hold_to_eager(label: str, runs: dict) -> None:
    """Every graph run of ``runs`` ({mode: [(result or list of results,
    launches, captures), ...]}) equal to every eager run bit for bit, with
    equal launches."""
    def listed(res):
        return res if isinstance(res, list) else [res]

    for mode, graph_runs in runs.items():
        if mode == "eager":
            continue
        for res_g, launches_g, _ in graph_runs:
            for res_e, launches_e, _ in runs["eager"]:
                g, e = listed(res_g), listed(res_e)
                diff = ([f"{len(g)} / {len(e)} refinements"] if len(g) != len(e)
                        else [d for a, b in zip(g, e) for d in result_diff(a, b)])
                if diff or launches_g != launches_e:
                    fail(f"phase 26 {label} {mode}: differs from the eager loop in {diff}, "
                         f"launches {launches_g} / {launches_e}")
    print(f"phase 26 {label}: every graph run ({', '.join(m for m in runs if m != 'eager')})"
          f" equals every eager run bit for bit, with equal launches", flush=True)


def hold_captures(label: str, runs: dict, want: dict) -> None:
    """The captures in each timed run of each mode: ``want[mode]``."""
    for mode, n in want.items():
        got = [c for _, _, c in runs[mode]]
        if any(c != n for c in got):
            fail(f"phase 26 {label} {mode}: {got} captures a run, not {n}")
    print(f"phase 26 {label}: captures a timed run {want}", flush=True)


def compiled_refine_phase(problem, gpu: str) -> None:
    """Phase 26: the compiled refinement, kept across calls.  The bench main
    path (B=64, 100 Adam steps, 400x400) and phase 5's default
    configuration (960x540, B=8, 61 SGD steps in segments of 40 + 21, on
    the capacities and crop its run kept) each run as the eager loop
    (``cuda_graph=False``), with a capture per ``refine`` call (a run, or
    a segment: the loop before the capture was kept), and with one
    ``optimize.CapturedRefine`` kept (the bench's across its runs;
    phase 5's one a run, as ``DiffDope`` dispatches it, and one kept
    across runs), each warmed up once, then in turns forward and back.
    Every graph run equals every eager run bit for bit (poses, totals,
    logs, telemetry, params), with equal launch counts; phase 5's run
    with one capture a run equals its session's own run; a kept run
    captures nothing.  Printed: each run's wall time, peak memory and
    captures; each graph mode's step 0 (a run whose step callback waits
    for every step: the first step's interval), the host time of each
    capture and a replay's interval; the kept graphs' pools; the device
    busy time a step under each mode (the profiler's kernels, over an
    untraced step).  Then the synthesized sweep (:func:`kept_sweep`)."""
    import functools
    import gc
    import statistics

    import numpy as np
    import torch

    from diffdope_tpu_torch.bench import bench_refine, device_busy, run_refinement
    from diffdope_tpu_torch.optimize import CapturedRefine, refine

    dd, _, _ = diffdope_session(True)
    dd.run_optimization()  # the capacities and crop of the kept run
    settings = session_settings(dd)
    kept = {"bench main path": bench_refine(problem),
            "default configuration": CapturedRefine(**settings)}
    cases = {
        "bench main path": {
            "eager": lambda **kw: run_refinement(problem, cuda_graph=False, **kw)[0],
            "capture per call": lambda **kw: run_refinement(problem, **kw)[0],
            "kept capture": lambda **kw: run_refinement(
                problem, jit_refine=kept["bench main path"], **kw)[0],
        },
        "default configuration": {
            "eager": lambda **kw: session_refine(dd, False, **kw),
            "capture per call": lambda **kw: session_refine(
                dd, jit_refine=functools.partial(refine, **settings), **kw),
            "capture per run": lambda **kw: session_refine(dd, **kw),
            "kept capture": lambda **kw: session_refine(
                dd, jit_refine=kept["default configuration"], **kw),
        },
    }
    segments = -(-(dd.nb_iterations + 1) // int(dd._tpu().get("scan_segment", 40)))
    captures = {"bench main path": {"capture per call": 1, "kept capture": 0},
                "default configuration": {"capture per call": segments,
                                          "capture per run": 1, "kept capture": 0}}
    # warm-ups first: the kept modes' step 0 and capture come before any
    # profiler session (on the card, replaying under torch.profiler a graph
    # captured between two of its sessions crashed the process)
    for modes in cases.values():
        for go in modes.values():
            go()
    for name, modes in cases.items():
        runs = {}
        for mode in list(modes) + list(reversed(modes)):
            runs.setdefault(mode, []).append(
                timed_run(modes[mode], f"phase 26 {name} {mode}", gpu))
        hold_to_eager(name, runs)
        hold_captures(name, runs, captures[name])
        print(f"phase 26 {name}: the kept graph's pool "
              f"{kept[name].pool_bytes / 2 ** 20:.1f} MiB [{gpu}]", flush=True)
        if name == "default configuration":
            res_g = runs["capture per run"][0][0]
            for k, v in dd.losses_values.items():
                if not np.array_equal(res_g.losses_values[k].cpu().numpy(), v):
                    fail(f"phase 26: the session's own run differs from the graph in {k}")
            print("phase 26 default configuration: the session's own run is the graph's "
                  "bit for bit", flush=True)
        # step 0 and the captures: a callback that waits for every step
        for mode, go in modes.items():
            if mode == "eager":
                continue
            stamps = []

            def stamp(i, total):
                float(total)
                stamps.append((i, time.perf_counter()))

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with Captures() as caps:
                go(step_callback=stamp)
            times = [t for _, t in stamps]
            gaps = [b - a for a, b in zip([t0] + times, times)]
            replay = statistics.median(g for (i, _), g in zip(stamps, gaps) if i >= 2)
            first = [g for (i, _), g in zip(stamps, gaps) if i == 0]
            print(f"phase 26 {name} {mode}: step 0 of each call waited for "
                  f"{[round(1e3 * g, 3) for g in first]} ms, {caps.summary()} (host), a "
                  f"replay waited for {1e3 * replay:.3f} ms [{gpu}]", flush=True)
        # what torch.cuda.graph runs before each capture, and the capture
        # skips: a synchronize and empty_cache, and gc.collect (always, or
        # where torch.compiler.config.force_cudagraph_gc is set)
        setup = {"synchronize + empty_cache": [], "gc.collect": []}
        for _ in range(3):
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            gc.collect()
            setup["synchronize + empty_cache"].append(round(1e3 * (t1 - t0), 3))
            setup["gc.collect"].append(round(1e3 * (time.perf_counter() - t1), 3))
        force = getattr(getattr(torch.compiler, "config", None), "force_cudagraph_gc", None)
        print(f"phase 26 {name}: torch.cuda.graph's set-up, which the capture skips: "
              f"{setup} ms (force_cudagraph_gc {force}) [{gpu}]", flush=True)
    for name, modes in cases.items():
        for mode, go in modes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = go()
            torch.cuda.synchronize()
            steps = res.total_loss.shape[0]
            step_ms = 1e3 * (time.perf_counter() - t0) / steps

            def traced():
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = go()
                torch.cuda.synchronize()
                return out, time.perf_counter() - t

            events, busy_ms, wall = device_busy(traced)
            busy = busy_ms / steps
            top = sorted((e for e in events
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: -e.self_device_time_total)[:5]
            print(f"phase 26 {name} {mode}: device busy {busy:.4f} ms a step of an "
                  f"untraced {step_ms:.4f} ms ({100 * busy / step_ms:.1f}%); traced "
                  f"{1e3 * wall / steps:.4f} ms a step; top "
                  f"{[(e.key[:40], round(e.self_device_time_total / 1e3 / steps, 4)) for e in top]}"
                  f" [{gpu}]", flush=True)
    del dd, kept, cases
    torch.cuda.empty_cache()
    kept_sweep(gpu)


def kept_sweep(gpu: str) -> None:
    """Phase 26's synthesized sweep: phase 17 (a)'s configuration
    (``SWEEP_ARGS``, its tree of three levels of three objects) through
    ``bop.sweep_perturbation_levels``, its context's refinement as the
    eager loop, as a capture per object (a fresh ``CapturedRefine`` a
    call: the bare ``refine`` of the loop before), and as the context's
    one kept ``CapturedRefine``; each mode a warm-up sweep (the context,
    and for the kept mode its step 0 and capture), then a timed one.  Each
    object's refinement equals the eager loop's bit for bit, with equal
    launches; the kept sweep captures nothing, the other one a call."""
    import tempfile

    import torch

    from diffdope_tpu_torch import bop
    from diffdope_tpu_torch.optimize import CapturedRefine

    h, w = (int(v) for v in SWEEP_ARGS[SWEEP_ARGS.index("--resolution") + 1].split("x"))
    batch = int(SWEEP_ARGS[SWEEP_ARGS.index("--batchsize") + 1])
    iterations = int(SWEEP_ARGS[SWEEP_ARGS.index("--iterations") + 1])

    def make(mode, calls):
        def build(*args, **kwargs):
            if mode == "eager":
                inner = CapturedRefine(*args, cuda_graph=False, **kwargs)
            elif mode == "kept capture":
                inner = CapturedRefine(*args, **kwargs)
            else:
                def inner(params, **kw):
                    return CapturedRefine(*args, **kwargs)(params, **kw)

            def call(params, **kw):
                calls.append(inner(params, **kw))
                return calls[-1]

            call.inner = inner
            return call
        return build

    runs, pools = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        write_error_tree(Path(tmp))
        for mode in ("eager", "capture per call", "kept capture"):
            calls = []
            bop._synth_ctx_cache.clear()
            bop._synth_escalation.clear()
            own, bop.CapturedRefine = bop.CapturedRefine, make(mode, calls)
            try:
                def sweep():
                    calls.clear()
                    bop.sweep_perturbation_levels(
                        tmp, mesh_path=str(HERE / SWEEP_MESH), resolution=(h, w),
                        batchsize=batch, nb_iterations=iterations, log_fn=lambda *a: None,
                        device="cuda")
                    return list(calls)

                sweep()  # warm-up
                runs[mode] = [timed_run(sweep, f"phase 26 synthesized sweep {mode}", gpu)]
                ctx = next(iter(bop._synth_ctx_cache.values()))
                if mode == "kept capture":
                    pools[mode] = ctx["refine"].inner.pool_bytes
            finally:
                bop.CapturedRefine = own
        bop._synth_ctx_cache.clear()
        bop._synth_escalation.clear()
    hold_to_eager("synthesized sweep", runs)
    n_calls = len(runs["eager"][0][0])
    hold_captures("synthesized sweep", runs, {"capture per call": n_calls, "kept capture": 0})
    print(f"phase 26 synthesized sweep: {n_calls} refinements a sweep; the kept context's "
          f"graph pool {pools['kept capture'] / 2 ** 20:.1f} MiB (one context kept) [{gpu}]",
          flush=True)
    torch.cuda.empty_cache()


def main() -> None:
    import faulthandler

    import numpy as np
    import torch

    faulthandler.enable()  # a crash in a library prints the Python stack

    if not torch.cuda.is_available():
        fail("no CUDA device (this smoke run needs one GPU; no CPU fallback)")
    from diffdope_tpu_torch import kernels
    from diffdope_tpu_torch.bench import (
        bench_problem,
        bench_refine,
        card,
        distinct_poses,
        run_refinement,
    )
    from diffdope_tpu_torch.kernels.check import (
        COUNTERS,
        KERNELS,
        check_kernels,
        check_pack_layouts,
        check_sliver,
    )
    from diffdope_tpu_torch.metrics import add_metric
    from diffdope_tpu_torch.optimize import argmin_hypothesis, pose_matrix, pose_params
    from diffdope_tpu_torch.testing import bench_scene

    gpu = card()
    print(f"card: {gpu}", flush=True)
    print(f"versions: {versions()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({len(kernels.SOURCES)} nvcc in "
          f"parallel: {' '.join(kernels.NVCC_FLAGS)})", flush=True)

    # ---- kernels against their plain versions --------------------------------
    # every check runs on distinct poses, so a kernel that reads another
    # hypothesis's inputs disagrees with its plain version
    small = bench_problem((64, 96), subdiv=2, batch=3, device="cuda")
    mtx, _, _ = pose_matrix(distinct_poses(small["params0"], 0.01))
    d_small = torch.tensor([[1.0, 0.7, 0.0], [0.5, 1.3, 0.0], [2.0, 0.2, 0.0]],
                           device="cuda")
    # K1-K6 on the compact table; K1, K2, K7 and K5/K6 with the depth lane
    # on the uniform table of the depth variant
    small_du = bench_problem((64, 96), subdiv=2, batch=3, device="cuda", depth=True,
                             uniform=True)
    d_small_du = torch.tensor([[1.0, 0.7, 0.9], [0.5, 1.3, 1.1], [2.0, 0.2, 0.4]],
                              device="cuda")
    # K1/K2 at the uv table's two channels and K5/K6's colour lane, without
    # and with the depth plane, on the test scene textured
    small_t = [bench_problem((64, 96), subdiv=2, batch=3, device="cuda", texture=True,
                             depth=depth) for depth in (False, True)]
    for row in (check_all(small["fn"], mtx, d_small)
                + check_all(small_du["fn"], mtx, d_small_du)
                + check_all(small_t[0]["fn"], mtx, d_small)
                + check_all(small_t[1]["fn"], mtx, d_small_du)):
        print(f"test scene {row['name']}: ok={row['ok']} "
              f"max_abs_err={row['max_abs_err']:.3e} ({row['tolerance']})", flush=True)
        if not row["ok"]:
            fail(f"{row['name']} disagrees with its plain version at the test scene: {row}")
    # K8 over a frame that is a multiple of neither tile
    k8_res = (70, 100)
    k8_scene = bench_scene(k8_res, subdiv=2)
    k8_mtx, _, _ = pose_matrix(distinct_poses(
        pose_params(k8_scene["q0"], k8_scene["t0"], 3, "cuda"), 0.01))
    for tile in ((16, 32), API_TILE):
        k8_check("test scene", gpu, k8_scene["proj"], k8_mtx, k8_scene["pos"],
                 k8_scene["tri"], k8_res, tile)
        k9_check("test scene", gpu, k8_scene["proj"], k8_mtx, k8_scene["pos"],
                 k8_scene["tri"], k8_scene["vtx_color"], k8_scene["edge_adj"], k8_res, tile)
    # K3, K7, K8 and K9 at a sliver whose f32 planes cover a pixel 8 rows
    # past its vertex bounds
    for row in check_sliver():
        print(f"sliver {row['name']}: ok={row['ok']} covered {row['covered']} "
              f"({row['tolerance']})", flush=True)
        if not row["ok"]:
            fail(f"{row['name']} disagrees with its plain version at the sliver: {row}")
    # K10 and K7 over the gathered bins on the planar routes, same frame
    for route in ("v3", "v2"):
        planar_checks(f"test scene {route}", gpu,
                      bench_problem(k8_res, subdiv=2, batch=3, device="cuda", route=route),
                      k8_mtx, d_small)

    problem = bench_problem((400, 400), subdiv=5, batch=64, device="cuda")
    print(f"bench problem: compact capacity {problem['compact_total']} slots, "
          f"ROI crop {problem['fn'].crop}", flush=True)
    mtx, _, _ = pose_matrix(distinct_poses(problem["params0"], 1e-3))
    d_sums = torch.as_tensor(
        np.random.default_rng(1).uniform(0.5, 2.0, (64, 3)),
        dtype=torch.float32, device="cuda",
    )
    bench_rows = {}
    for row in check_all(problem["fn"], mtx, d_sums, reps=20):
        print(f"bench shapes {row['name']}: ok={row['ok']} "
              f"max_abs_err={row['max_abs_err']:.3e} kernel {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms, bound {row['bound'][0]:.4f} ms "
              f"({row['bound'][1]}){slots(row)} [{gpu}]", flush=True)
        if not row["ok"]:
            fail(f"{row['name']} disagrees with its plain version at bench shapes: {row}")
        bench_rows[row["name"]] = row
    # the depth lane of K5/K6 at the bench problem's crop (its depth
    # variant), and K7 on its uniform-K table (the full frame, K 1,024);
    # only the rows the kernel line takes from each
    # and K5/K6's colour lane on the bench problem textured (no ROI crop on
    # the texture route: the full frame), without and with the depth plane
    for variant, names in (({"depth": True}, ("K5_loss_fwd_depth", "K6_loss_bwd_depth")),
                           ({"uniform": True}, ("K7_raster_uniform_fwd",
                                                "K7_raster_uniform_bwd")),
                           ({"texture": True}, ("K5_loss_fwd_color", "K6_loss_bwd_color")),
                           ({"texture": True, "depth": True},
                            ("K5_loss_fwd_color_depth", "K6_loss_bwd_color_depth"))):
        extra = bench_problem((400, 400), subdiv=5, batch=64, device="cuda", **variant)
        print(f"bench problem {variant}: crop {extra['fn'].crop}", flush=True)
        for row in check_kernels(extra["fn"], mtx, d_sums, reps=20):
            print(f"bench shapes {variant} {row['name']}: ok={row['ok']} "
                  f"max_abs_err={row['max_abs_err']:.3e} kernel {row['ms']:.4f} ms, "
                  f"plain {row['plain_ms']:.4f} ms, bound {row['bound'][0]:.4f} ms "
                  f"({row['bound'][1]}){slots(row)} [{gpu}]", flush=True)
            if not row["ok"]:
                fail(f"{row['name']} disagrees with its plain version at bench "
                     f"shapes {variant}: {row}")
            if row["name"] in names:
                bench_rows[row["name"]] = row
        del extra
        torch.cuda.empty_cache()
    # K8 and K9 at the bench shapes: the bench scene's mesh at its 64 distinct
    # poses
    sc = problem["scene"]
    bench_rows["K8_raster_ids"] = k8_check("bench shapes", gpu, sc["proj"], mtx, sc["pos"],
                                           sc["tri"], (400, 400), API_TILE, reps=20)
    for row in k9_check("bench shapes", gpu, sc["proj"], mtx, sc["pos"], sc["tri"],
                        sc["vtx_color"], sc["edge_adj"], (400, 400), API_TILE, reps=20):
        bench_rows[row["name"]] = row
    torch.cuda.empty_cache()
    # K10 on the bench problem's 'v3' variant (the sorted table of its 20,480
    # triangles)
    v3 = bench_problem((400, 400), subdiv=5, batch=64, device="cuda", route="v3")
    for name, row in planar_checks("bench shapes v3", gpu, v3, mtx, d_sums,
                                   reps=20).items():
        if name.startswith("K10"):
            bench_rows[name] = row
    del v3
    torch.cuda.empty_cache()

    # ---- the bench main path ------------------------------------------------
    # one captured refinement, as the bench keeps it: the warm-up pays step 0
    # and the capture, the timed run replays
    jit_refine = bench_refine(problem)
    with Captures() as warm_caps:
        run_refinement(problem, jit_refine=jit_refine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with Captures() as caps:
        res, seconds = run_refinement(problem, jit_refine=jit_refine)
    launches = dict(kernels.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = res.total_loss.shape[0]
    print(f"main path: {steps} steps, B=64, 400x400: {seconds:.4f} s, "
          f"{1e3 * seconds / steps:.3f} ms/step, {1.0 / seconds:.4f} refinements/s, "
          f"peak {peak_gib:.2f} GiB; warm-up {warm_caps.summary()}, timed run "
          f"{caps.count} capture(s) [{gpu}]", flush=True)
    if warm_caps.count != 1 or caps.count:
        fail(f"main path: {warm_caps.count} capture(s) in the warm-up, {caps.count} in "
             f"the timed run (one kept capture: 1 and 0)")
    del jit_refine
    print(f"launches in the main path: {launches}", flush=True)
    check_launches("main path", launches, COMPACT_FUSED,
                   set(launches) - set(COMPACT_FUSED))
    if launches["pack_fwd"] != launches["raster_fwd"]:
        fail("a table of the main path was not packed by K1")

    total = res.total_loss.cpu()
    if not bool(torch.isfinite(total).all()):
        fail(f"non-finite loss: {total}")
    print(f"loss: first {float(total[0]):.6f}, last {float(total[-1]):.6f}", flush=True)
    if not float(total[-1]) < float(total[0]):
        fail("the loss did not fall")
    if problem["fn"].crop is None:
        fail("the bench problem runs without its ROI crop")
    for key in ("_bin_overflow", "_crop_leak"):
        worst = int(res.telemetry[key].max())
        print(f"{key}: max {worst} per step", flush=True)
        if worst != 0:
            fail(f"{key} is {worst}")
    best = int(argmin_hypothesis(res.losses_values))
    final, _, _ = pose_matrix(res.params)
    pos = problem["scene"]["pos"]
    mtx_gt = problem["mtx_gt"][0]
    start, _, _ = pose_matrix(problem["params0"])

    def add(m):
        return float(add_metric(pos, m[:3, :3], m[:3, 3], mtx_gt[:3, :3], mtx_gt[:3, 3]))

    add0, add1 = add(start[best]), add(final[best])
    print(f"best hypothesis {best}: ADD {add0:.6f} -> {add1:.6f} (object units)",
          flush=True)
    if not add1 < add0:
        fail("the best hypothesis did not end closer to the gt pose")
    drows_lanes(problem)

    # ---- DiffDope at the default configuration ------------------------------
    dd_f, launches_f, add0, add1 = diffdope_phase(True, gpu, "fused")
    check_launches("DiffDope fused", launches_f, COMPACT_FUSED,
                   set(launches_f) - set(COMPACT_FUSED))
    check_diffdope(dd_f, "fused", add0, add1)

    dd_u, launches_u, add0, add1 = diffdope_phase(False, gpu, "unfused")
    check_launches("DiffDope unfused", launches_u, COMPACT_UNFUSED,
                   set(launches_u) - set(COMPACT_UNFUSED))
    check_diffdope(dd_u, "unfused", add0, add1)
    step0_f = {k: v[0] for k, v in dd_f.losses_values.items()}
    agree_step0("DiffDope unfused against fused",
                {k: v[0] for k, v in dd_u.losses_values.items()}, step0_f,
                sorted(step0_f))
    del dd_u

    # ---- DiffDope with the depth loss: the compact and the uniform table ----
    depth = {"l1_depth_with_mask": True}
    dd_c, launches_c, add0, add1 = diffdope_phase(True, gpu, "depth compact", losses=depth)
    on = ("pack_fwd", "pack_bwd", "raster_fwd", "raster_bwd", "loss_fwd_depth",
          "loss_bwd_depth")
    check_launches("DiffDope depth compact", launches_c, on, set(launches_c) - set(on))
    check_diffdope(dd_c, "depth compact", add0, add1)
    step0_c = {k: v[0] for k, v in dd_c.losses_values.items()}
    agree_step0("DiffDope depth compact against one unfused render", step0_c,
                unfused_step0(dd_c), ("mask_selection", "depth"))

    adds_c = (add0, add1)
    dd_k, launches_k, add0, add1 = diffdope_phase(
        True, gpu, "depth uniform", tpu={"compact_bins": False}, losses=depth)
    on = ("pack_fwd", "pack_bwd", "raster_uniform_fwd", "raster_uniform_bwd",
          "loss_fwd_depth", "loss_bwd_depth")
    check_launches("DiffDope depth uniform", launches_k, on, set(launches_k) - set(on))
    check_diffdope(dd_k, "depth uniform", add0, add1)
    mtx_last = torch.as_tensor(dd_k.mtx_history[-1], device="cuda")
    for row in check_kernels(dd_k._make_render_fn(), mtx_last):
        print(f"DiffDope depth uniform render shapes {row['name']}: ok={row['ok']} "
              f"max_abs_err={row['max_abs_err']:.3e} ({row['tolerance']}){slots(row)}",
              flush=True)
        if not row["ok"]:
            fail(f"{row['name']} disagrees with its plain version on the uniform "
                 f"render's tables: {row}")
    agree_step0("DiffDope depth uniform against depth compact",
                {k: v[0] for k, v in dd_k.losses_values.items()}, step0_c,
                ("mask_selection", "depth"))
    # the ROI crop at the init, even where the kept compact run dropped it
    # after a leak: no leak there, the uniform run's step-0 logs, and the
    # same slots per tile as the uniform table
    mtx0 = torch.as_tensor(dd_c.mtx_history[0], device="cuda")
    crop_kept, dd_c._crop_disable = getattr(dd_c, "_crop_disable", False), False
    fn_c = dd_c._make_fused_loss_fn(dd_c.gt_tensors)
    if fn_c.crop is None:
        fail("DiffDope depth compact: the fused loss has no ROI crop at the init")
    with torch.no_grad():
        _, logs_c = fn_c(mtx0)
    if int(logs_c["_crop_leak"]) or int(logs_c["_bin_overflow"]):
        fail(f"DiffDope depth compact: the crop at the init leaks or drops: {logs_c}")
    agree_step0(f"DiffDope depth, crop {fn_c.crop} at the init, against uniform",
                {k: logs_c[k].cpu().numpy() for k in ("mask_selection", "depth")},
                {k: v[0] for k, v in dd_k.losses_values.items()},
                ("mask_selection", "depth"))
    fn_k = dd_k._make_fused_loss_fn(dd_k.gt_tensors)
    n = same_slots(fn_c, fn_k, mtx0)
    print(f"DiffDope depth: at the init the compact table (crop {fn_c.crop}) and the "
          f"uniform table hold the same {n} slots per tile in the same order",
          flush=True)
    # K2 on the two layouts of the init's bins: equal bit for bit, and
    # timed on each
    layout_row = check_pack_layouts(fn_c, fn_k, mtx0, reps=20)
    print(f"DiffDope depth K2 layouts: ok={layout_row['ok']} "
          f"max_abs_err={layout_row['max_abs_err']:.3e} ({layout_row['tolerance']}), "
          f"{layout_row['slots']} live slots of {layout_row['table_slots']} (compact, "
          f"uniform); K2 {layout_row['ms_a']:.4f} ms on the compact table, "
          f"{layout_row['ms_b']:.4f} ms on the uniform table [{gpu}]", flush=True)
    if not layout_row["ok"]:
        fail(f"K2 gives the compact and the uniform table other sums: {layout_row}")
    # F3: the two tables refine to the same poses at every step, bit for bit
    dd_c._crop_disable = crop_kept
    same_poses(dd_c, dd_k, adds_c, (add0, add1))

    del dd_c, dd_k, fn_c, fn_k
    torch.cuda.empty_cache()

    # ---- the API path (K8) and DiffDope on the reference rasterizer -------
    api_launches, seg_row = api_phase(gpu)
    torch.cuda.empty_cache()
    auto_phase(gpu)
    torch.cuda.empty_cache()

    # ---- the planar routes and K9 -------------------------------------------
    launches_3, _ = planar_phases(gpu, step0_f)
    torch.cuda.empty_cache()
    k9_launches = k9_phase(gpu)
    torch.cuda.empty_cache()

    # ---- exact texture and appearance refinement ---------------------------
    launches_t = texture_phase(gpu, "checker", depth=False)
    torch.cuda.empty_cache()
    texture_phase(gpu, "smooth", depth=False)
    torch.cuda.empty_cache()
    launches_td = texture_phase(gpu, "smooth", depth=True)
    torch.cuda.empty_cache()
    appearance_phase(gpu)
    torch.cuda.empty_cache()

    # ---- the default configuration from files -------------------------------
    files_phase(gpu)
    torch.cuda.empty_cache()

    # ---- the BOP evaluation path: the synthesized sweep, a real-format scene -
    bop_sweep_phase(gpu)
    torch.cuda.empty_cache()
    bop_scene_phase(gpu)
    torch.cuda.empty_cache()

    # ---- viz and the hypotheses sharded over two ranks (phase 5's session) --
    viz_phase(dd_f, gpu)
    sharded_phase(dd_f, gpu)
    del dd_f
    torch.cuda.empty_cache()

    # ---- the reference's last public surface: the config's copy, Mesh.scaled -
    host_api_phase(gpu)
    torch.cuda.empty_cache()

    # ---- the default configuration from JPEG files ---------------------------
    jpeg_phase(gpu)
    torch.cuda.empty_cache()

    # ---- the default configuration from TIFF, BMP and Netpbm files ----------
    formats_phase(gpu)
    torch.cuda.empty_cache()

    # ---- the WebP corpus, and the default configuration from WebP files -----
    webp_phase(gpu)
    torch.cuda.empty_cache()

    # ---- the later formats: masks, depths and images cv2 reads --------------
    later_formats_phase(gpu)
    torch.cuda.empty_cache()

    # ---- OpenEXR: the corpus, and the default configuration from EXR files ---
    exr_phase(gpu)
    torch.cuda.empty_cache()

    # ---- the compiled refinement: graph replays against the eager loop -------
    compiled_refine_phase(problem, gpu)

    # launches on the path that runs each kernel: the bench main path (its
    # bf16 lane of K6/K4), the depth phase on the compact table (K4 with
    # f32 d_rows), the depth phase on the uniform one, phase 11 (K10, and
    # the f32 rgb + mask K6 of its chained ops), the API path (K8 and the
    # setup rows' sum), phase 13 (K9) and phase 14 and its depth variant
    # (the colour lane)
    path = {**launches_c, **{c: launches_k[c] for c in
                             ("raster_uniform_fwd", "raster_uniform_bwd")},
            **{c: launches[c] for c in COMPACT_FUSED},
            **{c: api_launches[c] for c in ("raster_ids", "setup_rows_bwd")},
            "gather_rows_fwd": k9_launches, "gather_rows_bwd": k9_launches,
            **{c: launches_3[c] for c in ("raster_v3_fwd", "raster_v3_bwd", "loss_bwd")},
            **{c: launches_t[c] for c in ("loss_fwd_color", "loss_bwd_color")},
            **{c: launches_td[c] for c in ("loss_fwd_color_depth", "loss_bwd_color_depth")}}
    bench_rows["setup_rows_bwd"] = seg_row
    kernel_rows = dict(KERNELS, setup_rows_bwd=(
        "diffdope_tpu_torch/csrc/rasterize.cu", "diffdope_tpu/render/rasterize.py:245"))
    counters = dict(COUNTERS, setup_rows_bwd="setup_rows_bwd")
    rows = []
    for name, (source, replaces) in kernel_rows.items():
        r = bench_rows[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path[counters[name]], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r.get("library_ms"),
        })
        if name == "K2_pack_bwd":  # the autograd check above, and the layouts'
            rows[-1]["layouts_bit_equal"] = layout_row["ok"]
        if not path[counters[name]]:
            fail(f"{name} was launched no time on its path")
    print(json.dumps({"kernels": rows}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
