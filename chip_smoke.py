#!/usr/bin/env python3
"""Drive mesh_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; none catches its own):

1. probe: torch/CUDA versions, the card's name and power limit, and the
   build of every CUDA kernel from ``mesh_tpu_torch/csrc`` (nvcc, sm_90a);
2. kernels vs plain: each kernel against its plain PyTorch version on the
   same card tensors, at the main path's shapes (256 posed SMPL-sized
   bodies x 1024 queries; closest_faces in all four variants, with the
   exact and the fused reduction) and on one body with 4096 queries (all
   variants; the fused reduction also with NaN planted in three faces and
   two queries; the degenerate-tail variants also on a mesh with planted
   zero-area and collinear faces) and with 4096 queries at 10-100x its
   radius (all variants, both reductions); closest_faces' chunk cull on
   each of these against the plain version of its design (faces, chunks
   each warp folded, faces each lane needed, chunks each warp staged),
   the every-face plain version and the every-face kernel
   (``closest_faces_every``, which launches on no driven path), with the
   shares of chunks tested, and its chunk records (``cull_records``)
   against their plain version; culled_faces in all four variants on
   the large batch of phase 5 (faces, face tiles and warp chunks tested
   and faces each query folded against its plain version, faces and face
   tiles against every face of each tested tile, with the fractions of
   tiles, chunks and pairs tested), both rope_faces entries on the scan of
   phase 6 (the resident one at every sub-lane count of ``rk.LANES`` and at
   the one it picks, each timed), and both rope_mxu_faces entries, f32
   and bf16, on that scan and on 8,192 mixed-radius queries around its
   sphere (where the bf16 screen must skip visits), each over all its query
   tiles at every sub-lane count and at the pick (timed on the scan);
   ray_any_hit (every face) and ray_any_hit_culled on every ray of phase 7
   (64 bodies x 4 cameras x 6890 vertices; the culled kernel on each
   body's vertices in Morton order, its flags the every-face kernel's, its
   flags, pairs per ray, chunks per warp and blocking faces its plain
   version's) and the culled kernel on planted sets (grazing rays within
   1e-6 rad of a flat grid's plane, NaN and inf corners, t in [0, 1.5]),
   alongnormal_faces at phase 8's shapes and on planted sets (phase 8's
   first ALONG_PLANTED queries with NaN normals, normals of norm 3 and 0,
   as many queries at 10-100x the body's radius, the planted degenerate
   mesh, lines through a flat grid's shared edges and vertices and lines
   within GRAZE_TILT rad of its plane, body 0 scaled by 1e15): its chunk
   cull against the plain version of its design (faces, chunks each warp
   folded, faces each lane needed, chunks each warp staged, miss
   candidates each lane folded), the every-face plain version and the
   every-face kernel (``alongnormal_faces_every``, which launches on no
   driven path), at phase 8's shapes every split of ALONG_SPLITS timed
   against its plain version, with the kernel's bounds (the pairs its
   lanes need, the pairs its warps issue and every pair) and, apart, the
   time its own tests, fallbacks, bounds, misses and seed would take at
   the card's peak; normal_weighted_faces (with and without
   the degenerate tail) at phase 8's shapes, the tail variant also on the
   planted mesh and, in the drive's tail, on NW_PLANTED of phase 8's
   queries with NaN normals, normals of norm 3 and 0, eps = -0.1 and 0,
   and on as many queries at 10-100x the body's radius (the planted miss's
   kind): normal_weighted_faces' chunk cull on each against the plain
   version of its design (faces, chunks each warp folded, faces each lane
   needed, chunks each warp staged), the every-face plain version and the
   every-face kernel (``normal_weighted_faces_every``, which launches on
   no driven path), with its chunk records against cull_records_plain and,
   at phase 8's shapes, every split of NW_SPLITS timed against its plain
   version; tri_tri_any_hit in both tiles at phase 9's shapes (1,552
   hand faces x 13,776 body faces) against the every-pair plain version
   and the every-pair kernel (``tri_tri_any_hit_every``, which launches on
   no driven path; flags and first hits), the Moller tile's cull also
   against the plain version of its design (flags, first hits, warp and
   lane counts) with its records kernel (``tri_records``) against
   ``tri_records_plain``, on those shapes (every split of TRI_SPLITS
   timed) and on the planted sets of ``tri_planted`` (NaN corners and
   normals, zero normals, coplanar overlaps, grazing copies, far queries,
   coordinates near the margin's 2^100 cap, triangles hitting in several
   splits), the segment tile also with the planted
   mesh's faces as queries against body 0; self_intersect in both tiles on
   every face of body 0 and of phase 5's body 0 (98,304 faces) and of
   their rest templates in the kernel's Morton face order, against the
   plain version of its design (counts, warp tiles tested, each face's
   work) and the every-pair plain version (counts; at 98,304 faces the
   plain versions of the tile the gate does not take run on a query range
   of whole warps only), and on the query range [F / 4, F / 2) of each,
   with the fractions of warp-tiles tested and of pairs each lane tested
   and sent to the interval part; leaf_boxes on phase
   11's two keyframes at leaf 256, the 98,304-face keyframe at leaf 8 (16,384
   leaves), phase 6's scan at leaves 256 and 8, a copy with planted NaN
   corners and one with corners at +-0.0, the keyframes at leaves 5 and 3
   and the 98,304-face one in views 4 bytes past a 16-byte boundary at
   leaves 256 and 8 (the kernel's corner items), each against its plain
   version and the warp-a-leaf oracle (``leaf_boxes_warp``, which launches
   on no driven path) (the 98,304-face keyframe at leaves 256 and 8 timed
   with L2 flushed before each call, as the HBM bound assumes, and with
   the operand in L2; the row in the kernels line is leaf 256's), and an
   empty launch timed beside them; nearest_vertices at the main path's
   batch, on body 0 (every split of the vertex axis), on its far queries
   and on planted meshes (vertices duplicated across each split boundary,
   queries equidistant from two vertices in different splits, a NaN query,
   queries whose costs overflow to +inf), against its plain version and
   the every-vertex oracle (``nearest_vertices_every``, which launches on
   no driven path); mxu_faces,
   mxu_bound_culled (the bound pass) and mxu_repair at phase 12's shapes
   with and without the
   degenerate tail, the tail also on the planted mesh, and both tails on
   body 0's far queries: the chunk culls of mxu_faces and mxu_repair
   against the plain versions of their design (faces, tiles run, chunks
   each warp folded, faces each lane needed, chunks each warp staged), the
   every-face plain versions and the every-face kernels
   (``mxu_faces_every``, ``mxu_repair_every``, which launch on no driven
   path), with the shares of chunks tested and their chunk records against
   ``cull_records_plain``; the bound pass's chunk cull
   (``mxu_bound_culled``) bit for bit against the plain version of its
   design (ub, cert, counts) and within its contract against the
   every-face kernel (``mxu_bound``, which launches on no driven path) and
   plain version, the repair fed its ub and cert giving the every-face
   path's faces and tiles run, and the repair's faces the dense scan's;
   the bound pass also on body 0's far queries with a NaN a2, a NaN
   reach and a NaN query planted.
   Built without FMA contraction,
   each kernel must pick exactly the faces (vertices, blocked flags,
   counts, leaf boxes) its plain version picks, with the same tiles,
   leaves or pairs tested; culled_faces' three variants other than phase
   5's own are held on the first CULLED_CHECK_BODIES bodies;
3. main path at full width: lbs -> vertex normals -> batched closest point
   for 256 bodies x 1024 queries, median step time over 10 reps, the
   faces checked against the plain version on the same batch;
3b. main_path_fused: the same step with ``closest_point_kernel(reduction=
   "fused")`` (bench.py's MESH_TPU_BENCH_REDUCTION=fused step), median step
   time over 10 reps; every winner's exact sqdist within (1 + 4 x 2^-12) of
   phase 3's;
4. facade: ``mesh_tpu_torch.Mesh`` closest faces/points (through the
   query engine: a CUDA-graph plan of the brute-force step), nearest
   vertices, vertex normals and the fused call on one body, with the
   reference's dtypes and shapes; the closest faces/points against the
   plain reconstruction-form scan;
5. large batch: ``batch_step`` on 64 posed bodies of a 98,304-face
   template (``_uv_sphere(256, 192)``) with 4096 surface-proximal queries
   each, which routes to the sphere-culled kernel; median step time over
   10 reps, and the result against the brute-force kernel on the same
   inputs (sqdist within 1e-5, faces equal except at ties);
6. scan: ``Mesh.closest_faces_and_points`` on a 209,304-face sphere with
   65,536 surface-proximal queries under ``MESH_TPU_NO_ENGINE=1`` (the
   engine would take the culled kernel; its direct route, the auto ladder,
   takes the BVH rope kernels):
   the streamed entry by default (path ``scan``) and the resident one
   under ``MESH_TPU_BVH_STREAM_VMEM_MB=32`` (path ``scan_resident``); the
   two must be bit-identical, and both are held against the brute-force
   kernel; the host BVH build is timed apart from the cached calls;
7. visibility: ``visibility_step`` on 64 posed bodies from four cameras
   at (+-3, 0, 0) and (0, +-3, 0) (the culled any-hit kernel; the
   every-face one launches on no driven path), vertex normals computed in
   the step,
   median step time over 10 reps; body 0's flags against a float64
   divided-form recompute (equal except on rays borderline at rounding
   level); on the rest template, a closed surface without folds, every
   back-facing vertex (n.dir < -0.2) must be blocked (the posed synthetic
   bodies fold through themselves, so there the count is only reported);
   then one body through ``Mesh.vertex_visibility`` (omnidirectional and
   with a sensor) and ``visible_mesh``;
8. registration: one posed body as a ``Mesh`` with 65,536 scan-like points
   carrying noisy face normals, through ``compute_aabb_normals_tree()
   .nearest`` and ``compute_aabb_tree().nearest_alongnormal`` (cold first
   call and median of 5 warm calls each), held against float64 dense
   recomputes; a planted miss must come back as 1e100;
9. contact: examples/hand_body_contact.py through the port: an SMPL-sized
   body and a MANO-sized hand (``synthetic_family_model``) posed by its
   recipe, ``compute_aabb_tree().intersections_indices`` (the gate's tile,
   and the segment tile under ``MESH_TPU_SAFE_TILES=1``: the same faces),
   ``tree.nearest`` and the signed gap from ``tri_normals``; the cold first
   call and the median of 5 warm calls of the step and of
   ``intersections_indices``; each tile's mask against a float64
   recompute of its own predicate (``decide64``: equal except on faces
   borderline within TOL_MOVE);
10. self_intersect: ``query.self_intersection_count`` on phase 3's and
   phase 5's posed body 0 (cold first call, median of 5 warm calls, the
   kernel alone in both tiles): 0 on each rest template (a closed UV
   sphere), above 0 posed, each tile's involved faces those the
   every-pair kernel counted (SELF_EXPECTED) and its per-face counts phase
   2's; where the two tiles' involved faces differ,
   and on 512 faces (half involved), each tile against a float64
   recompute of its own predicate;
11. anim: an ``AvatarSession(Mesh(rest), leaf_size=256)`` (the default
   leaf-box route, the CUDA kernel) for phase 3's SMPL-sized model (13,776 faces) and one for phase 5's
   (98,304 faces), each streaming 64 frames: lbs on the card along a
   straight pose trajectory between two N(0, 0.2) poses, frame 40
   stretched 20x (a rebuild), 4096 surface-proximal queries and a 1/30 s
   deadline per frame, then 5 cold frames under ``MESH_TPU_ANIM=0``.  Each
   frame's answers against the brute-force kernel (sqdist within 1e-5,
   faces equal except at ties), its boxes against a ``kernel="host"``
   refit, every face inside its leaf box, no index built on a refit frame,
   and the actions and inflations of a ``kernel="host"`` session fed the
   same frames;
12. mxu: ``Mesh.closest_faces_and_points`` under ``MESH_TPU_MXU=1``, then
   with ``MESH_TPU_MXU_BF16=1`` too (both under ``MESH_TPU_NO_ENGINE=1``:
   the engine never takes the MXU rung), on posed body 0 with phase 4's 4096
   queries and on a 32,512-face ``_sphere_mesh(32768)`` with 65,536
   surface-proximal and 65,536 N(0, 0.4) queries (cold first call, median
   of 5 warm calls; the surface queries in bench.py's patches of 256, one
   per query tile): the MXU rung's dense scan, then the bf16 bound pass
   and the f32 exact repair on one set of cull operands, each repair call
   reported beside its dense call.  Each answer against the brute-force kernel
   (sqdist within 1e-5, faces equal except at ties), the repair's answers
   equal to the dense scan's, fewer face tiles repaired than screened on
   the surface-proximal queries; the environment is restored afterwards;
13. mxu_bvh: ``Mesh.closest_faces_and_points`` on phase 6's scan under
   ``MESH_TPU_NO_ENGINE=1`` and
   ``MESH_TPU_MXU=1`` with ``MESH_TPU_MXU_CROSSOVER_FACES=8192`` (the
   card's saved calibration puts the crossover past this mesh), streamed
   (path ``mxu_bvh``) and resident under ``MESH_TPU_BVH_STREAM_VMEM_MB=32``
   (path ``mxu_bvh_resident``), each f32 and then under
   ``MESH_TPU_MXU_BF16=1`` (cold first call, median of 5 warm calls): the
   MXU rope walks.  The four answers bit-identical, against the brute-force
   kernel and phase 6's VPU walk under the tie contract, and the repair
   series moved by the screen's skipped visits; the environment is
   restored afterwards.

14. fit: the training path on ``synthetic_body_model(seed=0)`` (6,890
   vertices, 13,776 faces, 24 joints, 10 betas), at bench.py's
   fit_step_latency shape (1 body x 256 N(0, 0.3) scan points) and at
   BASELINE.json config 5's (1 body x 100,000 surface samples of posed
   body 0): ``scan_to_model_loss`` forward and value-and-grad times
   (``cuda_ms``) and their ratio, one closest_faces launch a forward and
   a value-and-grad (the backward re-runs no search), whether two
   backwards were bit-identical, 10 steps of ``make_fit_step`` with a
   falling loss, and the kernel route's gradients against the plain
   scan's on the queries whose faces agree; ``torch.func.jvp`` through
   ``diff.closest_point(mode="recompute")`` with the kernel launching
   inside, against the gradient's projection; ``diff.
   nearest_normal_weighted`` on phase 8's set (faces equal to the plain
   version's); ``diff.closest_point`` over a BVH index on phase 6's scan
   mesh (the streamed rope walk) against the default route (the culled
   kernel) where the faces agree; ``register_vertices`` from the rest
   template to posed body 0, 30 steps with a burst every 5 (each burst
   through the query engine); after the checks, two backward passes of
   ``diff.closest_point`` at 1 x 100,000 bit-equal, ``torch.func.vmap``
   of it over 4 bodies of phase 3 equal to ``closest_point_batched`` bit
   for bit (outputs and gradients) with one closest_faces launch, and
   ``torch.func.vmap`` of ``diff.point_to_triangle`` equal to its plain
   call; then the step's stages at 1 x 100,000 (lbs, search,
   recomposition, backward, Adam);
14b. empty: a set of no queries through every entry point (the Mesh
   facade on the brute, culled and BVH rungs, nearest vertices, both
   trees, the batched and fused facades, the diff wrappers), each with
   the reference's empty shapes and dtypes, and no kernel launched.
15. engine: the query engine (``mesh_tpu_torch.engine``), every plan a
   CUDA graph, from an empty plan cache: the numpy facades
   (``batched_closest_faces_and_points``, ``fused_normals_and_closest_
   points`` and ``batched_vertex_normals`` five times at phase 3's 256 x
   1024, ``batched_vertex_visibility`` at phase 7's 64 x 4 cameras), Mesh
   on body 0 at Q = 1100, 1500, 2048 (one bucket) and 2049 (the next:
   exactly two plans made), Mesh on phase 6's scan sphere (above the
   crossover: ``culled_faces``), ``warmup()`` on the SMPL and FLAME shapes
   and then SMPL-shaped bodies (no plan made), 16 requests to the executor
   inside ``coalesce()`` (Q 700-1024: one dispatch) with one past its
   deadline and one cancelled, phase 14's ICP, and the large batch's
   normals five times.  After the counted drive, each answer against the
   same call under ``MESH_TPU_NO_ENGINE=1`` and, for the graphs, against
   the eager step on the request's own shape, bit for bit (the scan's
   culled answer against the eager culled kernel, and against the direct
   route's rope walk under the tie contract), every answer a graph's
   replay, a plan miss's too; every executor future equal
   to its facade call; ICP losses equal; normals bit-identical run to run
   and within 1e-5 of a float64 recompute; the centering's vertex mean
   of a body alone equal to its row in the batch and within 1e-6 of the
   float64 mean; then each op's engine call
   against its direct call on the host clock in interleaved rounds, with
   each plan's capture seconds, launches per replay, the graph pool's
   bytes and ``torch.cuda.memory_reserved`` around the phase.
16. fallback: the reference's fallback routes, counts set to 0 just before
   each sub-drive and read just after it, every knob restored.  16a:
   ``Mesh(body 0).compute_aabb_tree(strategy="anchored")`` on phase 8's
   65,536 scan points and on phase 5's 98,304-face body 0 with its 4096
   queries: the table build (first call) and 5 warm calls on the host
   clock, the tight share, closest_faces (and cull_records) launched once
   a call that had a loose query and nothing else, every answer against
   the brute-force kernel.  16b: under ``MESH_TPU_FORCE_XLA=1``, Mesh
   closest faces/points on body 0 x 4096 (an engine plan of the plain
   scan), ``batched_closest_faces_and_points`` on 16 bodies x 1024,
   ``closest_vertices``, ``batched_vertex_visibility`` on 4 bodies x 4
   cameras, both trees on phase 8's set, ``intersections_indices`` on
   phase 9's meshes, ``self_intersection_count`` of body 0 and
   ``diff.closest_point`` on 4096: no kernel launched, every decision
   counted as forced, and each answer against the kernel route's (faces
   but at ties, flags but on float64-borderline rays or faces, the
   intersection and self-intersection counts against their float64
   segment predicate).  16c: the auto facade's top-k culled rung under the
   knob on phase 5's body 0 x 4096: the route once a call, the fallback
   counted, the answers against the brute kernel.  16d: the accel
   facade's plain walks on phase 6's scan, under
   ``MESH_TPU_ACCEL_KIND=grid`` and under ``MESH_TPU_BVH_STREAM=0`` (the
   leaf-8 BVH): the index build, one call once it is built and on the
   card (the kernel route's call timed beside it), the tight share,
   fallback and steps, no kernel launched, the answers against the brute
   kernel and the first 4096 bit for bit against the plain scan.  16e:
   ``calibrate_crossover``, ``calibrate_accel_crossover``,
   ``calibrate_stream_tiles`` and ``calibrate_mxu_crossover`` with
   ``save=False``, each ladder logged; the measurements they set are
   restored and every threshold must read as before.  Run with
   ``MESH_TPU_FORCE_XLA=1`` set, the script builds the kernels and runs
   phase 16 alone, without 16e: every facade under the knob, each answer
   held against the kernels, which it calls by name.

17. domain: a psbody-style workflow through the ``Mesh`` facade on
   ``synthetic_body_model(seed=0)``'s rest template and posed body 0, with
   a segmentation into the joints' parts (each face takes the argmax of its
   corners' summed skinning weights) and 20 seeded landmarks: a. posed body
   0 written as binary and ascii PLY, OBJ and JSON and read back through
   ``Mesh(filename=...)``, the native reader (which must have built) and
   the Python reader, each bit-equal to what the file holds; b.
   ``set_landmarks_from_xyz`` and ``recompute_landmark_indices`` (the
   nearest-vertex and closest-face kernels); c. a Loop level
   (``topology.loop_subdivider``, 55,104 faces) carrying the segmentation
   (``transfer_segm``: 55,104 centroid queries) and the landmarks; d. on
   the card only, a second level (220,416 faces; its centroids against the
   55,104-face donor, above the brute/culled crossover: culled_faces),
   4096 seeded faces held to a float64 scan of the donor (the part of a
   donor face at the least distance, up to ties); e. ``simplified(
   factor=0.5)`` applied, ``uniquified_mesh``, ``keep_vertices``,
   ``remove_faces``, ``concatenate_mesh``, ``reorder_vertices``,
   ``flip_faces`` (landmarks recomputed on the card by the edits),
   ``subdivide_triangles``, ``estimate_circumference`` at three planes and
   ``visible_mesh`` (the culled any-hit kernel).  Counts set to 0 just
   before the card run and read just after it; then the same workflow
   (without d) with ``device="cpu"``, the port's plain versions: numpy
   outputs bit for bit, landmark indices and parts equal but at float64
   ties, regressor coefficients within 1e-5, normals within 1e-6,
   visibility flags equal but on float64-borderline rays.

18. serve: the serving tier (``mesh_tpu_torch.serve``) over posed body 0
   (1024 N(0, 0.4) queries a request, bench.py's) and phase 5's posed
   98,304-face body 0 (4096 scan-like queries), counts set to 0 just before
   step a and read just after step g, each step's apart: a. a
   ``QueryService(workers=2)`` with the real watchdog warms every rung of
   the default ladder (engine, culled, anchored); b. one-rung ladders
   (``MESH_TPU_SERVE_LADDER``) engine on both meshes, culled, anchored and
   accel on the body, and anchored again on 1024 queries within about 1
   mm of the body's vertices, each warmed and then one request, answered
   by its rung with no retry: engine launches closest_faces and
   cull_records on the body and culled_faces on the template, accel the
   resident rope walk, culled and anchored nothing; c. bench.py
   serve_load's closed loop (4 clients x 24 requests, a 0.5 s deadline,
   three rounds; per round the plans made, the garbage collector's pauses,
   the slowest request's stages and each tenant's longest queue wait); d.
   its open loop (40 qps for 1 s); e. ``run_periodic``: 6 avatar streams
   at 30 Hz with a 1/30 s frame deadline for 1 s; f. ``run_trace_replay``
   of ``synth_mix(seed=7)`` at speed 1; g. a wedge: a ladder of a top rung
   blocked on an Event and the engine, a 0.2 s watchdog threshold.  After
   the window: every rung's answer against the brute-force kernel (sqdist
   within 1e-5, faces equal except at float64 ties within 1e-6; culled and
   anchored on their tight queries, with ``certified`` equal to every query
   tight, and most of the request near the surface tight); c-f answered
   by the engine with no retry, no shed and the retries counter at 0, the
   replay's checksum the null replay's; in g the first request answered
   by the engine with one retry within twice its deadline and health
   DEGRADED, the next started at rung 1, and after the release and 3
   successes health HEALTHY and the top rung answering; every closed-loop
   request a closed ledger row with its stages,
   ``mesh_tpu_serve_requests_total`` the requests issued, the stats sink
   read back, an ``SLOMonitor``'s availability good / total of the
   counters; the phase within 60 s.  Then the engine rung's dispatch on
   the card: each cached plan of the body's 1024-query bucket replayed 50
   times between CUDA events, the one-request plan's kernels by
   ``torch.profiler``.

19. store: the mesh store (``mesh_tpu_torch.store``) in a temporary root
   (``MESH_TPU_STORE_DIR``), counts set to 0 just before step a and read
   just after step d: a. phase 6's scan sphere ingested, one warm
   ``Mesh`` call through phase 6's route (the streamed rope walk; its
   index built and persisted as a side-car under the tag of the leaf size
   the walk asks for) and the warm answers on bench.py's 64 jittered
   unit-sphere queries; b. posed body 0 through ``Mesh.write_store`` and
   ``Mesh.load_from_store``, each answering phase 4's 4096 queries; c.
   8 requests of 1024 N(0, 0.4) queries by body 0's digest through a
   ``QueryService(workers=2)`` with a 0.5 s deadline, each with an inline
   twin, then an unknown key and one more keyed request; d. 16 ``lbs``
   frames of the SMPL-sized body written as a delta sequence against its
   stored rest keyframe and streamed through ``resolve_frame`` into
   ``AvatarSession(digest=..., leaf_size=256)`` with 4096 queries a frame.
   After the window: a child process on the card (its own launches) runs
   the cold start's side-car arm (open, ``get_index``, walk) and rebuild
   arm (open, ``build_bvh``, walk), best of 2 each on the host clock,
   answering bit-equal to the warm answers, with side-car hits and no
   build miss in the side-car arm; the compact tiers within their
   manifests' tolerance and ``verify`` clean; the loaded Mesh's answers
   equal to its source's; the first keyed request paged, the rest
   resident, each with a ``page_in`` stage and equal to its twin bit for
   bit, request 0 against the brute-force kernel, the unknown key a
   ``StoreError`` for that request alone; every decoded frame within the
   sequence's tolerance, its answers against the brute-force kernel on the
   decoded geometry, one ``leaf_boxes`` launch a frame and no index built
   on a refit frame; a paged mesh's upload timed; the phase within 120 s.

21. parallel: ``mesh_tpu_torch.parallel`` in a world of PARALLEL_RANKS
   processes (``parallel_backend``: NCCL with a card a rank; on one card
   gloo, every rank on card 0 and the collectives staged through the host,
   since NCCL refuses two ranks on one GPU; the phase prints which), each
   rank's launches counted over its window (set to 0
   just before a, read just after e) and summed with the parent's window
   of f: a. BASELINE config 5 on a mesh: phase 14's 100,000 scan points
   against posed body 0 through ``sharded_closest_faces_and_points`` and
   through ``multihost_closest_faces_and_points`` with ragged per-rank
   counts and one zero-row rank, each bit-equal to one single-device
   ``closest_point_kernel`` call on the whole set; b. 4,096 landmark-like
   queries against phase 6's 209,304-face sphere, face-sharded, merged by
   gather and by ring: faces, parts, points and sqdist bit-equal to the
   single-device kernel and to each other; c. ``sharded_visibility`` on
   body 0 and ``sharded_batched_visibility`` on phase 7's 64 bodies from
   its 4 cameras, flag for flag and n.dir equal to ``visibility_compute``,
   ``sharded_batched_vert_normals`` on the main path's 256 bodies bit-equal
   to the batched normals; d. 10 steps of ``make_fit_step(mesh=...)`` at
   bench_256 (PARALLEL_RANKS bodies, dp = PARALLEL_RANKS) and at
   config5_100k (dp 1, sp = PARALLEL_RANKS), from one converted state
   (the unsharded step's two steps in): the first step's loss and betas
   within 1e-5 of the unsharded step's, the loss falling; e. at step 3 a
   checkpoint restored into a fresh template placed on the mesh, whose
   next step equals the live one bit for bit; then in the parent f. one
   100,000-query ``engine.submit("closest_point")`` on body 0, timed
   PARALLEL_REPS times with the lane off and PARALLEL_REPS times with
   MESH_TPU_FLEET_SHARD_MIN_Q=1024 (the sharded lane, each request counted
   once), every answer bit-equal to the lane-off one, and 600 queries that
   do not take it.  Times after the window: a's wall against the
   single-device call, each rank's kernel on its shard, the gather and
   ring merges, a fit step sharded and unsharded, the lane's request on
   and off; the phase within PARALLEL_BUDGET_S.

After phase 19, the four closest-point routes (brute, culled, resident and
streamed rope) are timed at phases 5 and 6's shapes, and
``calibrate_mxu_crossover(save=False)`` times the MXU rung against the
brute-force kernel: the crossover evidence; then each drive's stages (the
large batch's culled prologue in its parts, each anim session's resident
rope kernel alone, held to its plain version at every sub-lane count
as on the scan).

Phases 3-15, 3b, 14b, 17-21 are the driven paths (phases 6 and
13 twice);
phase 16 drives no kernel path of its own and holds its launches itself.  A
CUDA-graph plan's launches count once a replay (its capture counts none;
the warm-up run before it counts as the launches it is).  Kernel
launch counts are set to 0 just before each and read just after it, and
every kernel must have launched on each path of ``KERNEL_PATHS`` and on no
other path.  The last lines are the card's name and power limit (nvidia-smi),
one JSON line describing every kernel with its launches per path, and
``{"ok": true, "device": ...}``.

Imports neither JAX nor mesh_tpu.  Needs one CUDA card.
"""

import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

_REPO = os.path.dirname(os.path.abspath(__file__))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

BATCH = 256
QUERIES_PER_MESH = 1024
FACADE_QUERIES = 4096
REPS = 10

#: phase 5: a finer body template, (n_seg, n_ring) of _uv_sphere, scaled
#: to body proportions (49,154 vertices, 98,304 faces)
LARGE_TEMPLATE = (256, 192)
LARGE_BATCH = 64
LARGE_QUERIES = 4096
#: scan points: a random face, a random barycentric point, N(0, 5 mm)
SCAN_NOISE = 0.005

#: phase 6: bench.py's accel_stream_proxy recipe at 65,536 queries
SCAN_FACES = 210000
SCAN_QUERIES = 65536

#: phase 7: the main path's first bodies seen from four cameras around them
VIS_BATCH = 64
VIS_CAMERAS = ((3.0, 0.0, 0.0), (-3.0, 0.0, 0.0), (0.0, 3.0, 0.0),
               (0.0, -3.0, 0.0))
VIS_MIN_DIST = 1e-3
#: phase 2's planted sets for the culled any-hit kernel: GRAZE_RAYS rays
#: within GRAZE_TILT rad of a flat GRAZE_GRID x GRAZE_GRID grid's plane,
#: and the rest template's rays bounded to t in [0, VIS_T_HI]
GRAZE_RAYS = 65536
GRAZE_TILT = 1e-6
GRAZE_GRID = 16
VIS_T_HI = 1.5
#: n.dir below this: a back-facing vertex, which a closed mesh must block
BACKFACING = -0.2
#: the facade's sensor for camera 0: x and y half-axes (0.05 along y, 0.2
#: along z) on a plane 1 in front of the camera, z axis towards the camera
FACADE_SENSOR = (0.0, 0.05, 0.0, 0.0, 0.0, 0.2, 1.0, 0.0, 0.0)

#: phase 8: scan registration of one posed body
REG_QUERIES = 65536
REG_EPS = 0.1
REG_NORMAL_NOISE = 0.1
#: queries held against the float64 dense blended minimum
REG_CHECK = 1024

#: H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
#: and HBM3 bandwidth
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
#: ``queued_ms``: the spin that the timed calls queue behind, and the SM
#: clock that converts it to cycles (the H100 SXM's boost clock; a lower
#: clock only spins longer)
QUEUE_SPIN_MS = 50.0
SPIN_CLOCK_HZ = 1.98e9
#: ``cold_ms``: bytes written before each timed call, to evict its operands
#: from the H100's 50 MB L2
L2_FLUSH_BYTES = 256 << 20

#: operations per query-face pair of each closest_faces variant, counted in
#: csrc/closest_faces.cu: (tile_variant, degenerate_tail) -> ops
FACE_PAIR_OPS = {("fast", False): 88, ("fast", True): 119,
                 ("safe", False): 147, ("safe", True): 151}
VERTEX_PAIR_OPS = 10

VARIANTS = [("fast", False), ("fast", True), ("safe", False), ("safe", True)]

#: operations per pair of the rope kernels: the fast tile with its tail
ROPE_PAIR_OPS = FACE_PAIR_OPS[("fast", True)]
#: phase 2: a resident rope leaf size that is no multiple of 4, which the
#: kernel stages 4 bytes at a time
RESIDENT_ODD_TILE_F = 30

#: operations per pair counted in csrc/ray_cost.cuh and the kernels over
#: it: any-hit (line_hit, the t_lo test, the exit test), along-normal
#: (line_hit, |tn|, the guard, the division, the miss select, the argmin),
#: normal-weighted (the fast tile + normal dot, sqrt, 1 - dot, times eps)
RAY_PAIR_OPS = 64
#: the culled any-hit kernel's chunk test per lane and chunk
#: (csrc/ray_any_hit_culled.cu chunk_needed): the cone bound and the guard
#: (16), the margin (19), the slab test and its decision (32) and the vote
#: (2); and when the cone fails the guard, the faces' normals (7 a face: 3
#: products, 2 sums, |.|, min; then the pad and the guard: 2)
CULL_TEST_OPS = 69
CULL_FACE_OPS = 7 * 32 + 2
ALONG_PAIR_OPS = 67
#: the along-normal chunk cull (csrc/alongnormal_faces.cu) per lane and
#: chunk: row 8's chunk test and the lane's threshold and need test (2
#: fminf, a compare, an and); on a chunk its line meets with the guard held,
#: item 3's bound (tau's 2 compares, 2 selects, negation and fminf, the
#: division and 5 products, sums and differences, the clamp's compare and
#: select: 16); on a miss, the count and the candidate's fold (4)
ALONG_TEST_OPS = CULL_TEST_OPS + 4
ALONG_BOUND_OPS = 16
ALONG_MISS_OPS = 4
#: the along-normal seed pass per lane and chunk (along_seed_kernel): the
#: distances to the box (12) and to the centre (3), their squares and sums
#: (10), the NaN tests and selects (4), and the insertion into the four
#: nearest (per slot 5 compares, 4 ands and ors, 6 selects: 60); then
#: ray_kernel.SEED_CHUNKS x 32 pairs
ALONG_SEED_SCAN_OPS = 89
#: the splits of a warp's chunks that phase 2 times for alongnormal_faces
ALONG_SPLITS = (1, 2, 4, 8, 16, 32)
#: phase 2's planted sets for alongnormal_faces: the first ALONG_PLANTED of
#: phase 8's queries on body 0, and as many far queries and grid lines
ALONG_PLANTED = 4096
NW_PAIR_OPS = {False: FACE_PAIR_OPS[("fast", False)] + 8,
               True: FACE_PAIR_OPS[("fast", True)] + 8}

#: operations per pair of the triangle-triangle tiles, counted in
#: csrc/tri_tri_cost.cuh; the self-intersection kernel adds 21 of its own
#: (9 vertex-id compares, 8 ors, the self test's add, compare and or, the
#: count's add)
TRI_PAIR_OPS = {"segment": 428, "moller": 232}
#: the splits of a warp's chunks that phase 2 times for tri_tri_any_hit
TRI_SPLITS = (1, 4, 8, 16, 32, 64)
SELF_PAIR_OPS = {k: v + 21 for k, v in TRI_PAIR_OPS.items()}
#: the work of the redesigned self_intersect (csrc/self_intersect.cu) per
#: query lane: the Moller box test of each tile (plane_needs_box: 3 sign
#: tests, 2 x (3 selects, 3 products, 3 sums), 8 for X, 2 for M, 7 for
#: the skip), the 20 of the vertex-id and self tests on each pair of the
#: tiles it takes, the plane sides (Moller, 64) or the whole segment test
#: on each pair past them, and the interval part (Moller, 168) on each pair
#: on neither side of the other's plane; the count's add on each pair that
#: reaches the test that decides it
SELF_BOX_OPS = 38
SELF_ID_OPS = 20
MOLLER_SIDES_OPS = 64
MOLLER_INTERVAL_OPS = TRI_PAIR_OPS["moller"] - MOLLER_SIDES_OPS
#: the culled_faces cull tests (csrc/culled_faces.cu): a lane's chunk bound
#: and its compare (3 differences, 3 products, 2 sums, sqrt, difference,
#: max, 2 products, compare), once per chunk of each tile its block takes;
#: the block's sphere-to-sphere tile test, once per (query tile, face
#: tile)
CHUNK_BOUND_OPS = 14
TILE_TEST_OPS = 15

#: phase 9: examples/hand_body_contact.py's recipe (hand offset from the
#: body axis, m; contact: a hand vertex within 1 cm of the body)
CONTACT_OFFSET = (0.26, 0.0, 0.1)
CONTACT_GAP = 0.01
#: the float64 checks' borderline band: a face whose float64 decision
#: flips when the segment tests' tolerances move by this much may differ
TOL_MOVE = 1e-6
#: phase 10: faces of each posed body held against float64 (half involved)
SELF_CHECK_FACES = 512
#: phase 10: the self-intersecting faces of each posed body per tile, as
#: the every-pair kernel counted them before the tile cull
SELF_EXPECTED = {"smpl_body0": {"moller": 223},
                 "large_body0": {"moller": 610, "segment": 608}}

#: phase 2: culled_faces' variants other than the large batch's own are
#: held to their plain versions on the first bodies only (the plain
#: versions' seconds are most of the script's time)
CULLED_CHECK_BODIES = 32

#: phase 11: avatar sessions, each streaming ANIM_FRAMES posed bodies along
#: a pose trajectory between two N(0, ANIM_POSE_SIGMA) poses, with
#: ANIM_QUERIES surface-proximal queries and a 30 Hz deadline per frame;
#: frame ANIM_STRETCH_FRAME is tests/test_anim.py's 20x stretch, which trips
#: a rebuild; then ANIM_COLD_FRAMES frames under MESH_TPU_ANIM=0
ANIM_FRAMES = 64
ANIM_QUERIES = 4096
ANIM_POSE_SIGMA = 0.2
ANIM_DEADLINE_S = 1.0 / 30.0
ANIM_STRETCH_FRAME = 40
ANIM_STRETCH = 20.0
ANIM_COLD_FRAMES = 5
#: operations per float of the leaf-box kernel: a compare and a select
#: each for the min and the max
LEAF_BOX_OPS = 4

#: phase 12: the MXU rung under MESH_TPU_MXU (and MESH_TPU_MXU_BF16) on
#: posed body 0 with phase 4's queries, and on bench.py's 32,768-face
#: sphere (32,512 faces) with MXU_QUERIES surface-proximal and as many
#: N(0, 0.4) queries; MXU_WARM warm calls after the cold one.  The
#: surface-proximal queries are bench.py mxu_proxy's recipe: one compact
#: patch per query tile of MXU_PATCH queries, 1.005 times a unit direction
#: plus N(0, 0.002), the spatially coherent order of a scan whose tiles
#: the bound pass can prune
MXU_SPHERE_FACES = 32768
MXU_QUERIES = 65536
MXU_WARM = 5
MXU_PATCH = 256
#: operations per pair counted in csrc/mxu_cost.cuh (with and without the
#: degenerate tail) and csrc/mxu_bound.cu
MXU_PAIR_OPS = {False: 93, True: 124}
MXU_BOUND_OPS = 26
#: operations of the bound pass's chunk test per lane and chunk
#: (csrc/mxu_bound_culled.cu: the box distance 17, the two lower bounds 10,
#: the compares and their logic 5)
MXU_BOUND_CULL_OPS = 32
#: the splits of a warp's chunks that phase 2 times beside the default
MXU_SPLITS = (1, 4, 16, 32, 64)

#: phase 3b: the fused reduction's operations per pair, the tile's plus the
#: key's two ands, its or and the tile's shift (csrc/argmin.cuh)
FUSED_PAIR_OPS = {k: v + 4 for k, v in FACE_PAIR_OPS.items()}

#: operations of closest_faces' chunk bound (closest_cull.cuh cull_lb2 and
#: the lane's need test) and of its seed's scan, per lane and chunk
CULL_BOUND_OPS = 41
SEED_OPS = 11
#: operations of the MXU chunk cull's bound (csrc/mxu_cull.cuh cull_lb2 and
#: the lane's need test): row 1's, the reach's two adds and the screen's and
MXU_CULL_BOUND_OPS = 44

#: operations of normal_weighted_faces' chunk bound per lane and chunk: row
#: 1's and NormalWeightedCost::lower's (the -inf test and its select, the
#: max, the square root, the add; csrc/nw_cost.cuh)
NW_CULL_BOUND_OPS = CULL_BOUND_OPS + 5
#: the splits of a warp's chunks that phase 2 times for normal_weighted_faces
NW_SPLITS = (1, 4, 16, 32, 64)
#: phase 2's planted sets for normal_weighted_faces: the first NW_PLANTED of
#: phase 8's queries on body 0
NW_PLANTED = 4096

#: operations of cull_records per face (the planes' finiteness, the corners,
#: the box's minima and maxima, the conditioning numbers and their maxima)
RECORD_OPS = 120



#: phase 13: the MXU rope walks through the Mesh facade on phase 6's scan
#: under MESH_TPU_MXU, with the MXU crossover pinned at MXU_BVH_CROSSOVER
#: faces (the card's saved calibration puts it past the scan's mesh), a
#: cold call and MXU_BVH_WARM warm calls per mode
MXU_BVH_CROSSOVER = 8192
MXU_BVH_WARM = 5
#: operations per pair of the MXU walk's full visit (the MXU tile with its
#: tail) and of its bf16 screen, counted in csrc/rope_mxu_faces.cu
ROPE_MXU_PAIR_OPS = MXU_PAIR_OPS[True]
SCREEN_PAIR_OPS = 25
#: phase 2: MIXED_QUERIES queries on phase 6's sphere, half surface-proximal
#: and half at radius MIXED_RADIUS, where the bf16 screen skips leaf visits
MIXED_QUERIES = 8192
MIXED_RADIUS = 1.6

#: phase 14: the scan-fit step at bench.py's fit_step_latency shape (1 body
#: x 256 N(0, 0.3) points) and BASELINE.json config 5's (1 body x 100,000
#: surface samples of posed body 0 with N(0, SCAN_NOISE) noise)
FIT_SHAPES = {"bench_256": ("randn", 256),
              "config5_100k": ("surface", 100000)}
FIT_MAIN = "config5_100k"
FIT_REPS = 10
#: phase 14's times: FIT_ROUNDS rounds of FIT_REPS calls of each timed call,
#: interleaved after a shared warm-up of FIT_WARMUP calls of each
FIT_ROUNDS = 7
FIT_WARMUP = 3
FIT_STEPS = 10
#: phase 14: the jvp's queries, the first of FIT_MAIN's scan
JVP_QUERIES = 4096
#: phase 14: free-vertex ICP from the rest template to posed body 0
REGISTER_SCAN = 4096
REGISTER_STEPS = 30
REGISTER_EVERY = 5

# phase 15 (engine): Mesh on body 0 at these query counts (three in the
# 2048 bucket, then one past it), SMPL-shaped bodies (index, Q) after
# warmup(), the executor's requests and their query counts, the normals'
# repeat runs and the timing rounds
ENGINE_FACADE_QS = (1100, 1500, 2048, 2049)
ENGINE_WARM_BODIES = ((1, 1000), (2, 700), (3, 300))
ENGINE_REQUESTS = 16
ENGINE_REQUEST_QS = (700, 1024)
ENGINE_NORMAL_RUNS = 5
ENGINE_ROUNDS = 5

# phase 16: the fallback routes
FALLBACK_WARM = 5
FALLBACK_BATCH = 16
FALLBACK_VIS_BATCH = 4
WALK_WARM = 2
WALK_CHECK = 4096

# phase 17: the psbody-style domain workflow
DOMAIN_LANDMARKS = 20
DOMAIN_LANDMARK_SIGMA = 0.01
DOMAIN_CHECK_FACES = 4096
#: float64 distance within which two donor faces or vertices tie (1 um on
#: a body of about 1.8 m: float32 rounding of the kernels' centered frame)
DOMAIN_TIE = 1e-6
DOMAIN_COEFF_TOL = 1e-5
DOMAIN_NORMAL_TOL = 1e-6
DOMAIN_BUDGET_S = 60.0
#: the files of step a: (extension, writer keywords)
DOMAIN_FORMATS = {"ply_binary": ("ply", {}),
                  "ply_ascii": ("ply", {"ascii": True}),
                  "obj": ("obj", {}), "json": ("json", {})}
DOMAIN_CAMERA = (0.0, 0.0, 3.0)

# phase 18: the serving tier (bench.py serve_load's shape: N(0, 0.4)
# queries, a closed loop of 4 clients x 24 requests at a 0.5 s deadline,
# three rounds; an open loop at 40 qps for 1 s), the avatar shape of
# run_periodic (6 sessions at 30 Hz, a 1/30 s frame deadline, 1 s), a
# replay of synth_mix(seed=7) at speed 1 and a wedge of the top rung
SERVE_QUERIES = 1024
SERVE_WORKERS = 2
SERVE_DEADLINE_S = 0.5
SERVE_CLIENTS = 4
SERVE_REQUESTS_PER_CLIENT = 24
SERVE_ROUNDS = 3
SERVE_OPEN_QPS = 40.0
SERVE_OPEN_S = 1.0
SERVE_SESSIONS = 6
SERVE_HZ = 30.0
SERVE_PERIODIC_S = 1.0
SERVE_TRACE_SEED = 7
#: the wedge: the watchdog's threshold, the request's deadline and the
#: successes that bring health back
SERVE_WEDGE_S = 0.2
SERVE_WEDGE_DEADLINE_S = 0.5
SERVE_RECOVER_AFTER = 3
#: one-rung ladders answer within this deadline (no fall-through exists)
SERVE_RUNG_DEADLINE_S = 5.0
#: the anchored rung's second request: random vertices of the body with
#: this much N(0, s) noise (K 16 tables certify most of them)
SERVE_NEAR_NOISE = 0.001
SERVE_BUDGET_S = 60.0
#: the closed loop's ledger rows, dumped for phase 20's prof (removed there)
SERVE_CLOSED_LEDGER = os.path.join(_REPO, "build", "chip_smoke_prof",
                                   "serve_closed.jsonl")
#: phase 14's diff repairs: bodies under torch.func.vmap
DIFF_VMAP_BODIES = 4
#: phase 19: bench.py's store cold-start queries (64 jittered unit-sphere
#: points, bench.py:1475-1478), each arm's best of this many runs, and the
#: child's time limit
STORE_COLD_QUERIES = 64
STORE_COLD_REPS = 2
STORE_CHILD_TIMEOUT_S = 300
#: phase 19c: store-keyed requests (each with an inline twin), and calls
#: timing one request's upload of a paged mesh
STORE_REQUESTS = 8
STORE_UPLOADS = 20
#: phase 19d: delta frames of the SMPL-sized body, queries a frame
STORE_FRAMES = 16
STORE_BUDGET_S = 120.0

#: kernel -> the driven paths that must launch it (and no other path may);
#: the first path's count is the kernel's ``launches`` in the kernels line
#: (a kernel with no path has its row in its successor's)
KERNEL_PATHS = {"closest_faces": ("main_path", "facade", "contact", "fit",
                                  "engine", "domain", "serve", "store",
                                  "fleet", "parallel"),
                "closest_faces_fused": ("main_path_fused",),
                # the every-face kernel, phase 2's face oracle
                "closest_faces_every": (),
                "cull_records": ("main_path", "main_path_fused", "facade",
                                 "contact", "mxu", "registration", "fit",
                                 "engine", "domain", "serve", "store",
                                 "fleet", "parallel"),
                "nearest_vertices": ("facade", "domain"),
                # the every-vertex kernel, phase 2's index oracle
                "nearest_vertices_every": (),
                # on the domain path only where a donor mesh crosses the
                # brute/culled crossover (step d's, at the default); on the
                # serve path the engine rung's, on the 98,304-face template
                "culled_faces": ("large_batch", "fit", "engine", "domain",
                                 "serve"),
                # on the store path the scan's warm call before the
                # cold-start child (whose own launches are its process's)
                "rope_faces_stream": ("scan", "fit", "store"),
                # on the serve path the accel rung's, on the SMPL-sized body;
                # on the store path the store-keyed session's frames
                "rope_faces_resident": ("scan_resident", "anim", "serve",
                                        "store"),
                "rope_mxu_stream": ("mxu_bvh",),
                "rope_mxu_resident": ("mxu_bvh_resident",),
                "ray_any_hit_culled": ("visibility", "engine", "domain",
                                       "parallel"),
                # the every-face kernel, phase 2's flag oracle
                "ray_any_hit": (),
                "alongnormal_faces": ("registration",),
                # the every-face kernel, phase 2's face oracle
                "alongnormal_faces_every": (),
                "normal_weighted_faces": ("registration", "fit"),
                # the every-face kernel, phase 2's face oracle
                "normal_weighted_faces_every": (),
                "tri_tri_any_hit": ("contact",),
                "tri_records": ("contact",),
                # the every-pair kernel, phase 2's flag oracle
                "tri_tri_any_hit_every": (),
                "self_intersect": ("self_intersect",),
                "leaf_boxes": ("anim", "store"),
                # the warp-a-leaf kernel, phase 2's box oracle
                "leaf_boxes_warp": (),
                "mxu_faces": ("mxu",),
                "mxu_bound_culled": ("mxu",),
                "mxu_repair": ("mxu",),
                # the every-face kernels, phase 2's MXU oracles
                "mxu_faces_every": (),
                "mxu_bound": (),
                "mxu_repair_every": ()}


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError("check failed: " + what)


def nvidia_smi(query="name,power.limit"):
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=" + query, "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


#: the card's state beside a run's times: a card that slows under load
#: shows its SM clock below the maximum here
CARD_STATE = "clocks.sm,clocks.max.sm,temperature.gpu,power.draw"


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps, warmup=1):
    """Mean device milliseconds of ``fn`` over ``reps`` calls, for work
    shorter than its host launch path (where ``cuda_ms`` would time the
    host's launch rate): the calls are queued behind a spinning kernel of
    QUEUE_SPIN_MS, so the events time the card's back-to-back runs.  Fails
    if the host took longer to queue them than the spin lasted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin.record()
    torch.cuda._sleep(int(QUEUE_SPIN_MS * 1e-3 * SPIN_CLOCK_HZ))
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    spin_ms = spin.elapsed_time(start)
    check(host_ms < spin_ms, "queued_ms: the host queued %d calls in %.2f ms, "
          "longer than the %.2f ms spin" % (reps, host_ms, spin_ms))
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps, warmup=1):
    """Median device milliseconds of one call of ``fn`` with its operands
    out of L2, for work that an HBM bound describes: before each call a
    buffer of L2_FLUSH_BYTES is written, and events around the call alone
    time it.  The calls queue behind a spin, as in ``queued_ms``, so the
    events time the card's runs and not the host's launch path."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    spin = torch.cuda.Event(enable_timing=True)
    spin_end = torch.cuda.Event(enable_timing=True)
    spin.record()
    torch.cuda._sleep(int(QUEUE_SPIN_MS * 1e-3 * SPIN_CLOCK_HZ))
    spin_end.record()
    t0 = time.perf_counter()
    for start, end in events:
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = spin.elapsed_time(spin_end)
    check(host_ms < spin_ms, "cold_ms: the host queued %d calls in %.2f ms, "
          "longer than the %.2f ms spin" % (reps, host_ms, spin_ms))
    return statistics.median(start.elapsed_time(end)
                             for start, end in events)


def bound_ms(pairs, ops_per_pair, n_bytes):
    """(least milliseconds, "operations" or "bytes") for work of ``pairs``
    pairs at ``ops_per_pair`` moving ``n_bytes`` once."""
    ops = pairs * ops_per_pair / PEAK_FP32_OPS * 1e3
    mem = n_bytes / PEAK_BYTES * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def planted_degenerate(v, f, rng, n=64):
    """``v``/``f`` plus n zero-area faces (two equal corners) and n
    collinear faces (a new vertex at an edge's midpoint), and queries near
    them: (v2, f2, queries)."""
    picks = rng.choice(f.shape[0], n, replace=False)
    i, j = f[picks, 0], f[picks, 1]
    mids = (v[i].astype(np.float64) + v[j]) / 2.0
    new = v.shape[0] + np.arange(n)
    v2 = np.vstack([v, mids]).astype(np.float32)
    f2 = np.vstack([f, np.stack([i, i, j], 1), np.stack([i, j, new], 1)])
    near = mids + rng.randn(n, 3) * 0.01
    far = rng.randn(FACADE_QUERIES - n, 3) * 0.4
    return v2, f2.astype(np.int32), np.vstack([near, far]).astype(np.float32)


def compare_faces(ck, pts, planes, tri, center, variant, tail, timing,
                  reduction="exact"):
    """Kernel vs plain for closest_faces on one operand set (the fused
    reduction at the reference's tile_f with ``reduction="fused"``): the
    chunk-cull kernel's faces identical to the plain version of its design
    (``argmin_faces_culled_plain``, also its warp, lane and stage counts),
    to the every-face plain version and to the every-face kernel
    (``closest_faces_every``), and the max abs point/sqdist difference
    after the epilogue (NaN where both are NaN counts as equal).

    With ``timing``: the kernel alone on operands made beforehand, the
    every-face kernel, the cull prologue (``cull_operands``) and the plain
    versions; three bounds: the work these inputs need per lane (the faces
    of the chunks its own lane needs, a bound per chunk and the seed), the
    pairs the warps issue (32 lanes x the faces of each chunk a warp
    folds) and every pair (the every-face design's), each x the tile's
    operations per pair."""
    kw = {"reduction": reduction, "tile_f": ck.FUSED_TILE_F}
    name = "closest_faces" + ("_fused" if reduction == "fused" else "")
    cull = ck.cull_operands(pts, planes, variant, tail)
    records_plain = ck.cull_records_plain(planes, variant, tail)
    same = (cull["records"] == records_plain) | (
        torch.isnan(cull["records"]) & torch.isnan(records_plain))
    check(bool(same.all()), "cull_records[%s, tail=%s]: %d of %d values "
          "differ from the plain version" % (
              variant, tail, int((~same).sum()), same.numel()))
    k, kw_, kl, kb = ck.argmin_faces(pts, planes, variant, tail, cull=cull,
                                     with_stats=True, **kw)
    (p, pw, pl, pb), plain_ms = timed(lambda: ck.argmin_faces_culled_plain(
        pts, planes, cull, variant, tail, **kw))
    every, every_plain_ms = timed(lambda: ck.argmin_faces_plain(
        pts, planes, variant, tail, **kw))
    oracle = ck.argmin_faces_every(pts, planes, variant, tail, **kw)
    mism = int((k != p).sum())
    check(mism == 0 and torch.equal(kw_, pw) and torch.equal(kl, pl)
          and torch.equal(kb, pb),
          "%s[%s, tail=%s]: %d of %d faces (and %d warp, %d lane, %d stage "
          "counts) differ from the plain version" % (
              name, variant, tail, mism, k.numel(), int((kw_ != pw).sum()),
              int((kl != pl).sum()), int((kb != pb).sum())))
    check(torch.equal(k, every) and torch.equal(k, oracle),
          "%s[%s, tail=%s]: %d faces differ from the every-face plain "
          "version, %d from the every-face kernel" % (
              name, variant, tail, int((k != every).sum()),
              int((k != oracle).sum())))
    rk = ck.winner_epilogue(k, tri, pts, center)
    rp = ck.winner_epilogue(p, tri, pts, center)
    err = max(float((rk["point"] - rp["point"]).abs().nan_to_num().max()),
              float((rk["sqdist"] - rp["sqdist"]).abs().nan_to_num().max()))
    n_b, n_q = pts.shape[:2]
    n_f = planes.shape[-1]
    n_c = -(-n_f // ck.CULL_CHUNK)
    out = {"variant": variant, "degenerate_tail": tail,
           "shape": [n_b, n_q, n_f], "faces_identical": True,
           "every_face_identical": True, "max_abs_err": err,
           "warp_chunks": int(kw_.sum()), "warp_chunks_all": kw_.numel() * n_c,
           "warp_chunk_max": int(kw_.max()), "warp_stages": int(kb.sum()),
           "warp_stage_max": int(kb.max()), "lane_faces": int(kl.sum()),
           "pairs": n_b * n_q * n_f, "plain_ms": plain_ms,
           "every_plain_ms": every_plain_ms}
    out["warp_share"] = out["warp_chunks"] / out["warp_chunks_all"]
    out["heaviest_warp_share"] = out["warp_chunk_max"] / n_c
    out["stage_share"] = out["warp_stages"] / out["warp_chunks_all"]
    out["lane_share"] = out["lane_faces"] / out["pairs"]
    if timing:
        out["ms"] = cuda_ms(lambda: ck.argmin_faces(
            pts, planes, variant, tail, cull=cull, **kw), reps=REPS)
        out["every_ms"] = cuda_ms(lambda: ck.argmin_faces_every(
            pts, planes, variant, tail, **kw), reps=REPS)
        out["prologue_ms"] = cuda_ms(lambda: ck.cull_operands(
            pts, planes, variant, tail), reps=REPS)
        out["records_ms"] = cuda_ms(lambda: ck.cull_records(
            planes, variant, tail), reps=REPS)
        out["records_plain_ms"] = cuda_ms(lambda: ck.cull_records_plain(
            planes, variant, tail), reps=3)
        out["records_bound_ms"], out["records_bound_by"] = bound_ms(
            n_b * n_f, RECORD_OPS,
            4 * (planes.numel() + cull["records"].numel()))
        n_bytes = 4 * (pts.numel() + planes.numel() + n_b * n_q
                       + cull["qorder"].numel() + cull["records"].numel())
        ops = (FUSED_PAIR_OPS if reduction == "fused"
               else FACE_PAIR_OPS)[(variant, tail)]
        lanes = n_b * n_q
        around = lanes * (n_c * (CULL_BOUND_OPS + SEED_OPS) + ops)
        out["bound_ms"], out["bound_by"] = bound_ms(
            out["lane_faces"] * ops + around, 1, n_bytes)
        out["bound_issued_ms"], _ = bound_ms(
            out["warp_chunks"] * 32 * ck.CULL_CHUNK * ops + around, 1,
            n_bytes)
        out["bound_every_pair_ms"], _ = bound_ms(out["pairs"], ops, n_bytes)
        # no launch ends before its heaviest block has run on one SM
        n_sms = torch.cuda.get_device_properties(0).multi_processor_count
        per_block = kw_.new_zeros((n_b, -(-kw_.shape[1] // 4) * 4))
        per_block[:, :kw_.shape[1]] = kw_
        heavy = int(per_block.view(n_b, -1, 4).sum(-1).max())
        out["bound_heaviest_block_ms"] = (heavy * 32 * ck.CULL_CHUNK * ops
                                          / (PEAK_FP32_OPS / n_sms) * 1e3)
    log("  %s[%s, tail=%s] %s: records identical to cull_records_plain's; "
        "faces identical to the plain version (and "
        "its counts), the every-face plain version and kernel; warps fold "
        "%.4f of the chunks (heaviest warp %.4f) and stage %.4f, lanes "
        "need %.4f of the pairs; max abs point/sqdist diff %.3g%s" % (
            name, variant, tail, out["shape"], out["warp_share"],
            out["heaviest_warp_share"], out["stage_share"],
            out["lane_share"], err, "" if not timing else
            "; %.3f ms (every face %.3f, prologue %.3f of it records "
            "%.4f, plain %.2f, bound %.4f; plain %.1f ms, "
            "every-face plain %.1f; bound %.3f ms, issued %.3f, every pair "
            "%.3f, heaviest block on one SM %.3f)" % (
                out["ms"], out["every_ms"], out["prologue_ms"],
                out["records_ms"], out["records_plain_ms"],
                out["records_bound_ms"],
                out["plain_ms"], out["every_plain_ms"], out["bound_ms"],
                out["bound_issued_ms"], out["bound_every_pair_ms"],
                out["bound_heaviest_block_ms"])))
    return out


def far_queries(v, n_q, rng):
    """[1, n_q, 3] queries in random directions from body ``v``'s vertex
    mean, at 10 to 100 times its radius (the largest vertex distance from
    the mean)."""
    mean = v.mean(dim=0)
    radius = float((v - mean).norm(dim=-1).max())
    d = rng.randn(n_q, 3)
    d *= rng.uniform(10.0, 100.0, (n_q, 1)) * radius / np.linalg.norm(
        d, axis=1, keepdims=True)
    return (torch.as_tensor(d, dtype=torch.float32, device=v.device)
            + mean)[None].contiguous()


def cull_row(run, launches):
    """The chunk cull's figures of a timed ``compare_faces`` run for the
    kernels line, with the every-face oracle's time and launches (0 on
    every path) beside them."""
    row = {key: run[key] for key in (
        "bound_issued_ms", "bound_every_pair_ms", "bound_heaviest_block_ms",
        "warp_share", "heaviest_warp_share", "stage_share", "lane_share",
        "prologue_ms", "every_plain_ms")}
    row["every"] = {
        "name": "closest_faces_every", "route": "cuda",
        "source": "mesh_tpu_torch/csrc/closest_faces_every.cu",
        "ms": run["every_ms"],
        "launches_by_path": {p: launches[p]["closest_faces_every"]
                             for p in launches}}
    return row


def compare_vertices(ck, pts, vplanes, label, timing=False, splits=()):
    """nearest_vertices on one operand against its plain version and the
    every-vertex oracle (``nearest_vertices_every``): indices identical, at
    the plan ``vertex_plan`` picks and at each of ``splits`` with each of
    ``VERTEX_PER_THREAD`` queries a thread.  Timed when ``timing``: the
    kernel and the oracle back to back (``ms``, ``every_ms``: CUDA events
    around ``REPS`` calls, the clock of every row's ``ms``) and as device
    time (``device_ms``, ``every_device_ms``, ``split_device_ms``:
    ``queued_ms``, since a 1 x 4096 call is shorter than its host launch
    path), the plain version and the library call (cdist + argmin)."""
    n_b, n_q, n_v = pts.shape[0], pts.shape[1], vplanes.shape[-1]
    per, split = ck.vertex_plan(n_b, n_q, n_v, ck._sm_count(pts.device))
    k = ck.argmin_vertices(pts, vplanes)
    p = ck.argmin_vertices_plain(pts, vplanes)
    e = ck.argmin_vertices_every(pts, vplanes)
    for name, other in (("plain version", p), ("every-vertex oracle", e)):
        mism = int((k != other).sum())
        check(mism == 0, "nearest_vertices on %s: %d of %d indices differ "
              "from the %s" % (label, mism, k.numel(), name))
    for s in splits:
        for q in ck.VERTEX_PER_THREAD:
            mism = int((ck.argmin_vertices(pts, vplanes, _plan=(q, s))
                        != p).sum())
            check(mism == 0, "nearest_vertices on %s at split %d, %d "
                  "queries a thread: %d indices differ from the plain "
                  "version" % (label, s, q, mism))
    vt = vplanes.transpose(-1, -2)
    rows = torch.arange(n_b, device=pts.device)[:, None]

    def dist(idx):
        d = pts - vt[rows, idx.long()]
        return (d * d).sum(dim=-1).sqrt()

    fin = torch.isfinite(dist(p))
    out = {"on": label, "shape": [n_b, n_q, n_v], "per_thread": per,
           "split": split, "splits_checked": list(splits),
           "indices_identical": True,
           "max_abs_err": float((dist(k) - dist(p))[fin].abs().max())
           if bool(fin.any()) else 0.0}
    if timing:
        out["ms"] = cuda_ms(lambda: ck.argmin_vertices(pts, vplanes),
                            reps=REPS)
        out["device_ms"] = queued_ms(
            lambda: ck.argmin_vertices(pts, vplanes), 50)
        out["split_device_ms"] = {s: queued_ms(
            lambda s=s: ck.argmin_vertices(pts, vplanes, _plan=(per, s)),
            50) for s in splits}
        out["every_ms"] = cuda_ms(
            lambda: ck.argmin_vertices_every(pts, vplanes), reps=REPS)
        out["every_device_ms"] = queued_ms(
            lambda: ck.argmin_vertices_every(pts, vplanes), 50)
        out["plain_ms"] = cuda_ms(
            lambda: ck.argmin_vertices_plain(pts, vplanes), reps=3)
        out["library_ms"] = cuda_ms(
            lambda: torch.cdist(pts, vt).argmin(dim=-1), reps=3)
        lib = torch.cdist(pts, vt).argmin(dim=-1)
        out["library_agree"] = float((lib == k.long()).float().mean())
        pairs = n_b * n_q * n_v
        n_bytes = 4 * (pts.numel() + vplanes.numel() + n_b * n_q)
        out["bound_ms"], out["bound_by"] = bound_ms(pairs, VERTEX_PAIR_OPS,
                                                    n_bytes)
    log("  nearest_vertices on %s %s (%d queries a thread, split %d): "
        "indices identical to the plain version and the oracle%s%s" % (
            label, out["shape"], per, split,
            " and at splits %s" % list(splits) if splits else "",
            "" if not timing else
            "; %.4f ms back to back, %.4f device (oracle %.4f, %.4f; "
            "splits, device: %s; plain %.2f ms, cdist+argmin %.2f ms, "
            "bound %.4f ms)"
            % (out["ms"], out["device_ms"], out["every_ms"],
               out["every_device_ms"], ", ".join(
                   "%d: %.4f" % kv for kv in out["split_device_ms"].items()),
               out["plain_ms"], out["library_ms"], out["bound_ms"])))
    return out


def vertex_planted(ck, verts0):
    """nearest_vertices at the facade's shape (body ``verts0``'s vertices,
    centered, and FACADE_QUERIES queries) with planted sets, one mesh for
    each split of 2 to ``ck.VERTEX_MAX_SPLIT``: at each boundary b of the
    split's ranges vertex b a copy of vertex b - 1 with a query on it, and
    vertices b - 2 and b + 1 at m -+ (2^-10, 0, 0) for a dyadic m off the
    body with a query at m (equidistant, exactly); then a NaN query and
    queries whose costs overflow to +inf.  Each mesh at its own split and
    at the one the plan picks, against the plain version and the oracle
    (``compare_vertices``); the NaN and far queries must get index 0."""
    vc = (verts0 - verts0.mean(dim=0)).contiguous()
    n_v = vc.shape[0]
    rng = np.random.RandomState(12)
    runs = []
    for split in range(2, ck.VERTEX_MAX_SPLIT + 1):
        v = vc.clone()
        q = torch.as_tensor(rng.randn(FACADE_QUERIES, 3) * 0.4,
                            dtype=torch.float32, device=vc.device)
        planted = []
        for s, (b, _) in enumerate(ck.vertex_split_bounds(n_v, split)):
            if not 2 <= b <= n_v - 2:
                continue
            v[b] = v[b - 1]
            mid = torch.tensor([2.0 + 0.25 * s, 2.0, -2.0],
                               device=vc.device)
            step = torch.tensor([2.0 ** -10, 0.0, 0.0], device=vc.device)
            v[b - 2], v[b + 1] = mid + step, mid - step
            planted += [v[b - 1], mid]
        far = torch.tensor([[float("nan"), 0.0, 0.0], [1e20, 0.0, 0.0],
                            [0.0, -3e19, 1e20]], device=vc.device)
        q[:len(planted)] = torch.stack(planted)
        q[len(planted):len(planted) + 3] = far
        pts = q[None].contiguous()
        vplanes = v.t()[None].contiguous()
        run = compare_vertices(ck, pts, vplanes, "planted, split %d"
                               % split, splits=(split,))
        got = ck.argmin_vertices(pts, vplanes, _plan=(
            run["per_thread"], split))[0]
        check(got[len(planted):len(planted) + 3].tolist() == [0, 0, 0],
              "nearest_vertices, planted at split %d: the NaN and far "
              "queries got %s, not 0" % (
                  split, got[len(planted):len(planted) + 3].tolist()))
        run["planted_queries"] = len(planted) + 3
        runs.append(run)
    return runs


def check_facade_against_scan(v, f, q, faces, points):
    """The facade's faces [1, Q] and points [Q, 3] for body ``v`` against
    the plain reconstruction-form scan on the same tensors: squared
    distances within 1e-5, and faces equal except at ties, where the scan's
    own distances to the two faces are within 1e-6."""
    from mesh_tpu_torch.query.closest_point import closest_faces_and_points_t
    from mesh_tpu_torch.query.point_triangle import closest_point_on_triangle

    oracle = closest_faces_and_points_t(v, f, q)
    sq = ((q.double().cpu().numpy() - points) ** 2).sum(-1)
    gap = float(np.abs(sq - oracle["sqdist"].cpu().numpy()).max())
    check(gap <= 1e-5, "facade sqdist %.3g from the reconstruction-form "
          "scan" % gap)
    mine = torch.as_tensor(faces[0].astype(np.int64), device=v.device)
    theirs = oracle["face"].long()
    differ = mine != theirs
    n_diff, tie = int(differ.sum()), 0.0
    if n_diff:
        center = v.mean(dim=0)
        tri = (v - center)[f.long()]
        qc = (q - center)[differ]

        def sqd(idx):
            t = tri[idx]
            return closest_point_on_triangle(qc, t[:, 0], t[:, 1], t[:, 2])[1]

        tie = float((sqd(mine[differ]) - sqd(theirs[differ])).abs().max())
        check(tie <= 1e-6, "facade: %d faces differ from the scan's and are "
              "%.3g apart, not a tie" % (n_diff, tie))
    log("  facade vs reconstruction-form scan: sqdist within %.3g, %d faces "
        "differ, all at ties (max gap %.3g)" % (gap, n_diff, tie))


class _Camera(object):
    """A camera as the facade reads one: an origin and a sensor's axes."""

    def __init__(self, origin, sensor_axis):
        self.origin = np.asarray(origin)
        self.sensor_axis = np.asarray(sensor_axis)


def kernel_counters():
    """The launch-count dicts of every kernel wrapper."""
    from mesh_tpu_torch.accel import refit_kernel as fk
    from mesh_tpu_torch.accel import rope_kernel as rk
    from mesh_tpu_torch.query import closest_kernel as ck
    from mesh_tpu_torch.query import culled_kernel as qk
    from mesh_tpu_torch.query import mxu_kernel as mk
    from mesh_tpu_torch.query import normal_weighted as nw
    from mesh_tpu_torch.query import ray_kernel as ray
    from mesh_tpu_torch.query import tri_tri_kernel as tk

    return (ck.LAUNCHES, qk.LAUNCHES, rk.LAUNCHES, ray.LAUNCHES, nw.LAUNCHES,
            tk.LAUNCHES, tk.TILE_LAUNCHES, fk.LAUNCHES, mk.LAUNCHES)


def reset_launches():
    for counts in kernel_counters():
        for key in counts:
            counts[key] = 0


def read_launches():
    out = {}
    for counts in kernel_counters():
        out.update(counts)
    return out


def timed(fn):
    """(fn(), milliseconds of this one call by CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def surface_queries(verts, faces, n_q, rng):
    """Scan-like points on a batch ``verts`` [B, V, 3]: per body, n_q
    random faces, random barycentric points and N(0, SCAN_NOISE) noise ->
    (points [B, Q, 3], picked faces [B, Q])."""
    n_b = verts.shape[0]
    dev = verts.device
    pick = torch.as_tensor(rng.randint(0, faces.shape[0], (n_b, n_q)),
                           device=dev)
    w = torch.as_tensor(rng.dirichlet([1.0, 1.0, 1.0], (n_b, n_q)),
                        dtype=torch.float32, device=dev)
    noise = torch.as_tensor(rng.randn(n_b, n_q, 3) * SCAN_NOISE,
                            dtype=torch.float32, device=dev)
    rows = torch.arange(n_b, device=dev)[:, None, None]
    tri = verts[rows, faces.long()[pick]]                 # [B, Q, 3, 3]
    points = torch.einsum("bqk,bqkx->bqx", w, tri) + noise
    return points.contiguous(), pick


def check_against_brute(name, v, f, q, faces, sqdist, brute, quiet=False,
                        against="the brute kernel"):
    """A drive's faces and sqdist [B, Q] against the brute-force kernel's
    result on the same inputs (v [B, V, 3], q [B, Q, 3]), or another
    route's (``against`` names it): sqdist within 1e-5, faces equal except
    at ties, where the two faces' distances in the brute kernel's frame
    are within 1e-6.  ``quiet`` skips the log line."""
    from mesh_tpu_torch.query.point_triangle import closest_point_on_triangle

    gap = float((sqdist - brute["sqdist"]).abs().max())
    check(gap <= 1e-5, "%s: sqdist %.3g from %s" % (name, gap, against))
    differ = faces.long() != brute["face"].long()
    n_diff, tie = int(differ.sum()), 0.0
    if n_diff:
        center = v.mean(dim=-2, keepdim=True)
        b, qi = differ.nonzero(as_tuple=True)
        vc = v - center
        qc = (q - center)[b, qi]

        def sqd(face):
            t = vc[b[:, None], f.long()[face.long()]]
            return closest_point_on_triangle(qc, t[:, 0], t[:, 1], t[:, 2])[1]

        tie = float((sqd(faces[b, qi]) - sqd(brute["face"][b, qi])).abs().max())
        check(tie <= 1e-6, "%s: %d faces differ from %s and are %.3g apart, "
              "not a tie" % (name, n_diff, against, tie))
    if not quiet:
        log("  %s vs %s: sqdist within %.3g, %d of %d faces differ, all at "
            "ties (max gap %.3g)" % (
                name, against, gap, n_diff, faces.numel(), tie))
    return {"sqdist_gap": gap, "faces_differ": n_diff, "tie_gap": tie}


def compare_culled(qk, ops, variant, tail, timing):
    """Kernel vs plain for culled_faces on one operand set: identical
    faces, tested tiles, tested chunks and faces folded per query over
    every query tile, and the faces and tiles of the reference's design
    (every face of each tested tile, ``argmin_culled_tile_plain``).

    The bound counts the work these inputs need under the chunk cull:
    each real query's chunk bounds (every chunk of each tile its block
    takes) and the real faces its own lane folded in, and the block tile
    tests; padded query rows and faces are left out.  What the warps issue
    (every lane of a warp runs a chunk one lane needs) is reported beside
    it, and so is the reference's design (every pair of each tested
    tile)."""
    k, kv, kc, kp = qk.argmin_culled(ops, variant, tail, with_stats=True)
    (p, pv, pc, pp), plain_ms = timed(
        lambda: qk.argmin_culled_plain(ops, variant, tail))
    check(torch.equal(k, p) and torch.equal(kv, pv) and torch.equal(kc, pc)
          and torch.equal(kp, pp),
          "culled_faces[%s, tail=%s]: %d of %d faces (and %d tile, %d chunk, "
          "%d folded-face counts) differ from the plain version" % (
              variant, tail, int((k != p).sum()), k.numel(),
              int((kv != pv).sum()), int((kc != pc).sum()),
              int((kp != pp).sum())))
    (t, tv), tile_plain_ms = timed(
        lambda: qk.argmin_culled_tile_plain(ops, variant, tail))
    check(torch.equal(k, t) and torch.equal(kv, tv),
          "culled_faces[%s, tail=%s]: %d of %d faces (and %d tile counts) "
          "differ from every face of each tested tile" % (
              variant, tail, int((k != t).sum()), k.numel(),
              int((kv != tv).sum())))
    rk_, rp = qk.culled_epilogue(ops, k), qk.culled_epilogue(ops, p)
    err = max(float((rk_["point"] - rp["point"]).abs().max()),
              float((rk_["sqdist"] - rp["sqdist"]).abs().max()))
    tile_q, tile_f = ops["tile_q"], ops["tile_f"]
    chunk = qk.chunk_faces(tile_f)
    n_ft = ops["fsph"].shape[1]
    tested, chunks = int(kv.sum()), int(kc.sum())
    n_b, q_pad = ops["seed"].shape
    n_q, n_f = ops["qorder"].shape[1], ops["n_faces"]
    f_pad = ops["planes"].shape[-1]
    # per real query: the visits of its query tile, and its folded faces
    real_visits = kv.repeat_interleave(tile_q, dim=1)[:, :n_q]
    folded = int(kp[:, :n_q].sum())
    lane_bounds = int(real_visits.sum()) * (tile_f // chunk)
    out = {"variant": variant, "degenerate_tail": tail,
           "shape": [n_b, q_pad, f_pad], "real": [n_b, n_q, n_f],
           "faces_identical": True, "max_abs_err": err,
           "face_tiles_tested": tested, "face_tiles": kv.numel() * n_ft,
           "warp_chunks_tested": chunks,
           "warp_chunks_of_tested_tiles": tested * (tile_f // chunk)
           * kc.shape[-1],
           "pairs_folded": folded, "lane_chunk_bounds": lane_bounds,
           "pairs_issued": chunks * qk.WARP * chunk,
           "pairs": n_b * n_q * n_f,
           "plain_ms": plain_ms, "tile_plain_ms": tile_plain_ms}
    out["tile_fraction"] = tested / out["face_tiles"]
    out["chunk_fraction"] = chunks / max(1, out["warp_chunks_of_tested_tiles"])
    out["pair_fraction"] = folded / out["pairs"]
    out["issued_fraction"] = out["pairs_issued"] / (n_b * q_pad * f_pad)
    if timing:
        out["ms"] = cuda_ms(lambda: qk.argmin_culled(ops, variant, tail),
                            reps=REPS)
        n_bytes = 4 * (sum(ops[key].numel() for key in (
            "pts_s", "seed", "qsph", "fsph", "csph", "planes")) + k.numel()
            + kv.numel())
        # the work these inputs need under the chunk cull, and the
        # reference's design's (every pair of each tested tile)
        out["bound_ms"], out["bound_by"] = bound_ms(
            folded * FACE_PAIR_OPS[(variant, tail)]
            + lane_bounds * CHUNK_BOUND_OPS
            + kv.numel() * n_ft * TILE_TEST_OPS, 1, n_bytes)
        out["bound_tiles_ms"], _ = bound_ms(
            tested * tile_q * tile_f, FACE_PAIR_OPS[(variant, tail)], n_bytes)
    log("  culled_faces[%s, tail=%s] %s: faces, tile, chunk and folded-face "
        "counts identical (faces and tiles also to every face of each "
        "tested tile), face tiles tested %d of %d (%.4f), warp-chunks %d of "
        "the tested tiles' %d (%.4f); real pairs folded by their own lanes "
        "%d (%.4f of %d), issued by the warps %.4f; max abs point/sqdist "
        "diff %.3g, plain %.1f ms, tile plain %.1f ms%s" % (
            variant, tail, out["shape"], tested, out["face_tiles"],
            out["tile_fraction"], chunks, out["warp_chunks_of_tested_tiles"],
            out["chunk_fraction"], folded, out["pair_fraction"],
            out["pairs"], out["issued_fraction"], err, plain_ms,
            tile_plain_ms, "" if not timing else
            ", %.3f ms (bound %.4f ms; every pair of the tested tiles %.3f "
            "ms)" % (out["ms"], out["bound_ms"], out["bound_tiles_ms"])))
    return out


def culled_prologue_parts(qk, v, f, points, variant):
    """CUDA-event ms of the steps of ``culled_operands`` (each a separate
    run of 3 after a warm-up, on the same inputs, each the function the
    rung calls): centering, the corner gather, ``prologue_orders`` (the
    Morton sorts), ``prologue_gathers``, ``prologue_spheres``, ``_seeds``
    and ``face_planes``; "rest" is the whole prologue less their sum (the
    sphere packing, host gaps)."""
    from mesh_tpu_torch.query import closest_kernel as ck

    tile_q, tile_f = 256, 1024
    pts, center, _ = ck._center_inputs(v, f, points)
    vc = v.to(torch.float32) - center
    tri = vc[:, f.long()]
    forder, qorder = qk.prologue_orders(tri, pts)
    tri_s, _, pts_s = qk.prologue_gathers(tri, pts, forder, qorder, tile_q,
                                          tile_f)
    _, (sc, sr), _ = qk.prologue_spheres(tri_s, pts_s, tile_q, tile_f)
    parts = {
        "centering": cuda_ms(lambda: ck._center_inputs(v, f, points), 3),
        "corner_gather": cuda_ms(lambda: vc[:, f.long()], 3),
        "morton_sorts": cuda_ms(lambda: qk.prologue_orders(tri, pts), 3),
        "sorted_gathers": cuda_ms(lambda: qk.prologue_gathers(
            tri, pts, forder, qorder, tile_q, tile_f), 3),
        "spheres": cuda_ms(lambda: qk.prologue_spheres(
            tri_s, pts_s, tile_q, tile_f), 3),
        "seeds": cuda_ms(lambda: qk._seeds(pts_s, sc, sr), 3),
        "face_planes": cuda_ms(lambda: ck.face_planes(tri_s, variant), 3)}
    whole = cuda_ms(lambda: qk.culled_operands(v, f, points, variant), 3)
    parts["rest"] = whole - sum(parts.values())
    return parts


def grid_bounds(out, n_tiles, per_tile, tile_q, tile_f, pair_ops):
    """Add to ``out`` the bounds of a launch of one block per query tile:
    a grid of fewer tiles than SMs uses only that many SMs' share of the
    card's float32 rate, and no launch ends before its heaviest tile
    (``per_tile``, the leaves each tile folds) is folded on one SM."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    folded = int(per_tile.sum())
    out["grid_sms"] = min(n_tiles, n_sms)
    out["bound_grid_sms_ms"] = max(
        out["bound_ms"], folded * tile_q * tile_f * pair_ops / PEAK_FP32_OPS
        * 1e3 * n_sms / out["grid_sms"])
    out["leaves_per_tile_max"] = int(per_tile.max())
    out["leaves_per_tile_mean"] = folded / n_tiles
    out["bound_heaviest_tile_ms"] = (
        out["leaves_per_tile_max"] * tile_q * tile_f * pair_ops
        / (PEAK_FP32_OPS / n_sms) * 1e3)
    return ("bound over the grid's %d SMs %.4f ms; leaves per tile mean "
            "%.1f, max %d, the heaviest tile's bound on one SM %.4f ms" % (
                out["grid_sms"], out["bound_grid_sms_ms"],
                out["leaves_per_tile_mean"], out["leaves_per_tile_max"],
                out["bound_heaviest_tile_ms"]))


def lane_counts(rk, tile_q, tile_f):
    """The sub-lane counts of ``rk.LANES`` the tiles allow."""
    return [s for s in rk.LANES
            if tile_f % s == 0 and tile_q * s <= rk.MAX_LANE_THREADS]


def compare_rope(rk, ops, n_buffers, label="scan", reps=REPS):
    """Kernel vs plain for one rope_faces entry on one operand set:
    identical distances, faces and leaf counts over every query tile.  The
    entry is held at every sub-lane count of ``rk.LANES`` the tiles allow
    and at the one ``rope_argmin`` picks (``rk.picked_lanes``), each
    timed; ``ms`` is the picked one's, and the pick must give S = 1's
    answers (one thread folding each leaf)."""
    name = "rope_faces_stream" if n_buffers else "rope_faces_resident"
    (pd, pi, pl), plain_ms = timed(lambda: rk.rope_argmin_plain(ops,
                                                                n_buffers))
    tile_q, tile_f = ops["tile_q"], ops["tile_f"]
    n_tiles = ops["seed"].shape[0] // tile_q
    chosen = rk.picked_lanes(tile_q, tile_f)
    ms_by_lanes, outs = {}, {}
    fit = lane_counts(rk, tile_q, tile_f)
    for lanes in fit + [None]:
        outs[lanes] = kd, ki, kl = rk.rope_argmin(ops, n_buffers,
                                                  lanes=lanes)
        check(torch.equal(ki, pi) and torch.equal(kl, pl)
              and torch.equal(kd, pd),
              "%s on %s (lanes %s): %d of %d faces (and %d leaf counts) "
              "differ from the plain version" % (
                  name, label, lanes, int((ki != pi).sum()), ki.numel(),
                  int((kl != pl).sum())))
        if lanes is not None:
            ms_by_lanes[lanes] = cuda_ms(
                lambda: rk.rope_argmin(ops, n_buffers, lanes=lanes),
                reps=reps)
    check(all(torch.equal(a, b) for a, b in zip(outs[None], outs[1])),
          "%s on %s: the picked lanes' answers are not S = 1's"
          % (name, label))
    leaves = int(kl.sum())
    n_leaves = ops["rows"].shape[-1] // tile_f
    faces = "recs" if n_buffers else "rows"
    out = {"operands": label,
           "shape": [ops["seed"].shape[0], ops["rows"].shape[-1]],
           "n_buffers": n_buffers, "faces_identical": True,
           "max_abs_err": float((kd - pd).abs().max()),
           "leaves_tested": leaves, "leaves": kl.numel() * n_leaves,
           "plain_ms": plain_ms, "lanes": chosen,
           "ms_by_lanes": ms_by_lanes, "ms": ms_by_lanes[chosen]}
    n_bytes = 4 * (sum(ops[key].numel() for key in (
        "pts_s", "seed", "boxes", "topo", faces)) + 2 * kd.numel()
        + kl.numel())
    pairs = leaves * tile_q * tile_f
    out["bound_ms"], out["bound_by"] = bound_ms(pairs, ROPE_PAIR_OPS, n_bytes)
    grid = grid_bounds(out, n_tiles, kl, tile_q, tile_f, ROPE_PAIR_OPS)
    log("  %s on %s %s: faces, distances and leaf counts identical to the "
        "plain version at lanes %s and the pick, which gives S = 1's; %d of "
        "%d leaves tested, %.3f ms (plain %.1f ms, bound %.4f ms); lanes %d "
        "picked; by lanes %s; %s" % (
            name, label, out["shape"], fit, leaves, out["leaves"], out["ms"],
            plain_ms, out["bound_ms"], chosen,
            ", ".join("%d: %.3f" % kv for kv in ms_by_lanes.items()), grid))
    return out, (kd, ki, kl)


def compare_fused_nan(ck, body, f, q, variant, tail):
    """The fused kernel vs its plain version on one body with NaN planted
    in corner a's x plane of three faces and in two queries: identical
    faces; on the card a NaN key (0x7fffffff) loses to every finite cost,
    so no finite query names a planted face and a NaN query names face
    0."""
    pts, planes, tri, center = ck.closest_point_operands(body, f, q, variant)
    nan_faces = [5, f.shape[0] // 2, f.shape[0] - 1]
    nan_queries = [3, q.shape[1] // 2]
    planes[0, 0, nan_faces] = float("nan")
    pts[0, nan_queries, 0] = float("nan")
    out = compare_faces(ck, pts, planes, tri, center, variant, tail,
                        timing=False, reduction="fused")
    faces = ck.argmin_faces(pts, planes, variant, tail, reduction="fused")[0]
    finite = torch.ones(faces.shape[0], dtype=torch.bool, device=faces.device)
    finite[nan_queries] = False
    planted = torch.isin(faces[finite].long(),
                         torch.as_tensor(nan_faces, device=faces.device))
    check(not bool(planted.any()) and bool((faces[~finite] == 0).all()),
          "closest_faces_fused[%s, tail=%s] with planted NaN: %d finite "
          "queries name a NaN face, NaN queries name %s" % (
              variant, tail, int(planted.sum()), faces[~finite].tolist()))
    out["planted_nan"] = {"faces": nan_faces, "queries": nan_queries}
    return out


def compare_rope_mxu(rk, ops, n_buffers, use_bf16, label, timing):
    """Kernel vs plain for one rope_mxu_faces entry (f32 or bf16) on one
    operand set: identical distances, faces, leaves taken and full visits
    over every query tile.  Either entry is held at every sub-lane count
    the tiles allow and at the pick (which must give S = 1's answers),
    each timed with ``timing``.  The bound counts the full visits' pairs
    at ROPE_MXU_PAIR_OPS and the screen's pairs at SCREEN_PAIR_OPS, as the
    picked launch evaluates them: each sub-lane's run up to its own first
    survivor."""
    name = "rope_mxu_stream" if n_buffers else "rope_mxu_resident"
    tile_q, tile_f = ops["tile_q"], ops["tile_f"]
    chosen = rk.picked_lanes(tile_q, tile_f)
    counts = {}
    (pd, pi, pl, pr), plain_ms = timed(lambda: rk.rope_mxu_argmin_plain(
        ops, n_buffers, use_bf16, counts, lanes=chosen))
    fit = lane_counts(rk, tile_q, tile_f)
    ms_by_lanes, outs = {}, {}
    for lanes in fit + [None]:
        outs[lanes] = kd, ki, kl, kr = rk.rope_mxu_argmin(
            ops, n_buffers, use_bf16, lanes=lanes)
        check(torch.equal(ki, pi) and torch.equal(kd, pd)
              and torch.equal(kl, pl) and torch.equal(kr, pr),
              "%s[%s, bf16=%s, lanes %s]: %d of %d faces, %d leaf counts "
              "and %d visit counts differ from the plain version" % (
                  name, label, use_bf16, lanes, int((ki != pi).sum()),
                  ki.numel(), int((kl != pl).sum()), int((kr != pr).sum())))
        if timing and lanes is not None:
            ms_by_lanes[lanes] = cuda_ms(lambda: rk.rope_mxu_argmin(
                ops, n_buffers, use_bf16, lanes=lanes), reps=REPS)
    check(all(torch.equal(a, b) for a, b in zip(outs[None], outs[1])),
          "%s[%s, bf16=%s]: the picked lanes' answers are not S = 1's"
          % (name, label, use_bf16))
    out = {"on": label, "shape": [ops["seed"].shape[0], ops["rec"].shape[0]],
           "n_buffers": n_buffers, "use_bf16": use_bf16, "identical": True,
           "lanes": chosen, "lanes_held": fit,
           "max_abs_err": float((kd - pd).abs().max()),
           "leaves_tested": int(kl.sum()), "full_visits": int(kr.sum()),
           "screen_pairs": counts.get("screen_pairs", 0),
           "screen_lane_pairs": counts.get("screen_lane_pairs", 0),
           "leaves": kl.numel() * (ops["rec"].shape[0] // tile_f),
           "pair_tests": int(kl.long().repeat_interleave(tile_q)[
               :ops["qorder"].shape[0]].sum()) * tile_f,
           "plain_ms": plain_ms}
    grid = ""
    if timing:
        out["ms_by_lanes"] = ms_by_lanes
        out["ms"] = ms_by_lanes[chosen]
        n_bytes = 4 * (sum(ops[key].numel() for key in (
            "pts_s", "p2", "seed", "boxes", "topo", "rec"))
            + 2 * kd.numel() + 2 * kl.numel())
        n_ops = (out["full_visits"] * tile_q * tile_f * ROPE_MXU_PAIR_OPS
                 + out["screen_lane_pairs"] * SCREEN_PAIR_OPS)
        out["bound_ms"], out["bound_by"] = bound_ms(n_ops, 1, n_bytes)
        # the grid bounds count each tile's full visits (not its screen)
        grid = "; " + grid_bounds(out, kl.numel(), kr, tile_q, tile_f,
                                  ROPE_MXU_PAIR_OPS)
    log("  %s[%s, bf16=%s] %s: faces, distances, leaf and visit counts "
        "identical at lanes %s and the pick (%d, S = 1's answers); %d leaves "
        "taken, %d full visits, %d screen pairs (%d as the sub-lanes screen); "
        "plain %.1f ms%s%s" % (
            name, label, use_bf16, out["shape"], fit, chosen,
            out["leaves_tested"], out["full_visits"], out["screen_pairs"],
            out["screen_lane_pairs"], plain_ms,
            "" if not timing else ", %.3f ms (bound %.3f ms); by lanes %s"
            % (out["ms"], out["bound_ms"], ", ".join(
                "%d: %.3f" % kv for kv in ms_by_lanes.items())), grid))
    return out, (kd, ki, kl, kr)


def mixed_queries(rng):
    """MIXED_QUERIES points around phase 6's unit sphere: half at radius
    1 + N(0, 0.002), half at MIXED_RADIUS, float32 [n, 3]."""
    d = rng.randn(MIXED_QUERIES, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    half = MIXED_QUERIES // 2
    r = np.concatenate([1.0 + 0.002 * rng.randn(half),
                        np.full(MIXED_QUERIES - half, MIXED_RADIUS)])
    return (d * r[:, None]).astype(np.float32)


def large_batch_inputs(dev):
    """Phase 5's inputs: the finer-template body model, betas and pose for
    LARGE_BATCH bodies, the posed vertices and surface-proximal queries."""
    from mesh_tpu_torch.models import lbs, synthetic_body_model
    from mesh_tpu_torch.models.body_model import _uv_sphere

    v, f = _uv_sphere(*LARGE_TEMPLATE)
    model = synthetic_body_model(
        seed=0, template=(v * np.array([0.3, 0.2, 0.9]), f), device=dev)
    rng = np.random.RandomState(0)
    betas = torch.as_tensor(rng.randn(LARGE_BATCH, model.num_betas) * 0.3,
                            dtype=torch.float32, device=dev)
    pose = torch.as_tensor(rng.randn(LARGE_BATCH, model.num_joints, 3) * 0.1,
                           dtype=torch.float32, device=dev)
    verts, _ = lbs(model, betas, pose, device=dev)
    queries, _ = surface_queries(verts, model.faces, LARGE_QUERIES, rng)
    return model, betas, pose, verts, queries


def scan_inputs():
    """Phase 6's mesh and queries: bench.py's parametric sphere and its
    surface-proximal points (unit directions pushed a few percent off)."""
    from mesh_tpu_torch.query.autotune import _sphere_mesh

    v, f = _sphere_mesh(SCAN_FACES)
    rng = np.random.RandomState(0)
    pts = rng.randn(SCAN_QUERIES, 3)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts *= 1.0 + 0.05 * rng.randn(SCAN_QUERIES, 1)
    return v, f, pts.astype(np.float32)


def drive_scan(path, v, f, pts, dev):
    """One scan path: the Mesh facade under MESH_TPU_NO_ENGINE=1 (its
    direct route, the auto ladder; first call cold, then warm calls) and
    the accel rung with its stats, counts reset just before and read just
    after."""
    from mesh_tpu_torch import Mesh
    from mesh_tpu_torch.accel.traverse import closest_faces_and_points_accel
    from mesh_tpu_torch.query import culled as auto

    reset_launches()
    auto.STRATEGY.clear()
    m = Mesh(v, f, device=dev)
    with no_engine():       # the engine would take the culled kernel
        t0 = time.perf_counter()
        faces, points = m.closest_faces_and_points(pts)
        first_s = time.perf_counter() - t0
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            faces2, points2 = m.closest_faces_and_points(pts)
            times.append((time.perf_counter() - t0) * 1e3)
    vt, ft = m.device_arrays()
    res, stats = closest_faces_and_points_accel(vt, ft, pts, with_stats=True,
                                                device=dev)
    launches = read_launches()
    check(dict(auto.STRATEGY) == {"accel_bvh": 6},
          "%s routes %s, not the BVH" % (path, auto.STRATEGY))
    check(faces.dtype == np.uint32 and faces.shape == (1, SCAN_QUERIES)
          and points.dtype == np.float64
          and points.shape == (SCAN_QUERIES, 3), "%s facade dtype/shape"
          % path)
    check(np.array_equal(faces, faces2) and np.array_equal(points, points2)
          and np.array_equal(faces[0], res["face"].astype(np.uint32))
          and np.array_equal(points, res["point"].astype(np.float64)),
          "%s: repeated calls disagree" % path)
    check(bool(np.isfinite(res["sqdist"]).all()), "%s sqdist not finite"
          % path)
    log("  %s: backend %s, %d pair tests (%.1f%% of Q x F), first facade "
        "call %.3f s (with the host BVH build), warm calls median %.3f ms "
        "(min %.3f, max %.3f)" % (
            path, stats["backend"], stats["pair_tests"],
            100.0 * stats["pair_tests"] / (SCAN_QUERIES * f.shape[0]),
            first_s, statistics.median(times), min(times), max(times)))
    return res, stats, launches, {
        "first_call_s": first_s, "warm_call_ms": statistics.median(times),
        "warm_call_ms_min": min(times), "warm_call_ms_max": max(times)}


def crossover(dev, large, scan):
    """Every closest-point route timed at both drives' shapes (ms, CUDA
    events around whole calls, 3 reps after a warm-up): brute force,
    culled, resident and streamed rope."""
    from mesh_tpu_torch.accel import rope_kernel as rk
    from mesh_tpu_torch.query import closest_kernel as ck
    from mesh_tpu_torch.query import culled_kernel as qk

    verts, f_l, q_l, nondegen = large
    v_s, f_s, p_s = scan
    n_b, n_q = q_l.shape[:2]
    shapes = [
        ("large_batch %d bodies x %d" % (n_b, n_q), verts, f_l, q_l, nondegen,
         False),
        ("large_batch body 0 x %d" % n_q, verts[0], f_l, q_l[0], nondegen,
         True),
        ("scan 1 x %d" % p_s.shape[0], torch.as_tensor(v_s, device=dev),
         torch.as_tensor(f_s, device=dev), torch.as_tensor(p_s, device=dev),
         True, True),
    ]
    rows = []
    for label, v, f, q, nd, single in shapes:
        row = {"shape": label, "faces": int(f.shape[0]),
               "brute": cuda_ms(lambda: ck.closest_point_kernel(
                   v, f, q, assume_nondegenerate=nd), 3),
               "culled": cuda_ms(lambda: qk.closest_point_culled_kernel(
                   v, f, q, assume_nondegenerate=nd), 3)}
        vb, qb = (v[None], q[None]) if single else (v, q)
        ops = qk.culled_operands(vb, f, qb)
        tested = qk.argmin_culled(ops, "fast", not nd)[1]
        row["culled_face_tiles_tested"] = float(tested.sum()) / (
            tested.numel() * ops["fsph"].shape[1])
        del ops
        if single:
            row["rope_resident"] = cuda_ms(
                lambda: rk.closest_point_bvh_kernel(v, f, q, device=dev), 3)
            row["rope_stream"] = cuda_ms(
                lambda: rk.closest_point_bvh_stream_kernel(v, f, q,
                                                           device=dev), 3)
        rows.append(row)
        log("  crossover at %s (%d faces): %s; culled tests %.1f%% of its "
            "face tiles" % (label, row["faces"], ", ".join(
                "%s %.3f ms" % (k, row[k]) for k in (
                    "brute", "culled", "rope_resident", "rope_stream")
                if k in row), 100 * row["culled_face_tiles_tested"]))
    return rows


def compare_any_hit(ray, origins, dirs, planes):
    """Kernel vs plain for the every-face ray_any_hit on one operand set:
    identical blocked flags and pairs tested per ray, both timed.  Returns
    (the run, the kernel's flags)."""
    kb, kt = ray.ray_any_hit(origins, dirs, planes, t_lo=0.0)
    (pb, pt), plain_ms = timed(
        lambda: ray.ray_any_hit_plain(origins, dirs, planes, t_lo=0.0))
    check(torch.equal(kb, pb) and torch.equal(kt, pt),
          "ray_any_hit: %d of %d blocked flags (and %d pair counts) differ "
          "from the plain version" % (int((kb != pb).sum()), kb.numel(),
                                      int((kt != pt).sum())))
    n_b, n_r = origins.shape[:2]
    tested = int(kt.sum())
    pairs = n_b * n_r * planes.shape[-1]
    out = {"shape": [n_b, n_r, planes.shape[-1]], "flags_identical": True,
           "max_abs_err": float((kb.int() - pb.int()).abs().max()),
           "blocked_share": float(kb.float().mean()),
           "pairs_tested": tested, "pairs": pairs, "plain_ms": plain_ms,
           "ms": cuda_ms(lambda: ray.ray_any_hit(origins, dirs, planes,
                                                 t_lo=0.0), reps=REPS)}
    n_bytes = 4 * (origins.numel() + dirs.numel() + planes.numel()
                   + 2 * kb.numel())
    out["bound_ms"], out["bound_by"] = bound_ms(tested, RAY_PAIR_OPS,
                                                n_bytes)
    log("  ray_any_hit %s: flags and pair counts identical, %.1f%% blocked, "
        "%d of %d pairs tested (%.1f%%), %.3f ms (plain %.1f ms, bound %.3f "
        "ms)" % (out["shape"], 100 * out["blocked_share"], tested, pairs,
                 100.0 * tested / pairs, out["ms"], plain_ms, out["bound_ms"]))
    return out, kb


def compare_any_hit_culled(ray, vis, ops, dense, label, t_lo=0.0, t_hi=None,
                           order=None, timing=False):
    """ray_any_hit_culled on one operand set against its plain version
    (blocked flags, pairs per ray, chunks per warp and blocking faces
    identical) and against the every-face kernel's flags ``dense`` (the
    rays in each mesh's vertex order when ``order`` [B, V], the vertex
    Morton order of ``ops``' rays, is given; else in ``ops``' order).
    The bound counts each lane's own work: the pairs it evaluated, a chunk
    test per chunk while it was unblocked, and the normals fallbacks among
    them."""
    kb = ray.ray_any_hit_culled(ops, t_lo, t_hi, with_stats=True)
    plain, plain_ms = timed(lambda: ray.ray_any_hit_culled_plain(
        ops, t_lo, t_hi, with_tests=True))
    for name, a, b in zip(("blocked flags", "pairs per ray", "warp chunks",
                           "blocking faces"), kb, plain):
        check(torch.equal(a, b), "ray_any_hit_culled on %s: %d of %d %s "
              "differ from the plain version" % (label, int((a != b).sum()),
                                                 a.numel(), name))
    flags = kb[0]
    if order is not None:
        flags = vis.unsort_flags(flags, order, flags.shape[1]
                                 // order.shape[1]).reshape(flags.shape)
    check(torch.equal(flags, dense), "ray_any_hit_culled on %s: %d of %d "
          "blocked flags differ from the every-face kernel's"
          % (label, int((flags != dense).sum()), flags.numel()))
    n_b, n_r = flags.shape
    n_f, n_c = ops["n_faces"], ops["chunks"].shape[1]
    pairs, warp, tests, by_face = (int(x.sum()) for x in (
        kb[1], kb[2], plain[4], plain[5]))
    out = {"on": label, "shape": [n_b, n_r, n_f], "flags_identical": True,
           "max_abs_err": 0.0, "blocked_share": float(flags.float().mean()),
           "pairs": pairs, "pairs_all": n_b * n_r * n_f,
           "pair_fraction": pairs / max(1, n_b * n_r * n_f),
           "warp_chunks": warp, "warp_chunks_all": kb[2].numel() * n_c,
           "chunk_fraction": warp / max(1, kb[2].numel() * n_c),
           "chunk_tests": tests, "normal_fallbacks": by_face,
           "fallback_fraction": by_face / max(1, tests),
           "plain_ms": plain_ms}
    n_bytes = 4 * (ops["origins"].numel() + ops["dirs"].numel()
                   + ops["faces"].numel() + ops["chunks"].numel()
                   + 2 * flags.numel())
    out["bound_ms"], out["bound_by"] = bound_ms(
        pairs * RAY_PAIR_OPS + tests * CULL_TEST_OPS
        + by_face * CULL_FACE_OPS, 1, n_bytes)
    out["bound_issued_ms"] = bound_ms(
        warp * 32 * ray.ANY_HIT_CHUNK, RAY_PAIR_OPS, n_bytes)[0]
    out["bound_all_pairs_ms"] = bound_ms(n_b * n_r * n_f, RAY_PAIR_OPS,
                                         n_bytes)[0]
    if timing:
        out["ms"] = cuda_ms(lambda: ray.ray_any_hit_culled(ops, t_lo, t_hi),
                            reps=REPS)
    log("  ray_any_hit_culled on %s %s: flags identical to the every-face "
        "kernel's and, with the counts, to the plain version's; %.1f%% "
        "blocked; lanes evaluated %d pairs (%.4f of all), warps tested %d of "
        "%d chunks (%.4f), %d chunk tests, %.4f of them by the faces' "
        "normals; %s ms (plain %.1f ms, bound %.3f ms per lane, %.3f "
        "issued, %.3f every pair)"
        % (label, out["shape"], 100 * out["blocked_share"], pairs,
           out["pair_fraction"], warp, out["warp_chunks_all"],
           out["chunk_fraction"], tests, out["fallback_fraction"],
           "%.3f" % out["ms"] if timing else "-", plain_ms, out["bound_ms"],
           out["bound_issued_ms"], out["bound_all_pairs_ms"]))
    return out


def any_hit_planted(ray, vis, template, faces, dev):
    """The sets the culled any-hit kernel must also get right, as (label,
    operands, t_lo, t_hi, the every-face kernel's flags): GRAZE_RAYS rays
    within GRAZE_TILT rad of a flat grid's plane (turned off the axes and
    moved off the origin), starting 5 to 60 units before it; the rest
    ``template`` [V, 3] with one NaN and one inf corner, from camera 0; and
    the template from camera 0 with t in [0, VIS_T_HI]."""
    rng = np.random.RandomState(7)
    n = GRAZE_GRID
    xs = np.linspace(0.0, 1.0, n + 1)
    gv = np.array([(x, y, 0.0) for y in xs for x in xs])
    gf = np.array([q for j in range(n) for i in range(n) for q in (
        (j * (n + 1) + i, j * (n + 1) + i + 1, (j + 1) * (n + 1) + i + 1),
        (j * (n + 1) + i, (j + 1) * (n + 1) + i + 1, (j + 1) * (n + 1) + i))])
    rot, _ = np.linalg.qr(rng.randn(3, 3))
    shift = np.array([3.0, -2.0, 5.0])
    far = rng.uniform(5.0, 60.0, GRAZE_RAYS)
    tilt = rng.uniform(-GRAZE_TILT, GRAZE_TILT, GRAZE_RAYS)
    local_o = np.stack([-far, rng.uniform(-1.0, 2.0, GRAZE_RAYS),
                        -tilt * (far + rng.uniform(-40.0, 40.0, GRAZE_RAYS))],
                       1)
    local_d = np.stack([np.cos(tilt), rng.uniform(-0.05, 0.05, GRAZE_RAYS)
                        * np.cos(tilt), np.sin(tilt)], 1)

    def t32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    grid = t32((gv @ rot.T + shift)[gf])[None]
    cam = torch.tensor(VIS_CAMERAS[:1], dtype=torch.float32, device=dev)
    rest = template[None]
    tri = rest[..., faces.long(), :]
    bad = tri.clone()
    bad[0, 100, 1, 0] = float("nan")
    bad[0, 5000, 2, 2] = float("inf")
    o, d = vis.visibility_rays(rest, cam, VIS_MIN_DIST)
    o, d = vis.sort_rays(o, d, vis.vertex_order(rest))
    sets = [("grazing rays on a flat grid", t32(local_o @ rot.T + shift)[None],
             t32(local_d @ rot.T)[None], grid, 0.0, None),
            ("NaN and inf corners", o, d, bad, 0.0, None),
            ("t in [0, %g]" % VIS_T_HI, o, d, tri, 0.0, VIS_T_HI)]
    return [(label, ray.any_hit_operands(o_, d_, tri_), t_lo, t_hi,
             ray.ray_any_hit(o_, d_, ray.ray_planes(tri_), t_lo, t_hi)[0])
            for label, o_, d_, tri_, t_lo, t_hi in sets]


def compare_alongnormal(ray, pts, nrm, tri, label="registration",
                        timing=False):
    """alongnormal_faces on one operand set (``pts``, ``nrm`` [B, Q, 3],
    faces ``tri`` [B, F, 3, 3]): the chunk-cull kernel's faces identical to
    the plain version of its design (``argmin_alongnormal_culled_plain``,
    also its warp, lane, stage and miss counts) at the default split, to
    the every-face plain version and to the every-face kernel
    (``alongnormal_faces_every``), and the epilogue's distances and points
    after each.

    With ``timing``: also every split of ALONG_SPLITS against its plain
    version, each timed; the kernel alone on operands made beforehand (the
    face side and the query order), with the query order (what a tree's
    warm call pays), the query order alone, the face side alone (a tree's
    first call), the every-face kernel and the plain versions; three
    bounds, each against the bytes: the pairs these inputs need (the real
    faces of the chunks each lane needs), the pairs the warps issue (32
    lanes x the faces of each chunk a warp folds) and every pair, each x
    ALONG_PAIR_OPS; and apart from them the design's own work
    (``design_overhead_ms``: each lane's chunk tests, their normals
    fallbacks, the bounds of the chunks its line meets, its miss
    candidates and its seed), which no bound counts as needed."""
    planes = ray.ray_planes(tri)
    cull = ray.alongnormal_cull_operands(tri)
    qorder = ray.along_query_order(pts, cull)
    name = "alongnormal_faces[%s]" % label

    def against_plain(split):
        k = ray.argmin_alongnormal(pts, nrm, cull=cull, qorder=qorder,
                                   with_stats=True, split=split)
        p, plain_ms = timed(lambda: ray.argmin_alongnormal_culled_plain(
            pts, nrm, cull, qorder, split, with_tests=True))
        check(all(torch.equal(x, y) for x, y in zip(k, p)),
              "%s, split %d: %d of %d faces (and %s warp, lane, stage, miss "
              "counts) differ from the plain version" % (
                  name, split, int((k[0] != p[0]).sum()), k[0].numel(),
                  [int((x != y).sum()) for x, y in zip(k[1:], p[1:])]))
        return k, p, plain_ms

    k, p, plain_ms = against_plain(ray.ALONG_SPLIT)
    every, every_plain_ms = timed(lambda: ray.argmin_alongnormal_plain(
        pts, nrm, planes))
    oracle = ray.argmin_alongnormal_every(pts, nrm, planes)
    check(torch.equal(k[0], every) and torch.equal(k[0], oracle),
          "%s: %d faces differ from the every-face plain version, %d from "
          "the every-face kernel" % (name, int((k[0] != every).sum()),
                                     int((k[0] != oracle).sum())))
    dk = ray.alongnormal_epilogue(k[0], tri, pts, nrm)
    dp = ray.alongnormal_epilogue(every, tri, pts, nrm)
    check(same_bits(dk[0], dp[0]) and same_bits(dk[2], dp[2]),
          "%s: epilogue distances or points differ on identical faces "
          "(NaN where NaN, the same bits elsewhere)" % name)
    real = ~torch.isnan(dk[2])
    n_b, n_q = pts.shape[:2]
    n_f, n_c = cull["n_faces"], cull["chunks"].shape[1]
    warp, lane, stage, misses = (int(x.sum()) for x in k[1:5])
    tests, fallbacks, meets = (int(x.sum()) for x in p[5:8])
    out = {"set": label, "shape": [n_b, n_q, n_f], "split": ray.ALONG_SPLIT,
           "faces_identical": True, "every_face_identical": True,
           "max_abs_err": float((dk[2] - dp[2]).abs()[real].max())
           if bool(real.any()) else 0.0,
           "hit_share": float(torch.isfinite(dk[0]).float().mean()),
           "warp_chunks": warp, "warp_chunks_all": k[1].numel() * n_c,
           "warp_chunk_max": int(k[1].max()), "warp_stages": stage,
           "lane_faces": lane, "lane_misses": misses, "chunk_tests": tests,
           "normal_fallbacks": fallbacks, "meets": meets,
           "pairs": n_b * n_q * n_f, "plain_ms": plain_ms,
           "every_plain_ms": every_plain_ms}
    out["warp_share"] = warp / out["warp_chunks_all"]
    out["heaviest_warp_share"] = out["warp_chunk_max"] / n_c
    out["stage_share"] = stage / out["warp_chunks_all"]
    out["lane_share"] = lane / out["pairs"]
    out["miss_share"] = misses / max(1, tests)
    out["fallback_share"] = fallbacks / max(1, tests)
    if timing:
        n_bytes = 4 * (pts.numel() + nrm.numel() + qorder.numel()
                       + cull["faces"].numel() + cull["chunks"].numel()
                       + cull["ids"].numel() + cull["min_ids"].numel()
                       + 2 * n_b * n_q)

        def overhead_ms(tests_, fallbacks_, meets_, misses_):
            # each lane's chunk tests, bounds, miss candidates and seed
            return bound_ms(
                tests_ * ALONG_TEST_OPS + fallbacks_ * CULL_FACE_OPS
                + meets_ * ALONG_BOUND_OPS + misses_ * ALONG_MISS_OPS
                + n_b * n_q * (n_c * ALONG_SEED_SCAN_OPS + ray.SEED_CHUNKS
                               * ray.ANY_HIT_CHUNK * ALONG_PAIR_OPS), 1, 0)[0]

        out["splits"] = {}
        for split in ALONG_SPLITS:
            ks, ps_, split_plain_ms = against_plain(split)
            out["splits"][split] = {
                "ms": cuda_ms(lambda: ray.argmin_alongnormal(
                    pts, nrm, cull=cull, qorder=qorder, split=split),
                    reps=REPS),
                "plain_ms": split_plain_ms,
                "warp_share": int(ks[1].sum()) / out["warp_chunks_all"],
                "lane_share": int(ks[2].sum()) / out["pairs"],
                "bound_ms": bound_ms(int(ks[2].sum()), ALONG_PAIR_OPS,
                                     n_bytes)[0],
                "bound_issued_ms": bound_ms(
                    int(ks[1].sum()) * 32 * ray.ANY_HIT_CHUNK,
                    ALONG_PAIR_OPS, n_bytes)[0],
                "design_overhead_ms": overhead_ms(*(
                    int(x.sum()) for x in (ps_[5], ps_[6], ps_[7], ps_[4])))}
        out["ms"] = cuda_ms(lambda: ray.argmin_alongnormal(
            pts, nrm, cull=cull, qorder=qorder), reps=REPS)
        out["with_order_ms"] = cuda_ms(lambda: ray.argmin_alongnormal(
            pts, nrm, cull=cull), reps=REPS)
        out["order_ms"] = cuda_ms(lambda: ray.along_query_order(pts, cull),
                                  reps=REPS)
        out["prologue_ms"] = cuda_ms(
            lambda: ray.alongnormal_cull_operands(tri), reps=REPS)
        out["every_ms"] = cuda_ms(lambda: ray.argmin_alongnormal_every(
            pts, nrm, planes), reps=REPS)
        out["bound_ms"], out["bound_by"] = bound_ms(lane, ALONG_PAIR_OPS,
                                                    n_bytes)
        out["bound_issued_ms"] = bound_ms(warp * 32 * ray.ANY_HIT_CHUNK,
                                          ALONG_PAIR_OPS, n_bytes)[0]
        out["design_overhead_ms"] = overhead_ms(tests, fallbacks, meets,
                                                misses)
        out["bound_every_pair_ms"] = bound_ms(out["pairs"], ALONG_PAIR_OPS,
                                              n_bytes)[0]
    log("  %s %s: faces identical to the plain version (and its counts), "
        "the every-face plain version and kernel; warps fold %.4f of the "
        "chunks (heaviest warp %.4f) and stage %.4f, lanes need %.4f of the "
        "pairs, %.4f of the chunk tests find a miss, %.4f fall back to the "
        "faces' normals; %.1f%% hit; plain %.1f ms, every-face plain %.1f "
        "ms%s" % (
            name, out["shape"], out["warp_share"],
            out["heaviest_warp_share"], out["stage_share"],
            out["lane_share"], out["miss_share"], out["fallback_share"],
            100 * out["hit_share"], plain_ms, every_plain_ms,
            "" if not timing else
            "; %.3f ms at split %d (splits %s; with the query order %.3f, "
            "the order %.3f, the face side %.3f; every face %.3f; bound "
            "%.4f ms per lane, %.4f issued, %.3f every pair; the design's "
            "tests, fallbacks, bounds, misses and seed %.4f)" % (
                out["ms"], ray.ALONG_SPLIT, ", ".join(
                    "%d: %.3f" % (sp, r["ms"])
                    for sp, r in out["splits"].items()),
                out["with_order_ms"], out["order_ms"], out["prologue_ms"],
                out["every_ms"], out["bound_ms"], out["bound_issued_ms"],
                out["bound_every_pair_ms"], out["design_overhead_ms"])))
    return out


def along_planted(ray, verts0, faces, pts, nrm, v2t, f2t, q2t, rng):
    """alongnormal_faces on phase 2's planted sets, each held as
    ``compare_alongnormal`` holds phase 8's operands: the first
    ALONG_PLANTED of phase 8's queries on body 0 with NaN in every 97th
    normal, with normals of norm 3 and 0; as many queries at 10-100 times
    the body's radius (``far_queries``) with random unit normals; the
    planted degenerate mesh with random normals; lines through the shared
    edges and vertices of a flat grid, perpendicular to it (both faces at
    an edge tie at equal |t|), and lines within GRAZE_TILT rad of its
    plane; and body 0 scaled by 1e15 (coordinates near float32's
    overflow in the pair's products)."""
    dev = pts.device
    p, n = pts[:ALONG_PLANTED], nrm[:ALONG_PLANTED]
    nan_n = n.clone()
    nan_n[::97, 1] = float("nan")

    def unit(k):
        x = torch.as_tensor(rng.randn(k, 3), dtype=torch.float32, device=dev)
        return x / x.norm(dim=-1, keepdim=True)

    g = GRAZE_GRID
    xs = np.linspace(0.0, 1.0, g + 1)
    gv = np.array([(x, y, 0.0) for y in xs for x in xs])
    gf = np.array([q for j in range(g) for i in range(g) for q in (
        (j * (g + 1) + i, j * (g + 1) + i + 1, (j + 1) * (g + 1) + i + 1),
        (j * (g + 1) + i, (j + 1) * (g + 1) + i + 1, (j + 1) * (g + 1) + i))])
    rot, _ = np.linalg.qr(rng.randn(3, 3))
    shift = np.array([3.0, -2.0, 5.0])
    grid = torch.as_tensor((gv @ rot.T + shift)[gf], dtype=torch.float32,
                           device=dev)[None]
    # points on the grid's vertices and edge midpoints, offset off the
    # plane along its normal, lines perpendicular to it
    k = ALONG_PLANTED // 2
    on = np.concatenate([gv[rng.randint(0, gv.shape[0], k // 2)],
                         (gv[gf[rng.randint(0, gf.shape[0], k - k // 2), 0]]
                          + gv[gf[rng.randint(0, gf.shape[0],
                                              k - k // 2), 1]]) / 2.0])
    on = on + np.array([0.0, 0.0, 1.0]) * rng.uniform(-2.0, 2.0, (k, 1))
    ties_p = on @ rot.T + shift
    ties_n = np.tile(np.array([0.0, 0.0, 1.0]) @ rot.T, (k, 1))
    # lines within GRAZE_TILT rad of the plane, from 5 to 60 units away
    far = rng.uniform(5.0, 60.0, k)
    tilt = rng.uniform(-GRAZE_TILT, GRAZE_TILT, k)
    graze_p = np.stack([-far, rng.uniform(-1.0, 2.0, k),
                        -tilt * (far + rng.uniform(-40.0, 40.0, k))], 1)
    graze_n = np.stack([np.cos(tilt), rng.uniform(-0.05, 0.05, k)
                        * np.cos(tilt), np.sin(tilt)], 1)
    line_p = torch.as_tensor(np.concatenate([ties_p, graze_p @ rot.T
                                             + shift]), dtype=torch.float32,
                             device=dev)
    line_n = torch.as_tensor(np.concatenate([ties_n, graze_n @ rot.T]),
                             dtype=torch.float32, device=dev)
    body = verts0[faces.long()][None]
    big = 1e15
    sets = [("nan normals", p, nan_n, body),
            ("normals x3", p, n * 3.0, body),
            ("zero normals", p, torch.zeros_like(n), body),
            ("far", far_queries(verts0, ALONG_PLANTED, rng)[0],
             unit(ALONG_PLANTED), body),
            ("planted degenerate", q2t[0], unit(q2t.shape[1]),
             v2t[0][f2t.long()][None]),
            ("grid ties and grazing lines", line_p, line_n, grid),
            ("scaled 1e15", p * big, n, body * big)]
    return [compare_alongnormal(ray, q[None].contiguous(),
                                qn[None].contiguous(), tri_.contiguous(),
                                label=label)
            for label, q, qn, tri_ in sets]


def compare_normal_weighted(nw, ck, ops, tail, timing, eps=REG_EPS,
                            label="registration"):
    """Kernel vs plain for normal_weighted_faces on one operand set: the
    chunk-cull kernel's faces identical to the plain version of its design
    (``argmin_normal_weighted_culled_plain``, also its warp, lane and stage
    counts) at the default split, to the every-face plain version and to
    the every-face kernel (``normal_weighted_faces_every``), its chunk
    records equal to ``cull_records_plain``'s, and the epilogue's points
    after each.

    With ``timing``: also every split of NW_SPLITS against its plain
    version, each timed; the kernel alone on operands made beforehand, with
    its prologue (``normal_weighted_cull_operands``), the prologue alone,
    the every-face kernel and the plain versions; four bounds: the work
    these inputs need per lane (the faces of the chunks its own lane needs,
    a bound per chunk and the seed), the pairs the warps issue (32 lanes x
    the faces of each chunk a warp folds), the heaviest warp's pairs on one
    scheduler, and every pair, each x the pair's operations."""
    pts, nrm, planes, tri, center = ops
    cull = nw.normal_weighted_cull_operands(pts, planes, tail)
    records_plain = ck.cull_records_plain(planes, "fast", tail)
    same = (cull["records"] == records_plain) | (
        torch.isnan(cull["records"]) & torch.isnan(records_plain))
    check(bool(same.all()), "normal_weighted_faces[%s, tail=%s]: %d of %d "
          "record values differ from cull_records_plain's" % (
              label, tail, int((~same).sum()), same.numel()))
    name = "normal_weighted_faces[%s, tail=%s, eps=%g]" % (label, tail, eps)

    def against_plain(split):
        k, kw_, kl, kb = nw.argmin_normal_weighted(
            pts, nrm, planes, eps, tail, cull=cull, with_stats=True,
            split=split)
        (p, pw, pl, pb), plain_ms = timed(
            lambda: nw.argmin_normal_weighted_culled_plain(
                pts, nrm, planes, cull, eps, tail, split))
        check(torch.equal(k, p) and torch.equal(kw_, pw)
              and torch.equal(kl, pl) and torch.equal(kb, pb),
              "%s, split %d: %d of %d faces (and %d warp, %d lane, %d stage "
              "counts) differ from the plain version" % (
                  name, split, int((k != p).sum()), k.numel(),
                  int((kw_ != pw).sum()), int((kl != pl).sum()),
                  int((kb != pb).sum())))
        return k, kw_, kl, kb, plain_ms

    k, kw_, kl, kb, plain_ms = against_plain(nw.NW_SPLIT)
    every, every_plain_ms = timed(lambda: nw.argmin_normal_weighted_plain(
        pts, nrm, planes, eps, tail))
    oracle = nw.argmin_normal_weighted_every(pts, nrm, planes, eps, tail)
    check(torch.equal(k, every) and torch.equal(k, oracle),
          "%s: %d faces differ from the every-face plain version, %d from "
          "the every-face kernel" % (name, int((k != every).sum()),
                                     int((k != oracle).sum())))
    pk = nw.normal_weighted_epilogue(k, tri, pts, center)[1]
    pp = nw.normal_weighted_epilogue(every, tri, pts, center)[1]
    n_b, n_q = pts.shape[:2]
    n_f = planes.shape[-1]
    n_c = -(-n_f // ck.CULL_CHUNK)
    out = {"set": label, "degenerate_tail": tail, "eps": eps,
           "shape": [n_b, n_q, n_f], "split": nw.NW_SPLIT,
           "faces_identical": True, "every_face_identical": True,
           "max_abs_err": float((pk - pp).abs().nan_to_num().max()),
           "warp_chunks": int(kw_.sum()), "warp_chunks_all": kw_.numel() * n_c,
           "warp_chunk_max": int(kw_.max()), "warp_stages": int(kb.sum()),
           "lane_faces": int(kl.sum()), "pairs": n_b * n_q * n_f,
           "plain_ms": plain_ms, "every_plain_ms": every_plain_ms}
    out["warp_share"] = out["warp_chunks"] / out["warp_chunks_all"]
    out["heaviest_warp_share"] = out["warp_chunk_max"] / n_c
    out["stage_share"] = out["warp_stages"] / out["warp_chunks_all"]
    out["lane_share"] = out["lane_faces"] / out["pairs"]
    if timing:
        ops_ = NW_PAIR_OPS[tail]
        n_bytes = 4 * (pts.numel() + nrm.numel() + planes.numel()
                       + n_b * n_q + cull["qorder"].numel()
                       + cull["records"].numel() + n_b)
        lanes = n_b * n_q
        around = lanes * (n_c * (NW_CULL_BOUND_OPS + SEED_OPS) + ops_)
        # a warp issues one instruction for its 32 lanes a cycle: a
        # scheduler's share of the card's rate
        n_sms = torch.cuda.get_device_properties(0).multi_processor_count
        per_scheduler = PEAK_FP32_OPS / (4 * n_sms)
        out["splits"] = {}
        for split in NW_SPLITS:
            _, sw, sl, sb, split_plain_ms = against_plain(split)
            out["splits"][split] = {
                "ms": cuda_ms(lambda: nw.argmin_normal_weighted(
                    pts, nrm, planes, eps, tail, cull=cull, split=split),
                    reps=REPS),
                "plain_ms": split_plain_ms,
                "warp_share": int(sw.sum()) / out["warp_chunks_all"],
                "heaviest_warp_share": int(sw.max()) / n_c,
                "lane_share": int(sl.sum()) / out["pairs"],
                # a split's heaviest warp folds at least its share
                "bound_heaviest_warp_ms": (
                    int(sw.max()) / split * ck.CULL_CHUNK * 32 * ops_
                    / per_scheduler * 1e3),
                "bound_issued_ms": bound_ms(
                    int(sw.sum()) * 32 * ck.CULL_CHUNK * ops_ + around, 1,
                    n_bytes)[0]}
        out["ms"] = cuda_ms(lambda: nw.argmin_normal_weighted(
            pts, nrm, planes, eps, tail, cull=cull), reps=REPS)
        out["with_prologue_ms"] = cuda_ms(lambda: nw.argmin_normal_weighted(
            pts, nrm, planes, eps, tail), reps=REPS)
        out["prologue_ms"] = cuda_ms(lambda: nw.normal_weighted_cull_operands(
            pts, planes, tail), reps=REPS)
        out["every_ms"] = cuda_ms(lambda: nw.argmin_normal_weighted_every(
            pts, nrm, planes, eps, tail), reps=REPS)
        out["bound_ms"], out["bound_by"] = bound_ms(
            out["lane_faces"] * ops_ + around, 1, n_bytes)
        out["bound_issued_ms"], _ = bound_ms(
            out["warp_chunks"] * 32 * ck.CULL_CHUNK * ops_ + around, 1,
            n_bytes)
        out["bound_every_pair_ms"], _ = bound_ms(out["pairs"], ops_, n_bytes)
        out["bound_heaviest_warp_ms"] = out["splits"][nw.NW_SPLIT][
            "bound_heaviest_warp_ms"]
    log("  %s %s: records identical to cull_records_plain's; faces "
        "identical to the plain version (and its counts), the every-face "
        "plain version and kernel; warps fold %.4f of the chunks (heaviest "
        "warp %.4f) and stage %.4f, lanes need %.4f of the pairs; plain "
        "%.1f ms, every-face plain %.1f ms%s" % (
            name, out["shape"], out["warp_share"],
            out["heaviest_warp_share"], out["stage_share"],
            out["lane_share"], plain_ms, every_plain_ms, "" if not timing else
            "; %.3f ms at split %d (splits %s; with the prologue %.3f, "
            "prologue %.3f, every face %.3f; bound %.4f ms, issued %.4f, "
            "heaviest warp on one scheduler %.4f, every pair %.3f)" % (
                out["ms"], nw.NW_SPLIT, ", ".join(
                    "%d: %.3f" % (sp, r["ms"])
                    for sp, r in out["splits"].items()),
                out["with_prologue_ms"], out["prologue_ms"],
                out["every_ms"], out["bound_ms"], out["bound_issued_ms"],
                out["bound_heaviest_warp_ms"], out["bound_every_pair_ms"])))
    return out


def normal_weighted_planted(nw, ck, verts0, faces, pts, nrm, tail, rng):
    """normal_weighted_faces on phase 2's planted sets: the first
    NW_PLANTED of phase 8's queries on body 0 with NaN in every 97th
    normal, normals of norm 3 and 0, eps = -0.1 and 0, and NW_PLANTED
    queries at 10-100 times the body's radius (``far_queries``, the planted
    miss's kind) with random unit normals; each held as
    ``compare_normal_weighted`` holds phase 8's operands."""
    p, n = pts[:NW_PLANTED], nrm[:NW_PLANTED]
    nan_n = n.clone()
    nan_n[::97, 1] = float("nan")
    far_n = torch.as_tensor(rng.randn(NW_PLANTED, 3), dtype=torch.float32,
                            device=pts.device)
    far_n = far_n / far_n.norm(dim=-1, keepdim=True)
    sets = [("nan normals", p, nan_n, REG_EPS),
            ("normals x3", p, n * 3.0, REG_EPS),
            ("zero normals", p, torch.zeros_like(n), REG_EPS),
            ("eps -0.1", p, n, -0.1), ("eps 0", p, n, 0.0),
            ("far", far_queries(verts0, NW_PLANTED, rng)[0], far_n,
             REG_EPS)]
    runs = []
    for label, q, qn, eps in sets:
        runs.append(compare_normal_weighted(
            nw, ck, nw.normal_weighted_operands(
                verts0[None], faces, q[None].contiguous(),
                qn[None].contiguous()), tail, timing=False, eps=eps,
            label=label))
    return runs


def registration_inputs(verts0, faces, rng):
    """Phase 8's queries on one posed body ``verts0`` [V, 3]: scan-like
    points, each with its face's unit normal perturbed by
    N(0, REG_NORMAL_NOISE) and renormalized; the last query is a planted
    miss: the line through (50, 0, 0) along y passes far from the body."""
    from mesh_tpu_torch.geometry.tri_normals import normalize_rows
    from mesh_tpu_torch.geometry.tri_normals import tri_normals_scaled_t

    pts, pick = surface_queries(verts0[None], faces, REG_QUERIES, rng)
    fn = normalize_rows(tri_normals_scaled_t(verts0, faces))[pick[0]]
    noise = torch.as_tensor(rng.randn(REG_QUERIES, 3) * REG_NORMAL_NOISE,
                            dtype=torch.float32, device=verts0.device)
    nrm = normalize_rows(fn + noise)
    pts, nrm = pts[0].clone(), nrm.contiguous()
    pts[-1] = torch.tensor([50.0, 0.0, 0.0])
    nrm[-1] = torch.tensor([0.0, 1.0, 0.0])
    return pts.contiguous(), nrm.contiguous()


def blended_min64(v, f, pts, nrm, faces):
    """Float64 dense check of the normal-weighted search: per query, the
    blended cost of the given face and the least over every face."""
    from mesh_tpu_torch.geometry.cross_product import cross3
    from mesh_tpu_torch.query.point_triangle import closest_point_on_triangle

    tri = v.double()[f.long()]
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    fn = cross3(b - a, c - a)
    fn = fn / (fn * fn).sum(-1, keepdim=True).sqrt().clamp_min(1e-300)
    q, n = pts.double(), nrm.double()

    def cost(qq, nn, aa, bb, cc, ff):
        _, sq, _ = closest_point_on_triangle(qq, aa, bb, cc)
        return sq.sqrt() + REG_EPS * (1.0 - (nn * ff).sum(-1))

    fl = faces.long()
    mine = cost(q, n, a[fl], b[fl], c[fl], fn[fl])
    least = torch.cat([
        cost(q[i:i + 64, None], n[i:i + 64, None], a[None], b[None],
             c[None], fn[None]).min(dim=-1).values
        for i in range(0, q.shape[0], 64)])
    return mine, least


def any_hit64(origins, dirs, tri, t_lo=0.0, near=1e-5):
    """Float64 divided-form recompute of the any-hit test: per ray [R],
    whether some face is hit with t >= t_lo, and whether some face sits
    within ``near`` of the predicate's boundary (its tightest barycentric
    or ray-parameter slack), where float32 rounding may decide either
    way."""
    from mesh_tpu_torch.geometry.cross_product import cross3

    tri = tri.double()
    a = tri[None, :, 0]
    e1, e2 = tri[None, :, 1] - a, tri[None, :, 2] - a
    blocked, border = [], []
    for i in range(0, origins.shape[0], 256):
        o = origins[i:i + 256].double()[:, None]
        d = dirs[i:i + 256].double()[:, None]
        pvec = cross3(d, e2)
        det = (e1 * pvec).sum(-1)
        valid = det.abs() >= 1e-9
        inv = 1.0 / torch.where(valid, det, torch.ones_like(det))
        s = o - a
        u = (s * pvec).sum(-1) * inv
        qvec = cross3(s, e1)
        v = (d * qvec).sum(-1) * inv
        t = (e2 * qvec).sum(-1) * inv
        slack = torch.minimum(torch.minimum(u + 1e-6, v + 1e-6),
                              torch.minimum(1.0 + 1e-6 - u - v, t - t_lo))
        blocked.append((valid & (slack >= 0)).any(dim=-1))
        border.append((valid & (slack.abs() <= near)).any(dim=-1))
    return torch.cat(blocked), torch.cat(border)


def alongnormal_hits64(v, f, pts, nrm):
    """Float64 dense recompute of the along-normal search in the divided
    form: (whether any face is hit [Q], least |t| |n| over the hits)."""
    from mesh_tpu_torch.query.ray import ray_triangle_hits

    tri = v.double()[f.long()]
    a, b, c = tri[None, :, 0], tri[None, :, 1], tri[None, :, 2]
    any_hit, least = [], []
    for i in range(0, pts.shape[0], 256):
        p = pts[i:i + 256].double()[:, None]
        n = nrm[i:i + 256].double()[:, None]
        t, hit = ray_triangle_hits(p, n, a, b, c)
        d = torch.where(hit, t.abs() * n.norm(dim=-1), float("inf"))
        any_hit.append(hit.any(dim=-1))
        least.append(d.min(dim=-1).values)
    return torch.cat(any_hit), torch.cat(least)


def moller_rows(tk, tri):
    """The Moller operand [13, N] of triangles ``tri`` [N, 3, 3] already in
    the operand's frame (no prescale): corners, unit normal, offset."""
    a, b, c, n, d = tk.tri_planes(tri.to(torch.float32))
    return torch.cat([a, b, c, n, d[..., None]], dim=-1).t().contiguous()


def tri_planted(tk, qp, fp, rng):
    """tri_tri_any_hit's planted sets on the Moller operands ``qp`` [13, Q]
    and ``fp`` [13, F] (phase 9's hand and body), as (label, query operand,
    face operand), each made in the operands' unit-box frame:

    - nan_faces: NaN in a corner of every 1009th face from face 101 and
      in the normal of every 1103rd from the middle (its chunk's box is
      NaN; a NaN plane makes the Moller test report a hit);
    - nan_queries: NaN in a corner of every 97th query from query 5 (the
      query box is NaN: every face is a candidate);
    - zero_normal: every 13th query and every 17th face with normal and
      offset 0, a degenerate triangle's operand;
    - coplanar: the first Q faces as the queries, every other one moved
      within its plane by a third of an edge (Moller's coplanar reject);
    - graze: the Q faces nearest the origin (the finest float32 grid) as
      queries with their corners moved off their planes by N(0, 2 kTriEps);
    - far: the queries moved 10 units along x, where every face plane
      clears the query box unless it is parallel to x within the margin;
    - cap: corners and offsets of both scaled by 2^99, where
      X = |n|_1 P + |d| crosses the 2^100 cap;
    - splits: 64 triangles spanning the mesh in planes near x = c, each
      meeting faces across the whole index range, so in many splits."""
    n_q, n_f = qp.shape[1], fp.shape[1]
    dev = qp.device
    ftri = fp[0:9].t().reshape(-1, 3, 3)
    sets = []
    f = fp.clone()
    f[4, 101::1009] = float("nan")
    f[10, n_f // 2::1103] = float("nan")
    sets.append(("nan_faces", qp, f))
    q = qp.clone()
    q[0, 5::97] = float("nan")
    sets.append(("nan_queries", q, fp))
    q, f = qp.clone(), fp.clone()
    q[9:13, ::13] = 0.0
    f[9:13, ::17] = 0.0
    sets.append(("zero_normal", q, f))
    take = torch.arange(min(n_q, n_f), device=dev)
    tri = ftri[take].clone()
    shift = (tri[:, 1] - tri[:, 0]) / 3.0
    tri[1::2] += shift[1::2, None]
    sets.append(("coplanar", moller_rows(tk, tri), fp))
    near = torch.argsort(ftri.mean(dim=1).norm(dim=-1))[:n_q]
    tri = ftri[near].clone()
    n = fp[9:12, near].t()
    lift = torch.as_tensor(rng.randn(len(near), 3) * 2e-9,
                           dtype=torch.float32, device=dev)
    tri += lift[..., None] * n[:, None, :]
    sets.append(("graze", moller_rows(tk, tri), fp))
    q = qp.clone()
    q[0:9:3] += 10.0
    q[12] -= 10.0 * q[9]          # the offset of the moved plane
    sets.append(("far", q, fp))
    q, f = qp.clone(), fp.clone()
    for t in (q, f):
        t[0:9] *= 2.0 ** 99
        t[12] *= 2.0 ** 99
    sets.append(("cap", q, f))
    c = torch.as_tensor(rng.uniform(-0.9, 0.9, 64), dtype=torch.float32,
                        device=dev)
    tilt = torch.as_tensor(rng.uniform(-0.05, 0.05, (64, 1, 2)),
                           dtype=torch.float32, device=dev)
    base = torch.tensor([[0.0, -3.0, -3.0], [0.0, 6.0, -3.0],
                         [0.0, -3.0, 6.0]], device=dev)
    tri = base[None].repeat(64, 1, 1)
    tri[..., 0] = c[:, None] + (tilt * base[None, :, 1:]).sum(dim=-1)
    sets.append(("splits", moller_rows(tk, tri), fp))
    return sets


def records_match(a, b):
    """Two chunk records [C, 8] of the tri_tri_any_hit cull: the box words
    equal as values (NaN where NaN; a zero's sign is free), the masks bit
    for bit."""
    box_a, box_b = a[:, :7], b[:, :7]
    nan = torch.isnan(box_a)
    return (torch.equal(nan, torch.isnan(box_b))
            and torch.equal(box_a[~nan], box_b[~nan])
            and torch.equal(a.view(torch.int32)[:, 7],
                            b.view(torch.int32)[:, 7]))


def compare_tri_tri(tk, qp, fp, algorithm, label, timing):
    """tri_tri_any_hit on one operand set: flags and first hits (tested)
    identical to the every-pair plain version and to the every-pair kernel
    (``tri_tri_any_hit_every``).  The Moller tile's cull runs on
    ``tri_any_hit_operands``, whose records kernel must equal
    ``tri_records_plain`` (``records_match``; the face records bit for
    bit), and the kernel must equal the plain version of its design
    (``tri_tri_any_hit_culled_plain``: flags, first hits, warp and lane
    counts) at ``TRI_SPLIT``.

    With ``timing``: the kernel alone (queued, each launch into the same
    first-hit buffer), every split of TRI_SPLITS (each held to its plain
    version too), the wrapper with the operands made in it (what a facade
    call runs on the card), the operands alone, the records kernel alone,
    the every-pair kernel and the plain versions.  Bounds against the
    bytes: the lanes' work (each lane's box test of every chunk with a
    candidate x 38, the pairs its lane ran through the plane sides x 64,
    those reaching the interval part x 168), the warps' issued work (the
    candidate slots of the chunks each warp took x 32 lanes instead of the
    lanes' pairs) and every pair x 232 (the segment tile: the pairs it
    tests x 428)."""
    from mesh_tpu_torch import _build

    name = "tri_tri_any_hit[%s]" % algorithm
    every, every_plain_ms = timed(
        lambda: tk.tri_tri_any_hit_plain(qp, fp, algorithm))
    oracle = tk.tri_tri_any_hit_every(qp, fp, algorithm)
    n_q, n_f = qp.shape[-1], fp.shape[-1]
    out = {"tile": algorithm, "on": label, "shape": [n_q, n_f],
           "flags_identical": True, "every_pair_identical": True,
           "max_abs_err": 0.0, "pairs": n_q * n_f,
           "every_plain_ms": every_plain_ms}
    if algorithm == "segment":
        k = tk.tri_tri_any_hit(qp, fp, algorithm)
        check(all(torch.equal(x, y) and torch.equal(x, z)
                  for x, y, z in zip(k, every, oracle)),
              "%s on %s: %d of %d flags (%d first hits) differ from the "
              "every-pair plain version, %d from the every-pair kernel" % (
                  name, label, int((k[0] != every[0]).sum()), n_q,
                  int((k[1] != every[1]).sum()),
                  int((k[0] != oracle[0]).sum())))
        tested = int(k[1].sum())
        out.update(hit=int(k[0].sum()), pairs_tested=tested,
                   plain_ms=every_plain_ms)
        if timing:
            n_bytes = 4 * (qp.numel() + fp.numel() + 2 * n_q)
            out["ms"] = cuda_ms(lambda: tk.tri_tri_any_hit(
                qp, fp, algorithm), reps=REPS)
            out["every_ms"] = cuda_ms(lambda: tk.tri_tri_any_hit_every(
                qp, fp, algorithm), reps=REPS)
            out["bound_ms"], out["bound_by"] = bound_ms(
                tested, TRI_PAIR_OPS[algorithm], n_bytes)
        log("  %s on %s %s: flags and first hits identical to every pair "
            "(plain and kernel), %d hit, %d of %d pairs tested, plain %.1f "
            "ms%s" % (name, label, out["shape"], out["hit"], tested,
                      n_q * n_f, every_plain_ms, "" if not timing else
                      ", %.3f ms (every-pair kernel %.3f, bound %.4f ms)"
                      % (out["ms"], out["every_ms"], out["bound_ms"])))
        return out

    ops = tk.tri_any_hit_operands(qp, fp)
    (faces_p, chunks_p), records_plain_ms = timed(
        lambda: tk.tri_records_plain(ops["qlo"], ops["qhi"], fp))
    check(same_bits(ops["faces"], faces_p)
          and records_match(ops["chunks"], chunks_p),
          "tri_records on %s: the records differ from the plain version "
          "(faces %s, chunks %s)" % (label, same_bits(ops["faces"], faces_p),
                                     records_match(ops["chunks"], chunks_p)))

    def against_plain(split):
        k = tk.tri_tri_any_hit(qp, fp, algorithm, ops=ops, split=split,
                               with_stats=True)
        p, plain_ms = timed(
            lambda: tk.tri_tri_any_hit_culled_plain(qp, ops, split))
        check(all(torch.equal(x, y) for x, y in zip(k, p)),
              "%s on %s, split %d: %d of %d flags (%d first hits, %s warp "
              "and lane counts) differ from the plain version of the cull"
              % (name, label, split, int((k[0] != p[0]).sum()), n_q,
                 int((k[1] != p[1]).sum()),
                 [int((x != y).sum()) for x, y in zip(k[2:], p[2:])]))
        return k, plain_ms

    k, plain_ms = against_plain(tk.TRI_SPLIT)
    check(torch.equal(k[0], every[0]) and torch.equal(k[1], every[1])
          and torch.equal(k[0], oracle[0]) and torch.equal(k[1], oracle[1]),
          "%s on %s: %d of %d flags (%d first hits) differ from the "
          "every-pair plain version, %d (%d) from the every-pair kernel" % (
              name, label, int((k[0] != every[0]).sum()), n_q,
              int((k[1] != every[1]).sum()), int((k[0] != oracle[0]).sum()),
              int((k[1] != oracle[1]).sum())))
    bits = tk._mask_bits(ops["chunks"])
    n_c = ops["chunks"].shape[0]
    nonempty = int((bits.view(n_c, -1).any(dim=1)).sum())
    warp_chunks, warp_slots = (int(x) for x in k[2].sum(dim=0))
    lane_pairs, deep = (int(x) for x in k[3].sum(dim=0))
    out.update(
        hit=int(k[0].sum()), pairs_tested=int(k[1].sum()),
        split=tk.TRI_SPLIT, plain_ms=plain_ms,
        records_plain_ms=records_plain_ms, candidates=int(bits.sum()),
        chunks=n_c, chunks_with_candidates=nonempty,
        warp_chunks=warp_chunks, warp_slots=warp_slots,
        lane_pairs=lane_pairs, deep_pairs=deep)
    out["candidate_share"] = out["candidates"] / n_f
    out["warp_share"] = warp_chunks / (k[2].shape[0] * n_c)
    out["lane_share"] = lane_pairs / out["pairs"]
    out["issued_share"] = warp_slots * tk.WARP / out["pairs"]
    out["deep_share"] = deep / out["pairs"]
    if timing:
        n_bytes = 4 * (qp.numel() + ops["faces"].numel()
                       + ops["chunks"].numel() + n_q)
        tests = n_q * nonempty * SELF_BOX_OPS

        def work(pairs, deep_):
            return (tests + pairs * MOLLER_SIDES_OPS
                    + deep_ * MOLLER_INTERVAL_OPS)

        first = torch.empty(n_q, dtype=torch.int32, device=qp.device)

        def kernel_alone(split):
            _build.launch("tri_tri_any_hit", qp.device, qp, ops["faces"],
                          ops["chunks"], first, None, None, n_q, n_f, n_c,
                          split, 1, tk.T_LO, tk.T_HI)

        out["splits"] = {}
        for split in TRI_SPLITS:
            ks, split_plain_ms = against_plain(split)
            pairs_s, deep_s = (int(x) for x in ks[3].sum(dim=0))
            out["splits"][split] = {
                "ms": queued_ms(lambda: kernel_alone(split), reps=100),
                "plain_ms": split_plain_ms,
                "warp_share": int(ks[2][:, 0].sum()) / (ks[2].shape[0]
                                                        * n_c),
                "lane_share": pairs_s / out["pairs"],
                "bound_ms": bound_ms(work(pairs_s, deep_s), 1, n_bytes)[0],
                "bound_issued_ms": bound_ms(work(
                    int(ks[2][:, 1].sum()) * tk.WARP, deep_s), 1,
                    n_bytes)[0]}
        out["ms"] = queued_ms(lambda: kernel_alone(tk.TRI_SPLIT), reps=100)
        out["wrapper_ms"] = queued_ms(lambda: tk.tri_tri_any_hit(
            qp, fp, algorithm, ops=ops), reps=100)
        out["with_operands_ms"] = cuda_ms(lambda: tk.tri_tri_any_hit(
            qp, fp, algorithm), reps=REPS)
        out["operands_ms"] = cuda_ms(lambda: tk.tri_any_hit_operands(qp, fp),
                                     reps=REPS)
        out["records_ms"] = queued_ms(lambda: tk.tri_records(
            ops["qlo"], ops["qhi"], fp), reps=100)
        out["records_bound_ms"], out["records_bound_by"] = bound_ms(
            0, 0, 4 * (6 + fp.numel() + ops["faces"].numel()
                       + ops["chunks"].numel()))
        out["every_ms"] = cuda_ms(lambda: tk.tri_tri_any_hit_every(
            qp, fp, algorithm), reps=REPS)
        out["bound_ms"], out["bound_by"] = bound_ms(work(lane_pairs, deep),
                                                    1, n_bytes)
        out["bound_issued_ms"] = bound_ms(
            work(warp_slots * tk.WARP, deep), 1, n_bytes)[0]
        out["bound_every_pair_ms"] = bound_ms(
            out["pairs"], TRI_PAIR_OPS[algorithm],
            4 * (qp.numel() + fp.numel() + 2 * n_q))[0]
    log("  %s on %s %s: flags, first hits and counts identical to the "
        "plain version of the cull, flags and first hits to every pair "
        "(plain and kernel); %d hit; %d candidate faces (%.4f), %d of %d "
        "chunks hold one; warps take %.4f of the warp-chunks and issue "
        "%.5f of the pairs, lanes run %.5f, %.2g reach the interval part; "
        "plain %.1f ms, every-pair plain %.1f ms%s" % (
            name, label, out["shape"], out["hit"], out["candidates"],
            out["candidate_share"], nonempty, n_c, out["warp_share"],
            out["issued_share"], out["lane_share"], out["deep_share"],
            plain_ms, every_plain_ms, "" if not timing else
            "; %.4f ms at split %d (splits %s; wrapper %.4f, with its "
            "operands %.4f, operands %.4f, records kernel %.4f; every-pair "
            "kernel %.4f; bound %.5f ms per lane, %.5f issued, %.4f every "
            "pair)" % (
                out["ms"], tk.TRI_SPLIT, ", ".join(
                    "%d: %.4f" % (sp, r["ms"])
                    for sp, r in out["splits"].items()),
                out["wrapper_ms"], out["with_operands_ms"],
                out["operands_ms"], out["records_ms"], out["every_ms"],
                out["bound_ms"], out["bound_issued_ms"],
                out["bound_every_pair_ms"])))
    return out


def compare_self(tk, tri, ids, algorithm, label, plain_range=False):
    """Kernel vs plain for self_intersect on every face of a mesh against
    all its faces, in the kernel's (Morton) face order: identical per-face
    counts, warp tiles and work per face to the plain version of its
    design, and identical counts to the every-pair plain version; the
    kernel on the query range [F / 4, F / 2) (not whole warps) must give
    that slice of the counts.  With ``plain_range`` the plain versions run
    on that range rounded to whole warps only, so that their warps line up
    with the kernel's.

    The bound counts the work these inputs need under the cull, per query
    lane: the Moller box test of every tile, the id tests of the pairs of
    the tiles it takes, the plane sides (or the whole segment test) of the
    pairs past them and the interval part of those on neither side.  The
    warp-tiles the warps issue are reported beside it, and so is every
    pair of the reference's design.  Returns (the run's record, the counts
    in the mesh's face order)."""
    order = tk.morton_face_order(tri)
    tri, ids = tri[order], ids[order].contiguous()
    qp, fp = tk.self_planes(tri, algorithm)
    n_f = tri.shape[0]
    r0, r1 = n_f // 4, n_f // 2
    p0, p1 = ((r0 // tk.WARP * tk.WARP, r1 // tk.WARP * tk.WARP)
              if plain_range else (0, n_f))
    k, kt, kw = tk.self_intersect_counts(qp, fp, ids, algorithm,
                                         with_stats=True)
    (p, pt, pw), plain_ms = timed(lambda: tk.self_intersect_culled_plain(
        qp, fp, ids, algorithm, p0, p1))
    e, every_ms = timed(lambda: tk.self_intersect_counts_plain(
        qp, fp, ids, algorithm, p0, p1))
    w0 = p0 // tk.WARP
    check(torch.equal(k[p0:p1], p)
          and torch.equal(kw[p0:p1], pw)
          and torch.equal(kt[w0:w0 + pt.numel()], pt),
          "self_intersect[%s] on %s: %d of %d counts (%d work, %d "
          "warp-tile counts) differ from the plain version" % (
              algorithm, label, int((k[p0:p1] != p).sum()), p.numel(),
              int((kw[p0:p1] != pw).any(dim=1).sum()),
              int((kt[w0:w0 + pt.numel()] != pt).sum())))
    check(torch.equal(k[p0:p1], e), "self_intersect[%s] on %s: %d of %d "
          "counts differ from the every-pair plain version" % (
              algorithm, label, int((k[p0:p1] != e).sum()), e.numel()))
    for q0, q1 in {(r0, r1), (p0, p1)} - {(0, n_f)}:
        check(torch.equal(tk.self_intersect_counts(qp, fp, ids, algorithm,
                                                   q0, q1), k[q0:q1]),
              "self_intersect[%s] on %s: the query range [%d, %d) differs "
              "from the whole mesh's counts" % (algorithm, label, q0, q1))
    n_tiles = -(-n_f // tk.SELF_TILE)
    warp_tiles = int(kt.sum())
    taken, reached, deep = (int(x) for x in kw.sum(dim=0))
    out = {"tile": algorithm, "on": label, "shape": [n_f, n_f],
           "counts_identical": True, "max_abs_err": 0.0,
           "involved": int((k > 0).sum()), "partners": int(k.sum()),
           "pairs": n_f * n_f, "plain_ms": plain_ms,
           "every_pair_plain_ms": every_ms, "plain_query_faces": p1 - p0,
           "query_range": [r0, r1],
           "warp_tiles_tested": warp_tiles,
           "warp_tiles": kt.numel() * n_tiles,
           "pairs_issued": warp_tiles * tk.WARP * tk.SELF_TILE,
           "pairs_taken": taken, "pairs_reached": reached,
           "deep_pairs": deep,
           "ms": cuda_ms(lambda: tk.self_intersect_counts(
               qp, fp, ids, algorithm), reps=3)}
    out["tile_fraction"] = warp_tiles / out["warp_tiles"]
    out["pair_fraction"] = taken / out["pairs"]
    out["deep_fraction"] = deep / out["pairs"]
    n_bytes = 4 * (qp.numel() + fp.numel() + ids.numel() + n_f)
    out["bound_every_pair_ms"], _ = bound_ms(
        n_f * n_f, SELF_PAIR_OPS[algorithm], n_bytes)
    if algorithm == "moller":
        work = (n_f * n_tiles * SELF_BOX_OPS + taken * SELF_ID_OPS
                + reached * MOLLER_SIDES_OPS
                + deep * (MOLLER_INTERVAL_OPS + 1))
    else:
        work = (taken * SELF_ID_OPS
                + reached * (TRI_PAIR_OPS["segment"] + 1))
    out["bound_ms"], out["bound_by"] = bound_ms(work, 1, n_bytes)
    log("  self_intersect[%s] on %s %s: counts, warp tiles and work "
        "identical (plain on %d query faces; counts also to every pair; "
        "query range [%d, %d)), %d faces involved, %d partners; warp-tiles "
        "tested %d of %d (%.4f); pairs per lane taken %d (%.4f), past the "
        "exclusion %d, to the interval part %d (%.3g); %.3f ms (plain %.1f "
        "ms, every-pair plain %.1f ms, bound %.4f ms, every pair %.4f ms)"
        % (algorithm, label, out["shape"], p1 - p0, r0, r1, out["involved"],
           out["partners"], warp_tiles, out["warp_tiles"],
           out["tile_fraction"], taken, out["pair_fraction"], reached, deep,
           out["deep_fraction"], out["ms"], plain_ms, every_ms,
           out["bound_ms"], out["bound_every_pair_ms"]))
    counts = torch.empty_like(k)
    counts[order] = k
    return out, counts


def decide64(tile, q_tri, tri, q_ids=None, f_ids=None, q_index=None):
    """Float64 decision of ``tile``'s predicate for each query triangle
    [Q, 3, 3] against every face [F, 3, 3]: (any hit [Q], borderline [Q]),
    bool on the CPU.

    - segment: the divided segment form (query/ray.py tri_tri_intersects):
      a pair's slack is the best of its six segment tests' least margin
      (u, v, 1 - u - v, t, 1 - t, each with the 1e-9 tolerance; a test
      with |det| under 1e-9 counts -inf); a query hits iff its largest
      slack is >= 0, and moving every tolerance by TOL_MOVE flips that
      only where |slack| < TOL_MOVE: borderline.
    - moller: Moller's interval test on the triangles prescaled together
      into the unit box, as the tile's prologue does
      (tri_tri_intersects_moller); borderline where moving the plane
      thickening from 1e-9 to 0 or to 1e-9 + TOL_MOVE changes the
      decision.

    With ``q_ids`` / ``f_ids`` (vertex ids) and ``q_index`` (the queries'
    face indices), faces sharing a vertex with the query, or the query
    itself, are left out, as the self-intersection count does."""
    from mesh_tpu_torch.geometry.cross_product import cross3
    from mesh_tpu_torch.query import tri_tri_kernel as tk

    eps = 1e-9
    q_all, tri = q_tri.double(), tri.double()
    if tile == "moller":
        q_all, tri = tk.moller_prescale(q_all, tri)
        planes = tk.tri_planes(tri[None])
    hits, borders = [], []
    chunk = max(1, (1 << 22) // max(1, tri.shape[0]))
    for i in range(0, q_all.shape[0], chunk):
        q = q_all[i:i + chunk][:, None]                     # [c, 1, 3, 3]
        excluded = torch.zeros((q.shape[0], tri.shape[0]), dtype=torch.bool,
                               device=tri.device)
        if q_ids is not None:
            qi = q_ids[i:i + chunk].long()
            excluded = (qi[:, :, None, None] == f_ids.long()[None, None]).any(
                dim=1).any(dim=-1)
            excluded |= (q_index[i:i + chunk, None].long()
                         == torch.arange(tri.shape[0], device=tri.device))
        if tile == "moller":
            qp = tk.tri_planes(q)
            flags = [((tk.moller_hit(*(tuple(x[..., k] for k in range(3))
                                       for x in qp[:4]), qp[4],
                                     *(tuple(x[..., k] for k in range(3))
                                       for x in planes[:4]), planes[4], e)
                       & ~excluded).any(dim=-1))
                     for e in (eps, 0.0, eps + TOL_MOVE)]
            hits.append(flags[0])
            borders.append((flags[1] != flags[0]) | (flags[2] != flags[0]))
            continue
        m = tri[None]                                       # [1, F, 3, 3]
        pair = None
        for src, dst in ((q, m), (m, q)):
            a = dst[..., 0, :]
            e1, e2 = dst[..., 1, :] - a, dst[..., 2, :] - a
            for c in range(3):
                s0 = src[..., c, :]
                d = src[..., (c + 1) % 3, :] - s0
                pvec = cross3(d, e2)
                det = (e1 * pvec).sum(-1)
                valid = det.abs() >= eps
                inv = 1.0 / torch.where(valid, det, torch.ones_like(det))
                sv = s0 - a
                u = (sv * pvec).sum(-1) * inv
                qvec = cross3(sv, e1)
                v = (d * qvec).sum(-1) * inv
                t = (e2 * qvec).sum(-1) * inv
                slack = torch.minimum(
                    torch.minimum(torch.minimum(u + eps, v + eps),
                                  1.0 + eps - (u + v)),
                    torch.minimum(t + eps, 1.0 + eps - t))
                slack = torch.where(valid, slack,
                                    torch.full_like(slack, -float("inf")))
                pair = slack if pair is None else torch.maximum(pair, slack)
        best = torch.where(excluded, torch.full_like(pair, -float("inf")),
                           pair).max(dim=-1).values
        hits.append(best >= 0)
        borders.append(best.abs() < TOL_MOVE)
    return torch.cat(hits).cpu(), torch.cat(borders).cpu()


def check_against64(name, flags, decided):
    """Per-query flags [Q] against a float64 decision (any hit [Q],
    borderline [Q]) of ``decide64``: equal except on borderline queries.
    Returns (flags that differ, borderline queries)."""
    exact, border = decided
    differ = flags.cpu() != exact
    off = differ & ~border
    check(not bool(off.any()), "%s: %d of %d flags differ from the float64 "
          "recompute away from the borderline band (queries %s)" % (
              name, int(off.sum()), flags.numel(),
              off.nonzero()[:5, 0].tolist()))
    return int(differ.sum()), int(border.sum())


def contact_inputs(dev):
    """Phase 9's meshes, as examples/hand_body_contact.py makes them: an
    SMPL-sized body (betas N(0, 0.3), rest pose) and a MANO-sized hand
    (pose N(0, 0.05)) offset against its flank -> (body_v, body_f, hand_v,
    hand_f) numpy, float32 vertices and uint32 faces."""
    from mesh_tpu_torch.models import lbs, synthetic_family_model

    body_model = synthetic_family_model("smpl", device=dev)
    hand_model = synthetic_family_model("mano", device=dev)
    rng = np.random.RandomState(0)
    body_v = lbs(body_model,
                 torch.as_tensor(rng.randn(1, body_model.num_betas) * 0.3,
                                 dtype=torch.float32, device=dev),
                 torch.zeros((1, body_model.num_joints, 3), device=dev),
                 device=dev)[0][0].cpu().numpy()
    hand_v = lbs(hand_model,
                 torch.zeros((1, hand_model.num_betas), device=dev),
                 torch.as_tensor(rng.randn(1, hand_model.num_joints, 3)
                                 * 0.05, dtype=torch.float32, device=dev),
                 device=dev)[0][0].cpu().numpy()
    hand_v = hand_v + np.array(CONTACT_OFFSET)
    return (body_v, body_model.faces.cpu().numpy().astype(np.uint32),
            hand_v, hand_model.faces.cpu().numpy().astype(np.uint32))


def contact_step(body, hand, dev):
    """examples/hand_body_contact.py steps 1-2 through the port: the
    intersecting hand faces, then the signed gap of every hand vertex to
    the body (closest point, signed by the closest face's normal)."""
    from mesh_tpu_torch.geometry import tri_normals

    tree = body.compute_aabb_tree()
    hit_faces = tree.intersections_indices(hand.v, hand.f)
    f_idx, points = tree.nearest(hand.v)
    gap = np.linalg.norm(np.asarray(hand.v) - points, axis=1)
    face_normals = tri_normals(body.v, body.f.astype(np.int32),
                               device=dev).cpu().numpy()
    inside = np.sum((np.asarray(hand.v) - points)
                    * face_normals[np.asarray(f_idx).ravel()], axis=1) < 0
    signed = np.where(inside, -gap, gap)
    return hit_faces, signed


def refit_tri_s(v, f, index, dev):
    """The leaf-box kernel's operand for vertices ``v`` and faces ``f``
    (arrays or tensors) over ``index``'s layout: the corners in its
    centered frame and Morton order, [Fp, 3, 3] float32 on ``dev``, as the
    refit gathers them."""
    arr = index.on(dev)
    vc = torch.as_tensor(v, dtype=torch.float32, device=dev) - arr["center"]
    f_t = torch.as_tensor(f, device=dev).long()
    return vc[f_t[arr["order"].long()]].contiguous()


def boxes_equal(a, b):
    """Equal values (so -0.0 == 0.0) and NaN in the same places."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan], b[~nan]))


def compare_leaf_boxes(tri_s, n_leaves, leaf, label, nan_leaves=None,
                       timing=False):
    """Kernel vs plain for leaf_boxes on one operand: every leaf's lo and
    hi equal (NaN where the plain version has NaN; with ``nan_leaves``,
    exactly those leaves), timed with the library call when ``timing``."""
    from mesh_tpu_torch.accel import refit_kernel as fk

    klo, khi = fk.leaf_boxes_kernel(tri_s, n_leaves, leaf)
    (plo, phi), plain_ms = timed(
        lambda: fk.leaf_boxes_plain(tri_s, n_leaves, leaf))
    wlo, whi = fk.leaf_boxes_warp_kernel(tri_s, n_leaves, leaf)
    for name, (lo, hi) in (("plain version", (plo, phi)),
                           ("warp-a-leaf oracle", (wlo, whi))):
        check(boxes_equal(klo, lo) and boxes_equal(khi, hi),
              "leaf_boxes on %s: %d of %d leaves differ from the %s"
              % (label, int(((klo != lo) | (khi != hi)).any(dim=1).sum()),
                 n_leaves, name))
    nan = (torch.isnan(klo) | torch.isnan(khi)).any(dim=1)
    if nan_leaves is not None:
        want = torch.zeros(n_leaves, dtype=torch.bool, device=nan.device)
        want[nan_leaves] = True
        check(torch.equal(nan, want), "leaf_boxes on %s: NaN in leaves %s, "
              "planted in %s" % (label, nan.nonzero()[:, 0].tolist(),
                                 sorted(nan_leaves)))
    fin = ~nan
    out = {"on": label, "shape": [tri_s.shape[0], n_leaves, leaf],
           "plan": list(fk.leaf_plan(tri_s, leaf)),
           "leaves_identical": True, "nan_leaves": int(nan.sum()),
           "max_abs_err": float(torch.maximum(
               (klo[fin] - plo[fin]).abs().max(),
               (khi[fin] - phi[fin]).abs().max())), "plain_ms": plain_ms}
    if timing:
        blocks = tri_s.view(n_leaves, leaf * 3, 3)
        # microseconds of work each, timed with tri_s out of L2 (the HBM
        # bound's regime); the kernel also back to back with tri_s left in
        # L2, as a frame finds it just after the gather wrote it
        out["ms"] = cold_ms(lambda: fk.leaf_boxes_kernel(
            tri_s, n_leaves, leaf), reps=100)
        out["plain_ms"] = cold_ms(lambda: fk.leaf_boxes_plain(
            tri_s, n_leaves, leaf), reps=100)
        out["library_ms"] = cold_ms(lambda: torch.aminmax(blocks, dim=1),
                                    reps=100)
        out["l2_warm_ms"] = queued_ms(lambda: fk.leaf_boxes_kernel(
            tri_s, n_leaves, leaf), reps=100)
        out["warp_ms"] = cold_ms(lambda: fk.leaf_boxes_warp_kernel(
            tri_s, n_leaves, leaf), reps=100)
        out["warp_l2_warm_ms"] = queued_ms(
            lambda: fk.leaf_boxes_warp_kernel(tri_s, n_leaves, leaf),
            reps=100)
        # the library calls in both regimes, beside the kernel's
        out["library_l2_warm_ms"] = queued_ms(
            lambda: torch.aminmax(blocks, dim=1), reps=100)
        out["amin_amax_ms"] = cold_ms(
            lambda: (blocks.amin(dim=1), blocks.amax(dim=1)), reps=100)
        out["amin_amax_l2_warm_ms"] = queued_ms(
            lambda: (blocks.amin(dim=1), blocks.amax(dim=1)), reps=100)
        n_bytes = 4 * (tri_s.numel() + 6 * n_leaves)
        out["bound_ms"], out["bound_by"] = bound_ms(
            tri_s.numel(), LEAF_BOX_OPS, n_bytes)
    log("  leaf_boxes on %s %s, plan %s: every leaf identical to the plain "
        "version and the oracle (%d NaN)%s" % (
            label, out["shape"], out["plan"], out["nan_leaves"],
            "" if not timing else
            ", L2 flushed: %.4f ms (oracle %.4f ms, plain %.4f ms, aminmax "
            "%.4f ms, amin + amax %.4f ms, HBM bound %.4f ms); L2 warm, back "
            "to back: %.4f ms (oracle %.4f ms, aminmax %.4f ms, amin + amax "
            "%.4f ms)"
            % (out["ms"], out["warp_ms"], out["plain_ms"],
               out["library_ms"], out["amin_amax_ms"], out["bound_ms"],
               out["l2_warm_ms"], out["warp_l2_warm_ms"],
               out["library_l2_warm_ms"], out["amin_amax_l2_warm_ms"])))
    return out


def anim_stream(model, dev, seed):
    """Phase 11's stream for one body model: the rest keyframe (betas
    N(0, 0.3), zero pose; numpy [V, 3]) and a generator of ANIM_FRAMES
    (posed vertices [V, 3], queries [Q, 3]) on the card: lbs along the
    straight line between two N(0, ANIM_POSE_SIGMA) poses, frame
    ANIM_STRETCH_FRAME stretched ANIM_STRETCH times, surface-proximal
    queries on each frame's surface."""
    from mesh_tpu_torch.models import lbs

    rng = np.random.RandomState(seed)
    betas = torch.as_tensor(rng.randn(1, model.num_betas) * 0.3,
                            dtype=torch.float32, device=dev)
    poses = [torch.as_tensor(rng.randn(1, model.num_joints, 3)
                             * ANIM_POSE_SIGMA, dtype=torch.float32,
                             device=dev) for _ in range(2)]
    rest = lbs(model, betas, torch.zeros_like(poses[0]), device=dev)[0][0]

    def pose(k):
        t = k / float(ANIM_FRAMES - 1)
        return (1.0 - t) * poses[0] + t * poses[1]

    def frames():
        for k in range(ANIM_FRAMES):
            v = lbs(model, betas, pose(k), device=dev)[0][0]
            if k == ANIM_STRETCH_FRAME:
                v = v * ANIM_STRETCH
            q, _ = surface_queries(v[None], model.faces, ANIM_QUERIES, rng)
            yield v, q[0]

    return rest.cpu().numpy(), frames, (betas, pose)


def drive_anim(label, model, leaf, dev, seed):
    """One avatar session (the default leaf-box route, leaves of ``leaf``) over
    phase 11's stream, then ANIM_COLD_FRAMES cold frames (the first
    frames again) under MESH_TPU_ANIM=0.  Returns the session's keyframe,
    faces, the frames (vertices, queries, result, whether an index was
    built during the frame) and the cold frames."""
    from mesh_tpu_torch import Mesh
    from mesh_tpu_torch.accel.build import index_cache_info
    from mesh_tpu_torch.anim import AvatarSession

    rest, frames, _ = anim_stream(model, dev, seed)
    f_np = model.faces.cpu().numpy()
    sess = AvatarSession(Mesh(rest, f_np, device=dev), leaf_size=leaf,
                         device=dev)
    run = []
    for v, q in frames():
        keys = index_cache_info()["keys"]
        out = sess.frame(vertices=v, points=q, deadline_s=ANIM_DEADLINE_S)
        run.append({"v": v, "q": q, "out": out,
                    "built": index_cache_info()["keys"] != keys})
    anim = os.environ.get("MESH_TPU_ANIM")
    os.environ["MESH_TPU_ANIM"] = "0"
    try:
        cold = [sess.frame(vertices=fr["v"], points=fr["q"],
                           deadline_s=ANIM_DEADLINE_S)
                for fr in run[:ANIM_COLD_FRAMES]]
    finally:
        if anim is None:
            del os.environ["MESH_TPU_ANIM"]
        else:
            os.environ["MESH_TPU_ANIM"] = anim
    sess.stop()
    stats = sess.stats()
    log("  %s: %d frames (%d refits, %d rebuilds) + %d cold, %d over the "
        "deadline" % (label, len(run), stats["refits"], stats["rebuilds"],
                      len(cold), stats["deadline_misses"]))
    return rest, f_np, run, cold


def leaf_boxes_of(index, dev):
    """The leaf boxes of ``index``, (lo, hi) [n_leaves, 3] on ``dev``,
    read from its node arrays in leaf order."""
    arr = index.on(dev)
    is_leaf = arr["node_leaf"] >= 0
    order = torch.argsort(arr["node_leaf"][is_leaf])
    return arr["node_lo"][is_leaf][order], arr["node_hi"][is_leaf][order]


def check_anim(label, model, leaf, rest, f_np, run, cold, dev):
    """Phase 11's checks of one session: every frame's answers against the
    brute-force kernel, its boxes against a ``kernel="host"`` refit, every
    face inside its leaf box, no index built on a refit frame, and the
    actions and inflations of a ``kernel="host"`` session fed the same
    frames.  Returns the session's summary."""
    from mesh_tpu_torch import Mesh
    from mesh_tpu_torch.anim import AvatarSession, refit_bvh
    from mesh_tpu_torch.query import closest_kernel as ck

    f = model.faces
    actions = [fr["out"]["action"] for fr in run]
    check(actions.count("refit") and actions.count("rebuild"),
          "%s: actions %s want both refit and rebuild" % (label, actions))
    check(actions[ANIM_STRETCH_FRAME] == "rebuild",
          "%s: the stretched frame %s" % (label, actions[ANIM_STRETCH_FRAME]))
    check(all(c["action"] == "cold" for c in cold), "%s: cold frames" % label)
    worst = {"sqdist_gap": 0.0, "faces_differ": 0, "tie_gap": 0.0}
    for k, fr in enumerate(run + [dict(fr, out=c) for fr, c in
                                  zip(run, cold)]):
        v, q, out = fr["v"], fr["q"], fr["out"]
        name = "%s frame %d (%s)" % (label, k, out["action"])
        check(out["faces"].shape == (ANIM_QUERIES,)
              and bool(np.isfinite(out["sqdist"]).all()), name + " result")
        brute = ck.closest_point_kernel(v[None], f, q[None])
        got = check_against_brute(
            name, v[None], f, q[None],
            torch.as_tensor(out["faces"], device=dev)[None],
            torch.as_tensor(out["sqdist"], device=dev)[None], brute,
            quiet=True)
        worst["sqdist_gap"] = max(worst["sqdist_gap"], got["sqdist_gap"])
        worst["tie_gap"] = max(worst["tie_gap"], got["tie_gap"])
        worst["faces_differ"] += got["faces_differ"]
        index = out["index"]
        check(int(index.meta["leaf_size"]) == leaf, name + " leaf size")
        if out["action"] == "refit":
            check(not fr["built"], name + ": an index was built")
            host, _ = refit_bvh(index, v.cpu().numpy(), f_np, kernel="host",
                                device=dev)
            check(all(np.array_equal(host.arrays[n], index.arrays[n])
                      for n in ("node_lo", "node_hi")),
                  name + ": boxes differ from the host refit")
        lo, hi = leaf_boxes_of(index, dev)
        corners = refit_tri_s(v, f_np, index, dev).view(
            lo.shape[0], -1, 3)
        check(bool(((corners >= lo[:, None]) & (corners <= hi[:, None]))
                   .all()), name + ": a corner outside its leaf box")
    host = AvatarSession(Mesh(rest, f_np, device=dev), leaf_size=leaf,
                         kernel="host", device=dev)
    for fr in run:
        mine = fr["out"]
        out = host.frame(vertices=fr["v"])
        check(out["action"] == mine["action"]
              and out["inflation"] == mine["inflation"],
              "%s frame %d: host session %s %.17g, kernel session %s %.17g"
              % (label, mine["frame"], out["action"], out["inflation"],
                 mine["action"], mine["inflation"]))
    host.stop()
    lat = [fr["out"]["latency_s"] * 1e3 for fr in run]
    refit_lat = [fr["out"]["latency_s"] * 1e3 for fr in run
                 if fr["out"]["action"] == "refit"]
    cold_lat = [c["latency_s"] * 1e3 for c in cold]
    summary = {
        "faces": int(f.shape[0]), "leaf_size": leaf,
        "n_leaves": int(run[0]["out"]["index"].meta["n_leaves"]),
        "frames": len(run), "refits": actions.count("refit"),
        "rebuilds": actions.count("rebuild"),
        "rebuild_frames": [k for k, a in enumerate(actions)
                           if a == "rebuild"],
        "inflation_max": max(fr["out"]["inflation"] for fr in run),
        "frame_ms_median": statistics.median(lat),
        "frame_ms_p95": float(np.percentile(lat, 95)),
        "frame_ms_max": max(lat),
        "refit_frame_ms_median": statistics.median(refit_lat),
        "deadline_misses": sum(fr["out"]["deadline_missed"] for fr in run),
        "deadline_miss_frames": [k for k, fr in enumerate(run)
                                 if fr["out"]["deadline_missed"]],
        "cold_frame_ms_median": statistics.median(cold_lat),
        "cold_over_refit": statistics.median(cold_lat)
        / statistics.median(refit_lat),
        "vs_brute": worst}
    log("  %s (%d faces, leaf %d): actions equal the host session's; all "
        "%d frames + %d cold vs the brute kernel: sqdist within %.3g, %d "
        "faces differ, all at ties (max gap %.3g); refit boxes equal the "
        "host refit, every corner in its leaf box, no build on a refit "
        "frame; rebuild at frames %s, max inflation %.4f" % (
            label, summary["faces"], leaf, len(run), len(cold),
            worst["sqdist_gap"], worst["faces_differ"], worst["tie_gap"],
            summary["rebuild_frames"], summary["inflation_max"]))
    log("  %s frames (host clock): median %.3f ms, p95 %.3f, max %.3f; "
        "refit frames median %.3f; %d of %d over the %.1f ms deadline (frames "
        "%s); cold frames (MESH_TPU_ANIM=0) median %.3f ms, %.2fx a refit "
        "frame" % (label, summary["frame_ms_median"], summary["frame_ms_p95"],
                   summary["frame_ms_max"], summary["refit_frame_ms_median"],
                   summary["deadline_misses"], len(run), ANIM_DEADLINE_S * 1e3,
                   summary["deadline_miss_frames"],
                   summary["cold_frame_ms_median"],
                   summary["cold_over_refit"]))
    return summary


def anim_frame(model, leaf, seed, dev):
    """Phase 11's refit frame ANIM_STRETCH_FRAME // 2 of one body model's
    stream: (frame index, posed vertices, queries, the rest keyframe
    (numpy), its index at ``leaf``, faces numpy, betas, pose
    trajectory)."""
    from mesh_tpu_torch.accel.build import get_index

    rest, frames, (betas, pose) = anim_stream(model, dev, seed)
    f_np = model.faces.cpu().numpy()
    k = ANIM_STRETCH_FRAME // 2
    for i, (v, q) in enumerate(frames()):
        if i == k:
            break
    base = get_index(rest, f_np, kind="bvh", leaf_size=leaf)
    return k, v, q, rest, base, f_np, betas, pose


def anim_rope_operands(v, faces, q, refit, dev):
    """The resident rope walk's operands on one frame (posed vertices
    ``v``, ``faces`` as the session holds them, queries ``q``), as the
    traversal builds them over the frame's refit index ``refit``."""
    from mesh_tpu_torch.accel import rope_kernel as rk
    from mesh_tpu_torch.accel.traverse import RESIDENT_TILE_F

    return rk.rope_operands(v, faces, q, tile_f=RESIDENT_TILE_F, index=refit,
                            rebuild_mismatched=True, device=dev)


def anim_stages(model, leaf, seed, dev, label):
    """CUDA-event stages of one refit frame of phase 11's stream (frame
    ANIM_STRETCH_FRAME // 2), each a separate run: lbs, the corner gather,
    the leaf-box kernel alone, the host part of the refit (leaf boxes to
    the host, levels, preorder scatter, box measure, node boxes back to
    the card), the whole refit, the traversal over the refit index, and
    the resident rope kernel alone on the operands that traversal builds,
    held to its plain version at every sub-lane count (``compare_rope``,
    with the leaves it tests and its bounds); and the host ``build_bvh`` a
    cold frame pays (host clock, median of 3).  Returns (stages in ms,
    compare_rope's run)."""
    from mesh_tpu_torch.accel import refit_kernel as fk
    from mesh_tpu_torch.accel import rope_kernel as rk
    from mesh_tpu_torch.accel.build import build_bvh
    from mesh_tpu_torch.accel.traverse import closest_faces_and_points_accel
    from mesh_tpu_torch.anim import refit as anim_refit
    from mesh_tpu_torch.models import lbs

    k, v, q, _, base, f_np, betas, pose = anim_frame(model, leaf, seed,
                                                     dev)
    n_leaves = int(base.meta["n_leaves"])
    tri_s = refit_tri_s(v, f_np, base, dev)
    lo, hi = fk.leaf_boxes_kernel(tri_s, n_leaves, leaf)
    depth = int(base.meta["depth"])
    n_nodes = int(base.meta["n_nodes"])

    def host_part():
        lo_l, hi_l = anim_refit._level_boxes(lo.cpu().numpy(),
                                             hi.cpu().numpy())
        node_lo = np.empty((n_nodes, 3), np.float32)
        node_hi = np.empty((n_nodes, 3), np.float32)
        for level, pre in enumerate(anim_refit._preorder_positions(depth)):
            node_lo[pre] = lo_l[level]
            node_hi[pre] = hi_l[level]
        anim_refit.box_measure(node_lo, node_hi)
        return (torch.as_tensor(node_lo, device=dev),
                torch.as_tensor(node_hi, device=dev))

    f_dev = model.faces.long()        # as the session holds them
    refit, _ = anim_refit.refit_bvh(base, v, f_dev, device=dev)
    stages = {
        "lbs": cuda_ms(lambda: lbs(model, betas, pose(k), device=dev), 5),
        "gather": cuda_ms(lambda: refit_tri_s(v, f_dev, base, dev), 5),
        "leaf_boxes_kernel": queued_ms(lambda: fk.leaf_boxes_kernel(
            tri_s, n_leaves, leaf), 100),
        "levels_scatter_measure": cuda_ms(host_part, 5),
        "refit_bvh": cuda_ms(lambda: anim_refit.refit_bvh(
            base, v, f_dev, device=dev), 5),
        "traversal": cuda_ms(lambda: closest_faces_and_points_accel(
            v, f_dev, q, index=refit, device=dev), 5)}
    ops_r = anim_rope_operands(v, f_dev, q, refit, dev)
    run, _ = compare_rope(rk, ops_r, None, label="anim " + label, reps=5)
    stages["rope_kernel"] = run["ms"]
    stages["rope_leaves_tested"] = run["leaves_tested"]
    stages["rope_bound"] = run["bound_ms"]
    builds = []
    v_np = v.cpu().numpy()
    for _ in range(3):
        t0 = time.perf_counter()
        build_bvh(v_np, f_np, leaf_size=leaf)
        builds.append((time.perf_counter() - t0) * 1e3)
    stages["host_build_bvh"] = statistics.median(builds)
    return stages, run


def surface_patches(n_q, rng):
    """Phase 12's surface-proximal queries on the unit sphere: n_q /
    MXU_PATCH patches of MXU_PATCH queries each (bench.py mxu_proxy_stage),
    float32 [n_q, 3]."""
    dirs = rng.randn(n_q // MXU_PATCH, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pts = np.repeat(dirs * 1.005, MXU_PATCH, axis=0)
    return (pts + 0.002 * rng.randn(*pts.shape)).astype(np.float32)


def same_bits(a, b):
    """Equal bit for bit where not NaN, and NaN where NaN."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a.view(torch.int32)[~nan],
                            b.view(torch.int32)[~nan]))


def bound_contract(ub, cert, ub0, cert0, tile_q):
    """Violations of the culled bound pass's contract
    (csrc/mxu_bound_culled.cu) by (ub, cert) against the every-face
    (ub0, cert0): ub bit for bit, cert equal where the every-face value is
    <= sqrt(max(ub, 0)) or ub is NaN, both above or both NaN elsewhere,
    and survivors equal."""
    bad = 0 if same_bits(ub, ub0) else int(ub.numel())
    su = torch.sqrt(torch.clamp_min(ub0, 0.0))[:, None]
    both_nan = torch.isnan(cert) & torch.isnan(cert0)
    exact = (cert0 <= su) | torch.isnan(ub0)[:, None]
    ok = torch.where(exact, (cert == cert0) | both_nan,
                     ((cert > su) & (cert0 > su)) | both_nan)
    bad += int((~ok).sum())
    from mesh_tpu_torch.query import mxu_kernel as mk

    return bad + int((mk.survivors(ub, cert, tile_q)
                      != mk.survivors(ub0, cert0, tile_q)).sum())


def compare_mxu(mk, ck, label, v, f, q, tail, timing):
    """Kernel vs plain for the MXU kernels on one mesh (``v`` [V, 3], ``f``
    [F, 3], ``q`` [Q, 3] on the card) at the reference's tiles: the chunk
    culls ``mxu_faces`` and ``mxu_repair`` identical to the plain versions
    of their design (faces, tiles run, and the chunks each warp folded, the
    faces each lane needed and the chunks each warp staged), to the
    every-face plain versions and to the every-face kernels
    (``mxu_faces_every``, ``mxu_repair_every``, which launch on no driven
    path) on faces and tiles run; the chunk records' box and rounding
    fields identical to ``cull_records_plain``'s; the bound pass's chunk
    cull ``mxu_bound_culled`` identical to the plain version of its design
    (ub, cert and the three counts, bit for bit) and meeting its contract
    against the every-face kernel ``mxu_bound`` (which launches on no
    driven path) and ``mxu_bound_plain``, those two equal; the repair fed
    its (ub, cert) giving the faces and tiles run of the every-face path
    (``mxu_bound`` then ``mxu_repair_every``) and the dense scan's faces.
    With ``timing``: each kernel's time (the bound pass also at each of
    MXU_SPLITS), the every-face kernels', the cull prologue's
    (``mxu_cull_operands``: the Morton order, the records cached), the
    plain versions' and the bounds: the work these inputs need per lane
    (the faces of the chunks its own lane needs, a bound per chunk it
    scans, the seed), the pairs the warps issue and every pair; and the
    ``closest_faces`` kernel's time on the same inputs."""
    tile_q, tile_f = mk.TILE_Q, mk.TILE_F
    p, rec, tri, pts, center = mk.mxu_operands(v, f, q, device=v.device)
    n_q, n_f = p.shape[0], rec.shape[0]
    split = mk.mxu_split(n_q)
    cull = mk.mxu_cull_operands(p, rec, tail)
    planes = rec[:, list(mk._FAST_COLS)].T.contiguous()[None]
    records_plain = ck.cull_records_plain(planes, "fast", tail)[0]
    got = cull["records"][:, :12]
    same = (got == records_plain) | (torch.isnan(got)
                                     & torch.isnan(records_plain))
    check(bool(same.all()), "mxu chunk records[%s, tail=%s]: %d of %d "
          "values differ from cull_records_plain's" % (
              label, tail, int((~same).sum()), same.numel()))
    kf, *kstats = mk.mxu_faces(p, rec, degenerate_tail=tail, cull=cull,
                               with_stats=True)
    pf, *pstats = mk.mxu_faces_culled_plain(p, rec, cull,
                                            degenerate_tail=tail, split=split)
    ef = mk.mxu_faces_plain(p, rec, degenerate_tail=tail)
    of = mk.mxu_faces_every(p, rec, degenerate_tail=tail)
    kub, kcert, *kbstats = mk.mxu_bound_culled(p, rec, cull=cull,
                                               with_stats=True)
    bsplit = mk.mxu_bound_split(n_q)
    pub, pcert, *pbstats = mk.mxu_bound_culled_plain(p, rec, cull,
                                                     split=bsplit)
    eub, ecert = mk.mxu_bound(p, rec)
    xub, xcert = mk.mxu_bound_plain(p, rec)
    check(same_bits(kub, pub) and same_bits(kcert, pcert)
          and all(torch.equal(a, b) for a, b in zip(kbstats, pbstats)),
          "mxu_bound_culled[%s]: ub, cert or the warp, lane, stage counts "
          "differ from the plain version of its design (%d, %d, %s)" % (
              label, int((kub != pub).sum()), int((kcert != pcert).sum()),
              [int((a != b).sum()) for a, b in zip(kbstats, pbstats)]))
    check(same_bits(eub, xub) and same_bits(ecert, xcert),
          "mxu_bound[%s]: %d ub and %d cert values differ from the plain "
          "version" % (label, int((eub != xub).sum()),
                       int((ecert != xcert).sum())))
    for what, (u0, c0) in (("the every-face kernel", (eub, ecert)),
                           ("mxu_bound_plain", (xub, xcert))):
        bad = bound_contract(kub, kcert, u0, c0, tile_q)
        check(bad == 0, "mxu_bound_culled[%s]: %d violations of its "
              "contract against %s" % (label, bad, what))
    kr, krep, *krstats = mk.mxu_repair(p, rec, kub, kcert,
                                       degenerate_tail=tail, cull=cull,
                                       with_stats=True)
    pr, prep, *prstats = mk.mxu_repair_culled_plain(
        p, rec, kub, kcert, cull, degenerate_tail=tail, split=split)
    er, erep = mk.mxu_repair_plain(p, rec, kub, kcert, degenerate_tail=tail)
    orr, orep = mk.mxu_repair_every(p, rec, eub, ecert, degenerate_tail=tail)
    for name, k, pl, ks, ps in (("mxu_faces", kf, pf, kstats, pstats),
                                ("mxu_repair", kr, pr, krstats, prstats)):
        check(torch.equal(k, pl) and all(torch.equal(a, b)
                                         for a, b in zip(ks, ps)),
              "%s[%s, tail=%s]: %d of %d faces (and %s warp, lane, stage "
              "counts) differ from the plain version of its design" % (
                  name, label, tail, int((k != pl).sum()), k.numel(),
                  [int((a != b).sum()) for a, b in zip(ks, ps)]))
    check(torch.equal(kf, ef) and torch.equal(kf, of),
          "mxu_faces[%s, tail=%s]: %d faces differ from the every-face plain "
          "version, %d from the every-face kernel" % (
              label, tail, int((kf != ef).sum()), int((kf != of).sum())))
    check(torch.equal(krep, prep) and torch.equal(krep, erep)
          and torch.equal(krep, orep),
          "mxu_repair[%s, tail=%s]: tiles run differ from the plain versions "
          "or the every-face path" % (label, tail))
    check(torch.equal(kr, er) and torch.equal(kr, orr),
          "mxu_repair[%s, tail=%s]: %d faces differ from the every-face "
          "plain version, %d from the every-face path" % (
              label, tail, int((kr != er).sum()), int((kr != orr).sum())))
    check(torch.equal(kr, kf), "mxu_repair[%s, tail=%s]: %d faces differ "
          "from the dense scan's" % (label, tail, int((kr != kf).sum())))
    rk_, rp = mk.mxu_epilogue(kf, tri, pts, center), mk.mxu_epilogue(
        pf, tri, pts, center)
    err = max(float((rk_["point"] - rp["point"]).abs().max()),
              float((rk_["sqdist"] - rp["sqdist"]).abs().max()))
    surv = mk.survivors(kub, kcert, tile_q)
    tile_faces = torch.tensor([min(n_f, (t + 1) * tile_f) - t * tile_f
                               for t in range(surv.shape[1])],
                              device=surv.device)
    n_c = -(-n_f // ck.CULL_CHUNK)
    out = {"mesh": label, "degenerate_tail": tail,
           "shape": [int(n_q), n_f], "queries": int(pts.shape[1]),
           "split": split, "bound_split": bsplit, "identical": True,
           "max_abs_err": err,
           "screened": int(surv.numel()), "repaired": int(krep.sum()),
           "repaired_pairs": int((surv.sum(0) * tile_faces).sum()) * tile_q}
    for key, (warp, lane, stage), pairs in (
            ("faces", kstats, n_q * n_f),
            ("repair", krstats, out["repaired_pairs"]),
            ("bound", kbstats, n_q * n_f)):
        out[key] = {"warp_chunks": int(warp.sum()),
                    "warp_share": int(warp.sum()) / (warp.numel() * n_c),
                    "heaviest_warp_share": int(warp.max()) / n_c,
                    "stage_share": int(stage.sum()) / (stage.numel() * n_c),
                    "lane_faces": int(lane.sum()),
                    "lane_share": int(lane.sum()) / (n_q * n_f),
                    "lane_share_of_run": int(lane.sum()) / max(1, pairs)}
    log("  mxu[%s, tail=%s] %s, split %d (bound %d): faces, counts and "
        "tiles run identical to the plain versions of the design, faces "
        "to the every-face plain versions and kernels; the culled bound pass "
        "identical to its plain version and within its contract, repair "
        "== dense; %d of %d tiles repaired; dense warps fold %.4f of the "
        "chunks (heaviest %.4f), lanes need %.4f of the pairs; repair %.4f "
        "(heaviest %.4f), %.4f; bound %.4f (heaviest %.4f), %.4f" % (
            label, tail, out["shape"], split, bsplit, out["repaired"],
            out["screened"], out["faces"]["warp_share"],
            out["faces"]["heaviest_warp_share"], out["faces"]["lane_share"],
            out["repair"]["warp_share"],
            out["repair"]["heaviest_warp_share"],
            out["repair"]["lane_share"], out["bound"]["warp_share"],
            out["bound"]["heaviest_warp_share"],
            out["bound"]["lane_share"]))
    if not timing:
        return out
    ops = MXU_PAIR_OPS[tail]
    cull_bytes = 4 * (cull["qorder"].numel() + cull["records"].numel())
    rec_bytes = 4 * (p.numel() + rec.numel())
    screen_bytes = 4 * (kub.numel() + kcert.numel())
    # chunks each lane scans: every chunk for the dense scan, those of the
    # tiles its query tile runs for the repair (its seed's scan likewise)
    chunks_run = int((surv.sum(0) * (tile_faces // ck.CULL_CHUNK + (
        tile_faces % ck.CULL_CHUNK > 0))).sum()) * tile_q
    args = {"faces": (p, rec), "repair": (p, rec, kub, kcert)}
    kernels = {"faces": (mk.mxu_faces, mk.mxu_faces_every,
                         mk.mxu_faces_culled_plain, mk.mxu_faces_plain),
               "repair": (mk.mxu_repair, mk.mxu_repair_every,
                          mk.mxu_repair_culled_plain, mk.mxu_repair_plain)}
    for key, scanned, n_bytes in (
            ("faces", n_q * n_c, rec_bytes + cull_bytes + 4 * n_q),
            ("repair", chunks_run, rec_bytes + cull_bytes + surv.numel()
             + 4 * (n_q + krep.numel()))):
        kern, every, culled_plain, plain = kernels[key]
        row = out[key]
        row["ms"] = cuda_ms(lambda: kern(*args[key], degenerate_tail=tail,
                                         cull=cull), REPS)
        row["every_ms"] = cuda_ms(lambda: every(*args[key],
                                                degenerate_tail=tail), REPS)
        row["with_prologue_ms"] = cuda_ms(lambda: kern(
            *args[key], degenerate_tail=tail), REPS)
        row["plain_ms"] = cuda_ms(lambda: culled_plain(
            *args[key], cull, degenerate_tail=tail, split=split), 1)
        row["every_plain_ms"] = cuda_ms(lambda: plain(
            *args[key], degenerate_tail=tail), 1)
        around = scanned * (MXU_CULL_BOUND_OPS + SEED_OPS) + n_q * ops
        row["bound_ms"], row["bound_by"] = bound_ms(
            row["lane_faces"] * ops + around, 1, n_bytes)
        row["bound_issued_ms"] = bound_ms(
            row["warp_chunks"] * 32 * ck.CULL_CHUNK * ops + around, 1,
            n_bytes)[0]
        row["bound_every_pair_ms"] = bound_ms(
            n_q * n_f if key == "faces" else out["repaired_pairs"], ops,
            rec_bytes + 4 * n_q + (screen_bytes if key == "repair" else 0))[0]
    out["prologue_ms"] = cuda_ms(lambda: mk.mxu_cull_operands(p, rec, tail),
                                 REPS)
    row = out["bound"]
    row["ms"] = cuda_ms(lambda: mk.mxu_bound_culled(p, rec, cull=cull), REPS)
    row["every_ms"] = cuda_ms(lambda: mk.mxu_bound(p, rec), REPS)
    row["with_prologue_ms"] = cuda_ms(lambda: mk.mxu_bound_culled(p, rec),
                                      REPS)
    row["plain_ms"] = cuda_ms(lambda: mk.mxu_bound_culled_plain(
        p, rec, cull, split=bsplit), 1)
    row["every_plain_ms"] = cuda_ms(lambda: mk.mxu_bound_plain(p, rec), 1)
    row["split_ms"] = {s: cuda_ms(lambda: mk.mxu_bound_culled(
        p, rec, cull=cull, split=s), REPS) for s in MXU_SPLITS}
    bound_bytes = (4 * (p.numel() + cull["qorder"].numel()
                        + cull["records"].numel() + n_f * mk.MXU_BOUND_RECORD)
                   + screen_bytes)
    # per lane: a test per chunk, the seed's scan and pair, and the faces
    # of the chunks its own lane needs
    around = n_q * n_c * (MXU_BOUND_CULL_OPS + SEED_OPS) + n_q * MXU_BOUND_OPS
    row["bound_ms"], row["bound_by"] = bound_ms(
        row["lane_faces"] * MXU_BOUND_OPS + around, 1, bound_bytes)
    row["bound_issued_ms"] = bound_ms(
        row["warp_chunks"] * 32 * ck.CULL_CHUNK * MXU_BOUND_OPS + around, 1,
        bound_bytes)[0]
    row["bound_every_pair_ms"] = bound_ms(
        n_q * n_f, MXU_BOUND_OPS, rec_bytes + screen_bytes)[0]
    ops_c = ck.closest_point_operands(v[None], f, q[None], "fast")
    out["closest_faces_ms"] = cuda_ms(lambda: ck.argmin_faces(
        ops_c[0], ops_c[1], "fast", tail), REPS)
    log("    %s: mxu_faces %.3f ms (every face %.3f, with its prologue "
        "%.3f; plain %.1f, every-face plain %.1f; bound %.4f, issued %.4f, "
        "every pair %.3f), mxu_bound_culled %.3f ms (every face %.3f, with "
        "its prologue %.3f, splits %s; plain %.1f, every-face plain %.1f; "
        "bound %.4f, issued %.4f, every pair %.3f), "
        "mxu_repair %.3f ms (every face %.3f, with its prologue %.3f; plain "
        "%.1f, every-face plain %.1f; bound %.4f, issued %.4f, every pair "
        "%.3f on %d pairs); cull prologue %.4f ms; closest_faces %.3f ms" % (
            label, out["faces"]["ms"], out["faces"]["every_ms"],
            out["faces"]["with_prologue_ms"], out["faces"]["plain_ms"],
            out["faces"]["every_plain_ms"], out["faces"]["bound_ms"],
            out["faces"]["bound_issued_ms"],
            out["faces"]["bound_every_pair_ms"], out["bound"]["ms"],
            out["bound"]["every_ms"], out["bound"]["with_prologue_ms"],
            ", ".join("%d: %.3f" % kv for kv in out["bound"]["split_ms"]
                      .items()),
            out["bound"]["plain_ms"], out["bound"]["every_plain_ms"],
            out["bound"]["bound_ms"], out["bound"]["bound_issued_ms"],
            out["bound"]["bound_every_pair_ms"],
            out["repair"]["ms"], out["repair"]["every_ms"],
            out["repair"]["with_prologue_ms"], out["repair"]["plain_ms"],
            out["repair"]["every_plain_ms"], out["repair"]["bound_ms"],
            out["repair"]["bound_issued_ms"],
            out["repair"]["bound_every_pair_ms"], out["repaired_pairs"],
            out["prologue_ms"], out["closest_faces_ms"]))
    return out


def compare_bound_planted(mk, v, f, q):
    """The bound pass's chunk cull on planted non-finite inputs: one NaN
    query, then a NaN reach in one face, then also a NaN a2 in a late
    face (which makes every ub NaN), each at split 1 and the default:
    bit for bit its plain version (ub, cert, counts) and within its
    contract against the every-face kernel."""
    p, rec, _, _, _ = mk.mxu_operands(v, f, q, device=v.device)
    p = p.clone()
    p[5] = float("nan")
    rec = rec.clone()
    n_f = rec.shape[0]
    for col, face in ((23, n_f // 3), (15, n_f - 40)):
        rec[face, col] = float("nan")
        cull = mk.mxu_cull_operands(p, rec)
        eub, ecert = mk.mxu_bound(p, rec)
        for split in (1, mk.mxu_bound_split(p.shape[0])):
            k = mk.mxu_bound_culled(p, rec, cull=cull, split=split,
                                    with_stats=True)
            pl = mk.mxu_bound_culled_plain(p, rec, cull, split=split)
            check(same_bits(k[0], pl[0]) and same_bits(k[1], pl[1])
                  and all(torch.equal(a, b) for a, b in zip(k[2:], pl[2:])),
                  "mxu_bound_culled[planted NaN in column %d, split %d]: "
                  "differs from the plain version of its design"
                  % (col, split))
            bad = bound_contract(k[0], k[1], eub, ecert, mk.TILE_Q)
            check(bad == 0, "mxu_bound_culled[planted NaN in column %d, "
                  "split %d]: %d violations of its contract" % (
                      col, split, bad))
        check(bool(torch.isnan(ecert[:, face // mk.TILE_F]).all())
              and bool(torch.isnan(eub[5]))
              and bool(torch.isnan(eub).all()) == (col == 15),
              "mxu_bound[planted NaN in column %d]: NaN not where planted"
              % col)
    log("  mxu_bound_culled on planted NaN (a query, a reach, a late a2): "
        "identical to its plain version, within its contract")


def drive_mxu(cases, dev):
    """Phase 12's drive: ``Mesh.closest_faces_and_points`` on each case
    (label, v, f, q as numpy) under MESH_TPU_MXU=1, then under
    MESH_TPU_MXU_BF16=1 as well: a cold first call (staging cache emptied)
    and MXU_WARM warm calls each, the repair series read around each
    case, all under MESH_TPU_NO_ENGINE=1 (the engine never takes the MXU
    rung).  The knobs are restored afterwards.  Returns the runs by
    (label, mode)."""
    from mesh_tpu_torch import Mesh
    from mesh_tpu_torch.obs.metrics import REGISTRY
    from mesh_tpu_torch.query import mxu_kernel as mk

    series = REGISTRY.counter("mesh_tpu_query_mxu_repair_total")
    saved = {k: os.environ.get(k) for k in (
        "MESH_TPU_MXU", "MESH_TPU_MXU_BF16", "MESH_TPU_NO_ENGINE")}
    runs = {}
    try:
        os.environ["MESH_TPU_MXU"] = "1"
        os.environ["MESH_TPU_NO_ENGINE"] = "1"
        for mode in ("dense", "repair"):
            if mode == "repair":
                os.environ["MESH_TPU_MXU_BF16"] = "1"
            else:
                os.environ.pop("MESH_TPU_MXU_BF16", None)
            for label, v, f, q in cases:
                before = {o: series.value(kind="dense", outcome=o)
                          for o in ("repaired", "skipped")}
                mk._MXU_FACE_CACHE.clear()
                m = Mesh(v, f, device=dev)
                t0 = time.perf_counter()
                faces, points = m.closest_faces_and_points(q)
                first_ms = (time.perf_counter() - t0) * 1e3
                times = []
                for _ in range(MXU_WARM):
                    t0 = time.perf_counter()
                    faces2, points2 = m.closest_faces_and_points(q)
                    times.append((time.perf_counter() - t0) * 1e3)
                check(np.array_equal(faces, faces2)
                      and np.array_equal(points, points2),
                      "mxu %s %s: repeated calls disagree" % (label, mode))
                tiles = {o: series.value(kind="dense", outcome=o) - before[o]
                         for o in before}
                runs[label, mode] = {
                    "faces": faces, "points": points, "first_ms": first_ms,
                    "warm_ms": statistics.median(times),
                    "warm_ms_min": min(times), "warm_ms_max": max(times),
                    "repaired": tiles["repaired"],
                    "screened": tiles["repaired"] + tiles["skipped"]}
                log("  %s, %s: first call %.3f ms, warm median %.3f ms (min "
                    "%.3f, max %.3f)%s" % (
                        label, mode, first_ms, statistics.median(times),
                        min(times), max(times), "" if mode == "dense" else
                        "; %d of %d face tiles repaired" % (
                            tiles["repaired"],
                            tiles["repaired"] + tiles["skipped"])))
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
    return runs


def check_mxu(cases, runs, dev):
    """Phase 12's checks, after the counted window: every answer against
    the brute-force kernel on the same inputs (sqdist within 1e-5, faces
    equal except at ties), the repair's answers equal to the dense scan's
    bit for bit, every face tile screened, and fewer tiles repaired than
    screened on the surface-proximal queries."""
    from mesh_tpu_torch.query import closest_kernel as ck
    from mesh_tpu_torch.query import mxu_kernel as mk

    summary = {}
    for label, v, f, q in cases:
        dense, rep = runs[label, "dense"], runs[label, "repair"]
        check(np.array_equal(dense["faces"], rep["faces"])
              and np.array_equal(dense["points"], rep["points"]),
              "mxu %s: the repair's answers differ from the dense scan's"
              % label)
        vt = torch.as_tensor(v, device=dev)[None]
        ft = torch.as_tensor(f, device=dev)
        qt = torch.as_tensor(q, device=dev)[None]
        brute = ck.closest_point_kernel(
            vt, ft, qt, assume_nondegenerate=ck.mesh_is_nondegenerate(v, f))
        sq = torch.as_tensor(((q.astype(np.float64) - dense["points"]) ** 2)
                             .sum(-1)[None], dtype=torch.float32, device=dev)
        faces = torch.as_tensor(dense["faces"].astype(np.int64), device=dev)
        vs = check_against_brute("mxu " + label, vt, ft, qt, faces, sq, brute)
        n_tiles = -(-f.shape[0] // mk.TILE_F) * -(-q.shape[0] // mk.TILE_Q)
        check(rep["screened"] == (1 + MXU_WARM) * n_tiles,
              "mxu %s: %d face tiles screened, not %d" % (
                  label, rep["screened"], (1 + MXU_WARM) * n_tiles))
        if label == "sphere_surface":
            check(rep["repaired"] < rep["screened"], "mxu %s: the screen "
                  "pruned no tile" % label)
        log("  mxu %s: repair call %.3f ms (first %.3f) beside the dense "
            "call's %.3f (first %.3f), warm medians" % (
                label, rep["warm_ms"], rep["first_ms"], dense["warm_ms"],
                dense["first_ms"]))
        summary[label] = {
            "faces": int(f.shape[0]), "queries": int(q.shape[0]),
            "vs_brute": vs, "repaired_over_screened":
                rep["repaired"] / rep["screened"],
            "repair_over_dense": rep["warm_ms"] / dense["warm_ms"],
            **{"%s_%s" % (mode, k): runs[label, mode][k]
               for mode in ("dense", "repair")
               for k in ("first_ms", "warm_ms", "warm_ms_min",
                         "warm_ms_max")}}
    return summary


def drive_mxu_bvh(v, f, pts, dev):
    """Phase 13's drive: ``Mesh.closest_faces_and_points`` on phase 6's
    scan under MESH_TPU_MXU=1 with the crossover pinned at
    MXU_BVH_CROSSOVER, streamed (path ``mxu_bvh``) and resident under
    MESH_TPU_BVH_STREAM_VMEM_MB=32 (path ``mxu_bvh_resident``), each f32
    and then under MESH_TPU_MXU_BF16=1: per mode a cold call (index cache
    emptied), MXU_BVH_WARM warm calls and one accel-rung call with its
    stats, the repair series read around them, all under
    MESH_TPU_NO_ENGINE=1 (the engine never takes the BVH).  Launch counts
    are reset just before each path and read just after it; the knobs are
    restored afterwards.  Returns (runs by (path, mode), launches by
    path)."""
    from mesh_tpu_torch import Mesh
    from mesh_tpu_torch.accel.build import clear_index_cache
    from mesh_tpu_torch.accel.traverse import closest_faces_and_points_accel
    from mesh_tpu_torch.obs.metrics import REGISTRY
    from mesh_tpu_torch.query import culled as auto

    series = REGISTRY.counter("mesh_tpu_query_mxu_repair_total")
    names = ("MESH_TPU_MXU", "MESH_TPU_MXU_BF16",
             "MESH_TPU_MXU_CROSSOVER_FACES", "MESH_TPU_BVH_STREAM_VMEM_MB",
             "MESH_TPU_NO_ENGINE")
    saved = {k: os.environ.get(k) for k in names}
    runs, launches = {}, {}
    try:
        os.environ["MESH_TPU_MXU"] = "1"
        os.environ["MESH_TPU_NO_ENGINE"] = "1"
        os.environ["MESH_TPU_MXU_CROSSOVER_FACES"] = str(MXU_BVH_CROSSOVER)
        for path, kind in (("mxu_bvh", "stream"), ("mxu_bvh_resident", "bvh")):
            if kind == "bvh":
                os.environ["MESH_TPU_BVH_STREAM_VMEM_MB"] = "32"
            reset_launches()
            auto.STRATEGY.clear()
            for mode in ("f32", "bf16"):
                if mode == "bf16":
                    os.environ["MESH_TPU_MXU_BF16"] = "1"
                else:
                    os.environ.pop("MESH_TPU_MXU_BF16", None)
                before = {o: series.value(kind=kind, outcome=o)
                          for o in ("repaired", "skipped")}
                clear_index_cache()
                m = Mesh(v, f, device=dev)
                t0 = time.perf_counter()
                faces, points = m.closest_faces_and_points(pts)
                first_ms = (time.perf_counter() - t0) * 1e3
                times = []
                for _ in range(MXU_BVH_WARM):
                    t0 = time.perf_counter()
                    faces2, points2 = m.closest_faces_and_points(pts)
                    times.append((time.perf_counter() - t0) * 1e3)
                vt, ft = m.device_arrays()
                res, stats = closest_faces_and_points_accel(
                    vt, ft, pts, with_stats=True, device=dev)
                check(np.array_equal(faces, faces2)
                      and np.array_equal(points, points2),
                      "%s %s: repeated calls disagree" % (path, mode))
                runs[path, mode] = {
                    "faces": faces, "points": points, "res": res,
                    "stats": stats, "first_ms": first_ms,
                    "warm_ms": statistics.median(times),
                    "warm_ms_min": min(times), "warm_ms_max": max(times),
                    "series": {o: series.value(kind=kind, outcome=o)
                               - before[o] for o in before}}
                log("  %s, %s: backend %s, first call %.3f ms (with the host "
                    "BVH build), warm median %.3f ms (min %.3f, max %.3f); "
                    "repair series moved %s" % (
                        path, mode, stats["backend"], first_ms,
                        statistics.median(times), min(times), max(times),
                        runs[path, mode]["series"]))
            launches[path] = read_launches()
            check(dict(auto.STRATEGY) == {"accel_bvh": 2 * (1 + MXU_BVH_WARM)},
                  "%s routes %s, not the BVH" % (path, auto.STRATEGY))
            if kind == "bvh":
                if saved["MESH_TPU_BVH_STREAM_VMEM_MB"] is None:
                    del os.environ["MESH_TPU_BVH_STREAM_VMEM_MB"]
                else:
                    os.environ["MESH_TPU_BVH_STREAM_VMEM_MB"] = \
                        saved["MESH_TPU_BVH_STREAM_VMEM_MB"]
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
    return runs, launches


def check_mxu_bvh(runs, v, f, pts, vpu, walks, dev):
    """Phase 13's checks, after the counted window: the backends, the four
    answers (streamed or resident, f32 or bf16) bit-identical, each against
    the brute-force kernel and phase 6's VPU walk (``vpu``, its result
    dict) under the tie contract; the pair tests and the repair series
    against phase 2's runs of the same walks on the same scan (``walks``,
    by (walk, use_bf16)): every call moves the series by that run's full
    visits and skipped visits under bf16, and not at all under f32."""
    from mesh_tpu_torch.query import closest_kernel as ck

    calls = 2 + MXU_BVH_WARM      # cold, warm and the accel-rung call
    base = runs["mxu_bvh", "f32"]
    summary = {}
    for (path, mode), run in runs.items():
        stats = run["stats"]
        walk = "stream" if path == "mxu_bvh" else "resident"
        check(stats["backend"] == "rope_%s_mxu" % walk
              and stats["fallback"] == 0,
              "%s %s: backend %s, %d fallbacks" % (
                  path, mode, stats["backend"], stats["fallback"]))
        check(np.array_equal(run["faces"], base["faces"])
              and np.array_equal(run["points"], base["points"])
              and all(np.array_equal(run["res"][k], base["res"][k])
                      for k in ("face", "part", "point", "sqdist")),
              "%s %s: answers differ from mxu_bvh f32's" % (path, mode))
        ref = walks[walk, mode == "bf16"]
        check(stats["pair_tests"] == ref["pair_tests"], "%s %s: %d pair "
              "tests, phase 2's walk tested %d" % (
                  path, mode, stats["pair_tests"], ref["pair_tests"]))
        want_series = ({"repaired": calls * ref["full_visits"],
                        "skipped": calls * (ref["leaves_tested"]
                                            - ref["full_visits"])}
                       if mode == "bf16" else {"repaired": 0, "skipped": 0})
        check(run["series"] == want_series,
              "%s %s: repair series moved %s, not %s" % (
                  path, mode, run["series"], want_series))
        summary["%s_%s" % (path, mode)] = dict(
            {k: run[k] for k in ("first_ms", "warm_ms", "warm_ms_min",
                                 "warm_ms_max", "series")},
            backend=stats["backend"], pair_tests=stats["pair_tests"],
            screened=ref["leaves_tested"], repaired=ref["full_visits"])
    check(runs["mxu_bvh", "f32"]["stats"]["pair_tests"]
          >= runs["mxu_bvh_resident", "f32"]["stats"]["pair_tests"],
          "mxu_bvh: streamed pair tests below the resident walk's")
    vt = torch.as_tensor(v, device=dev)[None]
    ft = torch.as_tensor(f, device=dev)
    qt = torch.as_tensor(pts, device=dev)[None]
    faces = torch.as_tensor(base["res"]["face"], device=dev)[None]
    sqdist = torch.as_tensor(base["res"]["sqdist"], device=dev)[None]
    brute = ck.closest_point_kernel(
        vt, ft, qt, assume_nondegenerate=ck.mesh_is_nondegenerate(v, f))
    summary["vs_brute"] = check_against_brute("mxu_bvh", vt, ft, qt, faces,
                                              sqdist, brute)
    summary["vs_vpu_walk"] = check_against_brute(
        "mxu_bvh", vt, ft, qt, faces, sqdist,
        {"face": torch.as_tensor(vpu["face"], device=dev)[None],
         "sqdist": torch.as_tensor(vpu["sqdist"], device=dev)[None]},
        against="phase 6's VPU walk")
    return summary


# ---------------------------------------------------------------------------
# Phase 14: the training path.

def _layout(x):
    """Shapes and dtype names of a result: arrays, tensors, tuples, dicts."""
    if isinstance(x, tuple):
        return tuple(_layout(y) for y in x)
    if isinstance(x, dict):
        return {k: _layout(y) for k, y in x.items()}
    if torch.is_tensor(x):
        return (tuple(x.shape), str(x.dtype).replace("torch.", ""))
    return (tuple(x.shape), str(x.dtype))


def fit_inputs(model, verts0, dev):
    """Phase 14's scans, by FIT_SHAPES: bench.py's fit_step_latency scan
    (N(0, 0.3) points) and BASELINE.json config 5's (surface samples of
    posed body 0 ``verts0`` with N(0, SCAN_NOISE) noise), each [1, S, 3]."""
    rng = np.random.RandomState(14)
    scans = {}
    for label, (kind, n) in FIT_SHAPES.items():
        if kind == "randn":
            scans[label] = torch.as_tensor(rng.randn(1, n, 3) * 0.3,
                                           dtype=torch.float32, device=dev)
        else:
            scans[label] = surface_queries(verts0[None], model.faces, n,
                                           rng)[0]
    return scans


def fit_zero_params(model, dev):
    """Zero (betas, pose, trans) of one body, leaves that require grad."""
    return [torch.zeros(shape, dtype=torch.float32, device=dev,
                        requires_grad=True)
            for shape in ((1, model.num_betas), (1, model.num_joints, 3),
                          (1, 3))]


def fit_calls(model, scan, dev):
    """(params, forward, value_and_grad) of ``scan_to_model_loss`` at zero
    parameters, both under ``no_tf32`` as ``make_fit_step`` runs them."""
    from mesh_tpu_torch.models.body_model import no_tf32
    from mesh_tpu_torch.parallel import fit

    params = fit_zero_params(model, dev)

    def forward():
        with torch.no_grad(), no_tf32():
            return fit.scan_to_model_loss(model, *params, scan, device=dev)

    def value_and_grad():
        with no_tf32():
            loss = fit.scan_to_model_loss(model, *params, scan, device=dev)
            return loss, torch.autograd.grad(loss, params)

    return params, forward, value_and_grad


def fit_shape(label, model, scan, dev):
    """One fit shape: the closest_faces launches of one forward and one
    value-and-grad, two value-and-grads' gradients (bit-identical or not),
    and FIT_STEPS steps of ``make_fit_step`` (times: ``fit_times``)."""
    from mesh_tpu_torch.parallel import fit
    from mesh_tpu_torch.query import closest_kernel as ck

    _, forward, value_and_grad = fit_calls(model, scan, dev)
    run = {"scan_points": scan.shape[1]}
    n0 = ck.LAUNCHES["closest_faces"]
    loss_f = forward()
    run["launches_per_forward"] = ck.LAUNCHES["closest_faces"] - n0
    n0 = ck.LAUNCHES["closest_faces"]
    loss_v, grads = value_and_grad()
    run["launches_per_value_and_grad"] = ck.LAUNCHES["closest_faces"] - n0
    _, grads2 = value_and_grad()
    run["backward_bit_identical"] = all(
        torch.equal(a, b) for a, b in zip(grads, grads2))
    run["loss"] = float(loss_v.detach())
    check(float(loss_f) == run["loss"], "fit %s: the forward's loss %r, the "
          "value and grad's %r" % (label, float(loss_f), run["loss"]))
    state, opt = fit.init_fit_state(model, 1, device=dev)
    step = fit.make_fit_step(model, opt, device=dev)
    losses = []
    n0 = ck.LAUNCHES["closest_faces"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FIT_STEPS):
        state, loss = step(state, scan)
        losses.append(float(loss))
    run["step_ms"] = (time.perf_counter() - t0) * 1e3 / FIT_STEPS
    run["launches_per_step"] = (ck.LAUNCHES["closest_faces"] - n0) / FIT_STEPS
    run["losses"] = losses
    log("  fit %s (1 x %d): closest_faces launches %d a forward, %d a "
        "value and grad; two backwards bit-identical: %s; %d steps of "
        "make_fit_step %.3f ms each (host clock), loss %.6g -> %.6g"
        % (label, scan.shape[1], run["launches_per_forward"],
           run["launches_per_value_and_grad"], run["backward_bit_identical"],
           FIT_STEPS, run["step_ms"], losses[0], losses[-1]))
    return run, grads


def drive_fit(model, verts0, scans, reg_pts, reg_nrm, scan_mesh, dev):
    """Phase 14's drive, counts set to 0 just before it and read just
    after: the fit at each shape, ``torch.func.jvp`` through recompute
    mode, ``diff.nearest_normal_weighted`` on phase 8's set,
    ``diff.closest_point`` over a BVH index and by the default route on
    phase 6's scan mesh, and ``register_vertices``.  Returns (runs, what
    the checks after the window need, launches)."""
    from mesh_tpu_torch import diff
    from mesh_tpu_torch.accel.build import get_index
    from mesh_tpu_torch.query import closest_kernel as ck
    from mesh_tpu_torch.query import normal_weighted as nw

    f = model.faces
    reset_launches()
    runs, keep = {}, {}
    for label, scan in scans.items():
        runs[label], keep[label] = fit_shape(label, model, scan, dev)

    # torch.func.jvp through recompute mode, the kernel launching inside
    q = scans[FIT_MAIN][0, :JVP_QUERIES]
    dv = torch.as_tensor(np.random.RandomState(16).randn(*verts0.shape),
                         dtype=torch.float32, device=dev)

    def prim(v_):
        return diff.closest_point(v_, f, q, mode="recompute",
                                  device=dev)["sqdist"]

    n0 = ck.LAUNCHES["closest_faces"]
    _, tangent = torch.func.jvp(prim, (verts0,), (dv,))
    jvp_launches = ck.LAUNCHES["closest_faces"] - n0
    grad = torch.func.grad(lambda v_: prim(v_).sum())(verts0)
    runs["jvp"] = {"queries": JVP_QUERIES, "launches": jvp_launches,
                   "tangent_sum": float(tangent.sum()),
                   "grad_dot": float((grad * dv).sum())}

    # the normal-weighted query on phase 8's registration set (row 7)
    v_nw = verts0.clone().requires_grad_(True)
    n0 = nw.LAUNCHES["normal_weighted_faces"]
    res_nw = diff.nearest_normal_weighted(v_nw, f, reg_pts, reg_nrm,
                                          eps=REG_EPS, device=dev)
    (g_nw,) = torch.autograd.grad(res_nw["sqdist"].sum(), v_nw)
    runs["normal_weighted"] = {
        "queries": reg_pts.shape[0],
        "launches": nw.LAUNCHES["normal_weighted_faces"] - n0,
        "grad_finite": bool(torch.isfinite(g_nw).all())}
    keep["normal_weighted"] = res_nw["face"]

    # closest point over a BVH index on phase 6's scan mesh (rows 12 / 14)
    v_s, f_s, p_s = scan_mesh
    index = get_index(v_s, f_s, "bvh")
    vt = torch.as_tensor(v_s, dtype=torch.float32, device=dev)
    pt = torch.as_tensor(p_s, device=dev)
    faces = {}
    for route, idx in (("accel", index), ("default", None)):
        n0 = read_launches()
        faces[route] = diff.closest_point(vt, f_s, pt, accel_index=idx,
                                          device=dev)["face"]
        n1 = read_launches()
        runs["scan_" + route] = {
            "launches": {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]}}
    same = faces["accel"] == faces["default"]
    grads = {}
    for route, idx in (("accel", index), ("default", None)):
        vq = vt.clone().requires_grad_(True)
        res = diff.closest_point(vq, f_s, pt, accel_index=idx, device=dev)
        (grads[route],) = torch.autograd.grad(
            (res["sqdist"] * same).sum(), vq)
    keep["scan"] = (same, grads)
    runs["scan_accel"]["faces_equal_share"] = float(same.float().mean())

    # free-vertex ICP: REGISTER_STEPS steps, a burst every REGISTER_EVERY
    rng = np.random.RandomState(15)
    reg_scan = surface_queries(verts0[None], f, REGISTER_SCAN, rng)[0][0]
    n0 = ck.LAUNCHES["closest_faces"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    icp = diff.register_vertices(model.v_template, f, reg_scan,
                                 steps=REGISTER_STEPS,
                                 recorrespond_every=REGISTER_EVERY,
                                 device=dev)
    runs["register"] = {
        "ms": (time.perf_counter() - t0) * 1e3, "scan_points": REGISTER_SCAN,
        "steps": REGISTER_STEPS,
        "recorrespondences": icp.recorrespondences,
        "launches": ck.LAUNCHES["closest_faces"] - n0,
        "loss_first": icp.losses[0], "loss_last": icp.losses[-1],
        "residual_rms": icp.residual_rms}
    launches = read_launches()
    return runs, keep, launches


def check_fit(runs, keep, model, verts0, scans, reg_pts, reg_nrm, dev):
    """Phase 14's checks, after the counted window: one closest_faces
    launch a forward, a value-and-grad and a step, falling losses; at each
    fit shape, the kernel's faces identical to its plain versions on the
    fit's own operands (``compare_faces``), and the kernel route against
    the plain scan (``use_pallas=False``, another distance formula): sqdist
    within 1e-5 on every query, every face that differs a tie (the two
    faces' distances by one formula within 1e-6, ``check_against_brute``),
    the gradient of the mean sqdist with respect to the vertices within
    rtol 1e-4, atol 1e-5 of its largest over the agreeing queries, and its
    gap over all queries recorded (a near-tie may put the closest point on
    an edge in one route and just inside a face in the other); the jvp's tangent against the
    gradient's projection (rtol 1e-4), the normal-weighted faces equal to
    the kernel's plain version's, the BVH route's gradients equal to the
    default route's where the faces agree, and the ICP bursts."""
    from mesh_tpu_torch import diff
    from mesh_tpu_torch.models import lbs
    from mesh_tpu_torch.query import closest_kernel as ck
    from mesh_tpu_torch.query import normal_weighted as nw

    f = model.faces
    with torch.no_grad():
        # the parameters the gradients were taken at (zero: the rest pose)
        verts, _ = lbs(model, *fit_zero_params(model, dev), device=dev)
    for label, scan in scans.items():
        run = runs[label]
        check(run["launches_per_forward"] == 1
              and run["launches_per_value_and_grad"] == 1
              and run["launches_per_step"] == 1,
              "fit %s: closest_faces launched %s a forward, %s a value and "
              "grad, %s a step, not once each" % (
                  label, run["launches_per_forward"],
                  run["launches_per_value_and_grad"],
                  run["launches_per_step"]))
        check(np.isfinite(run["losses"]).all()
              and run["losses"][-1] < run["losses"][0],
              "fit %s: the loss did not fall: %s" % (label, run["losses"]))
        check(all(bool(torch.isfinite(g).all()) for g in keep[label]),
              "fit %s: gradients not finite" % label)
        # the fit's route: the brute kernel, the fast tile with its tail
        ops = ck.closest_point_operands(verts, f, scan, "fast")
        run["kernel_vs_plain"] = compare_faces(ck, *ops, "fast", True,
                                               timing=False)
        del ops
        res, vq, grads = {}, {}, {}
        for route in (None, False):
            vq[route] = verts.clone().requires_grad_(True)
            res[route] = diff.closest_point_batched(vq[route], f, scan,
                                                    use_pallas=route,
                                                    device=dev)
            grads[route] = torch.autograd.grad(
                res[route]["sqdist"].mean(), vq[route], retain_graph=True)[0]
        same = res[None]["face"] == res[False]["face"]
        for route in (None, False):
            grads[route, "agree"] = torch.autograd.grad(
                (res[route]["sqdist"] * same).mean(), vq[route])[0]
        # every query: sqdist within 1e-5; a face that differs must be a tie
        # (its distance and the plain face's, one formula, within 1e-6)
        ties = check_against_brute(
            "fit %s kernel route" % label, verts, f, scan, res[None]["face"],
            res[None]["sqdist"].detach(),
            {k: res[False][k].detach() for k in ("face", "sqdist")},
            quiet=True, against="the plain scan")
        pt_gap = (res[None]["point"] - res[False]["point"]).detach().norm(
            dim=-1)[~same]
        g_k, g_p = grads[None, "agree"], grads[False, "agree"]
        run["faces_equal_plain_share"] = float(same.float().mean())
        run["sqdist_max_abs_err_vs_plain"] = ties["sqdist_gap"]
        run["mismatched_tie_max_gap"] = ties["tie_gap"]
        run["mismatched_point_max_gap"] = float(pt_gap.max()) if (
            pt_gap.numel()) else 0.0
        run["grad_max_abs_err_vs_plain"] = float((g_k - g_p).abs().max())
        run["grad_all_queries_max_abs_err_vs_plain"] = float(
            (grads[None] - grads[False]).abs().max())
        run["grad_max_abs"] = float(grads[False].abs().max())
        log("  fit %s: the plain scan picks the kernel's face for %.4f of "
            "the queries; on every query sqdist within %.3g; the others are "
            "ties (their two faces' distances within %.3g, closest points "
            "%.3g apart); vertex gradients within %.3g of the plain route's "
            "on the agreeing queries, %.3g on all (largest %.3g)"
            % (label, run["faces_equal_plain_share"],
               run["sqdist_max_abs_err_vs_plain"],
               run["mismatched_tie_max_gap"],
               run["mismatched_point_max_gap"],
               run["grad_max_abs_err_vs_plain"],
               run["grad_all_queries_max_abs_err_vs_plain"],
               run["grad_max_abs"]))
        check(torch.allclose(g_k, g_p, rtol=1e-4,
                             atol=1e-5 * float(g_p.abs().max())),
              "fit %s: kernel-route vertex gradients differ from the plain "
              "scan's by %.3g on the agreeing queries"
              % (label, run["grad_max_abs_err_vs_plain"]))
    jvp = runs["jvp"]
    check(jvp["launches"] > 0, "jvp: the closest_faces kernel never "
          "launched inside torch.func.jvp")
    check(abs(jvp["tangent_sum"] - jvp["grad_dot"])
          <= 1e-4 * max(1.0, abs(jvp["grad_dot"])),
          "jvp: tangent %r against the gradient's %r" % (
              jvp["tangent_sum"], jvp["grad_dot"]))
    run_nw = runs["normal_weighted"]
    plain_nw = nw.nearest_normal_weighted_plain(verts0, model.faces, reg_pts,
                                                reg_nrm, eps=REG_EPS)[0]
    run_nw["faces_equal_plain"] = bool(torch.equal(keep["normal_weighted"],
                                                   plain_nw))
    check(run_nw["launches"] > 0 and run_nw["grad_finite"]
          and run_nw["faces_equal_plain"],
          "diff.nearest_normal_weighted: %s" % run_nw)
    same, grads = keep["scan"]
    err = float((grads["accel"] - grads["default"]).abs().max())
    tol = 1e-5 * float(grads["default"].abs().max())
    runs["scan_accel"]["grad_max_abs_err_vs_default"] = err
    check(err <= tol and runs["scan_accel"]["faces_equal_share"] > 0.99,
          "diff.closest_point(accel_index): faces equal for %.4f, gradients "
          "differ by %.3g (tolerance %.3g)" % (
              runs["scan_accel"]["faces_equal_share"], err, tol))
    reg = runs["register"]
    check(reg["recorrespondences"] == REGISTER_STEPS // REGISTER_EVERY
          and reg["launches"] == reg["recorrespondences"]
          and reg["loss_last"] < reg["loss_first"],
          "register_vertices: %s" % reg)
    log("  jvp through recompute on %d queries: %d closest_faces launches, "
        "tangent %.6g against %.6g; nearest_normal_weighted on %d queries: "
        "%d launches, faces equal to the plain version's; BVH route on the "
        "scan: launches %s, faces equal to the default route's (%s) for "
        "%.4f, gradients within %.3g; register_vertices: %d bursts, %d "
        "launches, loss %.6g -> %.6g in %.1f ms" % (
            jvp["queries"], jvp["launches"], jvp["tangent_sum"],
            jvp["grad_dot"], run_nw["queries"], run_nw["launches"],
            runs["scan_accel"]["launches"], runs["scan_default"]["launches"],
            runs["scan_accel"]["faces_equal_share"], err,
            reg["recorrespondences"], reg["launches"], reg["loss_first"],
            reg["loss_last"], reg["ms"]))
    return runs


def round_ms(fns):
    """{name: [ms of each round]}: ``cuda_ms`` of FIT_REPS calls of each
    function of ``fns`` in FIT_ROUNDS interleaved rounds, after a shared
    warm-up of FIT_WARMUP calls of each, so no name is timed colder or in
    another stretch of the run than the others."""
    for _ in range(FIT_WARMUP):
        for fn in fns.values():
            fn()
    times = {name: [] for name in fns}
    for _ in range(FIT_ROUNDS):
        for name, fn in fns.items():
            times[name].append(cuda_ms(fn, FIT_REPS, warmup=0))
    return times


def spread(ms):
    """The median of round times ``ms`` and their least and most."""
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}


def fit_times(model, scans, runs, dev):
    """Forward and value-and-grad ms at every fit shape (``round_ms``),
    written into ``runs[label]``: medians, spreads, the ratio of the
    medians and the least and most ratio of one round."""
    calls = {label: fit_calls(model, scan, dev)[1:]
             for label, scan in scans.items()}
    fns = {}
    for label, (forward, value_and_grad) in calls.items():
        fns[label + "/forward"] = forward
        fns[label + "/value_and_grad"] = value_and_grad
    times = round_ms(fns)
    for label in scans:
        fwd = times[label + "/forward"]
        vg = times[label + "/value_and_grad"]
        ratios = [b / a for a, b in zip(fwd, vg)]
        run = runs[label]
        run["forward_ms"] = statistics.median(fwd)
        run["value_and_grad_ms"] = statistics.median(vg)
        run["forward_ms_rounds"], run["value_and_grad_ms_rounds"] = fwd, vg
        run["backward_over_forward"] = (run["value_and_grad_ms"]
                                        / run["forward_ms"])
        run["backward_over_forward_range"] = [min(ratios), max(ratios)]
        log("  fit %s: forward %.3f ms (rounds %.3f-%.3f), value and grad "
            "%.3f ms (%.3f-%.3f), ratio %.2f (a round's %.2f-%.2f); medians "
            "of %d rounds of %d calls after a shared warm-up"
            % (label, run["forward_ms"], min(fwd), max(fwd),
               run["value_and_grad_ms"], min(vg), max(vg),
               run["backward_over_forward"], min(ratios), max(ratios),
               FIT_ROUNDS, FIT_REPS))


def fit_stages(model, scan, dev):
    """Where one fit step's time goes at one shape, in separate CUDA-event
    runs after the counted window (``round_ms``; median, least and most):
    lbs of one body, the search (``closest_point_dispatch``: prologue,
    closest_faces, epilogue), the recomposition at the winning faces
    (``_Frozen``'s forward), the backward of the whole loss, one Adam
    update."""
    from mesh_tpu_torch.diff import queries as dq
    from mesh_tpu_torch.models import lbs
    from mesh_tpu_torch.models.body_model import no_tf32
    from mesh_tpu_torch.parallel import fit
    from mesh_tpu_torch.query.closest_point import closest_point_dispatch

    params = fit_zero_params(model, dev)
    f = model.faces.long()
    with no_tf32():
        verts, _ = lbs(model, *params, device=dev)
        vd = verts.detach()
        corners = f[closest_point_dispatch(vd, f, scan, use_pallas=True)[
            "face"].long()]
        loss = fit.scan_to_model_loss(model, *params, scan, device=dev)
        grads = torch.autograd.grad(loss, params, retain_graph=True)
        # Adam steps copies, so the retained graph's leaves stay as they were
        moved = [p_.detach().clone().requires_grad_(True) for p_ in params]
        for p_, g in zip(moved, grads):
            p_.grad = g
        times = round_ms({
            "lbs": lambda: lbs(model, *params, device=dev),
            "search": lambda: closest_point_dispatch(vd, f, scan,
                                                      use_pallas=True),
            "recompose": lambda: dq._Frozen.apply(vd, scan, corners),
            "backward": lambda: torch.autograd.grad(loss, params,
                                                    retain_graph=True),
            "adam_step": fit.adam(moved).step})
    return {name: spread(ms) for name, ms in times.items()}


def empty_expected(n_v):
    """Phase 14b: what an empty query set returns at each entry point, the
    reference's shapes and dtypes, for a mesh of ``n_v`` vertices."""
    face_pts = (((1, 0), "uint32"), ((0, 3), "float64"))
    diff_res = {"bary": ((0, 3), "float32"), "face": ((0,), "int32"),
                "part": ((0,), "int32"), "point": ((0, 3), "float32"),
                "sqdist": ((0,), "float32")}
    return {
        "Mesh.closest_faces_and_points": face_pts,
        "Mesh.closest_faces_and_points[culled]": face_pts,
        "Mesh.closest_faces_and_points[bvh]": face_pts,
        "Mesh.closest_points": ((0, 3), "float64"),
        "Mesh.closest_vertices": (((0,), "int32"), ((0,), "float64")),
        "AabbTree.nearest": (((1, 0), "uint32"), ((1, 0), "uint32"),
                             ((0, 3), "float64")),
        "AabbTree.nearest_alongnormal": (((0,), "float64"),
                                         ((0,), "uint32"),
                                         ((0, 3), "float64")),
        "AabbNormalsTree.nearest": (((0, 1), "uint32"),
                                    ((0, 3), "float64")),
        "batched_closest_faces_and_points": (((2, 1, 0), "uint32"),
                                             ((2, 0, 3), "float64")),
        "fused_normals_and_closest_points": (((n_v, 3), "float64"),)
        + face_pts,
        "fused_normals_and_closest_points[batch]": (
            ((2, n_v, 3), "float64"), ((2, 1, 0), "uint32"),
            ((2, 0, 3), "float64")),
        "diff.closest_point": diff_res,
        "diff.closest_point[recompute]": diff_res,
        "diff.closest_point[accel]": diff_res,
        "diff.closest_point_batched": {
            k: ((2,) + s, d) for k, (s, d) in diff_res.items()},
        "diff.nearest_normal_weighted": diff_res,
        "diff.point_to_triangle": {k: v for k, v in diff_res.items()
                                   if k != "face"},
    }


def drive_empty(posed0, f_np, large0, f_l, scan_mesh, dev):
    """Phase 14b: an empty query set through every entry point on the
    card, counts set to 0 just before and read just after (no kernel may
    launch: an empty grid is a launch error, so the wrappers return
    first).  Returns (layouts, launches)."""
    from mesh_tpu_torch import (
        Mesh,
        batched_closest_faces_and_points,
        diff,
        fused_normals_and_closest_points,
    )
    from mesh_tpu_torch.accel.build import get_index

    e = np.zeros((0, 3), np.float32)
    v_s, f_s, _ = scan_mesh
    reset_launches()
    m = Mesh(posed0, f_np, device=dev)
    got = {
        "Mesh.closest_faces_and_points": m.closest_faces_and_points(e),
        "Mesh.closest_faces_and_points[culled]": Mesh(
            large0, f_l, device=dev).closest_faces_and_points(e),
        "Mesh.closest_faces_and_points[bvh]": Mesh(
            v_s, f_s, device=dev).closest_faces_and_points(e),
        "Mesh.closest_points": m.closest_points(e),
        "Mesh.closest_vertices": m.closest_vertices(e),
        "AabbTree.nearest": m.compute_aabb_tree().nearest(e, True),
        "AabbTree.nearest_alongnormal":
            m.compute_aabb_tree().nearest_alongnormal(e, e),
        "AabbNormalsTree.nearest": m.compute_aabb_normals_tree().nearest(e,
                                                                         e),
        "batched_closest_faces_and_points": batched_closest_faces_and_points(
            [m, m], e, device=dev),
        "fused_normals_and_closest_points": fused_normals_and_closest_points(
            m, e, device=dev),
        "fused_normals_and_closest_points[batch]":
            fused_normals_and_closest_points([m, m], np.zeros((2, 0, 3)),
                                             device=dev),
        "diff.closest_point": diff.closest_point(posed0, f_np, e,
                                                 device=dev),
        "diff.closest_point[recompute]": diff.closest_point(
            posed0, f_np, e, mode="recompute", device=dev),
        "diff.closest_point[accel]": diff.closest_point(
            v_s.astype(np.float32), f_s, e,
            accel_index=get_index(v_s, f_s, "bvh"), device=dev),
        "diff.closest_point_batched": diff.closest_point_batched(
            np.stack([posed0, posed0]), f_np, np.zeros((2, 0, 3), np.float32),
            device=dev),
        "diff.nearest_normal_weighted": diff.nearest_normal_weighted(
            posed0, f_np, e, e, device=dev),
        "diff.point_to_triangle": diff.point_to_triangle(e, e, e, e,
                                                         device=dev),
    }
    torch.cuda.synchronize()
    launches = read_launches()
    layouts = {k: _layout(x) for k, x in got.items()}
    expected = empty_expected(posed0.shape[0])
    for name, want in expected.items():
        check(layouts[name] == want,
              "empty queries, %s: %s, not the reference's %s"
              % (name, layouts[name], want))
    log("  %d entry points returned the reference's empty shapes and "
        "dtypes, with no kernel launched" % len(expected))
    return layouts, launches


# ---------------------------------------------------------------------------
# Phase 15: the query engine.

@contextlib.contextmanager
def knobs_set(**values):
    """The block with the environment knobs ``values`` set; each is
    restored afterwards."""
    saved = {name: os.environ.get(name) for name in values}
    os.environ.update({name: str(v) for name, v in values.items()})
    try:
        yield
    finally:
        for name, old in saved.items():
            if old is None:
                del os.environ[name]
            else:
                os.environ[name] = old


def no_engine():
    """The block under MESH_TPU_NO_ENGINE=1: the facades' direct routes
    (the auto ladder's BVH and MXU rungs included); the knob is restored
    afterwards."""
    return knobs_set(MESH_TPU_NO_ENGINE=1)


def same_arrays(a, b):
    """Equal bit for bit: the same shapes, dtypes and values (NaN where
    NaN), for arrays, tensors and tuples of them."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_arrays(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_arrays(a[k], b[k])
                                            for k in a)
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))


def engine_misses():
    from mesh_tpu_torch import engine

    return engine.stats()["plan_cache"]["misses"]


def drive_engine(inp, dev):
    """Phase 15's drive, counts set to 0 just before and read just after:
    every engine route on the card, from an empty plan cache.  ``inp``
    holds phase 3's, 6's, 7's and 14's inputs.  Returns (runs, launches,
    plan facts)."""
    from mesh_tpu_torch import (
        Mesh,
        batched_closest_faces_and_points,
        batched_vertex_normals,
        batched_vertex_visibility,
        diff,
        engine,
        fused_normals_and_closest_points,
    )
    from mesh_tpu_torch.obs.clock import monotonic

    planner = engine.get_planner()
    planner.clear()
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    engine.reset_stats()
    posed, f_np, q_np = inp["posed"], inp["f_np"], inp["queries"]
    runs = {}
    captures = {}

    def run(name, fn):
        """fn() with the seconds of any plan it made."""
        before = engine.STATS._compile_seconds.value()
        misses = engine_misses()
        out = fn()
        if engine_misses() > misses:
            captures[name] = engine.STATS._compile_seconds.value() - before
        return out

    reset_launches()
    t_drive = time.perf_counter()
    # 1. the numpy facades at the main path's and phase 7's shapes
    runs["closest"] = run("closest 256x1024", lambda: (
        batched_closest_faces_and_points((posed, f_np), q_np, device=dev)))
    runs["fused"] = run("fused 256x1024", lambda: (
        fused_normals_and_closest_points((posed, f_np), q_np, device=dev)))
    runs["normals"] = [run("normals 256", lambda: batched_vertex_normals(
        (posed, f_np), device=dev)) for _ in range(ENGINE_NORMAL_RUNS)]
    runs["visibility"] = run("visibility 64x4", lambda: (
        batched_vertex_visibility((inp["vis_posed"], f_np), inp["cams"],
                                  min_dist=VIS_MIN_DIST, device=dev)))
    # 2. Mesh on body 0: three counts in one bucket, then the next bucket
    body0 = Mesh(posed[0], f_np, device=dev)
    runs["facade"] = {}
    for n_q in ENGINE_FACADE_QS:
        misses = engine_misses()
        runs["facade"][n_q] = (run("Mesh Q=%d" % n_q, lambda: (
            body0.closest_faces_and_points(inp["q_facade"][:n_q]))),
            engine_misses() - misses)
    # 3. the scan sphere: F above the crossover -> culled_faces
    v_s, f_s, p_s = inp["scan"]
    runs["scan"] = run("Mesh scan 65536", lambda: Mesh(
        v_s, f_s, device=dev).closest_faces_and_points(p_s))
    # 4. warmup() on MODEL_SHAPES, then real SMPL-shaped bodies
    t0 = time.perf_counter()
    runs["warmup_made"] = engine.warmup(device=dev)
    runs["warmup_s"] = time.perf_counter() - t0
    misses = engine_misses()
    runs["warm_bodies"] = [
        (Mesh(posed[i], f_np, device=dev).closest_faces_and_points(
            q_np[i, :n_q]),
         fused_normals_and_closest_points(Mesh(posed[i], f_np, device=dev),
                                          q_np[i, :n_q], device=dev))
        for i, n_q in ENGINE_WARM_BODIES]
    runs["warm_misses"] = engine_misses() - misses
    # 5. the executor: ENGINE_REQUESTS requests in one coalesced dispatch,
    # one past its deadline and one cancelled
    ex = engine.get_executor()
    bodies = [Mesh(posed[i], f_np, device=dev)
              for i in range(ENGINE_REQUESTS)]
    n_qs = [int(n) for n in np.linspace(*ENGINE_REQUEST_QS, ENGINE_REQUESTS)]
    co0 = engine.stats()["coalesced"]
    with ex.coalesce():
        futs = [ex.submit("closest_point", m, q_np[i, :n])
                for i, (m, n) in enumerate(zip(bodies, n_qs))]
        late = ex.submit("closest_point", bodies[0], q_np[0, :700],
                         deadline=monotonic() - 1.0)
        dropped = ex.submit("closest_point", bodies[1], q_np[1, :700])
        runs["cancelled"] = dropped.cancel()
    ex.drain()
    co1 = engine.stats()["coalesced"]
    runs["coalesced"] = {k: co1[k] - co0[k]
                         for k in ("dispatches", "requests")}
    runs["futures"] = [fu.result(timeout=60) for fu in futs]
    try:
        late.result(timeout=60)
        runs["late"] = "answered"
    except Exception as e:       # the check reads which error came back
        runs["late"] = type(e).__name__
    runs["requests"] = (bodies, n_qs)
    # 6. phase 14's ICP through the engine
    runs["icp"] = diff.register_vertices(
        inp["icp"][0], inp["icp"][1], inp["icp"][2], steps=REGISTER_STEPS,
        recorrespond_every=REGISTER_EVERY, device=dev).losses
    # 7. the large-batch template's normals (valence-256 poles)
    runs["normals_large"] = [run("normals large", lambda: (
        batched_vertex_normals(inp["large"], device=dev)))
        for _ in range(ENGINE_NORMAL_RUNS)]
    torch.cuda.synchronize()
    runs["drive_s"] = time.perf_counter() - t_drive
    launches = read_launches()
    facts = {"captures_s": captures, "plans": planner.plan_info(),
             "pool_bytes": planner.pool_bytes(dev),
             "reserved_before": reserved0,
             "reserved_after": torch.cuda.memory_reserved(),
             "stats": engine.stats()}
    return runs, launches, facts


def check_engine(runs, facts, inp, dev):
    """Phase 15's checks, after the counted drive: engine against the
    direct path (MESH_TPU_NO_ENGINE=1) and, for the graphs, against the
    eager step on each request's own shape, bit for bit; the plan counts;
    the coalesced dispatch; ICP; the normals' run-to-run bits and their
    float64 recompute.  Returns the record of the phase."""
    from mesh_tpu_torch import (
        Mesh,
        batched_closest_faces_and_points,
        batched_vertex_normals,
        batched_vertex_visibility,
        diff,
        fused_normals_and_closest_points,
    )
    from mesh_tpu_torch.batch import batch_step, visibility_step
    from mesh_tpu_torch.query import closest_kernel as ck
    from mesh_tpu_torch.query import culled_kernel as qk
    from mesh_tpu_torch.utils.knobs import tile_variant

    posed, f_np, q_np = inp["posed"], inp["f_np"], inp["queries"]
    verts, f, queries = inp["verts"], inp["f"], inp["queries_t"]
    variant = tile_variant()
    nondegen = ck.mesh_is_nondegenerate(posed, f_np.astype(np.int32))
    rec = {}
    # 0. every answer of the drive was its plan's run, a miss's too (on
    # the card, a graph's replay): as many runs as dispatches, the scan's
    # culled plan and the visibility plan among them
    plans = facts["plans"]
    dispatches = sum(row["count"] for row
                     in facts["stats"]["dispatch_latency"].values())
    replays = sum(p["runs"] for p in plans)
    check(all(p["backend"] == dev.type for p in plans)
          and replays == dispatches,
          "engine: %d plan runs for %d dispatches" % (replays, dispatches))
    n_scan = str(len(inp["scan"][1]))
    rec["replays"] = {
        "dispatches": dispatches,
        "scan_culled": [p["runs"] for p in plans
                        if p["key"][0] == "closest_point"
                        and p["key"][4] == n_scan],
        "visibility": [p["runs"] for p in plans
                       if p["key"][0] == "visibility"]}
    # (a CPU rehearsal's scan is above the crossover: the direct route)
    check(rec["replays"]["scan_culled"] == ([1] if dev.type == "cuda"
                                            else [])
          and rec["replays"]["visibility"] == [1],
          "engine: the scan's and the visibility plan's replays are %s"
          % rec["replays"])
    log("  %d dispatches, each a %s plan's run (the scan's culled plan and "
        "the visibility plan ran once each in the drive)"
        % (dispatches, dev.type))
    # 1. the facades against the direct path and against the eager step
    with no_engine():
        direct = {
            "closest": batched_closest_faces_and_points((posed, f_np), q_np,
                                                        device=dev),
            "fused": fused_normals_and_closest_points((posed, f_np), q_np,
                                                      device=dev),
            "normals": batched_vertex_normals((posed, f_np), device=dev),
            "visibility": batched_vertex_visibility(
                (inp["vis_posed"], f_np), inp["cams"], min_dist=VIS_MIN_DIST,
                device=dev)}
    for name in ("closest", "fused", "visibility"):
        check(same_arrays(runs[name], direct[name]),
              "engine %s differs from the direct path" % name)
    check(all(same_arrays(n, direct["normals"]) for n in runs["normals"]),
          "engine normals differ from the direct path or between runs")
    _, eager = batch_step(verts, f, queries, with_normals=False,
                          assume_nondegenerate=nondegen, tile_variant=variant)
    check(same_arrays(runs["closest"][0][:, 0], eager["face"].cpu().numpy()
                      .astype(np.uint32))
          and same_arrays(runs["closest"][1], eager["point"].cpu().numpy()
                          .astype(np.float64)),
          "engine closest differs from the eager batch_step")
    normals_e, eager_f = batch_step(verts, f, queries,
                                    assume_nondegenerate=nondegen,
                                    tile_variant=variant)
    check(same_arrays(runs["fused"][0], normals_e.cpu().numpy().astype(
        np.float64)) and same_arrays(runs["fused"][1][:, 0],
                                     eager_f["face"].cpu().numpy().astype(
                                         np.uint32)),
          "engine fused differs from the eager batch_step")
    vis_e, ndc_e = visibility_step(inp["verts_v"], f, inp["cams_t"],
                                   min_dist=VIS_MIN_DIST)
    check(same_arrays(runs["visibility"][0], vis_e.cpu().numpy().astype(
        np.uint32)) and same_arrays(runs["visibility"][1],
                                    ndc_e.cpu().numpy().astype(np.float64)),
          "engine visibility differs from the eager visibility_step")
    del eager, eager_f, normals_e, vis_e, ndc_e
    log("  facades (closest, fused, normals x %d, visibility) bit-identical "
        "to the direct path and to the eager step" % ENGINE_NORMAL_RUNS)
    # 2. Mesh on body 0: two plans made, the rest hits, bits the direct's
    body0 = Mesh(posed[0], f_np, device=dev)
    made = [runs["facade"][n][1] for n in ENGINE_FACADE_QS]
    check(made == [1, 0, 0, 1], "Mesh on body 0 at Q = %s made %s plans, "
          "not [1, 0, 0, 1]" % (ENGINE_FACADE_QS, made))
    for n_q in ENGINE_FACADE_QS:
        q = inp["q_facade"][:n_q]
        with no_engine():
            want = body0.closest_faces_and_points(q)
        got = runs["facade"][n_q][0]
        check(same_arrays(got, want), "Mesh Q=%d: engine differs from the "
              "direct route" % n_q)
        _, eager = batch_step(verts[:1], f, torch.as_tensor(
            q, device=dev)[None], with_normals=False,
            assume_nondegenerate=ck.mesh_is_nondegenerate(posed[0], f_np),
            tile_variant=variant)
        check(same_arrays(got[0][0], eager["face"][0].cpu().numpy().astype(
            np.uint32)), "Mesh Q=%d: engine differs from the eager step"
              % n_q)
    log("  Mesh on body 0 at Q = %s: plans made %s, every answer the "
        "direct route's and the eager step's" % (ENGINE_FACADE_QS, made))
    # 3. the scan through culled_faces: the eager kernel bit for bit, the
    # direct route (the streamed rope walk) under the tie contract
    v_s, f_s, p_s = inp["scan"]
    vt = torch.as_tensor(v_s, dtype=torch.float32, device=dev)
    ft = torch.as_tensor(f_s.astype(np.int64), device=dev)
    pt = torch.as_tensor(p_s, device=dev)
    eager = qk.closest_point_culled_kernel(
        vt, ft, pt, assume_nondegenerate=ck.mesh_is_nondegenerate(
            v_s.astype(np.float32), f_s.astype(np.int64)),
        tile_variant=variant)
    faces_s, points_s = runs["scan"]
    check(same_arrays(faces_s[0], eager["face"].cpu().numpy().astype(
        np.uint32)) and same_arrays(points_s, eager["point"].cpu().numpy()
                                    .astype(np.float64)),
          "scan: engine differs from the eager culled kernel")
    with no_engine():
        faces_d, points_d = Mesh(v_s, f_s, device=dev).closest_faces_and_points(
            p_s)
    sq = lambda p: torch.as_tensor(((p_s - p) ** 2).sum(-1), device=dev)[None]
    rec["scan_vs_direct"] = check_against_brute(
        "scan through the engine", vt[None], ft, pt[None],
        torch.as_tensor(faces_s.astype(np.int64), device=dev),
        sq(points_s), {"face": torch.as_tensor(faces_d.astype(np.int64),
                                               device=dev),
                       "sqdist": sq(points_d)},
        against="the direct route (streamed rope walk)")
    del vt, ft, pt, eager
    # 4. warmup, then real bodies: no plan made, the direct answers
    check(runs["warm_misses"] == 0, "after warmup() %d plans were made for "
          "SMPL-shaped bodies" % runs["warm_misses"])
    for (i, n_q), (cfp, fused) in zip(ENGINE_WARM_BODIES, runs["warm_bodies"]):
        m = Mesh(posed[i], f_np, device=dev)
        with no_engine():
            want = (m.closest_faces_and_points(q_np[i, :n_q]),
                    fused_normals_and_closest_points(m, q_np[i, :n_q],
                                                     device=dev))
        check(same_arrays((cfp, fused), want), "body %d after warmup(): the "
              "placeholder-captured plan differs from the direct path" % i)
    log("  warmup(): %d plans made in %.3f s; %d SMPL-shaped bodies then "
        "made none, answers the direct path's" % (
            runs["warmup_made"], runs["warmup_s"], len(ENGINE_WARM_BODIES)))
    # 5. the executor
    bodies, n_qs = runs["requests"]
    check(runs["coalesced"] == {"dispatches": 1,
                                "requests": ENGINE_REQUESTS},
          "executor: %s, not %d requests in one dispatch" % (
              runs["coalesced"], ENGINE_REQUESTS))
    check(runs["late"] == "DeadlineExceeded" and runs["cancelled"],
          "executor: the late request gave %s, cancelled %s" % (
              runs["late"], runs["cancelled"]))
    for i, (m, n, fut) in enumerate(zip(bodies, n_qs, runs["futures"])):
        check(same_arrays(fut, m.closest_faces_and_points(q_np[i, :n])),
              "executor request %d (Q=%d) differs from its facade call"
              % (i, n))
    log("  executor: %d requests (Q %d-%d) in 1 dispatch, each its facade "
        "call's bits; the late one DeadlineExceeded, the cancelled one "
        "skipped" % (ENGINE_REQUESTS, min(n_qs), max(n_qs)))
    # 6. ICP
    with no_engine():
        losses = diff.register_vertices(
            inp["icp"][0], inp["icp"][1], inp["icp"][2],
            steps=REGISTER_STEPS, recorrespond_every=REGISTER_EVERY,
            device=dev).losses
    check(losses == runs["icp"], "ICP: the engine's losses differ from the "
          "direct route's")
    log("  ICP: %d losses bit-identical to the direct route's (%.6g -> "
        "%.6g)" % (len(losses), losses[0], losses[-1]))
    # 7. normals: run to run, and against a float64 recompute
    rec["normals"] = {}
    for label, outs, (v_np, f_n) in (
            ("smpl", runs["normals"], (posed, f_np)),
            ("large", runs["normals_large"], inp["large"])):
        check(all(same_arrays(n, outs[0]) for n in outs),
              "%s normals differ between runs" % label)
        gap = normals_gap64(outs[0], v_np, f_n, dev)
        check(gap <= 1e-5, "%s normals %.3g from the float64 recompute"
              % (label, gap))
        rec["normals"][label] = gap
    log("  normals: %d runs bit-identical; float64 gaps %s" % (
        ENGINE_NORMAL_RUNS, rec["normals"]))
    # 8. the centering's mean: each body's bits alone its row's in the
    # batch, near the float64 mean
    center = ck.vertex_mean(verts)
    check(all(torch.equal(ck.vertex_mean(verts[i:i + 1]), center[i:i + 1])
              for i in range(0, verts.shape[0], 17)),
          "vertex_mean: a body alone differs from its row in the batch")
    rec["center_gap64"] = float((center.double() - verts.double().mean(
        dim=1, keepdim=True)).abs().max())
    check(rec["center_gap64"] <= 1e-6, "vertex_mean %.3g from the float64 "
          "mean" % rec["center_gap64"])
    log("  vertex_mean: bodies alone equal to their batch rows; %.3g from "
        "the float64 mean" % rec["center_gap64"])
    return rec


def normals_gap64(normals, v_np, f_np, dev):
    """Largest component gap of unit ``normals`` [B, V, 3] from a float64
    recompute (area-weighted face normals summed per vertex)."""
    v = torch.as_tensor(v_np, device=dev).double()
    f = torch.as_tensor(np.asarray(f_np, np.int64), device=dev)
    tri = v[:, f]
    fn = torch.cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0],
                     dim=-1)
    acc = torch.zeros_like(v)
    for k in range(3):
        acc.index_add_(1, f[:, k], fn)
    norm = acc.norm(dim=-1, keepdim=True)
    n64 = torch.where(norm > 0, acc / norm.clamp_min(1e-300), acc)
    return float((torch.as_tensor(normals, device=dev) - n64).abs().max())


def engine_times(inp, dev):
    """Host-clock ms of each op's warm engine call against its direct call
    (MESH_TPU_NO_ENGINE=1), in ENGINE_ROUNDS interleaved rounds after one
    warm call of each: {op: {"engine": spread, "direct": spread}}."""
    from mesh_tpu_torch import (
        Mesh,
        batched_closest_faces_and_points,
        batched_vertex_normals,
        batched_vertex_visibility,
        fused_normals_and_closest_points,
    )

    posed, f_np, q_np = inp["posed"], inp["f_np"], inp["queries"]
    body0 = Mesh(posed[0], f_np, device=dev)
    ops = {
        "closest_256x1024": lambda: batched_closest_faces_and_points(
            (posed, f_np), q_np, device=dev),
        "fused_256x1024": lambda: fused_normals_and_closest_points(
            (posed, f_np), q_np, device=dev),
        "normals_256": lambda: batched_vertex_normals((posed, f_np),
                                                      device=dev),
        "visibility_64x4": lambda: batched_vertex_visibility(
            (inp["vis_posed"], f_np), inp["cams"], min_dist=VIS_MIN_DIST,
            device=dev),
        "mesh_body0_q1500": lambda: body0.closest_faces_and_points(
            inp["q_facade"][:1500]),
    }
    out = {}
    for name, fn in ops.items():
        fn()
        with no_engine():
            fn()
        times = {"engine": [], "direct": []}
        for _ in range(ENGINE_ROUNDS):
            for side in ("engine", "direct"):
                t0 = time.perf_counter()
                if side == "direct":
                    with no_engine():
                        fn()
                else:
                    fn()
                times[side].append((time.perf_counter() - t0) * 1e3)
        out[name] = {side: spread(ms) for side, ms in times.items()}
    return out


# ---------------------------------------------------------------------------
# Phase 16: the reference's fallback routes.

def host_calls(fn, warm):
    """(first answer, first call ms, median warm call ms, warm answers) on
    the host clock: one cold call, then ``warm`` calls."""
    t0 = time.perf_counter()
    out = fn()
    first_ms = (time.perf_counter() - t0) * 1e3
    times, again = [], []
    for _ in range(warm):
        t0 = time.perf_counter()
        again.append(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return out, first_ms, statistics.median(times) if times else None, again


def counted_only(launches, allowed, what):
    """Every kernel but ``allowed`` launched 0 times in ``launches``."""
    extra = {k: n for k, n in launches.items() if n and k not in allowed}
    check(not extra, "%s launched %s" % (what, extra))


def drive_anchored(label, v, f, q, dev):
    """16a: one ``Mesh(v, f).compute_aabb_tree(strategy="anchored")``,
    its first ``nearest`` (the table build) and FALLBACK_WARM warm calls,
    counts set to 0 just before and read just after; then, outside the
    window, the tight share and every answer against the brute-force
    kernel.  The brute kernel launches once a call with a loose query
    (with its cull records)."""
    from mesh_tpu_torch import Mesh
    from mesh_tpu_torch.query import closest_kernel as ck
    from mesh_tpu_torch.query.anchored import (
        closest_point_anchored,
        closest_point_anchored_auto,
    )
    from mesh_tpu_torch.utils.dispatch import force_xla

    q_np = q.cpu().numpy() if torch.is_tensor(q) else q
    m = Mesh(v, f, device=dev)
    reset_launches()
    tree = m.compute_aabb_tree(strategy="anchored")
    (faces, points), first_ms, warm_ms, again = host_calls(
        lambda: tree.nearest(q_np), FALLBACK_WARM)
    launches = read_launches()
    check(all(np.array_equal(faces, a[0]) and np.array_equal(points, a[1])
              for a in again), "anchored %s: repeated calls disagree" % label)
    vt, ft = m.device_arrays()
    qt = torch.as_tensor(q_np, device=dev)
    res = closest_point_anchored(vt, ft, qt, *tree._tables, device=dev)
    tight = res["tight"]
    loose = int((~tight).sum())
    calls = 1 + FALLBACK_WARM
    # the loose queries re-run through the brute kernel, or under the knob
    # (a forced run) through the plain scan
    want = calls if loose and not force_xla() else 0
    check(launches["closest_faces"] == want
          and launches["cull_records"] == want,
          "anchored %s: %d loose queries, closest_faces launched %d times "
          "in %d calls" % (label, loose, launches["closest_faces"], calls))
    counted_only(launches, ("closest_faces", "cull_records"),
                 "anchored %s" % label)
    # the same call with its distances, against the brute kernel (a planted
    # far query's sqdist is held relatively: its float32 ulp passes 1e-5)
    auto = closest_point_anchored_auto(vt, ft, qt, tables=tree._tables,
                                       device=dev)
    check(np.array_equal(auto["face"].astype(np.uint32), faces[0])
          and np.array_equal(auto["point"].astype(np.float64), points),
          "anchored %s: the tree and closest_point_anchored_auto disagree"
          % label)
    brute = ck.closest_point_kernel(vt[None], ft, qt[None])
    near = torch.as_tensor(brute["sqdist"][0] < 1.0)
    far = ~near
    if bool(far.any()):
        rel = float(((torch.as_tensor(auto["sqdist"], device=dev)[far.to(dev)]
                      - brute["sqdist"][0][far.to(dev)]).abs()
                     / brute["sqdist"][0][far.to(dev)]).max())
        check(rel <= 1e-6, "anchored %s: far sqdist %.3g off" % (label, rel))
    sel = near.nonzero()[:, 0].to(dev)
    vs = check_against_brute(
        "anchored %s" % label, vt[None], ft, qt[sel][None],
        torch.as_tensor(auto["face"].astype(np.int64), device=dev)[sel][None],
        torch.as_tensor(auto["sqdist"], device=dev)[sel][None],
        {k: x[:, sel] for k, x in brute.items()})
    # the kernel route's call: the default tree (the auto ladder)
    auto_tree = m.compute_aabb_tree()
    with knobs_set(MESH_TPU_FORCE_XLA=0):
        kernel_ms = host_calls(lambda: auto_tree.nearest(q_np),
                               FALLBACK_WARM)[2]
    rec = {"faces": int(ft.shape[0]), "queries": int(qt.shape[0]),
           "first_call_ms": first_ms, "warm_call_ms": warm_ms,
           "kernel_route_warm_ms": kernel_ms,
           "tight_share": float(tight.float().mean()), "loose": loose,
           "closest_faces_launches": launches["closest_faces"],
           "vs_brute": vs}
    log("  anchored %s: %d faces x %d queries, first call (tables) %.1f ms, "
        "warm %.3f ms (the default tree's %.3f; host clock); tight %.4f, %d "
        "loose -> closest_faces %d launches in %d calls" % (
            label, rec["faces"], rec["queries"], first_ms, warm_ms,
            kernel_ms, rec["tight_share"], loose, launches["closest_faces"],
            calls))
    return rec


def entry_calls(inp, dev):
    """16b's entry points on phases 3-9's inputs -> {name: call}; the
    caller sets the knob (or not) and holds the counts."""
    from mesh_tpu_torch import Mesh, diff
    from mesh_tpu_torch.batch import (
        batched_closest_faces_and_points,
        batched_vertex_visibility,
    )
    from mesh_tpu_torch.query.closest_point import (
        closest_vertices_with_distance,
    )
    from mesh_tpu_torch.query.ray import self_intersection_count

    body0, f_np, q1 = inp["body0"], inp["f_np"], inp["q1"]
    m0 = Mesh(body0, f_np, device=dev)
    m_r = Mesh(body0, f_np, device=dev)
    body = Mesh(inp["body_v"], inp["body_f"], device=dev)
    calls = {
        "Mesh.closest_faces_and_points":
            lambda: m0.closest_faces_and_points(q1),
        "batched_closest_faces_and_points":
            lambda: batched_closest_faces_and_points(
                (inp["posed"][:FALLBACK_BATCH], f_np),
                inp["queries"][:FALLBACK_BATCH], device=dev),
        "closest_vertices": lambda: tuple(
            x.cpu().numpy() for x in closest_vertices_with_distance(
                body0, q1, device=dev)),
        "batched_vertex_visibility": lambda: batched_vertex_visibility(
            (inp["posed"][:FALLBACK_VIS_BATCH], f_np), inp["cams"],
            device=dev),
        "AabbTree.nearest_alongnormal":
            lambda: m_r.compute_aabb_tree().nearest_alongnormal(
                inp["reg_pts"], inp["reg_nrm"]),
        "AabbNormalsTree.nearest":
            lambda: m_r.compute_aabb_normals_tree().nearest(
                inp["reg_pts"], inp["reg_nrm"]),
        "intersections_indices":
            lambda: body.compute_aabb_tree().intersections_indices(
                inp["hand_v"], inp["hand_f"]),
        "self_intersection_count": lambda: int(self_intersection_count(
            body0, f_np, device=dev)),
        "diff.closest_point": lambda: {
            k: x.detach().cpu().numpy() for k, x in diff.closest_point(
                body0, f_np.astype(np.int64), q1, device=dev).items()},
    }
    return calls


def run_calls(calls):
    """{name: (answer, first call ms, second call ms)}, each call ended by
    a synchronize, on the host clock."""
    out = {}
    for name, fn in calls.items():
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ans = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = (ans, *times)
    return out


def check_forced(forced, kernel, inp, dev):
    """16b's checks, after the window: each forced answer against the
    kernel route's answer to the same call (``kernel``, run with the knob
    unset), under the fallback contracts; returns {name: what was
    found}."""
    from mesh_tpu_torch.query.visibility import visibility_rays

    from mesh_tpu_torch.query import closest_kernel as ck

    body0, f_np, q1 = inp["body0"], inp["f_np"], inp["q1"]
    v0 = torch.as_tensor(body0, device=dev)
    ft = torch.as_tensor(f_np.astype(np.int64), device=dev)
    q1_t = torch.as_tensor(q1, device=dev)
    found = {}

    def faces_points(name, faces, points, k_faces, k_points, v_b, q_b):
        """Faces but at ties, sqdist within 1e-5, both from the points."""
        q64 = q_b.cpu().numpy().astype(np.float64)

        def sq(p):
            return torch.as_tensor(((p - q64) ** 2).sum(-1),
                                   dtype=torch.float32, device=dev)

        def face(x):
            return torch.as_tensor(x.astype(np.int64), device=dev)
        found[name] = check_against_brute(
            "forced %s" % name, v_b, ft, q_b, face(faces), sq(points),
            {"face": face(k_faces), "sqdist": sq(k_points)}, quiet=True,
            against="the kernel route")

    name = "Mesh.closest_faces_and_points"
    (faces, points), (k_faces, k_points) = forced[name][0], kernel[name][0]
    faces_points(name, faces, points[None], k_faces, k_points[None],
                 v0[None], q1_t[None])
    name = "batched_closest_faces_and_points"
    (faces, points), (k_faces, k_points) = forced[name][0], kernel[name][0]
    faces_points(name, faces[:, 0], points, k_faces[:, 0], k_points,
                 torch.as_tensor(inp["posed"][:FALLBACK_BATCH], device=dev),
                 torch.as_tensor(inp["queries"][:FALLBACK_BATCH],
                                 device=dev))
    name = "diff.closest_point"
    res, k_res = forced[name][0], kernel[name][0]
    faces_points(name, res["face"][None], res["point"][None].astype(
        np.float64), k_res["face"][None], k_res["point"][None].astype(
            np.float64), v0[None], q1_t[None])
    # nearest vertices: the same index but at equidistant vertices
    idx, dist = forced["closest_vertices"][0]
    k_idx, k_dist = kernel["closest_vertices"][0]
    gap = float(np.abs(dist - k_dist).max())
    differ = idx != k_idx
    if differ.any():
        v64 = body0.astype(np.float64)
        q64 = q1.astype(np.float64)[differ]
        tie = np.abs(np.linalg.norm(q64 - v64[idx[differ]], axis=1)
                     - np.linalg.norm(q64 - v64[k_idx[differ]], axis=1))
        check(tie.max() <= 1e-6, "forced closest_vertices: %d differ, %.3g "
              "apart" % (int(differ.sum()), tie.max()))
    check(gap <= 1e-5, "forced closest_vertices: distance %.3g from the "
          "kernel's" % gap)
    found["closest_vertices"] = {"dist_gap": gap,
                                 "differ": int(differ.sum())}
    # visibility: flags equal but on rays borderline in float64
    vis, ndc = forced["batched_vertex_visibility"][0]
    k_vis, k_ndc = kernel["batched_vertex_visibility"][0]
    check(np.abs(ndc - k_ndc).max() <= 1e-5, "forced visibility: n.dir")
    differ = np.argwhere(vis != k_vis)
    border = 0
    verts_b = torch.as_tensor(inp["posed"][:FALLBACK_VIS_BATCH], device=dev)
    cams_t = torch.as_tensor(inp["cams"], device=dev)
    origins, dirs = visibility_rays(verts_b, cams_t, VIS_MIN_DIST)
    for b in np.unique(differ[:, 0]) if differ.size else ():
        rows = differ[differ[:, 0] == b]
        ray = torch.as_tensor(rows[:, 1] * body0.shape[0] + rows[:, 2],
                              device=dev)
        _, near = any_hit64(origins[b][ray], dirs[b].reshape(-1, 3)[ray],
                            verts_b[b][ft])
        check(bool(near.all()), "forced visibility, body %d: %d flags "
              "differ from the kernel's away from the float64 borderline"
              % (b, int((~near).sum())))
        border += int(near.sum())
    found["batched_vertex_visibility"] = {"differ": int(len(differ)),
                                          "borderline": border}
    # along-normal: hit flags equal but on borderline lines, distances near
    k_d, k_f, _ = kernel["AabbTree.nearest_alongnormal"][0]
    a_d, a_f, _ = forced["AabbTree.nearest_alongnormal"][0]
    hit, k_hit = a_d < 1e100, k_d < 1e100
    flip = np.nonzero(hit != k_hit)[0]
    if flip.size:
        sel = torch.as_tensor(flip, device=dev)
        pts = torch.as_tensor(inp["reg_pts"], device=dev)[sel]
        nrm = torch.as_tensor(inp["reg_nrm"], device=dev)[sel]
        tri = v0[ft]
        near = any_hit64(pts, nrm, tri, t_lo=-1e30)[1]
        check(bool(near.all()), "forced along-normal: %d hits differ from "
              "the kernel's away from the borderline" % int((~near).sum()))
    both = hit & k_hit
    d_gap = float(np.abs(a_d[both] - k_d[both]).max())
    check(d_gap <= 1e-4, "forced along-normal: distance %.3g from the "
          "kernel's" % d_gap)
    found["AabbTree.nearest_alongnormal"] = {
        "hits": int(hit.sum()), "hit_flips": int(flip.size),
        "dist_gap": d_gap, "faces_differ": int((a_f != k_f)[both].sum())}
    # normal-weighted: faces but at blended-cost ties, points near
    n_f, n_p = forced["AabbNormalsTree.nearest"][0]
    k_nf, k_np = kernel["AabbNormalsTree.nearest"][0]
    same = n_f[:, 0] == k_nf[:, 0]
    p_gap = float(np.abs(n_p[same] - k_np[same]).max())
    check(p_gap <= 1e-5, "forced normal-weighted: points %.3g from the "
          "kernel's" % p_gap)
    tie = 0.0
    if not same.all():
        sel = torch.as_tensor(np.nonzero(~same)[0], device=dev)
        pts = torch.as_tensor(inp["reg_pts"], device=dev)[sel]
        nrm = torch.as_tensor(inp["reg_nrm"], device=dev)[sel]
        mine = blended_min64(v0, ft, pts, nrm, torch.as_tensor(
            n_f[~same, 0].astype(np.int64), device=dev))[0]
        theirs = blended_min64(v0, ft, pts, nrm, torch.as_tensor(
            k_nf[~same, 0].astype(np.int64), device=dev))[0]
        tie = float((mine - theirs).abs().max())
        check(tie <= 1e-5, "forced normal-weighted: %d faces differ, "
              "%.3g apart in blended cost" % (int((~same).sum()), tie))
    found["AabbNormalsTree.nearest"] = {"differ": int((~same).sum()),
                                        "point_gap": p_gap, "tie_gap": tie}
    # intersections and self-intersection: the divided segment form against
    # its float64 predicate (phase 9 / 10's decide64)
    hand_tri = torch.as_tensor(inp["hand_v"].astype(np.float32),
                               device=dev)[torch.as_tensor(
                                   inp["hand_f"].astype(np.int64),
                                   device=dev)]
    body_tri = torch.as_tensor(inp["body_v"], device=dev)[torch.as_tensor(
        inp["body_f"].astype(np.int64), device=dev)]
    mask = torch.zeros(hand_tri.shape[0], dtype=torch.bool)
    mask[torch.as_tensor(forced["intersections_indices"][0])] = True
    differ_i, border_i = check_against64(
        "forced intersections", mask, decide64("segment", hand_tri,
                                               body_tri))
    found["intersections_indices"] = {"intersecting": int(mask.sum()),
                                      "differ64": differ_i,
                                      "borderline64": border_i}
    count = forced["self_intersection_count"][0]
    ids = ft.to(torch.int32)
    tri0 = v0[ft]
    exact, border = decide64("segment", tri0, tri0, ids, ids,
                             torch.arange(ft.shape[0], device=dev))
    n_exact, n_border = int(exact.sum()), int(border.sum())
    check(abs(count - n_exact) <= n_border, "forced self-intersection: %d "
          "faces, the float64 segment predicate %d (%d borderline)"
          % (count, n_exact, n_border))
    found["self_intersection_count"] = {
        "count": count, "count64": n_exact, "borderline64": n_border,
        "kernel_count": kernel["self_intersection_count"][0]}
    found["intersections_indices"]["kernel_intersecting"] = int(
        kernel["intersections_indices"][0].size)
    return found


def drive_xla_culled(v, f, q, dev):
    """16c: the auto facade's top-k culled rung under the knob on one
    large body: counts set to 0 before and read after, the route once a
    call, the fallback reported, the answers against the brute kernel."""
    from mesh_tpu_torch.obs.metrics import REGISTRY
    from mesh_tpu_torch.query import closest_kernel as ck
    from mesh_tpu_torch.query import culled as auto

    fallback = REGISTRY.counter("mesh_tpu_query_certificate_fallback_total")
    strategy = REGISTRY.counter("mesh_tpu_query_strategy_total")
    before = fallback.value(), strategy.value(path="xla_culled")
    auto.STRATEGY.clear()
    reset_launches()
    with knobs_set(MESH_TPU_FORCE_XLA=1):
        res, first_ms, warm_ms, again = host_calls(
            lambda: auto.closest_faces_and_points_auto(v, f, q, device=dev),
            FALLBACK_WARM)
    launches = read_launches()
    calls = 1 + FALLBACK_WARM
    counted_only(launches, (), "xla_culled")
    check(dict(auto.STRATEGY) == {"xla_culled": calls}
          and strategy.value(path="xla_culled") - before[1] == calls,
          "xla_culled: routes %s" % auto.STRATEGY)
    check(all(np.array_equal(res["face"], a["face"]) for a in again),
          "xla_culled: repeated calls disagree")
    fell_back = (fallback.value() - before[0]) // calls
    vt = torch.as_tensor(v, device=dev)[None]
    ft = torch.as_tensor(np.asarray(f, np.int64), device=dev)
    qt = torch.as_tensor(q, device=dev)[None]
    brute = ck.closest_point_kernel(vt, ft, qt)
    vs = check_against_brute(
        "xla_culled", vt, ft, qt,
        torch.as_tensor(res["face"].astype(np.int64), device=dev)[None],
        torch.as_tensor(res["sqdist"], device=dev)[None], brute)
    # the kernel route's call: the same facade without the knob
    with knobs_set(MESH_TPU_FORCE_XLA=0):
        kernel_ms = host_calls(lambda: auto.closest_faces_and_points_auto(
            v, f, q, device=dev), FALLBACK_WARM)[2]
    rec = {"faces": int(ft.shape[0]), "queries": int(qt.shape[1]),
           "first_call_ms": first_ms, "warm_call_ms": warm_ms,
           "kernel_route_warm_ms": kernel_ms,
           "fallback_per_call": int(fell_back), "vs_brute": vs}
    log("  xla_culled: %d faces x %d queries, route once a call (%d), "
        "%d loose queries re-run a call; first %.1f ms, warm %.3f ms (the "
        "kernel route's %.3f; host clock)" % (
            rec["faces"], rec["queries"], calls, fell_back, first_ms,
            warm_ms, kernel_ms))
    return rec


def drive_walk(label, knob, kind, v, f, q, dev):
    """16d: the accel facade's plain walk (``knob`` set: the index ``kind``
    it reads or the rope walks it turns off) on the scan: the index build
    and its upload, then one call with its stats (warm: nothing is left to
    build), counts set to 0 before and read after (no kernel may launch);
    then the answers against the brute kernel, and the first WALK_CHECK
    queries bit for bit against the plain scan on the card."""
    from mesh_tpu_torch.accel.build import clear_index_cache, get_index
    from mesh_tpu_torch.accel.traverse import closest_faces_and_points_accel
    from mesh_tpu_torch.query import closest_kernel as ck
    from mesh_tpu_torch.query.closest_point import closest_faces_and_points_t

    clear_index_cache()
    reset_launches()
    with knobs_set(**knob):
        t0 = time.perf_counter()
        index = get_index(v, f, kind=kind)
        build_s = time.perf_counter() - t0
        index.on(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, stats = closest_faces_and_points_accel(v, f, q, with_stats=True,
                                                    device=dev)
        warm_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    counted_only(launches, (), "walk %s" % label)
    check(stats["backend"] == "xla", "walk %s took %s" % (label,
                                                          stats["backend"]))
    vt = torch.as_tensor(v, device=dev)
    ft = torch.as_tensor(np.asarray(f, np.int64), device=dev)
    qt = torch.as_tensor(q, device=dev)
    brute = ck.closest_point_kernel(vt[None], ft, qt[None])
    vs = check_against_brute(
        "walk %s" % label, vt[None], ft, qt[None],
        torch.as_tensor(res["face"].astype(np.int64), device=dev)[None],
        torch.as_tensor(res["sqdist"], device=dev)[None], brute)
    del brute
    scan = closest_faces_and_points_t(vt, ft, qt[:WALK_CHECK])
    check(all(np.array_equal(res[k][:WALK_CHECK], x.cpu().numpy())
              for k, x in scan.items()),
          "walk %s: the first %d answers differ from the plain scan"
          % (label, WALK_CHECK))
    # the kernel route's call: the same facade without the knob
    with knobs_set(MESH_TPU_FORCE_XLA=0):
        kernel_ms = host_calls(lambda: closest_faces_and_points_accel(
            v, f, q, device=dev), WALK_WARM)[2]
    rec = dict(stats, build_s=build_s, warm_call_ms=warm_ms,
               kernel_route_warm_ms=kernel_ms,
               vs_brute=vs, index=dict(index.meta),
               scan_bit_equal=WALK_CHECK)
    log("  walk %s (%s): build %.3f s; tight %.4f, %d loose re-run through "
        "the plain scan, %d pair tests%s; a call %.1f ms (the kernel route's "
        "%.1f; host clock); first %d answers bit-equal to the plain scan" % (
            label, kind, build_s, stats["tight_frac"], stats["fallback"],
            stats["pair_tests"],
            ", steps max %d mean %.1f" % (stats["steps_max"],
                                          stats["steps_mean"])
            if "steps_max" in stats else "", warm_ms, kernel_ms,
            WALK_CHECK))
    return rec


def drive_calibrations(dev):
    """16e: the four calibrations with ``save=False``, each ladder logged;
    the in-process measurements they set are restored, and the thresholds
    must read as before."""
    from mesh_tpu_torch.query import autotune

    names = ("_measured", "_accel_measured", "_stream_measured",
             "_mxu_measured")
    accessors = (autotune.crossover_faces, autotune.accel_crossover_faces,
                 autotune.stream_tile_params, autotune.mxu_crossover_faces)
    saved = {name: getattr(autotune, name) for name in names}
    before = [fn() for fn in accessors]
    rec = {}
    for name, run in (
            ("crossover", autotune.calibrate_crossover),
            ("accel_crossover", autotune.calibrate_accel_crossover),
            ("stream_tiles", autotune.calibrate_stream_tiles),
            ("mxu_crossover", autotune.calibrate_mxu_crossover)):
        t0 = time.perf_counter()
        got = run(save=False, device=dev)
        rec[name] = dict(autotune.CALIBRATIONS[name],
                         seconds=time.perf_counter() - t0)
        rows = rec[name].get("ladder") or rec[name].get("sweep")
        log("  calibrate %s(save=False): %s in %.1f s (stable %s); %s" % (
            name, got, rec[name]["seconds"], rec[name]["stable"],
            "; ".join(", ".join("%s %s" % (k, ("%.3f ms" % (x * 1e3))
                                           if k == "t" or k.startswith("t_")
                                           else x)
                                for k, x in row.items()) for row in rows)))
    for name, value in saved.items():
        setattr(autotune, name, value)
    after = [fn() for fn in accessors]
    check(after == before, "calibrations left the thresholds %s, were %s"
          % (after, before))
    rec["thresholds"] = after
    return rec


def fallback_inputs(posed, f_np, q1_np, queries, reg_pts, reg_nrm, verts_l,
                    f_l, queries_l, scan, contact):
    """Phase 16's inputs, as numpy arrays: phases 3-9's."""
    body_v, body_f, hand_v, hand_f = contact
    return {"body0": posed[0], "f_np": f_np, "q1": q1_np, "posed": posed,
            "queries": queries.cpu().numpy(),
            "cams": np.asarray(VIS_CAMERAS, np.float32),
            "reg_pts": reg_pts.cpu().numpy(),
            "reg_nrm": reg_nrm.cpu().numpy(),
            "large0": verts_l[0].cpu().numpy(), "f_l": f_l.cpu().numpy(),
            "large_q": queries_l[0].cpu().numpy(), "scan": scan,
            "body_v": body_v, "body_f": body_f, "hand_v": hand_v,
            "hand_f": hand_f}


def drive_fallback(inp, dev, smi, calibrate=True):
    """Phase 16 (16e only with ``calibrate``) -> its record."""
    from mesh_tpu_torch.accel.build import clear_index_cache
    from mesh_tpu_torch.obs.metrics import REGISTRY

    log("== fallback: anchored tables, MESH_TPU_FORCE_XLA at every entry "
        "point, the top-k culled rung, the plain grid and BVH walks%s"
        % (", the calibrations" if calibrate else ""))
    t_fb = time.perf_counter()
    fallback = {"anchored": {
        "scan": drive_anchored("scan", inp["body0"], inp["f_np"],
                               inp["reg_pts"], dev),
        "large": drive_anchored("large", inp["large0"], inp["f_l"],
                                inp["large_q"], dev)}}
    backend = REGISTRY.counter("mesh_tpu_dispatch_backend_total")
    before = (backend.value(backend="xla", reason="forced"),
              backend.value(backend="pallas", reason="platform"))
    calls = entry_calls(inp, dev)
    reset_launches()
    with knobs_set(MESH_TPU_FORCE_XLA=1):
        forced = run_calls(calls)
    launches = read_launches()
    counted_only(launches, (), "MESH_TPU_FORCE_XLA's window")
    decisions = backend.value(backend="xla", reason="forced") - before[0]
    check(decisions >= len(forced)
          and backend.value(backend="pallas", reason="platform")
          == before[1], "MESH_TPU_FORCE_XLA: %d forced decisions for %d "
          "entry points" % (decisions, len(forced)))
    with knobs_set(MESH_TPU_FORCE_XLA=0):
        kernel = run_calls(calls)
        checks = check_forced(forced, kernel, inp, dev)
    fallback["forced"] = {
        "decisions": decisions, "checks": checks,
        "ms": {name: {"xla_first": run[1], "xla_second": run[2],
                      "kernel_first": kernel[name][1],
                      "kernel_second": kernel[name][2]}
               for name, run in forced.items()}}
    log("  MESH_TPU_FORCE_XLA: %d entry points, %d forced decisions, no "
        "kernel launched; second call, XLA form against the kernel route "
        "(host clock, ms): %s" % (len(forced), decisions, ", ".join(
            "%s %.1f / %.1f" % (name, t["xla_second"], t["kernel_second"])
            for name, t in fallback["forced"]["ms"].items())))
    del forced, kernel
    fallback["xla_culled"] = drive_xla_culled(inp["large0"], inp["f_l"],
                                              inp["large_q"], dev)
    fallback["walks"] = {
        "grid": drive_walk("grid", {"MESH_TPU_ACCEL_KIND": "grid"}, "grid",
                           *inp["scan"], dev),
        "bvh": drive_walk("bvh", {"MESH_TPU_BVH_STREAM": "0"}, "bvh",
                          *inp["scan"], dev)}
    clear_index_cache()
    if calibrate:
        fallback["calibrations"] = drive_calibrations(dev)
    fallback["wall_s"] = time.perf_counter() - t_fb
    log("fallback record (%.1f s on %s): %s" % (
        fallback["wall_s"], smi, json.dumps(fallback)))
    return fallback


# ---------------------------------------------------------------------------
# Phase 17: the psbody-style domain workflow.

def domain_inputs(model, posed0):
    """Phase 17's inputs: the rest template and posed body 0 (float64), the
    faces, a segmentation into the joints' parts (each face takes the
    argmax of its three corners' summed skinning weights) and
    DOMAIN_LANDMARKS landmarks (template vertices plus
    N(0, DOMAIN_LANDMARK_SIGMA), from a seeded generator)."""
    rest = model.v_template.cpu().numpy().astype(np.float64)
    f_np = model.faces.cpu().numpy().astype(np.uint32)
    w = model.lbs_weights.cpu().numpy().astype(np.float64)
    part = w[f_np.astype(np.int64)].sum(axis=1).argmax(axis=1)
    segm = {"part%02d" % j: np.flatnonzero(part == j).tolist()
            for j in range(w.shape[1]) if (part == j).any()}
    rng = np.random.RandomState(17)
    picks = rng.choice(len(rest), DOMAIN_LANDMARKS, replace=False)
    landmarks = {"lm%02d" % i: rest[k] + rng.randn(3) * DOMAIN_LANDMARK_SIGMA
                 for i, k in enumerate(picks)}
    return {"rest": rest, "posed0": np.asarray(posed0, np.float64),
            "f": f_np, "segm": segm, "landmarks": landmarks}


def held_values(kind, v):
    """What a file of DOMAIN_FORMATS ``kind`` holds of float64 ``v``: float32
    (binary PLY), C's %g of the float32 (ascii PLY), %f (OBJ), the value
    itself (JSON)."""
    if kind == "ply_binary":
        return v.astype(np.float32).astype(np.float64)
    if kind == "ply_ascii":
        text = ["%g" % c for c in v.astype(np.float32).ravel()]
    elif kind == "obj":
        text = ["%f" % c for c in v.ravel()]
    else:
        return v
    return np.array([float(c) for c in text]).reshape(v.shape)


def domain_files(inp, dev, folder):
    """Step a: posed body 0 written in every format of DOMAIN_FORMATS and
    read back through ``Mesh(filename=...)`` and, for PLY and OBJ, by the
    native and the Python readers: each ``v`` / ``f`` bit-equal to what the
    file holds, with the reference's dtypes."""
    from mesh_tpu_torch import Mesh
    from mesh_tpu_torch.serialization import native
    from mesh_tpu_torch.serialization import obj as obj_io
    from mesh_tpu_torch.serialization import ply as ply_io

    check(native.available(), "the native reader did not build: %s"
          % native.library_path())
    body = Mesh(v=inp["posed0"], f=inp["f"], device=dev)
    readers = {"ply": (("native", native.load_ply_native, "pts", "tri"),
                       ("python", ply_io.read_ply, "pts", "tri")),
               "obj": (("native", native.load_obj_native, "v", "f"),
                       ("python", obj_io.load_obj, "v", "f")),
               "json": ()}
    rec = {}
    for kind, (ext, kw) in DOMAIN_FORMATS.items():
        path = os.path.join(folder, "body0_%s.%s" % (kind, ext))
        getattr(body, "write_" + ext)(path, **kw)
        want_v, want_f = held_values(kind, body.v), body.f.astype(np.int64)
        back = Mesh(filename=path, device=dev)
        check(back.v.dtype == np.float64 and back.f.dtype == np.uint32,
              "step a, %s: dtypes %s, %s" % (kind, back.v.dtype, back.f.dtype))
        got = {"facade": (back.v, back.f)}
        for name, read, vk, fk in readers[ext]:
            data = read(path)
            got[name] = (data[vk], data[fk])
        for name, (v_, f_) in got.items():
            check(np.array_equal(v_, want_v)
                  and np.array_equal(np.asarray(f_, np.int64), want_f),
                  "step a, %s through the %s reader: v or f differs from "
                  "what the file holds" % (kind, name))
        rec[kind] = {"bytes": os.path.getsize(path), "readers": sorted(got)}
    return rec


def domain_planes(v):
    """Three planes across the longest axis of ``v``'s box, at 30, 50 and
    70 percent of its extent: (normal, distance) pairs."""
    lo, hi = v.min(axis=0), v.max(axis=0)
    axis = int(np.argmax(hi - lo))
    normal = np.eye(3)[axis]
    return [(normal, float(lo[axis] + t * (hi[axis] - lo[axis])))
            for t in (0.3, 0.5, 0.7)]


def domain_workflow(inp, dev, folder, second_level):
    """Steps a-e on ``dev`` (d only with ``second_level``) -> (meshes and
    answers, seconds a step)."""
    from mesh_tpu_torch import Mesh
    from mesh_tpu_torch.topology import loop_subdivider

    out, times = {}, {}

    def step(name, fn):
        t0 = time.perf_counter()
        result = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return result

    out["files"] = step("a_files", lambda: domain_files(inp, dev, folder))

    def landmarks():
        body = Mesh(v=inp["rest"], f=inp["f"],
                    segm={k: list(x) for k, x in inp["segm"].items()},
                    device=dev)
        body.set_landmarks_from_xyz(dict(inp["landmarks"]))
        body.recompute_landmark_indices()
        return body

    body = out["body"] = step("b_landmarks", landmarks)
    s1 = out["s1"] = step("c_subdivide", lambda: loop_subdivider(body)(body))
    if second_level:
        out["s2"] = step("d_subdivide", lambda: loop_subdivider(s1)(s1))

    def edits():
        dec = body.simplified(factor=0.5)(body)
        uniq = dec.uniquified_mesh()
        work = Mesh(v=body.v, f=body.f, device=dev)
        work.set_landmarks_from_xyz(dict(inp["landmarks"]))
        work.keep_vertices(np.flatnonzero(np.arange(len(work.v)) % 10 != 0))
        work.remove_faces(np.arange(0, len(work.f), 7))
        work.concatenate_mesh(dec)
        work.reorder_vertices(np.random.RandomState(18).permutation(
            len(work.v)))
        work.flip_faces()
        cent = Mesh(v=body.v, f=body.f, device=dev)
        cent.subdivide_triangles()
        circ = [body.estimate_circumference(n, d)
                for n, d in domain_planes(body.v)]
        flags = np.asarray(body.vertex_visibility(DOMAIN_CAMERA))
        seen = body.visible_mesh(DOMAIN_CAMERA)
        return {"dec": dec, "uniq": uniq, "work": work, "cent": cent,
                "circumference": circ, "flags": flags, "seen": seen}

    out.update(step("e_edits", edits))
    return out, times


def part_gaps64(centroids, donor_v, donor_f, donor_parts, parts, dev):
    """For each centroid [N, 3], in float64 on ``dev``: the distance to the
    nearest donor face of its part (``parts`` [N]) less the distance to the
    nearest donor face of any part."""
    from mesh_tpu_torch.query.point_triangle import closest_point_on_triangle

    tri = torch.as_tensor(np.asarray(donor_v, np.float64), device=dev)[
        torch.as_tensor(np.asarray(donor_f, np.int64), device=dev)]
    code = {n: i for i, n in enumerate(sorted(set(donor_parts) | set(parts)))}
    dp = torch.as_tensor([code[n] for n in donor_parts], device=dev)
    qp = torch.as_tensor([code[n] for n in parts], device=dev)
    c = torch.as_tensor(np.asarray(centroids, np.float64), device=dev)
    gaps = []
    for i in range(0, c.shape[0], 128):
        d = closest_point_on_triangle(c[i:i + 128, None], tri[None, :, 0],
                                      tri[None, :, 1], tri[None, :, 2])[1]
        own = d.masked_fill(dp[None] != qp[i:i + 128, None], float("inf"))
        gaps.append(own.min(dim=1).values.clamp_min(0).sqrt()
                    - d.min(dim=1).values.clamp_min(0).sqrt())
    return torch.cat(gaps).cpu().numpy()


def check_parts(label, card, cpu, donor, dev):
    """``transfer_segm``'s parts on the card against the CPU run's: equal
    face for face, except where both parts hold a donor face at the least
    float64 distance from the face's centroid (a tie)."""
    check(sorted(card.segm) == sorted(cpu.segm), "%s: parts %s against %s"
          % (label, sorted(card.segm), sorted(cpu.segm)))
    mine, theirs = np.array(card.parts_by_face()), np.array(cpu.parts_by_face())
    differ = np.flatnonzero(mine != theirs)
    gap = 0.0
    if differ.size:
        cen = cpu.v[cpu.f[differ].astype(np.int64)].mean(axis=1)
        for parts in (mine[differ], theirs[differ]):
            gaps = part_gaps64(cen, donor.v, donor.f, donor.parts_by_face(),
                               parts.tolist(), dev)
            gap = max(gap, float(gaps.max()))
        check(gap <= DOMAIN_TIE, "%s: %d faces take another part than on "
              "the CPU, %.3g beyond a float64 tie" % (label, differ.size, gap))
    return {"faces": int(len(mine)), "differ": int(differ.size),
            "tie_gap": gap}


def check_landmarks(label, card, cpu):
    """Landmark indices equal but at float64 ties of the nearest vertex;
    regressors on the same face (or a float64 tie), coefficients within
    DOMAIN_COEFF_TOL."""
    from mesh_tpu_torch.query.point_triangle import closest_point_on_triangle

    check(list(card.landm) == list(cpu.landm), "%s: landmark names" % label)
    xyz = {k: np.asarray(cpu.landm_raw_xyz[k], np.float64)
           for k in cpu.landm}
    differ, coeff_gap = 0, 0.0
    for name in cpu.landm:
        a, b = card.landm[name], cpu.landm[name]
        if a != b:
            gap = abs(np.linalg.norm(xyz[name] - cpu.v[a])
                      - np.linalg.norm(xyz[name] - cpu.v[b]))
            check(gap <= DOMAIN_TIE, "%s: landmark %s at vertex %d, on the "
                  "CPU %d, %.3g beyond a tie" % (label, name, a, b, gap))
            differ += 1
    check(list(card.landm_regressors) == list(cpu.landm_regressors),
          "%s: regressor names" % label)
    for name in cpu.landm_regressors:
        (ci, cc), (pi, pc) = card.landm_regressors[name], \
            cpu.landm_regressors[name]
        if np.array_equal(ci, pi):
            coeff_gap = max(coeff_gap, float(np.abs(cc - pc).max()))
            continue
        tri = torch.as_tensor(cpu.v[np.stack([ci, pi]).astype(np.int64)])
        p = torch.as_tensor(xyz[name])[None]
        d = closest_point_on_triangle(p, tri[:, 0], tri[:, 1], tri[:, 2])[1]
        gap = float(abs(d[0].sqrt() - d[1].sqrt()))
        check(gap <= DOMAIN_TIE, "%s: landmark %s regressed on another face "
              "than on the CPU, %.3g beyond a tie" % (label, name, gap))
        differ += 1
    check(coeff_gap <= DOMAIN_COEFF_TOL, "%s: regressor coefficients %.3g "
          "from the CPU's" % (label, coeff_gap))
    return {"landmarks": len(cpu.landm), "differ": differ,
            "coeff_gap": coeff_gap}


def same_mesh(label, a, b, attrs=("v", "f")):
    for name in attrs:
        check(same_arrays(getattr(a, name), getattr(b, name)),
              "%s: %s differs from the CPU run's" % (label, name))


def check_domain(card, cpu, inp, dev):
    """Steps a-c and e on the card against the same workflow on the CPU
    (the port's plain versions): numpy outputs bit for bit, the kernels'
    answers under the tie contract."""
    from mesh_tpu_torch.query.visibility import visibility_rays

    checks = {"files": card["files"]}
    body_c, body_h = card["body"], cpu["body"]
    checks["landmarks"] = check_landmarks("step b", body_c, body_h)
    same_mesh("step c", card["s1"], cpu["s1"])
    check(len(card["s1"].f) == 4 * len(inp["f"]), "step c: %d faces"
          % len(card["s1"].f))
    check(card["s1"].landm == cpu["s1"].landm, "step c: landmarks")
    checks["subdivide_parts"] = check_parts("step c", card["s1"], cpu["s1"],
                                            body_h, dev)
    same_mesh("step e, simplified", card["dec"], cpu["dec"])
    checks["simplified_parts"] = check_parts("step e, simplified",
                                             card["dec"], cpu["dec"],
                                             body_h, dev)
    same_mesh("step e, uniquified", card["uniq"], cpu["uniq"])
    gap = float(np.abs(card["uniq"].vn - cpu["uniq"].vn).max())
    check(gap <= DOMAIN_NORMAL_TOL, "step e, uniquified: normals %.3g from "
          "the CPU's" % gap)
    checks["uniquified_normal_gap"] = gap
    same_mesh("step e, edited", card["work"], cpu["work"])
    checks["edited_landmarks"] = check_landmarks("step e, edited",
                                                 card["work"], cpu["work"])
    same_mesh("step e, centroid split", card["cent"], cpu["cent"])
    check(card["circumference"] == cpu["circumference"],
          "step e: circumferences %s against %s"
          % (card["circumference"], cpu["circumference"]))
    flags_c, flags_h = card["flags"], cpu["flags"]
    differ = np.flatnonzero(flags_c != flags_h)
    if differ.size:
        v = torch.as_tensor(body_h.v[differ].astype(np.float32),
                            device=dev)[None]
        cam = torch.tensor([DOMAIN_CAMERA], dtype=torch.float32, device=dev)
        origins, dirs = visibility_rays(v, cam, VIS_MIN_DIST)
        tri = torch.as_tensor(body_h.v.astype(np.float32), device=dev)[
            torch.as_tensor(body_h.f.astype(np.int64), device=dev)]
        near = any_hit64(origins[0], dirs[0].reshape(-1, 3), tri)[1]
        check(bool(near.all()), "step e: %d visibility flags differ from "
              "the CPU's away from the float64 borderline"
              % int((~near).sum()))
    else:
        same_mesh("step e, visible part", card["seen"], cpu["seen"])
    check(len(card["seen"].v) == int(flags_c.astype(bool).sum()),
          "step e: the visible mesh's vertices")
    checks["visibility"] = {"visible": int(flags_c.astype(bool).sum()),
                            "differ": int(differ.size)}
    return checks


def check_second_level(s1, s2, dev):
    """Step d: 16 times the template's faces, every face in a part, and on
    DOMAIN_CHECK_FACES seeded faces the part of a donor face at the least
    float64 distance from the face's centroid (up to ties)."""
    check(len(s2.f) == 4 * len(s1.f), "step d: %d faces from %d"
          % (len(s2.f), len(s1.f)))
    parts = np.array(s2.parts_by_face())
    check(bool((parts != "").all()), "step d: faces without a part")
    sample = np.random.RandomState(19).choice(len(s2.f), DOMAIN_CHECK_FACES,
                                              replace=False)
    cen = s2.v[s2.f[sample].astype(np.int64)].mean(axis=1)
    gaps = part_gaps64(cen, s1.v, s1.f, s1.parts_by_face(),
                       parts[sample].tolist(), dev)
    check(float(gaps.max()) <= DOMAIN_TIE, "step d: %d of %d sampled faces "
          "take a part with no donor face at the least float64 distance "
          "(gap %.3g)" % (int((gaps > DOMAIN_TIE).sum()), len(sample),
                          float(gaps.max())))
    return {"faces": int(len(s2.f)), "donor_faces": int(len(s1.f)),
            "checked": int(len(sample)), "max_gap": float(gaps.max()),
            "ties": int((gaps > 0).sum())}


def drive_domain(model, posed0, dev, smi):
    """Phase 17 -> (its record, launches on its card run)."""
    import shutil

    from mesh_tpu_torch.query.autotune import crossover_faces

    inp = domain_inputs(model, posed0)
    log("== domain: posed body 0 through PLY, OBJ and JSON, %d landmarks, "
        "a %d-part segmentation, two Loop levels, decimation and the edits"
        % (DOMAIN_LANDMARKS, len(inp["segm"])))
    folder = os.path.join(_REPO, "build", "chip_smoke_domain")
    shutil.rmtree(folder, ignore_errors=True)
    for side in ("card", "cpu"):
        os.makedirs(os.path.join(folder, side))
    try:
        reset_launches()
        t0 = time.perf_counter()
        card, times = domain_workflow(inp, dev, os.path.join(folder, "card"),
                                      second_level=True)
        wall = time.perf_counter() - t0
        launches = read_launches()
        t0 = time.perf_counter()
        cpu, cpu_times = domain_workflow(inp, torch.device("cpu"),
                                         os.path.join(folder, "cpu"),
                                         second_level=False)
        cpu_wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    rec = {"checks": check_domain(card, cpu, inp, dev)}
    rec["second_level"] = check_second_level(card["s1"], card["s2"], dev)
    culled = len(card["s1"].f) > crossover_faces()
    needed = {"closest_faces", "cull_records", "nearest_vertices",
              "ray_any_hit_culled"} | ({"culled_faces"} if culled else set())
    for name in sorted(needed):
        check(launches[name] > 0, "kernel %s never launched on the domain "
              "path" % name)
    counted_only(launches, needed, "the domain path")
    rec.update({"wall_s": wall, "steps_s": times, "cpu_wall_s": cpu_wall,
                "cpu_steps_s": cpu_times, "budget_s": DOMAIN_BUDGET_S,
                "launches": {k: n for k, n in launches.items() if n},
                "faces": {"template": int(len(inp["f"])),
                          "level1": int(len(card["s1"].f)),
                          "level2": int(len(card["s2"].f)),
                          "simplified": int(len(card["dec"].f))}})
    log("  domain on the card %.1f s (budget %.0f s): %s; the CPU run %.1f s"
        % (wall, DOMAIN_BUDGET_S, ", ".join(
            "%s %.2f" % kv for kv in times.items()), cpu_wall))
    log("  launches: %s" % rec["launches"])
    log("domain record (on %s): %s" % (smi, json.dumps(rec)))
    return rec, launches


# ---------------------------------------------------------------------------
# Phase 18: the serving tier.

def serve_inputs(posed0, f_np, template_v, template_f, template_q):
    """Phase 18's meshes and requests: posed body 0 with SERVE_QUERIES
    N(0, 0.4) queries (bench.py's) and as many near its surface (random
    vertices with N(0, SERVE_NEAR_NOISE) noise, for the anchored rung: most
    of them tight), phase 5's posed 98,304-face body 0 with its
    LARGE_QUERIES scan-like queries."""
    rng = np.random.RandomState(18)
    body_v = np.asarray(posed0, np.float32)
    near = body_v[rng.randint(0, len(body_v), SERVE_QUERIES)]
    return {"body": (body_v, np.asarray(f_np)),
            "body_q": np.asarray(rng.randn(SERVE_QUERIES, 3) * 0.4,
                                 np.float32),
            "body_q_near": np.asarray(
                near + rng.randn(SERVE_QUERIES, 3) * SERVE_NEAR_NOISE,
                np.float32),
            "template": (np.asarray(template_v, np.float32),
                         np.asarray(template_f)),
            "template_q": np.asarray(template_q, np.float32)}


class _Launches(object):
    """Per-step launch counts inside one counted window: the difference of
    the counts around each step (nothing is set to 0 inside the window)."""

    def __init__(self):
        self.steps = {}
        self._last = read_launches()

    def mark(self, step):
        now = read_launches()
        self.steps[step] = {k: now[k] - self._last.get(k, 0) for k in now
                            if now[k] != self._last.get(k, 0)}
        self._last = now


def serve_rung(make_service, name, mesh, q):
    """(b): a one-rung ladder ``name`` (picked by MESH_TPU_SERVE_LADDER)
    warmed, then one request: (rung names warmed, the response, the
    request's ledger row)."""
    from mesh_tpu_torch.obs import get_ledger
    from mesh_tpu_torch.serve import default_ladder

    with knobs_set(MESH_TPU_SERVE_LADDER=name):
        ladder = default_ladder()
    service = make_service(ladder=ladder,
                           default_deadline_s=SERVE_RUNG_DEADLINE_S)
    rows = []
    try:
        warmed = service.warmup(mesh, queries=256)
        get_ledger().add_listener(rows.append)
        try:
            resp = service.query(mesh, q, tenant="rung-" + name)
        finally:
            get_ledger().remove_listener(rows.append)
    finally:
        service.stop(write_stats=False)
    return warmed, resp, rows[-1]


class _GcPauses(object):
    """A ``gc.callbacks`` hook: per round, the collections of each
    generation and their pauses (ms, host clock)."""

    def __init__(self):
        self._t0 = None
        self.start_round()

    def start_round(self):
        self.round = {"gc_collections": [0, 0, 0], "gc_ms": 0.0,
                      "gc_max_ms": 0.0}

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            ms = (time.perf_counter() - self._t0) * 1e3
            self._t0 = None
            self.round["gc_collections"][info["generation"]] += 1
            self.round["gc_ms"] += ms
            self.round["gc_max_ms"] = max(self.round["gc_max_ms"], ms)


def gate_rung(release):
    """(g)'s top rung: the engine rung behind an Event, bounded by its
    slice like every built-in rung (the wedge a stuck dispatch makes)."""
    from mesh_tpu_torch.serve import Rung, ServeResult, call_with_timeout
    from mesh_tpu_torch.serve import deadline as deadline_mod

    def fn(mesh, points, chunk, timeout):
        def blocked():
            release.wait()
            res = deadline_mod._rung_engine(mesh, points, chunk, timeout)
            return ServeResult(res.faces, res.points, "gate", res.certified)
        return call_with_timeout(blocked, timeout)
    return Rung("gate", fn)


def drive_serve(inp, dev, folder):
    """Phase 18 steps a-g: launch counts set to 0 just before and read just
    after, each step's launches apart; the answers, reports and rows for
    the checks, which run after the window."""
    from mesh_tpu_torch import Mesh
    from mesh_tpu_torch.obs import REGISTRY, get_ledger, list_incidents
    from mesh_tpu_torch.obs.replay import null_replay, synth_mix
    from mesh_tpu_torch.serve import (
        HealthMonitor, QueryService, default_ladder, run_closed_loop,
        run_open_loop, run_periodic, run_trace_replay)

    body = Mesh(*inp["body"], device=dev)
    template = Mesh(*inp["template"], device=dev)
    q, q_t = inp["body_q"], inp["template_q"]
    out = {"times_s": {}}
    times = out["times_s"]

    def make_service(**kw):
        kw.setdefault("workers", SERVE_WORKERS)
        kw.setdefault("stats_path", os.path.join(folder, "stats.json"))
        return QueryService(**kw)

    reset_launches()
    marks = _Launches()
    t_phase = time.perf_counter()
    main = make_service(default_deadline_s=SERVE_DEADLINE_S)
    try:
        # a. warmup of the default ladder
        t0 = time.perf_counter()
        out["warmed"] = main.warmup(body, queries=SERVE_QUERIES)
        out["ladder"] = [r.name for r in main.ladder]
        times["a_warmup"] = time.perf_counter() - t0
        marks.mark("a_warmup")
        # b. one-rung ladders
        out["rungs"] = {}
        for label, name, mesh, pts in (
                ("engine", "engine", body, q),
                ("engine_template", "engine", template, q_t),
                ("culled", "culled", body, q),
                ("anchored", "anchored", body, q),
                ("anchored_near", "anchored", body, inp["body_q_near"]),
                ("accel", "accel", body, q)):
            t0 = time.perf_counter()
            out["rungs"][label] = serve_rung(make_service, name, mesh, pts)
            times["b_" + label] = time.perf_counter() - t0
            marks.mark("b_" + label)
        # c. the closed loop, three rounds; its ledger rows kept, and per
        # round the plans made and the garbage collector's pauses
        rows = []
        gc_pauses = _GcPauses()
        get_ledger().add_listener(rows.append)
        gc.callbacks.append(gc_pauses)
        out["closed"], out["closed_rounds"] = [], []
        try:
            t0 = time.perf_counter()
            for _ in range(SERVE_ROUNDS):
                first, misses = len(rows), engine_misses()
                gc_pauses.start_round()
                out["closed"].append(run_closed_loop(
                    main, body, q, clients=SERVE_CLIENTS,
                    requests_per_client=SERVE_REQUESTS_PER_CLIENT,
                    deadline_s=SERVE_DEADLINE_S))
                out["closed_rounds"].append(dict(
                    gc_pauses.round, rows=(first, len(rows)),
                    plans_made=engine_misses() - misses))
            times["c_closed"] = time.perf_counter() - t0
        finally:
            gc.callbacks.remove(gc_pauses)
            get_ledger().remove_listener(rows.append)
        out["closed_rows"] = rows
        # the closed loop's rows, dumped as the reference's prof reads them
        # (phase 20 attributes a dispatch's time with obs/prof.py)
        os.makedirs(os.path.dirname(SERVE_CLOSED_LEDGER), exist_ok=True)
        dumped = get_ledger().dump_jsonl(SERVE_CLOSED_LEDGER, n=len(rows))
        with open(SERVE_CLOSED_LEDGER) as fh:
            check(dumped == len(rows) and [
                {k: v for k, v in json.loads(line).items() if k != "schema"}
                for line in fh] == [json.loads(json.dumps(r)) for r in rows],
                "serve: the ledger's dump is not the closed loop's rows")
        marks.mark("c_closed")
        # d. the open loop
        t0 = time.perf_counter()
        out["open"] = run_open_loop(main, body, q, rate_qps=SERVE_OPEN_QPS,
                                    duration_s=SERVE_OPEN_S,
                                    deadline_s=SERVE_DEADLINE_S)
        times["d_open"] = time.perf_counter() - t0
        marks.mark("d_open")
        # e. avatar streams: deadline-hard periodic arrivals
        t0 = time.perf_counter()
        out["periodic"] = run_periodic(
            main, body, q, sessions=SERVE_SESSIONS, hz=SERVE_HZ,
            frames_per_session=int(round(SERVE_HZ * SERVE_PERIODIC_S)))
        times["e_periodic"] = time.perf_counter() - t0
        marks.mark("e_periodic")
        # f. replay of the adversarial mix at speed 1
        trace = synth_mix(seed=SERVE_TRACE_SEED)
        t0 = time.perf_counter()
        out["replay"] = run_trace_replay(main, body, q, trace, speed=1.0)
        times["f_replay"] = time.perf_counter() - t0
        out["null_replay"] = null_replay(trace, speed=1.0)
        marks.mark("f_replay")
        out["retries_healthy"] = REGISTRY.counter(
            "mesh_tpu_serve_retries_total").total()
        out["health_healthy"] = main.health.snapshot()
    finally:
        main.stop(write_stats=False)
    # g. the wedge: the top rung blocked until released
    release = threading.Event()
    health = HealthMonitor(wedge_after_s=SERVE_WEDGE_S,
                           recover_after=SERVE_RECOVER_AFTER)
    wedge = make_service(health=health,
                         default_deadline_s=SERVE_WEDGE_DEADLINE_S,
                         ladder=[gate_rung(release), default_ladder()[0]])
    steps = []
    try:
        t0 = time.perf_counter()
        for i in range(SERVE_RECOVER_AFTER + 1):
            if i == 2:
                release.set()
            t1 = time.perf_counter()
            resp = wedge.query(body, q, tenant="wedge")
            steps.append({"rung": resp.rung, "retries": resp.retries,
                          "wall_s": time.perf_counter() - t1,
                          "state_after": health.state_name})
        times["g_wedge"] = time.perf_counter() - t0
    finally:
        release.set()
        wedge.stop(write_stats=False)
    out["wedge"] = steps
    out["incidents"] = [os.path.basename(p) for p in list_incidents()]
    marks.mark("g_wedge")
    out["phase_s"] = time.perf_counter() - t_phase
    launches = read_launches()
    out["step_launches"] = marks.steps
    return out, launches


def serve_answer_check(label, resp, v, f, q, dev, subset=None):
    """One served answer against the brute-force kernel on the same inputs
    (``subset``: a mask of the queries held, default all)."""
    from mesh_tpu_torch.query import closest_kernel as ck

    v_t = torch.as_tensor(v, device=dev)[None]
    f_t = torch.as_tensor(np.asarray(f, np.int64), device=dev)
    pts = np.asarray(q, np.float32)
    sq = ((pts.astype(np.float64) - resp.points) ** 2).sum(-1)
    faces = resp.faces[0].astype(np.int64)
    if subset is not None:
        pts, sq, faces = pts[subset], sq[subset], faces[subset]
    if not len(pts):
        return {"held": 0}
    q_t = torch.as_tensor(pts, device=dev)[None]
    brute = ck.closest_point_kernel(
        v_t, f_t, q_t, assume_nondegenerate=ck.mesh_is_nondegenerate(v, f))
    res = check_against_brute(
        label, v_t, f_t, q_t, torch.as_tensor(faces, device=dev)[None],
        torch.as_tensor(sq, dtype=torch.float32, device=dev)[None], brute)
    res["held"] = int(len(pts))
    return res


def serve_tight(name, v, f, q, dev):
    """The per-query ``tight`` mask and the faces of the culled or anchored
    rung's search on one request, recomputed with the rung's own settings
    (k 64 and chunks of 256; K 16 and chunks of 512)."""
    from mesh_tpu_torch.query.anchored import (build_anchor_tables,
                                               closest_point_anchored)
    from mesh_tpu_torch.query.culled import closest_faces_and_points_culled

    v_t = torch.as_tensor(v, device=dev)
    f_t = torch.as_tensor(np.asarray(f, np.int64), device=dev)
    q_t = torch.as_tensor(q, device=dev)
    if name == "culled":
        res = closest_faces_and_points_culled(v_t, f_t, q_t, k=64, chunk=256)
    else:
        table, safe = build_anchor_tables(v_t, f_t, k=16, device=dev)
        res = closest_point_anchored(v_t, f_t, q_t, table, safe, chunk=512,
                                     device=dev)
    return res["tight"].cpu().numpy(), res["face"].cpu().numpy()


def check_serve_rungs(out, inp, dev):
    """(a) and (b): every rung of the default ladder warmed; each one-rung
    ladder's answer from its rung with no retry, its launches, its ledger
    row, and its answer against the brute-force kernel (the culled and
    anchored rungs' on their tight queries, with ``certified`` equal to
    every query tight; on the request near the surface most are tight)."""
    from mesh_tpu_torch.accel.traverse import pallas_bvh_variant

    check(out["warmed"] == out["ladder"] == ["engine", "culled", "anchored"],
          "serve: warmup returned %s of the ladder %s"
          % (out["warmed"], out["ladder"]))
    variant = pallas_bvh_variant(len(inp["body"][1]))
    check(variant == "resident", "serve: the accel rung's route on the "
          "body is %s, not the resident walk" % variant)
    expected = {"engine": {"closest_faces", "cull_records"},
                "engine_template": {"culled_faces"},
                "culled": set(), "anchored": set(),
                "anchored_near": set(),
                "accel": {"rope_faces_resident"}}
    rungs = {}
    for label, (warmed, resp, row) in out["rungs"].items():
        name = label.split("_")[0]
        on_template = label == "engine_template"
        v, f = inp["template"] if on_template else inp["body"]
        q = (inp["template_q"] if on_template else inp["body_q_near"]
             if label == "anchored_near" else inp["body_q"])
        check(warmed == [name] and resp.rung == name and resp.retries == 0,
              "serve %s: warmed %s, answered by %s with %d retries"
              % (label, warmed, resp.rung, resp.retries))
        check(row["outcome"] == "ok" and row["rung"] == name
              and "device" in row["stages"], "serve %s: ledger row %s"
              % (label, row))
        step = out["step_launches"]["b_" + label]
        for kernel in sorted(expected[label]):
            check(step.get(kernel, 0) > 0, "serve %s: %s never launched"
                  % (label, kernel))
        counted_only(step, expected[label], "serve %s" % label)
        info = {"certified": resp.certified,
                "latency_ms": resp.latency_s * 1e3, "launches": step,
                "backend": row.get("backend")}
        if name in ("engine", "accel"):
            check(resp.certified, "serve %s: not certified" % label)
            info["vs_brute"] = serve_answer_check("serve " + label, resp, v,
                                                  f, q, dev)
        else:
            tight, faces = serve_tight(name, v, f, q, dev)
            check(np.array_equal(faces, resp.faces[0].astype(np.int64)),
                  "serve %s: the served faces are not the search's" % label)
            check(resp.certified == bool(tight.all()),
                  "serve %s: certified %s with %d of %d queries tight"
                  % (label, resp.certified, int(tight.sum()), len(tight)))
            info["tight"] = int(tight.sum())
            if label == "anchored_near":
                check(2 * info["tight"] > len(tight), "serve %s: %d of %d "
                      "queries near the surface tight"
                      % (label, info["tight"], len(tight)))
            info["vs_brute"] = serve_answer_check(
                "serve %s (tight queries)" % label, resp, v, f, q, dev,
                subset=tight)
        if name == "accel":
            check(row.get("backend") == "rope_resident", "serve accel: "
                  "backend %s" % row.get("backend"))
        rungs[label] = info
    return rungs


def check_serve_loads(out, rec):
    """(c)-(f): the healthy drives answered from the engine, no retry,
    nothing shed; the replay's checksum the null replay's."""
    reports = out["closed"] + [out["open"], out["periodic"], out["replay"]]
    for report in reports:
        check(report["errors"] == 0 and report["retries"] == 0
              and report["shed"] == 0 and report["approximate"] == 0
              and set(report["rungs"]) <= {"engine"},
              "serve %s loop: %s" % (report["loop"], report))
    check(out["retries_healthy"] == 0, "serve: %s retries on the healthy "
          "drives" % out["retries_healthy"])
    check(out["health_healthy"]["state"] == "healthy"
          and out["health_healthy"]["trips"] == 0,
          "serve: health after the healthy drives %s" % out["health_healthy"])
    for report in out["closed"]:
        check(report["ok"] == report["requests"] == SERVE_CLIENTS
              * SERVE_REQUESTS_PER_CLIENT and report["rungs"] == {
                  "engine": report["requests"]},
              "serve closed loop: %s" % report)
    check(out["replay"]["checksum"] == out["null_replay"]["checksum"]
          and out["replay"]["admissions"] == out["null_replay"]["admissions"],
          "serve replay: checksum %s, the null replay's %s"
          % (out["replay"]["checksum"], out["null_replay"]["checksum"]))
    best = min(out["closed"], key=lambda r: r["p99_ms"])
    rec["closed_loop"] = {k: best[k] for k in (
        "p50_ms", "p95_ms", "p99_ms", "goodput_qps", "deadline_miss_rate",
        "shed_rate", "requests", "rungs")}
    rec["closed_loop"]["rounds"] = []
    for report, diag in zip(out["closed"], out["closed_rounds"]):
        lo, hi = diag["rows"]
        slowest = max(out["closed_rows"][lo:hi], key=lambda r: r["total_s"])
        rnd = {k: report[k] for k in ("p50_ms", "p95_ms", "p99_ms",
                                      "goodput_qps", "deadline_miss_rate")}
        rnd.update({k: diag[k] for k in ("plans_made", "gc_collections",
                                         "gc_ms", "gc_max_ms")})
        rnd["slowest_ms"] = slowest["total_s"] * 1e3
        rnd["slowest_tenant"] = slowest.get("tenant")
        rnd["slowest_stages_ms"] = {k: sec * 1e3 for k, sec
                                    in slowest["stages"].items()}
        queue_max = {}
        for r in out["closed_rows"][lo:hi]:
            queue_max[r.get("tenant")] = max(queue_max.get(r.get("tenant"),
                                                           0.0),
                                             r["stages"]["queue"] * 1e3)
        rnd["queue_max_ms_by_tenant"] = queue_max
        rec["closed_loop"]["rounds"].append(rnd)
    rec["open_loop"] = {k: out["open"][k] for k in (
        "p50_ms", "p95_ms", "p99_ms", "goodput_qps", "deadline_miss_rate",
        "shed_rate", "requests", "rate_qps")}
    rec["periodic"] = {k: out["periodic"][k] for k in (
        "p50_ms", "p99_ms", "frame_miss_rate", "deadline_miss_rate",
        "requests", "sessions", "hz")}
    rec["replay"] = {k: out["replay"][k] for k in (
        "p50_ms", "p99_ms", "goodput_qps", "deadline_miss_rate", "requests",
        "admissions", "checksum", "paced_s")}
    return reports


def check_serve_wedge(out, rec):
    """(g): the first request answers from the engine with one retry within
    2x its deadline and leaves health DEGRADED; the next starts at rung 1;
    after the release and SERVE_RECOVER_AFTER successes health is HEALTHY
    and the top rung answers again."""
    from mesh_tpu_torch.obs import REGISTRY

    steps = out["wedge"]
    check(steps[0]["rung"] == "engine" and steps[0]["retries"] == 1
          and steps[0]["wall_s"] < 2.0 * SERVE_WEDGE_DEADLINE_S
          and steps[0]["state_after"] == "degraded",
          "serve wedge: first request %s" % steps[0])
    check(steps[1]["rung"] == "engine" and steps[1]["retries"] == 0
          and steps[1]["state_after"] == "degraded",
          "serve wedge: the degraded request %s did not start at rung 1"
          % steps[1])
    check(steps[-2]["state_after"] == "healthy"
          and (steps[-1]["rung"], steps[-1]["retries"],
               steps[-1]["state_after"]) == ("gate", 0, "healthy"),
          "serve wedge: health did not recover: %s" % steps)
    check(any("watchdog_trip" in name for name in out["incidents"]),
          "serve wedge: no watchdog_trip incident in %s" % out["incidents"])
    trips = REGISTRY.get("mesh_tpu_serve_watchdog_trips_total")
    rec["wedge"] = {"steps": steps, "trips": {
        labels["reason"]: n for labels, n in trips._labelled()},
        "incidents": len(out["incidents"])}


def check_serve_books(out, reports, rec, folder):
    """(h): every closed-loop request has a closed ledger row with its
    stages; ``mesh_tpu_serve_requests_total`` equals the requests issued;
    the stats sink reads back; an SLOMonitor's availability compliance is
    good / total from the counters."""
    from mesh_tpu_torch.obs import REGISTRY
    from mesh_tpu_torch.obs.slo import SLOMonitor, compliance, default_slos
    from mesh_tpu_torch.serve import QueryService

    rows = out["closed_rows"]
    issued = SERVE_ROUNDS * SERVE_CLIENTS * SERVE_REQUESTS_PER_CLIENT
    check(len(rows) == issued and all(
        r["outcome"] == "ok" and r["rung"] == "engine"
        and {"queue", "device", "respond"} <= set(r["stages"])
        and r["total_s"] > 0 and r.get("request_id") for r in rows),
        "serve: %d ledger rows for %d closed-loop requests, or a row "
        "without its stages" % (len(rows), issued))
    stages = {}
    for r in rows:
        for stage, sec in r["stages"].items():
            stages.setdefault(stage, []).append(sec * 1e3)
    rec["closed_loop_stages_ms"] = {
        k: {"p50": float(np.percentile(v, 50)),
            "p99": float(np.percentile(v, 99)), "n": len(v)}
        for k, v in stages.items()}
    requests = REGISTRY.get("mesh_tpu_serve_requests_total")
    total = requests.total()
    sent = (len(out["rungs"]) + sum(r["requests"] for r in reports)
            + len(out["wedge"]))
    check(total == sent, "serve: mesh_tpu_serve_requests_total %d, %d "
          "requests issued" % (total, sent))
    sink = os.path.join(folder, "stats_check.json")
    stats_service = QueryService(workers=1, stats_path=sink)
    try:
        stats_service.write_stats()
    finally:
        stats_service.stop(write_stats=False)
    with open(sink) as fh:
        data = json.load(fh)
    check(data["metrics"]["mesh_tpu_serve_requests_total"]["series"]
          == requests.snapshot()["series"], "serve: the stats sink")
    avail = [s for s in default_slos() if s.kind == "availability"][0]
    monitor = SLOMonitor()
    monitor.tick()
    monitor.evaluate()
    snap = REGISTRY.snapshot()
    good = REGISTRY.get("mesh_tpu_serve_good_total")
    compl = {}
    for tenant in sorted({lb["tenant"] for lb, _ in requests._labelled()}):
        n = sum(v for lb, v in requests._labelled() if lb["tenant"] == tenant)
        row = compliance(snap, avail, tenant)
        check(row["total"] == n and row["good"] == good.value(tenant=tenant)
              and row["compliance"] == good.value(tenant=tenant) / n,
              "serve: availability of %s %s against the counters %d / %d"
              % (tenant, row, good.value(tenant=tenant), n))
        compl[tenant] = row["compliance"]
    rec["availability"] = compl
    rec["requests_total"] = total


def replay_kernels(plan, reps=10):
    """What one replay of ``plan`` runs on the card, by ``torch.profiler``
    (CUPTI) over ``reps`` replays: its kernels and copies, launches and
    device ms a replay, the costliest first; {"error": ...} where the
    profiler cannot trace the card."""
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with torch.cuda.stream(plan.stream):
                for _ in range(reps):
                    plan.graph.replay()
            torch.cuda.synchronize()
        events = prof.key_averages()
    except Exception as e:          # noqa: BLE001 - reported, not raised
        return {"error": "%s: %s" % (type(e).__name__, str(e)[:200])}
    rows = []
    for e in events:
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us > 0 and e.count:
            rows.append({"name": e.key[:80], "launches": e.count / reps,
                         "ms": us / 1e3 / reps})
    rows.sort(key=lambda r: -r["ms"])
    return {"launches": sum(r["launches"] for r in rows),
            "ms": sum(r["ms"] for r in rows), "top": rows[:8]}


def serve_replay_device(inp, rec, reps=50):
    """The device time of the engine rung's dispatch on the body: each
    cached plan of the body's SERVE_QUERIES bucket (one request a dispatch,
    and two where the workers' requests coalesced) replayed ``reps`` times
    back to back on its own stream between CUDA events, after the counted
    window, the one-request plan's kernels by ``replay_kernels``; and,
    derived, the device's busy share of the closed loop (its dispatches x
    the one-request replay over its wall time)."""
    from mesh_tpu_torch.engine import get_planner

    planner = get_planner()
    n_verts, n_faces = len(inp["body"][0]), len(inp["body"][1])
    out, kernels = {}, None
    with planner._lock:
        plans = [(key, plan) for key, plan in planner._plans.items()
                 if plan.backend == "cuda" and key[2:5] == (
                     SERVE_QUERIES, n_verts, n_faces)]
        for key, plan in plans:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(plan.stream):
                plan.graph.replay()
                start.record()
                for _ in range(reps):
                    plan.graph.replay()
                end.record()
            end.synchronize()
            out["b%d" % key[1]] = start.elapsed_time(end) / reps
            if key[1] == 1:
                kernels = replay_kernels(plan)
    check("b1" in out, "serve: no plan of the body's %d-query bucket among "
          "%s" % (SERVE_QUERIES, planner.cached_keys()))
    dispatches = rec["step_launches"]["c_closed"]["closest_faces"]
    wall_ms = rec["times_s"]["c_closed"] * 1e3
    return {"replay_ms": out, "replay_b1_kernels": kernels,
            "closed_dispatches": dispatches,
            "closed_wall_ms": wall_ms,
            "closed_busy_share_derived": dispatches * out["b1"] / wall_ms}


def check_serve(out, launches, inp, dev, folder):
    """Phase 18's checks, after the counted window."""
    rec = {"times_s": out["times_s"], "phase_s": out["phase_s"]}
    rec["rungs"] = check_serve_rungs(out, inp, dev)
    reports = check_serve_loads(out, rec)
    check_serve_wedge(out, rec)
    check_serve_books(out, reports, rec, folder)
    needed = {k for k, paths in KERNEL_PATHS.items() if "serve" in paths}
    for name in sorted(needed):
        check(launches[name] > 0, "kernel %s never launched on the serve "
              "path" % name)
    counted_only(launches, needed, "the serve path")
    rec["launches"] = {k: n for k, n in launches.items() if n}
    rec["step_launches"] = out["step_launches"]
    rec["replay_device"] = serve_replay_device(inp, rec)
    return rec


def drive_serve_phase(inp, dev, smi):
    """Phase 18 -> (its record, launches on its counted window)."""
    import shutil

    folder = os.path.join(_REPO, "build", "chip_smoke_serve")
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    log("== serve: QueryService(workers=%d) over posed body 0 (%d faces) and "
        "the %d-face template: warmup, one-rung ladders, a closed loop of "
        "%d x %d x %d rounds, an open loop, %d avatar streams at %g Hz, a "
        "replay of synth_mix(seed=%d) and a wedge" % (
            SERVE_WORKERS, len(inp["body"][1]), len(inp["template"][1]),
            SERVE_CLIENTS, SERVE_REQUESTS_PER_CLIENT, SERVE_ROUNDS,
            SERVE_SESSIONS, SERVE_HZ, SERVE_TRACE_SEED))
    incidents = os.path.join(folder, "incidents")
    try:
        with knobs_set(MESH_TPU_INCIDENT_DIR=incidents):
            out, launches = drive_serve(inp, dev, folder)
        rec = check_serve(out, launches, inp, dev, folder)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    check(out["phase_s"] <= SERVE_BUDGET_S, "serve: %.1f s, budget %.0f s"
          % (out["phase_s"], SERVE_BUDGET_S))
    log("  steps (s): %s; phase %.1f s (budget %.0f s)" % (", ".join(
        "%s %.2f" % kv for kv in out["times_s"].items()), out["phase_s"],
        SERVE_BUDGET_S))
    for label, info in rec["rungs"].items():
        log("  rung %s: certified %s, %.3f ms, launches %s, %s" % (
            label, info["certified"], info["latency_ms"], info["launches"],
            info["vs_brute"]))
    c = rec["closed_loop"]
    log("  closed loop (best of %d rounds by p99): p50 %.3f ms, p95 %.3f ms, "
        "p99 %.3f ms, goodput %.1f qps, deadline-miss rate %.4f, rungs %s, "
        "on %s" % (SERVE_ROUNDS, c["p50_ms"], c["p95_ms"], c["p99_ms"],
                   c["goodput_qps"], c["deadline_miss_rate"], c["rungs"],
                   smi))
    log("  open loop: %s" % rec["open_loop"])
    log("  periodic: frame_miss_rate %.4f, %s" % (
        rec["periodic"]["frame_miss_rate"], rec["periodic"]))
    log("  replay: %s" % rec["replay"])
    log("  wedge: %s" % rec["wedge"])
    log("  closed-loop rounds: %s" % rec["closed_loop"]["rounds"])
    log("  closed-loop stages (ms): %s" % rec["closed_loop_stages_ms"])
    log("  engine dispatch on the card (CUDA events): %s"
        % rec["replay_device"])
    log("  launches: %s" % rec["launches"])
    log("serve record (on %s): %s" % (smi, json.dumps(rec)))
    return rec, launches


# ---------------------------------------------------------------------------
# Phase 14's repairs: the diff wrappers under torch.func.vmap and the
# envelope backward's fixed-order sum.


def check_diff_repairs(verts, f, queries, scan, dev):
    """After phase 14's counted window: two backward passes of
    ``diff.closest_point`` at 1 x len(scan) give the same bits (the
    backward sums in slot order, no atomics); ``torch.func.vmap`` of it
    over DIFF_VMAP_BODIES bodies equals ``closest_point_batched`` bit for
    bit, outputs and gradients, with one closest_faces launch a call; and
    ``torch.func.vmap`` of ``diff.point_to_triangle`` equals its unmapped
    call.  Returns the record."""
    from mesh_tpu_torch import diff

    rec = {}
    v0 = verts[0].detach()
    grads = []
    for _ in range(2):
        v = v0.clone().requires_grad_()
        p = scan.detach().clone().requires_grad_()
        diff.closest_point(v, f, p, device=dev)["sqdist"].sum().backward()
        grads.append((v.grad, p.grad))
    check(torch.equal(grads[0][0], grads[1][0])
          and torch.equal(grads[0][1], grads[1][1]),
          "fit: two backward passes of diff.closest_point at 1 x %d differ"
          % scan.shape[0])
    rec["backward_bit_equal"] = True
    rec["backward_vertices_touched"] = int(
        (grads[0][0].abs().sum(dim=-1) > 0).sum())
    vb = verts[:DIFF_VMAP_BODIES].detach()
    pb = queries[:DIFF_VMAP_BODIES].detach()

    def mapped(v_, p_):
        return torch.func.vmap(lambda a, b: diff.closest_point(
            a, f, b, device=dev))(v_, p_)

    before = read_launches()["closest_faces"]
    out = mapped(vb, pb)
    rec["vmap_closest_faces_launches"] = \
        read_launches()["closest_faces"] - before
    check(rec["vmap_closest_faces_launches"] == 1,
          "fit: vmap over %d bodies launched closest_faces %d times"
          % (DIFF_VMAP_BODIES, rec["vmap_closest_faces_launches"]))
    ref = diff.closest_point_batched(vb, f, pb, device=dev)
    check(same_arrays(out, ref),
          "fit: vmap(diff.closest_point) differs from closest_point_batched")
    ts = [vb.clone().requires_grad_(), pb.clone().requires_grad_()]
    g_map = torch.autograd.grad(mapped(*ts)["sqdist"].sum(), ts)
    tb = [vb.clone().requires_grad_(), pb.clone().requires_grad_()]
    g_bat = torch.autograd.grad(diff.closest_point_batched(
        tb[0], f, tb[1], device=dev)["sqdist"].sum(), tb)
    check(same_arrays(g_map, g_bat),
          "fit: vmap gradients differ from closest_point_batched's")
    rng = np.random.RandomState(19)
    tri = torch.as_tensor(rng.randn(4, DIFF_VMAP_BODIES, 1024, 3),
                          dtype=torch.float32, device=dev)
    p2t = torch.func.vmap(lambda *t: diff.point_to_triangle(
        *t, device=dev))(*tri)
    check(same_arrays(p2t, diff.point_to_triangle(*tri, device=dev))
          and bool(torch.isfinite(p2t["sqdist"]).all()),
          "fit: vmap(diff.point_to_triangle) differs from the plain call")
    rec["vmap_bit_equal"] = True
    log("  diff repairs: two backward passes at 1 x %d bit-equal (%d "
        "vertices touched); vmap over %d bodies = closest_point_batched bit "
        "for bit (outputs, gradients), %d closest_faces launch; vmap of "
        "point_to_triangle = its plain call" % (
            scan.shape[0], rec["backward_vertices_touched"],
            DIFF_VMAP_BODIES, rec["vmap_closest_faces_launches"]))
    return rec


# ---------------------------------------------------------------------------
# Phase 19: the mesh store.

#: phase 19a's child: both cold-start arms on the card in a fresh process
STORE_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from mesh_tpu_torch.accel.build import build_bvh, clear_index_cache, get_index
from mesh_tpu_torch.accel.traverse import closest_faces_and_points_accel
from mesh_tpu_torch.obs.metrics import REGISTRY
from mesh_tpu_torch.query.autotune import _sphere_mesh, stream_tile_params
from mesh_tpu_torch.store import get_store

digest, pts_path, out_path, reps = sys.argv[1:5]
pts = np.load(pts_path)
dev = torch.device("cuda")
tile_f = stream_tile_params()[1]
store = get_store()
# the card, the context and the rope library warmed on another mesh
wv, wf = _sphere_mesh(2048)
closest_faces_and_points_accel(wv, wf, pts, device=dev)


def counts():
    return [REGISTRY.counter(name).value(kind="bvh") for name in (
        "mesh_tpu_store_sidecar_hits_total",
        "mesh_tpu_accel_cache_misses_total")]


def arm(sidecar):
    clear_index_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = store.open(digest)
    idx = (get_index(m.v, m.f, "bvh", leaf_size=tile_f) if sidecar
           else build_bvh(m.v, m.f, leaf_size=tile_f))
    res = closest_faces_and_points_accel(m.v, m.f, pts, index=idx,
                                         device=dev)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res


seconds = {"sidecar": [], "rebuild": []}
out, hits, misses = {}, 0, 0
for _ in range(int(reps)):
    before = counts()
    sec, out["sidecar"] = arm(True)
    after = counts()
    hits += after[0] - before[0]
    misses += after[1] - before[1]
    seconds["sidecar"].append(sec)
    sec, out["rebuild"] = arm(False)
    seconds["rebuild"].append(sec)
np.savez(out_path, **{"%s_%s" % (a, k): out[a][k] for a in out
                      for k in ("face", "point", "sqdist")})
print(json.dumps({"seconds": seconds, "sidecar_hits": hits,
                  "sidecar_arm_build_misses": misses,
                  "jax": "jax" in sys.modules}))
"""


def store_cold_start(store, v, f, dev, folder):
    """19a: the scan mesh ingested, one warm call through phase 6's route
    (the Mesh facade's streamed rope walk; it builds the index and persists
    its side-car under the tag that route asks for), the warm answers on
    bench.py's queries, then both arms in a child on the card."""
    from mesh_tpu_torch import Mesh
    from mesh_tpu_torch.accel.build import clear_index_cache
    from mesh_tpu_torch.accel.traverse import closest_faces_and_points_accel
    from mesh_tpu_torch.query.autotune import stream_tile_params
    from mesh_tpu_torch.store.sidecar import sidecar_tag

    rng = np.random.RandomState(0)
    pts = rng.randn(STORE_COLD_QUERIES, 3)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts *= 1.0 + 0.05 * rng.randn(STORE_COLD_QUERIES, 1)
    pts = np.asarray(pts, np.float32)
    t0 = time.perf_counter()
    digest = store.ingest(v, f)
    ingest_s = time.perf_counter() - t0
    clear_index_cache()
    with no_engine():
        t0 = time.perf_counter()
        Mesh(v, f, device=dev).closest_faces_and_points(pts)
        warm_call_s = time.perf_counter() - t0
    tile_f = stream_tile_params()[1]
    want_tag = sidecar_tag("bvh", {"leaf_size": tile_f})
    warm = closest_faces_and_points_accel(v, f, pts, device=dev)
    return {"digest": digest, "pts": pts, "warm": warm, "tag": want_tag,
            "ingest_s": ingest_s, "warm_call_s": warm_call_s}


def run_store_child(cold, folder):
    """19a's child: a fresh process on the card, MESH_TPU_STORE_DIR set,
    stopped at its time limit."""
    np.save(os.path.join(folder, "pts.npy"), cold["pts"])
    out_path = os.path.join(folder, "child.npz")
    env = dict(os.environ, PYTHONPATH=_REPO)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", STORE_CHILD, cold["digest"],
         os.path.join(folder, "pts.npy"), out_path, str(STORE_COLD_REPS)],
        capture_output=True, text=True, timeout=STORE_CHILD_TIMEOUT_S,
        env=env, cwd=_REPO)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, "store: the cold-start child failed: %s"
          % proc.stderr[-4000:])
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    with np.load(out_path) as z:
        doc["answers"] = {k: z[k] for k in z.files}
    doc["child_wall_s"] = wall
    return doc


def drive_store(inp, dev, folder):
    """Phase 19 a-d, launch counts set to 0 just before and read just
    after (the child's launches are its own process's); the records the
    checks read, which run after the window."""
    from mesh_tpu_torch import Mesh
    from mesh_tpu_torch.accel.build import index_cache_info
    from mesh_tpu_torch.accel.traverse import RESIDENT_TILE_F
    from mesh_tpu_torch.anim import AvatarSession
    from mesh_tpu_torch.obs import get_ledger
    from mesh_tpu_torch.serve import HealthMonitor, QueryService
    from mesh_tpu_torch.serve.deadline import _mesh_tensors
    from mesh_tpu_torch.store import get_page_cache, get_store
    from mesh_tpu_torch.store import deltas

    out = {"times_s": {}}
    times = out["times_s"]
    store = get_store()
    reset_launches()
    marks = _Launches()
    t_phase = time.perf_counter()
    # a. the cold start's parent side
    t0 = time.perf_counter()
    out["cold"] = store_cold_start(store, *inp["scan"][:2], dev, folder)
    times["a_parent"] = time.perf_counter() - t0
    marks.mark("a_parent")
    # b. the tiers and the Mesh facade
    t0 = time.perf_counter()
    body_v, f_np = inp["body"]
    src = Mesh(body_v, f_np, device=dev)
    digest = src.write_store()
    loaded = Mesh(device=dev).load_from_store(digest)
    out["body_digest"] = digest
    out["facade"] = (src.closest_faces_and_points(inp["facade_q"]),
                     loaded.closest_faces_and_points(inp["facade_q"]),
                     loaded)
    times["b_tiers"] = time.perf_counter() - t0
    marks.mark("b_tiers")
    # c. store-keyed requests, each with an inline twin
    t0 = time.perf_counter()
    svc = QueryService(workers=SERVE_WORKERS,
                       default_deadline_s=SERVE_DEADLINE_S,
                       health=HealthMonitor(watchdog=False),
                       stats_path=os.path.join(folder, "stats.json"),
                       device=dev)
    rows = []
    get_ledger().add_listener(rows.append)
    try:
        out["warmed"] = svc.warmup(src, queries=SERVE_QUERIES)
        pairs = []
        for k in range(STORE_REQUESTS):
            keyed = svc.query(digest, inp["serve_q"], tenant="store")
            inline = svc.query(src, inp["serve_q"], tenant="inline")
            pairs.append((keyed, inline))
        bad = svc.submit("0badc0de-0badc0de-v3-f1", inp["serve_q"],
                         tenant="unknown")
        try:
            bad.result(timeout=30)
            out["unknown"] = None
        except Exception as e:                        # noqa: BLE001
            out["unknown"] = e
        out["after_unknown"] = svc.query(digest, inp["serve_q"],
                                         tenant="store")
    finally:
        get_ledger().remove_listener(rows.append)
        svc.stop(write_stats=False)
    out["pairs"], out["rows"] = pairs, rows
    times["c_serve"] = time.perf_counter() - t0
    marks.mark("c_serve")
    # d. delta frames through a store-keyed session
    t0 = time.perf_counter()
    model = inp["model"]
    rest, frames, _ = anim_stream(model, dev, 19)
    f_model = model.faces.cpu().numpy()
    key = store.ingest(rest, f_model)
    stream = []
    for k, (v, q) in enumerate(frames()):
        if k == STORE_FRAMES:
            break
        stream.append((v.cpu().numpy(), q))
    t1 = time.perf_counter()
    manifest = deltas.write_sequence(store, key, "phase19",
                                     [v for v, _ in stream])
    times["d_write_sequence"] = time.perf_counter() - t1
    sess = AvatarSession(digest=key, leaf_size=RESIDENT_TILE_F, device=dev)
    run = []
    leaf_before = read_launches()["leaf_boxes"]
    for k, (_, q) in enumerate(stream):
        t1 = time.perf_counter()
        frame, provenance = deltas.resolve_frame(key, "phase19", k)
        resolve_s = time.perf_counter() - t1
        keys = index_cache_info()["keys"]
        res = sess.frame(vertices=np.asarray(frame.v), points=q)
        run.append({"v": np.array(frame.v), "q": q, "out": res,
                    "provenance": provenance, "resolve_s": resolve_s,
                    "built": index_cache_info()["keys"] != keys})
    out["leaf_boxes_in_frames"] = read_launches()["leaf_boxes"] - leaf_before
    sess.stop()
    out["anim"] = {"key": key, "manifest": manifest, "stream": stream,
                   "run": run, "faces": f_model, "stats": sess.stats()}
    times["d_frames"] = time.perf_counter() - t0
    marks.mark("d_frames")
    launches = read_launches()
    out["phase_s"] = time.perf_counter() - t_phase
    out["step_launches"] = marks.steps
    # after the window: the child, the page-in and upload times
    out["child"] = run_store_child(out["cold"], folder)
    stored, _ = get_page_cache().resolve(digest)
    uploads = []
    for _ in range(STORE_UPLOADS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _mesh_tensors(stored, dev)
        torch.cuda.synchronize()
        uploads.append((time.perf_counter() - t1) * 1e3)
    out["upload_ms"] = uploads
    out["store"] = store
    return out, launches


def check_store(out, launches, inp, dev):
    """Phase 19's checks, after the counted window."""
    from mesh_tpu_torch.errors import StoreError
    from mesh_tpu_torch.query import closest_kernel as ck
    from mesh_tpu_torch.store import deltas

    store = out["store"]
    rec = {"times_s": out["times_s"], "phase_s": out["phase_s"]}
    # a. the cold start
    cold, child = out["cold"], out["child"]
    tags = store.sidecar_tags(cold["digest"])
    check(tags == [cold["tag"]], "store: the scan's side-cars %s, want the "
          "route's %s" % (tags, cold["tag"]))
    for arm in ("sidecar", "rebuild"):
        for key in ("face", "point", "sqdist"):
            check(np.array_equal(child["answers"]["%s_%s" % (arm, key)],
                                 cold["warm"][key]),
                  "store: the child's %s arm differs from the warm %s"
                  % (arm, key))
    check(child["sidecar_hits"] >= 1 and child["sidecar_arm_build_misses"]
          == 0 and not child["jax"], "store: the child's side-car hits %s, "
          "build misses %s, jax %s" % (
              child["sidecar_hits"], child["sidecar_arm_build_misses"],
              child["jax"]))
    rec["cold_start"] = {
        "faces": int(inp["scan"][1].shape[0]), "queries": STORE_COLD_QUERIES,
        "tag": cold["tag"], "ingest_s": cold["ingest_s"],
        "warm_call_s": cold["warm_call_s"],
        "sidecar_s": child["seconds"]["sidecar"],
        "rebuild_s": child["seconds"]["rebuild"],
        "sidecar_best_s": min(child["seconds"]["sidecar"]),
        "rebuild_best_s": min(child["seconds"]["rebuild"]),
        "sidecar_hits": child["sidecar_hits"],
        "sidecar_arm_build_misses": child["sidecar_arm_build_misses"],
        "child_wall_s": child["child_wall_s"]}
    # b. the tiers and the facade
    tiers = {}
    for name, digest in (("scan", cold["digest"]),
                         ("body", out["body_digest"])):
        exact, compact = store.open(digest), store.open(digest,
                                                        tier="compact")
        tol = store.manifest(digest)["tiers"]["compact"]["tolerance"]
        err = float(np.max(np.abs(np.asarray(compact.v, np.float64)
                                  - np.asarray(exact.v, np.float64))))
        check(err <= tol, "store: %s compact tier %.3g from the exact, "
              "tolerance %.3g" % (name, err, tol))
        check(np.array_equal(compact.f, exact.f), "store: %s compact faces"
              % name)
        tiers[name] = {"compact_err": err, "tolerance": tol,
                       "bytes": store.object_bytes(digest)}
    check(store.verify() == [], "store: verify found problems")
    rec["tiers"] = tiers
    (f1, p1), (f2, p2), loaded = out["facade"]
    src_v, src_f = inp["body"]
    check(np.array_equal(loaded.v, np.asarray(src_v, np.float64))
          and np.array_equal(loaded.f, np.asarray(src_f, np.uint32))
          and np.array_equal(f1, f2) and np.array_equal(p1, p2),
          "store: Mesh.load_from_store answers differ from the source Mesh")
    # c. store-keyed requests
    pairs, rows = out["pairs"], out["rows"]
    keyed_rows = [r for r in rows if r.get("tenant") == "store"]
    sources = [r.get("mesh_source") for r in keyed_rows]
    check(sources == ["paged"] + ["resident"] * (len(keyed_rows) - 1),
          "store: keyed requests' sources %s" % sources)
    check(all("page_in" in r["stages"] and r["store_key"] ==
              out["body_digest"] and r["outcome"] == "ok"
              for r in keyed_rows), "store: a keyed ledger row lacks page_in")
    for k, (keyed, inline) in enumerate(pairs):
        check(np.array_equal(keyed.faces, inline.faces)
              and np.array_equal(keyed.points, inline.points)
              and keyed.rung == inline.rung,
              "store: keyed request %d differs from its inline twin" % k)
    rec["vs_brute"] = serve_answer_check(
        "store-keyed request 0", pairs[0][0], np.asarray(src_v, np.float32),
        src_f, inp["serve_q"], dev)
    check(isinstance(out["unknown"], StoreError),
          "store: the unknown key gave %r" % (out["unknown"],))
    check(np.array_equal(out["after_unknown"].faces, pairs[0][1].faces),
          "store: the request after the unknown key")
    page_in = [r["stages"]["page_in"] * 1e3 for r in keyed_rows]
    rec["serve"] = {
        "requests": len(keyed_rows), "rungs": sorted({p[0].rung
                                                      for p in pairs}),
        "page_in_ms_paged": page_in[0],
        "page_in_ms_p50": statistics.median(page_in),
        "page_in_ms_resident_p50": statistics.median(page_in[1:]),
        "latency_ms_keyed_p50": statistics.median(
            p[0].latency_s * 1e3 for p in pairs),
        "latency_ms_inline_p50": statistics.median(
            p[1].latency_s * 1e3 for p in pairs),
        "upload_ms_p50": statistics.median(out["upload_ms"]),
        "upload_ms_min": min(out["upload_ms"]),
        "unknown_key_error": type(out["unknown"]).__name__}
    # d. delta frames
    anim = out["anim"]
    tol = deltas.sequence_tolerance(anim["manifest"])
    f_t = torch.as_tensor(anim["faces"].astype(np.int64), device=dev)
    worst = {"decode_err": 0.0, "sqdist_gap": 0.0, "faces_differ": 0,
             "tie_gap": 0.0}
    for k, ((v_in, _), fr) in enumerate(zip(anim["stream"], anim["run"])):
        err = float(np.max(np.abs(fr["v"].astype(np.float64)
                                  - v_in.astype(np.float64))))
        check(err <= tol, "store: frame %d decodes %.3g off, tolerance "
              "%.3g" % (k, err, tol))
        worst["decode_err"] = max(worst["decode_err"], err)
        res = fr["out"]
        check(res["action"] in ("refit", "rebuild") and not (
            res["action"] == "refit" and fr["built"]),
            "store: frame %d action %s, index built %s" % (
                k, res["action"], fr["built"]))
        check(fr["provenance"] == "paged", "store: frame %d %s" % (
            k, fr["provenance"]))
        v_t = torch.as_tensor(fr["v"], device=dev)[None]
        q_t = fr["q"][None]
        brute = ck.closest_point_kernel(v_t, f_t, q_t)
        got = check_against_brute(
            "store frame %d" % k, v_t, f_t, q_t,
            torch.as_tensor(res["faces"], device=dev)[None],
            torch.as_tensor(res["sqdist"], device=dev)[None], brute,
            quiet=True)
        worst["sqdist_gap"] = max(worst["sqdist_gap"], got["sqdist_gap"])
        worst["tie_gap"] = max(worst["tie_gap"], got["tie_gap"])
        worst["faces_differ"] += got["faces_differ"]
    check(out["leaf_boxes_in_frames"] == len(anim["run"]),
          "store: leaf_boxes launched %d times over %d frames"
          % (out["leaf_boxes_in_frames"], len(anim["run"])))
    rec["frames"] = dict(
        worst, frames=len(anim["run"]), tolerance=tol,
        sequence_bytes=anim["manifest"]["bytes"],
        raw_frame_bytes=int(sum(v.nbytes for v, _ in anim["stream"])),
        resolve_ms_p50=statistics.median(
            fr["resolve_s"] * 1e3 for fr in anim["run"]),
        frame_ms_p50=statistics.median(
            fr["out"]["latency_s"] * 1e3 for fr in anim["run"]),
        leaf_boxes=out["leaf_boxes_in_frames"], stats=anim["stats"])
    needed = {k for k, paths in KERNEL_PATHS.items() if "store" in paths}
    for name in sorted(needed):
        check(launches[name] > 0, "kernel %s never launched on the store "
              "path" % name)
    counted_only(launches, needed, "the store path")
    rec["launches"] = {k: n for k, n in launches.items() if n}
    rec["step_launches"] = out["step_launches"]
    return rec


def drive_store_phase(inp, dev, smi):
    """Phase 19 -> (its record, launches on its counted window), in a
    temporary store root (MESH_TPU_STORE_DIR) removed afterwards."""
    import shutil

    from mesh_tpu_torch.store import clear_page_cache

    folder = os.path.join(_REPO, "build", "chip_smoke_store")
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    log("== store: the scan sphere's cold start (a child, side-car and "
        "rebuild arms, best of %d), tiers and Mesh.load_from_store, %d "
        "store-keyed requests of %d queries on posed body 0, %d delta frames "
        "through AvatarSession(digest=)" % (
            STORE_COLD_REPS, STORE_REQUESTS, SERVE_QUERIES, STORE_FRAMES))
    try:
        with knobs_set(MESH_TPU_STORE_DIR=os.path.join(folder, "root"),
                       MESH_TPU_INCIDENT_DIR=os.path.join(folder,
                                                          "incidents")):
            clear_page_cache()
            out, launches = drive_store(inp, dev, folder)
            rec = check_store(out, launches, inp, dev)
    finally:
        clear_page_cache()
        shutil.rmtree(folder, ignore_errors=True)
    check(out["phase_s"] <= STORE_BUDGET_S, "store: %.1f s, budget %.0f s"
          % (out["phase_s"], STORE_BUDGET_S))
    c = rec["cold_start"]
    log("  cold start (host clock, best of %d, on %s): side-car arm %.3f s, "
        "rebuild arm %.3f s (%d faces, %d queries; side-car hits %d, build "
        "misses %d; child %.1f s)" % (
            STORE_COLD_REPS, smi, c["sidecar_best_s"], c["rebuild_best_s"],
            c["faces"], c["queries"], c["sidecar_hits"],
            c["sidecar_arm_build_misses"], c["child_wall_s"]))
    s = rec["serve"]
    log("  store-keyed requests (host clock, on %s): page_in paged %.3f ms, "
        "p50 %.4f ms (resident %.4f), a paged mesh's upload p50 %.3f ms, "
        "latency p50 keyed %.3f / inline %.3f ms, rungs %s" % (
            smi, s["page_in_ms_paged"], s["page_in_ms_p50"],
            s["page_in_ms_resident_p50"], s["upload_ms_p50"],
            s["latency_ms_keyed_p50"], s["latency_ms_inline_p50"],
            s["rungs"]))
    fr = rec["frames"]
    log("  delta frames: %d, decode error %.3g within %.3g, %d of %d bytes "
        "of raw frames, resolve p50 %.3f ms, frame p50 %.3f ms, leaf_boxes "
        "%d; vs brute: sqdist %.3g, %d faces differ at ties (gap %.3g)" % (
            fr["frames"], fr["decode_err"], fr["tolerance"],
            fr["sequence_bytes"], fr["raw_frame_bytes"], fr["resolve_ms_p50"],
            fr["frame_ms_p50"], fr["leaf_boxes"], fr["sqdist_gap"],
            fr["faces_differ"], fr["tie_gap"]))
    log("  steps (s): %s; phase %.1f s (budget %.0f s); launches %s" % (
        ", ".join("%s %.2f" % kv for kv in out["times_s"].items()),
        out["phase_s"], STORE_BUDGET_S, rec["launches"]))
    log("store record (on %s): %s" % (smi, json.dumps(rec)))
    return rec, launches


# ---------------------------------------------------------------------------
# Phase 20: the fleet tier and the obs tooling it reads through.

#: bench.py fleet_proxy's shape (bench.py:1756) with real meshes: 16 posed
#: SMPL-sized bodies in a store, 3 replicas, 8 rounds of one request a key
FLEET_BODIES = 16
FLEET_ROUNDS = 8
FLEET_REPLICAS = 3
#: the replicas' per-tenant bound: no request of a replay is shed, so both
#: replays admit the same sequence (the spill drive sets its own bound, 1)
FLEET_QUEUE = 8192
#: synth_mix's 11.2 s replayed at twice its pace (the checksum is
#: invariant to the speed)
FLEET_REPLAY_SPEED = 2.0
#: 20e: Mesh.closest_faces_and_points timed by utils.profiling.time_fn
FLEET_TIME_FN_REPS = 10
#: 20g: the staged harness's budgets (the hung stage's by its knob)
FLEET_STAGE_TIMEOUT_S = 180.0
FLEET_STAGE_SLEEP_S = 3.0
#: 20h: requests through the witnessed child's 2-replica router
FLEET_WITNESS_REQUESTS = 8
FLEET_CHILD_TIMEOUT_S = 300
FLEET_BUDGET_S = 120.0

#: 20g's stage children: each runs mesh_tpu_torch on the card; the fault
#: hook (MESH_TPU_BENCH_FAULT) comes first, as a stage child's must
FLEET_STAGE_CHILD = r"""
import json, sys
from mesh_tpu_torch.obs import perf
name = sys.argv[1]
perf.inject_fault(name)
import numpy as np
import torch
if name == "probe":
    print(json.dumps({"metric": "probe", "value": 1.0,
                      "card": torch.cuda.get_device_name(0),
                      "backend_ok": bool(torch.cuda.is_available()),
                      "jax": "jax" in sys.modules}))
else:
    from mesh_tpu_torch import Mesh
    z = np.load(sys.argv[2])
    mesh = Mesh(z["v"], z["f"], device="cuda")
    faces, points = mesh.closest_faces_and_points(z["q"])
    np.savez(sys.argv[3], faces=faces, points=points)
    print(json.dumps({"metric": name, "value": float(len(z["q"])),
                      "sqdist_sum": float(((z["q"] - points) ** 2).sum()),
                      "jax": "jax" in sys.modules}))
"""

#: 20h's child: the lock witness over a 2-replica router on the card
FLEET_WITNESS_CHILD = r"""
import json, sys
import numpy as np
from mesh_tpu_torch import Mesh
from mesh_tpu_torch.fleet import FleetRouter
from mesh_tpu_torch.serve import QueryService
from mesh_tpu_torch.utils import lockwitness
if not lockwitness.installed():
    raise SystemExit("MESH_TPU_LOCK_WITNESS did not install the witness")
z = np.load(sys.argv[1])
mesh = Mesh(z["v"], z["f"], device="cuda")
router = FleetRouter({"w-%d" % i: QueryService(
    workers=2, device="cuda", default_deadline_s=30.0) for i in range(2)})
try:
    futures = [router.submit(mesh, z["q"], tenant="t%d" % (i % 2))
               for i in range(int(sys.argv[2]))]
    answers = [f.result(timeout=120) for f in futures]
finally:
    router.stop(write_stats=False)
path = lockwitness.dump()
print(json.dumps({"path": path, "answers": len(answers),
                  "rungs": sorted({a.rung for a in answers}),
                  "jax": "jax" in sys.modules}))
"""


def bridge_counts():
    """What the torch.monitor bridge folded into the registry: kernel
    libraries loaded (hits) and built (misses), and the misses' seconds."""
    from mesh_tpu_torch.obs import REGISTRY

    seconds = REGISTRY.get("mesh_tpu_kernel_cache_seconds")
    miss = [s for s in (seconds.snapshot()["series"] if seconds else ())
            if s["labels"].get("outcome") == "miss"]
    return {"hits": REGISTRY.counter(
                "mesh_tpu_kernel_cache_hits_total").total(),
            "misses": REGISTRY.counter(
                "mesh_tpu_kernel_cache_misses_total").total(),
            "miss_seconds_n": miss[0]["count"] if miss else 0,
            "miss_seconds": miss[0]["sum"] if miss else 0.0}


def fleet_inputs(model, dev):
    """Phase 20's bodies: FLEET_BODIES posed by lbs from one seed, and per
    body FLEET_ROUNDS + 1 sets of SERVE_QUERIES N(0, 0.4) queries (the
    last for the round after the drain)."""
    from mesh_tpu_torch.models import lbs

    rng = np.random.RandomState(20)
    betas = torch.as_tensor(rng.randn(FLEET_BODIES, model.num_betas) * 0.3,
                            dtype=torch.float32, device=dev)
    pose = torch.as_tensor(rng.randn(FLEET_BODIES, model.num_joints, 3) * 0.1,
                           dtype=torch.float32, device=dev)
    verts, _ = lbs(model, betas, pose, device=dev)
    return {"verts": verts.cpu().numpy(),
            "faces": model.faces.cpu().numpy(),
            "queries": np.asarray(rng.randn(
                FLEET_BODIES, FLEET_ROUNDS + 1, SERVE_QUERIES, 3) * 0.4,
                np.float32)}


class _Kept(object):
    """A router as the loadgen drivers see it, keeping every request's
    mesh, points and future for the checks after the window."""

    def __init__(self, router):
        self.router = router
        self.kept = []
        self._lock = threading.Lock()

    def submit(self, mesh, points, **kw):
        future = self.router.submit(mesh, points, **kw)
        with self._lock:
            self.kept.append((mesh, points, future))
        return future

    def query(self, mesh, points, **kw):
        return self.submit(mesh, points, **kw).result()

    def admission_checksums(self):
        return self.router.admission_checksums()


def null_fleet_checksums(names, keys, queries, rounds):
    """The admission checksums a fleet of the same membership gives on the
    same submit sequence when its replicas answer from plain Python (no
    card, no timing): what step a's must equal."""
    from mesh_tpu_torch.fleet import FleetRouter
    from mesh_tpu_torch.serve import HealthMonitor, QueryService, Rung
    from mesh_tpu_torch.serve import ServeResult

    def ok(mesh, points, chunk, timeout):
        return ServeResult(np.zeros((1, len(points)), np.uint32),
                           np.zeros((len(points), 3)), "null", True)

    router = FleetRouter({n: QueryService(
        workers=1, ladder=[Rung("null", ok)], device="cpu",
        health=HealthMonitor(watchdog=False),
        max_queue_per_tenant=FLEET_QUEUE) for n in names})
    try:
        for r in range(rounds):
            for fut in [router.submit(k, queries[i, r], tenant="affinity")
                        for i, k in enumerate(keys)]:
                fut.result(timeout=60)
        return router.admission_checksums()
    finally:
        router.stop(write_stats=False)


def start_witness_child(folder, body_npz):
    """20h's child, started in the background (it runs while the staged
    harness's children do): (process, witness path, stdout path)."""
    wit = os.path.join(folder, "witness.jsonl")
    log_path = os.path.join(folder, "witness_child.out")
    env = dict(os.environ, PYTHONPATH=_REPO, MESH_TPU_LOCK_WITNESS="1",
               MESH_TPU_LOCK_WITNESS_FILE=wit)
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", FLEET_WITNESS_CHILD, body_npz,
             str(FLEET_WITNESS_REQUESTS)], stdout=out,
            stderr=subprocess.STDOUT, env=env, cwd=_REPO)
    return proc, wit, log_path


def wait_witness_child(proc, log_path):
    try:
        rc = proc.wait(timeout=FLEET_CHILD_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log_path) as fh:
        text = fh.read()
    check(rc == 0, "fleet witness: the child exited %s: %s" % (rc,
                                                               text[-4000:]))
    return json.loads(text.strip().splitlines()[-1])


def run_fleet_stages(folder, body_npz):
    """20g: the staged harness over three children on the card -> (results,
    the partial file's doc, the status counters' moves)."""
    from mesh_tpu_torch.obs import REGISTRY
    from mesh_tpu_torch.obs import perf

    def counts():
        return {st: {lb["stage"]: n for lb, n in REGISTRY.counter(
            "mesh_tpu_bench_stage_%s_total" % st)._labelled()}
            for st in ("ok", "hung", "crashed", "skipped")}

    env = {"PYTHONPATH": _REPO}
    specs = [
        perf.StageSpec("probe", [sys.executable, "-c", FLEET_STAGE_CHILD,
                                 "probe"],
                       perf.stage_timeout("probe", FLEET_STAGE_TIMEOUT_S),
                       gate=True, env=env),
        perf.StageSpec("query", [sys.executable, "-c", FLEET_STAGE_CHILD,
                                 "query", body_npz,
                                 os.path.join(folder, "query_out.npz")],
                       perf.stage_timeout("query", FLEET_STAGE_TIMEOUT_S),
                       requires_backend=True, env=env),
        perf.StageSpec("sleep", [sys.executable, "-c", FLEET_STAGE_CHILD,
                                 "sleep"],
                       perf.stage_timeout("sleep", FLEET_STAGE_SLEEP_S),
                       env=dict(env, MESH_TPU_BENCH_FAULT="sleep:hang"))]
    before = counts()
    partial = perf.partial_path(os.path.join(folder, "bench_partial.json"))
    results = perf.run_stages(specs, partial, log=log)
    after = counts()
    moved = {st: {k: n - before[st].get(k, 0) for k, n in after[st].items()
                  if n != before[st].get(k, 0)} for st in after}
    return results, perf.read_bench_json(partial), moved


def fleet_answer(label, resp, v, f, q, dev, brutes):
    """One served answer against the brute-force kernel on the same inputs
    (the brute result cached per body and query set)."""
    import zlib

    from mesh_tpu_torch.query import closest_kernel as ck

    key = (zlib.crc32(np.ascontiguousarray(v).tobytes()),
           zlib.crc32(np.ascontiguousarray(q).tobytes()))
    v_t = torch.as_tensor(v, device=dev)[None]
    f_t = torch.as_tensor(np.asarray(f, np.int64), device=dev)
    q_t = torch.as_tensor(q, device=dev)[None]
    if key not in brutes:
        brutes[key] = ck.closest_point_kernel(
            v_t, f_t, q_t,
            assume_nondegenerate=ck.mesh_is_nondegenerate(v, f))
    sq = ((q.astype(np.float64) - resp.points) ** 2).sum(-1)
    return check_against_brute(
        label, v_t, f_t, q_t,
        torch.as_tensor(resp.faces[0].astype(np.int64), device=dev)[None],
        torch.as_tensor(sq, dtype=torch.float32, device=dev)[None],
        brutes[key], quiet=True)


def drive_fleet(inp, dev, folder):
    """Phase 20 a-e, launch counts set to 0 just before a and read just
    after e; f-h after the window (h's child started before g's); the
    records the checks read."""
    from mesh_tpu_torch import Mesh
    from mesh_tpu_torch.fleet import (FleetCoordinator, FleetRouter,
                                      aggregate_sinks, read_sink)
    from mesh_tpu_torch.obs import (REGISTRY, TRACER, get_ledger,
                                    get_trace_tail, prof, prometheus_text,
                                    render_tree, write_jsonl)
    from mesh_tpu_torch.obs.clock import monotonic
    from mesh_tpu_torch.obs.replay import synth_mix
    from mesh_tpu_torch.serve import (QueryService, run_closed_loop,
                                      run_trace_replay)
    from mesh_tpu_torch.store import get_store
    from mesh_tpu_torch.utils import tuning
    from mesh_tpu_torch.utils.profiling import time_fn, trace

    store = get_store()
    verts, faces, queries = inp["verts"], inp["faces"], inp["queries"]
    keys = [store.ingest(v, faces) for v in verts]
    body_of = {k: i for i, k in enumerate(keys)}
    out = {"keys": keys, "times_s": {}, "answers": [], "sent": 0}
    times = out["times_s"]

    def make(name, **kw):
        kw.setdefault("workers", SERVE_WORKERS)
        kw.setdefault("max_queue_per_tenant", FLEET_QUEUE)
        return QueryService(default_deadline_s=SERVE_DEADLINE_S,
                            stats_path=os.path.join(folder, name + ".json"),
                            device=dev, **kw)

    def counter(name):
        return REGISTRY.counter(name).total()

    rows = []
    requests0 = counter("mesh_tpu_serve_requests_total")
    get_ledger().add_listener(rows.append)
    names = ["replica-%d" % i for i in range(FLEET_REPLICAS)]
    replicas = {n: make(n) for n in names}
    router = FleetRouter(replicas)
    kept = _Kept(router)
    reset_launches()
    marks = _Launches()
    t_phase = time.perf_counter()
    try:
        # a. affinity, then a drain
        t0 = time.perf_counter()
        out["primaries"] = [
            router.plan("closest_point", k, queries[i, 0])[1][0]
            for i, k in enumerate(keys)]
        out["first_seen"] = []
        for r in range(FLEET_ROUNDS):
            futures = [kept.submit(k, queries[i, r], tenant="affinity")
                       for i, k in enumerate(keys)]
            for i, fut in enumerate(futures):
                fut.result(timeout=60)
                seen = (out["primaries"][i], keys[i])
                if seen not in out["first_seen"]:
                    out["first_seen"].append(seen)
        out["affinity_rows"] = len(rows)
        out["affinity_sums"] = router.admission_checksums()
        victim = out["primaries"][0]
        replicas[victim].health.begin_drain()
        out["victim"] = victim
        out["after_drain"] = [
            router.plan("closest_point", k, queries[i, FLEET_ROUNDS])[1][0]
            for i, k in enumerate(keys)]
        first = len(rows)
        for fut in [kept.submit(k, queries[i, FLEET_ROUNDS],
                                tenant="drained")
                    for i, k in enumerate(keys)]:
            fut.result(timeout=60)
        out["drain_rows"] = (first, len(rows))
        times["a_affinity"] = time.perf_counter() - t0
        marks.mark("a_affinity")
        # b. spill, the kill switch, the closed loop, two replays
        t0 = time.perf_counter()
        key0, q0 = keys[0], queries[0, 0]
        spill = {n: make(n, workers=1, max_queue_per_tenant=1)
                 for n in ("spill-a", "spill-b")}
        spill_router = FleetRouter(spill)
        try:
            order = spill_router.plan("closest_point", key0, q0)[1]
            spills0 = REGISTRY.counter("mesh_tpu_fleet_spill_total").value(
                replica=order[0])
            rejected0 = REGISTRY.counter(
                "mesh_tpu_fleet_requests_total").value(
                    replica=order[0], outcome="rejected")
            spill[order[0]].hold()
            try:
                burst = [spill_router.submit(key0, q0, tenant="stampede")
                         for _ in range(2)]
            finally:
                spill[order[0]].release()
            out["spill"] = {
                "order": order,
                "answers": [fut.result(timeout=60) for fut in burst],
                "spills": REGISTRY.counter(
                    "mesh_tpu_fleet_spill_total").value(
                        replica=order[0]) - spills0,
                "rejected": REGISTRY.counter(
                    "mesh_tpu_fleet_requests_total").value(
                        replica=order[0], outcome="rejected") - rejected0}
        finally:
            spill_router.stop(write_stats=False)
        # two admissions and the primary's queue_full hop
        out["sent"] += 3
        out["answers"] += [("spill", key0, q0, a)
                           for a in out["spill"]["answers"]]
        solo = make("solo")
        solo_router = FleetRouter({"solo": solo})
        fleet0 = counter("mesh_tpu_fleet_requests_total")
        try:
            with knobs_set(MESH_TPU_FLEET=0):
                via = solo_router.query(key0, q0, tenant="solo")
            direct = solo.query(key0, q0, tenant="solo")
        finally:
            solo_router.stop(write_stats=False)
        out["kill_switch"] = {
            "equal": bool(np.array_equal(via.faces, direct.faces)
                          and np.array_equal(via.points, direct.points)),
            "fleet_requests": counter("mesh_tpu_fleet_requests_total")
            - fleet0}
        out["sent"] += 2
        out["answers"] += [("kill switch", key0, q0, via),
                           ("direct", key0, q0, direct)]
        first = len(rows)
        out["closed"] = run_closed_loop(
            kept, key0, q0, clients=SERVE_CLIENTS,
            requests_per_client=SERVE_REQUESTS_PER_CLIENT,
            deadline_s=SERVE_DEADLINE_S)
        out["closed_rows"] = (first, len(rows))
        trace_doc = synth_mix(seed=SERVE_TRACE_SEED)
        out["replays"] = []
        for _ in range(2):
            router.reset_admission_log()
            out["replays"].append(run_trace_replay(
                kept, key0, q0, trace_doc, speed=FLEET_REPLAY_SPEED))
        times["b_spill_loops"] = time.perf_counter() - t0
        marks.mark("b_spill_loops")
        # c. the coordinator over the replicas' stats callables
        t0 = time.perf_counter()
        coord = FleetCoordinator({n: s.stats for n, s in replicas.items()})
        sinks = [read_sink(s.stats) for s in replicas.values()]
        out["sinks"], out["aggregate"] = sinks, aggregate_sinks(sinks)
        out["step"] = coord.step()
        now = monotonic()
        out["grants"] = [
            coord.grant_widen("replica-0", now=now),
            coord.grant_widen("replica-1", now=now + 1.0),
            coord.grant_widen("replica-1",
                              now=now + coord.widen_cooldown_s + 1.0)]
        out["coordinator"] = coord.status()
        tuning.reset()          # a shrink step's actuations end here
        times["c_coordinator"] = time.perf_counter() - t0
        marks.mark("c_coordinator")
        # d. prof: per replica, the fleet, one request's trace, phase 18
        t0 = time.perf_counter()
        by_replica = {}
        for row in rows:
            if row.get("replica"):
                by_replica.setdefault(row["replica"], []).append(row)
        out["replica_stats"] = {n: prof.stats_from_records(r)
                                for n, r in sorted(by_replica.items())}
        out["fleet_attribution"] = prof.fleet_attribution(
            sorted(out["replica_stats"].items()))[1]
        ring = os.path.join(folder, "ledger_ring.jsonl")
        out["ring_rows"] = get_ledger().dump_jsonl(ring)
        last = [r for r in prof.load_rows(ring) if r.get("replica")][-1]
        out["trace"] = prof.request_trace(last["request_id"], paths=[ring],
                                          tail=get_trace_tail())
        out["trace_plan"] = router.plan("closest_point", key0, q0)[1]
        out["trace_lines"] = prof.render_request_trace(out["trace"])
        out["serve18"] = prof.load(inp["closed_ledger"])
        lo, hi = out["closed_rows"]
        out["fleet_closed"] = prof.stats_from_records(rows[lo:hi])
        out["vs_serve18"] = prof.diff(out["serve18"], out["fleet_closed"])
        times["d_prof"] = time.perf_counter() - t0
        marks.mark("d_prof")
        # e. export and profiling around single requests
        t0 = time.perf_counter()
        out["prometheus"] = prometheus_text()
        TRACER.clear()
        with knobs_set(MESH_TPU_OBS=1):
            out["answers"].append(("spans", key0, q0,
                                   kept.query(key0, q0, tenant="spans")))
        spans = TRACER.events()
        out["tree"] = render_tree(spans)
        out["span_lines"] = write_jsonl(os.path.join(folder, "spans.jsonl"),
                                        events=spans)
        out["spans"] = len(spans)
        with trace(os.path.join(folder, "trace")) as profile:
            out["answers"].append(("traced", key0, q0,
                                   kept.query(key0, q0, tenant="traced")))
        out["trace_path"] = profile.trace_path
        mesh = Mesh(verts[0], faces, device=dev)
        out["time_fn_s"] = time_fn(
            lambda: mesh.closest_faces_and_points(q0),
            reps=FLEET_TIME_FN_REPS, warmup=1)
        times["e_export"] = time.perf_counter() - t0
        marks.mark("e_export")
        launches = read_launches()
        out["window_s"] = time.perf_counter() - t_phase
        out["step_launches"] = marks.steps
    finally:
        get_ledger().remove_listener(rows.append)
        router.stop(write_stats=False)
    out["rows"] = rows
    out["requests_moved"] = counter("mesh_tpu_serve_requests_total") \
        - requests0
    out["sent"] += len(kept.kept)
    out["answers"] += [("fleet", k, q, fut.result(timeout=60))
                       for k, q, fut in kept.kept]
    out["body_of"] = body_of
    # f-h after the window: h's child runs while g's do
    body_npz = os.path.join(folder, "body0.npz")
    np.savez(body_npz, v=verts[0], f=faces, q=queries[0, 0])
    t0 = time.perf_counter()
    witness = start_witness_child(folder, body_npz)
    try:
        out["stages"], out["partial"], out["stage_counts"] = \
            run_fleet_stages(folder, body_npz)
    finally:
        out["witness"] = wait_witness_child(witness[0], witness[2])
    times["gh_children"] = time.perf_counter() - t0
    out["witness_edges"] = witness[1]
    with np.load(os.path.join(folder, "query_out.npz")) as z:
        out["stage_answer"] = (z["faces"], z["points"])
    return out, launches


def _acyclic(edges):
    """True when the witnessed order graph (src -> dst sites) has no
    cycle."""
    graph = {}
    for src, dst, _ in edges:
        graph.setdefault(src, set()).add(dst)
    state = {}

    def visit(node):
        state[node] = 1
        for nxt in graph.get(node, ()):
            if state.get(nxt) == 1 or (nxt not in state and not visit(nxt)):
                return False
        state[node] = 2
        return True

    return all(state.get(n) == 2 or visit(n) for n in list(graph))


def _row_key(row):
    return row["routing_key"].split("|")[1]


def check_fleet_routing(out, inp, rec):
    """(a) and (b): affinity, the drain, spill, the kill switch and the
    loads through the router."""
    keys, prim = out["keys"], out["primaries"]
    names = ["replica-%d" % i for i in range(FLEET_REPLICAS)]
    rows = out["rows"]
    served = {}
    for row in rows[:out["affinity_rows"]]:
        served.setdefault(_row_key(row), []).append(row["replica"])
    for i, k in enumerate(keys):
        check(served.get(k) == [prim[i]] * FLEET_ROUNDS,
              "fleet affinity: key %s served by %s, its ring primary is %s"
              % (k, served.get(k), prim[i]))
    check(len(set(prim)) > 1, "fleet: every key on one replica %s" % prim)
    null = null_fleet_checksums(names, keys, inp["queries"], FLEET_ROUNDS)
    check(out["affinity_sums"] == null, "fleet: admission checksums %s, a "
          "plain-Python fleet's on the same sequence %s"
          % (out["affinity_sums"], null))
    victim, after = out["victim"], out["after_drain"]
    moved = [i for i in range(len(keys)) if after[i] != prim[i]]
    check(moved and all(prim[i] == victim for i in moved)
          and all(after[i] != victim for i in range(len(keys))),
          "fleet drain of %s moved keys %s (primaries %s, after %s)"
          % (victim, moved, prim, after))
    lo, hi = out["drain_rows"]
    check(sorted((_row_key(r), r["replica"]) for r in rows[lo:hi])
          == sorted(zip(keys, after)), "fleet: the round after the drain "
          "was not served by the new primaries")
    sp = out["spill"]
    spilled = [r for r in rows if r.get("tenant") == "stampede"]
    check(sp["spills"] == 1 and sp["rejected"] == 0
          and sorted((r["replica"], bool(r.get("spilled"))) for r in spilled)
          == sorted([(sp["order"][0], False), (sp["order"][1], True)]),
          "fleet spill: %d spills, %d rejections, rows %s" % (
              sp["spills"], sp["rejected"],
              [(r["replica"], r.get("spilled")) for r in spilled]))
    ks = out["kill_switch"]
    check(ks["equal"] and ks["fleet_requests"] == 0, "fleet kill switch: "
          "bit-equal %s, fleet series moved %s" % (ks["equal"],
                                                   ks["fleet_requests"]))
    closed = out["closed"]
    n_closed = SERVE_CLIENTS * SERVE_REQUESTS_PER_CLIENT
    check(closed["errors"] == 0 and closed["shed"] == 0
          and closed["ok"] == closed["requests"] == n_closed
          and closed["rungs"] == {"engine": n_closed},
          "fleet closed loop: %s" % closed)
    first, second = out["replays"]
    for report in out["replays"]:
        check(report["errors"] == 0 and report["shed"] == 0
              and report["requests"] == report["admissions"],
              "fleet replay: %s" % report)
    check(first["checksum"] == second["checksum"]
          and first["replica_checksums"] == second["replica_checksums"],
          "fleet replay: checksums %s / %s, replicas %s / %s" % (
              first["checksum"], second["checksum"],
              first["replica_checksums"], second["replica_checksums"]))
    rec["affinity"] = {"keys": len(keys), "rounds": FLEET_ROUNDS,
                       "primaries": prim, "first_seen": out["first_seen"],
                       "checksums": out["affinity_sums"]}
    rec["drain"] = {"victim": victim, "moved": len(moved)}
    rec["spill"] = {"spills": sp["spills"], "rejected": sp["rejected"]}
    rec["closed_loop"] = {k: closed[k] for k in (
        "p50_ms", "p95_ms", "p99_ms", "goodput_qps", "deadline_miss_rate",
        "shed_rate", "requests", "rungs")}
    rec["replay"] = {k: first[k] for k in (
        "admissions", "checksum", "replica_checksums", "p50_ms", "p99_ms",
        "paced_s")}
    rec["replay"]["second_p99_ms"] = second["p99_ms"]


def check_fleet_tools(out, inp, rec, dev):
    """(c)-(h): the coordinator, prof, the exporters and profiling, the
    bridge's counts, the staged harness and the lock witness."""
    import re
    import types

    from mesh_tpu_torch import _build
    from mesh_tpu_torch.obs import REGISTRY, list_incidents, perf, prof

    # c. sinks sum per label set; one step; one grant per cooldown
    for name, entry in out["aggregate"].items():
        for series in entry["series"]:
            want = 0
            for sink in out["sinks"]:
                for s in sink["metrics"].get(name, {}).get("series", ()):
                    if s["labels"] == series["labels"]:
                        want += s["count" if entry["type"] == "histogram"
                                  else "value"]
            got = series["count" if entry["type"] == "histogram" else "value"]
            check(got == want, "fleet aggregate %s%s: %s, the sinks sum %s"
                  % (name, series["labels"], got, want))
    step, status = out["step"], out["coordinator"]
    check(step["decision"] in ("hold", "shrink", "release")
          and step["sinks"] == FLEET_REPLICAS, "fleet step %s" % step)
    want = [True, False, True] if status["pressure"] <= 0.1 else [False] * 3
    check(out["grants"] == want, "fleet grants %s at pressure %s"
          % (out["grants"], status["pressure"]))
    rec["coordinator"] = {"decision": step["decision"],
                          "pressure": step["pressure"],
                          "actions": len(step["actions"]),
                          "grants": out["grants"]}
    # d. prof
    names = ["replica-%d" % i for i in range(FLEET_REPLICAS)]
    check(set(out["replica_stats"]) <= set(names) | {"spill-a", "spill-b"}
          and len(out["fleet_attribution"]) >= 2,
          "fleet prof: replicas %s" % sorted(out["replica_stats"]))
    tr = out["trace"]
    check(len(tr["rows"]) == 1 and tr["rows"][0]["replica"]
          == out["trace_plan"][0] and _row_key(tr["rows"][0])
          == out["keys"][0], "fleet request trace %s (plan %s)"
          % (tr["rows"], out["trace_plan"]))
    s18 = out["serve18"]
    check(s18["total"]["count"] == SERVE_ROUNDS * SERVE_CLIENTS
          * SERVE_REQUESTS_PER_CLIENT, "prof of phase 18's closed loop: "
          "%s rows" % s18["total"]["count"])
    rec["prof"] = {
        "serve18_stages_ms": {k: {"p50": v["p50_s"] * 1e3,
                                  "p99": v["p99_s"] * 1e3,
                                  "mean": v["mean_s"] * 1e3,
                                  "count": v["count"]}
                              for k, v in s18["stages"].items()},
        "serve18_total_ms": {"p50": s18["total"]["p50_s"] * 1e3,
                             "p99": s18["total"]["p99_s"] * 1e3},
        "serve18_top": prof.top_lines(s18),
        "fleet_closed_vs_serve18": out["vs_serve18"][1],
        "fleet_attribution": out["fleet_attribution"],
        "request_trace": out["trace_lines"]}
    # e. the exporters and profiling
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? (\S+)$')
    lines = out["prometheus"].splitlines()
    for line in lines:
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            continue
        m = sample.match(line)
        check(m is not None and (m.group(2) in ("+Inf", "-Inf", "NaN")
                                 or float(m.group(2)) == float(m.group(2))),
              "prometheus_text: unparsable line %r" % line)
    check(out["spans"] > 0 and "serve.request" in out["tree"]
          and "engine.dispatch" in out["tree"]
          and out["span_lines"] == out["spans"] + 1,
          "render_tree of %d spans: %s" % (out["spans"], out["tree"][:400]))
    with open(out["trace_path"]) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = sorted({e["name"] for e in events
                      if e.get("cat") == "kernel" and "cull" in e["name"]})
    check(any("closest_cull_kernel" in n for n in kernels),
          "profiling.trace: no closest_faces kernel (closest_cull_kernel) "
          "among %s" % kernels)
    check(out["time_fn_s"] > 0, "time_fn %s" % out["time_fn_s"])
    rec["export"] = {"prometheus_lines": len(lines), "spans": out["spans"],
                     "trace_kernels": kernels,
                     "time_fn_ms": out["time_fn_s"] * 1e3}
    # f. the bridge: one event per kernel library at phase 1's build
    bridge = inp["bridge"]
    check(bridge["hits"] + bridge["misses"] == len(_build.KERNELS)
          and bridge["miss_seconds_n"] == bridge["misses"]
          and (bridge["misses"] == 0 or bridge["miss_seconds"] > 0),
          "bridge: %s for %d libraries" % (bridge, len(_build.KERNELS)))
    rec["bridge"] = bridge
    # g. the staged harness
    st = out["stages"]
    statuses = [r.status for r in st.values()]
    check(statuses == ["ok", "ok", "hung"], "staged harness: %s" % {
        n: (r.status, r.error) for n, r in st.items()})
    probe = st["probe"].record
    check(probe["card"] == torch.cuda.get_device_name(0)
          and not probe["jax"] and not st["query"].record["jax"],
          "staged probe %s" % probe)
    doc = out["partial"]
    check(doc["kind"] == "bench_partial" and [
        doc["stages"][n]["status"] for n in doc["order"]] == statuses,
        "bench_partial.json: %s" % doc)
    hangs = [p for p in list_incidents() if "bench_stage_hang" in p]
    check(len(hangs) == 1, "staged harness: incidents %s" % hangs)
    check(out["stage_counts"] == {"ok": {"probe": 1, "query": 1},
                                  "hung": {"sleep": 1}, "crashed": {},
                                  "skipped": {}},
          "staged counters moved %s" % out["stage_counts"])
    rc, lines = perf.perfcheck(doc, baseline=doc)
    check(rc == 0, "perfcheck of the partial doc: %s" % lines)
    faces, points = out["stage_answer"]
    v0, f0, q0 = inp["verts"][0], inp["faces"], inp["queries"][0, 0]
    resp = types.SimpleNamespace(faces=faces[None],
                                 points=points.astype(np.float64))
    rec["staged"] = {
        "statuses": dict(zip(st, statuses)),
        "elapsed_s": {n: r.elapsed_s for n, r in st.items()},
        "vs_brute": fleet_answer("staged query", resp, v0, f0, q0, dev, {})}
    # h. the lock witness
    from mesh_tpu_torch.utils import lockwitness

    edges = lockwitness.load(out["witness_edges"])
    with open(out["witness_edges"]) as fh:
        sites = [json.loads(ln)["site"] for ln in fh if '"site"' in ln]
    check(out["witness"]["answers"] == FLEET_WITNESS_REQUESTS
          and out["witness"]["rungs"] == ["engine"]
          and not out["witness"]["jax"], "witness child %s" % out["witness"])
    check(sites and all(s[0].startswith("mesh_tpu_torch/") for s in sites)
          and all(e[0][0].startswith("mesh_tpu_torch/")
                  and e[1][0].startswith("mesh_tpu_torch/") for e in edges),
          "witness sites %s" % sites)
    check(_acyclic([(a, b, n) for a, b, n in edges]),
          "witness: the order graph has a cycle: %s" % edges)
    above = [(a, b) for a, b, _ in edges
             if a[0] == "mesh_tpu_torch/fleet/router.py"
             and b[0] == "mesh_tpu_torch/serve/health.py"]
    check(above, "witness: no router -> health edge among %s" % edges)
    rec["witness"] = {"sites": len(sites), "edges": len(edges),
                      "router_above_health": above}


def check_fleet(out, launches, inp, dev):
    """Phase 20's checks, after the counted window."""
    rec = {"times_s": out["times_s"], "window_s": out["window_s"]}
    check_fleet_routing(out, inp, rec)
    # every answer against the brute-force kernel
    brutes, worst = {}, {"sqdist_gap": 0.0, "faces_differ": 0,
                         "tie_gap": 0.0}
    for label, key, q, resp in out["answers"]:
        check(resp.rung == "engine", "fleet %s answered by %s"
              % (label, resp.rung))
        res = fleet_answer("fleet " + label, resp,
                           inp["verts"][out["body_of"][key]], inp["faces"],
                           q, dev, brutes)
        worst = {k: max(worst[k], res[k]) for k in worst}
    rec["vs_brute"] = dict(worst, answers=len(out["answers"]))
    rows = out["rows"]
    check(all(r["outcome"] == "ok" and r["total_s"] > 0
              and {"queue", "page_in", "device", "respond"} <= set(r["stages"])
              for r in rows), "fleet: a ledger row without its stages")
    check(out["requests_moved"] == out["sent"] == len(rows) + 1,
          "fleet: mesh_tpu_serve_requests_total moved %d, %d requests sent, "
          "%d rows" % (out["requests_moved"], out["sent"], len(rows)))
    needed = {k for k, paths in KERNEL_PATHS.items() if "fleet" in paths}
    for name in sorted(needed):
        check(launches[name] > 0, "kernel %s never launched on the fleet "
              "path" % name)
    counted_only(launches, needed, "the fleet path")
    # every answer, and time_fn's warm-up and timed calls
    served = len(out["answers"]) + FLEET_TIME_FN_REPS + 1
    check(launches["closest_faces"] == launches["cull_records"]
          <= served + 8, "fleet: closest_faces %d, cull_records %d for %d "
          "answers" % (launches["closest_faces"], launches["cull_records"],
                       served))
    rec["launches"] = {k: n for k, n in launches.items() if n}
    rec["step_launches"] = out["step_launches"]
    rec["answers_served"] = served
    check_fleet_tools(out, inp, rec, dev)
    return rec


def drive_fleet_phase(inp, dev, smi):
    """Phase 20 -> (its record, launches on its counted window), in a
    temporary store root and incident folder removed afterwards."""
    import shutil

    from mesh_tpu_torch.store import clear_page_cache

    folder = os.path.join(_REPO, "build", "chip_smoke_fleet")
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    log("== fleet: %d posed bodies in a store behind %d replicas "
        "(QueryService(workers=%d)), %d rounds of %d queries a key, a drain, "
        "spill, the kill switch, a closed loop of %d x %d, synth_mix(seed=%d) "
        "replayed twice at %gx, the coordinator, prof, export, the bridge, "
        "the staged harness and the lock witness" % (
            FLEET_BODIES, FLEET_REPLICAS, SERVE_WORKERS, FLEET_ROUNDS,
            SERVE_QUERIES, SERVE_CLIENTS, SERVE_REQUESTS_PER_CLIENT,
            SERVE_TRACE_SEED, FLEET_REPLAY_SPEED))
    t_phase = time.perf_counter()
    try:
        with knobs_set(MESH_TPU_STORE_DIR=os.path.join(folder, "root"),
                       MESH_TPU_INCIDENT_DIR=os.path.join(folder,
                                                          "incidents")):
            clear_page_cache()
            out, launches = drive_fleet(inp, dev, folder)
            rec = check_fleet(out, launches, inp, dev)
    finally:
        clear_page_cache()
        shutil.rmtree(folder, ignore_errors=True)
        shutil.rmtree(os.path.dirname(SERVE_CLOSED_LEDGER),
                      ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    check(rec["phase_s"] <= FLEET_BUDGET_S, "fleet: %.1f s, budget %.0f s"
          % (rec["phase_s"], FLEET_BUDGET_S))
    log("  prof of phase 18's closed loop (a dispatch's stages, host clock, "
        "ms; on %s):" % smi)
    for line in rec["prof"]["serve18_top"]:
        log("    " + line)
    log("  the fleet's closed loop against phase 18's (prof.diff):")
    for line in rec["prof"]["fleet_closed_vs_serve18"]:
        log("    " + line)
    log("  fleet attribution over the replicas' ledgers:")
    for line in rec["prof"]["fleet_attribution"]:
        log("    " + line)
    c = rec["closed_loop"]
    log("  closed loop through the router (host clock, on %s): p50 %.3f ms, "
        "p95 %.3f ms, p99 %.3f ms, goodput %.1f qps, deadline-miss rate "
        "%.4f, rungs %s" % (smi, c["p50_ms"], c["p95_ms"], c["p99_ms"],
                            c["goodput_qps"], c["deadline_miss_rate"],
                            c["rungs"]))
    log("  affinity %s; drain %s; spill %s; replay %s; coordinator %s" % (
        rec["affinity"]["primaries"], rec["drain"], rec["spill"],
        {k: rec["replay"][k] for k in ("admissions", "checksum", "p50_ms",
                                       "p99_ms", "second_p99_ms")},
        rec["coordinator"]))
    log("  export %s; bridge %s; staged %s; witness %s" % (
        rec["export"], rec["bridge"], rec["staged"]["statuses"],
        {k: rec["witness"][k] for k in ("sites", "edges")}))
    log("  launches on the window: closest_faces %d, cull_records %d for %d "
        "answers (%s); vs brute %s" % (
            rec["launches"].get("closest_faces", 0),
            rec["launches"].get("cull_records", 0), rec["answers_served"],
            rec["step_launches"], rec["vs_brute"]))
    log("  steps (s): %s; counted window %.1f s; phase %.1f s (budget %.0f s)"
        % (", ".join("%s %.2f" % kv for kv in rec["times_s"].items()),
           rec["window_s"], rec["phase_s"], FLEET_BUDGET_S))
    log("fleet record (on %s): %s" % (smi, json.dumps(rec, default=str)))
    return rec, launches


# ---------------------------------------------------------------------------
# Phase 21: the parallel layer on one card.

#: the world of phase 21: ranks sharing card 0 under gloo
PARALLEL_RANKS = 4
#: 21b's landmark-like queries (surface samples of the sphere, noisy)
PARALLEL_LANDMARKS = 4096
#: 21f: the lane's threshold, and a request below it
PARALLEL_LANE_MIN_Q = 1024
PARALLEL_LANE_SMALL = 600
#: 21d-e: the sharded fit's first-step tolerance against the unsharded
#: step (the reference's), the checkpoint's step, timed repeats of a-c
PARALLEL_FIT_TOL = 1e-5
PARALLEL_CKPT_STEP = 3
PARALLEL_REPS = 3
PARALLEL_CHILD_TIMEOUT_S = 420
PARALLEL_BUDGET_S = 180.0

#: one rank of phase 21's world: a-e with its launches counted over its
#: window, then its times; writes rank<r>.npz (rank 0: every replicated
#: result; the others a digest of each) and rank<r>.json
PARALLEL_RANK = r"""
import hashlib, json, os, statistics, sys, time
import numpy as np
import torch
import torch.distributed as dist

rank, world, port, folder, device, backend = sys.argv[1:7]
rank, world = int(rank), int(world)
dev = torch.device(device)
if dev.type == "cuda":
    # NCCL: a card a rank; gloo: every rank on card 0
    torch.cuda.set_device(rank if backend == "nccl" else 0)
dist.init_process_group(backend, init_method="tcp://localhost:" + port,
                        world_size=world, rank=rank)
from mesh_tpu_torch import parallel as par
from mesh_tpu_torch.convert import fit_state_from_arrays
from mesh_tpu_torch.models import synthetic_body_model
from mesh_tpu_torch.parallel import fit, sharding
from mesh_tpu_torch.query import closest_kernel as ck
from mesh_tpu_torch.query import ray_kernel as ray

inp = dict(np.load(os.path.join(folder, "inputs.npz")))
counters = (ck.LAUNCHES, ray.LAUNCHES)


def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize()


def wall(fn):
    dist.barrier()
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def rows(state):
    return {k: getattr(state, k).detach().cpu().numpy()
            for k in fit.FIT_PARAMS}


arrays, doc = {}, {"rank": rank, "world": world,
                   "backend": dist.get_backend(), "device": str(dev)}
mesh = par.make_device_mesh(device=device)
v, f = inp["body_v"], inp["body_f"]
model = synthetic_body_model(seed=0, device=dev)
for c in counters:
    for k in c:
        c[k] = 0
t_window = time.perf_counter()
# a. config 5 on the mesh, then the multi-process form with ragged counts
arrays["a"] = par.sharded_closest_faces_and_points(v, f, inp["scan"], mesh)
lo, hi = inp["ragged"][rank], inp["ragged"][rank + 1]
arrays["a_multihost"] = par.multihost_closest_faces_and_points(
    v, f, inp["scan"][lo:hi], mesh)
# b. face-sharded, both merges
for merge in ("gather", "ring"):
    arrays["b_" + merge] = par.sharded_closest_faces_sharded_topology(
        inp["sphere_v"], inp["sphere_f"], inp["landmarks"], mesh,
        merge=merge)
# c. visibility and normals
arrays["c_vis"] = par.sharded_visibility(v, f, inp["cams"],
                                         n=inp["body_n"], mesh=mesh)
arrays["c_batch_vis"] = par.sharded_batched_visibility(
    inp["vis_bodies"], f, inp["cams"], mesh)
arrays["c_normals"] = par.sharded_batched_vert_normals(
    inp["main_bodies"], f, mesh).cpu().numpy()
# d, e. the sharded fit, a checkpoint at step PARALLEL_CKPT_STEP
fits = {}
for label, shape in (("bench_256", (world, 1)), ("config5_100k", (1, world))):
    m = par.make_device_mesh(axis_names=("dp", "sp"), shape=shape,
                             device=device)
    target = inp["fit_" + label]
    state = fit_state_from_arrays(
        {k: inp["fit_%s_%s" % (label, k)] for k in fit.FIT_PARAMS},
        inp["fit_%s_count" % label],
        {k: inp["fit_%s_mu_%s" % (label, k)] for k in fit.FIT_PARAMS},
        {k: inp["fit_%s_nu_%s" % (label, k)] for k in fit.FIT_PARAMS},
        device=dev, mesh=m)
    step = par.make_fit_step(model, fit.adam, mesh=m)
    run = {"losses": [], "step_ms": [], "rows": state.shard.rows}
    for i in range(int(inp["fit_steps"])):
        if i == int(inp["ckpt_step"]):
            path = par.save_fit_state(
                os.path.join(folder, "ckpt_" + label), state, step=i)
            template = par.place_fit_state(fit.init_fit_state(
                model, target.shape[0], device=dev)[0], m)
            restored, run["restored_at"] = par.restore_fit_state(path,
                                                                 template)
        (state, loss), ms = wall(lambda: step(state, target))
        run["losses"].append(float(loss))
        run["step_ms"].append(ms)
        if i == 0:
            run["step1"] = rows(state)
        if i == int(inp["ckpt_step"]):
            nxt, r_loss = step(restored, target)
            run["resumed_equal"] = float(r_loss) == float(loss) and all(
                np.array_equal(a, rows(state)[k])
                for k, a in rows(nxt).items())
    fits[label] = run
sync()
doc["window_s"] = time.perf_counter() - t_window
doc["launches"] = {k: n for c in counters for k, n in c.items() if n}

# times, after the window
doc["a_ms"] = statistics.median([
    wall(lambda: par.sharded_closest_faces_and_points(v, f, inp["scan"],
                                                      mesh))[1]
    for _ in range(int(inp["reps"]))])
n_rows = -(-len(inp["scan"]) // world)
mine = torch.as_tensor(inp["scan"][rank * n_rows:(rank + 1) * n_rows],
                       device=dev)
vt, ft = torch.as_tensor(v, device=dev), torch.as_tensor(
    f.astype(np.int64), device=dev)
nondegen = ck.mesh_is_nondegenerate(v, f)
kernel_ms = []
for _ in range(int(inp["reps"])):
    dist.barrier()
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        ck.closest_point_kernel(vt, ft, mine, assume_nondegenerate=nondegen)
        end.record()
        end.synchronize()
        kernel_ms.append(start.elapsed_time(end))
    else:
        kernel_ms.append(wall(lambda: ck.closest_point_kernel(
            vt, ft, mine, assume_nondegenerate=nondegen))[1])
doc["kernel_ms"] = statistics.median(kernel_ms)
sv, sf = inp["sphere_v"], inp["sphere_f"]
padded, _ = sharding._pad_rows(sf.astype(np.int64), world)
per = len(padded) // world
res, key = sharding._closest_keyed(
    torch.as_tensor(sv, device=dev),
    torch.as_tensor(padded[rank * per:(rank + 1) * per], device=dev),
    torch.as_tensor(inp["landmarks"], device=dev), 512, True)
packed = torch.cat([key[:, None], res["sqdist"][:, None],
                    res["part"].to(torch.float32)[:, None], res["point"]],
                   dim=1)
faces = res["face"].to(torch.int32) + rank * per
for merge, fn in (("gather", sharding._gather_merge),
                  ("ring", sharding._ring_merge)):
    doc["merge_%s_ms" % merge] = statistics.median([wall(
        lambda: fn(packed, faces, mesh, "dp"))[1]
        for _ in range(int(inp["reps"]))])
doc["fits"] = {label: {k: r[k] for k in ("losses", "step_ms", "rows",
                                          "restored_at", "resumed_equal")}
               for label, r in fits.items()}

out = {}
for name, val in arrays.items():
    if isinstance(val, np.ndarray):
        out[name] = val
        continue
    for k, a in (val.items() if isinstance(val, dict) else enumerate(val)):
        out["%s.%s" % (name, k)] = np.asarray(a)
for label, r in fits.items():
    for k, a in r["step1"].items():
        out["fit_%s.%s" % (label, k)] = a
if rank:
    doc["digests"] = {k: hashlib.sha256(np.ascontiguousarray(a).tobytes())
                      .hexdigest() for k, a in out.items()
                      if not k.startswith("fit_")}
    out = {k: a for k, a in out.items() if k.startswith("fit_")}
np.savez(os.path.join(folder, "rank%d.npz" % rank), **out)
doc["jax"] = "jax" in sys.modules or "mesh_tpu" in sys.modules
with open(os.path.join(folder, "rank%d.json" % rank), "w") as fh:
    json.dump(doc, fh)
dist.barrier()
dist.destroy_process_group()
"""


def ragged_counts(n, k):
    """Row bounds [k + 1] of ``n`` rows over ``k`` ranks: ragged (weights
    k, k - 1, ..., 1) with rank 1 holding none."""
    weights = np.arange(k, 0, -1, dtype=np.float64)
    weights[1 % k] = 0.0
    counts = np.floor(n * weights / weights.sum()).astype(np.int64)
    counts[0] += n - counts.sum()
    return np.concatenate([[0], np.cumsum(counts)])


def parallel_fit_arrays(model, target, dev):
    """One state to start from, as the converter takes it: the unsharded
    step's state two steps in from small random parameters (moments and a
    count to carry)."""
    from mesh_tpu_torch.parallel import fit

    n_b = target.shape[0]
    rng = np.random.RandomState(21)
    leaves = [torch.as_tensor(rng.randn(*shape) * 0.05, dtype=torch.float32,
                              device=dev).requires_grad_(True)
              for shape in ((n_b, model.num_betas),
                            (n_b, model.num_joints, 3), (n_b, 3))]
    state = fit.FitState(*leaves, opt_state=fit.adam(leaves))
    step = fit.make_fit_step(model, fit.adam, device=dev)
    for _ in range(2):
        state, _ = step(state, target)
    opt = state.opt_state
    out = {"count": np.float32(opt.state[state.betas]["step"])}
    for name in fit.FIT_PARAMS:
        leaf = getattr(state, name)
        out[name] = leaf.detach().cpu().numpy()
        out["mu_" + name] = opt.state[leaf]["exp_avg"].cpu().numpy()
        out["nu_" + name] = opt.state[leaf]["exp_avg_sq"].cpu().numpy()
    return out


def parallel_inputs(model, posed, f_np, verts, verts_v, cams, scan,
                    sphere, dev):
    """Phase 21's inputs (numpy, as the ranks load them) and the parent's
    single-device references."""
    from mesh_tpu_torch.geometry.vert_normals import vert_normals_t
    from mesh_tpu_torch.parallel import fit
    from mesh_tpu_torch.query import closest_kernel as ck
    from mesh_tpu_torch.query.visibility import visibility_compute

    k = PARALLEL_RANKS
    v_s, f_s = sphere
    rng = np.random.RandomState(21)
    sv_t = torch.as_tensor(v_s, device=dev)
    land = surface_queries(sv_t[None], torch.as_tensor(
        f_s.astype(np.int64), device=dev), PARALLEL_LANDMARKS, rng)[0][0]
    f_t = torch.as_tensor(f_np.astype(np.int64), device=dev)
    body_n = vert_normals_t(torch.as_tensor(posed[0], device=dev),
                            f_t).cpu().numpy()
    inp = {"body_v": posed[0], "body_f": f_np, "body_n": body_n,
           "scan": scan, "ragged": ragged_counts(len(scan), k),
           "sphere_v": v_s, "sphere_f": f_s,
           "landmarks": land.cpu().numpy(),
           "cams": cams.cpu().numpy(), "vis_bodies": verts_v.cpu().numpy(),
           "main_bodies": verts.cpu().numpy(),
           "fit_steps": FIT_STEPS, "ckpt_step": PARALLEL_CKPT_STEP,
           "reps": PARALLEL_REPS}
    targets = {"bench_256": (rng.randn(k, 256, 3) * 0.3).astype(np.float32),
               "config5_100k": scan[None]}
    ref = {"fit": {}}
    for label, target in targets.items():
        inp["fit_" + label] = target
        arrays = parallel_fit_arrays(model, torch.as_tensor(
            target, device=dev), dev)
        for key, val in arrays.items():
            inp["fit_%s_%s" % (label, key)] = val
        from mesh_tpu_torch.convert import fit_state_from_arrays

        state = fit_state_from_arrays(
            {n: arrays[n] for n in fit.FIT_PARAMS}, arrays["count"],
            {n: arrays["mu_" + n] for n in fit.FIT_PARAMS},
            {n: arrays["nu_" + n] for n in fit.FIT_PARAMS}, device=dev)
        step = fit.make_fit_step(model, fit.adam, device=dev)
        losses, step_ms = [], []
        target_t = torch.as_tensor(target, device=dev)
        for i in range(FIT_STEPS):
            t0 = time.perf_counter()
            state, loss = step(state, target_t)
            losses.append(float(loss))          # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                first = {n: getattr(state, n).detach().cpu().numpy()
                         for n in fit.FIT_PARAMS}
        ref["fit"][label] = {"losses": losses, "step1": first,
                             "step_ms": statistics.median(step_ms[4:])}
    v_t = torch.as_tensor(posed[0], device=dev)
    nondegen = ck.mesh_is_nondegenerate(posed[0], f_np)
    scan_t = torch.as_tensor(scan, device=dev)
    ref["a"], ref["a_ms"] = timed(lambda: ck.closest_point_kernel(
        v_t, f_t, scan_t, assume_nondegenerate=nondegen))
    ref["a_ms"] = statistics.median(timed(lambda: ck.closest_point_kernel(
        v_t, f_t, scan_t, assume_nondegenerate=nondegen))[1]
        for _ in range(PARALLEL_REPS))
    ref["b"] = ck.closest_point_kernel(
        sv_t, torch.as_tensor(f_s.astype(np.int64), device=dev), land)
    ref["c_vis"] = visibility_compute(posed[0], f_np, inp["cams"],
                                      n=body_n, device=dev)
    normals_v = vert_normals_t(verts_v, f_t).cpu().numpy()
    ref["c_batch_vis"] = [
        visibility_compute(inp["vis_bodies"][b], f_np, inp["cams"],
                           n=normals_v[b], device=dev)
        for b in range(len(normals_v))]
    ref["c_normals"] = vert_normals_t(verts, f_t).cpu().numpy()
    ref = {key: ({n: x.cpu().numpy() for n, x in val.items()}
                 if key in ("a", "b") else val) for key, val in ref.items()}
    return inp, ref


def parallel_backend(device):
    """NCCL when every rank of phase 21 can have a card of its own, else
    gloo with the ranks sharing card 0 (NCCL refuses two ranks on one
    GPU; the collectives then go through the host)."""
    device = torch.device(device)
    if (device.type == "cuda"
            and torch.cuda.device_count() >= PARALLEL_RANKS):
        return "nccl"
    return "gloo"


def run_parallel_world(inp, folder, device):
    """Phase 21's ranks, started together and stopped at their time limit
    -> (each rank's json record, rank 0's arrays, every rank's fit rows)."""
    import socket

    np.savez(os.path.join(folder, "inputs.npz"), **inp)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = str(sock.getsockname()[1])
    sock.close()
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", PARALLEL_RANK, str(r), str(PARALLEL_RANKS),
         port, folder, str(device), parallel_backend(device)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=_REPO) for r in range(PARALLEL_RANKS)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(
                timeout=PARALLEL_CHILD_TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, out) in enumerate(zip(procs, outs)):
        check(proc.returncode == 0, "parallel: rank %d failed (rc %s): %s"
              % (r, proc.returncode, out[-4000:]))
    docs, fits = [], []
    for r in range(PARALLEL_RANKS):
        with open(os.path.join(folder, "rank%d.json" % r)) as fh:
            docs.append(json.load(fh))
        with np.load(os.path.join(folder, "rank%d.npz" % r)) as z:
            arrays = {key: z[key] for key in z.files}
        fits.append({key: a for key, a in arrays.items()
                     if key.startswith("fit_")})
        if r == 0:
            first = arrays
    return docs, first, fits


def _result_of(arrays, name):
    return {key.split(".", 1)[1]: a for key, a in arrays.items()
            if key.split(".", 1)[0] == name}


def same_closest(label, got, want):
    """A closest-point result dict bit for bit against another."""
    for key in ("face", "part", "sqdist", "point"):
        check(np.array_equal(np.asarray(got[key]), np.asarray(want[key]),
                             equal_nan=True),
              "parallel %s: %s differs in %d places" % (
                  label, key, int((np.asarray(got[key])
                                   != np.asarray(want[key])).sum())))


def drive_lane(body_v, f_np, scan, dev):
    """21f in the parent: a warm-up request of the whole scan with the lane
    off, PARALLEL_REPS more timed, PARALLEL_REPS timed with it on
    (MESH_TPU_FLEET_SHARD_MIN_Q), then a small one -> the answers, the
    lane counter's moves and the medians of the timed requests."""
    from mesh_tpu_torch import Mesh, engine
    from mesh_tpu_torch.obs.metrics import REGISTRY

    mesh = Mesh(body_v, f_np, device=dev)
    counter = REGISTRY.counter("mesh_tpu_fleet_shard_dispatches_total")

    def timed():
        t0 = time.perf_counter()
        res = engine.submit("closest_point", mesh, scan).result(timeout=300)
        return res, (time.perf_counter() - t0) * 1e3

    out = {}
    with knobs_set(MESH_TPU_FLEET_SHARD="1"):
        n0 = counter.value()
        out["off"] = engine.submit("closest_point", mesh, scan).result(
            timeout=300)
        runs = [timed() for _ in range(PARALLEL_REPS)]
        out["off_counted"] = counter.value() - n0
        out["off_ms"] = statistics.median(ms for _, ms in runs)
        out["answers"] = [res for res, _ in runs]
        with knobs_set(MESH_TPU_FLEET_SHARD_MIN_Q=PARALLEL_LANE_MIN_Q):
            n0 = counter.value()
            runs = [timed() for _ in range(PARALLEL_REPS)]
            out["on_counted"] = counter.value() - n0
            out["on_ms"] = statistics.median(ms for _, ms in runs)
            out["answers"] += [res for res, _ in runs]
            n0 = counter.value()
            engine.submit("closest_point", mesh,
                          scan[:PARALLEL_LANE_SMALL]).result(timeout=300)
            out["small_counted"] = counter.value() - n0
    return out


def check_parallel(docs, arrays, fits, lane, inp, ref):
    """21a-f against the single-device references -> the phase's record."""
    rec = {"ranks": PARALLEL_RANKS, "backend": docs[0]["backend"],
           "device": docs[0]["device"]}
    check(all(not d["jax"] for d in docs), "parallel: a rank imported jax")
    digests = docs[1]["digests"]
    for d in docs[2:]:
        check(d["digests"] == digests, "parallel: ranks 1 and %d disagree"
              % d["rank"])
    import hashlib

    for key, a in arrays.items():
        if key in digests:
            check(hashlib.sha256(np.ascontiguousarray(a).tobytes())
                  .hexdigest() == digests[key],
                  "parallel: rank 0 and rank 1 disagree on %s" % key)
    same_closest("a (query-sharded)", _result_of(arrays, "a"), ref["a"])
    same_closest("a (multihost)", _result_of(arrays, "a_multihost"),
                 ref["a"])
    for merge in ("gather", "ring"):
        same_closest("b (%s)" % merge, _result_of(arrays, "b_" + merge),
                     ref["b"])
    same_closest("b (gather vs ring)", _result_of(arrays, "b_gather"),
                 _result_of(arrays, "b_ring"))
    vis = _result_of(arrays, "c_vis")
    check(np.array_equal(vis["0"], ref["c_vis"][0])
          and np.array_equal(vis["1"], ref["c_vis"][1]),
          "parallel c: sharded_visibility differs from visibility_compute")
    bvis = _result_of(arrays, "c_batch_vis")
    for b, (want_vis, want_ndc) in enumerate(ref["c_batch_vis"]):
        check(np.array_equal(bvis["0"][b], want_vis)
              and np.array_equal(bvis["1"][b], want_ndc),
              "parallel c: sharded_batched_visibility body %d differs" % b)
    check(np.array_equal(arrays["c_normals"], ref["c_normals"]),
          "parallel c: sharded normals differ from the batched ones")
    rec["visible_share"] = float(vis["0"].mean())
    rec["fit"] = {}
    for label, want in ref["fit"].items():
        runs = [d["fits"][label] for d in docs]
        losses = runs[0]["losses"]
        check(all(r["losses"] == losses for r in runs),
              "parallel d %s: ranks disagree on the loss" % label)
        by_rows = {}
        for fit_rows, r in zip(fits, runs):
            by_rows[tuple(r["rows"])] = fit_rows["fit_%s.betas" % label]
        betas = np.concatenate([by_rows[k] for k in sorted(by_rows)])
        loss_gap = abs(losses[0] - want["losses"][0])
        betas_gap = float(np.abs(betas - want["step1"]["betas"]).max())
        check(loss_gap <= PARALLEL_FIT_TOL and betas_gap <= PARALLEL_FIT_TOL,
              "parallel d %s: step 1 loss gap %.3g, betas gap %.3g against "
              "the unsharded step" % (label, loss_gap, betas_gap))
        check(losses[-1] < losses[0], "parallel d %s: the loss did not "
              "fall: %s" % (label, losses))
        check(all(r["restored_at"] == PARALLEL_CKPT_STEP
                  and r["resumed_equal"] for r in runs),
              "parallel e %s: the resumed step differs from the live one"
              % label)
        rec["fit"][label] = {
            "loss_first": losses[0], "loss_last": losses[-1],
            "loss_gap": loss_gap, "betas_gap": betas_gap,
            "step_ms_sharded": max(statistics.median(r["step_ms"][4:])
                                   for r in runs),
            "step_ms_unsharded": want["step_ms"]}
    check(lane["off_counted"] == 0 and lane["on_counted"] == PARALLEL_REPS
          and lane["small_counted"] == 0,
          "parallel f: the lane counted %d off, %d on (of %d requests), %d "
          "small" % (lane["off_counted"], lane["on_counted"], PARALLEL_REPS,
                     lane["small_counted"]))
    for answer in lane["answers"]:
        for a, b in zip(lane["off"], answer):
            check(np.array_equal(a, b), "parallel f: a request's answer "
                  "differs from the first lane-off answer")
    rec["lane_ms"] = lane["on_ms"]
    rec["lane_off_ms"] = lane["off_ms"]
    rec["times_ms"] = {
        "a_sharded_wall": max(d["a_ms"] for d in docs),
        "a_single_device": ref["a_ms"],
        "kernel_per_rank": [d["kernel_ms"] for d in docs],
        "merge_gather": max(d["merge_gather_ms"] for d in docs),
        "merge_ring": max(d["merge_ring_ms"] for d in docs)}
    rec["window_s"] = max(d["window_s"] for d in docs)
    return rec


def drive_parallel_phase(inp, ref, dev, smi):
    """Phase 21 -> (its record, launches on its counted windows: every
    rank's and the parent's lane, summed)."""
    import shutil

    folder = os.path.join(_REPO, "build", "chip_smoke_parallel")
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    backend = parallel_backend(dev)
    log("== parallel: a world of %d ranks, backend %s (%s; on %s): config "
        "5's %d scan points query-sharded and multihost, %d landmarks "
        "face-sharded against %d faces, visibility and normals, the sharded "
        "fit at bench_256 and config5_100k with a checkpoint, then the "
        "engine's lane" % (
            PARALLEL_RANKS, backend,
            "a card a rank" if backend == "nccl" else
            "every rank on card 0, the collectives staged through the host",
            smi, len(inp["scan"]), PARALLEL_LANDMARKS,
            len(inp["sphere_f"])))
    t_phase = time.perf_counter()
    try:
        docs, arrays, fits = run_parallel_world(inp, folder, dev)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    reset_launches()
    lane = drive_lane(inp["body_v"], inp["body_f"], inp["scan"], dev)
    launches = read_launches()
    for d in docs:
        for name, n in d["launches"].items():
            launches[name] += n
    needed = {k for k, paths in KERNEL_PATHS.items() if "parallel" in paths}
    for name in sorted(needed):
        check(launches[name] > 0, "kernel %s never launched on the parallel "
              "path" % name)
    counted_only(launches, needed, "the parallel path")
    rec = check_parallel(docs, arrays, fits, lane, inp, ref)
    rec["launches"] = {k: n for k, n in launches.items() if n}
    rec["launches_by_rank"] = [d["launches"] for d in docs]
    rec["phase_s"] = time.perf_counter() - t_phase
    check(rec["phase_s"] <= PARALLEL_BUDGET_S, "parallel: %.1f s, budget "
          "%.0f s" % (rec["phase_s"], PARALLEL_BUDGET_S))
    t = rec["times_ms"]
    log("  backend %s, %d ranks on %s (%s)" % (
        rec["backend"], PARALLEL_RANKS, rec["device"], smi))
    log("  a: query-sharded wall %.3f ms against the single-device kernel "
        "call's %.3f ms; each rank's kernel on its shard %s ms" % (
            t["a_sharded_wall"], t["a_single_device"],
            ["%.3f" % x for x in t["kernel_per_rank"]]))
    log("  f: the engine's %d-query request, median of %d: lane on %.3f ms, "
        "lane off %.3f ms (host clock)" % (
            len(inp["scan"]), PARALLEL_REPS, rec["lane_ms"],
            rec["lane_off_ms"]))
    log("  b: merge gather %.3f ms, ring %.3f ms (host clock)"
        % (t["merge_gather"], t["merge_ring"]))
    for label, r in rec["fit"].items():
        log("  d: %s step 1 loss gap %.3g, betas gap %.3g; loss %.6g -> "
            "%.6g; a step %.3f ms sharded, %.3f ms unsharded (host clock)"
            % (label, r["loss_gap"], r["betas_gap"], r["loss_first"],
               r["loss_last"], r["step_ms_sharded"], r["step_ms_unsharded"]))
    log("  launches on the windows %s (by rank %s); phase %.1f s (budget "
        "%.0f s)" % (rec["launches"], rec["launches_by_rank"],
                     rec["phase_s"], PARALLEL_BUDGET_S))
    log("parallel record (on %s): %s" % (smi, json.dumps(rec, default=str)))
    return rec, launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1

    from mesh_tpu_torch import Mesh, _build
    from mesh_tpu_torch.accel import rope_kernel as rk
    from mesh_tpu_torch.accel.build import build_bvh, clear_index_cache
    from mesh_tpu_torch.accel.traverse import (
        RESIDENT_TILE_F as ANIM_LEAF,
        pallas_bvh_variant,
    )
    from mesh_tpu_torch.batch import batch_step, visibility_step
    from mesh_tpu_torch.geometry.cross_product import cross3
    from mesh_tpu_torch.geometry.vert_normals import vert_normals_t
    from mesh_tpu_torch.models import lbs, synthetic_body_model
    from mesh_tpu_torch.query import closest_kernel as ck
    from mesh_tpu_torch.query import culled as auto
    from mesh_tpu_torch.query import culled_kernel as qk
    from mesh_tpu_torch.query import mxu_kernel as mk
    from mesh_tpu_torch.query import normal_weighted as nw
    from mesh_tpu_torch.query import ray_kernel as ray
    from mesh_tpu_torch.query import tri_tri_kernel as tk
    from mesh_tpu_torch.query import visibility as vis
    from mesh_tpu_torch.query.autotune import (
        _sphere_mesh,
        calibrate_mxu_crossover,
        MXU_CALIBRATION,
        stream_tile_params,
    )
    from mesh_tpu_torch.query.closest_point import closest_faces_and_points_t
    from mesh_tpu_torch.query.visibility import visibility_rays
    from mesh_tpu_torch.obs import install_torch_monitoring_bridge
    from mesh_tpu_torch.utils.dispatch import force_xla

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()

    # -- 1. probe ---------------------------------------------------------
    log("== probe")
    log("python", sys.version.split()[0], "torch", torch.__version__,
        "cuda", torch.version.cuda, "devices", torch.cuda.device_count())
    log("card:", smi)
    # the torch.monitor bridge before the build: phase 20 reads one
    # kernel-cache event per library off the registry
    install_torch_monitoring_bridge()
    t0 = time.perf_counter()
    report = _build.build(verbose=True)
    build_s = time.perf_counter() - t0
    bridge = bridge_counts()
    log("kernel cache (torch.monitor bridge): %s" % bridge)
    for name, info in report.items():
        log("built %s in %.1f s" % (name, info["seconds"]))
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())
    log("kernel build: %.1f s (all sources in parallel)" % build_s)

    # -- inputs (bench.py's north-star workload) ----------------------------
    model = synthetic_body_model(seed=0, device=dev)
    f = model.faces
    f_np = f.cpu().numpy()
    rng = np.random.RandomState(0)
    betas = torch.as_tensor(rng.randn(BATCH, model.num_betas) * 0.3,
                            dtype=torch.float32, device=dev)
    pose = torch.as_tensor(rng.randn(BATCH, model.num_joints, 3) * 0.1,
                           dtype=torch.float32, device=dev)
    queries = torch.as_tensor(rng.randn(BATCH, QUERIES_PER_MESH, 3) * 0.4,
                              dtype=torch.float32, device=dev)
    verts, _ = lbs(model, betas, pose, device=dev)
    posed = verts.cpu().numpy()
    q1 = torch.as_tensor(rng.randn(1, FACADE_QUERIES, 3) * 0.4,
                         dtype=torch.float32, device=dev)
    q1_np = q1[0].cpu().numpy()
    nondegen = ck.mesh_is_nondegenerate(posed, f_np)
    main_variant = ("fast", not nondegen)
    log("posed batch %s nondegenerate: %s -> main path runs closest_faces"
        "[%s, tail=%s]" % (tuple(verts.shape), nondegen, *main_variant))

    # -- inputs of the large-mesh drives (phases 5 and 6) --------------------
    t0 = time.perf_counter()
    model_l, betas_l, pose_l, verts_l, queries_l = large_batch_inputs(dev)
    f_l = model_l.faces
    nondegen_l = ck.mesh_is_nondegenerate(verts_l.cpu().numpy(),
                                          f_l.cpu().numpy())
    variant_l = ("fast", not nondegen_l)
    v_s, f_s, p_s = scan_inputs()
    n_buffers = stream_tile_params()[2]
    log("large batch %s (%d faces) nondegenerate: %s -> culled_faces[%s, "
        "tail=%s]; scan mesh %d faces, %d queries; inputs %.1f s"
        % (tuple(verts_l.shape), f_l.shape[0], nondegen_l, *variant_l,
           f_s.shape[0], SCAN_QUERIES, time.perf_counter() - t0))

    # -- inputs of the visibility and registration drives (phases 7 and 8) --
    cams = torch.tensor(VIS_CAMERAS, dtype=torch.float32, device=dev)
    betas_v, pose_v = betas[:VIS_BATCH], pose[:VIS_BATCH]
    verts_v = verts[:VIS_BATCH]
    reg_pts, reg_nrm = registration_inputs(verts[0], f,
                                           np.random.RandomState(1))
    nondegen_r = ck.mesh_is_nondegenerate(posed[0], f_np)
    log("visibility: %d bodies x %d cameras; registration: body 0, %d "
        "queries, nondegenerate %s -> normal_weighted_faces[tail=%s]"
        % (VIS_BATCH, len(VIS_CAMERAS), REG_QUERIES, nondegen_r,
           not nondegen_r))

    # -- inputs of the contact and self-intersection drives (9 and 10) ------
    body_v, body_f, hand_v, hand_f = contact_inputs(dev)
    contact_tile = tk.ALGORITHMS[int(
        ck.mesh_is_nondegenerate(body_v, body_f)
        and ck.mesh_is_nondegenerate(hand_v, hand_f))]
    # float32, as the facade hands them to the kernels (hand_v is float64
    # after the offset, as in the example)
    hand_tri = torch.as_tensor(hand_v.astype(np.float32), device=dev)[
        torch.as_tensor(hand_f.astype(np.int64), device=dev)]
    body_tri = torch.as_tensor(body_v, device=dev)[
        torch.as_tensor(body_f.astype(np.int64), device=dev)]
    self_bodies = {
        "smpl_body0": (posed[0], f_np, model.v_template.cpu().numpy()),
        "large_body0": (verts_l[0].cpu().numpy(), f_l.cpu().numpy(),
                        model_l.v_template.cpu().numpy())}
    self_tiles = {k: tk.ALGORITHMS[int(ck.mesh_is_nondegenerate(v, f_))]
                  for k, (v, f_, _) in self_bodies.items()}
    log("contact: hand %d faces vs body %d faces -> tri_tri_any_hit[%s]; "
        "self-intersection tiles %s" % (hand_f.shape[0], body_f.shape[0],
                                        contact_tile, self_tiles))

    # -- inputs of the avatar sessions (phase 11) ----------------------------
    anim_models = {"smpl": (model, 11), "large": (model_l, 12)}
    anim_keys = {}
    for label, (m_, seed) in anim_models.items():
        check(pallas_bvh_variant(m_.faces.shape[0]) == "resident",
              "anim %s: %d faces do not take the resident walk"
              % (label, m_.faces.shape[0]))
        anim_keys[label] = (anim_stream(m_, dev, seed)[0],
                            m_.faces.cpu().numpy())
    log("anim: sessions of %s faces at leaf %d (the resident walk's tile_f), "
        "%d frames of %d queries each" % (
            [int(m_.faces.shape[0]) for m_, _ in anim_models.values()],
            ANIM_LEAF, ANIM_FRAMES, ANIM_QUERIES))

    # -- inputs of the MXU drive (phase 12) ----------------------------------
    v_m, f_m = _sphere_mesh(MXU_SPHERE_FACES)
    rng_m = np.random.RandomState(12)
    mxu_cases = [
        ("body0", posed[0], f_np, q1_np),
        ("sphere_surface", v_m, f_m, surface_patches(MXU_QUERIES, rng_m)),
        ("sphere_randn", v_m, f_m,
         (rng_m.randn(MXU_QUERIES, 3) * 0.4).astype(np.float32))]
    mxu_tails = {label: not ck.mesh_is_nondegenerate(v_, f_)
                 for label, v_, f_, _ in mxu_cases}
    log("mxu: %s faces, %s queries; degenerate tail %s" % (
        [c[2].shape[0] for c in mxu_cases], [c[3].shape[0] for c in mxu_cases],
        mxu_tails))

    if force_xla():
        # the knob held for the whole run: phases 2-15 and 16e check the
        # kernel route and are left out; phase 16 holds the XLA forms
        # against the kernels, which it calls by name
        log("MESH_TPU_FORCE_XLA is set: phase 16 alone (without 16e)")
        drive_fallback(fallback_inputs(
            posed, f_np, q1_np, queries, reg_pts, reg_nrm, verts_l, f_l,
            queries_l, (v_s, f_s, p_s), (body_v, body_f, hand_v, hand_f)),
            dev, smi, calibrate=False)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": card,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # -- 2. kernels vs plain on the card -------------------------------------
    log("== kernels vs plain")
    face_runs = []
    for variant, tail in VARIANTS:
        pts, planes, tri, center = ck.closest_point_operands(
            verts, f, queries, variant)
        face_runs.append(compare_faces(ck, pts, planes, tri, center,
                                       variant, tail, timing=True))
        del pts, planes, tri, center
    # the fused reduction at the main path's shapes, and on one body with
    # planted NaN
    fused_runs = []
    for variant, tail in VARIANTS:
        pts, planes, tri, center = ck.closest_point_operands(
            verts, f, queries, variant)
        fused_runs.append(compare_faces(ck, pts, planes, tri, center,
                                        variant, tail, timing=True,
                                        reduction="fused"))
        del pts, planes, tri, center
    body = verts[:1]
    face_sets = []
    for variant, tail in VARIANTS:
        ops = ck.closest_point_operands(body, f, q1, variant)
        face_sets.append(dict(compare_faces(ck, *ops, variant, tail,
                                            timing=False), on="facade"))
        fused_runs.append(compare_fused_nan(ck, body, f, q1, variant, tail))
    # the far-query set: 10-100x the body's radius
    q_far = far_queries(body[0], FACADE_QUERIES, np.random.RandomState(14))
    for variant, tail in VARIANTS:
        ops = ck.closest_point_operands(body, f, q_far, variant)
        for reduction in ("exact", "fused"):
            face_sets.append(dict(compare_faces(
                ck, *ops, variant, tail, timing=False, reduction=reduction),
                on="far", reduction=reduction))
    v2, f2, q2 = planted_degenerate(posed[0], f_np, rng)
    check(not ck.mesh_is_nondegenerate(v2, f2),
          "the planted mesh must fail the nondegeneracy check")
    v2t = torch.as_tensor(v2, device=dev)[None]
    f2t = torch.as_tensor(f2, device=dev)
    q2t = torch.as_tensor(q2, device=dev)[None]
    oracle = closest_faces_and_points_t(v2t[0], f2t, q2t[0])
    for variant in ("fast", "safe"):
        ops = ck.closest_point_operands(v2t, f2t, q2t, variant)
        face_sets.append(dict(compare_faces(ck, *ops, variant, True,
                                            timing=False), on="planted"))
        res = ck.closest_point_kernel(v2t, f2t, q2t, tile_variant=variant)
        gap = float((res["sqdist"][0] - oracle["sqdist"]).abs().max())
        check(gap <= 1e-5, "planted mesh, %s tile: sqdist %.3g from the "
              "reconstruction-form scan" % (variant, gap))
        log("  planted degenerate mesh (%d faces), %s tile with tail: "
            "sqdist within %.3g of the reconstruction-form scan"
            % (f2.shape[0], variant, gap))

    vmean = verts.mean(dim=-2, keepdim=True)
    vplanes = (verts - vmean).transpose(-1, -2).contiguous()
    vert_batch = compare_vertices(ck, (queries - vmean).contiguous(),
                                  vplanes, "the main path's batch",
                                  timing=True, splits=(1,))
    b0mean = verts[:1].mean(dim=-2, keepdim=True)
    vert_facade = compare_vertices(
        ck, (q1 - b0mean).contiguous(),
        (verts[:1] - b0mean).transpose(-1, -2).contiguous(), "body 0",
        timing=True, splits=tuple(range(1, ck.VERTEX_MAX_SPLIT + 1)))
    vert_far = compare_vertices(
        ck, (far_queries(verts[0], FACADE_QUERIES,
                         np.random.RandomState(13)) - b0mean).contiguous(),
        (verts[:1] - b0mean).transpose(-1, -2).contiguous(),
        "body 0, far queries")
    vert_planted = vertex_planted(ck, verts[0])
    del vplanes

    # culled_faces at phase 5's shapes (every query tile of all 64 bodies)
    culled_runs = []
    for variant, tail in VARIANTS:
        n_b = (LARGE_BATCH if (variant, tail) == variant_l
               else CULLED_CHECK_BODIES)
        ops_l = qk.culled_operands(verts_l[:n_b], f_l, queries_l[:n_b],
                                   variant)
        culled_runs.append(compare_culled(qk, ops_l, variant, tail,
                                          timing=(variant, tail) == variant_l))
        del ops_l
    # both rope_faces entries at phase 6's shapes (every query tile), each
    # at every sub-lane count
    ops_s = rk.rope_operands(v_s, f_s, p_s, device=dev, records=True)
    rope_stream, (sd, si, sl) = compare_rope(rk, ops_s, n_buffers)
    rope_resident, (rd, ri, rl) = compare_rope(rk, ops_s, None)
    check(torch.equal(si, ri) and torch.equal(sd, rd)
          and bool((sl >= rl).all()), "rope_faces: the streamed entry is not "
          "bit-identical to the resident one, or tests fewer leaves")
    log("  rope_faces: streamed and resident entries bit-identical; %d vs "
        "%d leaves tested" % (int(sl.sum()), int(rl.sum())))
    # the resident entry's scalar staging: a leaf size that is no multiple
    # of 4 (body 0, phase 4's queries)
    compare_rope(rk, rk.rope_operands(posed[0], f_np, q1_np, tile_q=64,
                                      tile_f=RESIDENT_ODD_TILE_F, device=dev),
                 None, label="body 0, leaf %d" % RESIDENT_ODD_TILE_F, reps=1)
    # both rope_mxu_faces entries, f32 and bf16, on phase 6's scan (timed)
    # and on a mixed-radius set on its sphere, where the screen must skip
    # visits
    rope_mxu_runs = {}
    for label, q_m in (("scan", p_s),
                       ("mixed", mixed_queries(np.random.RandomState(13)))):
        ops_m = rk.rope_operands(v_s, f_s, q_m, device=dev, mxu=True)
        outs = {}
        for walk, nb in (("stream", n_buffers), ("resident", None)):
            for use_bf16 in (False, True):
                run, outs[walk, use_bf16] = compare_rope_mxu(
                    rk, ops_m, nb, use_bf16, label, timing=label == "scan")
                rope_mxu_runs[label, walk, use_bf16] = run
        kd, ki, _, _ = outs["resident", False]
        check(all(torch.equal(o[0], kd) and torch.equal(o[1], ki)
                  for o in outs.values()), "rope_mxu_faces on %s: the four "
              "walks are not bit-identical" % label)
        check(all(torch.equal(outs[w, True][2], outs[w, False][2])
                  and torch.equal(outs[w, False][3], outs[w, False][2])
                  for w in ("stream", "resident"))
              and bool((outs["stream", False][2]
                        >= outs["resident", False][2]).all()),
              "rope_mxu_faces on %s: leaf or visit counts out of order"
              % label)
        skipped = {w: int(outs[w, False][3].sum() - outs[w, True][3].sum())
                   for w in ("stream", "resident")}
        if label == "mixed":
            check(min(skipped.values()) > 0, "rope_mxu_faces on %s: the "
                  "bf16 screen skipped %s visits" % (label, skipped))
        log("  rope_mxu_faces on %s: the four walks bit-identical; the bf16 "
            "screen skips %s full visits" % (label, skipped))
        del ops_m, outs
    # ray_any_hit and ray_any_hit_culled at phase 7's shapes: every ray of
    # every body and camera, the culled kernel on each body's vertices in
    # Morton order as visibility_local sorts them; then the planted sets
    origins_v, dirs_v = visibility_rays(verts_v, cams, VIS_MIN_DIST)
    tri_v = verts_v[..., f.long(), :]
    any_hit_run, dense_v = compare_any_hit(
        ray, origins_v, dirs_v.reshape(origins_v.shape).contiguous(),
        ray.ray_planes(tri_v))
    order_v = vis.vertex_order(verts_v)
    culled_hit_run = compare_any_hit_culled(
        ray, vis, ray.any_hit_operands(
            *vis.sort_rays(origins_v, dirs_v, order_v), tri_v),
        dense_v, "phase 7's rays", order=order_v, timing=True)
    culled_planted = [compare_any_hit_culled(ray, vis, ops_p, dense_p, label,
                                             t_lo, t_hi)
                      for label, ops_p, t_lo, t_hi, dense_p in any_hit_planted(
                          ray, vis, model.v_template, f, dev)]
    check(culled_planted[0]["blocked_share"] > 0, "no grazing ray is blocked")
    del origins_v, dirs_v, tri_v, dense_v, order_v
    # alongnormal_faces and normal_weighted_faces at phase 8's shapes
    along_run = compare_alongnormal(ray, reg_pts[None], reg_nrm[None],
                                    verts[:1][..., f.long(), :],
                                    timing=True)
    along_runs = [along_run] + along_planted(
        ray, verts[0], f, reg_pts, reg_nrm, v2t, f2t, q2t,
        np.random.RandomState(19))
    nw_ops = nw.normal_weighted_operands(verts[:1], f, reg_pts[None],
                                         reg_nrm[None])
    nw_runs = [compare_normal_weighted(nw, ck, nw_ops, tail, timing=True)
               for tail in (False, True)]
    del nw_ops
    n2 = rng.randn(1, q2.shape[0], 3)
    n2t = torch.as_tensor(n2 / np.linalg.norm(n2, axis=-1, keepdims=True),
                          dtype=torch.float32, device=dev)
    nw_runs.append(compare_normal_weighted(
        nw, ck, nw.normal_weighted_operands(v2t, f2t, q2t, n2t), True,
        timing=False, label="planted degenerate"))
    nw_runs += normal_weighted_planted(nw, ck, verts[0], f, reg_pts, reg_nrm,
                                       not nondegen_r,
                                       np.random.RandomState(17))
    # tri_tri_any_hit at phase 9's shapes in both tiles, the Moller tile's
    # cull also on the planted sets, and the segment tile with the planted
    # mesh's faces as the queries against body 0
    tri_runs = {alg: compare_tri_tri(tk, *tk.tri_tri_planes(
        hand_tri, body_tri, alg), alg, "hand vs body", timing=True)
        for alg in tk.ALGORITHMS}
    for label, qp_, fp_ in tri_planted(tk, *tk.moller_planes(
            hand_tri, body_tri), np.random.RandomState(23)):
        tri_runs["moller_" + label] = compare_tri_tri(
            tk, qp_, fp_, "moller", label, timing=False)
    tri_runs["segment_planted"] = compare_tri_tri(
        tk, *tk.segment_planes(v2t[0][f2t.long()], verts[0][f.long()]),
        "segment", "planted mesh vs body 0", timing=False)
    # self_intersect on every face of phase 3's and phase 5's body 0 and of
    # their rest templates, both tiles
    self_runs, self_counts = {}, {}
    for key, (v_np, f_np_, rest_np) in self_bodies.items():
        ids_b = torch.as_tensor(f_np_.astype(np.int32), device=dev)
        for label, verts_np in ((key, v_np),
                                (key.replace("body0", "rest"), rest_np)):
            tri_b = torch.as_tensor(verts_np, device=dev)[
                torch.as_tensor(f_np_.astype(np.int64), device=dev)]
            for alg in tk.ALGORITHMS:
                run, self_counts[label, alg] = compare_self(
                    tk, tri_b, ids_b, alg, label, plain_range=(
                        key == "large_body0" and alg != self_tiles[key]))
                self_runs["%s[%s]" % (label, alg)] = run
            del tri_b
        del ids_b
    # leaf_boxes at phase 11's shapes (both keyframes at the walk's leaf
    # size), the large keyframe at leaf 8, the scan at leaves 256 and 8, a
    # copy with planted NaN corners and one with corners at +-0.0
    leaf_runs = []
    operands = {}
    for label, (v_np, f_np_), leaf in (
            ("smpl keyframe", anim_keys["smpl"], ANIM_LEAF),
            ("large keyframe", anim_keys["large"], ANIM_LEAF),
            ("large keyframe", anim_keys["large"], 8),
            ("scan", (v_s, f_s), ANIM_LEAF), ("scan", (v_s, f_s), 8)):
        index = build_bvh(v_np, f_np_, leaf_size=leaf)
        n_lv = int(index.meta["n_leaves"])
        operands[label, leaf] = (refit_tri_s(v_np, f_np_, index, dev), n_lv)
        leaf_runs.append(compare_leaf_boxes(
            *operands[label, leaf], leaf, "%s, leaf %d" % (label, leaf),
            timing=label == "large keyframe"))
    planted_t, n_lv = operands["large keyframe", 8]
    planted_t = planted_t.clone()
    nan_leaves = [0, n_lv // 2 + 3, n_lv - 1]
    for axis, leaf_id in enumerate(nan_leaves):
        planted_t[leaf_id * 8 + axis, (axis + 1) % 3, axis] = float("nan")
    leaf_runs.append(compare_leaf_boxes(
        planted_t, n_lv, 8, "large keyframe with NaN corners, leaf 8",
        nan_leaves=nan_leaves))
    zeros_t, n_lv = operands["large keyframe", ANIM_LEAF]
    zeros_t = zeros_t.clone()
    zeros_t[:ANIM_LEAF, :, 0] = -0.0
    zeros_t[:ANIM_LEAF // 2, :, 0] = 0.0
    band = zeros_t[ANIM_LEAF:2 * ANIM_LEAF, :, 2]
    zeros_t[ANIM_LEAF:2 * ANIM_LEAF, :, 2] = torch.where(
        band > 0, torch.zeros_like(band), -torch.zeros_like(band))
    leaf_runs.append(compare_leaf_boxes(
        zeros_t, n_lv, ANIM_LEAF, "large keyframe with +-0.0 corners, leaf "
        "256", nan_leaves=[]))
    # the corner items: leaf sizes that are no multiple of 4, and tri_s
    # views 4 bytes past a 16-byte boundary
    for label, (v_np, f_np_), leaf in (
            ("large keyframe", anim_keys["large"], 5),
            ("smpl keyframe", anim_keys["smpl"], 3)):
        index = build_bvh(v_np, f_np_, leaf_size=leaf)
        leaf_runs.append(compare_leaf_boxes(
            refit_tri_s(v_np, f_np_, index, dev),
            int(index.meta["n_leaves"]), leaf,
            "%s, leaf %d" % (label, leaf)))
    for leaf in (ANIM_LEAF, 8):
        tri_s, n_lv = operands["large keyframe", leaf]
        buf = torch.empty(tri_s.numel() + 1, dtype=torch.float32,
                          device=dev)
        view = buf[1:].view(tri_s.shape)
        view.copy_(tri_s)
        check(view.data_ptr() % 16 == 4, "the misaligned view is aligned")
        leaf_runs.append(compare_leaf_boxes(
            view, n_lv, leaf,
            "large keyframe 4 bytes off 16, leaf %d" % leaf,
            timing=leaf == ANIM_LEAF))
    del operands, planted_t, zeros_t, buf, view
    # a launch that does no work: the floor under both rows' times
    empty_launch = {
        "queued_ms": queued_ms(lambda: torch.cuda._sleep(0), 100),
        "event_ms": cold_ms(lambda: torch.cuda._sleep(0), 100)}
    log("  an empty launch (torch.cuda._sleep(0)): %.4f ms back to back, "
        "%.4f ms between events after an L2 flush"
        % (empty_launch["queued_ms"], empty_launch["event_ms"]))
    # the three MXU kernels at phase 12's shapes, with and without the
    # degenerate tail (timed in the drive's own variant), and the tail on
    # the planted mesh
    mxu_runs = []
    for label, v_np, f_np_, q_np in mxu_cases:
        for tail in (False, True):
            mxu_runs.append(compare_mxu(
                mk, ck, label, torch.as_tensor(v_np, device=dev),
                torch.as_tensor(f_np_, device=dev),
                torch.as_tensor(q_np, device=dev), tail,
                timing=tail == mxu_tails[label]))
    mxu_runs.append(compare_mxu(mk, ck, "planted", v2t[0], f2t, q2t[0], True,
                                timing=False))
    for tail in (False, True):
        mxu_runs.append(compare_mxu(mk, ck, "far", body[0], f, q_far[0],
                                    tail, timing=False))
    compare_bound_planted(mk, body[0], f, q_far[0])

    # -- 3. main path at full width ------------------------------------------
    card_state = {"after_phase_2": nvidia_smi(CARD_STATE)}
    log("card state after phase 2 (%s): %s" % (CARD_STATE,
                                              card_state["after_phase_2"]))
    log("== main path: %d bodies x %d queries, %d faces each"
        % (BATCH, QUERIES_PER_MESH, f.shape[0]))
    reset_launches()

    def step():
        v, _ = lbs(model, betas, pose, device=dev)
        normals, res = batch_step(v, f, queries,
                                  assume_nondegenerate=nondegen,
                                  tile_variant=main_variant[0])
        checksum = (normals.sum() + res["point"].sum() + res["sqdist"].sum()
                    + res["face"].sum().to(torch.float32))
        return normals, res, checksum

    normals, res, checksum = step()         # warm-up
    float(checksum)
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        normals, res, checksum = step()
        end.record()
        float(checksum)
        times.append(start.elapsed_time(end))
    step_ms = statistics.median(times)
    launches = {"main_path": read_launches()}
    check(tuple(res["face"].shape) == (BATCH, QUERIES_PER_MESH)
          and res["face"].dtype == torch.int32, "face shape/dtype")
    check(tuple(res["point"].shape) == (BATCH, QUERIES_PER_MESH, 3),
          "point shape")
    check(tuple(normals.shape) == tuple(verts.shape), "normals shape")
    for name, t in (("normals", normals), ("point", res["point"]),
                    ("sqdist", res["sqdist"])):
        check(bool(torch.isfinite(t).all()), name + " not finite")
    check(bool(((res["face"] >= 0) & (res["face"] < f.shape[0])).all()),
          "face index out of range")
    # the same batch through the plain version: a sub-batch would center
    # with another reduction order on the card and move near-ties
    v_step, _ = lbs(model, betas, pose, device=dev)
    plain = ck.closest_point_plain(v_step, f, queries,
                                   assume_nondegenerate=nondegen,
                                   tile_variant=main_variant[0])
    check(bool((plain["face"] == res["face"]).all()),
          "main path faces differ from the plain version")
    oracle = closest_faces_and_points_t(v_step[0], f, queries[0, :256])
    gap = float((oracle["sqdist"] - res["sqdist"][0, :256]).abs().max())
    check(gap <= 1e-5, "main path sqdist %.3g from the reconstruction-form "
          "scan" % gap)
    unit = (normals * normals).sum(-1)
    check(bool(((unit - 1).abs() < 1e-5).all()), "normals not unit length")
    log("all %d meshes match the plain version; mesh 0 sqdist within %.3g "
        "of the reconstruction-form scan" % (BATCH, gap))

    n_queries = BATCH * QUERIES_PER_MESH
    log("main path step: median %.3f ms over %d reps (min %.3f, max %.3f), "
        "%.0f queries/s, checksum %.6g, on %s"
        % (step_ms, REPS, min(times), max(times),
           n_queries / (step_ms / 1e3), float(checksum), smi))

    # -- 3b. main path with the fused reduction -------------------------------
    log("== main_path_fused: %d bodies x %d queries, lbs -> normals -> "
        "closest_point_kernel(reduction='fused', tile_f=%d)"
        % (BATCH, QUERIES_PER_MESH, ck.FUSED_TILE_F))
    reset_launches()

    def step_fused():
        v, _ = lbs(model, betas, pose, device=dev)
        normals = vert_normals_t(v, f)
        res = ck.closest_point_kernel(
            v, f, queries, assume_nondegenerate=nondegen,
            tile_variant=main_variant[0], reduction="fused")
        checksum = (normals.sum() + res["point"].sum() + res["sqdist"].sum()
                    + res["face"].sum().to(torch.float32))
        return normals, res, checksum

    _, res_fused, checksum_fused = step_fused()         # warm-up
    float(checksum_fused)
    times_fused = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        normals_fused, res_fused, checksum_fused = step_fused()
        end.record()
        float(checksum_fused)
        times_fused.append(start.elapsed_time(end))
    step_fused_ms = statistics.median(times_fused)
    launches["main_path_fused"] = read_launches()
    check(tuple(res_fused["face"].shape) == (BATCH, QUERIES_PER_MESH)
          and res_fused["face"].dtype == torch.int32
          and tuple(normals_fused.shape) == tuple(verts.shape),
          "main_path_fused shapes/dtypes")
    for name, t in (("point", res_fused["point"]),
                    ("sqdist", res_fused["sqdist"])):
        check(bool(torch.isfinite(t).all()), "main_path_fused %s not finite"
              % name)
    radius = 2.0 ** -(23 - int(np.log2(ck.FUSED_TILE_F)))
    sq_f = res_fused["sqdist"].double()
    sq_e = res["sqdist"].double()
    check(bool((sq_f <= sq_e * (1 + 4 * radius) + 1e-12).all()),
          "main_path_fused: a winner %.3g above the exact one, past the tie "
          "radius %.3g" % (float(((sq_f - sq_e) / sq_e.clamp_min(1e-30))
                                 .max()), radius))
    fused_same = float((res_fused["face"] == res["face"]).double().mean())
    log("main_path_fused step: median %.3f ms over %d reps (min %.3f, max "
        "%.3f); faces equal to phase 3's for %.4f of the queries, every "
        "winner within (1 + 4 x %.3g) of the exact sqdist, on %s"
        % (step_fused_ms, REPS, min(times_fused), max(times_fused),
           fused_same, radius, smi))

    # -- 4. facade ---------------------------------------------------------
    log("== facade: Mesh on one body, %d queries" % FACADE_QUERIES)
    q_np = q1[0].cpu().numpy()
    reset_launches()
    m = Mesh(posed[0], f_np, device=dev)
    faces_f, points_f = m.closest_faces_and_points(q_np)
    check(faces_f.dtype == np.uint32 and faces_f.shape == (1, FACADE_QUERIES),
          "facade faces dtype/shape %s %s" % (faces_f.dtype, faces_f.shape))
    check(points_f.dtype == np.float64
          and points_f.shape == (FACADE_QUERIES, 3), "facade points")
    check_facade_against_scan(verts[0], f, q1[0], faces_f, points_f)
    vn = m.estimate_vertex_normals()
    check(vn.dtype == np.float64 and vn.shape == posed[0].shape,
          "facade normals")
    vidx, vdist = m.closest_vertices(q_np)
    check(vidx.shape == (FACADE_QUERIES,) and vdist.dtype == np.float64,
          "facade closest_vertices")
    vc = posed[0].astype(np.float64)
    d_all = ((q_np[:, None, :].astype(np.float64) - vc[None]) ** 2).sum(-1)
    gap = np.abs(np.sqrt(d_all.min(1)) - vdist).max()
    check(gap <= 1e-5, "closest_vertices %.3g from the float64 brute force"
          % gap)
    n2, faces2, points2 = m.normals_and_closest_points(q_np)
    check(np.array_equal(faces2, faces_f)
          and np.allclose(points2, points_f, atol=1e-6)
          and np.allclose(n2, vn, atol=1e-6), "fused facade disagrees")
    launches["facade"] = read_launches()
    log("facade ok")

    # -- 5. large batch: batch_step through the culled kernel --------------
    log("== large batch: %d bodies x %d queries, %d faces each"
        % (LARGE_BATCH, LARGE_QUERIES, f_l.shape[0]))
    reset_launches()
    auto.STRATEGY.clear()

    def step_l():
        v, _ = lbs(model_l, betas_l, pose_l, device=dev)
        normals, res = batch_step(v, f_l, queries_l,
                                  assume_nondegenerate=nondegen_l,
                                  tile_variant=variant_l[0])
        checksum = (normals.sum() + res["point"].sum() + res["sqdist"].sum()
                    + res["face"].sum().to(torch.float32))
        return normals, res, checksum

    normals_l, res_l, checksum_l = step_l()         # warm-up
    float(checksum_l)
    times_l = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        normals_l, res_l, checksum_l = step_l()
        end.record()
        float(checksum_l)
        times_l.append(start.elapsed_time(end))
    step_l_ms = statistics.median(times_l)
    launches["large_batch"] = read_launches()
    check(dict(auto.STRATEGY) == {"culled": REPS + 1},
          "large batch routes %s, not the culled kernel" % auto.STRATEGY)
    check(tuple(res_l["face"].shape) == (LARGE_BATCH, LARGE_QUERIES)
          and res_l["face"].dtype == torch.int32
          and tuple(res_l["point"].shape) == (LARGE_BATCH, LARGE_QUERIES, 3)
          and tuple(normals_l.shape) == tuple(verts_l.shape),
          "large batch shapes/dtypes")
    for name, t in (("normals", normals_l), ("point", res_l["point"]),
                    ("sqdist", res_l["sqdist"])):
        check(bool(torch.isfinite(t).all()), "large batch %s not finite"
              % name)
    check(bool(((res_l["face"] >= 0) & (res_l["face"] < f_l.shape[0])).all()),
          "large batch face index out of range")
    v_step_l, _ = lbs(model_l, betas_l, pose_l, device=dev)
    brute_l = ck.closest_point_kernel(v_step_l, f_l, queries_l,
                                      assume_nondegenerate=nondegen_l)
    large_vs_brute = check_against_brute(
        "large batch", v_step_l, f_l, queries_l, res_l["face"],
        res_l["sqdist"], brute_l)
    del brute_l
    n_queries_l = LARGE_BATCH * LARGE_QUERIES
    log("large batch step: median %.3f ms over %d reps (min %.3f, max %.3f), "
        "%.0f queries/s, checksum %.6g, route culled, on %s"
        % (step_l_ms, REPS, min(times_l), max(times_l),
           n_queries_l / (step_l_ms / 1e3), float(checksum_l), smi))

    # -- 6. scan: the Mesh facade through the BVH rope kernels --------------
    log("== scan: Mesh on a %d-face sphere, %d queries"
        % (f_s.shape[0], SCAN_QUERIES))
    clear_index_cache()
    res_s, stats_s, launches["scan"], scan_calls = drive_scan(
        "scan", v_s, f_s, p_s, dev)
    budget = os.environ.get("MESH_TPU_BVH_STREAM_VMEM_MB")
    os.environ["MESH_TPU_BVH_STREAM_VMEM_MB"] = "32"
    try:
        clear_index_cache()
        res_r, stats_r, launches["scan_resident"], resident_calls = \
            drive_scan("scan_resident", v_s, f_s, p_s, dev)
    finally:
        if budget is None:
            del os.environ["MESH_TPU_BVH_STREAM_VMEM_MB"]
        else:
            os.environ["MESH_TPU_BVH_STREAM_VMEM_MB"] = budget
    check(stats_s["backend"] == "rope_stream"
          and stats_r["backend"] == "rope_resident",
          "scan backends %s / %s" % (stats_s["backend"], stats_r["backend"]))
    check(all(np.array_equal(res_s[k], res_r[k])
              for k in ("face", "part", "point", "sqdist")),
          "scan and scan_resident results are not bit-identical")
    check(stats_s["pair_tests"] >= stats_r["pair_tests"],
          "streamed pair tests below the resident walk's")
    log("  scan and scan_resident bit-identical (faces, parts, points, "
        "sqdist); pair tests %d streamed >= %d resident"
        % (stats_s["pair_tests"], stats_r["pair_tests"]))
    v_s_t = torch.as_tensor(v_s, device=dev)
    f_s_dev = torch.as_tensor(f_s, device=dev)
    p_s_t = torch.as_tensor(p_s, device=dev)
    brute_s = ck.closest_point_kernel(
        v_s_t[None], f_s_dev, p_s_t[None],
        assume_nondegenerate=ck.mesh_is_nondegenerate(v_s, f_s))
    scan_vs_brute = check_against_brute(
        "scan", v_s_t[None], f_s_dev, p_s_t[None],
        torch.as_tensor(res_s["face"], device=dev)[None],
        torch.as_tensor(res_s["sqdist"], device=dev)[None], brute_s)
    del brute_s

    # -- 7. visibility: visibility_step on the batch, then the facade ------
    log("== visibility: %d bodies x %d cameras x %d vertices, %d faces each"
        % (VIS_BATCH, len(VIS_CAMERAS), verts.shape[1], f.shape[0]))
    reset_launches()

    def step_v():
        v, _ = lbs(model, betas_v, pose_v, device=dev)
        vis, ndc = visibility_step(v, f, cams, min_dist=VIS_MIN_DIST)
        return vis, ndc, vis.sum().to(torch.float32) + ndc.sum()

    vis_v, ndc_v, checksum_v = step_v()             # warm-up
    float(checksum_v)
    times_v = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        vis_v, ndc_v, checksum_v = step_v()
        end.record()
        float(checksum_v)
        times_v.append(start.elapsed_time(end))
    step_v_ms = statistics.median(times_v)
    rest_vis, rest_ndc = visibility_step(model.v_template[None], f, cams,
                                         min_dist=VIS_MIN_DIST)
    m_v = Mesh(posed[0], f_np, device=dev)
    omni = m_v.vertex_visibility(VIS_CAMERAS[0])
    sensed = m_v.vertex_visibility(_Camera(VIS_CAMERAS[0], FACADE_SENSOR))
    sub = m_v.visible_mesh(VIS_CAMERAS[0])
    launches["visibility"] = read_launches()
    n_v = verts.shape[1]
    check(tuple(vis_v.shape) == (VIS_BATCH, len(VIS_CAMERAS), n_v)
          and vis_v.dtype == torch.bool and ndc_v.shape == vis_v.shape
          and ndc_v.dtype == torch.float32, "visibility shapes/dtypes")
    check(bool(torch.isfinite(ndc_v).all()), "visibility n.dir not finite")
    share = vis_v.float().mean(dim=(0, 2)).tolist()
    rest_back = rest_ndc < BACKFACING
    rest_back_visible = int((rest_back & rest_vis).sum())
    check(rest_back_visible == 0, "visibility: %d back-facing vertices of "
          "the closed rest template are visible" % rest_back_visible)
    backfacing = ndc_v < BACKFACING
    backfacing_visible = int((backfacing & vis_v).sum())
    tri0 = verts_v[0][f.long()]
    fn0 = cross3(tri0[:, 1] - tri0[:, 0], tri0[:, 2] - tri0[:, 0])
    inward = int(((fn0 * (tri0.mean(dim=1) - verts_v[0].mean(dim=0))).sum(-1)
                  < 0).sum())
    origins0, dirs0 = visibility_rays(verts_v[:1], cams, VIS_MIN_DIST)
    blocked64, border64 = any_hit64(origins0[0], dirs0[0].reshape(-1, 3),
                                    tri0)
    differ64 = vis_v[0].reshape(-1) == blocked64
    check(not bool((differ64 & ~border64).any()),
          "visibility: %d of body 0's flags differ from the float64 "
          "recompute away from the boundary"
          % int((differ64 & ~border64).sum()))
    log("  visible share per camera %s; body 0 against float64: %d of %d "
        "flags differ, all on borderline rays; rest template: 0 of %d "
        "back-facing (n.dir < %g) vertices visible; posed batch: %d of %d "
        "back-facing vertices visible (body 0 has %d of %d faces turned "
        "towards its centroid: the posed surface folds)"
        % (["%.4f" % x for x in share], int(differ64.sum()),
           differ64.numel(), int(rest_back.sum()), BACKFACING,
           backfacing_visible, int(backfacing.sum()), inward, f.shape[0]))
    check(omni.dtype == np.uint32 and omni.shape == (n_v,),
          "facade visibility dtype/shape %s %s" % (omni.dtype, omni.shape))
    check(np.array_equal(omni.astype(bool), vis_v[0, 0].cpu().numpy()),
          "facade visibility differs from visibility_step on body 0")
    check(0 < int(sensed.sum()) < int(omni.sum())
          and not (sensed.astype(bool) & ~omni.astype(bool)).any(),
          "sensor visibility is not a proper subset of the omnidirectional")
    check(sub.v.shape[0] == int(omni.sum()) and sub.f.shape[0] > 0
          and int(sub.f.max()) < sub.v.shape[0], "visible_mesh")
    log("visibility step: median %.3f ms over %d reps (min %.3f, max %.3f), "
        "%.0f rays/s, on %s; facade: %d visible from camera 0, %d within the "
        "sensor, visible_mesh %d vertices / %d faces"
        % (step_v_ms, REPS, min(times_v), max(times_v),
           vis_v.numel() / (step_v_ms / 1e3), smi, int(omni.sum()),
           int(sensed.sum()), sub.v.shape[0], sub.f.shape[0]))

    # -- 8. registration: the normal-weighted and along-normal trees --------
    log("== registration: Mesh on body 0, %d scan points with normals"
        % REG_QUERIES)
    pts_np, nrm_np = reg_pts.cpu().numpy(), reg_nrm.cpu().numpy()
    m_r = Mesh(posed[0], f_np, device=dev)
    reset_launches()
    reg_calls = {}

    def timed_calls(name, first):
        """The first call (tree made inside it), then 5 warm calls."""
        t0 = time.perf_counter()
        query, out = first()
        reg_calls[name + "_first_call_s"] = time.perf_counter() - t0
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            again = query(pts_np, nrm_np)
            times.append((time.perf_counter() - t0) * 1e3)
            check(all(np.array_equal(x, y) for x, y in zip(out, again)),
                  "%s: repeated calls disagree" % name)
        reg_calls[name + "_warm_call_ms"] = statistics.median(times)
        reg_calls[name + "_warm_call_ms_min"] = min(times)
        reg_calls[name + "_warm_call_ms_max"] = max(times)
        return out

    def first_nw():
        tree = m_r.compute_aabb_normals_tree()
        return tree.nearest, tree.nearest(pts_np, nrm_np)

    def first_along():
        tree = m_r.compute_aabb_tree()
        return tree.nearest_alongnormal, tree.nearest_alongnormal(pts_np,
                                                                  nrm_np)

    nw_face, nw_point = timed_calls("normal_weighted", first_nw)
    an_d, an_f, an_p = timed_calls("alongnormal", first_along)
    launches["registration"] = read_launches()
    check(nw_face.dtype == np.uint32 and nw_face.shape == (REG_QUERIES, 1)
          and nw_point.dtype == np.float64
          and nw_point.shape == (REG_QUERIES, 3)
          and an_d.dtype == np.float64 and an_d.shape == (REG_QUERIES,)
          and an_f.dtype == np.uint32 and an_f.shape == (REG_QUERIES,)
          and an_p.dtype == np.float64 and an_p.shape == (REG_QUERIES, 3),
          "registration dtypes/shapes")
    check(bool(np.isfinite(nw_point).all()), "normal-weighted points")
    mine, least = blended_min64(
        verts[0], f, reg_pts[:REG_CHECK], reg_nrm[:REG_CHECK],
        torch.as_tensor(nw_face[:REG_CHECK, 0].astype(np.int64), device=dev))
    nw_gap = float((mine - least).max())
    check(nw_gap <= 1e-5, "normal-weighted winners' blended cost %.3g above "
          "the float64 dense minimum" % nw_gap)
    hit64, least64 = alongnormal_hits64(verts[0], f, reg_pts, reg_nrm)
    finite = torch.as_tensor(an_d < 1e100, device=dev)
    lost = int((hit64 & ~finite).sum())
    check(lost == 0, "along-normal: %d queries hit in float64 come back as "
          "misses" % lost)
    check(an_d[-1] == 1e100 and an_f[-1] == 0 and not an_p[-1].any(),
          "along-normal: the planted miss is not reported as 1e100")
    both = finite & hit64
    an_gap = float((torch.as_tensor(an_d, device=dev)[both]
                    - least64[both]).abs().max())
    registration = dict(
        reg_calls, nw_cost_gap64=nw_gap, along_hits=int(finite.sum()),
        along_hits64=int(hit64.sum()), along_dist_gap64=an_gap,
        nondegenerate=nondegen_r)
    log("  normal-weighted: winners within %.3g of the float64 dense "
        "blended minimum (first %d queries); along-normal: %d of %d hit "
        "(float64 dense: %d), none lost, distance within %.3g of the "
        "float64 nearest hit; planted miss -> 1e100"
        % (nw_gap, REG_CHECK, int(finite.sum()), REG_QUERIES,
           int(hit64.sum()), an_gap))
    log("registration calls (host clock, ms): %s" % ", ".join(
        "%s %.3f" % (k, v * (1e3 if k.endswith("_s") else 1.0))
        for k, v in reg_calls.items()))

    # -- 9. contact: examples/hand_body_contact.py through the port ---------
    log("== contact: hand %d faces vs body %d faces" % (hand_f.shape[0],
                                                       body_f.shape[0]))
    from mesh_tpu_torch.query import closest_kernel as ck_mod

    reset_launches()
    contact = {"tile": contact_tile}

    def host_ms(fn, first_key, warm_key):
        """The first call (cold), then the median of 5 warm calls, on the
        host clock."""
        t0 = time.perf_counter()
        out = fn()
        contact[first_key] = (time.perf_counter() - t0) * 1e3
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            again = fn()
            times.append((time.perf_counter() - t0) * 1e3)
            check(all(np.array_equal(x, y) for x, y in zip(out, again)),
                  "contact: repeated calls disagree")
        contact[warm_key] = statistics.median(times)
        return out

    body = Mesh(body_v, body_f, device=dev)
    hand = Mesh(hand_v, hand_f, device=dev)
    hit_faces, signed = host_ms(lambda: contact_step(body, hand, dev),
                                "step_first_ms", "step_warm_ms")
    ck_mod._NONDEGEN_CACHE.clear()
    tree_c = Mesh(body_v, body_f, device=dev).compute_aabb_tree()
    (hit_again,) = host_ms(lambda: (tree_c.intersections_indices(
        hand_v, hand_f),), "intersections_first_ms", "intersections_warm_ms")
    check(np.array_equal(hit_again, hit_faces),
          "contact: intersections_indices differs between trees")
    safe = os.environ.get("MESH_TPU_SAFE_TILES")
    os.environ["MESH_TPU_SAFE_TILES"] = "1"
    try:
        hit_safe = tree_c.intersections_indices(hand_v, hand_f)
    finally:
        if safe is None:
            del os.environ["MESH_TPU_SAFE_TILES"]
        else:
            os.environ["MESH_TPU_SAFE_TILES"] = safe
    launches["contact"] = read_launches()
    n_hand = hand_f.shape[0]
    check(hit_faces.dtype == np.int64 and 0 < hit_faces.size < n_hand,
          "contact: %d of %d hand faces intersect: want some, not all"
          % (hit_faces.size, n_hand))
    check(np.array_equal(hit_safe, hit_faces), "contact: the segment tile "
          "(MESH_TPU_SAFE_TILES=1) finds %d faces, the %s tile %d"
          % (hit_safe.size, contact_tile, hit_faces.size))
    check(signed.shape == (hand_v.shape[0],) and bool(
        np.isfinite(signed).all()), "contact: signed gaps")
    masks, decided = {}, {}
    for name, idx in ((contact_tile, hit_faces), ("segment", hit_safe)):
        mask = torch.zeros(n_hand, dtype=torch.bool)
        mask[torch.as_tensor(idx)] = True
        masks[name] = mask
        decided[name] = decide64(name, hand_tri, body_tri)
    differ_c, border_c = check_against64("contact", masks[contact_tile],
                                         decided[contact_tile])
    check_against64("contact, segment tile", masks["segment"],
                    decided["segment"])
    in_contact = np.abs(signed) < CONTACT_GAP
    contact.update(
        intersecting=int(hit_faces.size), hand_faces=n_hand,
        intersecting64=int(decided[contact_tile][0].sum()),
        differ64=differ_c,
        borderline64=border_c, contact_vertices=int(in_contact.sum()),
        deepest_mm=float(-1000.0 * signed.min()) if (signed < 0).any()
        else 0.0,
        kernel_ms={alg: tri_runs[alg]["ms"] for alg in tk.ALGORITHMS})
    log("  gate -> %s tile; %d of %d hand faces intersect (segment tile "
        "the same; float64: %d, %d differ, %d borderline); %d contact "
        "vertices (< %g m), deepest penetration %.1f mm" % (
            contact_tile, hit_faces.size, n_hand, contact["intersecting64"],
            differ_c, border_c, contact["contact_vertices"], CONTACT_GAP,
            contact["deepest_mm"]))
    log("contact calls (host clock, ms): step first %.3f, warm %.3f; "
        "intersections_indices first %.3f, warm %.3f; kernel alone (phase "
        "2, CUDA events) %s, on %s" % (
            contact["step_first_ms"], contact["step_warm_ms"],
            contact["intersections_first_ms"],
            contact["intersections_warm_ms"],
            ", ".join("%s %.3f" % kv for kv in contact["kernel_ms"].items()),
            smi))

    # -- 10. self-intersection of the posed bodies ----------------------------
    log("== self_intersect: phase 3's and phase 5's posed body 0")
    from mesh_tpu_torch.query.ray import self_intersection_count

    reset_launches()
    self_int = {}
    for key, (v_np, f_np_, rest_np) in self_bodies.items():
        rec = {"faces": int(f_np_.shape[0]), "tile": self_tiles[key]}
        ck_mod._NONDEGEN_CACHE.clear()
        t0 = time.perf_counter()
        count = int(self_intersection_count(v_np, f_np_, device=dev))
        rec["first_ms"] = (time.perf_counter() - t0) * 1e3
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            again = int(self_intersection_count(v_np, f_np_, device=dev))
            times.append((time.perf_counter() - t0) * 1e3)
            check(again == count, "%s: repeated counts disagree" % key)
        rec["warm_ms"] = statistics.median(times)
        rec["count"] = count
        rec["rest_count"] = int(self_intersection_count(rest_np, f_np_,
                                                        device=dev))
        vt_b = torch.as_tensor(v_np, device=dev)
        ft_b = torch.as_tensor(f_np_.astype(np.int64), device=dev)
        per_tile = {alg: tk.self_intersection_counts_kernel(vt_b, ft_b, alg)
                    for alg in tk.ALGORITHMS}
        tri_b = vt_b[ft_b]
        ids_b = ft_b.to(torch.int32).contiguous()
        rec["kernel_ms"] = {}
        order_b = tk.morton_face_order(tri_b)   # the facade's face order
        # the facade's device work around the kernel, in the gate's tile:
        # the steps of self_intersection_counts_kernel (separate runs, none
        # launching the kernel)
        qp_b, fp_b, ids_s = tk.self_sorted_operands(tri_b, ft_b, order_b,
                                                    self_tiles[key])
        rec["stages_ms"] = {
            "triangles": cuda_ms(lambda: vt_b.to(torch.float32)[ft_b], 3),
            "morton_order": cuda_ms(lambda: tk.morton_face_order(tri_b), 3),
            "sorted_operands": cuda_ms(lambda: tk.self_sorted_operands(
                tri_b, ft_b, order_b, self_tiles[key]), 3),
            "records_and_boxes": cuda_ms(lambda: tk.self_kernel_operands(
                fp_b, ids_s, self_tiles[key]), 3)}
        for alg in tk.ALGORITHMS:
            qp_b, fp_b, ids_s = tk.self_sorted_operands(tri_b, ft_b, order_b,
                                                        alg)
            rec["kernel_ms"][alg] = cuda_ms(lambda: tk.self_intersect_counts(
                qp_b, fp_b, ids_s, alg), reps=3)
        del qp_b, fp_b, ids_s
        check(all(torch.equal(per_tile[alg], self_counts[key, alg])
                  for alg in tk.ALGORITHMS),
              "%s: the facade's per-face counts differ from phase 2's "
              "kernel run" % key)
        involved = {alg: c > 0 for alg, c in per_tile.items()}
        for alg, expect in SELF_EXPECTED[key].items():
            check(int(involved[alg].sum()) == expect, "%s, %s tile: %d "
                  "self-intersecting faces, %d before the tile cull" % (
                      key, alg, int(involved[alg].sum()), expect))
        check(rec["rest_count"] == 0, "%s: the rest template (a closed UV "
              "sphere) has %d self-intersecting faces" % (key,
                                                          rec["rest_count"]))
        check(count > 0, "%s: the posed body does not self-intersect" % key)
        check(count == int(involved[self_tiles[key]].sum()),
              "%s: the facade's count is not its tile's" % key)
        tile_differ = (involved["moller"] != involved["segment"]).nonzero()[
            :, 0]
        rec["tile_counts"] = {alg: int(x.sum()) for alg, x in
                              involved.items()}
        rec["tiles_differ"] = int(tile_differ.numel())
        # each tile against its own float64 predicate, on the faces the
        # tiles disagree on and on 256 involved and 256 free faces
        rng_s = np.random.RandomState(2)
        inv_idx = involved[self_tiles[key]].nonzero()[:, 0].cpu().numpy()
        free_idx = (~involved[self_tiles[key]]).nonzero()[:, 0].cpu().numpy()
        half = SELF_CHECK_FACES // 2
        pick = torch.as_tensor(np.concatenate([
            rng_s.choice(inv_idx, min(half, inv_idx.size), replace=False),
            rng_s.choice(free_idx, min(half, free_idx.size), replace=False)]),
            device=dev)
        rec["checked64"] = int(pick.numel())
        rec["tiles_differ64"] = 0
        for label, faces in (("tiles differ", tile_differ), ("sample", pick)):
            if not faces.numel():
                continue
            dec = {alg: decide64(alg, tri_b[faces], tri_b, ids_b[faces], ids_b,
                                 faces) for alg in tk.ALGORITHMS}
            for alg in tk.ALGORITHMS:
                got = check_against64("%s, %s tile, %s" % (key, alg, label),
                                      involved[alg][faces], dec[alg])
                if label == "sample" and alg == self_tiles[key]:
                    rec["differ64"], rec["borderline64"] = got
            if label == "tiles differ":
                # the float64 predicates themselves disagree on these
                rec["tiles_differ64"] = int((dec["moller"][0]
                                             != dec["segment"][0]).sum())
        self_int[key] = rec
        log("  %s (%d faces): %d self-intersecting faces (%s tile; moller "
            "%d, segment %d, %d differ, the float64 predicates on %d of "
            "them), rest template 0; "
            "%d faces vs float64: %d differ, %d borderline; first call %.3f "
            "ms, warm %.3f ms (host clock), kernel alone (with its records "
            "and boxes) %s ms; around it %s ms; on %s" % (
                key, rec["faces"], count, self_tiles[key],
                rec["tile_counts"]["moller"], rec["tile_counts"]["segment"],
                rec["tiles_differ"], rec["tiles_differ64"], rec["checked64"],
                rec["differ64"],
                rec["borderline64"], rec["first_ms"], rec["warm_ms"],
                ", ".join("%s %.3f" % kv for kv in rec["kernel_ms"].items()),
                ", ".join("%s %.3f" % kv for kv in rec["stages_ms"].items()),
                smi))
        del vt_b, ft_b, tri_b, ids_b, per_tile
    launches["self_intersect"] = read_launches()

    # -- 11. anim: avatar sessions streaming posed bodies ---------------------
    log("== anim: %d frames through an AvatarSession per body model, leaf %d"
        % (ANIM_FRAMES, ANIM_LEAF))
    reset_launches()
    anim_runs = {label: drive_anim(label, m_, ANIM_LEAF, dev, seed)
                 for label, (m_, seed) in anim_models.items()}
    launches["anim"] = read_launches()
    anim = {label: check_anim(label, anim_models[label][0], ANIM_LEAF,
                              *run, dev)
            for label, run in anim_runs.items()}
    del anim_runs

    # -- 12. mxu: the MXU rung through the Mesh facade ------------------------
    log("== mxu: Mesh.closest_faces_and_points under MESH_TPU_MXU=1, then "
        "MESH_TPU_MXU_BF16=1")
    reset_launches()
    auto.STRATEGY.clear()
    mxu_drive = drive_mxu(mxu_cases, dev)
    launches["mxu"] = read_launches()
    check(dict(auto.STRATEGY) == {"mxu": 2 * len(mxu_cases) * (1 + MXU_WARM)},
          "the mxu drive routes %s, not the MXU rung" % auto.STRATEGY)
    mxu = check_mxu(mxu_cases, mxu_drive, dev)
    del mxu_drive

    # -- 13. mxu_bvh: the MXU rope walks through the Mesh facade ---------------
    log("== mxu_bvh: Mesh on the %d-face scan sphere, %d queries, under "
        "MESH_TPU_MXU=1 with the crossover pinned at %d faces, streamed and "
        "resident, f32 and bf16" % (f_s.shape[0], SCAN_QUERIES,
                                    MXU_BVH_CROSSOVER))
    mxu_bvh_runs, mxu_bvh_launches = drive_mxu_bvh(v_s, f_s, p_s, dev)
    launches.update(mxu_bvh_launches)
    mxu_bvh = check_mxu_bvh(
        mxu_bvh_runs, v_s, f_s, p_s, res_s,
        {k[1:]: r for k, r in rope_mxu_runs.items() if k[0] == "scan"}, dev)
    del mxu_bvh_runs

    # -- 14. fit: the training path ------------------------------------------
    log("== fit: scan_to_model_loss and make_fit_step on the SMPL-sized model "
        "at %s; torch.func.jvp, nearest_normal_weighted, the BVH route and "
        "register_vertices" % ", ".join(
            "1 x %d" % n for _, n in FIT_SHAPES.values()))
    verts0 = verts[0].detach()
    scans_fit = fit_inputs(model, verts0, dev)
    fit_runs, fit_keep, launches["fit"] = drive_fit(
        model, verts0, scans_fit, reg_pts, reg_nrm, (v_s, f_s, p_s), dev)
    fit_runs = check_fit(fit_runs, fit_keep, model, verts0, scans_fit,
                         reg_pts, reg_nrm, dev)
    fit_runs["diff_repairs"] = check_diff_repairs(
        verts, f, queries, scans_fit[FIT_MAIN][0], dev)
    log("  card: %s" % nvidia_smi(CARD_STATE))
    fit_times(model, scans_fit, fit_runs, dev)
    fit_runs["stages_ms"] = {}
    for label, scan in scans_fit.items():
        stages = fit_runs["stages_ms"][label] = fit_stages(model, scan, dev)
        log("fit %s stage breakdown (ms, separate runs; median of %d rounds "
            "(least-most)): %s" % (label, FIT_ROUNDS, ", ".join(
                "%s %.3f (%.3f-%.3f)" % (k, t["median"], t["min"], t["max"])
                for k, t in stages.items())))
    log("  card: %s" % nvidia_smi(CARD_STATE))
    # phase 21 shards phase 14's config-5 scan
    parallel_scan = scans_fit[FIT_MAIN][0].cpu().numpy()
    del fit_keep, scans_fit

    # -- 14b. empty: no queries through every entry point ---------------------
    log("== empty: Q = 0 through every entry point of the facades, the trees "
        "and diff, on the brute, culled and BVH rungs")
    empty_layouts, launches["empty"] = drive_empty(
        posed[0], f_np, verts_l[0].cpu().numpy(), f_l.cpu().numpy(),
        (v_s, f_s, p_s), dev)

    # -- 15. engine: the facades, Mesh, the executor and ICP through plans ----
    log("== engine: the batched facades at %d x %d and %d x %d cameras, Mesh "
        "at Q = %s and on the scan sphere, warmup(), %d coalesced requests, "
        "ICP and the normals, each plan a CUDA graph" % (
            BATCH, QUERIES_PER_MESH, VIS_BATCH, len(VIS_CAMERAS),
            ENGINE_FACADE_QS, ENGINE_REQUESTS))
    eng_inp = {
        "posed": posed, "f_np": f_np, "queries": queries.cpu().numpy(),
        "q_facade": q1_np, "verts": verts, "f": f, "queries_t": queries,
        "vis_posed": posed[:VIS_BATCH], "verts_v": verts_v,
        "cams": np.asarray(VIS_CAMERAS, np.float32), "cams_t": cams,
        "scan": (v_s, f_s, p_s),
        "icp": (model.v_template, f, surface_queries(
            verts[:1].detach(), f, REGISTER_SCAN,
            np.random.RandomState(15))[0][0]),
        "large": (verts_l.cpu().numpy(), f_l.cpu().numpy())}
    t0 = time.perf_counter()
    engine_runs, launches["engine"], engine_facts = drive_engine(eng_inp,
                                                                 dev)
    engine_rec = dict(check_engine(engine_runs, engine_facts, eng_inp, dev),
                      **engine_facts)
    engine_rec["drive_s"] = engine_runs["drive_s"]
    engine_rec["times_ms"] = engine_times(eng_inp, dev)
    del engine_runs, eng_inp
    log("  plans: %d made, pool %.1f MiB, memory_reserved %.1f -> %.1f MiB; "
        "capture seconds %s; launches per replay and replays %s" % (
            len(engine_rec["plans"]), engine_rec["pool_bytes"] / 2 ** 20,
            engine_rec["reserved_before"] / 2 ** 20,
            engine_rec["reserved_after"] / 2 ** 20,
            ", ".join("%s %.4f" % kv
                      for kv in engine_rec["captures_s"].items()),
            "; ".join("%s: %s x %d runs" % ("/".join(p["key"][:5]),
                                            p["replay_launches"], p["runs"])
                      for p in engine_rec["plans"])))
    log("engine against direct, host clock (ms, median (min-max) of %d "
        "interleaved rounds): %s, on %s" % (ENGINE_ROUNDS, "; ".join(
            "%s engine %.3f (%.3f-%.3f) direct %.3f (%.3f-%.3f)" % (
                op, t["engine"]["median"], t["engine"]["min"],
                t["engine"]["max"], t["direct"]["median"],
                t["direct"]["min"], t["direct"]["max"])
            for op, t in engine_rec["times_ms"].items()), smi))
    log("engine phase: %.1f s (drive %.1f s)" % (
        time.perf_counter() - t0, engine_rec["drive_s"]))

    for name, paths in KERNEL_PATHS.items():
        for path, counts in launches.items():
            if path in paths:
                check(counts[name] > 0, "kernel %s never launched on the %s "
                      "path" % (name, path))
            else:
                check(counts[name] == 0, "kernel %s launched %d times on the "
                      "%s path, which does not use it"
                      % (name, counts[name], path))
    log("launches per path: %s" % launches)

    # -- 16. fallback: the reference's XLA routes and the calibrations ---------
    fallback = drive_fallback(fallback_inputs(
        posed, f_np, q1_np, queries, reg_pts, reg_nrm, verts_l, f_l,
        queries_l, (v_s, f_s, p_s), (body_v, body_f, hand_v, hand_f)),
        dev, smi)

    # -- 17. domain: the psbody-style workflow on the card ---------------------
    domain, launches["domain"] = drive_domain(model, posed[0], dev, smi)

    # -- 18. serve: the serving tier over the engine and the rungs ------------
    serve, launches["serve"] = drive_serve_phase(serve_inputs(
        posed[0], f_np, verts_l[0].cpu().numpy(), f_l.cpu().numpy(),
        queries_l[0].cpu().numpy()), dev, smi)

    # -- 19. store: the mesh store and what stands on it ----------------------
    store_rec, launches["store"] = drive_store_phase({
        "scan": (v_s, f_s), "body": (posed[0], f_np), "facade_q": q1_np,
        "serve_q": np.asarray(np.random.RandomState(19).randn(
            SERVE_QUERIES, 3) * 0.4, np.float32),
        "model": model}, dev, smi)

    # -- 20. fleet: three replicas behind a FleetRouter and the obs tooling ----
    fleet_rec, launches["fleet"] = drive_fleet_phase(dict(
        fleet_inputs(model, dev), bridge=bridge,
        closed_ledger=SERVE_CLOSED_LEDGER), dev, smi)

    # -- 21. parallel: the parallel layer in a world of ranks on this card ----
    par_inp, par_ref = parallel_inputs(
        model, posed, f_np, verts, verts_v, cams,
        parallel_scan, (v_s, f_s), dev)
    parallel_rec, launches["parallel"] = drive_parallel_phase(
        par_inp, par_ref, dev, smi)
    del par_inp, par_ref

    # -- crossover evidence ---------------------------------------------------
    log("== crossover: every route at both drives' shapes")
    crossover_rows = crossover(dev, (verts_l, f_l, queries_l, nondegen_l),
                               (v_s, f_s, p_s))
    mxu_crossover = calibrate_mxu_crossover(save=False)
    log("  calibrate_mxu_crossover(save=False): %d faces (stable %s); ladder "
        "%s" % (mxu_crossover, MXU_CALIBRATION["stable"], ", ".join(
            "%d faces: brute %.3f ms, mxu %.3f ms" % (
                row["faces"], row["t_brute"] * 1e3, row["t_mxu"] * 1e3)
            for row in MXU_CALIBRATION["ladder"])))

    # per-stage breakdown of one main-path step, after the counted drive
    stages = {}
    stages["lbs"] = cuda_ms(lambda: lbs(model, betas, pose, device=dev), 3)
    stages["vert_normals"] = cuda_ms(lambda: batch_step(verts, f, None), 3)
    ops = ck.closest_point_operands(verts, f, queries, main_variant[0])
    stages["closest_prologue"] = cuda_ms(lambda: ck.closest_point_operands(
        verts, f, queries, main_variant[0]), 3)
    cull = ck.cull_operands(ops[0], ops[1], *main_variant)
    stages["cull_prologue"] = cuda_ms(lambda: ck.cull_operands(
        ops[0], ops[1], *main_variant), 3)
    stages["closest_kernel"] = cuda_ms(lambda: ck.argmin_faces(
        ops[0], ops[1], main_variant[0], main_variant[1], cull=cull), 3)
    best = ck.argmin_faces(ops[0], ops[1], *main_variant, cull=cull)
    stages["closest_epilogue"] = cuda_ms(
        lambda: ck.winner_epilogue(best, ops[2], ops[0], ops[3]), 3)
    del ops, cull
    log("stage breakdown (ms, separate runs): " + ", ".join(
        "%s %.3f" % kv for kv in stages.items()))
    stages_l = {}
    stages_l["lbs"] = cuda_ms(lambda: lbs(model_l, betas_l, pose_l,
                                          device=dev), 3)
    stages_l["vert_normals"] = cuda_ms(lambda: batch_step(verts_l, f_l, None),
                                       3)
    stages_l["culled_prologue"] = cuda_ms(lambda: qk.culled_operands(
        verts_l, f_l, queries_l, variant_l[0]), 3)
    stages_l["culled_prologue_parts"] = culled_prologue_parts(
        qk, verts_l, f_l, queries_l, variant_l[0])
    ops_l = qk.culled_operands(verts_l, f_l, queries_l, variant_l[0])
    stages_l["culled_kernel"] = cuda_ms(lambda: qk.argmin_culled(
        ops_l, *variant_l), 3)
    best_l = qk.argmin_culled(ops_l, *variant_l)[0]
    stages_l["culled_epilogue"] = cuda_ms(
        lambda: qk.culled_epilogue(ops_l, best_l), 3)
    del ops_l
    log("large batch stage breakdown (ms, separate runs): " + ", ".join(
        "%s %s" % (k_, "%.3f" % v_ if isinstance(v_, float) else ", ".join(
            "%s %.3f" % kv for kv in v_.items()))
        for k_, v_ in stages_l.items()))
    builds = []
    for _ in range(3):
        t0 = time.perf_counter()
        build_bvh(v_s, f_s, leaf_size=ops_s["tile_f"])
        builds.append((time.perf_counter() - t0) * 1e3)
    stages_s = {"host_bvh_build": statistics.median(builds)}
    stages_s["rope_prologue"] = cuda_ms(lambda: rk.rope_operands(
        v_s, f_s, p_s, device=dev, records=True), 3)
    stages_s["rope_prologue_face_records"] = cuda_ms(
        lambda: rk._face_records(ops_s["rows"]), 3)
    stages_s["rope_stream_kernel"] = rope_stream["ms"]
    stages_s["rope_resident_kernel"] = rope_resident["ms"]
    stages_s["rope_epilogue"] = cuda_ms(
        lambda: rk._rope_epilogue(ops_s, si, sl), 3)
    log("scan stage breakdown (ms; build on the host clock, median of 3; "
        "the rest separate CUDA-event runs): " + ", ".join(
            "%s %.3f" % kv for kv in stages_s.items()))
    rays_v = visibility_rays(verts_v, cams, VIS_MIN_DIST)
    order_v = vis.vertex_order(verts_v)
    sorted_v = vis.sort_rays(*rays_v, order_v)
    tri_v = verts_v[..., f.long(), :]
    tri_s_v = ray.any_hit_sorted_faces(tri_v)[1]
    ops_v = ray.any_hit_operands(*sorted_v, tri_v)
    blocked_v = ray.ray_any_hit_culled(ops_v)[0]
    stages_v = {
        "lbs": cuda_ms(lambda: lbs(model, betas_v, pose_v, device=dev), 3),
        "vert_normals": cuda_ms(lambda: batch_step(verts_v, f, None), 3),
        "rays": cuda_ms(lambda: visibility_rays(verts_v, cams,
                                                VIS_MIN_DIST), 3),
        "vertex_sort": cuda_ms(lambda: vis.sort_rays(
            *rays_v, vis.vertex_order(verts_v)), 3),
        "face_sort": cuda_ms(lambda: ray.any_hit_sorted_faces(tri_v), 3),
        "face_and_chunk_records": cuda_ms(
            lambda: ray.any_hit_records(tri_s_v), 3),
        "ray_any_hit_culled_kernel": culled_hit_run["ms"],
        "flags_back": cuda_ms(lambda: vis.unsort_flags(
            blocked_v, order_v, len(VIS_CAMERAS)), 3)}
    del rays_v, order_v, sorted_v, tri_v, tri_s_v, ops_v, blocked_v
    log("visibility stage breakdown (ms, separate runs): " + ", ".join(
        "%s %.3f" % kv for kv in stages_v.items()))
    rope_anim = {}
    for label, (m_, seed) in anim_models.items():
        anim[label]["stages_ms"], rope_anim[label] = anim_stages(
            m_, ANIM_LEAF, seed, dev, label)
        log("anim %s stage breakdown of a refit frame (ms, separate "
            "CUDA-event runs; host_build_bvh on the host clock): %s" % (
                label, ", ".join("%s %.4f" % kv for kv in
                                 anim[label]["stages_ms"].items())))

    # -- kernels line, card line, result ---------------------------------------
    main = next(r for r in face_runs
                if (r["variant"], r["degenerate_tail"]) == main_variant)
    kernels = [
        {"name": "closest_faces", "route": "cuda",
         "source": "mesh_tpu_torch/csrc/closest_faces.cu",
         "replaces": "mesh_tpu/query/pallas_closest.py:696",
         "launches": launches["main_path"]["closest_faces"],
         "launches_by_path": {p: launches[p]["closest_faces"]
                              for p in launches},
         "max_abs_err": max(r["max_abs_err"] for r in face_runs),
         "ms": main["ms"], "plain_ms": main["plain_ms"],
         "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
         "library_ms": None,
         "variant": "%s, tail=%s" % main_variant,
         "variants": face_runs, "sets": face_sets,
         **cull_row(main, launches)},
        {"name": "nearest_vertices", "route": "cuda",
         "source": "mesh_tpu_torch/csrc/nearest_vertices.cu",
         "replaces": "mesh_tpu/query/pallas_closest.py:577",
         "launches": launches["facade"]["nearest_vertices"],
         "launches_by_path": {p: launches[p]["nearest_vertices"]
                              for p in launches},
         "max_abs_err": max(r["max_abs_err"] for r in
                            [vert_facade, vert_batch, vert_far]
                            + vert_planted),
         "ms": vert_facade["ms"], "plain_ms": vert_facade["plain_ms"],
         "bound_ms": vert_facade["bound_ms"],
         "bound_by": vert_facade["bound_by"],
         "library_ms": vert_facade["library_ms"],
         "per_thread": vert_facade["per_thread"],
         "split": vert_facade["split"],
         "device_ms": vert_facade["device_ms"],
         "split_device_ms": vert_facade["split_device_ms"],
         "empty_launch_ms": empty_launch,
         "batch": vert_batch, "sets": [vert_far] + vert_planted,
         # the every-vertex oracle beside the split kernel: no path runs it
         "every": {
             "name": "nearest_vertices_every", "route": "cuda",
             "source": "mesh_tpu_torch/csrc/nearest_vertices_every.cu",
             "ms": vert_facade["every_ms"],
             "device_ms": vert_facade["every_device_ms"],
             "batch_ms": vert_batch["every_ms"],
             "batch_device_ms": vert_batch["every_device_ms"],
             "launches_by_path": {p: launches[p]["nearest_vertices_every"]
                                  for p in launches}}},
    ]
    main_l = next(r for r in culled_runs
                  if (r["variant"], r["degenerate_tail"]) == variant_l)
    kernels.append(
        {"name": "culled_faces", "route": "cuda",
         "source": "mesh_tpu_torch/csrc/culled_faces.cu",
         "replaces": "mesh_tpu/query/pallas_culled.py:288",
         "launches": launches["large_batch"]["culled_faces"],
         "launches_by_path": {p: launches[p]["culled_faces"]
                              for p in launches},
         "max_abs_err": max(r["max_abs_err"] for r in culled_runs),
         "ms": main_l["ms"], "plain_ms": main_l["plain_ms"],
         "bound_ms": main_l["bound_ms"], "bound_by": main_l["bound_by"],
         "bound_tiles_ms": main_l["bound_tiles_ms"],
         "tile_fraction": main_l["tile_fraction"],
         "chunk_fraction": main_l["chunk_fraction"],
         "pair_fraction": main_l["pair_fraction"],
         "issued_fraction": main_l["issued_fraction"],
         "library_ms": None,
         "variant": "%s, tail=%s" % variant_l,
         "variants": culled_runs})
    for name, run, path, replaces in (
            ("rope_faces_stream", rope_stream, "scan",
             "mesh_tpu/accel/pallas_stream.py:206"),
            ("rope_faces_resident", rope_resident, "scan_resident",
             "mesh_tpu/accel/pallas_bvh.py:214")):
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "mesh_tpu_torch/csrc/rope_faces.cu",
             "replaces": replaces,
             "launches": launches[path][name],
             "launches_by_path": {p: launches[p][name] for p in launches},
             "max_abs_err": run["max_abs_err"],
             "ms": run["ms"], "plain_ms": run["plain_ms"],
             "bound_ms": run["bound_ms"], "bound_by": run["bound_by"],
             "library_ms": None, "detail": run})
    kernels[-1].update(lanes=rope_resident["lanes"], anim=rope_anim)
    main_nw = nw_runs[0 if nondegen_r else 1]
    kernels.append(
        {"name": "ray_any_hit_culled", "route": "cuda",
         "source": "mesh_tpu_torch/csrc/ray_any_hit_culled.cu",
         "replaces": "mesh_tpu/query/pallas_ray.py:178",
         "entries": ["ray_any_hit_culled (visibility's kernel)",
                     "ray_any_hit (every face, the flag oracle)"],
         "launches": launches["visibility"]["ray_any_hit_culled"],
         "launches_by_path": {p: launches[p]["ray_any_hit_culled"]
                              for p in launches},
         "max_abs_err": 0.0, "ms": culled_hit_run["ms"],
         "plain_ms": culled_hit_run["plain_ms"],
         "bound_ms": culled_hit_run["bound_ms"],
         "bound_by": culled_hit_run["bound_by"], "library_ms": None,
         "bound_issued_ms": culled_hit_run["bound_issued_ms"],
         "bound_all_pairs_ms": culled_hit_run["bound_all_pairs_ms"],
         "pair_fraction": culled_hit_run["pair_fraction"],
         "chunk_fraction": culled_hit_run["chunk_fraction"],
         "fallback_fraction": culled_hit_run["fallback_fraction"],
         "detail": [culled_hit_run] + culled_planted,
         "dense": dict(any_hit_run, name="ray_any_hit",
                       source="mesh_tpu_torch/csrc/ray_any_hit.cu",
                       launches_by_path={p: launches[p]["ray_any_hit"]
                                         for p in launches})})
    for name, run, runs, source, replaces in (
            ("alongnormal_faces", along_run, along_runs,
             "alongnormal_faces.cu", "mesh_tpu/query/pallas_ray.py:231"),
            ("normal_weighted_faces", main_nw, nw_runs,
             "normal_weighted_faces.cu",
             "mesh_tpu/query/pallas_normal_weighted.py:78")):
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "mesh_tpu_torch/csrc/" + source, "replaces": replaces,
             "launches": launches["registration"][name],
             "launches_by_path": {p: launches[p][name] for p in launches},
             "max_abs_err": max(r["max_abs_err"] for r in runs),
             "ms": run["ms"], "plain_ms": run["plain_ms"],
             "bound_ms": run["bound_ms"], "bound_by": run["bound_by"],
             "library_ms": None, "detail": runs})
        if run is along_run:
            # the every-face oracle beside the chunk cull: no path runs it
            kernels[-1]["every"] = {
                "name": "alongnormal_faces_every", "route": "cuda",
                "source": "mesh_tpu_torch/csrc/alongnormal_faces_every.cu",
                "replaces": "mesh_tpu/query/pallas_ray.py:231",
                "launches": launches["registration"][
                    "alongnormal_faces_every"],
                "launches_by_path": {
                    p: launches[p]["alongnormal_faces_every"]
                    for p in launches},
                "max_abs_err": 0.0, "ms": along_run["every_ms"],
                "plain_ms": along_run["every_plain_ms"],
                "bound_ms": along_run["bound_every_pair_ms"],
                "bound_by": "operations", "library_ms": None}
            kernels[-1]["variant"] = "split %d" % along_run["split"]
            for field in ("bound_issued_ms", "bound_every_pair_ms",
                          "design_overhead_ms",
                          "warp_share", "heaviest_warp_share", "stage_share",
                          "lane_share", "miss_share", "fallback_share",
                          "prologue_ms", "order_ms", "with_order_ms",
                          "every_plain_ms", "splits"):
                kernels[-1][field] = along_run[field]
    # the every-face oracle beside the chunk cull: no path runs it
    kernels[-1]["every"] = {
        "name": "normal_weighted_faces_every", "route": "cuda",
        "source": "mesh_tpu_torch/csrc/normal_weighted_faces_every.cu",
        "ms": main_nw["every_ms"],
        "launches_by_path": {p: launches[p]["normal_weighted_faces_every"]
                             for p in launches}}
    kernels[-1]["variant"] = "fast, tail=%s, split %d" % (
        main_nw["degenerate_tail"], main_nw["split"])
    for field in ("bound_issued_ms", "bound_every_pair_ms",
                  "bound_heaviest_warp_ms", "warp_share",
                  "heaviest_warp_share", "stage_share", "lane_share",
                  "prologue_ms", "with_prologue_ms", "every_plain_ms",
                  "splits"):
        kernels[-1][field] = main_nw[field]
    for name, runs, path, source, replaces, main_run in (
            ("tri_tri_any_hit", tri_runs, "contact", "tri_tri_any_hit.cu",
             "mesh_tpu/query/pallas_ray.py:754", tri_runs[contact_tile]),
            ("self_intersect", self_runs, "self_intersect",
             "self_intersect.cu", "mesh_tpu/query/pallas_ray.py:697",
             self_runs["smpl_body0[%s]" % self_tiles["smpl_body0"]])):
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "mesh_tpu_torch/csrc/" + source, "replaces": replaces,
             "launches": launches[path][name],
             "launches_by_path": {p: launches[p][name] for p in launches},
             "launches_by_tile": {alg: launches[path]["%s[%s]" % (name, alg)]
                                  for alg in tk.ALGORITHMS},
             "max_abs_err": 0.0, "ms": main_run["ms"],
             "plain_ms": main_run["plain_ms"],
             "bound_ms": main_run["bound_ms"],
             "bound_by": main_run["bound_by"], "library_ms": None,
             "tile": main_run["tile"], "detail": runs})
        for key in ("bound_every_pair_ms", "tile_fraction", "pair_fraction",
                    "deep_fraction", "pairs_issued", "bound_issued_ms",
                    "split", "splits", "wrapper_ms", "with_operands_ms",
                    "operands_ms", "candidate_share", "warp_share",
                    "lane_share", "issued_share", "deep_share",
                    "every_plain_ms"):
            if key in main_run:
                kernels[-1][key] = main_run[key]
        if name == "tri_tri_any_hit":
            # the every-pair oracle beside the cull: no path runs it
            kernels[-1]["every"] = {
                "name": "tri_tri_any_hit_every", "route": "cuda",
                "source": "mesh_tpu_torch/csrc/tri_tri_any_hit_every.cu",
                "ms": {alg: tri_runs[alg]["every_ms"]
                       for alg in tk.ALGORITHMS},
                "launches_by_path": {p: launches[p]["tri_tri_any_hit_every"]
                                     for p in launches}}
            kernels.append(
                {"name": "tri_records", "route": "cuda",
                 "source": "mesh_tpu_torch/csrc/tri_records.cu",
                 "replaces": "mesh_tpu/query/pallas_ray.py:754",
                 "launches": launches["contact"]["tri_records"],
                 "launches_by_path": {p: launches[p]["tri_records"]
                                      for p in launches},
                 "max_abs_err": 0.0, "ms": tri_runs["moller"]["records_ms"],
                 "plain_ms": tri_runs["moller"]["records_plain_ms"],
                 "bound_ms": tri_runs["moller"]["records_bound_ms"],
                 "bound_by": tri_runs["moller"]["records_bound_by"],
                 "library_ms": None, "on": "hand vs body"})
    main_lb = next(r for r in leaf_runs if "ms" in r)     # leaf 256
    kernels.append(
        {"name": "leaf_boxes", "route": "cuda",
         "source": "mesh_tpu_torch/csrc/leaf_boxes.cu",
         "replaces": "mesh_tpu/accel/pallas_refit.py:65",
         "launches": launches["anim"]["leaf_boxes"],
         "launches_by_path": {p: launches[p]["leaf_boxes"] for p in launches},
         "max_abs_err": max(r["max_abs_err"] for r in leaf_runs),
         "ms": main_lb["ms"], "plain_ms": main_lb["plain_ms"],
         "bound_ms": main_lb["bound_ms"], "bound_by": main_lb["bound_by"],
         "library_ms": main_lb["library_ms"],
         "l2_warm_ms": main_lb["l2_warm_ms"],
         "library_l2_warm_ms": main_lb["library_l2_warm_ms"],
         "amin_amax_ms": main_lb["amin_amax_ms"],
         "amin_amax_l2_warm_ms": main_lb["amin_amax_l2_warm_ms"],
         "plan": main_lb["plan"], "empty_launch_ms": empty_launch,
         "on": main_lb["on"],
         "detail": leaf_runs,
         # the warp-a-leaf oracle beside the new kernel: no path runs it
         "warp": {
             "name": "leaf_boxes_warp", "route": "cuda",
             "source": "mesh_tpu_torch/csrc/leaf_boxes_warp.cu",
             "ms": main_lb["warp_ms"],
             "l2_warm_ms": main_lb["warp_l2_warm_ms"],
             "launches_by_path": {p: launches[p]["leaf_boxes_warp"]
                                  for p in launches}}})
    main_m = next(r for r in mxu_runs if r["mesh"] == "sphere_surface"
                  and "ms" in r["faces"])
    for name, key, source, replaces in (
            ("mxu_faces", "faces", "mxu_faces.cu",
             "mesh_tpu/query/pallas_closest.py:1015"),
            ("mxu_bound_culled", "bound", "mxu_bound_culled.cu",
             "mesh_tpu/query/pallas_closest.py:1091"),
            ("mxu_repair", "repair", "mxu_repair.cu",
             "mesh_tpu/query/pallas_closest.py:1115")):
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "mesh_tpu_torch/csrc/" + source, "replaces": replaces,
             "launches": launches["mxu"][name],
             "launches_by_path": {p: launches[p][name] for p in launches},
             "max_abs_err": max(r["max_abs_err"] for r in mxu_runs),
             "ms": main_m[key]["ms"], "plain_ms": main_m[key]["plain_ms"],
             "bound_ms": main_m[key]["bound_ms"],
             "bound_by": main_m[key]["bound_by"], "library_ms": None,
             "on": "sphere_surface, tail=%s" % main_m["degenerate_tail"],
             "detail": [dict(r.get(key, {}), mesh=r["mesh"],
                             degenerate_tail=r["degenerate_tail"],
                             split=r["split"],
                             closest_faces_ms=r.get("closest_faces_ms"),
                             prologue_ms=r.get("prologue_ms"),
                             repaired=r["repaired"], screened=r["screened"])
                        for r in mxu_runs]})
        # the every-face oracle beside the chunk cull: no path runs it
        oracle = {"faces": "mxu_faces_every", "bound": "mxu_bound",
                  "repair": "mxu_repair_every"}[key]
        kernels[-1]["every"] = {
            "name": oracle, "route": "cuda",
            "source": "mesh_tpu_torch/csrc/%s.cu" % oracle,
            "ms": main_m[key]["every_ms"],
            "launches_by_path": {p: launches[p][oracle] for p in launches}}
        for field in ("bound_issued_ms", "bound_every_pair_ms",
                      "warp_share", "heaviest_warp_share", "stage_share",
                      "lane_share", "every_plain_ms", "with_prologue_ms"):
            kernels[-1][field] = main_m[key][field]
        if key == "bound":
            kernels[-1]["split_ms"] = main_m[key]["split_ms"]
    main_fused = next(r for r in fused_runs if "ms" in r and (
        r["variant"], r["degenerate_tail"]) == main_variant)
    kernels.append(
        {"name": "closest_faces_fused", "route": "cuda",
         "source": "mesh_tpu_torch/csrc/closest_faces.cu",
         "replaces": "mesh_tpu/query/pallas_closest.py:277",
         "launches": launches["main_path_fused"]["closest_faces_fused"],
         "launches_by_path": {p: launches[p]["closest_faces_fused"]
                              for p in launches},
         "max_abs_err": max(r["max_abs_err"] for r in fused_runs),
         "ms": main_fused["ms"], "plain_ms": main_fused["plain_ms"],
         "bound_ms": main_fused["bound_ms"],
         "bound_by": main_fused["bound_by"], "library_ms": None,
         "variant": "%s, tail=%s, tile_f=%d" % (*main_variant,
                                                ck.FUSED_TILE_F),
         "variants": fused_runs, **cull_row(main_fused, launches)})
    kernels.append(
        {"name": "cull_records", "route": "cuda",
         "source": "mesh_tpu_torch/csrc/cull_records.cu",
         "replaces": "mesh_tpu/query/pallas_closest.py:696",
         "launches": launches["main_path"]["cull_records"],
         "launches_by_path": {p: launches[p]["cull_records"]
                              for p in launches},
         "max_abs_err": 0.0, "ms": main["records_ms"],
         "plain_ms": main["records_plain_ms"],
         "bound_ms": main["records_bound_ms"],
         "bound_by": main["records_bound_by"], "library_ms": None,
         "variant": "%s, tail=%s" % main_variant,
         "detail": [{k: r[k] for k in ("variant", "degenerate_tail",
                                       "records_ms", "records_plain_ms",
                                       "records_bound_ms")}
                    for r in face_runs]})
    for name, walk, path, replaces in (
            ("rope_mxu_stream", "stream", "mxu_bvh",
             "mesh_tpu/accel/pallas_stream.py:432"),
            ("rope_mxu_resident", "resident", "mxu_bvh_resident",
             "mesh_tpu/accel/pallas_bvh.py:406")):
        run = rope_mxu_runs["scan", walk, False]
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "mesh_tpu_torch/csrc/rope_mxu_faces.cu",
             "replaces": replaces,
             "launches": launches[path][name],
             "launches_by_path": {p: launches[p][name] for p in launches},
             "max_abs_err": max(r["max_abs_err"]
                                for k, r in rope_mxu_runs.items()
                                if k[1] == walk),
             "ms": run["ms"], "plain_ms": run["plain_ms"],
             "bound_ms": run["bound_ms"], "bound_by": run["bound_by"],
             "library_ms": None, "on": "scan, f32",
             "detail": [r for k, r in rope_mxu_runs.items()
                        if k[1] == walk]})
    driven = [k for k, paths in KERNEL_PATHS.items() if paths]
    check(sorted(r["name"] for r in kernels) == sorted(driven),
          "the kernels line lists %s, KERNEL_PATHS %s"
          % (sorted(r["name"] for r in kernels), sorted(driven)))
    card_state["end"] = nvidia_smi(CARD_STATE)
    log("card state at the end (%s): %s" % (CARD_STATE, card_state["end"]))
    log("total %.1f s" % (time.perf_counter() - t_start))
    print(smi, flush=True)
    print(json.dumps({
        "kernels": kernels, "main_path_step_ms": step_ms,
        "main_path_fused": {"step_ms": step_fused_ms,
                            "step_ms_min": min(times_fused),
                            "step_ms_max": max(times_fused),
                            "faces_equal_to_exact": fused_same},
        "stages_ms": stages, "build_s": build_s, "card_state": card_state,
        "large_batch": {"step_ms": step_l_ms, "step_ms_min": min(times_l),
                        "step_ms_max": max(times_l), "stages_ms": stages_l,
                        "vs_brute": large_vs_brute},
        "scan": {"stream": dict(stats_s, **scan_calls),
                 "resident": dict(stats_r, **resident_calls),
                 "stages_ms": stages_s, "vs_brute": scan_vs_brute},
        "crossover_ms": crossover_rows,
        "visibility": {"step_ms": step_v_ms, "step_ms_min": min(times_v),
                       "step_ms_max": max(times_v),
                       "visible_share_per_camera": share,
                       "backfacing_visible": backfacing_visible,
                       "rest_backfacing_visible": rest_back_visible,
                       "body0_flags_differ64": int(differ64.sum()),
                       "stages_ms": stages_v,
                       "every_face_kernel_ms": any_hit_run["ms"]},
        "registration": registration, "contact": contact,
        "self_intersect": self_int, "anim": anim,
        "mxu": {"calls": mxu, "crossover": dict(MXU_CALIBRATION)},
        "mxu_bvh": mxu_bvh, "fit": fit_runs,
        "empty": {"entry_points": sorted(empty_layouts)},
        "engine": engine_rec, "fallback": fallback, "domain": domain,
        "serve": serve, "store": store_rec, "fleet": fleet_rec,
        "parallel": parallel_rec},
        default=str),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
