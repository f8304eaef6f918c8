#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. probe   the card (nvidia-smi name and power limit), torch/CUDA versions,
           whether aiohttp and PIL import;
2. readyz  a fresh default app with ``renderer.prewarm: ["4x1024"]``:
           its background prewarm builds the kernels from
           ``kernels/csrc/render.cu``, ``kernels/csrc/jpeg.cu``,
           ``kernels/csrc/workloads.cu`` and ``kernels/csrc/staging.cu``
           with nvcc and the native codecs (``native/jpegenc.cpp``,
           ``jpegdec.cpp``, ``tilecache.cpp``, the JPEG 2000 tier-1,
           ``jp2kt1.cpp``, and the packer, ``wirepack.cpp``) with g++, all
           at once, and launches K10 at the cold-miss band shape and K1,
           K3, K4a and K4b at B = 1..8 while ``/readyz``
           answers 503 ``pending``, then 200 ``complete`` (the seconds to
           ready, the prewarm's launches); ``kernels/csrc/mesh.cu`` builds
           beside them, one more nvcc started with them;
   build   the same builds again (found built) and each kernel's ptxas
           register and shared-memory lines;
3. kernels each kernel against its plain PyTorch version at the flagship
           shape B=8, C=4, 1024x1024 uint16 (and at the served shape B=1):
           K1 render_ramp with linear settings (exact) and with all four
           families and a reversed channel (<= 1 per byte); K2 render_lut
           with a LUT channel (<= 1), and with the four families, a
           reversed channel and a LUT channel (<= 1); both on a ragged
           37x45 tile and on a base that is not 16-byte aligned; K3
           jpeg_coefficients exactly (mismatch count printed), K4a
           sparse_pack and K4b compact_rows byte for byte, at q 85 and 90
           and B=8, 3 and 1 (K4a also at cap 1000, on an all-zero tile, on
           a B=3 batch with a zero tile in it and on one tile of four
           tiles' blocks; K3 also flipped h, v and hv, on ragged, small,
           unaligned tiles and on a larger frame; K4b also with n_valid 5
           and 0 and rows over a cap that gives an odd width).
           Then K7 project_fold (uint16 zc=32 1024^2, max, mean and sum
           finalized, also in two chunks; zc=1; a 256-row band at y0=512
           of a 1024^2 plane; h=1000; u8, int32, f32 with NaN planes, and
           int8, int16, uint32 and float64 on a ragged 37x45 chunk), K8a
           mask_rasterize (in four flips: B=8 1024^2, B=1 1023^2, B=3
           1000x999 (a row stride no multiple of 4), 37x45, 1x9, 31x7,
           33x5: groups that span rows; 100x99 packed from an odd
           address) and K8b mask_overlay (grid bytes 0-3, fill alpha 0,
           128, 255: B=1 1024^2, a 37x45 pair, 1023x1021, a base 4 bytes
           past a 16-byte boundary, B=3 256^2, a base 1 byte and a grid
           3 bytes past one), each byte for byte, with ``copy_ms`` beside
           their times (a ``dst.copy_(src)`` of the same bytes under the
           same timing; K8a also timed at 1023^2 with flip_h); and K9
           mean2_int exactly (4 x 8192^2 uint16, the pyramid job's first
           level step; 4 x 1024^2 uint16; 3 x 4096^2 uint8; int16 with
           negatives; an odd 4097 x 8191 plane; an int8 37 x 45 plane),
           with ``torch.round(F.avg_pool2d(x.float(), 2))`` as its
           library call.  K5 huffman_pack byte for byte (whole rows) and
           K4b with the Huffman row lengths, on the K3 coefficients of
           the flagship tiles at B=8 and B=1, q 85 and 92, each with the
           fixed spec and one tuned to the tile's own frequencies; on an
           all-zero tile, blocks with runs of 16, 32, 48 and 62 zeros, DC
           differences of category 11, an entry overflow (cap 100) and a
           bit overflow (64 words); and at B=8 and B=1 the seams of its
           128-block chunks (fields straddling the word two chunks share,
           counted), a budget that ends inside a chunk, blocks of maximal
           magnitudes (with room for the whole stream and at the flagship
           budget), bases 2 bytes past alignment and ragged last chunks
           (1000^2 and 37 x 45 tiles); no PyTorch call packs a Huffman
           stream (``library_ms`` null).  K10 unpack16 (the packed
           staging's decode, ``kernels/csrc/staging.cu``) byte for byte on
           packed planes: a 4x1024^2 flagship tile, a 4x256x1024 band
           decoded into its rows of a 4x1024^2 stack, an all-zero plane
           (width 0), a full-range noise plane (width 17), rows of 1000
           samples (a partial block), 300 rows (no multiple of a CTA's
           8), a single row, a 16x1024^2 stack (a look-back over 2048
           tiles) and a band staged in one buffer as ``stage`` lays it
           out (the words a view, the widths 4-byte aligned behind them),
           each timed beside its bound and plain version (the ``k10:``
           line); no PyTorch call decodes it.  K6 bitpack_fixed (the
           direct renderer's bitpack engine; one launch, no memset) words
           and total bits exactly on the K3 coefficients of the flagship
           tiles at B=8 and B=1, q 85 and 95, an overflow at 64 words (the
           words below the cap equal, nothing spilled into the next
           tile's), an all-zero tile, runs of 16 to 62 zeros, DC
           differences of 2048 and more (the clamped category 11), an
           unaligned base, maximal blocks, clamps below -2047 in one chunk
           only and first in chunks, streams ending on a word, B=3 of
           different lengths, the kernel launched into outputs between
           guard words (a stray store shows), 70 calls back to back on
           one stream and two, and B=16 (the ``check bitpack_fixed``
           lines; its kernels and memsets a call counted by the profiler
           and held to one kernel; no PyTorch call packs a Huffman
           stream).  Then ``b16:`` K1, K3, K4a, K4b and K5 exactly at
           B = 16 (the largest group batch growth launches), each timed
           there.
           Each gets the median device time of 25 launches (CUDA events,
           the L2 flushed before each, a GPU sleep ahead of the timed span
           so the host's enqueue is not in it), the device time of each of
           its launches and memsets (torch.profiler, L2 warm), the plain
           version's time, and the bound from the bytes moved and the
           operations done; K7 also torch.sum over the chunk's dim 0 (the
           library call; torch.amax has no uint16 kernel);
4. serve   an 8192^2 4-channel uint16 pyramid (image 1; its level 0
           also as a single-level tiled OME-TIFF, image 3, and an NGFF
           group, image 4), a 4096^2 RGB JPEG-in-TIFF (image 5, PIL JFIF
           tiles of 512^2), a 1024^2 x 32
           4-channel uint16 Z-stack (image 2, 256 MiB) and 10 masks
           (8 of 1024^2 with fills, one 37x45, one 1023^2 whose payload
           ends mid-byte) through the port's default
           aiohttp app (micro-batcher, device raw cache, single-flight) on
           127.0.0.1: 11 GETs (resolution 0 and 1, greyscale, a reversed
           channel, a LUT channel as png and as a device-route JPEG, a
           flip, png, a render_image region, JPEG at q 0.9 and at the
           default quality on the device route, and one 256^2 JPEG on the
           host route), each checked against the plain route on a host
           read of the same request: png pixels exactly; device-route JPEG
           bytes against plain K1/K2 -> plain K3 -> plain K4 -> the same
           native coder; the 256^2 JPEG against PIL over the plain pixels.
           Every kernel's launch counter must rise.  Then
           batch:      8 distinct device-route JPEG GETs at once (two
                       windows, a reversed channel, flip h, flip v, a
                       1000x1000 region in the 1024 bucket, a LUT channel,
                       q 0.9), each equal to the plain route; fails unless
                       a group held 2 or more tiles, or if more groups were
                       in execute than device lanes; its launch counts are
                       the kernel line's ``launches``;
           e2e:        the raw cache cleared, 16 sequential and 48 GETs at
                       8 in flight, every one a miss (fails on a hit): p50,
                       tiles/s, group sizes, queue wait, execute time (the
                       app of these phases and of admission: and watchdog:
                       runs without the prefetcher, which would turn cold
                       GETs warm; prefetch: runs the default app with it);
           staging:    the e2e run's 16 cold tiles cut into the handler's
                       bands, each band packed (JAX's decision), its words
                       and widths copied from a pinned buffer and decoded
                       by K10, each timed, beside the same band's plain
                       pinned upload; K10's launches in the e2e run (fails
                       at 0: the cold misses go through it);
           stream:     render GETs of the default app leave chunked,
                       their bytes equal to an app's with
                       ``wire.streaming: false`` (one body with a
                       Content-Length); the p50 of ``http.firstByte``
                       over e2e's sequential run;
           raw_cache:  the 16 sequential tiles with another window, each a
                       hit (fails on a miss) and equal to the plain route:
                       warm p50 against cold;
           digest:     the 16 sequential tiles cold again with the raw
                       cache's content-digest dedup on (off by default):
                       cold p50 against the e2e run's, and the share of
                       misses the dedup saved a copy for;
           postures:   4 of the burst's GETs at once through the batcher's
                       own call on host planes (one pinned group buffer),
                       and through the direct reference handler
                       (``build_handler(batcher=False)``), each equal to the
                       plain route;
           spans:      the per-request p50 of each span of the render path
                       (the JAX package's names) over the e2e run's 16
                       sequential and 48 concurrent GETs, and of
                       ``imageregion_request_duration_ms``; fails if
                       getPixelBuffer, queueWait, the group's execute or
                       the coder has no sample; then the /metrics scrape;
           http_cache: a cold device-route JPEG GET (200 with ETag,
                       Cache-Control, Last-Modified), its If-None-Match
                       and If-Modified-Since repeats (empty 304s) and a
                       HEAD (the headers alone), none of them moving the
                       batcher's counters; a 404 without cache headers;
           projection: p=intmax|0:31, intmean and intsum of the Z-stack as
                       JPEG and PNG, each equal to the batcher=False
                       reference app; a re-windowed repeat makes 4 raw-cache
                       proj hits; one channel's 32 planes folded on the
                       host and by K7 (pinned H2D included), equal, with
                       their times;
           masks:      8 same-shape masks at once (mean group >= 2), each
                       PNG equal to the host rasterizer's; flips, a colour
                       override and the ragged payload; a 304 and a 404;
                       K8a launched;
           overlay:    masks 2 and 3 over a 1024^2 region, equal to the
                       host path (the base PNG decoded, host grids,
                       overlay_masks_batch); K8a and K8b launched;
           animation:  axis=z&frames=8 JPEG on the Z-stack: 8 FRME records
                       in order, each the plain route's bytes for its
                       plane; the strip's mean group;
           readers:    6 of the checked res-0 GETs (png, LUT png, three
                       device-route JPEGs, a render_image region) from
                       images 3 and 4, each byte-equal to image 1's; a
                       1024^2 device-route JPEG of image 5 equal to the
                       plain route over the reader's pixels (the native
                       decoder), which are within 2 of the Python
                       decoder's; each reader's cold
                       ``PixelsService.readRegion`` over 8 row-0 tiles
                       beside the chunked store's; K1-K4b launched;
           pyramid:    POST /pyramid for image 3, polled to done: every
                       committed level equal to image 1's store level bit
                       for bit, a resolution-2 JPEG and png of image 3
                       (now served from the pyramid) equal to image 1's,
                       levels_committed_total up by the level count, K9
                       launched once per level step; the job's wall time
                       split into the source read, the K9 steps and the
                       level writes;
           omero:      the OMERO deployment: an app with the Postgres
                       session store (required) and metadata service on
                       a sqlite OMERO schema (``SqliteAsyncDb``, its
                       statements counted) and ``omero.data.dir`` on a
                       repository holding image 3's OME-TIFF as a
                       ManagedRepository fileset (image 11), a big-endian
                       2048^2 x 4 uint16 ROMIO buffer cut from image 1
                       (12) and two Aperio-style JP2K TIFFs of 2048^2 RGB
                       in 512^2 tiles, 33005 and 33003 (13, 14): owner,
                       member and public-read device-route JPEG GETs of
                       each, 11 and 12 byte-equal to image 1's, 13 and 14
                       to the plain route over the reader's pixels; a LUT
                       GET; the outsider's 404 on a private image; 403s
                       for no cookie, an expired and an unknown one; one
                       JP2K tile by the native and the Python tier-1,
                       equal, with both times; a repeat GET asking no ACL
                       statement past the canRead memo; cold
                       ``readRegion`` over 8 512^2 tiles of each layout
                       beside the chunked store's; K1-K4b launched;
           prefetch:   the default app with prefetch on and sessions
                       enabled: one session pans 16 1024^2 tiles of image
                       1 (a snake over rows 4 and 5), each body equal to
                       the plain route; the prefetcher's hit rate (fails
                       at 0), staged, predicted and skipped counts, the
                       pan-step p50 against e2e's cold p50; then e2e's 48
                       GETs at 8 in flight with prefetch on, mean group
                       size and tiles/s beside e2e's (reported only);
           huffman:    ``renderer.jpeg-engine: auto`` (the startup probe's
                       rate and opening engine, two GETs), then
                       ``huffman``: e2e's 16 sequential cold tiles, their
                       16 re-windowed repeats and its 48 GETs at 8 in
                       flight, after the workload's table tuning; each
                       JPEG decodes (PIL) to exactly the pixels of the
                       sparse engine's JPEG of the same URL; cold and warm
                       p50, tiles/s, the wire bytes a tile and the wire's
                       D2H ms beside the sparse engine's, the sequential
                       run's span split, K5's launches (fails at 0, or if
                       K4a ran);
           byte_cache: the default app with the three byte caches on: 16
                       cold device-route JPEG tiles, then each again, the
                       first GET's bytes with no group dispatched and a
                       ``cache.hit`` span on every repeat (hit p50 beside
                       raw_cache's warm p50); a private copy of image 1:
                       the owner's GET, another session's 404 from the
                       cached tile's ACL; a mask with a colour and its
                       repeat, a shape-mask hit with no K8a launch;
           access_log: the default app with the image-region cache on: a
                       cold JPEG GET, its repeat, its revalidation and an
                       unknown image (200, 200, 304, 404), one JSON line
                       each on ``omero_ms_image_region_tpu_torch.access``
                       with the JAX app's keys, cache classes ``render``,
                       ``byte-cache``, ``render``, ``render`` and
                       provenance tiers ``render_cold``, ``byte_cache``,
                       ``304`` and none; the miss's cost ledger;
           bitpack:    ``renderer.jpeg-engine: bitpack`` with
                       ``batcher.enabled: false`` (the direct renderer):
                       4 flagship tiles, one flipped h and one flipped hv
                       at q 0.95, each K6's stream equal to the plain
                       bitpack route (plain K1, K3 and K6 and the host
                       framing), and a 1000x1000 region (not MCU-aligned:
                       the sparse engine) equal to the plain route; each
                       GET's wall ms beside a direct sparse app's; K6
                       launched once a bitpack GET (fails otherwise);
           growth:     queue-pressure growth in a default app: 64 flagship
                       tiles and their h-flips (one group key) sent
                       sequentially, then all 128 at once (up to 100 in
                       flight, the client's connection limit): each body
                       equal to its sequential one, and the batcher's
                       counters must hold groups above 8 (its max_batch
                       grown to 16);
           then the device busy share (torch.profiler) of 8 sequential and
           of 32 concurrent cold GETs, one tile's layer breakdown on a cold
           host read (read, digest, pinned DMA, kernels, wire, coder),
           hashlib's digest rates, and whether PIL's and the native
           coder's encodes overlap across 8 threads; then
           admission:  24 distinct cold device-route JPEG GETs at once
                       through an app with an admission bound of 4: each a
                       200 equal to the plain route or a 503 with
                       Retry-After >= 1, at least one 503, admitted + shed
                       = 24 (the default app's e2e run shed none);
           watchdog:   a seeded 3 s freeze of a group's lane, healed by
                       the watchdog's requeue (0.5 s floor) with the plain
                       route's bytes before the freeze ends, exactly one
                       requeue; without the injector a repeat runs clean;
           forensics:  a default app with a 0.5 s sentinel tick serves
                       16 flagship tiles at once until its baseline is
                       learned; a lane freeze (the fault injector; twice
                       the learned p99, at least 300 ms)
                       must be confirmed ``drifting`` (``/readyz`` too)
                       with one incident bundle, and must recover without
                       it; a ``/debug/profile`` over an 8-in-flight burst
                       must name render_ramp_kernel,
                       jpeg_coefficients_kernel, sparse_pack_kernel and
                       compact_rows_kernel (a 503 fails), a second one
                       meanwhile answers 409; OpenMetrics exemplars listed
                       by ``/debug/exemplars``, ``/debug/explain`` of a
                       served tile resident, ``/debug/costs`` and
                       ``/debug/decisions`` non-empty; prints the ticks
                       and seconds from the freeze to ``drifting``, the
                       bundle's files and the tile p50 during a capture
                       and outside one;
           pressure:   an app with the pressure governor (0.25 s ticks), a
                       64 MiB raw cache and ``hbm-high`` 0.5: cold
                       flagship tiles drive it to ``critical``; the
                       ladder engages in order; under it a tile's JPEG
                       equals the plain route's at quality 60 byte for
                       byte, a ``p=`` GET answers 503 with Retry-After and
                       a burst runs one group on a lane at a time; with
                       traffic stopped it releases in exact reverse;
                       prints each transition with its time and the tile
                       p50 under each rung;
           fleet:      the default app with ``fleet: {enabled: true,
                       members: 2}`` (two in-process members on the card,
                       each its own batcher and raw cache): 32 distinct
                       cold tiles at 8 in flight, each equal to the plain
                       route, each served and staged by the member this
                       script's own consistent-hash ring names (BLAKE2b,
                       64 points a member; stealing held off until the
                       skewed burst) and no plane resident on two
                       members; the same tiles re-windowed, every one a
                       raw-cache hit on its owner; a skewed burst of 16
                       cold tiles of one member at once: at least one
                       steal, and the thief's raw cache unchanged; a burst
                       with member m1 marked down in its middle: no failed
                       GET; ``POST /admin/drain?member=m1``: its planes
                       prestaged on m0, then ``/admin/undrain``; with
                       ``hotkey`` on, a burst of 64 GETs of one plane (64
                       windows) promotes a replica, reads balance to it
                       and no replica is staged twice; K1's launches per
                       member (each member's batcher groups), the p50 and
                       tiles/s against the e2e run's.
           The app is reached over HTTP on 127.0.0.1 where aiohttp is
           installed, else through its request front (``server.app.Front``:
           the same conditional decision, handler and status mapping);
           each line says which;
5. sidecar  the frontend/sidecar split: a ``--role sidecar`` child on a
           unix socket owns the card; a frontend in a process of its own
           (it must not initialise CUDA) serves 8 cold flagship JPEG tiles
           through it, byte-equal to a combined app's, over the
           shared-memory ring (``ring: true``, the sidecar's ring bytes),
           with the p50 beside combined; the child killed, the frontend
           answers 503 with Retry-After with degraded mode off and
           degraded 200s with it on; then ``--role split``: a 200, the
           sidecar child killed, the supervisor's new child serves the
           same bytes, and SIGTERM leaves no child;
5b. fleet_sidecars a ``--role frontend`` with ``fleet.sockets`` over two
           ``--role sidecar`` processes on the same card: 8 cold tiles
           byte-equal to the combined fleet app's; a skewed burst with
           one steal, the thief sidecar's raw cache (its
           ``shard_manifest``) unchanged; ``drain`` of m0 with the wire
           prestage of its shard on m1; the drained tile again, answered
           by a peer ``byte_fetch`` from m0's byte tier; p50s and the
           sidecars' start time;
5d. autoscale the elastic autoscaler on the card.  (A) JAX's
           elasticity drill: a combined app with three in-process members
           (``fleet.members: 3``, one lane each) and ``autoscaler:
           {floor: 1, interval-s: 0.5, hold-ticks: 2, cooldown-s: 3}``
           (queue-high 1.0 and queue-low 0.25 a lane; ``drain.fail-readyz``
           on; ``ready-max-queue-depth`` out of the way so ``/readyz``
           reads the drains only), the 64 flagship tiles warmed, then the
           port's ``LoadModel(seed=1234, viewers=200, grid=8)`` through
           ``run_open_loop`` in three legs: idle (no traffic) until the
           autoscaler has parked two members; the parked members' raw
           caches dropped (a restart's cold card memory); a 10 s burst at
           1.5x ``e2e:``'s tiles/s at 8 in flight, which grows the fleet a
           member at a time, each joiner's drained shard resident again
           (pre-stage-back) and its owned tiles raw-cache hits (>= 0.8);
           a 10 s quiet leg at 0.1x, which shrinks it to the floor again;
           then the burst's arrivals through ``run_closed_loop``
           (concurrency 8).  Every 200 is byte-equal to the default app's
           body of its tile, no 5xx but sheds (counted), transitions a
           cooldown apart, ``/readyz`` 200 while members are parked, the
           transitions in ``GET /admin/autoscaler``, the
           ``imageregion_autoscaler_*`` and ``imageregion_loadmodel_*``
           families in the scrape, and K1, K3, K4a, K4b and K10 launched
           (the counts from the warm-up to the closed loop).  Prints the
           transitions with their times, the open loop's p50, p99 and
           late fires, the closed loop's p99 and the launches.  (B)
           Sidecar units: a frontend over two ``fleet.sockets`` with
           ``autoscaler.unit-config`` spawns both sidecars itself; idle,
           the autoscaler parks m1 and stops its process (``pgrep`` finds
           none); a burst restarts it, its socket accepting before the
           undrain; every body byte-equal to the default app's; cleanup
           stops both units.  Latencies are printed, never gated (every
           member shares the one card);
5e. federation three federation hosts on the one card: host A is this
           process's combined app (``federation.enabled``, member a0
           in-process), hosts B and C two ``--role sidecar`` processes
           owning b0 and c0 (``quorum: true``, ``suspect-after-s`` 2,
           ``gossip-interval-s`` 0.5, ring seed ``fed-epoch-1``, shard
           epoch 1), started after every kernel is built.  Legs, in order:
           join (the startup's strict agreement; one digest on all three;
           each process's own ring, B's and C's read over
           ``manifest_hello``, gives the 64 tiles' route keys the owners
           this script's seeded BLAKE2b ring computes); serve (48 cold
           flagship tiles at 8 in flight, the same 48 warm, and two LUT
           GETs, one owned by a0 and one by b0: every body byte-equal to
           the default app's, every tile served by its ring owner; cold
           and warm p50 and tiles/s, the ``fed.hop`` spans of one traced
           agreement and gossip round, this process's K1, K2, K3, K4a,
           K4b and K10 launches, each required); epoch roll
           (``roll_epoch`` to epoch 2 with seed ``fed-epoch-2`` while 8
           GETs are in flight: committed on all three hosts, the probes'
           owners moved on every host, no GET failed, the 48 tiles then
           on their new owners); cross-host drain (``POST /admin/drain``
           of a0, the in-process member: its raw-cache planes shipped to
           the successors over ``shard_transfer``, planes, bytes and ms;
           its tiles then served elsewhere with a raw-cache hit rate of at
           least 0.8; undrain); netsplit (``partition`` rules cut host C
           off both ways: C fences within suspect-after-s plus a jittered
           interval while A and B stay quorate, refuses a roll's propose
           and an inbound staging, c0's tiles fail over with no 5xx but
           sheds; after the heal C is quorate again; seconds to fence and
           to restore); death (host B's process killed with 8 GETs in
           flight: no 5xx but sheds, its tiles then served elsewhere,
           ``/readyz`` 200).  The drain leg drains a0, not b0: as in JAX,
           a drain ships bytes only from an in-process drainer (a remote
           drainer's successors re-read the plane from their own store).
5c. mesh   (a) K12a ``composite_partial`` and K12b ``composite_pack``
           (``kernels/csrc/mesh.cu``, the mesh step's partial composite
           and ordered pack) against their plain versions at B=8 and B=1,
           C=4, 1024^2 uint16, the channels split as chan 1, 2 and 4 on
           the one card (each shard's K12a on its slice, K12b over the
           stacked partials in shard order): ramp, LUT, a reversed
           channel (exact) and the curved families (K1's +-1); raw in f32
           and u8; C=3 padded to 4 with inert channels and B=3 to 4; a
           ragged 1000x1020 tile; each timed on a chan-2 shard at B=8
           and B=1 (K12a also on a chan-4 shard and, with the LUT, on a
           chan-2 shard; K12b also over 4 shards and 1) beside its bound
           and plain version.  (b) The mesh app (``parallel: {enabled:
           true}``) for the sparse and the Huffman engines, standalone
           and joined to a process group of one (a free
           ``coordinator-address``, ``num-processes: 1``: NCCL and gloo
           up, the collectives run on the card): the 11 checked GETs
           twice and 16 cold tiles at 8 in flight, every body byte-equal
           to the default app's (the Huffman engine's tables pinned to
           the fixed ones, which the mesh codes with, as JAX's); at chan
           1 the step renders with K1 and K2 and makes no partial: K1 and
           K2 launched, K12a and K12b not; cold and warm p50, tiles/s and
           the mean group size beside ``e2e:``'s.  (c) ``mesh_ranks:``
           the chan > 1 path, K12's: two processes on the one card
           joined over gloo (NCCL refuses two ranks on one GPU) as a (1,
           2) mesh, each running ``render_step_sharded_batched`` on its
           channel shard of 8 flagship tiles at 1024^2 (per-tile
           windows; ramp, then a LUT channel): K12a on the shard, the
           partials all-gathered, K12b; both ranks' rows equal to K1's and
           K2's over the whole group, and K12a and K12b launched by each;
6. warm_restart two lives of
           ``python -m omero_ms_image_region_tpu_torch.server``
           from one YAML (``persistence: {enabled: true, dir: <tmp>}``,
           ``renderer.prewarm: ["4x1024"]``, the three byte caches, the
           provenance header) over the flagship data, ``nvcc`` and ``g++``
           on PATH behind wrappers that log every call.  Life 1 runs from
           the repo: 16 cold tiles and a mask, then SIGTERM; the manifest
           and a flight dump holding ``signal`` and ``warmstate.snapshot``
           must exist.  Life 2 runs from a copy of the package with empty
           ``_build/`` directories, as a deploy lays it down: no compiler
           may build (only ``--version`` runs, for the build store's
           fingerprint), every library comes from the build store
           (``execcache.load`` events, ``imageregion_execcache_*``),
           ``/readyz`` reaches 200 with ``rehydrate: done N/N``, life 1's
           17 GETs answer its bytes from the byte tiers with no group
           dispatched, and 8 re-windowed GETs of re-staged planes are
           raw-cache hits (``hbm_warm``, no ``PixelsService.readRegion``)
           with the plain route's bytes.  Prints each life's seconds to
           ready, the rehydrate's ms and items, the p50 of the repeats and
           of the re-windowed GETs, and the nvidia-smi line.
7. front_cost the host cost the front adds to a GET outside any I/O (a
           trace, 11 spans, admission, the ETag and header decision),
           median of 10,000, with the card's name and power limit.

Each phase's launch counts are set to 0 just before it and read just
after.  It prints the kernel table of all fourteen kernels as one JSON
line (``launches``: the batch burst for K1-K4b, the huffman phase for K5,
the bitpack phase for K6, the workload phases for K7, K8a, K8b and K9, the
e2e run's cold misses for K10, the two ranks of ``mesh_ranks:`` for K12a
and K12b;
``workload_launches``: each
kernel's launches in each of those phases, readers, pyramid, omero,
prefetch, huffman, byte_cache, bitpack, growth, forensics, pressure,
fleet, autoscale and federation (this process's serve leg) included), then the
nvidia-smi line,
and last ``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
F32_OPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
TILE = 1024
PLANE = 8 * TILE
DEVICE = "cuda"
L2_FLUSH_BYTES = 128 << 20   # > the 50 MB L2
SLEEP_CYCLES = 2_000_000     # ~1 ms of GPU sleep ahead of a timed launch
QUALITIES = (85, 90)
# The sparse engine's JPEG kernels (K3, K4a, K4b): the default app's
# device route; K5 serves the Huffman engine (the huffman phase).
SPARSE_WIRE = ("jpeg_coefficients", "sparse_pack", "compact_rows")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def importable(name: str) -> bool:
    try:
        importlib.import_module(name)
        return True
    except ImportError:
        return False


# ------------------------------------------------------------------ timing

def time_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Median of ``reps`` single launches, each timed with CUDA events
    and preceded by an L2 flush outside the timed span.  A GPU sleep
    queued ahead of the start event keeps the card busy while the host
    enqueues the launch, so the span holds the device work alone."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_events(torch, fn, calls: int = 10, tries: int = 5):
    """``(split, counts)`` of the kernels and memsets that ``fn`` launches
    (torch.profiler, L2 warm): device microseconds per call of each, and
    how many of each one call launches.  The profiler now and then records
    no kernel at all, or loses some of a window's events (a count that is
    not a whole number a call); such a window is profiled again, up to
    ``tries`` times (the last window's counts after that)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    split, counts = {}, {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [(e.key.replace("(anonymous namespace)::", "").split("(")[0]
                   .strip(), e) for e in prof.key_averages()
                  if e.self_device_time_total > 0]
        split = {k: e.self_device_time_total / calls for k, e in events}
        counts = {k: e.count / calls for k, e in events}
        if split and all(e.count % calls == 0 for _, e in events):
            break
    return split, counts


def device_split(torch, fn, calls: int = 10, tries: int = 3) -> dict:
    """Device microseconds per call of each kernel and memset that ``fn``
    launches (``device_events``' split): what a kernel's time is made of
    when it is more than one launch."""
    return device_events(torch, fn, calls, tries)[0]


def bytes_bound(n_bytes: float, ops: float = 0.0):
    """Least time for ``n_bytes`` moved and ``ops`` f32 operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def bound(raw, table):
    """Least time for the render on this card: bytes (each input read
    once, each output written once) over HBM bandwidth, against f32
    operations (about 17 per pixel-channel for window, curve, quantize and
    accumulate, 12 per pixel to round, clip and pack) over the f32 rate."""
    B, C, H, W = raw.shape
    n_bytes = (raw.numel() * raw.element_size() + B * H * W * 4
               + B * C * 4 * 5 + table.numel() * 4)
    return bytes_bound(n_bytes, B * H * W * (17 * C + 12))


def byte_diff(got, want):
    import numpy as np
    g = got.cpu().numpy().view(np.uint8).astype(np.int16)
    w = want.cpu().numpy().view(np.uint8).astype(np.int16)
    d = np.abs(g - w)
    return int(d.max()), int((d.reshape(-1, 4).max(axis=1) > 0).sum())


# ------------------------------------------------------------ kernel phase

def kernel_phase(torch, np):
    from omero_ms_image_region_tpu_torch.flagship import (
        flagship_rdef, synthetic_wsi_tiles)
    from omero_ms_image_region_tpu_torch.models.rendering import Family
    from omero_ms_image_region_tpu_torch.ops import render as R
    from omero_ms_image_region_tpu_torch.ops.lut import LutProvider

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    raw_np = synthetic_wsi_tiles(rng, 8, 4, TILE, TILE)
    raw8 = R.raw_to_tensor(raw_np, dev)

    linear = flagship_rdef(4)
    families = flagship_rdef(4)
    for cb, fam, k in zip(families.channel_bindings,
                          (Family.LINEAR, Family.POLYNOMIAL,
                           Family.LOGARITHMIC, Family.EXPONENTIAL),
                          (1.0, 0.7, 1.0, 0.35)):
        cb.family, cb.coefficient = fam, k
    families.channel_bindings[1].reverse_intensity = True
    luts = LutProvider()
    luts.add("smoke.lut", smoke_lut(np))
    lut = flagship_rdef(4)
    lut.channel_bindings[1].lut = "smoke.lut"
    lut_families = flagship_rdef(4)
    for cb, src in zip(lut_families.channel_bindings,
                       families.channel_bindings):
        cb.family, cb.coefficient = src.family, src.coefficient
        cb.reverse_intensity = src.reverse_intensity
    lut_families.channel_bindings[2].lut = "smoke.lut"

    def args_for(rdef, B, provider=None):
        s = R.settings_to_tensors(R.pack_settings(rdef, provider), dev)
        return R.batched_settings(s, B)

    # (kernel, check name, settings, tolerance)
    checks = [("render_ramp", "linear", linear, None, 0),
              ("render_ramp", "families_reversed", families, None, 1),
              ("render_lut", "lut", lut, luts, 1),
              ("render_lut", "lut_families_reversed", lut_families, luts, 1)]
    entries = {}
    for kernel, label, rdef, provider, tol in checks:
        for B in (8, 1):
            raw = raw8[:B].contiguous()
            args = args_for(rdef, B, provider)
            expect_lut = kernel == "render_lut"
            check((args[-1].dim() == 4) == expect_lut,
                  f"{label}: settings did not select {kernel}")
            got = R.render_tile_batch_packed(raw, *args)
            want = R.render_tile_batch_packed_plain(raw, *args)
            torch.cuda.synchronize()
            err, mism = byte_diff(got, want)
            print(f"check {kernel} {label} B={B}: max_abs_diff {err} "
                  f"mismatched_px {mism} (tolerance {tol})", flush=True)
            check(err <= tol, f"{kernel} {label} B={B} disagrees with "
                              f"its plain version: max |diff| {err}")
            e = entries.setdefault(kernel, {
                "name": kernel, "route": "cuda",
                "source": "omero_ms_image_region_tpu_torch/kernels/csrc/"
                          "render.cu",
                "replaces": ("omero_ms_image_region_tpu/experimental/"
                             "pallas_render.py:"
                             + ("256" if expect_lut else "226")),
                "max_abs_err": 0, "max_abs_diff": 0, "mismatched_px": 0,
                "tolerance": tol,
            })
            e["max_abs_err"] = e["max_abs_diff"] = max(e["max_abs_err"],
                                                       err)
            e["mismatched_px"] += mism
            e["tolerance"] = max(e["tolerance"], tol)
            if label in ("linear", "lut"):    # the served settings: timed
                key = "" if B == 8 else "b1_"
                e[key + "ms"] = time_ms(
                    torch, lambda: R.render_tile_batch_packed(raw, *args),
                    25)
                e[key + "plain_ms"] = time_ms(
                    torch,
                    lambda: R.render_tile_batch_packed_plain(raw, *args), 5)
                e[key + "device_us"] = device_split(
                    torch, lambda: R.render_tile_batch_packed(raw, *args))
                e[key + "bound_ms"], e[key + "bound_by"] = bound(
                    raw, args[-1])
                e[key + "bound_us"] = e[key + "bound_ms"] * 1e3
                e[key + "shape"] = list(raw.shape)
    # K1 and K2 on a ragged tile (hw % 8 != 0) and a base that is not
    # 16-byte aligned: their scalar paths.
    unaligned = raw8[1].reshape(-1)[1:1 + 4 * 64 * 64].view(1, 4, 64, 64)
    ragged = R.raw_to_tensor(synthetic_wsi_tiles(rng, 2, 4, 37, 45), dev)
    for kernel, rdef, provider in (("render_ramp", families, None),
                                   ("render_lut", lut_families, luts)):
        for label, raw in (("ragged 37x45", ragged),
                           ("unaligned base", unaligned)):
            args = args_for(rdef, raw.shape[0], provider)
            got = R.render_tile_batch_packed(raw, *args)
            want = R.render_tile_batch_packed_plain(raw, *args)
            err, mism = byte_diff(got, want)
            print(f"check {kernel} {label} {list(raw.shape)}: max_abs_diff "
                  f"{err} mismatched_px {mism} (tolerance 1)", flush=True)
            check(err <= 1, f"{kernel} {label} disagrees with its plain "
                            f"version: max |diff| {err}")
            e = entries[kernel]
            e["max_abs_err"] = e["max_abs_diff"] = max(e["max_abs_err"], err)
            e["mismatched_px"] += mism
    for e in entries.values():
        e["library_ms"] = None    # no single PyTorch call computes this
        e["library_note"] = "no single PyTorch call computes the render"
        print(f"kernel {e['name']}: {e['ms']:.4f} ms at B=8 (bound "
              f"{e['bound_ms']:.4f} ms, plain {e['plain_ms']:.3f} ms); "
              f"{e['b1_ms']:.4f} ms at B=1 (bound {e['b1_bound_ms']:.4f})",
              flush=True)
    return entries, raw8, args_for(linear, 8)


def jpeg_kernel_phase(torch, np, raw8, args8):
    """K3, K4a and K4b against their plain versions on the K1 output of
    the flagship tiles, at B=8 and B=1, q 85 and 90."""
    from omero_ms_image_region_tpu_torch.ops import jpegenc as J
    from omero_ms_image_region_tpu_torch.ops import render as R

    src = "omero_ms_image_region_tpu_torch/kernels/csrc/jpeg.cu"
    jax_ops = "omero_ms_image_region_tpu/ops/jpegenc.py:"
    entries = {name: {"name": name, "route": "cuda", "source": src,
                      "replaces": jax_ops + line, "max_abs_err": 0,
                      "mismatches": 0, "tolerance": 0}
               for name, line in (("jpeg_coefficients", "110"),
                                  ("sparse_pack", "191"),
                                  ("compact_rows", "400"))}
    packed8 = R.render_tile_batch_packed(raw8, *args8)
    for B in (8, 3, 1):
        packed = packed8[:B].contiguous()
        _, H, W = packed.shape
        nb = J.blocks_per_tile(H, W)
        key = "" if B == 8 else "b1_"
        for q in QUALITIES:
            cap = J.default_sparse_cap(H, W, q)
            got = J.packed_to_jpeg_coefficients(packed, q)
            want = J.packed_to_jpeg_coefficients_plain(packed, q)
            torch.cuda.synchronize()
            mism = sum(int((g != w).sum()) for g, w in zip(got, want))
            err = max(int((g.int() - w.int()).abs().max())
                      for g, w in zip(got, want))
            y, cb, cr = got
            wire = J.sparse_pack(y, cb, cr, cap)
            wire_plain = J.sparse_pack_plain(y, cb, cr, cap)
            wire_diff = int((wire != wire_plain).sum())
            comp = J.compact_sparse_rows(wire, B, cap, nb)
            lengths = J.sparse_row_lengths(wire, B, cap, nb)
            comp_plain = J.compact_rows_plain(wire, lengths)
            comp_diff = int((comp != comp_plain).sum())
            # A padding row (n_valid < B) and an overflowing cap too; at
            # B=3 the middle tile's coefficients zeroed (a batch of mixed
            # density) and an all-zero tile alone.
            small = J.sparse_pack(y, cb, cr, 1000)
            small_diff = int((small != J.sparse_pack_plain(
                y, cb, cr, 1000)).sum())
            extra = []
            if B == 3:
                mixed = [t.clone() for t in got]
                for t in mixed:
                    t[1].zero_()
                extra = [("mixed B=3", mixed, cap),
                         ("all-zero", [t[1:2].contiguous() for t in mixed],
                          cap)]
            if B == 8:
                # Four tiles' blocks as one tile of 768 partitions: three
                # steps of K4a's lookback.
                extra = [("wide tile", [t.reshape(2, -1, 64) for t in got],
                          4 * cap)]
            for label, c, cap_x in extra:
                d = int((J.sparse_pack(*c, cap_x)
                         != J.sparse_pack_plain(*c, cap_x)).sum())
                print(f"check sparse_pack {label} {list(c[0].shape)} q{q}: "
                      f"differing bytes {d} (cap {cap_x})", flush=True)
                small_diff += d
            nv = max(B - 1, 0)
            pad_diff = int((J.compact_sparse_rows(wire, nv, cap, nb)
                            != J.compact_rows_plain(wire, J.sparse_row_lengths(
                                wire, nv, cap, nb))).sum())
            totals = wire[:, :4].reshape(-1).view(torch.int32).tolist()
            print(f"check jpeg B={B} q{q}: jpeg_coefficients mismatches "
                  f"{mism} (of {sum(g.numel() for g in got)}, tolerance 0); "
                  f"sparse_pack differing bytes {wire_diff} (cap {cap}; "
                  f"{small_diff} at cap 1000); compact_rows differing bytes "
                  f"{comp_diff} ({pad_diff} with n_valid={nv}); totals "
                  f"{totals}", flush=True)
            check(mism == 0, f"jpeg_coefficients B={B} q{q}: {mism} "
                             f"coefficients differ from the plain version")
            check(wire_diff == 0 and small_diff == 0,
                  f"sparse_pack B={B} q{q} differs from the plain version")
            check(comp_diff == 0 and pad_diff == 0,
                  f"compact_rows B={B} q{q} differs from the plain version")
            e = entries["jpeg_coefficients"]
            e["mismatches"] += mism
            e["max_abs_err"] = max(e["max_abs_err"], err)
            for name, diff in (("sparse_pack", wire_diff + small_diff),
                               ("compact_rows", comp_diff + pad_diff)):
                entries[name]["mismatches"] += diff
                entries[name]["max_abs_err"] = max(
                    entries[name]["max_abs_err"], 255 if diff else 0)
            if q != QUALITIES[0] or B == 3:
                continue
            # Timed at q 85, the default quality's neighbour the flagship
            # serves (codecs.DEFAULT_JPEG_QUALITY).
            used = int(lengths.sum())
            stages = {
                "jpeg_coefficients": (
                    lambda: J.packed_to_jpeg_coefficients(packed, q),
                    lambda: J.packed_to_jpeg_coefficients_plain(packed, q),
                    # packed in, coefficients out, the table block
                    packed.numel() * 4 + sum(t.numel() * 2 for t in got)
                    + 768,
                    # ~16 f32 operations per pixel for colour and
                    # subsampling, 2 x 8 multiply-adds per coefficient
                    B * H * W * 16 + sum(t.numel() for t in got) * 32),
                "sparse_pack": (
                    lambda: J.sparse_pack(y, cb, cr, cap),
                    lambda: J.sparse_pack_plain(y, cb, cr, cap),
                    sum(t.numel() * 2 for t in got) + wire.numel(), 0),
                "compact_rows": (
                    lambda: J.compact_sparse_rows(wire, B, cap, nb),
                    lambda: J.compact_rows_plain(
                        wire, J.sparse_row_lengths(wire, B, cap, nb)),
                    # the used prefixes read, the whole output written
                    # (lengths, rows, zero tail)
                    used + comp.numel(), 0),
            }
            for name, (fn, plain, n_bytes, ops) in stages.items():
                e = entries[name]
                e[key + "ms"] = time_ms(torch, fn, 25)
                e[key + "plain_ms"] = time_ms(torch, plain, 5)
                e[key + "device_us"] = device_split(torch, fn)
                e[key + "bound_ms"], e[key + "bound_by"] = bytes_bound(
                    n_bytes, ops)
                e[key + "bound_bytes"] = n_bytes
                e[key + "shape"] = [B, H, W]
                e[key + "quality"] = q
            entries["sparse_pack"][key + "cap"] = cap
            entries["compact_rows"][key + "used_bytes"] = used
    edge_checks(torch, J, packed8, entries)
    for e in entries.values():
        e["library_ms"] = None
        e["library_note"] = ("no single PyTorch call computes this stage "
                             "of the JPEG wire")
        print(f"kernel {e['name']}: {e['ms']:.4f} ms at B=8 (bound "
              f"{e['bound_ms']:.4f} ms, plain {e['plain_ms']:.3f} ms); "
              f"{e['b1_ms']:.4f} ms at B=1 (bound {e['b1_bound_ms']:.4f})",
              flush=True)
    return entries


def huffman_kernel_phase(torch, np, raw8, args8):
    """K5 (huffman_pack) against its plain version on the K3 coefficients
    of the flagship tiles, every row byte for byte (tolerance 0), and K4b
    with the Huffman row lengths: B=8 and B=1 at q 85 and 92, each with
    the fixed spec and a spec tuned to the tile's own frequencies; an
    all-zero tile; blocks with runs of 16, 32 and 48 zeros (and 62); DC
    differences of category 11; an entry overflow (cap 100: K4b keeps the
    8-byte headers) and a bit overflow (64 words: K5 drops the rest); and
    the seams of K5's chunks (:func:`huffman_chunk_cases`) and ragged last
    chunks (1000^2 and 37 x 45 tiles) at B=8 and B=1."""
    from omero_ms_image_region_tpu_torch import jfif
    from omero_ms_image_region_tpu_torch.kernels import jpeg as KJ
    from omero_ms_image_region_tpu_torch.ops import jpegenc as J
    from omero_ms_image_region_tpu_torch.ops import render as R

    src = "omero_ms_image_region_tpu_torch/kernels/csrc/jpeg.cu"
    e = {"name": "huffman_pack", "route": "cuda", "source": src,
         "replaces": "omero_ms_image_region_tpu/ops/jpegenc.py:991",
         "max_abs_err": 0, "mismatches": 0, "tolerance": 0, "cases": 0}
    k4b = {}
    packed8 = R.render_tile_batch_packed(raw8, *args8)
    _, H, W = packed8.shape
    h16, w16 = H // 16, W // 16
    fixed = J.spec_tensor(J.huffman_spec_arrays(), "cuda")

    def compare(label, c, spec, cap, cw, h16=h16, w16=w16):
        got = J.huffman_pack(*c, cw, spec, h16, w16)
        want = J.huffman_pack_plain(*c, cw, spec, h16, w16)
        torch.cuda.synchronize()
        diff = int((got != want).sum())
        B = c[0].shape[0]
        comp_diff = 0
        for n_valid in (B, max(B - 1, 0)):
            comp = J.compact_huffman_rows(got, n_valid, cap, cw)
            comp_diff += int((comp != J.compact_rows_plain(
                got, J.huffman_row_lengths(got, n_valid, cap, cw))).sum())
        hdr = got[:, :8].reshape(-1).view(torch.int32).reshape(B, 2)
        over = [int(t) > cap or int(b) > 32 * cw for t, b in hdr.tolist()]
        print(f"check huffman_pack {label} B={B}: differing bytes {diff} "
              f"(rows of {got.shape[1]}), compact_rows (Huffman lengths) "
              f"differing bytes {comp_diff}; totals "
              f"{hdr[:, 0].tolist()} bits {hdr[:, 1].tolist()} over "
              f"{over}", flush=True)
        check(diff == 0, f"huffman_pack {label} B={B} differs from the "
                         f"plain version")
        check(comp_diff == 0, f"compact_rows (Huffman) {label} B={B} "
                              f"differs from the plain version")
        e["mismatches"] += diff
        e["max_abs_err"] = max(e["max_abs_err"], 255 if diff else 0)
        e["cases"] += 1
        return got, over

    for B in (8, 1):
        packed = packed8[:B].contiguous()
        key = "" if B == 8 else "b1_"
        for q in (85, 92):
            c = J.packed_to_jpeg_coefficients(packed, q)
            cap, cw = J.default_sparse_cap(H, W, q), J.default_words_cap(
                H, W, q)
            tuned8 = jfif.tuned_huffman_spec(*jfif.symbol_frequencies(
                *(t[0].cpu().numpy() for t in c)))
            tuned = J.spec_tensor(J.spec_kernel_arrays(tuned8), "cuda")
            wire, over = compare(f"q{q} fixed", c, fixed, cap, cw)
            compare(f"q{q} tuned", c, tuned, cap, cw)
            check(not any(over), f"huffman_pack q{q}: a flagship tile "
                                 f"overflowed its budgets")
            if q != 85:
                continue
            # Timed at q 85 with the fixed spec, as the engine opens.
            bits = wire[:, 4:8].reshape(-1).view(torch.int32).to(
                torch.int64)
            used = int((8 + 4 * ((bits + 31) // 32)).sum())
            coeff_bytes = sum(t.numel() * 2 for t in c)
            e[key + "ms"] = time_ms(torch, lambda: J.huffman_pack(
                *c, cw, fixed, h16, w16), 25)
            e[key + "plain_ms"] = time_ms(torch, lambda: J.huffman_pack_plain(
                *c, cw, fixed, h16, w16), 5)
            e[key + "device_us"] = device_split(torch, lambda: J.huffman_pack(
                *c, cw, fixed, h16, w16))
            # the coefficients and the spec read, the used words written
            e[key + "bound_ms"], e[key + "bound_by"] = bytes_bound(
                coeff_bytes + 4096 + used)
            e[key + "bound_bytes"] = coeff_bytes + 4096 + used
            e[key + "used_bytes"] = used
            e[key + "shape"] = [B, H, W]
            e[key + "quality"] = q
            e[key + "cap_words"] = cw
            k4b[key + "ms"] = time_ms(torch, lambda: J.compact_huffman_rows(
                wire, B, cap, cw), 25)
            k4b[key + "plain_ms"] = time_ms(
                torch, lambda: J.compact_rows_plain(
                    wire, J.huffman_row_lengths(wire, B, cap, cw)), 5)
            # the used prefixes read, the whole output written
            k4b[key + "bound_ms"], k4b[key + "bound_by"] = bytes_bound(
                used + 4 * B + wire.numel())
            k4b[key + "used_bytes"] = used

    # Synthetic content on B=1 q 85 coefficients.
    q = 85
    base = J.packed_to_jpeg_coefficients(packed8[:1].contiguous(), q)
    cap, cw = J.default_sparse_cap(H, W, q), J.default_words_cap(H, W, q)
    zeros = [torch.zeros_like(t) for t in base]
    got, _ = compare("all-zero tile", zeros, fixed, cap, cw)
    check(got[0, :4].view(torch.int32).item() == 0,
          "huffman_pack: an all-zero tile has nonzero entries")
    runs = [t.clone() for t in base]
    y, cb, cr = runs
    y[:, ::3, 1:] = 0
    y[:, ::6, 17] = 5             # a run of 16
    y[:, ::6, 50] = -3            # then 32
    y[:, 3::6, 49] = -7           # a run of 48
    y[:, 3::6, 63] = 2            # no EOB after position 63
    cb[:, ::2, 1:] = 0
    cb[:, ::2, 63] = 9            # a run of 62: three ZRL codes
    compare("zero runs 16/32/48/62", runs, fixed, cap, cw)
    dc = [t.clone() for t in base]
    dc[0][:, ::2, 0] = 1000
    dc[0][:, 1::2, 0] = -1000     # differences of 2000: category 11
    dc[1][:, ::2, 0] = -1020
    dc[1][:, 1::2, 0] = 1020
    compare("DC category 11", dc, fixed, cap, cw)
    c8 = J.packed_to_jpeg_coefficients(packed8, q)
    _, over = compare("entry overflow (cap 100)", c8, fixed, 100, cw)
    check(all(over), "huffman_pack: cap 100 did not overflow every row")
    _, over = compare("bit overflow (64 words)", c8, fixed, cap, 64)
    check(all(over), "huffman_pack: 64 words did not overflow every row")
    huffman_chunk_cases(torch, J, compare, c8, fixed, cap, cw, h16, w16)
    # A ragged last chunk: 1000^2 tiles (63 x 63 MCUs, 23,814 blocks:
    # 186 whole chunks and one of 6 blocks) and 37 x 45 (9 MCUs, 54
    # blocks: one chunk), at B=8 and B=1.
    for hh, ww in ((1000, 1000), (37, 45)):
        for B in (8, 1):
            c = J.packed_to_jpeg_coefficients(
                packed8[:B, :hh, :ww].contiguous(), q)
            gh, gw = hh + (-hh) % 16, ww + (-ww) % 16
            blocks = 6 * (gh * gw // 256)
            check(blocks % KJ.HUFF_CHUNK_BLOCKS != 0,
                  f"{hh}x{ww}: no ragged last chunk")
            compare(f"ragged last chunk {hh}x{ww} ({blocks} blocks)", c,
                    fixed, J.default_sparse_cap(gh, gw, q),
                    J.default_words_cap(gh, gw, q), h16=gh // 16,
                    w16=gw // 16)
    e["library_ms"] = None
    e["library_note"] = ("no single PyTorch call packs a Huffman stream")
    print(f"kernel huffman_pack: {e['ms']:.4f} ms at B=8 (bound "
          f"{e['bound_ms']:.4f} ms, plain {e['plain_ms']:.3f} ms, device "
          f"us {json.dumps(e['device_us'])}); {e['b1_ms']:.4f} ms at B=1 "
          f"(bound {e['b1_bound_ms']:.4f}, device us "
          f"{json.dumps(e['b1_device_us'])}); {e['cases']} cases equal; "
          f"its launches on the Huffman engine's serve are the huffman "
          f"line's k5_launches", flush=True)
    print("kernel compact_rows (Huffman lengths): " + json.dumps(k4b),
          flush=True)
    return {"huffman_pack": e}, k4b


def huffman_chunk_cases(torch, J, compare, c8, fixed, cap, cw, h16, w16):
    """K5's chunk seams, each whole row byte for byte against the plain
    version at B=8 and B=1: fields at the chunk seams of the flagship
    tiles (the seams where a field straddles the word two chunks share
    are counted, and there must be some); a row whose bits cross
    cap_words inside a chunk, away from its seams; and blocks of maximal
    magnitudes (every AC coefficient +-1023, size 10, DC differences of
    category 11: the most bits a block codes), with room for the whole
    stream and at the flagship budget."""
    from omero_ms_image_region_tpu_torch.kernels import jpeg as KJ

    chunk = KJ.HUFF_CHUNK_BLOCKS
    _, _, val, length, start, bstart = J.huffman_fields_plain(
        *c8, fixed, h16, w16)
    live = length > 0
    end = start + length
    seams = bstart[:, chunk::chunk]                        # [B, chunks - 1]
    # A seam's first field crosses out of the shared word, or the field
    # before it crosses into it.
    cross = live & ((end - 1) >> 5 != start >> 5)
    straddle = 0
    for b in range(seams.shape[0]):
        s = seams[b][seams[b] % 32 != 0]
        straddle += int((torch.isin(s, start[b][cross[b]])
                         | torch.isin(s, end[b][cross[b]])).sum())
    print(f"check huffman_pack chunk seams: {seams.numel()} seams of "
          f"{chunk} blocks, {straddle} with a field straddling the word "
          f"two chunks share", flush=True)
    check(straddle > 0, "huffman_pack: no field straddles a chunk seam")
    for B in (8, 1):
        c = [t[:B].contiguous() for t in c8]
        compare("chunk seams", c, fixed, cap, cw)
        # 32 cap_words within a word of the bit start of the middle block
        # of tile 0's middle chunk, 48 blocks from either seam
        mid = bstart[0, (bstart.shape[1] // chunk // 2) * chunk + chunk // 2]
        cw_mid = int(mid) // 32 + 1
        _, over = compare(f"bits cross cap_words mid-chunk ({cw_mid} "
                          f"words)", c, fixed, cap, cw_mid)
        check(over[0], "huffman_pack: the mid-chunk budget did not "
                       "overflow tile 0")
        big = [torch.where(torch.arange(64, device=t.device) % 2 == 0,
                           1023, -1023).to(torch.int16).expand_as(t[:B])
               .contiguous() for t in c8]
        for t in big:
            t[:, ::2, 0] = 1000
            t[:, 1::2, 0] = -1000
        bits_max = int(J.huffman_fields_plain(*big, fixed, h16, w16)[1].max())
        _, over = compare("maximal magnitudes, whole stream", big, fixed,
                          64 * 10 ** 6, bits_max // 32 + 1)
        check(not any(over), "huffman_pack: the whole-stream budget "
                             "overflowed")
        compare("maximal magnitudes, flagship budget", big, fixed, cap, cw)
        # Bases 2 bytes past 16-byte alignment: the 16-bit loads.
        odd = []
        for t in c:
            buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
            odd.append(buf[1:1 + t.numel()].view_as(t))
            odd[-1].copy_(t)
        compare("unaligned bases", odd, fixed, cap, cw)


def edge_checks(torch, J, packed8, entries):
    """K3's other paths and K4b's edge cases, each against its plain
    version with tolerance 0: K3 flipped h, v and hv at B=8; a ragged
    1000x1000 tile in its 1008^2 frame; a 37x45 tile; 512^2 tiles on a
    1024^2 frame; a base 4 bytes past a 16-byte boundary.  K4b at B=8
    with n_valid 8, 5 and 0 on a wire whose cap some rows overflow and
    whose width is not a multiple of 16."""
    q = QUALITIES[0]
    flat = packed8[:2].reshape(-1)
    k3_cases = [(f"flip {f}", packed8, None, "h" in f, "v" in f)
                for f in ("h", "v", "hv")]
    k3_cases += [
        ("ragged 1000x1000", packed8[:2, :1000, :1000].contiguous(), None,
         False, False),
        ("ragged 1000x1000 flip hv", packed8[:2, :1000, :1000].contiguous(),
         None, True, True),
        ("37x45", packed8[:3, 100:137, 200:245].contiguous(), None, True,
         False),
        ("512^2 on a 1024^2 frame", packed8[:2, :512, :512].contiguous(),
         (1024, 1024), False, True),
        ("unaligned base", flat[1:1 + 2 * 1020 * 1024].view(2, 1020, 1024),
         None, True, False),
    ]
    e = entries["jpeg_coefficients"]
    for label, packed, grid, fh, fv in k3_cases:
        gh, gw = grid or (None, None)
        got = J.packed_to_jpeg_coefficients(packed, q, gh, gw, fh, fv)
        want = J.packed_to_jpeg_coefficients_plain(packed, q, gh, gw, fh,
                                                   fv)
        mism = sum(int((g != w).sum()) for g, w in zip(got, want))
        print(f"check jpeg_coefficients {label} {list(packed.shape)} "
              f"q{q}: mismatches {mism} (tolerance 0)", flush=True)
        check(mism == 0, f"jpeg_coefficients {label}: {mism} coefficients "
                         f"differ from the plain version")
        e["mismatches"] += mism

    y, cb, cr = J.packed_to_jpeg_coefficients(packed8, q)
    _, H, W = packed8.shape
    nb = J.blocks_per_tile(H, W)
    totals = sorted(J.sparse_pack(y, cb, cr, 1)[:, :4].reshape(-1)
                    .view(torch.int32).tolist())
    cap = (totals[3] + totals[4]) // 2     # rows 0..3 of the sort fit
    while (4 + nb + (J.ENTRY_BITS * cap + 7) // 8) % 16 == 0:
        cap += 1
    wire = J.sparse_pack(y, cb, cr, cap)
    over = int((wire[:, :4].reshape(-1).view(torch.int32) > cap).sum())
    e = entries["compact_rows"]
    for nv in (8, 5, 0):
        d = int((J.compact_sparse_rows(wire, nv, cap, nb)
                 != J.compact_rows_plain(wire, J.sparse_row_lengths(
                     wire, nv, cap, nb))).sum())
        print(f"check compact_rows B=8 n_valid={nv} cap {cap} (width "
              f"{wire.shape[1]}, {over} rows over the cap): differing "
              f"bytes {d} (tolerance 0)", flush=True)
        check(d == 0, f"compact_rows n_valid={nv} differs from the plain "
                      f"version")
        e["mismatches"] += d


def flagship_packed(torch, np, B: int, seed: int = 0):
    """K1's output (linear flagship settings) for B synthetic 1024^2
    4-channel uint16 tiles, and the raw tiles and settings on the card."""
    from omero_ms_image_region_tpu_torch.flagship import (
        flagship_rdef, synthetic_wsi_tiles)
    from omero_ms_image_region_tpu_torch.ops import render as R

    raw = R.raw_to_tensor(synthetic_wsi_tiles(
        np.random.default_rng(seed), B, 4, TILE, TILE), "cuda")
    args = R.batched_settings(R.settings_to_tensors(
        R.pack_settings(flagship_rdef(4)), "cuda"), B)
    return R.render_tile_batch_packed(raw, *args), raw, args


def dc_pred_pos(g: int) -> int:
    """The scan position whose DC the block at scan position g is coded
    against (Y1..Y3 the Y before, Y0 the previous MCU's Y3, Cb and Cr one
    MCU back), or -1 in the first MCU."""
    m, slot = divmod(g, 6)
    if 1 <= slot <= 3:
        return g - 1
    return g - (6 if slot else 3) if m > 0 else -1


def bitpack_crafted(torch, J, base, scan, cw, chunk: int) -> list:
    """The inputs that choose between K6's two paths (as
    tests/test_torch_bitpack.py makes them at 256^2), on B=2 flagship
    coefficients ``base`` with ``scan`` (i32[n_mcu, 6]) and chunks of
    ``chunk`` blocks: clamps of negative amplitude (values below -2047,
    whose sign bits JAX adds into the words before the field) in chunk 1
    only and in the first block of chunks 1-4 (their spill reaches the
    previous chunk's last word), each tile's last block re-coded so that
    its stream ends on a word boundary, and B=3 tiles of different
    lengths (a flagship tile, an all-zero one, a clamped one)."""
    import itertools

    flat = scan.reshape(-1).tolist()
    one = base.clone()
    g = chunk + chunk // 2
    one[:, flat[g], 5] = -3000
    one[:, flat[g + 1], 0] = one[:, flat[dc_pred_pos(g + 1)], 0] - 2500
    start = base.clone()
    for k in range(1, 5):
        g = k * chunk
        pred = start[:, flat[dc_pred_pos(g)], 0]
        start[:, flat[g], 0] = pred - torch.tensor(
            [2900, 2049 + k], dtype=pred.dtype, device=pred.device)
    word = base.clone()
    last, prev = flat[-1], flat[dc_pred_pos(len(flat) - 1)]
    word[:, last, 1:] = 0
    word[:, last, 0] = word[:, prev, 0]
    spec = J.huffman_spec_arrays()
    _, bits = J.bitpack_fixed_plain(word, scan, *spec, cw)
    field = {s: int(spec[3][s]) + s for s in range(1, 11)}
    for b, total in enumerate(bits.tolist()):
        combo = next(c for n in range(5)
                     for c in itertools.combinations_with_replacement(
                         range(1, 11), n)
                     if sum(field[s] for s in c) % 32 == -total % 32)
        for k, s in enumerate(combo, start=1):
            word[b, last, k] = 1 << (s - 1)
    b3 = torch.cat([base[:1], torch.zeros_like(base[:1]), one[1:]])
    return [("clamp in chunk 1 only", one),
            ("clamps first in chunks 1-4", start),
            ("streams ending on a word", word),
            ("B=3 of different lengths", b3)]


def bitpack_kernel_phase(torch, np, raw8, args8):
    """K6 (bitpack_fixed) against its plain version, words and total
    bits exactly (tolerance 0): the K3 coefficients of the flagship tiles
    at B=8 and B=1, q 85 and 95, at the encoder's capacity; an overflow
    (64 words a tile at q 95: the words below the cap equal, each tile's
    words unspilled into the next tile's); an all-zero tile; runs of 16,
    32, 48 and 62 zeros; DC differences of 2048 and more (the category-11
    clamp, whose sign bits JAX adds into the stream); a base 2 bytes past
    alignment (the 16-bit loads); blocks of 63 category-10 coefficients
    (their words pass the chunk's rows: the exact path without a spill);
    the inputs that choose between the kernel's two paths
    (``bitpack_crafted``); the kernel launched into outputs between
    guard words (a store outside words, total bits or its status words
    shows); 50 calls back to back on one
    stream over a flagship tile, an all-zero one and a clamped one in
    turn (each output copied and freed, so the next call's words reuse
    its memory: a stale epoch or a word left unstored shows), then 10 on
    a second stream beside 10 on the first; and B=16 (the flagship tiles
    and their flipped copies).  Timed at q 85, B=8, B=1 and B=16, beside
    its plain version; no PyTorch call packs a Huffman stream."""
    from omero_ms_image_region_tpu_torch.kernels import jpeg as KJ
    from omero_ms_image_region_tpu_torch.kernels.scratch import (
        status_scratch)
    from omero_ms_image_region_tpu_torch.ops import jpegenc as J
    from omero_ms_image_region_tpu_torch.ops import render as R

    packed8 = R.render_tile_batch_packed(raw8, *args8)
    e = {"name": "bitpack_fixed", "route": "cuda",
         "source": "omero_ms_image_region_tpu_torch/kernels/csrc/jpeg.cu",
         "replaces": "omero_ms_image_region_tpu/ops/jpegenc.py:833",
         "max_abs_err": 0, "mismatches": 0, "tolerance": 0, "cases": 0}
    _, H, W = packed8.shape
    scan = J.scan_index_tensor(H // 16, W // 16, packed8.device)
    spec = J.huffman_spec_arrays()

    def join(c):
        B = c[0].shape[0]
        return torch.cat([t.reshape(B, -1, 64) for t in c], dim=1)

    def compare(label, blocks, cw):
        got_w, got_b = J.bitpack_fixed(blocks, scan, *spec, cw)
        want_w, want_b = J.bitpack_fixed_plain(blocks, scan, *spec, cw)
        torch.cuda.synchronize()
        diff = int((got_w != want_w).sum())
        bdiff = int((got_b != want_b).sum())
        bits = got_b.tolist()
        over = [b > 32 * cw for b in bits]
        print(f"check bitpack_fixed {label} B={blocks.shape[0]}: differing "
              f"words {diff} of {got_w.numel()} ({cw} a tile), differing "
              f"total_bits {bdiff}; bits {bits} over {over}", flush=True)
        check(diff == 0 and bdiff == 0,
              f"bitpack_fixed {label} differs from the plain version")
        e["cases"] += 1
        return got_w, got_b, over

    def timed(key, blocks, cw, q):
        bits = J.bitpack_fixed(blocks, scan, *spec, cw)[1]
        used = int(((bits.to(torch.int64) + 31) // 32 * 4).sum())
        n_bytes = blocks.numel() * 2 + scan.numel() * 4 + 4096 + used
        e[key + "ms"] = time_ms(torch, lambda: J.bitpack_fixed(
            blocks, scan, *spec, cw), 25)
        e[key + "plain_ms"] = time_ms(torch, lambda: J.bitpack_fixed_plain(
            blocks, scan, *spec, cw), 5)
        e[key + "device_us"], counts = device_events(
            torch, lambda: J.bitpack_fixed(blocks, scan, *spec, cw), tries=5)
        # One launch a call and no memset, as the profiler saw them.
        e[key + "launches_per_call"] = sum(counts.values())
        e[key + "device_events"] = counts
        check(e[key + "launches_per_call"] == 1
              and not any("memset" in k.lower() for k in counts),
              f"bitpack_fixed {key}launches per call: {counts}, not one "
              f"kernel and no memset")
        # the coefficients, the scan map and the spec read, the used
        # words written
        e[key + "bound_ms"], e[key + "bound_by"] = bytes_bound(n_bytes)
        e[key + "bound_bytes"] = n_bytes
        e[key + "used_bytes"] = used
        e[key + "shape"] = [blocks.shape[0], H, W]
        e[key + "quality"] = q
        e[key + "cap_words"] = cw

    for B in (8, 1):
        packed = packed8[:B].contiguous()
        key = "" if B == 8 else "b1_"
        for q in (85, 95):
            blocks = join(J.packed_to_jpeg_coefficients(packed, q))
            cw = J.BitpackJpegEncoder(H, W, q).cap_words
            words, bits, over = compare(f"q{q}", blocks, cw)
            check(not any(over), f"bitpack_fixed q{q}: a flagship tile "
                                 f"overflowed the encoder's capacity")
            if q == 95:
                _, _, over = compare("overflow (64 words) q95", blocks, 64)
                check(all(over), "bitpack_fixed: 64 words did not "
                                 "overflow every tile")
                continue
            timed(key, blocks, cw, q)
    base = join(J.packed_to_jpeg_coefficients(packed8[:2].contiguous(), 85))
    cw = J.BitpackJpegEncoder(H, W, 85).cap_words
    compare("all-zero tile", torch.zeros_like(base[:1]), cw)
    runs = base.clone()
    runs[:, ::3, 1:] = 0
    runs[:, ::6, 17] = 5             # a run of 16
    runs[:, ::6, 50] = -3            # then 32
    runs[:, 3::6, 49] = -7           # a run of 48
    runs[:, 3::6, 63] = 2            # no EOB after position 63
    runs[:, 1::6, 1:] = 0
    runs[:, 1::6, 63] = 9            # a run of 62: three ZRL codes
    compare("zero runs 16/32/48/62", runs, cw)
    dc = base.clone()
    dc[:, ::2, 0] = 2047
    dc[:, 1::2, 0] = -2047           # differences of +-4094: clamped
    dc[:, ::7, 0] = 1024             # and of 3071, 2048, ...
    compare("DC differences >= 2048", dc, cw)
    odd = torch.empty(base.numel() + 8, dtype=base.dtype,
                      device=base.device)
    odd = odd[1:1 + base.numel()].view_as(base)
    odd.copy_(base)
    compare("unaligned base", odd, cw)
    dense = base.clone()
    dense[:, :, 1:] = 600            # 26-bit fields: over a chunk's rows
    compare("maximal blocks", dense, 1 << 16)
    crafted = bitpack_crafted(torch, J, base, scan, cw,
                              KJ.BIT_CHUNK_BLOCKS)
    for label, blocks in crafted:
        _, bits, _ = compare(label, blocks, cw)
        if label.startswith("streams"):
            check(all(b % 32 == 0 for b in bits.tolist()),
                  "bitpack_fixed: a stream does not end on a word")
        if label.startswith("B=3"):
            check(len(set(bits.tolist())) == 3,
                  "bitpack_fixed: the B=3 lengths are not distinct")

    # Stores stay inside the outputs: the kernel launched as the wrapper
    # launches it, into words and total bits that lie between guard words
    # of 0x5A5A5A5A, and the status scratch past this call's chunks kept.
    lib, spec_t, G = KJ.library(), J.spec_tensor(spec, base.device), 4096
    strays = 0
    for label, blocks, gcw in [("q85 B=2", base, cw),
                               ("maximal blocks at 64 words", dense, 64),
                               *((lb, bl, cw) for lb, bl in crafted)]:
        B, nb = blocks.shape[:2]
        buf = torch.full((3 * G + B * gcw + B,), 0x5A5A5A5A,
                         dtype=torch.int32, device=base.device)
        words = buf[G:G + B * gcw].view(B, gcw)
        bits = buf[2 * G + B * gcw:2 * G + B * gcw + B]
        guards = torch.cat([buf[:G], buf[G + B * gcw:2 * G + B * gcw],
                            buf[2 * G + B * gcw + B:]])
        chunks = lib.bitpack_fixed_status_words(B, nb)
        stream = torch.cuda.current_stream().cuda_stream
        status, epoch = status_scratch(base.device, stream, chunks)
        rest = status[chunks:].clone()
        err = lib.bitpack_fixed_launch(
            blocks.data_ptr(), B, nb, scan.data_ptr(), spec_t.data_ptr(),
            gcw, words.data_ptr(), bits.data_ptr(), status.data_ptr(),
            status.numel(), epoch, stream)
        check(err == 0, f"bitpack_fixed guarded {label}: CUDA error {err}")
        want_w, want_b = J.bitpack_fixed_plain(blocks, scan, *spec, gcw)
        torch.cuda.synchronize()
        stray = int((guards != 0x5A5A5A5A).sum()) + int(
            (status[chunks:] != rest).sum())
        diff = int((words != want_w).sum()) + int((bits != want_b).sum())
        strays += stray
        print(f"check bitpack_fixed guarded {label}: guard and scratch "
              f"words changed {stray}, differing words and bits {diff}",
              flush=True)
        check(stray == 0 and diff == 0,
              f"bitpack_fixed stored outside its outputs on {label}")
    e["guard_words_changed"] = strays
    e["cases"] += 1

    # Back to back, then on two streams: each output copied and dropped.
    turns = [base[:1].contiguous(), torch.zeros_like(base[:1]),
             crafted[0][1][1:].contiguous()]
    wants = [J.bitpack_fixed_plain(t, scan, *spec, cw) for t in turns]

    def call(i, kept):
        w, bits = J.bitpack_fixed(turns[i % 3], scan, *spec, cw)
        kept.append((i % 3, w.clone(), bits.clone()))

    kept = []
    for i in range(50):
        call(i, kept)
    second = torch.cuda.Stream()
    second.wait_stream(torch.cuda.current_stream())
    for i in range(10):
        call(i, kept)
        with torch.cuda.stream(second):
            call(i + 1, kept)
    torch.cuda.synchronize()
    bad = sum(int((w != wants[t][0]).sum()) + int((bits != wants[t][1]).sum())
              for t, w, bits in kept)
    e["repeat_calls"] = len(kept)
    e["repeat_differing"] = bad
    print(f"check bitpack_fixed repeated: {len(kept)} calls (50 on one "
          f"stream, then 10 on each of two), differing words and bits "
          f"{bad}", flush=True)
    check(bad == 0, "bitpack_fixed differs on repeated or concurrent calls")
    e["cases"] += 1
    del kept

    c85 = J.packed_to_jpeg_coefficients(packed8, 85)
    flipped = J.packed_to_jpeg_coefficients(packed8, 85, flip_h=True,
                                            flip_v=True)
    b16 = torch.cat([join(c85), join(flipped)])
    compare("B=16 (flagship tiles and their flips)", b16, cw)
    timed("b16_", b16, cw, 85)
    e["library_ms"] = None
    e["library_note"] = "no PyTorch call packs a Huffman stream"
    print(f"kernel bitpack_fixed: {e['ms']:.4f} ms at B=8 (bound "
          f"{e['bound_ms']:.4f} ms, plain {e['plain_ms']:.3f} ms, device "
          f"us {json.dumps(e['device_us'])}); {e['b1_ms']:.4f} ms at B=1 "
          f"(bound {e['b1_bound_ms']:.4f}, plain {e['b1_plain_ms']:.3f}, "
          f"device us {json.dumps(e['b1_device_us'])}); {e['b16_ms']:.4f} "
          f"ms at B=16 (bound {e['b16_bound_ms']:.4f}); launches a call "
          f"{e['launches_per_call']:g} / {e['b1_launches_per_call']:g} / "
          f"{e['b16_launches_per_call']:g} (profiled); "
          f"{e['cases']} cases equal", flush=True)
    return {"bitpack_fixed": e}


def b16_kernel_phase(torch, np) -> dict:
    """K1, K3, K4a, K4b and K5 against their plain versions at B = 16,
    the largest group batch growth launches (2 x max-batch): 16 flagship
    tiles (128 MiB of uint16), K1 exactly on linear settings, K3 at q 85,
    K4a and K4b (sparse rows), K5 and K4b (Huffman rows) byte for byte;
    each kernel's ms at B=16 (25 launches, L2 flushed)."""
    from omero_ms_image_region_tpu_torch.ops import jpegenc as J
    from omero_ms_image_region_tpu_torch.ops import render as R

    q = 85
    packed, raw, args = flagship_packed(torch, np, 16, seed=16)
    B, H, W = packed.shape
    out = {"B": B, "shape": [B, 4, H, W], "quality": q}
    want = R.render_tile_batch_packed_plain(raw, *args)
    out["render_ramp_mismatched_px"] = byte_diff(packed, want)[1]
    c = J.packed_to_jpeg_coefficients(packed, q)
    cp = J.packed_to_jpeg_coefficients_plain(packed, q)
    out["jpeg_coefficients_mismatches"] = sum(
        int((g != w).sum()) for g, w in zip(c, cp))
    del want, cp
    nb = J.blocks_per_tile(H, W)
    cap = J.default_sparse_cap(H, W, q)
    wire = J.sparse_pack(*c, cap)
    out["sparse_pack_differing_bytes"] = int(
        (wire != J.sparse_pack_plain(*c, cap)).sum())
    out["compact_rows_differing_bytes"] = int(
        (J.compact_sparse_rows(wire, B, cap, nb) != J.compact_rows_plain(
            wire, J.sparse_row_lengths(wire, B, cap, nb))).sum())
    cw = J.default_words_cap(H, W, q)
    spec = J.spec_tensor(J.huffman_spec_arrays(), "cuda")
    hw = J.huffman_pack(*c, cw, spec, H // 16, W // 16)
    out["huffman_pack_differing_bytes"] = int(
        (hw != J.huffman_pack_plain(*c, cw, spec, H // 16, W // 16)).sum())
    out["compact_rows_huffman_differing_bytes"] = int(
        (J.compact_huffman_rows(hw, B, cap, cw) != J.compact_rows_plain(
            hw, J.huffman_row_lengths(hw, B, cap, cw))).sum())
    bad = {k: v for k, v in out.items()
           if k.endswith(("mismatched_px", "mismatches", "differing_bytes"))
           and v}
    out["ms"] = {
        "render_ramp": time_ms(torch, lambda: R.render_tile_batch_packed(
            raw, *args), 25),
        "jpeg_coefficients": time_ms(
            torch, lambda: J.packed_to_jpeg_coefficients(packed, q), 25),
        "sparse_pack": time_ms(torch, lambda: J.sparse_pack(*c, cap), 25),
        "compact_rows": time_ms(torch, lambda: J.compact_sparse_rows(
            wire, B, cap, nb), 25),
        "huffman_pack": time_ms(torch, lambda: J.huffman_pack(
            *c, cw, spec, H // 16, W // 16), 25),
    }
    print("b16: " + json.dumps(out), flush=True)
    check(not bad, f"b16: kernels differ from their plain versions at "
                   f"B=16: {bad}")
    return out


def smoke_lut(np):
    """A fixed 256x3 LUT (a fire-like ramp), as uint8."""
    ramp = np.arange(256)
    return np.stack([np.minimum(255, ramp * 3),
                     np.clip(ramp * 3 - 255, 0, 255),
                     np.clip(ramp * 3 - 510, 0, 255)], axis=-1).astype(
        np.uint8)


# ------------------------------------------------- workload kernels phase

WL_SOURCE = "omero_ms_image_region_tpu_torch/kernels/csrc/workloads.cu"
Z_STACK = 32                 # planes of the smoke's Z-stack


def workloads_kernel_phase(torch, np):
    """K7, K8a and K8b against their plain versions, byte for byte
    (``array_equal``, NaN equal to NaN), at the sizes the new phases give
    them, with the edge cases listed in the module docstring; each timed
    as the others are."""
    from omero_ms_image_region_tpu_torch.flagship import synthetic_wsi_tiles
    from omero_ms_image_region_tpu_torch.kernels import workloads as KW
    from omero_ms_image_region_tpu_torch.ops import maskops as M
    from omero_ms_image_region_tpu_torch.ops import projection as P

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    entries = {
        "project_fold": {"name": "project_fold", "route": "cuda",
                         "source": WL_SOURCE,
                         "replaces": "omero_ms_image_region_tpu/ops/"
                                     "projection.py:178",
                         "max_abs_err": 0, "mismatches": 0,
                         "tolerance": 0},
        "mask_rasterize": {"name": "mask_rasterize", "route": "cuda",
                           "source": WL_SOURCE,
                           "replaces": "omero_ms_image_region_tpu/ops/"
                                       "maskops.py:143",
                           "max_abs_err": 0, "mismatches": 0,
                           "tolerance": 0},
        "mask_overlay": {"name": "mask_overlay", "route": "cuda",
                         "source": WL_SOURCE,
                         "replaces": "omero_ms_image_region_tpu/ops/"
                                     "maskops.py:197",
                         "max_abs_err": 0, "mismatches": 0,
                         "tolerance": 0},
    }

    def tally(name, got, want, label):
        g, w = got.cpu().numpy(), want.cpu().numpy()
        same = np.array_equal(g, w, equal_nan=True)
        diff = int((~((g == w) | (np.isnan(g) & np.isnan(w)))).sum()
                   if g.dtype.kind == "f" else (g != w).sum())
        err = (0.0 if same else float(np.nanmax(np.abs(
            g.astype(np.float64) - w.astype(np.float64)))))
        print(f"check {name} {label}: differing {diff} of {g.size} "
              f"(tolerance 0)", flush=True)
        check(same, f"{name} {label} differs from its plain version")
        e = entries[name]
        e["mismatches"] += diff
        e["max_abs_err"] = max(e["max_abs_err"], err)

    # K7: (label, chunk [zc, h, W], out shape, y0, first/finalize cases)
    def stack_of(dtype, zc, h, w):
        if dtype == np.uint16:
            return np.stack([synthetic_wsi_tiles(rng, 1, 1, h, w)[0, 0]
                             for _ in range(zc)])
        if np.dtype(dtype).kind == "f":
            x = rng.normal(0, 1000, size=(zc, h, w)).astype(dtype)
            x[1, ::7] = np.nan              # NaN rows in two planes
            x[zc - 1, :, ::5] = np.nan
            return x
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, size=(zc, h, w),
                            endpoint=True).astype(dtype)

    cases = [("u16 zc=32 1024^2", np.uint16, Z_STACK, TILE, TILE, TILE, 0),
             ("u16 zc=1", np.uint16, 1, TILE, TILE, TILE, 0),
             ("u16 256-row band at y0=512", np.uint16, 8, 256, TILE,
              TILE, 512),
             ("u16 h=1000", np.uint16, 8, 1000, TILE, TILE, 0),
             ("u8", np.uint8, 16, 512, 512, 512, 0),
             ("int32", np.int32, 16, 512, 512, 512, 0),
             ("f32 with NaN planes", np.float32, 16, 512, 512, 512, 0),
             ("int8 37x45", np.int8, 5, 37, 45, 37, 0),
             ("uint32 37x45", np.uint32, 5, 37, 45, 37, 0),
             ("float64 37x45", np.float64, 5, 37, 45, 37, 0),
             ("int16 37x45", np.int16, 5, 37, 45, 37, 0)]
    for label, dtype, zc, h, w, H, y0 in cases:
        chunk = P.stage_planes(stack_of(dtype, zc, h, w), dev)
        type_max = (1.0 if np.dtype(dtype).kind == "f"
                    else float(np.iinfo(dtype).max))
        for alg in (0, 1, 2):
            base = torch.full((H, w), 7.0, dtype=torch.float32, device=dev)
            got, want = base.clone(), base.clone()
            KW.project_fold(chunk, got, y0, alg, True, True, zc, type_max)
            P.fold_chunk_plain(chunk, want, y0, alg, True, True, zc,
                               type_max)
            tally("project_fold", got, want, f"{label} alg {alg}")
            # Two chunks: the second folds onto the first's rows.
            if zc > 2:
                got2, want2 = base.clone(), base.clone()
                half = zc // 2
                for out, fold in ((got2, KW.project_fold),
                                  (want2, P.fold_chunk_plain)):
                    fold(chunk[:half].contiguous(), out, y0, alg, True,
                         False, zc, type_max)
                    fold(chunk[half:].contiguous(), out, y0, alg, False,
                         True, zc, type_max)
                tally("project_fold", got2, want2,
                      f"{label} alg {alg} in two chunks")
    # Timed at the projection phase's shape: one channel's 32 planes.
    chunk = P.stage_planes(stack_of(np.uint16, Z_STACK, TILE, TILE), dev)
    out = torch.empty((TILE, TILE), dtype=torch.float32, device=dev)
    e = entries["project_fold"]
    for alg, tag in ((0, "max"), (2, "sum")):
        key = "" if alg == 0 else "sum_"
        e[key + "ms"] = time_ms(torch, lambda: KW.project_fold(
            chunk, out, 0, alg, True, True, Z_STACK, 65535.0), 25)
        e[key + "plain_ms"] = time_ms(torch, lambda: P.fold_chunk_plain(
            chunk, out, 0, alg, True, True, Z_STACK, 65535.0), 5)
        e[key + "bound_ms"], e[key + "bound_by"] = bytes_bound(
            chunk.numel() * 2 + out.numel() * 4, chunk.numel())
        lib = ((lambda: torch.amax(chunk, dim=0)) if alg == 0 else
               (lambda: torch.sum(chunk, dim=0, dtype=torch.float32)))
        try:
            e[key + "library_ms"] = time_ms(torch, lib, 25)
            e[key + "library_call"] = (
                "torch.amax(chunk, dim=0)" if alg == 0 else
                "torch.sum(chunk, dim=0, dtype=torch.float32)")
        except Exception as exc:      # an op torch lacks for uint16
            e[key + "library_ms"] = None
            e[key + "library_call"] = f"{tag}: {type(exc).__name__}: {exc}"
    e["shape"] = [Z_STACK, TILE, TILE]
    e["dtype"] = "uint16"
    del chunk, out

    def copy_ms(n_bytes):
        """``dst.copy_(src)`` of half ``n_bytes`` each way under time_ms:
        the same bytes as the kernel, as a yardstick of the harness (the
        half rounded down to 16 bytes: PyTorch's copy of a size that is no
        multiple of 4 takes a slower, unvectorized kernel)."""
        src = torch.empty(n_bytes // 32 * 16, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        return time_ms(torch, lambda: dst.copy_(src), 25)

    def timed(e, key, fn, n_bytes, shape):
        """The kernel's time (cold L2), its device time with the L2 warm,
        the copy yardstick and the bound, under ``key``."""
        e[key + "ms"] = time_ms(torch, fn, 25)
        e[key + "device_us"] = device_split(torch, fn)
        e[key + "copy_ms"] = copy_ms(n_bytes)
        e[key + "bound_ms"], e[key + "bound_by"] = bytes_bound(n_bytes)
        e[key + "shape"] = shape
        print(f"kernel {e['name']} {shape}: {e[key + 'ms']:.4f} ms, copy of "
              f"the same bytes {e[key + 'copy_ms']:.4f} ms, bound "
              f"{e[key + 'bound_ms']:.4f} ms, warm L2 "
              f"{json.dumps(e[key + 'device_us'])} us", flush=True)

    # K8a, four flips each: B=8 1024^2 masks (timed unflipped); one
    # 1023^2 mask (timed with flip_h: groups cross rows); B=3 1000x999
    # (a row stride of 124,875 bytes, no multiple of 4); 37x45, 1x9, 31x7
    # and 33x5 (W < 32 and W just above it: groups span rows); B=3 100x99
    # packed from 3 bytes past a 4-byte boundary.
    for (w, h, B, poff) in ((TILE, TILE, 8, 0), (TILE - 1, TILE - 1, 1, 0),
                            (1000, 999, 3, 0), (37, 45, 3, 0), (1, 9, 2, 0),
                            (31, 7, 2, 0), (33, 5, 2, 0), (100, 99, 3, 3)):
        nb = M.packed_nbytes(w, h)
        packed = torch.from_numpy(rng.integers(
            0, 256, size=B * nb + 4, dtype=np.uint8)).to(dev)[
                poff:poff + B * nb].view(B, nb)
        where = f" packed +{poff} bytes" if poff else ""
        for fh, fv in ((0, 0), (1, 0), (0, 1), (1, 1)):
            tally("mask_rasterize",
                  KW.mask_rasterize(packed, w, h, bool(fh), bool(fv)),
                  M.mask_rasterize_plain(packed, w, h, bool(fh), bool(fv)),
                  f"{B}x{w}x{h}{where} flip h{fh} v{fv}")
        e = entries["mask_rasterize"]
        if B == 8:
            timed(e, "", lambda: KW.mask_rasterize(packed, w, h),
                  packed.numel() + B * w * h, [B, h, w])
            e["plain_ms"] = time_ms(torch, lambda: M.mask_rasterize_plain(
                packed, w, h), 5)
        elif w == TILE - 1:
            timed(e, "ragged_", lambda: KW.mask_rasterize(packed, w, h,
                                                          True),
                  packed.numel() + B * w * h, [B, h, w, "flip_h"])
    # K8b, fill alpha 0, 128, 255, grid bytes 0..3: one 1024^2 RGBA tile
    # (timed at alpha 128); a 37x45 pair; 1023x1021 (a ragged tail); a
    # 1024^2 base that starts 4 bytes past a 16-byte boundary; B=3 256^2;
    # a base 1 byte and a grid 3 bytes past one (the byte loads).
    for (w, h, B, off, goff) in ((TILE, TILE, 1, 0, 0), (37, 45, 2, 0, 0),
                                 (TILE - 1, TILE - 3, 1, 0, 0),
                                 (TILE, TILE, 1, 4, 0), (256, 256, 3, 0, 0),
                                 (256, 255, 2, 1, 3)):
        n, m = B * h * w * 4, B * h * w
        flat = torch.from_numpy(rng.integers(
            0, 256, size=n + 16, dtype=np.uint8)).to(dev)
        base = flat[off:off + n].view(B, h, w, 4)
        gflat = torch.from_numpy(rng.integers(
            0, 4, size=m + 16, dtype=np.uint8)).to(dev)
        grids = gflat[goff:goff + m].view(B, h, w)
        where = (f" base +{off} bytes" if off else "") + (
            f" grid +{goff} bytes" if goff else "")
        for alpha in (0, 128, 255):
            fills = torch.tensor([[255, 40, 7, alpha]] * B,
                                 dtype=torch.uint8, device=dev)
            tally("mask_overlay", KW.mask_overlay(base, grids, fills),
                  M.mask_overlay_plain(base, grids, fills),
                  f"{B}x{w}x{h}{where} alpha {alpha}")
            if B == 1 and w == TILE and not off and alpha == 128:
                e = entries["mask_overlay"]
                timed(e, "", lambda: KW.mask_overlay(base, grids, fills),
                      base.numel() * 2 + grids.numel() + fills.numel(),
                      [B, h, w, 4])
                e["plain_ms"] = time_ms(
                    torch, lambda: M.mask_overlay_plain(base, grids, fills),
                    5)
    for name in ("mask_rasterize", "mask_overlay"):
        entries[name]["library_ms"] = None
        entries[name]["library_note"] = "no single PyTorch call computes this"
    e = entries["project_fold"]
    e["library_note"] = ("max: " + e["library_call"] + "; sum: "
                         + e["sum_library_call"])
    if e["library_ms"] is None:      # no amax of this type: the sum's
        e["library_ms"] = e["sum_library_ms"]
    for e in entries.values():
        print(f"kernel {e['name']}: {e['ms']:.4f} ms (bound "
              f"{e['bound_ms']:.4f} ms, plain {e['plain_ms']:.3f} ms, "
              f"library {e['library_ms']}) at {e['shape']}", flush=True)
    return entries


def pyramid_kernel_phase(torch, np):
    """K9 (mean2_int) against its plain version, exactly, at the pyramid
    job's shapes: its first level step (4 x 8192^2 uint16), 4 x 1024^2
    uint16, an RGB WSI's 3 x 4096^2 uint8, int16 with negatives, an odd
    4097 x 8191 plane and an int8 37 x 45 plane; timed at the first."""
    import torch.nn.functional as F

    from omero_ms_image_region_tpu_torch.kernels import workloads as KW
    from omero_ms_image_region_tpu_torch.ops import pyramid as PY

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    e = {"name": "mean2_int", "route": "cuda", "source": WL_SOURCE,
         "replaces": "omero_ms_image_region_tpu/ops/pyramid.py:26",
         "max_abs_err": 0, "mismatches": 0, "tolerance": 0}

    def planes(dtype, shape):
        carrier = torch.int16 if dtype == torch.uint16 else dtype
        info = torch.iinfo(carrier)
        x = torch.randint(info.min, info.max + 1, shape, dtype=carrier,
                          device=dev, generator=gen)
        return x.view(torch.uint16) if dtype == torch.uint16 else x

    def as_int(t):
        return PY._widen(t)

    cases = [("4x8192^2 u16 (the job's first level step)", torch.uint16,
              (4, PLANE, PLANE)),
             ("4x1024^2 u16", torch.uint16, (4, TILE, TILE)),
             ("3x4096^2 u8 (an RGB WSI)", torch.uint8, (3, 4096, 4096)),
             ("2x1024x1000 i16 with negatives", torch.int16,
              (2, TILE, 1000)),
             ("odd 4097x8191 u16", torch.uint16, (1, 4097, 8191)),
             ("i8 37x45", torch.int8, (1, 37, 45))]
    for label, dtype, shape in cases:
        x = planes(dtype, shape)
        got, want = KW.mean2_int(x), PY.mean2_int_plain(x)
        torch.cuda.synchronize()
        diff = int((as_int(got) != as_int(want)).sum())
        err = int((as_int(got) - as_int(want)).abs().max()) if diff else 0
        print(f"check mean2_int {label}: differing {diff} of "
              f"{got.numel()} (tolerance 0)", flush=True)
        check(diff == 0, f"mean2_int {label} differs from its plain "
                         f"version")
        e["mismatches"] += diff
        e["max_abs_err"] = max(e["max_abs_err"], err)
        if shape[0] == 4 and shape[1] == PLANE:
            e["ms"] = time_ms(torch, lambda: KW.mean2_int(x), 25)
            e["plain_ms"] = time_ms(torch, lambda: PY.mean2_int_plain(x),
                                    5)
            e["library_ms"] = time_ms(torch, lambda: torch.round(
                F.avg_pool2d(as_int(x).to(torch.float32), 2)), 25)
            e["library_call"] = ("torch.round(F.avg_pool2d(x.float(), 2)) "
                                 "(uint16 widened through int32), cast "
                                 "included")
            e["bound_ms"], e["bound_by"] = bytes_bound(
                x.numel() * 2 + got.numel() * 2, got.numel() * 6)
            e["shape"] = list(shape)
            e["dtype"] = "uint16"
        del x, got, want
    torch.cuda.empty_cache()
    print(f"kernel mean2_int: {e['ms']:.4f} ms (bound {e['bound_ms']:.4f} "
          f"ms, plain {e['plain_ms']:.3f} ms, library "
          f"{e['library_ms']:.4f} ms) at {e['shape']}", flush=True)
    return {"mean2_int": e}


STAGING_SOURCE = "omero_ms_image_region_tpu_torch/kernels/csrc/staging.cu"


def k10_cases(np):
    """K10's cases: ``(label, array, rows, layout)``.  ``rows`` (a slice
    pair) decodes the array into those rows of a zeroed 4x1024^2 stack;
    ``layout`` "stage" puts the words and widths in one buffer as
    ``io.staging.stage`` does (the words a view of its head, the widths
    right behind them), else each is its own tensor.  The 300-row case is
    no multiple of a CTA's rows, the single row has no look-back, the
    16x1024^2 stack's look-back crosses 2048 tiles, and the staged band's
    widths start 4 bytes past an 8-byte boundary."""
    from omero_ms_image_region_tpu_torch.flagship import synthetic_wsi_tiles
    from omero_ms_image_region_tpu_torch.io import staging as S

    rng = np.random.default_rng(10)
    flagship = synthetic_wsi_tiles(rng, 1, 4, TILE, TILE)[0]
    cases = [("4x1024^2 flagship tile", flagship, None, None),
             ("4x256x1024 band into rows 256:512", flagship[:, 256:512],
              (slice(None), slice(256, 512)), None),
             ("4x1024^2 all zero (width 0)",
              np.zeros((4, TILE, TILE), np.uint16), None, None),
             ("4x1024^2 full-range noise (width 17)",
              rng.integers(0, 65536, (4, TILE, TILE)).astype(np.uint16),
              None, None),
             ("4x256x1000 rows of 1000 (a partial block)",
              synthetic_wsi_tiles(rng, 1, 4, 256, 1000)[0], None, None),
             ("3x100x1000 (300 rows, no multiple of a CTA's rows)",
              synthetic_wsi_tiles(rng, 1, 3, 100, 1000)[0], None, None),
             ("1x1x1024 a single row",
              synthetic_wsi_tiles(rng, 1, 1, 1, TILE)[0], None, None),
             ("16x1024^2 stack (a 2048-tile look-back)",
              synthetic_wsi_tiles(rng, 4, 4, TILE, TILE).reshape(
                  16, TILE, TILE), None, None)]
    # The first band of the flagship tile whose word count is odd: its
    # widths start 4 bytes past an 8-byte boundary of the staged buffer.
    for y in range(0, TILE, 64):
        band = flagship[:, y:y + 256]
        if band.shape[1] == 256 and len(S.pack16_host(band)[0]) % 2:
            cases.append((f"4x256x1024 band {y}:{y + 256} staged in one "
                          f"buffer (widths 4-byte aligned)", band, None,
                          "stage"))
            break
    return cases


def k10_inputs(torch, np, arr, layout):
    """``(words, widths)`` of ``arr`` packed, on the card, in ``layout``
    (see :func:`k10_cases`)."""
    from omero_ms_image_region_tpu_torch.io import staging as S

    words, widths = S.pack16_host(arr)
    if layout != "stage":
        return (torch.from_numpy(words.view(np.int32)).cuda(),
                torch.from_numpy(widths).cuda())
    buf = np.zeros(words.nbytes + widths.nbytes, np.uint8)
    buf[:words.nbytes] = words.view(np.uint8)
    buf[words.nbytes:] = widths
    on_dev = torch.from_numpy(buf).cuda()
    return on_dev[:words.nbytes].view(torch.int32), on_dev[words.nbytes:]


def staging_kernel_phase(torch, np):
    """K10 (unpack16) against its plain version and the source, byte for
    byte, on :func:`k10_cases`: a 4x1024^2 flagship tile whole and a
    4x256x1024 band (decoded into its rows of a 4x1024^2 stack, the
    handler's banded write), an all-zero plane (width 0 everywhere),
    full-range noise (width 17), rows of 1000 samples (a partial last
    block), 300 rows, a single row, a 16x1024^2 stack and a band staged as
    ``stage`` lays it out.  Each: median ms, the bound (words and widths
    read, 2 bytes a sample written, over HBM) and the plain version's
    ms."""
    from omero_ms_image_region_tpu_torch.io import staging as S
    from omero_ms_image_region_tpu_torch.kernels import staging as KS

    dev = torch.device("cuda")
    e = {"name": "unpack16", "route": "cuda", "source": STAGING_SOURCE,
         "replaces": "omero_ms_image_region_tpu/io/staging.py:53",
         "max_abs_err": 0, "mismatches": 0, "tolerance": 0,
         "library_ms": None,
         "library_note": "no PyTorch call decodes the packed row deltas",
         "cases": []}
    for label, arr, rows, layout in k10_cases(np):
        w_t, wd_t = k10_inputs(torch, np, arr, layout)
        if rows is None:
            out = torch.empty(arr.shape, dtype=torch.int16, device=dev)
            view = out
        else:
            out = torch.zeros((4, TILE, TILE), dtype=torch.int16,
                              device=dev)
            view = out[rows]
        KS.unpack16(w_t, wd_t, view)
        want = S.unpack16_plain(w_t, wd_t, arr.shape).view(torch.int16)
        torch.cuda.synchronize()
        diff = int((view != want).sum())
        source = torch.from_numpy(arr.view(np.int16)).to(dev)
        lost = int((view != source).sum())
        if rows is not None:
            lost += int(out[:, :256].count_nonzero()
                        + out[:, 512:].count_nonzero())
        print(f"check unpack16 {label}: differing {diff} from the plain "
              f"version, {lost} from the source (tolerance 0)", flush=True)
        check(diff == 0 and lost == 0,
              f"unpack16 {label} differs from its plain version or the "
              f"source")
        e["mismatches"] += diff
        ms = time_ms(torch, lambda: KS.unpack16(w_t, wd_t, view), 25)
        plain_ms = time_ms(torch, lambda: S.unpack16_plain(
            w_t, wd_t, arr.shape), 5)
        packed_bytes = w_t.numel() * 4 + wd_t.numel()
        bound_ms, bound_by = bytes_bound(packed_bytes + arr.size * 2)
        case = {"case": label, "shape": list(arr.shape), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by,
                "packed_ratio": packed_bytes / arr.nbytes,
                "device_us": device_split(
                    torch, lambda: KS.unpack16(w_t, wd_t, view))}
        if layout == "stage":
            case["widths_addr_mod_16"] = wd_t.data_ptr() % 16
        e["cases"].append(case)
        print(f"kernel unpack16 [{label}]: {ms:.4f} ms (bound "
              f"{bound_ms:.4f} ms by {bound_by}, plain {plain_ms:.3f} ms, "
              f"packed/raw {case['packed_ratio']:.3f})", flush=True)
        del w_t, wd_t, out, view, want, source
    first = e["cases"][0]
    for k in ("ms", "plain_ms", "bound_ms", "bound_by", "shape"):
        e[k] = first[k]
    e["band_ms"] = e["cases"][1]["ms"]
    e["band_bound_ms"] = e["cases"][1]["bound_ms"]
    print("k10: " + json.dumps({c["case"]: {
        k: c[k] for k in ("ms", "bound_ms", "plain_ms", "packed_ratio")}
        for c in e["cases"]}), flush=True)
    return {"unpack16": e}


# ------------------------------------------------------------- serve phase

ZSTACK_IMAGE = "2"
# Image 1's level 0 through the other readers: a single-level tiled
# OME-TIFF (3) and an NGFF group (4); an RGB JPEG-in-TIFF (5).
READER_IMAGES = {"ome-tiff": "3", "ome-ngff": "4"}
JPEG_IMAGE = "5"
RGB_PLANE = 4096
JPEG_TILE = 512
# Masks: 1-8 1024^2 with fills, 9 37x45, 10 1023x1023 (a payload that is
# not a whole number of bytes, with trailing bytes).
MASK_SHAPES = {**{i: (TILE, TILE) for i in range(1, 9)}, 9: (37, 45),
               10: (TILE - 1, TILE - 1)}


def write_jpeg_tiff(np, path, rgb, tile: int, quality: int) -> None:
    """A tiled RGB TIFF of compression 7 (photometric YCbCr), each tile a
    complete JFIF stream from PIL, written with the port's ``_TiffOut``."""
    import io

    from PIL import Image

    from omero_ms_image_region_tpu_torch.io.tiffwrite import _TiffOut

    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        out = _TiffOut(f, big=False)
        offs, cnts = [], []
        for y in range(0, h, tile):
            for x in range(0, w, tile):
                buf = io.BytesIO()
                Image.fromarray(np.ascontiguousarray(
                    rgb[y:y + tile, x:x + tile])).save(
                    buf, "jpeg", quality=quality)
                out.align()
                offs.append(out.write(buf.getvalue()))
                cnts.append(len(buf.getvalue()))
        ifd, _ = out.write_ifd([
            (256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]),
            (259, 3, [7]), (262, 3, [6]), (277, 3, [3]), (284, 3, [1]),
            (322, 4, [tile]), (323, 4, [tile]), (324, 4, offs),
            (325, 4, cnts)])
        out.patch_first_ifd(ifd)


def build_data(np, data_dir: str, lut_root: str) -> float:
    """The flagship plane (image 1, and its level 0 again as images 3 and
    4), the RGB JPEG-in-TIFF (image 5), the Z-stack (image 2) and the
    masks, written with the port's own ``build_pyramid``,
    ``write_ome_tiff``, ``write_ngff`` and ``write_mask`` (PIL encodes
    image 5's tiles)."""
    from omero_ms_image_region_tpu_torch.flagship import synthetic_wsi_tiles
    from omero_ms_image_region_tpu_torch.io.ngff import write_ngff
    from omero_ms_image_region_tpu_torch.io.store import build_pyramid
    from omero_ms_image_region_tpu_torch.io.tiffwrite import write_ome_tiff
    from omero_ms_image_region_tpu_torch.models.mask import Mask
    from omero_ms_image_region_tpu_torch.services.metadata import (
        write_mask)

    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    n = PLANE // TILE
    planes = np.empty((4, 1, PLANE, PLANE), np.uint16)
    for ty in range(n):
        row = synthetic_wsi_tiles(rng, n, 4, TILE, TILE)   # [n, C, T, T]
        for tx in range(n):
            planes[:, 0, ty * TILE:(ty + 1) * TILE,
                   tx * TILE:(tx + 1) * TILE] = row[tx]
    build_pyramid(planes, os.path.join(data_dir, "1"), chunk=(256, 256))
    # The same level 0 as a single-level OME-TIFF (512^2 tiles, no
    # compression) and an NGFF group, each read by its own reader.
    tiff_dir = os.path.join(data_dir, READER_IMAGES["ome-tiff"])
    os.makedirs(tiff_dir)
    write_ome_tiff(planes, os.path.join(tiff_dir, "plane.ome.tiff"),
                   tile=(512, 512), n_levels=1)
    write_ngff(planes, os.path.join(data_dir, READER_IMAGES["ome-ngff"],
                                    "plane.zarr"),
               chunk=(512, 512), n_levels=1, compressor=None)
    del planes
    # An RGB brightfield-like plane as tiled JPEG-in-TIFF (image 5).
    rgb = np.empty((RGB_PLANE, RGB_PLANE, 3), np.uint8)
    n = RGB_PLANE // TILE
    for ty in range(n):
        row = synthetic_wsi_tiles(rng, n, 3, TILE, TILE)
        for tx in range(n):
            rgb[ty * TILE:(ty + 1) * TILE, tx * TILE:(tx + 1) * TILE] = \
                (row[tx] >> 8).astype(np.uint8).transpose(1, 2, 0)
    os.makedirs(os.path.join(data_dir, JPEG_IMAGE))
    write_jpeg_tiff(np, os.path.join(data_dir, JPEG_IMAGE, "rgb.tif"), rgb,
                    JPEG_TILE, 90)
    del rgb
    # A confocal-sized Z-stack: 4 channels of 1024^2 uint16, 32 planes
    # (256 MiB), one synthetic_wsi_tiles call per plane.
    stack = np.empty((4, Z_STACK, TILE, TILE), np.uint16)
    rng = np.random.default_rng(1)
    for z in range(Z_STACK):
        stack[:, z] = synthetic_wsi_tiles(rng, 1, 4, TILE, TILE)[0]
    build_pyramid(stack, os.path.join(data_dir, ZSTACK_IMAGE),
                  chunk=(256, 256))
    # ROI-like masks: a thresholded blob field each.
    rng = np.random.default_rng(2)
    for sid, (w, h) in MASK_SHAPES.items():
        grid = synthetic_wsi_tiles(rng, 1, 1, h, w)[0, 0] > 9000
        bits = np.packbits(grid.reshape(-1)).tobytes()
        if sid == 10:
            bits += b"\xff\xff"
        fill = (None if sid in (1, 9) else
                (40 * sid % 256, 255 - 20 * sid, 90, 64 + 16 * sid))
        write_mask(data_dir, Mask(sid, w, h, bits, fill))
    with open(os.path.join(lut_root, "smoke.lut"), "wb") as f:
        f.write(smoke_lut(np).T.tobytes())     # 768-byte planar R, G, B
    return time.perf_counter() - t0


CH = "1|100:40000$FF0000,2|100:40000$00FF00,3|100:40000$0000FF," \
     "4|100:40000$FFFF00"
# A second window for the same tiles (a viewer re-windowing).
CH2 = "1|500:30000$FF0000,2|300:45000$00FF00,3|200:35000$0000FF," \
      "4|800:25000$FFFF00"


def requests_for(tile: int):
    """The 11 checked requests: tiles of ``tile`` pixels on a plane of
    8 tiles a side, and one 256^2 tile."""
    def t(res, x, y):
        return f"{res},{x},{y},{tile},{tile}"
    return [
        ("render_image_region", {"tile": t(0, 2, 3), "c": CH, "m": "c",
                                 "format": "png"}),
        ("render_image_region", {"tile": t(1, 1, 1), "c": CH, "m": "c",
                                 "format": "png"}),
        ("render_image_region", {"tile": t(0, 4, 4), "c": CH, "m": "g",
                                 "format": "png"}),
        ("render_image_region", {
            "tile": t(0, 5, 1), "c": CH, "m": "c", "format": "png",
            "maps": '[{"reverse":{"enabled":true}},{},{},{}]'}),
        ("render_image_region", {
            "tile": t(0, 3, 6), "m": "c", "format": "png",
            "c": CH.replace("$00FF00", "$smoke.lut")}),
        ("render_image_region", {"tile": t(0, 6, 2), "c": CH, "m": "c",
                                 "flip": "hv", "format": "png"}),
        ("render_image_region", {"tile": t(0, 1, 7), "c": CH, "m": "c",
                                 "format": "jpeg", "q": "0.9"}),
        ("render_image_region", {"tile": t(0, 2, 5), "c": CH, "m": "c",
                                 "format": "jpeg", "flip": "h"}),
        ("render_image_region", {
            "tile": t(0, 4, 6), "m": "c", "format": "jpeg",
            "c": CH.replace("$00FF00", "$smoke.lut")}),
        ("render_image_region", {"tile": "0,9,9,256,256", "c": CH, "m": "c",
                                 "format": "jpeg"}),
        ("render_image", {
            "region": f"{3 * tile - tile // 14},{2 * tile + tile // 2},"
                      f"{tile},{tile}",
            "c": CH, "m": "c", "format": "png"}),
    ]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def plain_jpeg(torch, ctx, raw, settings) -> bytes:
    """The device JPEG route with every stage's plain version: plain K1 or
    K2 and plain K3 on the card, plain K4a/K4b (on host tensors), the same
    native coder."""
    from omero_ms_image_region_tpu_torch import codecs
    from omero_ms_image_region_tpu_torch.ops import jpegenc as J
    from omero_ms_image_region_tpu_torch.ops import render as R

    t = R.settings_to_tensors(settings, DEVICE)
    packed = R.render_tile_batch_packed_plain(
        R.raw_to_tensor(raw, DEVICE)[None], *R.batched_settings(t))
    h, w = packed.shape[-2:]
    H, W = h + (-h) % 16, w + (-w) % 16
    q = codecs.quality_percent(ctx.compression_quality)
    coeffs = J.packed_to_jpeg_coefficients_plain(
        packed, q, H, W, ctx.flip_horizontal, ctx.flip_vertical)
    return J.coefficients_to_jpegs(*(c.cpu() for c in coeffs), H, W, q,
                                   [(w, h)])[0]


def digest_rates(raw) -> dict:
    """MB/s of hashlib's digests over one tile's raw planes (median of 5):
    the raw cache's BLAKE2b against the others the standard library
    has."""
    import hashlib

    view = memoryview(raw.reshape(-1)).cast("B")
    rates = {}
    for name in ("blake2b", "sha256", "sha1", "md5"):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            hashlib.new(name, view).digest()
            times.append(time.perf_counter() - t0)
        rates[name] = raw.nbytes / statistics.median(times) / 1e6
    return rates


def encode_overlap(np, rgba, row, w, h, q, cap) -> dict:
    """16 encodes of one tile on 1 thread and on 8: PIL's JPEG encode and
    the native sparse coder.  A speedup near 1 means the encodes
    serialise."""
    import concurrent.futures as cf

    from omero_ms_image_region_tpu_torch import codecs, native

    out = {}
    for name, fn in (("pil", lambda: codecs.encode_rgba(rgba, "jpeg",
                                                         None)),
                     ("native", lambda: native.jpeg_encode_sparse(
                         row, w, h, q, cap))):
        fn()
        walls = {}
        for threads in (1, 8):
            with cf.ThreadPoolExecutor(threads) as pool:
                t0 = time.perf_counter()
                list(pool.map(lambda _: fn(), range(16)))
                walls[threads] = time.perf_counter() - t0
        out[name] = {"one_thread_ms_per_encode": walls[1] / 16 * 1e3,
                     "eight_threads_ms_per_encode": walls[8] / 16 * 1e3,
                     "speedup": walls[1] / walls[8]}
    return out


def launch_counts():
    from omero_ms_image_region_tpu_torch.kernels import jpeg as KJ
    from omero_ms_image_region_tpu_torch.kernels import render as K
    from omero_ms_image_region_tpu_torch.kernels import staging as KS
    from omero_ms_image_region_tpu_torch.kernels import workloads as KW
    return dict(K.LAUNCHES, **KJ.LAUNCHES, **KW.LAUNCHES, **KS.LAUNCHES)


def reset_launch_counts() -> None:
    from omero_ms_image_region_tpu_torch.kernels import jpeg as KJ
    from omero_ms_image_region_tpu_torch.kernels import render as K
    from omero_ms_image_region_tpu_torch.kernels import staging as KS
    from omero_ms_image_region_tpu_torch.kernels import workloads as KW
    K.reset_launches()
    KJ.reset_launches()
    KW.reset_launches()
    KS.reset_launches()


class Batches:
    """The batcher's group counters over one phase."""

    def __init__(self, batcher):
        self.b = batcher
        self.batches0 = batcher.batches_dispatched
        self.tiles0 = batcher.tiles_rendered
        self.sizes0 = dict(batcher.group_sizes)
        batcher.max_executing = 0
        batcher.queue_waits_ms.clear()
        batcher.execute_ms.clear()

    def report(self) -> dict:
        b = self.b
        sizes = {k: v - self.sizes0.get(k, 0)
                 for k, v in sorted(b.group_sizes.items())
                 if v - self.sizes0.get(k, 0)}
        groups = b.batches_dispatched - self.batches0
        tiles = b.tiles_rendered - self.tiles0
        waits = sorted(b.queue_waits_ms)
        execute = list(b.execute_ms)
        return {"groups": groups, "tiles": tiles,
                "mean_group_size": tiles / groups if groups else 0.0,
                "group_sizes": sizes,
                "max_groups_in_execute": b.max_executing,
                "device_lanes": b.device_lanes,
                "queue_wait_p50_ms": statistics.median(waits) if waits
                else None,
                "queue_wait_max_ms": waits[-1] if waits else None,
                "execute_p50_ms": statistics.median(execute) if execute
                else None}


def batch_requests():
    """8 distinct device-route JPEG GETs for one concurrent burst: two
    windows, a reversed channel, flip=h, flip=v, a 1000x1000 region (the
    1024 bucket), a LUT channel and q=0.9 (each of the last two its own
    group key)."""
    def t(x):
        return f"0,{x},0,{TILE},{TILE}"
    jpeg = {"m": "c", "format": "jpeg"}
    return [
        ("render_image_region", dict(jpeg, tile=t(0), c=CH)),
        ("render_image_region", dict(jpeg, tile=t(1), c=CH2)),
        ("render_image_region", dict(
            jpeg, tile=t(2), c=CH,
            maps='[{},{"reverse":{"enabled":true}},{},{}]')),
        ("render_image_region", dict(jpeg, tile=t(3), c=CH, flip="h")),
        ("render_image_region", dict(jpeg, tile=t(4), c=CH, flip="v")),
        ("render_image_region", dict(
            jpeg, region=f"{5 * TILE + 7},{TILE // 3},1000,1000", c=CH)),
        ("render_image_region", dict(
            jpeg, tile=t(6), c=CH.replace("$00FF00", "$smoke.lut"))),
        ("render_image_region", dict(jpeg, tile=t(7), c=CH, q="0.9")),
    ]


def params_of(route, query, image="1"):
    """A request's params: ``query`` may name ``imageId`` and ``theZ``
    (default image 1, plane 0); a mask's id is ``shapeId``."""
    if route == "render_shape_mask":
        return dict(query, shapeId=image)
    return dict({"imageId": image, "theZ": "0", "theT": "0"}, **query)


class SimpleAnswer:
    def __init__(self, status, headers, body):
        self.status, self.headers, self.body = status, headers, body


class Client:
    """One app a config describes, over HTTP on 127.0.0.1 when aiohttp is
    installed, else through the app's request front
    (``server.app.Front``: the same conditional decision, handler, status
    mapping and request accounting, without a socket; its watchdog runs as
    a task here)."""

    def __init__(self, config, handler, have_aiohttp, db=None):
        self.config, self.handler, self.db = config, handler, db
        self.via = "http" if have_aiohttp else "front"
        self.runner = self.session = self.front = self.watchdog = None
        self.jobs = None
        self.loops: list = []

    async def start(self):
        if self.via == "http":
            import aiohttp
            from aiohttp import web
            from omero_ms_image_region_tpu_torch.server.app import create_app
            from omero_ms_image_region_tpu_torch.server.app import (
                _front_key)
            self.port = free_port()
            app = create_app(self.config, DEVICE, handler=self.handler,
                             db=self.db)
            # The app's front (its fleet router, with handler None).
            self.app_front = app[_front_key()]
            self.runner = web.AppRunner(app)
            await self.runner.setup()
            await web.TCPSite(self.runner, "127.0.0.1", self.port).start()
            self.session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=120))
            return
        from omero_ms_image_region_tpu_torch.server.app import (Front,
                                                                build_front)
        from omero_ms_image_region_tpu_torch.server.watchdog import (
            build_watchdog)
        if self.handler is None:
            # The config's own stack (a fleet); no watchdog task here.
            self.front = self.app_front = build_front(self.config, DEVICE)
            self.loops = [asyncio.create_task(loop(), name=name)
                          for name, loop in self.front.background()]
            return
        self.front = Front(self.config, self.handler, db=self.db)
        if self.config.watchdog.enabled:
            self.watchdog = asyncio.create_task(build_watchdog(
                self.config.watchdog, self.handler.s.renderer).run())
        if self.front.jobs is not None:
            self.jobs = asyncio.create_task(self.front.jobs.run())
        # The pressure governor's and the perf sentinel's tick loops.
        self.loops = [asyncio.create_task(loop(), name=name)
                      for name, loop in self.front.background()]

    async def stop(self):
        if self.session is not None:
            await self.session.close()
        if self.runner is not None:
            await self.runner.cleanup()       # closes the renderer
        for task in [self.watchdog, self.jobs] + self.loops:
            if task is not None:
                task.cancel()
                await asyncio.gather(task, return_exceptions=True)
        if self.front is not None:
            self.front.close()
        if self.handler is None:
            if self.runner is None:
                await close_fleet(self.front)
            return
        if self.handler.s.prefetcher is not None:
            self.handler.s.prefetcher.close()
        await self.handler.s.renderer.close()

    async def request(self, route, query, method="GET", headers=None,
                      image="1", cookies=None):
        """(status, headers, body, wall ms) of one request; ``cookies``
        (name -> value) go in its ``Cookie`` header."""
        t0 = time.perf_counter()
        if cookies:
            headers = dict(headers or {}, Cookie="; ".join(
                f"{k}={v}" for k, v in cookies.items()))
        if self.session is not None:
            query = dict(query)
            image = query.pop("imageId", image)
            z = query.pop("theZ", "0")
            tail = ("" if route == "render_shape_mask" else f"/{z}/0")
            url = (f"http://127.0.0.1:{self.port}/webgateway/{route}/"
                   f"{image}{tail}")
            async with self.session.request(method, url, params=query,
                                            headers=headers or {}) as r:
                body = await r.read()
                status, hdrs = r.status, r.headers.copy()  # any case
        else:
            answer = await self.front.observed(
                route, method, params_of(route, query, image),
                headers or {}, cookies or {})
            status, hdrs, body = answer.status, answer.headers, answer.body
        return status, hdrs, body, (time.perf_counter() - t0) * 1e3

    async def request_path(self, method: str, path: str):
        """(status, headers, body, wall ms) of a request to ``path`` (an
        ``/admin`` route)."""
        t0 = time.perf_counter()
        if self.session is not None:
            async with self.session.request(
                    method, f"http://127.0.0.1:{self.port}{path}") as r:
                body = await r.read()
                status, hdrs = r.status, r.headers.copy()
        else:
            from urllib.parse import parse_qsl, urlsplit
            parts = urlsplit(path)
            member = dict(parse_qsl(parts.query)).get("member")
            if parts.path == "/admin/drain":
                answer = await self.front.admin_drain(method, member)
            elif parts.path == "/admin/undrain":
                answer = self.front.admin_undrain(member)
            elif parts.path == "/admin/autoscaler":
                answer = self.front.admin_autoscaler()
            elif parts.path == "/admin/federation":
                answer = await self.front.admin_federation(
                    bool(dict(parse_qsl(parts.query)).get("agree")))
            else:
                answer = SimpleAnswer(200, {}, self.front.metrics_text()
                                      .encode())
            status, hdrs, body = answer.status, answer.headers, answer.body
        return status, hdrs, body, (time.perf_counter() - t0) * 1e3

    async def submit_pyramid(self, image: str):
        """(status, job document) of ``POST /pyramid {"imageId": ...}``."""
        body = json.dumps({"imageId": int(image)}).encode()
        if self.session is not None:
            async with self.session.post(
                    f"http://127.0.0.1:{self.port}/pyramid",
                    data=body) as r:
                return r.status, await r.json(content_type=None)
        answer = await self.front.observed(
            "pyramid_submit", "POST", {}, {}, {},
            call=lambda: self.front.pyramid_submit(body))
        return answer.status, json.loads(answer.body or b"null")

    async def pyramid_job(self, job_id: str):
        """(status, job document) of ``GET /pyramid/{jobId}``."""
        if self.session is not None:
            async with self.session.get(
                    f"http://127.0.0.1:{self.port}/pyramid/{job_id}") as r:
                return r.status, await r.json(content_type=None)
        answer = self.front.pyramid_status(job_id)
        return answer.status, json.loads(answer.body or b"null")

    async def readyz(self):
        """(status, body) of ``GET /readyz``."""
        if self.session is not None:
            async with self.session.get(
                    f"http://127.0.0.1:{self.port}/readyz") as r:
                return r.status, await r.json(content_type=None)
        ok, checks = self.front.ready()
        return (200 if ok else 503), {
            "status": "ready" if ok else "degraded", "checks": checks}

    async def metrics(self, openmetrics: bool = False) -> str:
        """The ``/metrics`` scrape; ``openmetrics`` asks for the
        OpenMetrics exposition (exemplars)."""
        if self.session is not None:
            headers = ({"Accept": "application/openmetrics-text; "
                                  "version=1.0.0"} if openmetrics else {})
            async with self.session.get(
                    f"http://127.0.0.1:{self.port}/metrics",
                    headers=headers) as r:
                return await r.text()
        return self.front.metrics_text(openmetrics=openmetrics)

    async def debug(self, route: str, **query):
        """(status, JSON document) of ``GET /debug/<route>?query``."""
        if self.session is not None:
            async with self.session.get(
                    f"http://127.0.0.1:{self.port}/debug/{route}",
                    params=query) as r:
                return r.status, await r.json(content_type=None)
        front = self.front
        if route == "profile":
            answer = await front.profile(query.get("ms"))
        elif route == "explain":
            answer = await front.explain(query.get("path"))
        else:
            return 200, {"costs": front.costs_doc,
                         "decisions": front.decisions_doc,
                         "exemplars": front.exemplars_doc,
                         "sentinel": front.sentinel_doc}[route]()
        return answer.status, json.loads(answer.body or b"null")


# The render path's spans (the JAX package's names), and the ones a cold
# device-route GET must have.
SPANS = ("get_pixels_description", "canRead",
         "PixelsService.getPixelBuffer", "PixelsService.readRegion",
         "dedup.coalesced", "batcher.queueWait",
         "batcher.queueWait.cancelled", "batcher.stage",
         "Renderer.renderAsPackedInt.batch", "jfif.encodeBatch",
         "Renderer.renderAsPackedInt", "encodeImage", "http.firstByte")
REQUIRED_SPANS = ("PixelsService.getPixelBuffer", "batcher.queueWait",
                  "Renderer.renderAsPackedInt.batch", "jfif.encodeBatch")


async def settled(batcher) -> None:
    """Wait for the batcher's last group: a JPEG request is answered when
    its tile is coded, before its group's lane spans are recorded."""
    while batcher.inflight():
        await asyncio.sleep(0.005)


def reset_spans(telemetry, registry) -> None:
    registry.reset()
    telemetry.REQUEST_HIST.reset()
    telemetry.TRACES.reset()


def span_split(telemetry, registry) -> dict:
    """Each span's per-request p50 over the finished traces since
    :func:`reset_spans` (a lane span counts once on each member's trace),
    its sample count in the registry, and the p50 of
    ``imageregion_request_duration_ms`` (bucket resolution, as /metrics
    gives it)."""
    traces = telemetry.TRACES.recent()
    snap = registry.snapshot()
    out = {}
    for name in SPANS:
        per_request = [v for v in (t.span_ms(name) for t in traces)
                       if v is not None]
        out[name] = {"p50_ms": statistics.median(per_request)
                     if per_request else None,
                     "requests": len(per_request),
                     "samples": snap.get(name, {}).get("count", 0)}
    hist = telemetry.REQUEST_HIST.get("render_image_region")
    return {"traces": len(traces), "spans": out,
            "request_duration_ms_p50_bucket": hist.quantile(0.5)
            if hist else None,
            "request_duration_count": hist.count if hist else 0}


async def staging_phase(torch, np, handler, tiles, e2e) -> dict:
    """The cold misses of the e2e run, layer by layer: each tile's host
    planes cut into the handler's bands, and each band packed
    (``io.staging.pack_for_stage``, JAX's decision), its words and widths
    copied from a pinned buffer, and decoded by K10, each timed (host
    clock for the pack, CUDA events for the copy and around K10's call,
    whose host enqueue shows there: the kernel alone is ``k10:``'s); beside
    them the same band's plain pinned upload (``HostPlanes.upload``), all
    by calling the port's functions directly.  K10's launches are the e2e
    run's."""
    from omero_ms_image_region_tpu_torch.io import staging as S
    from omero_ms_image_region_tpu_torch.kernels import staging as KS
    from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx

    dev = torch.device(DEVICE)
    layers = {k: [] for k in ("pack_ms", "copy_to_pinned_ms", "dma_ms",
                              "k10_call_ms", "packed_ratio", "plain_fill_ms",
                              "plain_dma_ms")}
    per_tile = {"packed_total_ms": [], "plain_total_ms": []}
    bands_packed = bands = 0
    for route, query in tiles:
        ctx = ImageRegionCtx.from_params(params_of(route, query))
        plan = await handler._plan(ctx, await handler._authorize(ctx))
        bounds = handler._band_bounds(plan.region,
                                      plan.src.tile_size()[1])
        raw, _ = await handler.read(ctx)
        packed_total = plain_total = 0.0
        for y0, y1 in zip(bounds, bounds[1:]):
            band = np.ascontiguousarray(raw[:, y0:y1])
            bands += 1
            t0 = time.perf_counter()
            packed = S.pack_for_stage(band)
            t1 = time.perf_counter()
            out = torch.empty(band.shape, dtype=torch.int16, device=dev)
            if packed is not None:
                bands_packed += 1
                words, widths = packed
                buf = torch.empty(words.nbytes + widths.nbytes,
                                  dtype=torch.uint8, pin_memory=True)
                host = buf.numpy()
                host[:words.nbytes] = words.view(np.uint8)
                host[words.nbytes:] = widths
                t2 = time.perf_counter()
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(3)]
                ev[0].record()
                on_dev = buf.to(dev, non_blocking=True)
                ev[1].record()
                KS.unpack16(on_dev[:words.nbytes].view(torch.int32),
                            on_dev[words.nbytes:], out)
                ev[2].record()
                torch.cuda.synchronize()
                check(torch.equal(out.cpu(), torch.from_numpy(
                    band.view(np.int16))), "staging: K10 did not give "
                                           "the band back")
                dma, k10 = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(
                    ev[2])
                layers["pack_ms"].append((t1 - t0) * 1e3)
                layers["copy_to_pinned_ms"].append((t2 - t1) * 1e3)
                layers["dma_ms"].append(dma)
                layers["k10_call_ms"].append(k10)
                layers["packed_ratio"].append(
                    (words.nbytes + widths.nbytes) / band.nbytes)
                packed_total += (t2 - t0) * 1e3 + dma + k10
            t3 = time.perf_counter()
            planes = S.HostPlanes(band.shape, band.dtype, dev)
            np.copyto(planes.array, band)
            t4 = time.perf_counter()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            planes.upload()
            ev[1].record()
            torch.cuda.synchronize()
            layers["plain_fill_ms"].append((t4 - t3) * 1e3)
            layers["plain_dma_ms"].append(ev[0].elapsed_time(ev[1]))
            plain_total += (t4 - t3) * 1e3 + ev[0].elapsed_time(ev[1])
        per_tile["packed_total_ms"].append(packed_total)
        per_tile["plain_total_ms"].append(plain_total)
    doc = {"tiles": len(tiles), "bands": bands,
           "bands_packed": bands_packed,
           "band_shape": [4, bounds[1] - bounds[0], TILE],
           "per_band_median": {k: statistics.median(v) if v else None
                               for k, v in layers.items()},
           "per_tile_median_ms": {k: statistics.median(v)
                                  for k, v in per_tile.items()},
           "k10_launches_in_e2e": e2e["launches"]["unpack16"],
           "e2e_cold_p50_ms": e2e["sequential_p50_ms"],
           "card": smi_line()}
    print("staging: " + json.dumps(doc), flush=True)
    check(bands_packed > 0, "staging: no band of a flagship tile packed")
    check(doc["k10_launches_in_e2e"] > 0,
          "staging: K10 was not launched by the served cold misses")
    return doc


async def stream_phase(client, data_dir, lut_root, have_aiohttp, tiles,
                       seq_spans) -> dict:
    """The default app's render GETs leave chunked (``wire.streaming``, on
    by default): over HTTP each carries ``Transfer-Encoding: chunked``, and
    its bytes equal an app's with ``wire.streaming: false`` (one body with
    ``Content-Length``); the p50 of ``http.firstByte`` over the e2e run's
    16 sequential cold GETs."""
    config, handler = front_handler(data_dir, lut_root,
                                    {"wire": {"streaming": False}})
    unary = Client(config, handler, have_aiohttp)
    await unary.start()
    rows = []
    try:
        for route, query in tiles:
            status, hdrs, body, ms = await client.request(route, query)
            u_status, u_hdrs, u_body, u_ms = await unary.request(route,
                                                                 query)
            rows.append({
                "status": (status, u_status), "same_bytes": body == u_body,
                "chunked": hdrs.get("Transfer-Encoding") == "chunked",
                "unary_content_length": u_hdrs.get("Content-Length"),
                "ms": ms, "unary_ms": u_ms})
    finally:
        await unary.stop()
    first_byte = seq_spans["spans"]["http.firstByte"]
    doc = {"gets": rows, "first_byte_p50_ms": first_byte["p50_ms"],
           "first_byte_requests": first_byte["requests"],
           "e2e_request_p50_bucket_ms":
               seq_spans["request_duration_ms_p50_bucket"],
           "via": client.via}
    print("stream: " + json.dumps(doc), flush=True)
    check(all(r["status"] == (200, 200) and r["same_bytes"] for r in rows),
          "stream: a chunked body differs from the unary one")
    if client.via == "http":
        check(all(r["chunked"] and r["unary_content_length"] for r in rows),
              "stream: a render GET was not chunked, or the unary app's "
              "had no Content-Length")
    check(first_byte["requests"] > 0,
          "stream: no http.firstByte span in the e2e run")
    return doc


async def http_cache_phase(client, handler, matches_plain) -> None:
    """A cold device-route JPEG GET, its If-None-Match and
    If-Modified-Since repeats (304, no body), a HEAD (its headers, no
    body), with the batcher's counters unmoved by the last three; a 404
    without cache headers."""
    batcher = handler.s.renderer
    handler.s.raw_cache.clear()
    route, query = ("render_image_region", {
        "tile": f"0,3,3,{TILE},{TILE}", "c": CH, "m": "c",
        "format": "jpeg", "q": "0.75"})
    status, hdrs, body, ms = await client.request(route, query)
    check(status == 200 and all(k in hdrs for k in (
        "ETag", "Cache-Control", "Last-Modified")),
        f"http_cache: cold GET {status} without its cache headers")
    _, _, _, same = await matches_plain(route, query, body)
    check(same, "http_cache: the cold GET differs from the plain route")
    counters = (batcher.batches_dispatched, batcher.tiles_rendered)
    inm = await client.request(route, query,
                               headers={"If-None-Match": hdrs["ETag"]})
    ims = await client.request(route, query, headers={
        "If-Modified-Since": hdrs["Last-Modified"]})
    head = await client.request(route, query, method="HEAD")
    moved = (batcher.batches_dispatched - counters[0],
             batcher.tiles_rendered - counters[1])
    nf = await client.request(route, query, image="99")
    doc = {"cold": [status, len(body), round(ms, 3)],
           "if_none_match": [inm[0], len(inm[2])],
           "if_modified_since": [ims[0], len(ims[2])],
           "head": [head[0], len(head[2])],
           "batches_moved": moved[0], "tiles_moved": moved[1],
           "not_found": [nf[0], sorted(k for k in nf[1] if k in (
               "ETag", "Cache-Control", "Vary", "Last-Modified"))],
           "etag": hdrs["ETag"], "cache_control": hdrs["Cache-Control"],
           "via": client.via}
    print("http_cache: " + json.dumps(doc), flush=True)
    check(inm[0] == 304 and inm[2] == b"", "http_cache: If-None-Match "
          "did not get an empty 304")
    check(ims[0] == 304 and ims[2] == b"", "http_cache: If-Modified-Since "
          "did not get an empty 304")
    check(head[0] == 200 and head[2] == b"" and all(
        head[1].get(k) == hdrs[k] for k in ("ETag", "Cache-Control",
                                            "Last-Modified")),
        "http_cache: HEAD did not answer the 200's headers alone")
    check(moved == (0, 0), "http_cache: a 304 or the HEAD rendered")
    check(nf[0] == 404 and not doc["not_found"][1],
          "http_cache: the 404 carries cache headers")


def front_handler(data_dir, lut_root, raw):
    """A config from ``raw`` over the smoke's data, and its handler on the
    card."""
    from omero_ms_image_region_tpu_torch.server.app import build_services
    from omero_ms_image_region_tpu_torch.server.config import AppConfig
    from omero_ms_image_region_tpu_torch.server.handler import (
        ImageRegionHandler)

    raw = dict(raw)
    raw.setdefault("raw-cache", {"prefetch": False})
    config = AppConfig.from_dict(dict(raw, **{
        "data-dir": data_dir,
        "omero.server": {"omero.script_repo_root": lut_root}}))
    return config, ImageRegionHandler(build_services(config, DEVICE))


async def admission_phase(data_dir, lut_root, have_aiohttp,
                          matches_plain) -> None:
    """24 distinct cold device-route JPEG GETs at once through an app
    whose admission bound is 4: each a 200 equal to the plain route or a
    503 with Retry-After >= 1; at least one 503; admitted + shed = 24."""
    config, handler = front_handler(data_dir, lut_root, {
        "fault-tolerance": {"admission-max-queue": 4}})
    adm = handler.s.admission
    reqs = [("render_image_region", {
        "tile": f"0,{i % 8},{i // 8},{TILE},{TILE}", "c": CH2, "m": "c",
        "format": "jpeg", "q": "0.8"}) for i in range(24)]
    client = Client(config, handler, have_aiohttp)
    await client.start()
    try:
        t0 = time.perf_counter()
        out = await asyncio.gather(*(client.request(*r) for r in reqs))
        wall = time.perf_counter() - t0
        statuses = {}
        for (route, query), (status, hdrs, body, _) in zip(reqs, out):
            statuses[status] = statuses.get(status, 0) + 1
            if status == 200:
                _, _, _, same = await matches_plain(route, query, body)
                check(same, f"admission {query}: body differs from the "
                            f"plain route")
            else:
                check(status == 503 and int(hdrs.get("Retry-After", 0))
                      >= 1, f"admission {query}: HTTP {status} "
                            f"Retry-After {hdrs.get('Retry-After')}")
        doc = {"gets": len(reqs), "bound": adm.max_queue,
               "statuses": statuses, "admitted": adm.admitted_total,
               "shed": adm.shed_total, "wall_ms": wall * 1e3,
               "prefetch": False, "via": client.via}
        print("admission: " + json.dumps(doc), flush=True)
        check(statuses.get(503, 0) >= 1, "admission: nothing was shed")
        check(adm.admitted_total + adm.shed_total == len(reqs),
              "admission: admitted + shed != GETs")
    finally:
        await client.stop()


async def watchdog_phase(data_dir, lut_root, have_aiohttp,
                         matches_plain) -> None:
    """A seeded freeze (3 s, once) wedges the first group of a
    device-route JPEG GET; the watchdog (0.1 s cadence, 0.5 s floor)
    requeues it, and the GET is answered with the plain route's bytes
    before the freeze ends.  Then, with the injector uninstalled, a repeat
    runs clean."""
    from omero_ms_image_region_tpu_torch.utils import faultinject, telemetry

    config, handler = front_handler(data_dir, lut_root, {
        "watchdog": {"interval-s": 0.1, "stall-min-s": 0.5},
        "fault-injection": {"seed": 1, "freeze-rate": 1.0,
                            "freeze-ms": 3000, "freeze-max": 1}})
    injector = faultinject.active()
    client = Client(config, handler, have_aiohttp)
    await client.start()
    fires0 = telemetry.WATCHDOG.totals()

    def fired():
        now = telemetry.WATCHDOG.totals()
        return {k: v - fires0.get(k, 0) for k, v in now.items()
                if v - fires0.get(k, 0)}
    try:
        route = "render_image_region"
        query = {"tile": f"0,6,6,{TILE},{TILE}", "c": CH, "m": "c",
                 "format": "jpeg", "q": "0.7"}
        status, _, body, ms = await client.request(route, query)
        _, _, _, same = await matches_plain(route, query, body)
        healed = {"status": status, "wall_ms": ms, "matches_plain": same,
                  "fires": fired(), "injected": injector.snapshot()}
        faultinject.uninstall()
        query2 = dict(query, tile=f"0,7,6,{TILE},{TILE}")
        status2, _, body2, ms2 = await client.request(route, query2)
        _, _, _, same2 = await matches_plain(route, query2, body2)
        doc = {"healed": healed, "repeat": {
            "status": status2, "wall_ms": ms2, "matches_plain": same2,
            "fires": fired()}, "via": client.via}
        print("watchdog: " + json.dumps(doc), flush=True)
        check(status == 200 and same and ms < 3000.0,
              "watchdog: the frozen GET was not healed before the freeze "
              "ended")
        check(healed["fires"] == {"requeue-group": 1}
              and healed["injected"] == {"freeze": 1},
              "watchdog: not exactly one requeue of one frozen group")
        check(status2 == 200 and same2
              and doc["repeat"]["fires"] == {"requeue-group": 1},
              "watchdog: the repeat without the injector did not run "
              "clean")
    finally:
        faultinject.uninstall()
        await client.stop()


# The hand kernels a profile of the default app's JPEG tiles must name.
PROFILED_KERNELS = ("render_ramp_kernel", "jpeg_coefficients_kernel",
                    "sparse_pack_kernel", "compact_rows_kernel")


async def in_flight_gets(client, reqs, depth: int = 8) -> list:
    """``reqs`` with at most ``depth`` in flight: (status, wall ms, t_end)
    of each."""
    sem = asyncio.Semaphore(depth)

    async def one(r):
        async with sem:
            status, _, _, ms = await client.request(*r)
            return status, ms, time.perf_counter()
    return await asyncio.gather(*(one(r) for r in reqs))


async def forensics_phase(data_dir, lut_root, have_aiohttp, smi) -> dict:
    """The perf sentinel, the profiler and the forensics routes on the
    card.  A default app with a short sentinel cadence (tick 0.5 s, 8
    samples a window, 2 warm-up, confirm and recover ticks, a baseline
    step of 0.5, an incident bundle directory) serves 16 flagship 1024^2
    JPEG tiles at once, again and again, until its baseline is learned
    (and has come down from the first, cold window's p99); the fault
    injector's lane freeze (twice the learned p99 a group, at least 300
    ms) then induces drift: the sentinel must confirm ``drifting``,
    ``/readyz`` must carry it and one bundle must be written; without the
    freeze it must return to ``ok``.  A ``/debug/profile`` taken during
    an 8-in-flight burst must name the four hand kernels that served it
    (K1, K3, K4a, K4b), and a second request while it runs must answer
    409.  An OpenMetrics scrape must carry exemplars whose trace ids
    ``/debug/exemplars`` lists, ``/debug/explain`` of a served tile must
    report it resident, ``/debug/costs`` and ``/debug/decisions`` must be
    non-empty.  Returns the phase's kernel launches."""
    from omero_ms_image_region_tpu_torch.server import sentinel
    from omero_ms_image_region_tpu_torch.utils import faultinject

    work = tempfile.mkdtemp(prefix="forensics-", dir=os.path.dirname(
        data_dir))
    bundles = os.path.join(work, "bundles")
    config, handler = front_handler(data_dir, lut_root, {
        "sentinel": {"tick-interval-s": 0.5, "min-samples": 8,
                     "warmup-ticks": 2, "confirm-ticks": 2,
                     "recover-ticks": 2, "baseline-alpha": 0.5,
                     "bundle-dir": bundles, "profile-ms": 200},
        "telemetry": {"profile-dir": os.path.join(work, "profiles")},
        "fault-injection": {"seed": 14}})
    injector = faultinject.active()
    client = Client(config, handler, have_aiohttp)
    await client.start()
    engine = sentinel.active()
    route = "render_image_region"
    tiles = [(route, {"tile": f"0,{i % 8},{2 + i // 8},{TILE},{TILE}",
                      "c": CH, "m": "c", "format": "jpeg"})
             for i in range(16)]
    done = {"n": 0}

    async def serve_until(pred, limit_s: float, what: str) -> float:
        """The 16 tiles at once, again and again, until ``pred``."""
        t0 = time.perf_counter()
        while not await pred():
            check(time.perf_counter() - t0 < limit_s,
                  f"forensics: {what} not within {limit_s} s "
                  f"(windows: {engine.summary()['keys']})")
            out = await in_flight_gets(client, tiles, depth=len(tiles))
            check(all(o[0] == 200 for o in out),
                  f"forensics: a GET failed while waiting for {what}")
            done["n"] += len(out)
        return time.perf_counter() - t0

    async def verdict(want: str) -> bool:
        _, doc = await client.readyz()
        return doc["checks"].get("sentinel") == want

    async def learned() -> bool:
        """Warmed up, and the baseline has come down from the first cold
        window's p99 to within 1.3x of the steady windows'."""
        keys = engine.summary()["keys"]
        return engine.verdict == "ok" and any(
            k["baseline_ticks"] >= config.sentinel.warmup_ticks
            and k["p99_ms"] and k["n"] >= config.sentinel.min_samples
            and k["baseline_p99_ms"] < 1.3 * k["p99_ms"]
            for k in keys.values())

    try:
        reset_launch_counts()
        warm_s = await serve_until(learned, 120.0, "a learned baseline")
        baseline = {k: v["baseline_p99_ms"] for k, v in
                    engine.summary()["keys"].items()
                    if v["baseline_p99_ms"] is not None}
        # Drift: every group's lane freezes twice the learned p99 (at
        # least 300 ms), so each window's p99 passes 1.5x the baseline
        # whatever the host's speed.
        freeze_ms = max(300.0, 2.0 * max(baseline.values()))
        ticks0 = engine.ticks
        injector.config.freeze_ms = freeze_ms
        injector.config.freeze_rate = 1.0
        drift_s = await serve_until(lambda: verdict("drifting"), 60.0,
                                    "the drift verdict")
        drift_ticks = engine.ticks - ticks0
        injector.config.freeze_rate = 0.0
        recover_s = await serve_until(lambda: verdict("ok"), 60.0,
                                      "the recovery")
        names = sorted(os.listdir(bundles)) if os.path.isdir(bundles) \
            else []
        check(len(names) == 1, f"forensics: {len(names)} incident "
                               f"bundles, not 1")
        with open(os.path.join(bundles, names[0], "manifest.json")) as f:
            manifest = json.load(f)
        bundle_files = sorted(os.listdir(os.path.join(bundles, names[0])))
        check(all(manifest["files"].get(k) for k in (
            "flight", "costs", "sketch_diff", "exemplars", "profile")),
              f"forensics: the bundle lacks a file: {manifest['files']}")

        # A profile over an 8-in-flight burst, and a second one meanwhile.
        burst = [(route, dict(q, c=CH2)) for _, q in tiles] * 4
        outside = await in_flight_gets(client, burst)
        capture = asyncio.create_task(client.debug("profile", ms="1500"))
        await asyncio.sleep(0.2)
        t_cap = time.perf_counter()
        second = await client.debug("profile", ms="10")
        during = await in_flight_gets(client, burst)
        status, prof = await capture
        check(status == 200, f"forensics: /debug/profile answered "
                             f"{status}: {prof}")
        check(second[0] == 409, f"forensics: a second profile while one "
                                f"ran answered {second[0]}, not 409")
        with open(os.path.join(prof["dir"], "trace.json")) as f:
            trace = f.read()
        named = {k: trace.count(k) for k in PROFILED_KERNELS}
        check(all(named.values()), f"forensics: the profile does not name "
                                   f"every hand kernel: {named}")
        in_window = [ms for st, ms, t in during
                     if t <= t_cap + 1.5 and st == 200]
        check(all(o[0] == 200 for o in during + outside),
              "forensics: a burst GET failed")

        # Exemplars, explain, costs, decisions.
        om = await client.metrics(openmetrics=True)
        check(om.endswith("# EOF\n"), "forensics: the OpenMetrics scrape "
                                      "has no # EOF")
        import re
        tails = set(re.findall(r'trace_id="([0-9a-f]+)"', om))
        _, ex = await client.debug("exemplars")
        listed = {d["trace"] for docs in ex["request_duration_ms"].values()
                  for d in docs}
        check(tails and tails <= listed, "forensics: the OpenMetrics "
              "exemplars are not the ones /debug/exemplars lists")
        path = ("/webgateway/render_image_region/1/0/0?tile="
                + tiles[0][1]["tile"] + "&c=" + CH + "&m=c&format=jpeg")
        status, explained = await client.debug("explain", path=path)
        check(status == 200 and explained["residency"]["hbm"],
              f"forensics: /debug/explain of a served tile: {status} "
              f"{explained}")
        _, costs = await client.debug("costs")
        _, dec = await client.debug("decisions")
        verdicts = [r["verdict"] for r in dec["records"]
                    if r["kind"] == "sentinel"]
        check(costs["top"] and costs["shapes"],
              "forensics: /debug/costs is empty")
        check(verdicts == ["drift", "recovered"],
              f"forensics: decision records {verdicts}")
        launches = launch_counts()
        doc = {
            "gets": done["n"] + 2 * len(burst),
            "tick_s": config.sentinel.tick_interval_s,
            "baseline_s": warm_s, "baseline_p99_ms": baseline,
            "freeze_ms": freeze_ms,
            "drift_after_freeze": {"ticks": drift_ticks,
                                   "seconds": drift_s},
            "recover_s": recover_s,
            "bundle": {"name": names[0], "files": bundle_files,
                       "manifest_files": manifest["files"]},
            "profile": {"status": status, "ms": prof["ms"],
                        "bytes": prof["bytes"], "kernels_named": named,
                        "second_request": second[0]},
            "p50_ms_during_capture": statistics.median(in_window)
            if in_window else None,
            "p50_ms_outside_capture": statistics.median(
                [ms for _, ms, _ in outside]),
            "exemplar_traces": len(tails),
            "explain_residency": explained["residency"],
            "cost_shapes": {k: v["dispatches"]
                            for k, v in costs["shapes"].items()},
            "decisions": verdicts,
            "launches": {k: v for k, v in launches.items() if v},
            "card": smi, "via": client.via}
        print("forensics: " + json.dumps(doc), flush=True)
        for name in ("render_ramp",) + SPARSE_WIRE:
            check(launches[name] >= 1,
                  f"forensics: {name} was not launched")
        return launches
    finally:
        faultinject.uninstall()
        await client.stop()


async def pressure_phase(data_dir, lut_root, have_aiohttp, smi,
                         matches_plain) -> dict:
    """The pressure governor on the card: an app with ``pressure.enabled``
    (ticks of 0.25 s, a step a tick), a 64 MiB raw cache, ``hbm-high``
    0.5 and ``low`` 0.25, so that cold flagship tiles (8 MiB of planes
    each) drive the level to ``critical``, and ``evict-to-frac`` 0.2, so
    that the evictions bring it under ``low`` once traffic stops.  The
    ladder must engage in its configured order; while it is engaged (each
    check waits for the whole ladder, traffic running) a tile's JPEG must
    equal the plain route's at quality 60 byte for byte
    (``drop_quality``), a ``p=`` projection must answer 503 with
    Retry-After (``shed_bulk``) and 16 tiles at once must run one group
    on a lane at a time (``cap_lanes``); once traffic stops the ladder
    must release in exact reverse.  Prints each transition with its time
    and the tile p50 under each rung.  Returns the phase's kernel
    launches."""
    from omero_ms_image_region_tpu_torch.server import pressure
    from omero_ms_image_region_tpu_torch.utils import telemetry

    config, handler = front_handler(data_dir, lut_root, {
        # A ring that holds the phase's events (every group records one).
        "telemetry": {"flight-recorder-events": 1 << 16},
        # Eight tiles' planes (64 MiB of 4-channel uint16 1024^2 tiles).
        "raw-cache": {"prefetch": False, "max-bytes": 8 * 4 * TILE * TILE * 2},
        "pressure": {"enabled": True, "interval-s": 0.25, "hbm-high": 0.5,
                     "hbm-low": 0.25, "evict-to-frac": 0.2,
                     "step-hold-ticks": 1, "release-hold-ticks": 3}})
    batcher = handler.s.renderer
    client = Client(config, handler, have_aiohttp)
    await client.start()
    gov = pressure.active()
    ladder = list(gov.ladder)
    route = "render_image_region"
    cold = [(route, {"tile": f"0,{i % 8},{i // 8},{TILE},{TILE}",
                     "c": CH, "m": "c", "format": "jpeg"})
            for i in range(64)]
    by_rung: dict = {}
    t0, wall0 = time.perf_counter(), time.time()
    stop = asyncio.Event()

    async def traffic():
        i = 0
        while not stop.is_set():
            reqs = [cold[(i + k) % len(cold)] for k in range(8)]
            i += 8
            rung = gov.engaged
            for status, ms, _ in await in_flight_gets(client, reqs):
                check(status == 200, f"pressure: a cold GET answered "
                                     f"{status} under rung {rung}")
                by_rung.setdefault(rung, []).append(ms)

    async def fully_engaged(what: str) -> None:
        """Wait (traffic running) until every step is engaged."""
        t_wait = time.perf_counter()
        while gov.engaged < len(ladder):
            check(time.perf_counter() - t_wait < 60.0 and not load.done(),
                  f"pressure: the ladder was not fully engaged {what} "
                  f"within 60 s ({gov.summary()})")
            await asyncio.sleep(0.02)

    load = None
    try:
        reset_launch_counts()
        load = asyncio.create_task(traffic())
        await fully_engaged("at first")
        t_full = time.perf_counter() - t0
        q = {"tile": f"0,3,7,{TILE},{TILE}", "c": CH2, "m": "c",
             "format": "jpeg"}
        await fully_engaged("for drop_quality")
        status, hdrs, body, capped_ms = await client.request(route, q)
        _, _, _, same = await matches_plain(route, dict(q, q="0.6"), body)
        check(status == 200 and same and hdrs.get("Cache-Control")
              == "no-store" and "ETag" not in hdrs,
              f"pressure: the drop_quality tile ({status}, "
              f"{hdrs.get('Cache-Control')}) is not the plain route's at "
              f"quality 60")
        pq = {"imageId": ZSTACK_IMAGE, "c": CH, "m": "c", "format": "jpeg",
              "p": f"intmax|0:{Z_STACK - 1}"}
        await fully_engaged("for shed_bulk")
        shed_status, shed_hdrs, _, _ = await client.request(route, pq)
        check(shed_status == 503 and int(shed_hdrs.get("Retry-After", 0))
              >= 1, f"pressure: the p= GET under shed_bulk answered "
                    f"{shed_status}")
        await fully_engaged("for cap_lanes")
        groups0 = batcher.batches_dispatched
        batcher.max_executing = 0
        # 16 distinct tiles at once: at least two groups (max-batch 8)
        # that two lanes would run together.
        burst = [(route, dict(q, tile=f"0,{i % 8},{6 + i // 8},{TILE},"
                                      f"{TILE}", c=CH2))
                 for i in range(16)]
        capped = await in_flight_gets(client, burst, depth=16)
        lanes = {"max_groups_in_execute": batcher.max_executing,
                 "groups": batcher.batches_dispatched - groups0,
                 "device_lanes": batcher.device_lanes}
        check(all(c[0] == 200 for c in capped)
              and lanes["max_groups_in_execute"] == 1
              and lanes["groups"] >= 2,
              f"pressure: cap_lanes did not leave one lane taking groups "
              f"({lanes})")
        stop.set()
        await load
        t_stop, stop_wall = time.perf_counter(), time.time()
        at_stop = gov.engaged
        while gov.engaged or gov.level:
            check(time.perf_counter() - t_stop < 60.0,
                  f"pressure: the ladder did not release in 60 s "
                  f"({gov.summary()})")
            await asyncio.sleep(0.05)
        events = [e for e in telemetry.FLIGHT.snapshot()
                  if e["ts"] >= wall0 - 0.001]
        base = wall0
        steps = [(e["action"], e["step"], round(e["ts"] - base, 3))
                 for e in events if e["kind"] == "pressure.step"]
        levels = [(e["prev"], e["level"], round(e["ts"] - base, 3))
                  for e in events if e["kind"] == "pressure.level"]
        # Every transition keeps the engaged set a prefix of the ladder:
        # an engage takes the next step, a release gives back the last.
        stack, ordered = [], True
        for action, step, _ in steps:
            if action == "engage":
                ordered &= len(stack) < len(ladder) \
                    and step == ladder[len(stack)]
                stack.append(step)
            else:
                ordered &= bool(stack) and step == stack[-1]
                stack = stack[:-1]
        released = [e["step"] for e in events if e["kind"] ==
                    "pressure.step" and e["action"] == "release"
                    and e["ts"] >= stop_wall - 0.001]
        launches = launch_counts()
        doc = {
            "ladder": ladder, "steps": steps, "levels": levels,
            "p50_ms_by_rung": {
                (ladder[r - 1] if r else "none"): {
                    "gets": len(v), "p50_ms": statistics.median(v)}
                for r, v in sorted(by_rung.items())},
            "fully_engaged_s": t_full, "engaged_at_stop": at_stop,
            "capped_tile_ms": capped_ms, "shed_status": shed_status,
            "retry_after": shed_hdrs.get("Retry-After"),
            "cap_lanes": lanes,
            "release_s": time.perf_counter() - t_stop,
            "launches": {k: v for k, v in launches.items() if v},
            "card": smi, "via": client.via}
        print("pressure: " + json.dumps(doc), flush=True)
        check(ordered and not stack, "pressure: a transition broke the "
                                     "ladder's prefix order")
        check(at_stop >= 1 and released == ladder[:at_stop][::-1],
              f"pressure: released {released} after traffic stopped, not "
              f"the exact reverse of {ladder[:at_stop]}")
        return launches
    finally:
        stop.set()
        if load is not None:
            await asyncio.gather(load, return_exceptions=True)
        await client.stop()


def front_cost_phase(smi: str, n: int = 10_000) -> None:
    """The host cost the front adds to a GET outside any I/O: a trace
    opened and finished, 11 spans (a cold device-route GET's), admission
    admit and release, the ETag, the cache and Last-Modified headers, the
    conditional decision and the request series.  Median of ``n``."""
    from omero_ms_image_region_tpu_torch.server import httpcache
    from omero_ms_image_region_tpu_torch.server.admission import (
        AdmissionController)
    from omero_ms_image_region_tpu_torch.server.app import (
        conditional_answer)
    from omero_ms_image_region_tpu_torch.utils import telemetry
    from omero_ms_image_region_tpu_torch.utils.stopwatch import (
        StopWatchRegistry)

    registry = StopWatchRegistry()
    hist = telemetry.HistogramVec("route")
    adm = AdmissionController(512)
    names = ("get_pixels_description", "canRead", "canRead",
             "PixelsService.getPixelBuffer", "PixelsService.readRegion",
             "batcher.queueWait", "batcher.stage", "batcher.groupTiles",
             "Renderer.renderAsPackedInt.batch", "jfif.encodeBatch",
             "Renderer.renderAsPackedInt")
    key, mtime = "5d41402abc4b2a76b9719d911017c592", 1.7e9
    times = []
    for _ in range(n):
        t0 = time.perf_counter_ns()
        trace_id = telemetry.new_trace_id()
        with telemetry.trace_scope(trace_id, "render_image_region"):
            etag = httpcache.etag_for(key, "0")
            cc, vary = httpcache.cache_headers(0, False)
            headers = {"ETag": etag, "Cache-Control": cc,
                       "Last-Modified": httpcache.http_date(
                           httpcache.last_modified_basis(mtime, "0"))}
            if vary:
                headers["Vary"] = vary
            conditional_answer({}, "GET", etag, mtime)
            t_admit = adm.admit()
            for name in names:
                registry.record(name, 1.0)
            adm.release(t_admit)
        telemetry.TRACES.finish(trace_id)
        hist.observe("render_image_region", 1.0)
        telemetry.count_request("front_cost", 200)
        times.append(time.perf_counter_ns() - t0)
    times.sort()
    print("front_cost: " + json.dumps({
        "iterations": n, "p50_us": times[n // 2] / 1e3,
        "p90_us": times[int(n * 0.9)] / 1e3, "spans_per_get": len(names),
        "card": smi}), flush=True)


def plain_matcher(torch, np, handler, have_pil):
    """``matches_plain(route, query, body)``: the served body against the
    plain route on a host read of the same request (png: pixels;
    device-route JPEG: bytes against plain K1/K2 -> plain K3 -> plain K4 ->
    the native coder; host JPEG: bytes against PIL over the plain
    pixels)."""
    from omero_ms_image_region_tpu_torch import codecs
    from omero_ms_image_region_tpu_torch.ops import render as R
    from omero_ms_image_region_tpu_torch.ops.flip import flip_image
    from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx

    async def matches_plain(route, query, body):
        ctx = ImageRegionCtx.from_params(params_of(route, query))
        raw, settings = await handler.read(ctx)
        h, w = raw.shape[-2:]
        if ctx.format == "jpeg" and h * w > handler.s.jpeg_host_max_px:
            return "device jpeg", list(raw.shape), settings, (
                body == plain_jpeg(torch, ctx, raw, settings))
        t = R.settings_to_tensors(settings, DEVICE)
        plain = R.render_tile_batch_packed_plain(
            R.raw_to_tensor(raw, DEVICE)[None], *R.batched_settings(t))
        plain = flip_image(plain[0], ctx.flip_horizontal, ctx.flip_vertical)
        want_rgba = R.unpack_rgba(plain.cpu().numpy())
        if ctx.format == "png" and have_pil:
            got_rgba = codecs.decode_to_rgba(body)
            return "png", list(raw.shape), settings, np.array_equal(
                got_rgba[..., :3], want_rgba[..., :3])
        return f"host {ctx.format}", list(raw.shape), settings, (
            body == codecs.encode_rgba(want_rgba, ctx.format,
                                       ctx.compression_quality))

    return matches_plain


def frames_of(body: bytes):
    """The frame bodies of an animation stream, in order."""
    out, i = [], 0
    while i < len(body):
        check(body[i:i + 4] == b"FRME", "animation: a record without FRME")
        n = int.from_bytes(body[i + 4:i + 8], "big")
        out.append(body[i + 8:i + 8 + n])
        i += 8 + n
    return out


async def workload_phases(torch, np, client, handler, data_dir, lut_root,
                          matches_plain) -> dict:
    """The projection, mask, overlay and animation routes through the
    default app; each phase's kernel launches (counts set to 0 just
    before it, read just after)."""
    from omero_ms_image_region_tpu_torch import codecs
    from omero_ms_image_region_tpu_torch.models.rendering import Projection
    from omero_ms_image_region_tpu_torch.ops import maskops as M
    from omero_ms_image_region_tpu_torch.ops import projection as P
    from omero_ms_image_region_tpu_torch.server.app import build_handler
    from omero_ms_image_region_tpu_torch.server.ctx import (
        ImageRegionCtx, ShapeMaskCtx)
    from omero_ms_image_region_tpu_torch.server.handler import (
        ShapeMaskHandler)
    from omero_ms_image_region_tpu_torch.server.region import RegionDef
    from omero_ms_image_region_tpu_torch.utils import telemetry
    from omero_ms_image_region_tpu_torch.utils.color import (
        split_html_color)

    batcher, cache = handler.s.renderer, handler.s.raw_cache
    reference = build_handler(data_dir, lut_root, device=DEVICE,
                              batcher=False)
    phases = {}

    async def direct(route, query) -> bytes:
        return await reference.render_image_region(
            ImageRegionCtx.from_params(params_of(route, query)))

    # projection: p= over the Z-stack's 32 planes, JPEG and PNG, each
    # equal to the batcher=False reference; a repeat hits the raw cache's
    # proj entries; then one channel folded on the host and by K7.
    reset_launch_counts()
    stats = Batches(batcher)
    gets = []
    for alg in ("intmax", "intmean", "intsum"):
        for fmt in ("jpeg", "png"):
            q = {"imageId": ZSTACK_IMAGE, "c": CH, "m": "c",
                 "format": fmt, "p": f"{alg}|0:{Z_STACK - 1}"}
            status, _, body, ms = await client.request(
                "render_image_region", q)
            check(status == 200, f"projection {alg} {fmt}: HTTP {status}")
            check(body == await direct("render_image_region", q),
                  f"projection {alg} {fmt}: body differs from the "
                  f"batcher=False reference")
            gets.append([alg, fmt, len(body), ms])
    hits0, misses0 = cache.hits, cache.misses
    q = {"imageId": ZSTACK_IMAGE, "c": CH2, "m": "c", "format": "jpeg",
         "p": f"intmax|0:{Z_STACK - 1}"}
    status, _, body, repeat_ms = await client.request(
        "render_image_region", q)
    check(status == 200 and body == await direct("render_image_region", q),
          "projection: the re-windowed repeat differs from the reference")
    repeat_hits = cache.hits - hits0
    check(repeat_hits == 4 and cache.misses == misses0,
          f"projection: the repeat made {repeat_hits} raw-cache hits and "
          f"{cache.misses - misses0} misses (want 4 proj hits)")
    src = handler.s.pixels_service.get_pixel_source(int(ZSTACK_IMAGE))
    full = RegionDef(0, 0, TILE, TILE)

    def get_plane(z):
        return src.get_region(z, 0, 0, full, 0)

    folds = {}
    for alg in (Projection.MAXIMUM_INTENSITY, Projection.MEAN_INTENSITY):
        outs = {}
        for placement in ("host", "device"):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                outs[placement] = P.project_planes(
                    get_plane, alg, Z_STACK, 0, Z_STACK - 1, 1, 65535.0,
                    shape=(TILE, TILE), placement=placement, device=DEVICE)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            folds[f"{alg.name.lower()}_{placement}_fold_ms"] = \
                statistics.median(times)
        check(torch.equal(outs["host"], outs["device"]),
              f"projection: the K7 fold of {alg.name} differs from the "
              f"host fold")
    t0 = time.perf_counter()
    for z in range(Z_STACK):
        get_plane(z)
    folds["read_32_planes_ms"] = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    groups = stats.report()
    proj = {"gets": gets, "repeat_raw_cache_hits": repeat_hits,
            "repeat_ms": repeat_ms,
            "proj_entries": sum(1 for k in list(cache._entries)
                                if k[0] == "proj"),
            "one_channel_32_planes": folds,
            "mean_group_size": groups["mean_group_size"],
            "launches": launches, "via": client.via}
    print("projection: " + json.dumps(proj), flush=True)
    for name in ("project_fold", "render_ramp", "jpeg_coefficients",
                 "sparse_pack", "compact_rows"):
        check(launches[name] >= 1,
              f"projection: {name} was not launched")
    phases["projection"] = launches

    # masks: 8 same-shape masks at once (one key of the mask lane), each
    # PNG the host rasterizer's; a colour override, flips, a payload with
    # a ragged end, a 304 and a 404.
    meta = handler.s.metadata

    async def host_png(sid, query):
        mask = await meta.get_mask(sid, None)
        ctx = ShapeMaskCtx.from_params(dict(query, shapeId=str(sid)))
        color = split_html_color(query["color"]) if "color" in query \
            else None
        return ShapeMaskHandler._render(mask, color, ctx)

    reset_launch_counts()
    stats = Batches(batcher)
    t0 = time.perf_counter()
    outs = await asyncio.gather(*(
        client.request("render_shape_mask", {}, image=str(sid))
        for sid in range(1, 9)))
    burst_ms = (time.perf_counter() - t0) * 1e3
    burst = stats.report()
    for sid, (status, _, body, _) in zip(range(1, 9), outs):
        check(status == 200 and body == await host_png(sid, {}),
              f"masks: mask {sid} differs from the host rasterizer")
    extra = [(9, {"flip": "h"}), (9, {"flip": "v", "color": "00FF0080"}),
             (10, {"flip": "hv"}), (10, {}), (1, {"color": "FF000080"})]
    for sid, query in extra:
        status, _, body, _ = await client.request(
            "render_shape_mask", query, image=str(sid))
        check(status == 200 and body == await host_png(sid, query),
              f"masks: mask {sid} {query} differs from the host rasterizer")
    status_304, _, body_304, _ = await client.request(
        "render_shape_mask", {}, headers={"If-None-Match":
                                          outs[0][1]["ETag"]}, image="1")
    status_404, _, _, _ = await client.request("render_shape_mask", {},
                                               image="99")
    launches = launch_counts()
    masks = {"burst": {"gets": 8, "wall_ms": burst_ms,
                       "mean_group_size": burst["mean_group_size"],
                       "group_sizes": burst["group_sizes"]},
             "checked": 8 + len(extra), "not_modified": status_304,
             "missing": status_404, "launches": launches,
             "via": client.via}
    print("masks: " + json.dumps(masks), flush=True)
    check(burst["mean_group_size"] >= 2,
          "masks: the 8 same-shape masks did not group")
    check(status_304 == 304 and body_304 == b"" and status_404 == 404,
          "masks: the 304 or the 404 went wrong")
    check(launches["mask_rasterize"] >= 1,
          "masks: mask_rasterize was not launched")
    phases["masks"] = launches

    # overlay: masks 2 and 3 over a 1024^2 region, against the host path
    # (the base PNG decoded, the host grids, overlay_masks_batch).
    base_q = {"tile": f"0,2,3,{TILE},{TILE}", "c": CH, "m": "c",
              "format": "png"}
    _, _, base_png, _ = await client.request("render_image_region", base_q)
    _, _, _, base_same = await matches_plain("render_image_region", base_q,
                                             base_png)
    check(base_same, "overlay: the base differs from the plain route")
    reset_launch_counts()
    status, _, body, overlay_ms = await client.request(
        "render_overlay", dict(base_q, shapes="2,3"))
    launches = launch_counts()
    want = codecs.decode_to_rgba(base_png)
    for sid in (2, 3):
        mask = await meta.get_mask(sid, None)
        grid, palette = M.rasterize_mask(mask)
        want = M.overlay_masks_batch(want[None], grid[None],
                                     palette[1][None])[0]
    check(status == 200 and body == codecs.encode_rgba(want, "png"),
          "overlay: the composite differs from the host path")
    overlay = {"status": status, "bytes": len(body), "wall_ms": overlay_ms,
               "launches": launches, "via": client.via}
    print("overlay: " + json.dumps(overlay), flush=True)
    check(launches["mask_rasterize"] >= 2 and launches["mask_overlay"] >= 2,
          "overlay: K8a and K8b were not launched for each shape")
    phases["overlay"] = launches

    # animation: 8 z frames of the Z-stack as JPEG, in order, each the
    # plain route's bytes for its plane.
    reset_launch_counts()
    stats = Batches(batcher)
    q = {"imageId": ZSTACK_IMAGE, "c": CH, "m": "c", "format": "jpeg",
         "axis": "z", "frames": "8"}
    status, hdrs, body, anim_ms = await client.request("render_animation",
                                                       q)
    launches = launch_counts()
    groups = stats.report()
    check(status == 200, f"animation: HTTP {status}")
    frames = frames_of(body)
    check(len(frames) == 8, f"animation: {len(frames)} frames")
    for z, frame in enumerate(frames):
        fq = {"imageId": ZSTACK_IMAGE, "theZ": str(z), "c": CH, "m": "c",
              "format": "jpeg"}
        _, _, plain_body, _ = await client.request("render_image_region",
                                                   fq)
        _, _, _, same = await matches_plain("render_image_region", fq,
                                            frame)
        check(frame == plain_body and same,
              f"animation: frame {z} differs from the plain route")
    anim = {"frames": len(frames), "bytes": len(body), "wall_ms": anim_ms,
            "first_frame_ms": telemetry.WORKLOADS.first_frame_ms,
            "content_type": hdrs.get("Content-Type"),
            "mean_group_size": groups["mean_group_size"],
            "group_sizes": groups["group_sizes"], "launches": launches,
            "via": client.via}
    print("animation: " + json.dumps(anim), flush=True)
    check(launches["render_ramp"] >= 1 and launches["compact_rows"] >= 1,
          "animation: the render and JPEG kernels were not launched")
    phases["animation"] = launches
    await reference.s.renderer.close()
    return phases


# The res-0 checked requests served again from images 3 and 4: png, a LUT
# channel png, three device-route JPEGs (q 0.9, flip h, LUT) and a
# render_image region.
READER_GETS = (0, 4, 6, 7, 8, 10)
RGB_CH = "1|0:255$FF0000,2|0:255$00FF00,3|0:255$0000FF"


def read_span_ms(telemetry) -> list:
    """Per-request ``PixelsService.readRegion`` ms of the traces since
    the last reset."""
    return [v for v in (t.span_ms("PixelsService.readRegion")
                        for t in telemetry.TRACES.recent()) if v is not None]


async def readers_phase(torch, np, client, handler, data_dir, requests,
                        results) -> dict:
    """Image 1's res-0 GETs served from images 3 (OME-TIFF) and 4 (NGFF),
    each byte-equal to image 1's; one 1024^2 device-route JPEG of image 5
    (JPEG-in-TIFF) equal to the plain route over the reader's pixels, and
    those pixels within the decoders' IDCT rounding (2) of the Python
    decoder's; then each reader's cold read span.  Returns the phase's
    kernel launches."""
    from omero_ms_image_region_tpu_torch.io.jpegdec import (
        decode_baseline_jpeg, ycbcr_to_rgb)
    from omero_ms_image_region_tpu_torch.io.tiff import (
        TILE_BYTE_COUNTS, TILE_OFFSETS, TiffFile)
    from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx
    from omero_ms_image_region_tpu_torch.utils import telemetry
    from omero_ms_image_region_tpu_torch.utils.stopwatch import REGISTRY

    reset_launch_counts()
    gets = []
    for i in READER_GETS:
        route, query = requests[i]
        want = results[i][1]
        for fmt, image in READER_IMAGES.items():
            status, _, body, ms = await client.request(route, query,
                                                       image=image)
            check(status == 200 and body == want,
                  f"readers: image {image} ({fmt}) {query}: HTTP {status}, "
                  f"body {'equal' if body == want else 'differs'} to "
                  f"image 1's")
            gets.append([fmt, i, query["format"], len(body), round(ms, 2)])

    # Image 5: the reader's pixels (the native decoder) give the served
    # bytes; the Python decoder's pixels, the plain version, agree within
    # the IDCT rounding the two decoders differ by.
    q = {"tile": f"0,1,1,{TILE},{TILE}", "c": RGB_CH, "m": "c",
         "format": "jpeg"}
    status, _, body, ms = await client.request("render_image_region", q,
                                               image=JPEG_IMAGE)
    check(status == 200, f"readers: image {JPEG_IMAGE}: HTTP {status}")
    ctx = ImageRegionCtx.from_params(params_of("render_image_region", q,
                                               JPEG_IMAGE))
    raw, settings = await handler.read(ctx)
    same = body == plain_jpeg(torch, ctx, raw, settings)
    tf = TiffFile(os.path.join(data_dir, JPEG_IMAGE, "rgb.tif"))
    ifd, per_row = tf.ifds[0], RGB_PLANE // JPEG_TILE
    python = np.empty((TILE, TILE, 3), np.uint8)
    t0 = time.perf_counter()
    k = TILE // JPEG_TILE
    for gy in range(k):
        for gx in range(k):
            idx = (k + gy) * per_row + k + gx
            seg = tf._pread(int(ifd.get(TILE_OFFSETS)[idx]),
                            int(ifd.get(TILE_BYTE_COUNTS)[idx]))
            python[gy * JPEG_TILE:(gy + 1) * JPEG_TILE,
                   gx * JPEG_TILE:(gx + 1) * JPEG_TILE] = ycbcr_to_rgb(
                decode_baseline_jpeg(seg))
    python_ms = (time.perf_counter() - t0) * 1e3
    tf.close()
    python = python.transpose(2, 0, 1)
    d = np.abs(python.astype(np.int16) - raw.astype(np.int16))
    jpeg_tiff = {"bytes": len(body), "wall_ms": ms,
                 "matches_plain_over_reader_pixels": same,
                 "python_decoder_ms": python_ms,
                 "python_vs_native_max_abs": int(d.max()),
                 "python_vs_native_differing": int((d > 0).sum()),
                 "matches_plain_over_python_pixels":
                     body == plain_jpeg(torch, ctx, python, settings)}
    check(same, f"readers: image {JPEG_IMAGE}: served bytes differ from "
                f"the plain route over the reader's pixels")
    check(d.max() <= 2, f"readers: image {JPEG_IMAGE}: the Python and "
                        f"native decoders differ by {int(d.max())} > 2")
    launches = launch_counts()
    for name in ("render_ramp", "render_lut", *SPARSE_WIRE):
        check(launches[name] >= 1,
              f"readers: {name} was not launched by the reader GETs")

    # Cold reads: 8 row-0 device-route JPEG tiles of each image (raw cache
    # cleared, the files in the page cache since they were written).
    cold = {}
    for fmt, image in (("chunked", "1"), *READER_IMAGES.items()):
        handler.s.raw_cache.clear()
        reset_spans(telemetry, REGISTRY)
        walls = []
        for x in range(8):
            status, _, _, ms = await client.request(
                "render_image_region",
                {"tile": f"0,{x},0,{TILE},{TILE}", "c": CH, "m": "c",
                 "format": "jpeg"}, image=image)
            check(status == 200, f"readers: cold {fmt}: HTTP {status}")
            walls.append(ms)
        await settled(handler.s.renderer)
        spans = read_span_ms(telemetry)
        check(len(spans) == 8, f"readers: cold {fmt}: {len(spans)} reads")
        cold[fmt] = {"read_p50_ms": statistics.median(spans),
                     "read_max_ms": max(spans),
                     "get_p50_ms": statistics.median(walls)}
    print("readers: " + json.dumps({
        "gets": gets, "bodies_equal_image_1": True,
        "jpeg_tiff": jpeg_tiff, f"cold_reads_4x{TILE}^2_u16": cold,
        "launches": launches, "via": client.via}), flush=True)
    return launches


def metric_value(scrape: str, name: str) -> float:
    for line in scrape.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return 0.0


async def pyramid_phase(torch, np, client, handler, data_dir) -> dict:
    """``POST /pyramid`` for image 3 through the default app, polled to
    its end: every level it commits equals image 1's store level, bit for
    bit; a resolution-2 GET on image 3, now served from the pyramid,
    equals image 1's; ``imageregion_pyramid_levels_committed_total`` rose
    by the level count; K9 ran once per level step.  Returns the phase's
    kernel launches."""
    from omero_ms_image_region_tpu_torch.io.ngff import NgffZarrSource
    from omero_ms_image_region_tpu_torch.io.store import ChunkedPyramidStore
    from omero_ms_image_region_tpu_torch.server.region import RegionDef
    from omero_ms_image_region_tpu_torch.utils.stopwatch import REGISTRY

    image = READER_IMAGES["ome-tiff"]
    committed0 = metric_value(await client.metrics(),
                              "imageregion_pyramid_levels_committed_total")
    REGISTRY.reset()
    reset_launch_counts()
    t0 = time.perf_counter()
    status, doc = await client.submit_pyramid(image)
    check(status == 202, f"pyramid: POST answered {status}: {doc}")
    for _ in range(3000):
        status, doc = await client.pyramid_job(doc["jobId"])
        if doc["state"] in ("done", "failed"):
            break
        await asyncio.sleep(0.1)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    check(doc["state"] == "done", f"pyramid: the job ended {doc}")
    n = doc["levelsTotal"]
    check(launches["mean2_int"] == n - 1,
          f"pyramid: K9 launched {launches['mean2_int']} times for "
          f"{n - 1} level steps")
    spans = {k: v["total_ms"] for k, v in REGISTRY.snapshot().items()
             if k.startswith("pyramid.")}
    committed = metric_value(await client.metrics(),
                             "imageregion_pyramid_levels_committed_total")
    check(committed - committed0 == n,
          f"pyramid: levels_committed_total rose by "
          f"{committed - committed0}, not {n}")

    # Every level equals image 1's store level, bit for bit.
    store = ChunkedPyramidStore(os.path.join(data_dir, "1"))
    built = NgffZarrSource(doc["dest"])
    check(built.resolution_descriptions()
          == store.resolution_descriptions()[:n],
          "pyramid: the level table differs from image 1's")
    t1 = time.perf_counter()
    for level, (sx, sy) in enumerate(built.resolution_descriptions()):
        for c in range(4):
            full = RegionDef(0, 0, sx, sy)
            check(np.array_equal(built.get_region(0, c, 0, full, level),
                                 store.get_region(0, c, 0, full, level)),
                  f"pyramid: level {level} channel {c} differs from "
                  f"image 1's")
    compare_s = time.perf_counter() - t1
    check(type(handler.s.pixels_service.get_pixel_source(int(image)))
          is NgffZarrSource, "pyramid: image 3 is not served from its "
                             "pyramid after the commit")
    res2 = []
    for fmt in ("jpeg", "png"):
        q = {"tile": f"2,1,1,{TILE},{TILE}", "c": CH, "m": "c",
             "format": fmt}
        status1, _, body1, _ = await client.request("render_image_region",
                                                     q, image="1")
        status3, _, body3, _ = await client.request("render_image_region",
                                                     q, image=image)
        check(status1 == status3 == 200 and body1 == body3,
              f"pyramid: resolution-2 {fmt} of image 3 ({status3}) "
              f"differs from image 1's ({status1})")
        res2.append([fmt, len(body3)])
    print("pyramid: " + json.dumps({
        "job": {k: doc[k] for k in ("state", "levelsTotal", "levelsDone",
                                    "resumed")},
        "wall_s": wall, "split_ms": spans,
        "mean2_int_launches": launches["mean2_int"],
        "levels_committed": committed - committed0,
        "levels_equal_image_1": True, "compare_s": compare_s,
        "res2_gets_equal_image_1": res2, "via": client.via}), flush=True)
    return launches


# The OMERO deployment (omero:): the repository images' ids, the legacy
# buffer's pixels id (Pixels/Dir-001/1012: the Dir-### fan-out), the
# OMERO.web cookies and the OMERO sessions their Django sessions hold.
OMERO_IMAGES = {"ome-tiff": "11", "romio": "12", "jp2k-33005": "13",
                "jp2k-33003": "14"}
PRIVATE_IMAGE = "15"
OMERO_SIZE = 2048
ROMIO_PIXELS_ID = 1012
J2K_TILE = 512
OMERO_COOKIES = {"ck-owner": "sess-owner", "ck-member": "sess-member",
                 "ck-outsider": "sess-outsider"}
OMERO_DSN = "postgresql://omero@localhost/omero"
OMERO_SCHEMA = """
CREATE TABLE experimentergroup (id INTEGER PRIMARY KEY, name TEXT,
                                permissions INTEGER);
CREATE TABLE experimenter (id INTEGER PRIMARY KEY, omename TEXT);
CREATE TABLE groupexperimentermap (child INTEGER, parent INTEGER);
CREATE TABLE session (id INTEGER PRIMARY KEY, uuid TEXT, owner INTEGER,
                      closed TEXT);
CREATE TABLE image (id INTEGER PRIMARY KEY, owner_id INTEGER,
                    group_id INTEGER, fileset INTEGER);
CREATE TABLE fileset (id INTEGER PRIMARY KEY, templateprefix TEXT);
CREATE TABLE filesetentry (id INTEGER PRIMARY KEY, fileset INTEGER,
                           originalfile INTEGER, clientpath TEXT);
CREATE TABLE originalfile (id INTEGER PRIMARY KEY, path TEXT, name TEXT,
                           mimetype TEXT);
CREATE TABLE pixelstype (id INTEGER PRIMARY KEY, value TEXT);
CREATE TABLE pixels (id INTEGER PRIMARY KEY, image INTEGER, sizex INTEGER,
                     sizey INTEGER, sizez INTEGER, sizec INTEGER,
                     sizet INTEGER, pixelstype INTEGER);
CREATE TABLE shape (id INTEGER PRIMARY KEY, roi INTEGER, owner_id INTEGER,
                    group_id INTEGER, width INTEGER, height INTEGER,
                    bytes BLOB, fillcolor INTEGER);
CREATE TABLE django_session (session_key TEXT PRIMARY KEY,
                             session_data TEXT, expire_date TEXT);
"""


class SqliteAsyncDb:
    """The ``AsyncDb`` (``fetchrow`` / ``fetch``) the port's Postgres
    session store and metadata service run on in this script: an
    OMERO-schema subset in a sqlite file, the services' PostgreSQL
    statements run as written but for ``$N`` -> ``?`` and ``now()`` ->
    ``CURRENT_TIMESTAMP``.  It counts statements, the Django-session
    lookups apart.  It proves the statements and the ACL arithmetic, not
    a live Postgres: no pool, no network round trip, no server-side plan
    or lock."""

    def __init__(self, path: str):
        import sqlite3

        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.conn.row_factory = sqlite3.Row
        self.statements = 0
        self.session_statements = 0

    def _run(self, sql, args):
        import re

        if "django_session" in sql:
            self.session_statements += 1
        else:
            self.statements += 1
        return self.conn.execute(re.sub(r"\$\d+", "?", sql).replace(
            "now()", "CURRENT_TIMESTAMP"), args)

    async def fetchrow(self, sql, *args):
        row = self._run(sql, args).fetchone()
        return None if row is None else dict(row)

    async def fetch(self, sql, *args):
        return [dict(r) for r in self._run(sql, args).fetchall()]


def write_j2k_tiff(np, path, rgb, compression: int) -> None:
    """An Aperio-style tiled TIFF whose 512^2 tiles are raw J2K
    codestreams from PIL (lossy 9/7 at a 20:1 rate): 33005 RGB with the
    codestream's colour transform on, 33003 YCbCr planes with it off (the
    photometric 6 convention), written with the port's ``_TiffOut``."""
    import io

    from PIL import Image

    from omero_ms_image_region_tpu_torch.io.tiffwrite import _TiffOut

    h, w, _ = rgb.shape
    ycc = compression == 33003
    with open(path, "wb") as f:
        out = _TiffOut(f, big=False)
        offs, cnts = [], []
        for y in range(0, h, J2K_TILE):
            for x in range(0, w, J2K_TILE):
                t = rgb[y:y + J2K_TILE, x:x + J2K_TILE]
                if ycc:
                    r, g, b = (t[..., i].astype(np.float32)
                               for i in range(3))
                    t = np.stack([
                        0.299 * r + 0.587 * g + 0.114 * b,
                        128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b,
                        128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b],
                        -1).round().clip(0, 255).astype(np.uint8)
                buf = io.BytesIO()
                Image.fromarray(np.ascontiguousarray(t)).save(
                    buf, "JPEG2000", irreversible=True, no_jp2=True,
                    quality_mode="rates", quality_layers=[20],
                    mct=0 if ycc else 1)
                out.align()
                offs.append(out.write(buf.getvalue()))
                cnts.append(len(buf.getvalue()))
        ifd, _ = out.write_ifd([
            (256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]),
            (259, 3, [compression]), (262, 3, [6 if ycc else 2]),
            (277, 3, [3]), (284, 3, [1]), (322, 4, [J2K_TILE]),
            (323, 4, [J2K_TILE]), (324, 4, offs), (325, 4, cnts)])
        out.patch_first_ifd(ifd)


def build_omero(np, data_dir: str, root: str):
    """The OMERO deployment under ``root``: the binary repository (image
    3's OME-TIFF hard-linked into a ManagedRepository fileset; a
    big-endian 2048^2 x 4 uint16 ROMIO buffer cropped from image 1's level
    0; two Aperio-style JP2K TIFFs, 33005 and 33003, of 2048^2 RGB from
    the same crop), an empty data directory, and the OMERO schema in
    sqlite: the public group holds images 11-14 (owner and member in it,
    the outsider reading by the world bit), the private group image 15;
    live Django sessions for the three cookies, and an expired one."""
    import base64
    import pickle

    from omero_ms_image_region_tpu_torch.io.ometiff import find_tiff
    from omero_ms_image_region_tpu_torch.io.store import ChunkedPyramidStore
    from omero_ms_image_region_tpu_torch.server.region import RegionDef
    from omero_ms_image_region_tpu_torch.services.db_metadata import (
        _romio_rel_path)

    t0 = time.perf_counter()
    repo = os.path.join(root, "OMERO")
    prefix = "user-1_100/2026-10/17"
    managed = os.path.join(repo, "ManagedRepository", prefix)
    os.makedirs(managed)
    os.link(find_tiff(os.path.join(data_dir, READER_IMAGES["ome-tiff"])),
            os.path.join(managed, "plane.ome.tiff"))
    store = ChunkedPyramidStore(os.path.join(data_dir, "1"))
    crop = np.stack([store.get_region(0, c, 0, RegionDef(
        0, 0, OMERO_SIZE, OMERO_SIZE), 0) for c in range(4)])
    store.close()
    romio = os.path.join(repo, _romio_rel_path(ROMIO_PIXELS_ID))
    os.makedirs(os.path.dirname(romio))
    with open(romio, "wb") as f:          # XYZCT: one plane a channel
        f.write(crop.astype(">u2").tobytes())
    rgb = np.ascontiguousarray((crop[:3] >> 8).astype(np.uint8)
                               .transpose(1, 2, 0))
    for comp in (33005, 33003):
        write_j2k_tiff(np, os.path.join(managed, f"scan-{comp}.svs"), rgb,
                       comp)
    omero_data = os.path.join(root, "omero-data")
    os.makedirs(omero_data)

    db = SqliteAsyncDb(os.path.join(root, "omero.db"))
    c = db.conn
    c.executescript(OMERO_SCHEMA)
    c.executemany("INSERT INTO experimentergroup VALUES (?, ?, ?)",
                  [(0, "system", -120), (10, "lab", -120),
                   (12, "atlas-public", -52)])
    c.executemany("INSERT INTO experimenter VALUES (?, ?)",
                  [(100, "owner"), (101, "member"), (102, "outsider")])
    c.executemany("INSERT INTO groupexperimentermap VALUES (?, ?)",
                  [(100, 10), (100, 12), (101, 12)])
    c.executemany("INSERT INTO session VALUES (?, ?, ?, ?)",
                  [(i + 1, key, 100 + i, None)
                   for i, key in enumerate(OMERO_COOKIES.values())])
    files = {"11": "plane.ome.tiff", "13": "scan-33005.svs",
             "14": "scan-33003.svs", "15": "plane.ome.tiff"}
    for image, name in files.items():
        fs = 900 + int(image)
        c.execute("INSERT INTO fileset VALUES (?, ?)", (fs, prefix + "/"))
        c.execute("INSERT INTO filesetentry VALUES (?, ?, ?, ?)",
                  (fs, fs, fs, name))
        c.execute("INSERT INTO originalfile VALUES (?, ?, ?, ?)",
                  (fs, prefix + "/", name, "image/tiff"))
    c.executemany("INSERT INTO image VALUES (?, ?, ?, ?)", [
        (11, 100, 12, 911), (12, 100, 12, None), (13, 100, 12, 913),
        (14, 100, 12, 914), (15, 100, 10, 915)])
    c.executemany("INSERT INTO pixelstype VALUES (?, ?)",
                  [(1, "uint16"), (2, "uint8")])
    c.executemany("INSERT INTO pixels VALUES (?, ?, ?, ?, ?, ?, ?, ?)", [
        (1011, 11, PLANE, PLANE, 1, 4, 1, 1),
        (ROMIO_PIXELS_ID, 12, OMERO_SIZE, OMERO_SIZE, 1, 4, 1, 1),
        (1013, 13, OMERO_SIZE, OMERO_SIZE, 1, 3, 1, 2),
        (1014, 14, OMERO_SIZE, OMERO_SIZE, 1, 3, 1, 2),
        (1015, 15, PLANE, PLANE, 1, 4, 1, 1)])

    def payload(key):
        return base64.b64encode(b"hmac:" + pickle.dumps(
            {"connector": {"omero_session_key": key}})).decode()
    c.executemany("INSERT INTO django_session VALUES (?, ?, ?)", [
        *((cookie, payload(key), "2999-01-01 00:00:00")
          for cookie, key in OMERO_COOKIES.items()),
        ("ck-expired", payload("sess-owner"), "2001-01-01 00:00:00")])
    c.commit()
    return db, repo, omero_data, time.perf_counter() - t0


async def omero_phase(torch, np, client, handler, data_dir, lut_root,
                      have_aiohttp) -> dict:
    """The OMERO deployment path: the port's app with the Postgres session
    store (required) and metadata service on the sqlite ``AsyncDb``, and
    ``omero.data.dir`` on the repository (prefetch off: the cold reads
    below count on misses).  Owner, member and public-read (outsider)
    device-route JPEG GETs of each repository image, each a 200: the
    OME-TIFF fileset's and the ROMIO buffer's byte-equal to image 1's, the
    JP2K TIFFs' equal to the plain route over the reader's pixels; one LUT
    GET (K2); the outsider on the private image a 404; no cookie, an
    expired and an unknown cookie a 403.  Then one JP2K tile decoded with
    the native and the Python tier-1, equal; the canRead memo's repeat
    GET (no ACL statement beyond ``get_pixels_description``'s); each
    layout's cold ``PixelsService.readRegion`` over 8 512^2 tiles beside
    the chunked store's.  Returns the phase's kernel launches."""
    from omero_ms_image_region_tpu_torch.io import jp2k
    from omero_ms_image_region_tpu_torch.io.tiff import (
        TILE_BYTE_COUNTS, TILE_OFFSETS, TiffFile)
    from omero_ms_image_region_tpu_torch.server.app import build_services
    from omero_ms_image_region_tpu_torch.server.config import AppConfig
    from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx
    from omero_ms_image_region_tpu_torch.server.handler import (
        ImageRegionHandler)
    from omero_ms_image_region_tpu_torch.services.db_metadata import (
        DbMetadataService)
    from omero_ms_image_region_tpu_torch.utils import telemetry
    from omero_ms_image_region_tpu_torch.utils.stopwatch import REGISTRY

    db, repo, omero_data, build_s = build_omero(
        np, data_dir, os.path.dirname(data_dir))
    config = AppConfig.from_dict({
        "data-dir": omero_data,
        "omero.server": {"omero.data.dir": repo,
                         "omero.script_repo_root": lut_root},
        "session-store": {"type": "postgres", "uri": OMERO_DSN,
                          "required": True},
        "metadata-service": {"type": "postgres", "dsn": OMERO_DSN},
        "raw-cache": {"prefetch": False}})
    ohandler = ImageRegionHandler(build_services(config, DEVICE, db=db))
    check(isinstance(ohandler.s.metadata, DbMetadataService),
          "omero: the app did not build the database metadata service")
    oclient = Client(config, ohandler, have_aiohttp, db=db)
    await oclient.start()
    route = "render_image_region"
    u16 = {"tile": f"0,1,1,{TILE},{TILE}", "c": CH, "m": "c",
           "format": "jpeg"}
    lut = dict(u16, c=CH.replace("$00FF00", "$smoke.lut"))
    rgb = dict(u16, c=RGB_CH)
    try:
        image1 = {}
        for name, q in (("u16", u16), ("lut", lut)):
            status, _, body, _ = await client.request(route, q, image="1")
            check(status == 200, f"omero: image 1 {name}: HTTP {status}")
            image1[name] = body
        reset_launch_counts()
        blocks0 = jp2k.T1_NATIVE_BLOCKS
        gets, first_statements = [], {}
        for layout, image in OMERO_IMAGES.items():
            q = rgb if layout.startswith("jp2k") else u16
            bodies = []
            for cookie, session in OMERO_COOKIES.items():
                n0 = db.statements
                status, _, body, ms = await oclient.request(
                    route, q, image=image, cookies={"sessionid": cookie})
                first_statements.setdefault(image, db.statements - n0)
                check(status == 200, f"omero: {layout} as {session}: "
                                     f"HTTP {status}")
                bodies.append(body)
                gets.append([layout, session, len(body), round(ms, 2)])
            if layout.startswith("jp2k"):
                ctx = ImageRegionCtx.from_params(
                    params_of(route, q, image), "sess-owner")
                raw, settings = await ohandler.read(ctx)
                want = plain_jpeg(torch, ctx, raw, settings)
                what = "the plain route over the reader's pixels"
            else:
                want, what = image1["u16"], "image 1's"
            check(all(b == want for b in bodies),
                  f"omero: {layout}: a body differs from {what}")
        status, _, body, _ = await oclient.request(
            route, lut, image=OMERO_IMAGES["ome-tiff"],
            cookies={"sessionid": "ck-owner"})
        check(status == 200 and body == image1["lut"],
              f"omero: the LUT GET ({status}) differs from image 1's")
        check(jp2k.T1_NATIVE_BLOCKS > blocks0,
              "omero: the JP2K GETs did not run the native tier-1")
        denied = {}
        for label, image, cookies in (
                ("outsider_private", PRIVATE_IMAGE,
                 {"sessionid": "ck-outsider"}),
                ("no_cookie", OMERO_IMAGES["ome-tiff"], None),
                ("expired", OMERO_IMAGES["ome-tiff"],
                 {"sessionid": "ck-expired"}),
                ("unknown", OMERO_IMAGES["ome-tiff"],
                 {"sessionid": "ck-nobody"})):
            status, hdrs, body, _ = await oclient.request(
                route, u16, image=image, cookies=cookies)
            denied[label] = status
            check(status == (404 if label == "outsider_private" else 403)
                  and not body and "ETag" not in hdrs,
                  f"omero: {label}: HTTP {status}")
        launches = launch_counts()
        for name in ("render_ramp", "render_lut", *SPARSE_WIRE):
            check(launches[name] >= 1,
                  f"omero: {name} was not launched by the OMERO GETs")

        # The canRead memo: a repeat GET inside the TTL asks the database
        # only get_pixels_description's own statements.
        memo = ohandler.s.can_read_memo
        n0 = db.statements
        await ohandler.s.metadata.get_pixels_description(
            int(OMERO_IMAGES["ome-tiff"]), "sess-owner")
        pixels_statements = db.statements - n0
        hits0, n0, s0 = memo.hits, db.statements, db.session_statements
        status, _, body, repeat_ms = await oclient.request(
            route, u16, image=OMERO_IMAGES["ome-tiff"],
            cookies={"sessionid": "ck-owner"})
        repeat = {"statements": db.statements - n0,
                  "session_statements": db.session_statements - s0,
                  "memo_hits": memo.hits - hits0,
                  "pixels_description_statements": pixels_statements,
                  "first_get_statements": first_statements,
                  "wall_ms": repeat_ms}
        check(status == 200 and body == image1["u16"]
              and repeat["statements"] == pixels_statements
              and repeat["memo_hits"] >= 2,
              f"omero: the repeat GET asked ACL questions past the memo "
              f"{repeat}")

        # One JP2K tile: native tier-1 against the Python tier-1.
        tf = TiffFile(os.path.join(repo, "ManagedRepository",
                                   "user-1_100/2026-10/17/scan-33005.svs"))
        ifd = tf.ifds[0]
        seg = tf._pread(int(ifd.get(TILE_OFFSETS)[0]),
                        int(ifd.get(TILE_BYTE_COUNTS)[0]))
        tf.close()
        t0 = time.perf_counter()
        native = jp2k.decode_tiff_jp2k(seg, 33005, 2)
        native_ms = (time.perf_counter() - t0) * 1e3
        served_t1 = jp2k._t1
        jp2k._t1 = lambda *a: jp2k._t1_decode(*a[:7], half_at_zero=a[7])
        try:
            t0 = time.perf_counter()
            python = jp2k.decode_tiff_jp2k(seg, 33005, 2)
            python_ms = (time.perf_counter() - t0) * 1e3
        finally:
            jp2k._t1 = served_t1
        tier1 = {"tile": f"{J2K_TILE}^2 RGB 9/7", "bytes": len(seg),
                 "native_ms": native_ms, "python_t1_ms": python_ms,
                 "equal": bool(np.array_equal(native, python))}
        check(tier1["equal"], "omero: the native and Python tier-1 "
                              "decodes of one JP2K tile differ")

        # Cold reads: 8 tiles of 512^2 (rows 0-1, which no GET above
        # read) of each layout, the raw cache cleared.
        cold = {}
        for layout, cl, h, image, ch in (
                ("chunked", client, handler, "1", CH),
                ("ome-tiff", oclient, ohandler, OMERO_IMAGES["ome-tiff"],
                 CH),
                ("romio", oclient, ohandler, OMERO_IMAGES["romio"], CH),
                ("jp2k-33005", oclient, ohandler,
                 OMERO_IMAGES["jp2k-33005"], RGB_CH)):
            h.s.raw_cache.clear()
            reset_spans(telemetry, REGISTRY)
            walls = []
            for i in range(8):
                status, _, _, ms = await cl.request(
                    route, {"tile": f"0,{i % 4},{i // 4},512,512", "c": ch,
                            "m": "c", "format": "jpeg"}, image=image,
                    cookies={"sessionid": "ck-owner"})
                check(status == 200, f"omero: cold {layout}: HTTP {status}")
                walls.append(ms)
            await settled(h.s.renderer)
            spans = read_span_ms(telemetry)
            check(len(spans) == 8, f"omero: cold {layout}: {len(spans)} "
                                   f"reads")
            cold[layout] = {"read_p50_ms": statistics.median(spans),
                            "read_max_ms": max(spans),
                            "get_p50_ms": statistics.median(walls)}
        print("omero: " + json.dumps({
            "build_s": build_s, "gets": gets, "denied": denied,
            "bodies_equal": True, "memo_repeat": repeat,
            "jp2k_tier1": tier1, "cold_reads_512^2": cold,
            "native_t1_blocks": jp2k.T1_NATIVE_BLOCKS - blocks0,
            "launches": launches, "prefetch": False,
            "via": oclient.via}), flush=True)
        return launches
    finally:
        await oclient.stop()


async def prefetch_phase(torch, np, data_dir, lut_root, have_aiohttp,
                         matches_plain, e2e, tiles) -> dict:
    """The default app with prefetch on and ``sessions.enabled`` (a
    static session store): one session pans a snake of 16 resolution-0
    1024^2 tiles of image 1 (row 4 left to right, row 5 back), one GET at
    a time, each sent after the previous answer; each body equals the
    plain route (checked after the pan).  Prints the prefetcher's hit rate
    and counts and the pan-step p50 beside e2e's cold p50; fails if
    nothing was staged or nothing staged was hit.  Then e2e's 48 GETs at 8
    in flight with prefetch on (one session a row), its mean group and
    tiles/s beside e2e's: reported, not gated.  Returns the phase's kernel
    launches."""
    from omero_ms_image_region_tpu_torch.utils import telemetry

    config, handler = front_handler(data_dir, lut_root, {
        "session-store": {"type": "static"},
        "sessions": {"enabled": True}, "raw-cache": {"prefetch": True}})
    pf, cache = handler.s.prefetcher, handler.s.raw_cache
    check(pf is not None and pf.viewport is not None,
          "prefetch: the app has no prefetcher with a viewport model")
    client = Client(config, handler, have_aiohttp)
    await client.start()
    route = "render_image_region"
    try:
        path = [(x, 4) for x in range(8)] + [(x, 5) for x in range(7, -1,
                                                                   -1)]
        pan = [(route, {"tile": f"0,{x},{y},{TILE},{TILE}", "c": CH,
                        "m": "c", "format": "jpeg"}) for x, y in path]
        reset_launch_counts()
        telemetry.PREFETCH.reset()
        out = []
        for r in pan:
            status, _, body, ms = await client.request(
                *r, cookies={"sessionid": "viewer-1"})
            check(status == 200, f"prefetch: pan {r[1]}: HTTP {status}")
            out.append((body, ms))
        pf.flush()
        launches = launch_counts()
        for r, (body, _) in zip(pan, out):
            _, _, _, same = await matches_plain(*r, body)
            check(same, f"prefetch: pan {r[1]}: body differs from the "
                        f"plain route")
        steps = [ms for _, ms in out[1:]]
        doc = {"pan": {"gets": len(pan), "hit_rate": pf.hit_rate(),
                       "staged": pf.staged, "hits": pf.hits,
                       "predicted": pf.predicted,
                       "scheduled": pf.scheduled,
                       "skipped": dict(telemetry.PREFETCH.skipped),
                       "raw_cache_hits": cache.hits,
                       "step_p50_ms": statistics.median(steps),
                       "first_ms": out[0][1],
                       "e2e_cold_p50_ms": e2e["sequential_p50_ms"],
                       "bodies_match_plain": True}}
        check(pf.staged > 0, "prefetch: the pan staged no tile")
        check((pf.hit_rate() or 0) > 0,
              "prefetch: no staged tile was hit by the pan")
        for name in ("render_ramp", *SPARSE_WIRE):
            check(launches[name] >= 1,
                  f"prefetch: {name} was not launched by the pan")

        # e2e's burst with prefetch on: 48 cold GETs at 8 in flight.
        cache.clear()
        staged0, hits0 = pf.staged, pf.hits
        shed0 = handler.s.admission.shed_total
        stats = Batches(handler.s.renderer)
        sem = asyncio.Semaphore(8)

        async def limited(i, r):
            async with sem:
                return await client.request(
                    *r, cookies={"sessionid": f"burst-row-{i // 8}"})
        t0 = time.perf_counter()
        burst = await asyncio.gather(*(limited(i, r) for i, r in
                                       enumerate(tiles[16:64])))
        wall = time.perf_counter() - t0
        pf.flush()
        await settled(handler.s.renderer)
        groups = stats.report()
        doc["burst_8_in_flight"] = {
            "gets": len(burst), "statuses": sorted({s for s, *_ in burst}),
            "tiles_per_s": len(burst) / wall,
            "p50_ms": statistics.median(ms for *_, ms in burst),
            "mean_group_size": groups["mean_group_size"],
            "staged": pf.staged - staged0, "hits": pf.hits - hits0,
            "sheds": handler.s.admission.shed_total - shed0,
            "e2e_tiles_per_s": e2e["concurrent_tiles_per_s"],
            "e2e_mean_group_size": e2e["mean_group_size"]}
        doc.update(launches=launches, via=client.via)
        print("prefetch: " + json.dumps(doc), flush=True)
        return launches
    finally:
        await client.stop()


def decoded(np, have_pil, body):
    """The pixels a JPEG decodes to: PIL's RGB where PIL imports, else
    the port's native decoder's components."""
    if have_pil:
        import io

        from PIL import Image
        return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    from omero_ms_image_region_tpu_torch import native
    return native.jpeg_decode_baseline(body, None)


class WireLog:
    """The fetch observer (``ops.jpegenc.set_fetch_observer``) as a
    record: each compacted wire's used bytes and its D2H seconds."""

    def __init__(self):
        self.fetches = []

    def __call__(self, nbytes, seconds):
        self.fetches.append((nbytes, seconds))

    def take(self) -> list:
        out, self.fetches = self.fetches, []
        return out


def plain_bitpack_jpeg(torch, ctx, raw, settings) -> bytes:
    """The bitpack engine's route with every stage's plain version on the
    card: plain K1 and K3 (flips in its reads), plain K6, the host's
    framing (``jfif.finish_fixed_stream``); a stream over the encoder's
    capacity is the sparse engine's plain route, as the renderer falls
    back."""
    from omero_ms_image_region_tpu_torch import codecs
    from omero_ms_image_region_tpu_torch import jfif
    from omero_ms_image_region_tpu_torch.ops import jpegenc as J
    from omero_ms_image_region_tpu_torch.ops import render as R

    t = R.settings_to_tensors(settings, DEVICE)
    packed = R.render_tile_batch_packed_plain(
        R.raw_to_tensor(raw, DEVICE)[None], *R.batched_settings(t))
    h, w = packed.shape[-2:]
    q = codecs.quality_percent(ctx.compression_quality)
    y, cb, cr = J.packed_to_jpeg_coefficients_plain(
        packed, q, h, w, ctx.flip_horizontal, ctx.flip_vertical)
    cap = J.BitpackJpegEncoder(h, w, q).cap_words
    blocks = torch.cat([c.reshape(1, -1, 64) for c in (y, cb, cr)], dim=1)
    words, bits = J.bitpack_fixed_plain(
        blocks, J._mcu_scan_index(h // 16, w // 16),
        *J.huffman_spec_arrays(), cap)
    if int(bits[0]) > 32 * cap:
        return plain_jpeg(torch, ctx, raw, settings)
    import numpy as np

    return jfif.finish_fixed_stream(
        words[0].cpu().numpy().view(np.uint32), int(bits[0]), w, h, q)


async def bitpack_phase(torch, np, data_dir, lut_root, have_aiohttp,
                        tiles) -> dict:
    """``renderer.jpeg-engine: bitpack`` in the direct posture
    (``batcher.enabled: false``): 4 flagship tiles, one flipped h, one
    flipped hv at q 0.95, each K6's stream equal to the plain bitpack
    route (plain K1, K3 and K6, the host framing), and a 1000x1000 region
    (not MCU-aligned: the sparse engine) equal to the plain sparse route.
    Prints each GET's wall ms beside the same tile through a direct
    sparse app, and K6's launches (fails unless one a bitpack GET).
    Returns the run's kernel launches."""
    from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx
    from omero_ms_image_region_tpu_torch.server.handler import Renderer

    config, handler = front_handler(data_dir, lut_root, {
        "batcher": {"enabled": False},
        "renderer": {"jpeg-engine": "bitpack"}})
    check(isinstance(handler.s.renderer, Renderer)
          and handler.s.renderer.jpeg_engine == "bitpack",
          "bitpack: the app did not build the direct bitpack renderer")
    reqs = [r for r in tiles[:4]]
    reqs += [(tiles[4][0], dict(tiles[4][1], flip="h")),
             (tiles[5][0], dict(tiles[5][1], flip="hv", q="0.95")),
             ("render_image_region", {
                 "region": f"{TILE + 7},{TILE // 3},1000,1000", "c": CH,
                 "m": "c", "format": "jpeg"})]
    aligned = len(reqs) - 1
    bclient = Client(config, handler, have_aiohttp)
    await bclient.start()
    try:
        await bclient.request(*reqs[0])            # warm-up, not counted
        reset_launch_counts()
        out = [await bclient.request(*r) for r in reqs]
        launches = launch_counts()
        for (route, query), (status, _, body, ms) in zip(reqs, out):
            check(status == 200, f"bitpack {query}: HTTP {status}")
            ctx = ImageRegionCtx.from_params(params_of(route, query))
            raw, settings = await handler.read(ctx)
            want = (plain_bitpack_jpeg(torch, ctx, raw, settings)
                    if "tile" in query else
                    plain_jpeg(torch, ctx, raw, settings))
            dht = body[:body.index(b"\xff\xda")].count(b"\xff\xc4")
            print(f"bitpack {json.dumps(query)}: bytes {len(body)} wall_ms "
                  f"{ms:.2f} DHTs {dht} matches_plain {body == want}",
                  flush=True)
            check(body == want, f"bitpack {query}: body differs from the "
                                f"plain route")
    finally:
        await bclient.stop()
    config, handler = front_handler(data_dir, lut_root, {
        "batcher": {"enabled": False}})
    sclient = Client(config, handler, have_aiohttp)
    await sclient.start()
    try:
        await sclient.request(*reqs[0])
        sparse = [(await sclient.request(*r))[3] for r in reqs[:4]]
    finally:
        await sclient.stop()
    doc = {"gets": len(reqs), "bitpack_gets": aligned,
           "k6_launches": launches["bitpack_fixed"],
           "k3_launches": launches["jpeg_coefficients"],
           "k4a_launches": launches["sparse_pack"],
           "wall_ms": [o[3] for o in out],
           "tile_p50_ms": statistics.median(o[3] for o in out[:4]),
           "direct_sparse_tile_p50_ms": statistics.median(sparse),
           "via": bclient.via}
    print("bitpack: " + json.dumps(doc), flush=True)
    check(launches["bitpack_fixed"] == aligned,
          f"bitpack: K6 launched {launches['bitpack_fixed']} times for "
          f"{aligned} MCU-aligned GETs")
    return launches


async def growth_phase(data_dir, lut_root, have_aiohttp) -> dict:
    """Queue-pressure growth in the default app (prefetch off): 64
    flagship tiles and their h-flips (one group key) first sequentially
    (the raw cache warm, each body kept), then all 128 at once, more
    than 16 in flight: every body equal to its sequential one, and the
    batcher's counters must show groups above 8 (``max_batch`` grown to
    its limit of 16).  Then 16 of them on host planes through a batcher
    of ``max_batch`` 16: one group, its members staged through one
    pinned buffer, each body equal to its sequential one.  Returns the
    burst's kernel launches."""
    from omero_ms_image_region_tpu_torch import codecs
    from omero_ms_image_region_tpu_torch.server.batcher import (
        BatchingRenderer)
    from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx

    config, handler = front_handler(data_dir, lut_root, {})
    batcher = handler.s.renderer
    check(batcher.max_batch == 8 and batcher.max_batch_limit == 16,
          "growth: the default batcher is not 8 growing to 16")
    reqs = [("render_image_region",
             {"tile": f"0,{i % 8},{i // 8},{TILE},{TILE}", "c": CH,
              "m": "c", "format": "jpeg", **({"flip": "h"} if f else {})})
            for f in (0, 1) for i in range(64)]
    gclient = Client(config, handler, have_aiohttp)
    await gclient.start()
    try:
        first = {}
        for r in reqs:
            status, _, body, _ = await gclient.request(*r)
            check(status == 200, f"growth {r[1]}: HTTP {status}")
            first[json.dumps(r[1], sort_keys=True)] = body
        stats = Batches(batcher)
        reset_launch_counts()
        t0 = time.perf_counter()
        out = await asyncio.gather(*(gclient.request(*r) for r in reqs))
        wall = time.perf_counter() - t0
        await settled(batcher)
        launches = launch_counts()
        groups = stats.report()
        for r, (status, _, body, _) in zip(reqs, out):
            check(status == 200, f"growth burst {r[1]}: HTTP {status}")
            check(body == first[json.dumps(r[1], sort_keys=True)],
                  f"growth burst {r[1]}: body differs from its "
                  f"sequential serve")
        # One group of 16 members on host planes: the pinned group
        # buffer at B = 16 (128 MiB of uint16).
        ctxs = [ImageRegionCtx.from_params(params_of(*r))
                for r in reqs[:16]]
        reads = [await handler.read(c) for c in ctxs]
        host_batcher = BatchingRenderer(DEVICE, max_batch=16)
        try:
            bodies = await asyncio.gather(*(
                host_batcher.render_jpeg(
                    raw, st, codecs.quality_percent(c.compression_quality),
                    raw.shape[2], raw.shape[1], c.flip_horizontal,
                    c.flip_vertical) for c, (raw, st) in zip(ctxs, reads)))
        finally:
            await host_batcher.close()
        for r, body in zip(reqs, bodies):
            check(body == first[json.dumps(r[1], sort_keys=True)],
                  f"growth host group {r[1]}: body differs from its "
                  f"sequential serve")
        doc = dict(groups, gets=len(reqs), wall_ms=wall * 1e3,
                   tiles_per_s=len(reqs) / wall,
                   max_batch=batcher.max_batch,
                   max_batch_limit=batcher.max_batch_limit,
                   host_planes_group_sizes=dict(host_batcher.group_sizes),
                   launches=launches, via=gclient.via)
        print("growth: " + json.dumps(doc), flush=True)
        check(max(groups["group_sizes"]) > 8,
              "growth: no group above 8 tiles in the burst")
        check(dict(host_batcher.group_sizes) == {16: 1},
              "growth: the 16 host-plane members were not one group")
    finally:
        await gclient.stop()
        await batcher.close()
    return launches


async def huffman_phase(torch, np, client, data_dir, lut_root, have_aiohttp,
                        have_pil, e2e, rc, tiles) -> dict:
    """``renderer.jpeg-engine: huffman`` through the default app (prefetch
    off, as e2e): e2e's 16 sequential cold tiles, their 16 re-windowed
    warm repeats and its 48 cold GETs at 8 in flight.  Each JPEG decodes
    to exactly the pixels of the sparse engine's JPEG of the same URL
    (the main app's; both code the same coefficients losslessly).  Prints
    cold and warm p50, tiles/s, the wire bytes a tile and the wire's D2H
    ms, each beside the sparse engine's (e2e's and raw_cache's run; the
    wire measured on the main app's 16 sequential tiles), and K5's
    launches (fails at 0, or if K4a ran).  Then ``jpeg-engine: auto``:
    the startup probe's rate and the opening engine, and two GETs through
    it.  Returns the Huffman run's kernel launches."""
    from omero_ms_image_region_tpu_torch.ops import jpegenc as J
    from omero_ms_image_region_tpu_torch.utils import telemetry
    from omero_ms_image_region_tpu_torch.utils.stopwatch import REGISTRY

    # auto: the startup probe and the opening engine.
    config, handler = front_handler(data_dir, lut_root, {
        "renderer": {"jpeg-engine": "auto"}})
    ctl = handler.s.renderer.engine_controller
    check(ctl is not None, "huffman: jpeg-engine auto built no controller")
    auto = {"probed_rate_mb_s": ctl.rate_mb_s, "opening_engine": ctl.engine,
            "crossover_mb_s": ctl.crossover}
    auto_client = Client(config, handler, have_aiohttp)
    await auto_client.start()
    try:
        for r in tiles[:2]:
            status, _, body, _ = await auto_client.request(*r)
            check(status == 200 and body[:2] == b"\xff\xd8",
                  f"huffman: auto engine GET {r[1]}: HTTP {status}")
        auto["engine_after_gets"] = ctl.current()
        auto["switches"] = ctl.switches
    finally:
        await auto_client.stop()
        J.set_fetch_observer(None)

    wire = WireLog()
    J.set_fetch_observer(wire)
    config, handler = front_handler(data_dir, lut_root, {
        "renderer": {"jpeg-engine": "huffman"}})
    batcher = handler.s.renderer
    check(batcher.jpeg_engine == "huffman",
          "huffman: the app's batcher is not on the Huffman engine")
    hclient = Client(config, handler, have_aiohttp)
    await hclient.start()
    try:
        await hclient.request(*tiles[63])           # warm-up, not counted
        # The warm-up started the workload's table tuning (one tile's
        # symbol count on a thread); the timed run serves after it, with
        # the tuned tables, as the engine's steady state.
        tune_key = (TILE, TILE, 85)
        for _ in range(600):
            if tune_key in J._TUNED_TABLES:
                break
            await asyncio.sleep(0.05)
        tables = ("tuned" if J._TUNED_TABLES.get(tune_key) is not None
                  else "fixed")
        wire.take()
        reset_launch_counts()
        handler.s.raw_cache.clear()
        reset_spans(telemetry, REGISTRY)
        cold, bodies = [], {}
        for r in tiles[:16]:
            status, _, body, ms = await hclient.request(*r)
            check(status == 200, f"huffman: {r[1]}: HTTP {status}")
            cold.append(ms)
            bodies[json.dumps(r[1], sort_keys=True)] = body
        await settled(batcher)
        split = span_split(telemetry, REGISTRY)
        huff_wire = wire.take()
        rewindow = [(route, dict(q, c=CH2)) for route, q in tiles[:16]]
        warm = []
        for r in rewindow:
            status, _, body, ms = await hclient.request(*r)
            check(status == 200, f"huffman: {r[1]}: HTTP {status}")
            warm.append(ms)
            bodies[json.dumps(r[1], sort_keys=True)] = body
        stats = Batches(batcher)
        sem = asyncio.Semaphore(8)

        async def limited(r):
            async with sem:
                return await hclient.request(*r)
        t0 = time.perf_counter()
        conc = await asyncio.gather(*(limited(r) for r in tiles[16:64]))
        wall = time.perf_counter() - t0
        await settled(batcher)
        groups = stats.report()
        launches = launch_counts()
        for r, (status, _, body, _) in zip(tiles[16:64], conc):
            check(status == 200, f"huffman: {r[1]}: HTTP {status}")
            bodies[json.dumps(r[1], sort_keys=True)] = body
        wire.take()
    finally:
        await hclient.stop()

    # The sparse engine's JPEG of each URL (the main app), decoded.
    same = 0
    dht = set()
    for r in tiles[:64] + rewindow:
        status, _, sparse_body, _ = await client.request(*r)
        check(status == 200, f"huffman: sparse {r[1]}: HTTP {status}")
        body = bodies[json.dumps(r[1], sort_keys=True)]
        dht.add(body[:body.index(b"\xff\xda")].count(b"\xff\xc4"))
        ok = np.array_equal(decoded(np, have_pil, body),
                            decoded(np, have_pil, sparse_body))
        check(ok, f"huffman: {r[1]}: the Huffman JPEG decodes to other "
                  f"pixels than the sparse engine's")
        same += ok
    wire.take()
    for r in tiles[:16]:
        await client.request(*r)
    sparse_wire = wire.take()
    J.set_fetch_observer(None)
    check(launches["huffman_pack"] >= 1 and launches["sparse_pack"] == 0,
          f"huffman: K5 launched {launches['huffman_pack']} times and K4a "
          f"{launches['sparse_pack']} in the Huffman run")
    doc = {
        "gets": len(bodies), "decode_equal_to_sparse": same,
        "decoder": "PIL" if have_pil else "native",
        "dht_markers": sorted(dht),
        "cold_p50_ms": statistics.median(cold),
        "sparse_cold_p50_ms": e2e["sequential_p50_ms"],
        "warm_p50_ms": statistics.median(warm),
        "sparse_warm_p50_ms": rc["warm_p50_ms"],
        "tiles_per_s_8_in_flight": len(conc) / wall,
        "sparse_tiles_per_s_8_in_flight": e2e["concurrent_tiles_per_s"],
        "mean_group_size": groups["mean_group_size"],
        "wire_bytes_per_tile": statistics.median(n for n, _ in huff_wire),
        "sparse_wire_bytes_per_tile": statistics.median(
            n for n, _ in sparse_wire),
        "wire_d2h_ms": statistics.median(s * 1e3 for _, s in huff_wire),
        "sparse_wire_d2h_ms": statistics.median(
            s * 1e3 for _, s in sparse_wire),
        "k5_launches": launches["huffman_pack"], "tables": tables,
        # the 16 sequential cold GETs' per-request span p50s, beside
        # spans:'s sparse split
        "sequential_spans": {k: v["p50_ms"] for k, v in
                             split["spans"].items()
                             if v["p50_ms"] is not None},
        "launches": launches, "auto": auto, "via": client.via}
    print("huffman: " + json.dumps(doc), flush=True)
    return launches


async def byte_cache_phase(data_dir, lut_root, have_aiohttp, rc) -> dict:
    """The default app with the three byte caches on (a static session
    store): 16 cold device-route JPEG tiles, then each again: every
    repeat answered with the first GET's bytes, no group dispatched and a
    ``cache.hit`` span on its trace.  A private copy of image 1 (its
    ``acl.json`` names one session): the owner's GET, then another
    session's GET of the cached tile, a 404.  A mask GET with a colour and
    its repeat, a shape-mask hit with no K8a launch.  Prints the hit p50
    beside raw_cache's warm p50.  Returns the phase's kernel launches."""
    from omero_ms_image_region_tpu_torch.utils import telemetry
    from omero_ms_image_region_tpu_torch.utils.stopwatch import REGISTRY

    config, handler = front_handler(data_dir, lut_root, {
        "session-store": {"type": "static"},
        "image-region-cache": {"enabled": True},
        "pixels-metadata-cache": {"enabled": True},
        "shape-mask-cache": {"enabled": True}})
    caches, batcher = handler.s.caches, handler.s.renderer
    private = os.path.join(data_dir, PRIVATE_COPY)
    os.makedirs(private, exist_ok=True)
    src = os.path.join(data_dir, "1")
    for name in os.listdir(src):
        if not os.path.exists(os.path.join(private, name)):
            os.symlink(os.path.join(src, name), os.path.join(private, name))
    with open(os.path.join(private, "acl.json"), "w") as f:
        json.dump({"sessions": ["viewer-1"]}, f)
    client = Client(config, handler, have_aiohttp)
    await client.start()
    route = "render_image_region"
    try:
        reset_launch_counts()
        tiles = [(route, {"tile": f"0,{i},3,{TILE},{TILE}", "c": CH,
                          "m": "c", "format": "jpeg"}) for i in range(8)]
        tiles += [(route, dict(q, c=CH2)) for _, q in tiles]
        first = []
        for r in tiles:
            status, _, body, _ = await client.request(*r)
            check(status == 200, f"byte_cache: {r[1]}: HTTP {status}")
            first.append(body)
        await settled(batcher)
        region = caches.image_region.tiers[0]
        hits0 = region.hits
        groups0 = batcher.batches_dispatched
        reset_spans(telemetry, REGISTRY)
        hit_ms = []
        for r, body in zip(tiles, first):
            status, _, again, ms = await client.request(*r)
            check(status == 200 and again == body,
                  f"byte_cache: the repeat of {r[1]} differs")
            hit_ms.append(ms)
        repeat_hits = region.hits - hits0
        repeat_groups = batcher.batches_dispatched - groups0
        traced = sum(t.span_ms("cache.hit") is not None
                     for t in telemetry.TRACES.recent())
        check(repeat_groups == 0,
              "byte_cache: a repeat GET dispatched a group")
        check(region.hits - hits0 == len(tiles),
              "byte_cache: a repeat GET missed the image-region cache")
        check(traced == len(tiles),
              f"byte_cache: {traced} of {len(tiles)} repeats carry a "
              f"cache.hit span")
        # A private copy: the owner renders it, another session is
        # refused by the cached bytes' ACL.
        q = dict(tiles[0][1])
        status, _, owner, _ = await client.request(
            route, q, image=PRIVATE_COPY, cookies={"sessionid": "viewer-1"})
        check(status == 200 and owner == first[0],
              f"byte_cache: the owner's private GET: HTTP {status}")
        hits1 = region.hits
        status, _, _, _ = await client.request(
            route, q, image=PRIVATE_COPY, cookies={"sessionid": "viewer-2"})
        check(status == 404 and region.hits == hits1 + 1,
              f"byte_cache: another session's GET of a cached private "
              f"tile: HTTP {status}")
        # A mask and its repeat.
        masks = caches.shape_mask.tiers[0]
        mq = {"color": "FF00FF"}
        status, _, mask, _ = await client.request(
            "render_shape_mask", mq, image="1")
        check(status == 200, f"byte_cache: mask GET: HTTP {status}")
        k8a0, mhits0 = launch_counts()["mask_rasterize"], masks.hits
        status, _, again, _ = await client.request(
            "render_shape_mask", mq, image="1")
        check(status == 200 and again == mask and masks.hits == mhits0 + 1
              and launch_counts()["mask_rasterize"] == k8a0,
              "byte_cache: the repeat mask GET was not a shape-mask hit")
        launches = launch_counts()
        doc = {"repeats": len(tiles), "hits": repeat_hits,
               "groups_on_repeat": repeat_groups,
               "cache_hit_spans": traced,
               "hit_p50_ms": statistics.median(hit_ms),
               "raw_cache_warm_p50_ms": rc["warm_p50_ms"],
               "private_other_session": 404, "mask_repeat_hit": True,
               "pixels_metadata_hits": caches.pixels_metadata.tiers[0].hits,
               "tier": type(region).__name__, "launches": launches,
               "via": client.via}
        print("byte_cache: " + json.dumps(doc), flush=True)
        return launches
    finally:
        await client.stop()


# A private copy of image 1 (its acl.json names one session), for the
# byte_cache phase.
PRIVATE_COPY = "21"


# The keys of the JAX app's JSON access line (omero_ms_image_region_tpu
# server/app.py, _finish_request): ``prov`` on a success only.
ACCESS_KEYS = ("ts", "trace", "route", "status", "bytes", "ms", "queue_ms",
               "render_ms", "encode_ms", "cache", "cost", "prov")


async def readyz_phase(have_aiohttp) -> dict:
    """A fresh default app with ``renderer.prewarm: ["4x1024"]`` before
    anything is built: ``/readyz`` 503 ``pending`` while its background
    prewarm builds the kernels (nvcc, g++) and launches K1, K3, K4a and
    K4b at B = 1..8, then 200 ``complete``; the seconds from the app's
    build to ready, and the launches the prewarm made."""
    from omero_ms_image_region_tpu_torch.utils import telemetry

    reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as empty:
        config, handler = front_handler(empty, None, {
            "renderer": {"prewarm": ["4x1024"]}})
        client = Client(config, handler, have_aiohttp)
        await client.start()
        try:
            answers = []
            while True:
                status, body = await client.readyz()
                if not answers or answers[-1] != (status, body):
                    answers.append((status, body))
                if status != 503 or body["checks"].get("prewarm") \
                        != "pending":
                    break
                check(time.perf_counter() - t0 < 600,
                      "readyz: the prewarm did not end in 600 s")
                await asyncio.sleep(0.1)
            secs = time.perf_counter() - t0
        finally:
            await client.stop()
    launches = launch_counts()
    doc = {"answers": [{"status": st, "checks": b["checks"]}
                       for st, b in answers],
           "ready_s": secs, "failed": telemetry.READINESS.prewarm_failed,
           "prewarm_launches": {k: v for k, v in launches.items() if v},
           "via": client.via}
    print("readyz: " + json.dumps(doc), flush=True)
    check(answers[0] == (503, {"status": "degraded", "checks": {
        "prewarm": "pending", "queue": "ok", "sentinel": "ok"}}),
          f"readyz: the first answer was {answers[0]}, not 503 pending")
    check(answers[-1] == (200, {"status": "ready", "checks": {
        "prewarm": "complete", "queue": "ok", "sentinel": "ok"}}),
          f"readyz: the prewarm ended in {answers[-1]}")
    for name in ("render_ramp",) + SPARSE_WIRE:
        check(launches[name] >= 8, f"readyz: the prewarm launched {name} "
                                   f"{launches[name]} times, not at every "
                                   f"batch size 1-8")
    return doc


async def access_log_phase(data_dir, lut_root, have_aiohttp) -> dict:
    """The JSON access log of the default app with the image-region cache
    on: a cold device-route JPEG GET, its repeat (a byte-cache hit), its
    revalidation (304) and an unknown image (404), one line each on
    ``omero_ms_image_region_tpu_torch.access`` with the JAX app's keys
    (``prov`` on the successes), their ``cache`` and provenance tier, and
    the miss's cost ledger."""
    import logging

    lines = []

    class Sink(logging.Handler):
        def emit(self, record):
            lines.append(json.loads(record.getMessage()))

    logger = logging.getLogger("omero_ms_image_region_tpu_torch.access")
    sink, level = Sink(logging.INFO), logger.level
    logger.addHandler(sink)
    logger.setLevel(logging.INFO)
    config, handler = front_handler(data_dir, lut_root, {
        "image-region-cache": {"enabled": True}})
    client = Client(config, handler, have_aiohttp)
    await client.start()
    route = "render_image_region"
    q = {"tile": f"0,2,6,{TILE},{TILE}", "c": CH, "m": "c",
         "format": "jpeg"}
    try:
        statuses = []
        status, hdrs, _, _ = await client.request(route, q)
        statuses.append(status)
        for query, headers, image in (
                (q, None, "1"), (q, {"If-None-Match": hdrs["ETag"]}, "1"),
                (q, None, "404")):
            status, _, _, _ = await client.request(route, query,
                                                   headers=headers,
                                                   image=image)
            statuses.append(status)
    finally:
        await client.stop()
        logger.removeHandler(sink)
        logger.setLevel(level)
    kinds = ("miss", "byte_cache_hit", "revalidation", "unknown_image")
    doc = {kind: {"status": line["status"], "bytes": line["bytes"],
                  "cache": line["cache"],
                  "tier": line.get("prov", {}).get("tier"),
                  "keys_match_jax": set(line) == set(
                      k for k in ACCESS_KEYS
                      if k != "prov" or line["status"] < 400)}
           for kind, line in zip(kinds, lines)}
    doc["lines"] = len(lines)
    doc["miss_cost"] = lines[0]["cost"] if lines else None
    doc["via"] = client.via
    print("access_log: " + json.dumps(doc), flush=True)
    check(statuses == [200, 200, 304, 404] and len(lines) == 4,
          f"access_log: statuses {statuses}, {len(lines)} lines")
    check(all(doc[k]["keys_match_jax"] for k in kinds),
          "access_log: a line's keys differ from the JAX app's")
    check([doc[k]["tier"] for k in kinds]
          == ["render_cold", "byte_cache", "304", None]
          and [doc[k]["cache"] for k in kinds]
          == ["render", "byte-cache", "render", "render"],
          "access_log: the provenance tiers or cache classes are wrong")
    check({"device_ms", "stage_ms", "staged_bytes", "read_ms",
           "queue_ms"} <= set(doc["miss_cost"]),
          "access_log: the miss's ledger lacks a field its path writes")
    return doc


# A third window for the warm_restart phase's re-windowed GETs.
CH3 = "1|900:20000$FF0000,2|700:42000$00FF00,3|400:30000$0000FF," \
      "4|1200:36000$FFFF00"


def http_get(port: int, path: str, timeout: float = 300.0):
    """(status, headers, body, ms) of one GET to 127.0.0.1:``port``."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            status, headers, body = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        status, headers, body = e.code, dict(e.headers), e.read()
    return status, headers, body, (time.perf_counter() - t0) * 1000.0


def scrape(port: int) -> str:
    status, _, body, _ = http_get(port, "/metrics")
    check(status == 200, f"warm_restart: /metrics answered {status}")
    return body.decode()


def compiler_wrappers(root: str) -> tuple:
    """A directory of ``nvcc`` and ``g++`` wrappers that log each call
    (argv) to a file and run the real compiler; (bin dir, log path)."""
    import shutil

    from omero_ms_image_region_tpu_torch.kernels import build

    bin_dir = os.path.join(root, "bin")
    os.makedirs(bin_dir)
    log_path = os.path.join(root, "compilers.log")
    for name, real in (("nvcc", build.nvcc()),
                       ("g++", shutil.which("g++"))):
        check(real is not None, f"warm_restart: no {name}")
        path = os.path.join(bin_dir, name)
        with open(path, "w") as f:
            f.write(f'#!/bin/sh\necho "{name} $*" >> "{log_path}"\n'
                    f'exec "{real}" "$@"\n')
        os.chmod(path, 0o755)
    return bin_dir, log_path


def builds_logged(log_path: str) -> list:
    """The logged compiler calls that were not ``--version``."""
    if not os.path.exists(log_path):
        return []
    with open(log_path) as f:
        return [ln.strip() for ln in f if "--version" not in ln]


# The frontend of the sidecar phase, in a process of its own so that it can
# show it never initialised CUDA: each app of ``spec["apps"]`` (a config
# dict, role frontend) serves ``spec["urls"]`` through its request front
# (``server.app.build_front``), bodies written to ``spec["out"][name]``.
FRONTEND_DRIVER = r"""
import asyncio, json, os, sys, time
from urllib.parse import parse_qsl, urlsplit
spec = json.loads(sys.argv[1])
import torch
from omero_ms_image_region_tpu_torch.server.app import build_front
from omero_ms_image_region_tpu_torch.server.config import AppConfig
from omero_ms_image_region_tpu_torch.utils import telemetry

def params(url):
    parts = urlsplit(url)
    _, _, route, image, z, t = parts.path.split("/")[:6]
    return route, dict(parse_qsl(parts.query), imageId=image, theZ=z, theT=t)

async def run(raw, out_dir):
    front = build_front(AppConfig.from_dict(raw), "cuda")
    gets = []
    for i, url in enumerate(spec["urls"]):
        route, p = params(url)
        t0 = time.perf_counter()
        a = await front.observed(route, "GET", p, {}, {})
        ms = (time.perf_counter() - t0) * 1e3
        if out_dir:
            with open(os.path.join(out_dir, f"{i}.bin"), "wb") as f:
                f.write(a.body)
        gets.append({"status": a.status, "ms": ms, "bytes": len(a.body),
                     "retry_after": a.headers.get("Retry-After"),
                     "provenance": a.headers.get("X-Image-Region-Provenance"),
                     "degraded": (a.prov_ctx is not None and getattr(
                         a.prov_ctx, "_provenance", {}).get("tier")
                         == "degraded")})
    ok, checks = await front.readiness()
    try:
        status, body = await asyncio.wait_for(
            front.client.call("metrics", {}), 5.0)
        sidecar = [l for l in bytes(body).decode().splitlines()
                   if l.startswith("imageregion_wire_")] if status == 200 \
            else []
    except Exception:
        sidecar = None
    await front.client.close()
    front.close()
    return {"gets": gets, "readyz": [ok, checks], "sidecar_wire": sidecar}

async def main():
    out = {name: await run(raw, spec["out"].get(name))
           for name, raw in spec["apps"].items()}
    out["wire"] = telemetry.WIRE.snapshot()
    out["degraded_renders"] = telemetry.RESILIENCE.degraded_renders
    out["cuda_initialized"] = torch.cuda.is_initialized()
    print(json.dumps(out))

asyncio.run(main())
"""


def run_frontend(spec: dict, timeout_s: float = 300.0) -> dict:
    """:data:`FRONTEND_DRIVER` in a child process; its JSON result."""
    proc = subprocess.run([sys.executable, "-c", FRONTEND_DRIVER,
                           json.dumps(spec)], capture_output=True,
                          text=True, timeout=timeout_s,
                          env=dict(os.environ, PYTHONPATH=os.getcwd()))
    check(proc.returncode == 0, f"sidecar: the frontend process failed "
                                f"({proc.returncode}):\n"
                                f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def pgrep(pattern: str) -> list:
    out = subprocess.run(["pgrep", "-f", "--", pattern], capture_output=True,
                         text=True).stdout.split()
    return [int(p) for p in out]


def sidecar_phase(torch, np, data_dir, lut_root, have_aiohttp,
                  smi: str) -> dict:
    """The frontend/sidecar split on the card.

    A ``--role sidecar`` child on a unix socket owns the card; a frontend
    (``sidecar.role: frontend``) in a process of its own serves 8 cold
    flagship JPEG tiles through it, each byte-equal to a fresh combined
    app's GET of the same URL in this process; the frontend negotiated the
    shared-memory ring, the bodies rode it (the sidecar's
    ``imageregion_wire_ring_bytes_total``), and the frontend never
    initialised CUDA.  p50 through the sidecar against combined.  With the
    sidecar killed: 503 with Retry-After with degraded mode off, 200s
    marked ``degraded`` with it on.  Then ``--role split``: a GET, the
    sidecar child killed, the supervisor's new child serves the same
    bytes."""
    import signal

    from omero_ms_image_region_tpu_torch.server import sidecar as SC

    tiles = [("render_image_region",
              {"tile": f"0,{i},6,{TILE},{TILE}", "c": CH3, "m": "c",
               "format": "jpeg"}) for i in range(8)]
    urls = ["/webgateway/render_image_region/1/0/0?" + "&".join(
        f"{k}={v}" for k, v in q.items()) for _, q in tiles]

    async def combined():
        config, handler = front_handler(data_dir, lut_root, {})
        client = Client(config, handler, have_aiohttp)
        await client.start()
        try:
            return [await client.request(*r) for r in tiles]
        finally:
            await client.stop()

    combined_gets = asyncio.run(combined())
    check(all(g[0] == 200 for g in combined_gets),
          "sidecar: the combined app failed a GET")
    tmp = tempfile.mkdtemp(prefix="sidecar-")
    sock = os.path.join(tmp, "render.sock")
    conf = os.path.join(tmp, "sidecar.yaml")
    with open(conf, "w") as f:
        json.dump({"raw-cache": {"prefetch": False},
                   "omero.server": {"omero.script_repo_root": lut_root}}, f)
    log = open(os.path.join(tmp, "sidecar.log"), "w")
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "omero_ms_image_region_tpu_torch.server",
         "--role", "sidecar", "--sidecar-socket", sock, "--config", conf,
         "--data-dir", data_dir, "--device", DEVICE],
        stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=os.getcwd()))
    doc: dict = {"card": smi}
    try:
        SC.wait_sidecar_socket(child, sock)
        doc["sidecar_start_s"] = time.perf_counter() - t0
        front_raw = {"data-dir": data_dir, "raw-cache": {"prefetch": False},
                     "omero.server": {"omero.script_repo_root": lut_root},
                     "telemetry": {"provenance-header": True},
                     "sidecar": {"role": "frontend", "socket": sock}}
        out_dir = os.path.join(tmp, "bodies")
        os.makedirs(out_dir)
        live = run_frontend({"apps": {"frontend": front_raw}, "urls": urls,
                             "out": {"frontend": out_dir}})
        gets = live["frontend"]["gets"]
        same = []
        for i, g in enumerate(combined_gets):
            with open(os.path.join(out_dir, f"{i}.bin"), "rb") as f:
                same.append(f.read() == g[2])
        wire = dict(line.rsplit(" ", 1) for line in
                    live["frontend"]["sidecar_wire"] or [])
        doc.update({
            "gets": len(gets), "statuses": [g["status"] for g in gets],
            "bytes_equal_combined": all(same),
            "p50_ms_through_sidecar": statistics.median(
                g["ms"] for g in gets),
            "p50_ms_combined": statistics.median(
                g[3] for g in combined_gets),
            "ring": live["wire"]["ring_negotiated"] > 0,
            "frontend_wire": live["wire"],
            "sidecar_ring_bytes": float(wire.get(
                'imageregion_wire_ring_bytes_total{process="sidecar"}',
                "nan")),
            "sidecar_ring_hits": float(wire.get(
                'imageregion_wire_ring_hits_total{process="sidecar"}',
                "nan")),
            "frontend_readyz": live["frontend"]["readyz"],
            "frontend_cuda_initialized": live["cuda_initialized"]})
        check(all(g["status"] == 200 for g in gets) and all(same),
              "sidecar: a GET through the sidecar differs from the "
              "combined app's bytes")
        check(doc["ring"] and doc["sidecar_ring_bytes"] > 0,
              "sidecar: no body rode the shared-memory ring")
        check(live["cuda_initialized"] is False,
              "sidecar: the frontend initialised CUDA")
        check(live["frontend"]["readyz"][0] is True,
              "sidecar: the frontend's /readyz was not ready")

        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
        degraded_raw = dict(front_raw, **{"fault-tolerance": {
            "degraded-mode": True}})
        dead = run_frontend({"apps": {"off": front_raw,
                                      "on": degraded_raw},
                             "urls": urls[:2], "out": {}})
        off, on = dead["off"]["gets"], dead["on"]["gets"]
        doc["sidecar_killed"] = {
            "degraded_off": [(g["status"], g["retry_after"]) for g in off],
            "degraded_on": [(g["status"], g["provenance"]) for g in on],
            "degraded_renders": dead["degraded_renders"],
            "readyz_off": dead["off"]["readyz"],
            "readyz_on": dead["on"]["readyz"]}
        print("sidecar_killed: " + json.dumps(doc["sidecar_killed"]),
              flush=True)
        check(all(g["status"] == 503 and g["retry_after"] for g in off),
              "sidecar: a dead sidecar did not answer 503 with "
              "Retry-After with degraded mode off")
        # The tier is the provenance record's (its access line and
        # counters); a streamed frontend answer sends no provenance header,
        # as in JAX (the sidecar's marks arrive after the headers).
        check(all(g["status"] == 200 and g["degraded"] for g in on)
              and dead["degraded_renders"] >= len(on),
              "sidecar: degraded mode did not serve marked degraded "
              "bodies")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60)
        log.close()

    # --role split: the supervisor brings a killed sidecar child back.
    port = free_port()
    split_sock = os.path.join(tmp, "split.sock")
    split_log = open(os.path.join(tmp, "split.log"), "w")
    split = subprocess.Popen(
        [sys.executable, "-m", "omero_ms_image_region_tpu_torch.server",
         "--role", "split", "--sidecar-socket", split_sock, "--config",
         conf, "--data-dir", data_dir, "--port", str(port), "--device",
         DEVICE], stdout=split_log, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=os.getcwd()))
    try:
        def get_tile(deadline_s: float):
            t_end = time.perf_counter() + deadline_s
            while time.perf_counter() < t_end:
                check(split.poll() is None, f"sidecar: the split process "
                                            f"exited with {split.returncode}")
                try:
                    status, _, body, _ = http_get(port, urls[0], 30.0)
                    if status == 200:
                        return body
                except OSError:
                    pass
                time.sleep(0.2)
            raise RuntimeError("sidecar: the split role served no 200")

        t0 = time.perf_counter()
        first = get_tile(300)
        split_first_s = time.perf_counter() - t0
        children = [p for p in pgrep(f"--sidecar-socket {split_sock}")
                    if p != split.pid]
        check(len(children) == 1, f"sidecar: the split role has "
                                  f"{len(children)} sidecar children")
        os.kill(children[0], signal.SIGKILL)
        t0 = time.perf_counter()
        again = get_tile(300)
        restart_s = time.perf_counter() - t0
        new = [p for p in pgrep(f"--sidecar-socket {split_sock}")
               if p != split.pid]
        doc["split"] = {"first_200_s": split_first_s,
                        "restart_to_200_s": restart_s,
                        "killed": children[0], "new_child": new,
                        "same_bytes": again == first}
        check(len(new) == 1 and new[0] != children[0] and again == first,
              "sidecar: the supervisor did not bring the sidecar back")
    finally:
        split.send_signal(signal.SIGTERM)
        try:
            split.wait(timeout=60)
        except subprocess.TimeoutExpired:
            split.kill()
            split.wait()
        split_log.close()
        for pid in pgrep(f"--sidecar-socket {split_sock}"):
            os.kill(pid, signal.SIGKILL)
    doc["split"]["children_left"] = len(pgrep(
        f"--sidecar-socket {split_sock}"))
    print("sidecar: " + json.dumps(doc), flush=True)
    check(doc["split"]["children_left"] == 0,
          "sidecar: the split role left its sidecar child running")
    return doc


# ------------------------------------------------------------- the fleet

def ring_owner(members, key: str, points: int = 64) -> str:
    """The consistent-hash owner of ``key``, computed here without the
    port: BLAKE2b-64 of "<member>#<v>" for ``points`` points a member, the
    first point clockwise of BLAKE2b-64 of the key."""
    import bisect
    import hashlib

    def point(s: str) -> int:
        return int.from_bytes(hashlib.blake2b(
            s.encode(), digest_size=8).digest(), "big")
    ring = sorted((point(f"{m}#{v}"), m) for m in members
                  for v in range(points))
    i = bisect.bisect([p for p, _ in ring], point(key)) % len(ring)
    return ring[i][1]


def tile_route(x: int, y: int, image: int = 1) -> str:
    """A level-0 tile's plane identity as the router hashes it."""
    import hashlib
    parts = (image, 0, 0, 0, (x, y, TILE, TILE), None)
    return hashlib.blake2b(repr(parts).encode(),
                           digest_size=16).hexdigest()


async def close_fleet(front) -> None:
    """Close a front's fleet built outside aiohttp (the app's cleanup
    does it otherwise)."""
    from omero_ms_image_region_tpu_torch.server.app import (
        _member_renderers)
    front.close()
    if front.router is not None:
        await front.router.close()
    for renderer in _member_renderers(front):
        await renderer.close()
    if front.services is not None:
        await front.services.renderer.close()


def member_of(headers) -> str:
    """The serving member in the provenance header (``-``: none)."""
    for part in (headers.get("X-Image-Region-Provenance") or "").split("; "):
        if part.startswith("member="):
            return part[len("member="):]
    return "-"


async def fleet_phase(torch, data_dir, lut_root, have_aiohttp, e2e,
                      matches_plain, smi: str) -> dict:
    """The combined role's fleet on the card (see the module docstring,
    ``fleet:``).  Returns each kernel's launches in the main-path run (the
    32 cold tiles), and the bytes of the first 8 for the sidecar fleet."""
    from omero_ms_image_region_tpu_torch.server.config import AppConfig
    from omero_ms_image_region_tpu_torch.utils import telemetry

    t_phase = time.perf_counter()
    config = AppConfig.from_dict({
        "data-dir": data_dir,
        "omero.server": {"omero.script_repo_root": lut_root},
        "raw-cache": {"prefetch": False},
        "telemetry": {"provenance-header": True},
        "fleet": {"enabled": True, "members": 2},
        # Promotion at 12 decayed requests of one plane (JAX's default
        # threshold), demotion at 6.
        "hotkey": {"enabled": True}})
    client = Client(config, None, have_aiohttp)
    await client.start()
    router = client.app_front.router
    members = list(router.order)
    caches = {n: router.members[n].services.raw_cache for n in members}
    batchers = {n: router.members[n].services.renderer for n in members}
    check(members == ["m0", "m1"] and caches["m0"] is not caches["m1"]
          and batchers["m0"] is not batchers["m1"],
          "fleet: the app did not build two members, each with its own "
          "batcher and raw cache")
    devices = {n: str(batchers[n].device) for n in members}

    def tile(x, y, c=CH, fmt="jpeg"):
        return ("render_image_region",
                {"tile": f"0,{x},{y},{TILE},{TILE}", "c": c, "m": "c",
                 "format": fmt})

    async def in_flight(reqs, n=8):
        sem = asyncio.Semaphore(n)

        async def one(r):
            async with sem:
                return await client.request(*r)
        t0 = time.perf_counter()
        out = await asyncio.gather(*(one(r) for r in reqs))
        return out, time.perf_counter() - t0

    def keys(name):
        return {str(k) for k in caches[name]._entries}

    doc: dict = {"card": smi, "devices": devices, "via": client.via}
    try:
        # Stealing waits for the skewed burst: a steal renders on the
        # thief without staging, and this part checks every plane on its
        # owner.
        router.steal_min_backlog = 0
        # Warm-up outside the counted run (each member's first group).
        grid = [(x, y) for y in range(4) for x in range(8)]
        await in_flight([tile(7, 7), tile(6, 7)])
        for c in caches.values():
            c.clear()
        routed0 = dict(telemetry.FLEET.routed)
        groups0 = {n: b.batches_dispatched for n, b in batchers.items()}
        reset_launch_counts()
        cold, wall = await in_flight([tile(x, y) for x, y in grid])
        launches = launch_counts()
        k1 = {n: batchers[n].batches_dispatched - groups0[n]
              for n in members}
        statuses = [s for s, _, _, _ in cold]
        check(all(s == 200 for s in statuses), f"fleet: a cold GET "
                                               f"failed: {statuses}")
        want = {xy: ring_owner(members, tile_route(*xy)) for xy in grid}
        served = {xy: member_of(h) for xy, (_, h, _, _) in zip(grid, cold)}
        for (x, y), (_, _, body, _) in zip(grid, cold):
            _, _, _, same = await matches_plain(*tile(x, y), body)
            check(same, f"fleet: tile {x},{y} differs from the plain "
                        f"route")
        route_keys = {xy: tile_route(*xy) for xy in grid}
        check(all(router.ring.member(route_keys[xy]) == want[xy]
                  for xy in grid),
              "fleet: the router's ring disagrees with this script's")
        check(served == want, f"fleet: a tile was not served by its ring "
                              f"owner: {served} against {want}")
        staged = {n: {tuple(e["key"][4])[:2] for e in
                      caches[n].snapshot_entries()} for n in members}
        for (x, y), owner in want.items():
            check((x * TILE, y * TILE) in staged[owner],
                  f"fleet: tile {x},{y} is not staged on its owner "
                  f"{owner}")
        both = keys("m0") & keys("m1")
        check(not both, f"fleet: {len(both)} planes resident on both "
                        f"members")
        check(sum(k1.values()) == launches["render_ramp"]
              + launches["render_lut"] and all(k1.values()),
              f"fleet: K1 launches per member {k1} do not add up to "
              f"{launches['render_ramp']}")
        doc.update({
            "gets": len(cold), "in_flight": 8,
            "p50_ms": statistics.median(ms for *_, ms in cold),
            "tiles_per_s": len(cold) / wall,
            "e2e_concurrent_p50_ms": e2e["concurrent_p50_ms"],
            "e2e_tiles_per_s": e2e["concurrent_tiles_per_s"],
            "owners": {n: sum(1 for o in want.values() if o == n)
                       for n in members},
            "routed": {n: telemetry.FLEET.routed.get(n, 0)
                       - routed0.get(n, 0) for n in members},
            "planes": {n: len(caches[n]) for n in members},
            "planes_on_both": len(both), "bodies_match_plain": True,
            "k1_launches_per_member": k1, "launches": launches})
        cold_bodies = {xy: body for xy, (_, _, body, _) in zip(grid, cold)}

        # Re-windowed: every GET a raw-cache hit on its owner.
        hm0 = {n: (caches[n].hits, caches[n].misses) for n in members}
        warm, _ = await in_flight([tile(x, y, CH2) for x, y in grid])
        check(all(s == 200 for s, *_ in warm), "fleet: a warm GET failed")
        hits = {n: caches[n].hits - hm0[n][0] for n in members}
        misses = {n: caches[n].misses - hm0[n][1] for n in members}
        check(hits == doc["owners"] and not any(misses.values())
              and [member_of(h) for _, h, _, _ in warm]
              == [want[xy] for xy in grid],
              f"fleet: re-windowed GETs were not all hits on their owners "
              f"(hits {hits}, misses {misses})")
        doc["rewindow"] = {"hits": hits, "misses": misses,
                           "p50_ms": statistics.median(
                               ms for *_, ms in warm)}

        # A skewed burst: 16 cold tiles of one member, all at once, with
        # the config's steal threshold.
        router.steal_min_backlog = config.fleet.steal_min_backlog
        victim = "m0"
        skew = [(x, y) for y in range(4, 7) for x in range(8)
                if ring_owner(members, tile_route(x, y)) == victim][:16]
        thief = {n: keys(n) for n in members}
        stolen0 = telemetry.FLEET.totals()["stolen"]
        burst, _ = await in_flight([tile(x, y) for x, y in skew],
                                   n=len(skew))
        stolen = telemetry.FLEET.totals()["stolen"] - stolen0
        thieves = [member_of(h) for _, h, _, _ in burst]
        check(all(s == 200 for s, *_ in burst), "fleet: a skewed GET "
                                                "failed")
        check(stolen >= 1 and "m1" in thieves,
              f"fleet: the skewed burst made no steal ({thieves})")
        check(keys("m1") == thief["m1"],
              "fleet: a stolen render was staged in the thief's raw "
              "cache")
        for (x, y), (_, _, body, _) in zip(skew, burst):
            _, _, _, same = await matches_plain(*tile(x, y), body)
            check(same, f"fleet: stolen tile {x},{y} differs from the "
                        f"plain route")
        doc["steal"] = {"gets": len(skew), "stolen": stolen,
                        "served_by": {n: thieves.count(n) for n in members},
                        "thief_planes_unchanged": True}

        # A member marked down mid-burst: no failed GET.
        down = [tile(x, 7, CH2) for x in range(6)] + [
            tile(x, y, CH3) for x, y in grid[:10]]
        failed0 = telemetry.FLEET.totals()["failed_over"]

        async def kill_m1():
            await asyncio.sleep(0.005)
            router.members["m1"].mark_down()
        (out, _), _ = await asyncio.gather(in_flight(down), kill_m1())
        statuses = [s for s, *_ in out]
        router.members["m1"].revive()
        check(all(s == 200 for s in statuses),
              f"fleet: GETs failed across a member's death: {statuses}")
        doc["member_down"] = {
            "gets": len(down), "failed": len(down) - statuses.count(200),
            "failed_over": telemetry.FLEET.totals()["failed_over"]
            - failed0,
            "served_by": {n: [member_of(h) for _, h, _, _ in out].count(n)
                          for n in members}}

        # Drain m1: its shard prestaged on m0; then undrain.
        m1_keys = keys("m1")
        status, _, body, drain_ms = await client.request_path(
            "POST", "/admin/drain?member=m1")
        drained = json.loads(body)
        check(status == 200 and drained["prestaged"] >= 1
              and m1_keys <= keys("m0"),
              f"fleet: the drain did not prestage m1's planes on m0 "
              f"({status} {drained.get('prestaged')})")
        during, _ = await in_flight([tile(x, y, CH3) for x, y in grid[10:]])
        check(all(s == 200 and member_of(h) == "m0"
                  for s, h, _, _ in during),
              "fleet: a GET during the drain failed or reached m1")
        status, _, body, _ = await client.request_path(
            "POST", "/admin/undrain?member=m1")
        check(status == 200, f"fleet: undrain answered {status}")
        doc["drain"] = {"planes": drained["planes"],
                        "prestaged": drained["prestaged"],
                        "settled": drained["settled"], "ms": drain_ms,
                        "gets_while_draining": len(during)}

        # Hot plane: 64 GETs of one plane, 64 windows, 8 in flight.
        hot_xy = (0, 7)
        hot = [tile(*hot_xy, f"1|{100 + i}:40000$FF0000,"
                             f"2|100:40000$00FF00,3|100:40000$0000FF,"
                             f"4|100:40000$FFFFFF") for i in range(64)]
        h0 = telemetry.HOTKEY.totals()
        got, _ = await in_flight(hot)
        h1 = telemetry.HOTKEY.totals()
        route = tile_route(*hot_xy)
        report = router.shard_report()
        doc["hotkey"] = {
            "gets": len(hot),
            "promoted": h1["promoted"] - h0["promoted"],
            "balanced": h1["balanced"] - h0["balanced"],
            "staged": h1["staged"] - h0["staged"],
            "duplicate_staged": h1["duplicate_staged"],
            "replica_set": router.replica_set(route),
            "served_by": {n: [member_of(h) for _, h, _, _ in got].count(n)
                          for n in members},
            "shard_report": report}
        check(all(s == 200 for s, *_ in got), "fleet: a hot GET failed")
        check(doc["hotkey"]["promoted"] >= 1
              and doc["hotkey"]["balanced"] >= 1
              and h1["duplicate_staged"] == 0,
              f"fleet: the hot burst did not promote and balance: "
              f"{doc['hotkey']}")
        status, _, body, _ = await client.request_path("GET", "/metrics")
        check('imageregion_fleet_member_planes{member="m1"}'
              in body.decode() and "imageregion_hotkey_promotions_total"
              in body.decode(), "fleet: /metrics lacks the fleet series")
        doc["launches_main_path"] = launches
        doc["phase_s"] = time.perf_counter() - t_phase
        print("fleet: " + json.dumps(doc), flush=True)
        return {"launches": launches, "bodies": cold_bodies,
                "p50_ms": doc["p50_ms"], "e2e": e2e}
    finally:
        await client.stop()


def fleet_sidecars_phase(data_dir, lut_root, smi: str,
                         combined: dict) -> dict:
    """A frontend fleet over two sidecar processes on the card (the module
    docstring's ``fleet_sidecars:``)."""
    import signal

    from omero_ms_image_region_tpu_torch.server import sidecar as SC
    from omero_ms_image_region_tpu_torch.server.app import build_front
    from omero_ms_image_region_tpu_torch.server.config import AppConfig
    from omero_ms_image_region_tpu_torch.utils import telemetry

    tmp = tempfile.mkdtemp(prefix="fleet-")
    socks = [os.path.join(tmp, f"m{i}.sock") for i in range(2)]
    conf = os.path.join(tmp, "sidecar.yaml")
    with open(conf, "w") as f:
        json.dump({"raw-cache": {"prefetch": False},
                   "image-region-cache": {"enabled": True},
                   "omero.server": {"omero.script_repo_root": lut_root}}, f)
    logs = [open(os.path.join(tmp, f"m{i}.log"), "w") for i in range(2)]
    t0 = time.perf_counter()
    children = [subprocess.Popen(
        [sys.executable, "-m", "omero_ms_image_region_tpu_torch.server",
         "--role", "sidecar", "--sidecar-socket", sock, "--config", conf,
         "--data-dir", data_dir, "--device", DEVICE],
        stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=os.getcwd()))
        for sock, log in zip(socks, logs)]
    doc: dict = {"card": smi}
    members = ["m0", "m1"]

    def tile(x, y, c=CH):
        return {"tile": f"0,{x},{y},{TILE},{TILE}", "c": c, "m": "c",
                "format": "jpeg", "imageId": "1", "theZ": "0", "theT": "0"}

    async def run():
        config = AppConfig.from_dict({
            "data-dir": data_dir,
            "telemetry": {"provenance-header": True},
            "sidecar": {"role": "frontend"},
            "fleet": {"enabled": True, "sockets": socks,
                      "lane-width": 1}})
        front = build_front(config, DEVICE)
        router = front.router

        async def get(q):
            t = time.perf_counter()
            a = await front.observed("render_image_region", "GET",
                                     dict(q), {}, {})
            return a, (time.perf_counter() - t) * 1e3

        try:
            # 8 cold tiles, byte-equal to the combined fleet's.
            grid = list(combined["bodies"])[:8]
            cold = [await get(tile(*xy)) for xy in grid]
            check(all(a.status == 200 and a.body == combined["bodies"][xy]
                      for xy, (a, _) in zip(grid, cold)),
                  "fleet_sidecars: a GET differs from the combined "
                  "fleet's bytes")
            doc.update({"gets": len(cold), "bytes_equal_combined": True,
                        "p50_ms": statistics.median(ms for _, ms in cold),
                        "p50_ms_combined_fleet": combined["p50_ms"]})

            # A skewed burst: one steal, the thief's shard unchanged.
            skew = [(x, y) for y in range(4, 8) for x in range(8)
                    if ring_owner(members, tile_route(x, y)) == "m0"][:6]
            before = await router.members["m1"].shard_manifest(0)
            stolen0 = telemetry.FLEET.totals()["stolen"]
            burst = await asyncio.gather(*(get(tile(*xy)) for xy in skew))
            after = await router.members["m1"].shard_manifest(0)
            stolen = telemetry.FLEET.totals()["stolen"] - stolen0
            check(all(a.status == 200 for a, _ in burst) and stolen >= 1,
                  f"fleet_sidecars: the skewed burst made no steal "
                  f"({[a.status for a, _ in burst]})")
            check(len(after) == len(before),
                  "fleet_sidecars: a stolen render was staged in the "
                  "thief sidecar's raw cache")
            doc["steal"] = {"gets": len(skew), "stolen": stolen,
                            "thief_planes": len(after)}

            # Drain m0 with the wire prestage, then the peer byte fetch.
            xy = grid[0] if ring_owner(members, tile_route(*grid[0])) \
                == "m0" else next(g for g in grid if ring_owner(
                    members, tile_route(*g)) == "m0")
            m0_planes = len(await router.members["m0"].shard_manifest(0))
            t = time.perf_counter()
            drained = json.loads((await front.admin_drain(
                "POST", "m0")).body)
            drain_ms = (time.perf_counter() - t) * 1e3
            m1_after = len(await router.members["m1"].shard_manifest(0))
            check(drained["prestaged"] >= 1,
                  f"fleet_sidecars: the drain prestaged nothing on m1: "
                  f"{drained}")
            fetch0 = telemetry.HTTPCACHE.peer_fetches
            again, peer_ms = await get(tile(*xy))
            fetched = telemetry.HTTPCACHE.peer_fetches - fetch0
            check(again.status == 200 and fetched == 1
                  and again.body == combined["bodies"][xy],
                  f"fleet_sidecars: the drained tile was not a peer "
                  f"byte_fetch ({again.status}, {fetched})")
            front.admin_undrain("m0")
            ok, checks = await front.readiness()
            doc["drain"] = {"m0_planes": m0_planes,
                            "planes": drained["planes"],
                            "prestaged": drained["prestaged"],
                            "m1_planes_after": m1_after, "ms": drain_ms}
            doc["peer_fetch"] = {"fetches": fetched, "ms": peer_ms}
            doc["readyz"] = [ok, checks]
        finally:
            await router.close()
            for m in router.members.values():
                await m.client.close()
            front.close()

    try:
        for child, sock in zip(children, socks):
            SC.wait_sidecar_socket(child, sock)
        doc["sidecars_start_s"] = time.perf_counter() - t0
        asyncio.run(run())
    finally:
        for child in children:
            if child.poll() is None:
                child.send_signal(signal.SIGTERM)
        for child in children:
            try:
                child.wait(timeout=60)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
        for log in logs:
            log.close()
    doc["phase_s"] = time.perf_counter() - t0
    print("fleet_sidecars: " + json.dumps(doc), flush=True)
    return doc


# ------------------------------------------------------- autoscale phase

AUTOSCALE_COOLDOWN_S = 3.0
AUTOSCALE_GRID = 8                # the flagship plane's 8 x 8 tiles


def autoscaler_block(**extra) -> dict:
    """The drill's ``autoscaler`` section: the issue's floor, interval,
    hold and cooldown; a queue band of 1.0 / 0.25 a lane."""
    return dict({"enabled": True, "floor": 1, "interval-s": 0.5,
                 "hold-ticks": 2, "cooldown-s": AUTOSCALE_COOLDOWN_S,
                 "queue-high-per-lane": 1.0, "queue-low-per-lane": 0.25},
                **extra)


def autoscale_tile(x: int, y: int):
    return ("render_image_region",
            {"tile": f"0,{x},{y},{TILE},{TILE}", "c": CH, "m": "c",
             "format": "jpeg"})


def pcts(values) -> dict:
    vals = sorted(values)
    if not vals:
        return {"p50_ms": None, "p99_ms": None, "n": 0}
    return {"p50_ms": statistics.median(vals),
            "p99_ms": vals[int(0.99 * (len(vals) - 1))], "n": len(vals)}


def load_submit(client, want: dict, served: list):
    """The load model's service seam over ``client``: a 503 is a shed
    (``OverloadedError``), any other non-200 or a body that differs from
    the default app's an error."""
    from omero_ms_image_region_tpu_torch.server.errors import OverloadedError

    async def submit(arrival):
        status, headers, body, _ = await client.request(
            *autoscale_tile(arrival.x, arrival.y))
        if status == 503:
            raise OverloadedError("shed")
        if status != 200:
            raise RuntimeError(f"HTTP {status} for {arrival.x},{arrival.y}")
        if body != want[(arrival.x, arrival.y)]:
            raise RuntimeError(f"tile {arrival.x},{arrival.y} differs from "
                               f"the default app's bytes")
        served.append(member_of(headers))
    return submit


async def default_bodies(data_dir, lut_root, have_aiohttp) -> dict:
    """The default app's body of each of the 64 tiles (8 in flight)."""
    from omero_ms_image_region_tpu_torch.server.config import AppConfig

    ref = Client(AppConfig.from_dict({
        "data-dir": data_dir,
        "omero.server": {"omero.script_repo_root": lut_root},
        "raw-cache": {"prefetch": False}}), None, have_aiohttp)
    await ref.start()
    try:
        grid = [(x, y) for y in range(AUTOSCALE_GRID)
                for x in range(AUTOSCALE_GRID)]
        sem = asyncio.Semaphore(8)

        async def one(xy):
            async with sem:
                return await ref.request(*autoscale_tile(*xy))
        out = await asyncio.gather(*(one(xy) for xy in grid))
        check(all(s == 200 for s, *_ in out),
              "autoscale: the default app failed a reference GET")
        return {xy: body for xy, (_, _, body, _) in zip(grid, out)}
    finally:
        await ref.stop()


async def autoscale_phase(data_dir, lut_root, have_aiohttp, e2e,
                          smi: str):
    """(A) of the module docstring's ``autoscale:``.  Returns the default
    app's bodies, each kernel's launches over the drill and the burst's
    offered rate."""
    from omero_ms_image_region_tpu_torch.server.config import AppConfig
    from omero_ms_image_region_tpu_torch.services.loadmodel import (
        LoadModel, run_closed_loop, run_open_loop)
    from omero_ms_image_region_tpu_torch.utils import telemetry

    t_phase = time.perf_counter()
    want = await default_bodies(data_dir, lut_root, have_aiohttp)
    telemetry.AUTOSCALER.reset()
    telemetry.LOADMODEL.reset()
    config = AppConfig.from_dict({
        "data-dir": data_dir,
        "omero.server": {"omero.script_repo_root": lut_root},
        "raw-cache": {"prefetch": False},
        "telemetry": {"provenance-header": True,
                      "ready-max-queue-depth": 1_000_000},
        # No stealing, as in JAX's drill: every tile stays on its ring
        # owner, so a member's shard is the tiles it owns.
        "fleet": {"enabled": True, "members": 3, "lane-width": 1,
                  "steal-min-backlog": 0},
        "drain": {"fail-readyz": True},
        "autoscaler": autoscaler_block()})
    reset_launch_counts()
    client = Client(config, None, have_aiohttp)
    await client.start()
    front = client.app_front
    router, scaler = front.router, front.autoscaler
    check(scaler is not None and router.order == ["m0", "m1", "m2"],
          "autoscale: the app built no autoscaler over three members")
    caches = {n: router.members[n].services.raw_cache for n in router.order}

    def keys(name) -> set:
        return {repr(e["key"]) for e in caches[name].snapshot_entries()}

    doc: dict = {"card": smi, "via": client.via,
                 "config": config.autoscaler.__dict__}
    seen = 0
    shard_at_drain: dict = {}
    warm_checks: list = []
    warm: dict = {}
    readyz: list = []
    timeline: list = []
    done = asyncio.Event()
    burst_leg = asyncio.Event()       # joiners are checked in the burst

    async def warm_check(name, prestage):
        if prestage is not None:
            await prestage
        cache = caches[name]
        resident = shard_at_drain.get(name, set()) <= keys(name)
        owned = [xy for xy in want
                 if router.ring.member(tile_route(*xy)) == name]
        h0, m0 = cache.hits, cache.misses
        for xy in owned:
            status, headers, body, _ = await client.request(
                *autoscale_tile(*xy))
            check(status == 200 and body == want[xy],
                  f"autoscale: joiner {name}'s tile {xy} failed or differs")
        hits, misses = cache.hits - h0, cache.misses - m0
        warm[name] = {"shard_planes": len(shard_at_drain.get(name, ())),
                      "resident_again": resident, "owned_gets": len(owned),
                      "hits": hits, "misses": misses,
                      "hit_rate": hits / max(1, hits + misses)}

    async def watch():
        nonlocal seen
        last_ready = 0.0
        while not done.is_set():
            while seen < len(scaler.transitions):
                tr = scaler.transitions[seen]
                seen += 1
                name = tr["member"]
                timeline.append({"action": tr["action"], "member": name,
                                 "t_s": round(time.perf_counter() - t0, 3),
                                 "active": tr["active"]})
                if tr["action"] == "down":
                    shard_at_drain[name] = keys(name)
                elif burst_leg.is_set():
                    warm_checks.append(asyncio.create_task(warm_check(
                        name, router.last_undrain_prestage)))
            parked = router.draining_members("autoscale")
            if parked and time.perf_counter() - last_ready >= 0.25:
                last_ready = time.perf_counter()
                status, body = await client.readyz()
                readyz.append((status, body["checks"].get("drain")))
            await asyncio.sleep(0.05)

    async def wait_floor(deadline_s: float) -> float:
        t = time.perf_counter()
        while time.perf_counter() - t < deadline_s:
            if scaler.active_members() == ["m0"] and (
                    scaler._op is None or scaler._op.done()) \
                    and seen == len(scaler.transitions):
                return time.perf_counter() - t
            await asyncio.sleep(0.05)
        check(False, f"autoscale: the fleet did not reach its floor in "
                     f"{deadline_s} s (active {scaler.active_members()}, "
                     f"transitions {timeline})")

    served: list = []
    submit = load_submit(client, want, served)
    t0 = time.perf_counter()
    watcher = asyncio.create_task(watch())
    try:
        # Warm the working set on the three members (8 in flight).
        sem = asyncio.Semaphore(8)

        async def one(xy):
            async with sem:
                return await client.request(*autoscale_tile(*xy))
        grid = list(want)
        out = await asyncio.gather(*(one(xy) for xy in grid))
        check(all(s == 200 and b == want[xy]
                  for xy, (s, _, b, _) in zip(grid, out)),
              "autoscale: a warm-up GET failed or differs from the default "
              "app's bytes")
        planes = {n: len(caches[n]) for n in router.order}
        check(all(planes.values()), f"autoscale: a member holds no plane "
                                    f"after the warm-up: {planes}")
        doc["warmup"] = {"gets": len(out), "planes": planes,
                         "s": round(time.perf_counter() - t0, 3)}

        # Idle: the autoscaler parks two members.
        t_idle = time.perf_counter()
        doc["idle_to_floor_s"] = await wait_floor(20.0)
        check([t["action"] for t in timeline] == ["down", "down"]
              and [t["member"] for t in timeline] == ["m2", "m1"],
              f"autoscale: idle did not park m2 then m1: {timeline}")
        doc["idle_s"] = round(time.perf_counter() - t_idle, 3)
        for name in ("m1", "m2"):         # a restart's cold card memory
            caches[name].clear()

        # The burst: 1.5x e2e's tiles/s at 8 in flight, open loop.
        model = LoadModel(seed=1234, viewers=200, grid=AUTOSCALE_GRID,
                          max_level=0, bulk_fraction=0.0)
        natural = model.events()
        rate = 1.5 * e2e["concurrent_tiles_per_s"]
        burst = model.window(rate, 10.0, natural)
        before = len(timeline)
        t_burst = time.perf_counter()
        burst_leg.set()
        open_report = await run_open_loop(submit, burst, offered_tps=rate)
        doc["burst_s"] = round(time.perf_counter() - t_burst, 3)
        if scaler._op is not None:
            await scaler._op
        await asyncio.sleep(0.1)          # the watcher sees the last one
        burst_leg.clear()
        await asyncio.gather(*warm_checks)
        grown = [t for t in timeline[before:] if t["action"] == "up"]
        check(grown, f"autoscale: the burst never grew the fleet "
                     f"({timeline[before:]})")
        active = [t["active"] for t in timeline[before:]]
        check(all(b - a in (-1, 1) for a, b in zip([1] + active, active)),
              f"autoscale: a transition moved more than one member: "
              f"{timeline[before:]}")
        for name, w in warm.items():
            check(w["resident_again"] and w["shard_planes"] > 0,
                  f"autoscale: joiner {name} rejoined cold: {w}")
            check(w["owned_gets"] and w["hit_rate"] >= 0.8,
                  f"autoscale: joiner {name}'s owned GETs hit {w}")

        # Quiet: 0.1x, back to the floor.
        quiet = model.window(0.1 * rate, 10.0, natural)
        t_quiet = time.perf_counter()
        quiet_report = await run_open_loop(submit, quiet,
                                           offered_tps=0.1 * rate)
        doc["quiet_s"] = round(time.perf_counter() - t_quiet, 3)
        doc["quiet_to_floor_s"] = await wait_floor(15.0)

        # The same burst arrivals, closed loop at 8 in flight.
        closed_report = await run_closed_loop(submit, burst, concurrency=8)
        launches = launch_counts()
        status, _, body, _ = await client.request_path(
            "GET", "/admin/autoscaler")
        admin = json.loads(body)
        scrape = await client.metrics()
    finally:
        done.set()
        await watcher
        for task in warm_checks:
            task.cancel()
        await asyncio.gather(*warm_checks, return_exceptions=True)
        await client.stop()
    for report in (open_report, quiet_report, closed_report):
        check(report.errors == [], f"autoscale: GETs failed: "
                                   f"{report.errors[:3]}")
    times = [t["t"] for t in scaler.transitions]
    check(all(b - a >= AUTOSCALE_COOLDOWN_S
              for a, b in zip(times, times[1:])),
          f"autoscale: transitions closer than the cooldown: {timeline}")
    check(readyz and all(s == 200 for s, _ in readyz),
          f"autoscale: /readyz was not 200 throughout the autoscale "
          f"drains: {sorted(set(readyz))}")
    check(status == 200 and [(t["action"], t["member"])
                             for t in admin["transitions"]]
          == [(t["action"], t["member"])
              for t in scaler.transitions[-16:]],
          "autoscale: GET /admin/autoscaler does not show the transitions")
    for family in ("imageregion_autoscaler_transitions_total",
                   "imageregion_autoscaler_active_members",
                   "imageregion_loadmodel_offered_total",
                   "imageregion_loadmodel_completed_total"):
        check(family in scrape, f"autoscale: {family} is not in the "
                                f"scrape")
    for name in ("render_ramp", "jpeg_coefficients", "sparse_pack",
                 "compact_rows", "unpack16"):
        check(launches[name] >= 1, f"autoscale: {name} was not launched "
                                   f"in the phase")
    doc.update({
        "offered_tps": rate, "e2e_tiles_per_s":
            e2e["concurrent_tiles_per_s"],
        "transitions": timeline, "warm_joiners": warm,
        "readyz_while_parked": {"polls": len(readyz),
                                "all_200": True},
        "open_loop": dict(pcts(open_report.all_latencies()),
                          served=open_report.served,
                          sheds=open_report.sheds,
                          late_fires=open_report.late_fires,
                          late_ms=open_report.late_ms,
                          window_s=open_report.window_s),
        "quiet_loop": dict(pcts(quiet_report.all_latencies()),
                           served=quiet_report.served,
                           sheds=quiet_report.sheds,
                           late_fires=quiet_report.late_fires),
        "closed_loop": dict(pcts(closed_report.all_latencies()),
                            served=closed_report.served,
                            sheds=closed_report.sheds,
                            concurrency=8),
        "served_by": {n: served.count(n) for n in router.order},
        "bodies_equal_default_app": True,
        "launches": {k: v for k, v in launches.items() if v},
        "phase_s": round(time.perf_counter() - t_phase, 3)})
    print("autoscale: " + json.dumps(doc), flush=True)
    print("autoscale: transitions " + " ".join(
        f"{t['action']}:{t['member']}@{t['t_s']}s" for t in timeline),
        flush=True)
    print(f"autoscale: open loop p50 {doc['open_loop']['p50_ms']} ms, "
          f"p99 {doc['open_loop']['p99_ms']} ms, late fires "
          f"{open_report.late_fires}, sheds {open_report.sheds}; closed "
          f"loop (8) p99 {doc['closed_loop']['p99_ms']} ms ({smi})",
          flush=True)
    print("autoscale: launches " + json.dumps(doc["launches"]), flush=True)
    return want, launches, rate


def autoscale_units_phase(data_dir, lut_root, have_aiohttp, want: dict,
                          rate: float, smi: str) -> dict:
    """(B) of the module docstring's ``autoscale:``: a frontend whose
    autoscaler stops and restarts its members' sidecar units."""
    import socket as socket_mod

    from omero_ms_image_region_tpu_torch.server.config import AppConfig
    from omero_ms_image_region_tpu_torch.services.loadmodel import (
        LoadModel, run_open_loop)
    from omero_ms_image_region_tpu_torch.utils import telemetry

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="units-")
    socks = [os.path.join(tmp, f"u{i}.sock") for i in range(2)]
    conf = os.path.join(tmp, "sidecar.yaml")
    with open(conf, "w") as f:
        json.dump({"data-dir": data_dir, "raw-cache": {"prefetch": False},
                   "omero.server": {"omero.script_repo_root": lut_root}}, f)
    config = AppConfig.from_dict({
        "data-dir": data_dir,
        "telemetry": {"provenance-header": True,
                      "ready-max-queue-depth": 1_000_000},
        "sidecar": {"role": "frontend"},
        "fleet": {"enabled": True, "sockets": socks, "lane-width": 1},
        # Four ticks to act: the open load that restarts m1 must not read
        # as idle between bunched arrivals and park it again.
        "autoscaler": autoscaler_block(**{"unit-config": conf,
                                          "queue-low-per-lane": 0.0,
                                          "hold-ticks": 4})})
    doc: dict = {"card": smi}

    def units_alive() -> list:
        return [bool(pgrep(f"--sidecar-socket {sock}")) for sock in socks]

    async def run():
        client = Client(config, None, have_aiohttp)
        t = time.perf_counter()
        await client.start()
        front = client.app_front
        lifecycle, router = front.unit_lifecycle, front.router
        check(lifecycle is not None and front.autoscaler is not None,
              "autoscale units: the frontend built no unit lifecycle")
        if client.via == "front":
            await asyncio.to_thread(lifecycle.start_all)
        doc["units_start_s"] = round(time.perf_counter() - t, 3)
        undrains: list = []
        real_undrain = router.undrain_member

        def undrain(name, *a, **k):
            # The restarted unit's socket must accept before the undrain.
            sock = socks[router.order.index(name)]
            probe = socket_mod.socket(socket_mod.AF_UNIX)
            try:
                probe.settimeout(2.0)
                probe.connect(sock)
                accepted = True
            except OSError:
                accepted = False
            finally:
                probe.close()
            undrains.append((name, accepted, lifecycle.alive(name)))
            return real_undrain(name, *a, **k)

        router.undrain_member = undrain
        served: list = []
        submit = load_submit(client, want, served)
        scaler = front.autoscaler
        try:
            check(units_alive() == [True, True],
                  "autoscale units: the startup did not spawn both units")
            for xy in list(want)[:8]:
                status, _, body, _ = await client.request(
                    *autoscale_tile(*xy))
                check(status == 200 and body == want[xy],
                      f"autoscale units: tile {xy} failed or differs")
            # Idle: m1 parked and its process stopped.
            t = time.perf_counter()
            while time.perf_counter() - t < 30.0:
                if (scaler.active_members() == ["m0"]
                        and scaler._op is not None and scaler._op.done()):
                    break
                await asyncio.sleep(0.05)
            check(scaler.active_members() == ["m0"]
                  and not lifecycle.alive("m1"),
                  f"autoscale units: idle did not park and stop m1 "
                  f"({scaler.transitions})")
            check(units_alive() == [True, False],
                  f"autoscale units: pgrep still finds m1's sidecar "
                  f"({units_alive()})")
            doc["park_and_stop_s"] = round(time.perf_counter() - t, 3)
            # Open-loop load restarts m1 and runs on (stopped once the
            # restarted m1 served): an idle fleet would park the member
            # again as soon as its restart op ends (the spawn outlasts the
            # cooldown, JAX's policy too).
            model = LoadModel(seed=1234, viewers=200, grid=AUTOSCALE_GRID,
                              max_level=0, bulk_fraction=0.0)
            stop = asyncio.Event()
            load = asyncio.create_task(run_open_loop(
                submit, model.window(rate, 40.0), offered_tps=rate,
                stop=stop))
            t = time.perf_counter()
            try:
                while (time.perf_counter() - t < 90.0 and not (
                        scaler.active_members() == ["m0", "m1"]
                        and scaler._op is not None and scaler._op.done())):
                    await asyncio.sleep(0.1)
                check(scaler.active_members() == ["m0", "m1"]
                      and lifecycle.alive("m1")
                      and units_alive() == [True, True],
                      f"autoscale units: the load did not restart m1 "
                      f"({scaler.transitions}, {units_alive()})")
                check(undrains == [("m1", True, True)],
                      f"autoscale units: m1 was undrained before its "
                      f"socket accepted: {undrains}")
                doc["restart_s"] = round(time.perf_counter() - t, 3)
                # The first GETs after the undrain may still go to m0: the
                # restarted unit's wire breaker, opened by the peer byte
                # fetches that failed while it was stopped, decays to
                # half-open within fault-tolerance.breaker-reset-s (JAX's
                # client does the same).  m1's own tiles are asked for until
                # m1 serves one.
                m1_tiles = [xy for xy in want if router.ring.member(
                    tile_route(*xy)) == "m1"][:4]
                t = time.perf_counter()
                first_m1 = None
                sheds = 0
                while first_m1 is None and time.perf_counter() - t < 30.0:
                    for xy in m1_tiles:
                        routed0 = telemetry.FLEET.routed.get("m1", 0)
                        status, _, body, _ = await client.request(
                            *autoscale_tile(*xy))
                        if status == 503:  # the half-open breaker's shed
                            sheds += 1
                            continue
                        check(status == 200 and body == want[xy],
                              f"autoscale units: m1's tile {xy} after the "
                              f"restart failed or differs ({status})")
                        if telemetry.FLEET.routed.get("m1", 0) > routed0:
                            first_m1 = time.perf_counter() - t
                            break
                    else:
                        await asyncio.sleep(0.25)
            finally:
                stop.set()
                report = await load
            breaker = router.members["m1"].client.breaker
            check(first_m1 is not None,
                  f"autoscale units: the restarted m1 served none of its "
                  f"tiles in 30 s (breaker {breaker.state_name}, opens "
                  f"{breaker.opens})")
            check(report.errors == [], f"autoscale units: GETs failed: "
                                       f"{report.errors[:3]}")
            doc["m1_serving_after_restart_s"] = round(first_m1, 3)
            doc["sheds_before_m1_served"] = sheds
            doc["m1_breaker"] = {"state": breaker.state_name,
                                 "opens": breaker.opens}
            doc["breaker_events"] = [
                {k: v for k, v in e.items() if k != "ts"}
                for e in telemetry.FLIGHT.snapshot()
                if e["kind"].startswith("breaker.")][-8:]
            doc.update({
                "transitions": [(t["action"], t["member"])
                                for t in scaler.transitions],
                "burst": dict(pcts(report.all_latencies()),
                              served=report.served, sheds=report.sheds,
                              late_fires=report.late_fires),
                "unit_starts": {n: u.starts
                                for n, u in lifecycle.units.items()},
                "unit_stops": {n: u.stops
                               for n, u in lifecycle.units.items()},
                "bodies_equal_default_app": True})
        finally:
            await client.stop()
            if client.via == "front":
                await asyncio.to_thread(lifecycle.stop_all)

    asyncio.run(run())
    check(units_alive() == [False, False],
          "autoscale units: a unit outlived the frontend's cleanup")
    doc["phase_s"] = round(time.perf_counter() - t_phase, 3)
    print("autoscale units: " + json.dumps(doc), flush=True)
    return doc


class ServerLife:
    """``python -m omero_ms_image_region_tpu_torch.server --config`` in
    ``cwd`` (its package is the one under ``cwd``), stopped with SIGTERM."""

    def __init__(self, cwd: str, config_path: str, port: int,
                 bin_dir: str, log_path: str):
        env = dict(os.environ, PYTHONPATH=cwd,
                   PATH=bin_dir + os.pathsep + os.environ.get("PATH", ""))
        self.port, self.log_path = port, log_path
        self.log = open(log_path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "omero_ms_image_region_tpu_torch.server",
             "--config", config_path, "--device", DEVICE], cwd=cwd,
            env=env, stdout=self.log, stderr=subprocess.STDOUT)

    def wait_ready(self, rehydrate: bool,
                   timeout_s: float = 600.0) -> tuple:
        """Poll ``/readyz`` until 200 and, with ``rehydrate``, the boot
        rehydrate ended; (seconds to the first 200, seconds to the end,
        the last body)."""
        ready_s = None
        while True:
            check(self.proc.poll() is None,
                  f"warm_restart: the server exited with "
                  f"{self.proc.returncode}")
            check(time.perf_counter() - self.t0 < timeout_s,
                  "warm_restart: /readyz did not reach 200 with the "
                  "rehydrate done")
            try:
                status, _, body, _ = http_get(self.port, "/readyz", 10.0)
            except OSError:
                time.sleep(0.2)
                continue
            doc = json.loads(body)
            if status == 200 and ready_s is None:
                ready_s = time.perf_counter() - self.t0
            state = doc["checks"].get("rehydrate", "")
            if status == 200 and (not rehydrate or state.startswith(
                    ("done", "aborted"))):
                return ready_s, time.perf_counter() - self.t0, doc
            time.sleep(0.1)

    def stop(self) -> int:
        """SIGTERM, then the exit code (kill after 120 s)."""
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.log.close()
        return self.proc.returncode

    def tail(self, n: int = 40) -> str:
        with open(self.log_path) as f:
            return "".join(f.readlines()[-n:])

    def prewarm_split(self) -> dict:
        """The prewarm's logged seconds: loading (or building) the
        libraries, and the launches at B = 1..8."""
        import re

        with open(self.log_path) as f:
            text = f.read()
        out = {}
        for key, pattern in (("libraries_s", r"kernels built and loaded in "
                                             r"([0-9.]+) s"),
                             ("launches_s", r"prewarmed \S+ .* in "
                                            r"([0-9.]+) s")):
            m = re.search(pattern, text)
            out[key] = float(m.group(1)) if m else None
        return out


# ------------------------------------------------------ federation phase

FED_HOSTS = ("hostA", "hostB", "hostC")
FED_MEMBERS = ("a0", "b0", "c0")
FED_SEEDS = ("fed-epoch-1", "fed-epoch-2")
FED_SUSPECT_S = 2.0
FED_GOSSIP_S = 0.5
LUT_CH = CH.replace("$00FF00", "$smoke.lut")


def seeded_ring_owner(members, key: str, seed: str, points: int = 64) -> str:
    """:func:`ring_owner` with a federation's ring seed: ``"<seed>|"``
    before every point's and the key's string, computed here without the
    port."""
    import bisect
    import hashlib

    def point(s: str) -> int:
        return int.from_bytes(hashlib.blake2b(
            s.encode(), digest_size=8).digest(), "big")
    ring = sorted((point(f"{seed}|{m}#{v}"), m) for m in members
                  for v in range(points))
    i = bisect.bisect([p for p, _ in ring], point(f"{seed}|{key}")) % len(
        ring)
    return ring[i][1]


def fed_owner(xy, seed: str) -> str:
    return seeded_ring_owner(FED_MEMBERS, tile_route(*xy), seed)


def fed_block(host: str, socks: dict) -> dict:
    """The three hosts' ``federation`` section: a0 in the smoke's own
    process, b0 and c0 on the sidecars' sockets; quorum on."""
    return {"enabled": True, "host": host, "quorum": True,
            "shard-epoch": 1, "ring-seed": FED_SEEDS[0],
            "gossip-interval-s": FED_GOSSIP_S,
            "suspect-after-s": FED_SUSPECT_S,
            "members": [{"name": "a0", "host": "hostA"},
                        {"name": "b0", "host": "hostB",
                         "address": socks["hostB"]},
                        {"name": "c0", "host": "hostC",
                         "address": socks["hostC"]}]}


def tier_of(headers) -> str:
    """The provenance header's byte source tier (``-``: none)."""
    for part in (headers.get("X-Image-Region-Provenance") or "").split("; "):
        if part.startswith("tier="):
            return part[len("tier="):]
    return "-"


def lut_tile(xy):
    return ("render_image_region",
            {"tile": f"0,{xy[0]},{xy[1]},{TILE},{TILE}", "c": LUT_CH,
             "m": "c", "format": "jpeg"})


async def reference_bodies(data_dir, lut_root, have_aiohttp, reqs) -> list:
    """The default app's bodies of ``reqs``."""
    from omero_ms_image_region_tpu_torch.server.config import AppConfig

    ref = Client(AppConfig.from_dict({
        "data-dir": data_dir,
        "omero.server": {"omero.script_repo_root": lut_root},
        "raw-cache": {"prefetch": False}}), None, have_aiohttp)
    await ref.start()
    try:
        out = [await ref.request(*r) for r in reqs]
        check(all(s == 200 for s, *_ in out),
              "federation: the default app failed a reference GET")
        return [body for _, _, body, _ in out]
    finally:
        await ref.stop()


def federation_phase(data_dir, lut_root, have_aiohttp, want: dict,
                     smi: str) -> dict:
    """The module docstring's ``federation:``: three hosts on the card,
    this process's federated app (host A) and two ``--role sidecar``
    processes (hosts B and C).  Returns this process's launches over the
    serve leg."""
    import signal

    from omero_ms_image_region_tpu_torch.server import sidecar as SC

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="fed-")
    socks = {h: os.path.join(tmp, f"{h}.sock") for h in FED_HOSTS[1:]}
    logs, children = {}, {}
    for host, sock in socks.items():
        conf = os.path.join(tmp, f"{host}.yaml")
        with open(conf, "w") as f:
            json.dump({"data-dir": data_dir,
                       "omero.server": {"omero.script_repo_root": lut_root},
                       "raw-cache": {"prefetch": False},
                       "federation": fed_block(host, socks)}, f)
        logs[host] = open(os.path.join(tmp, f"{host}.log"), "w")
        children[host] = subprocess.Popen(
            [sys.executable, "-m", "omero_ms_image_region_tpu_torch.server",
             "--role", "sidecar", "--sidecar-socket", sock, "--config",
             conf, "--device", DEVICE],
            stdout=logs[host], stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=os.getcwd()))
    doc: dict = {"card": smi, "hosts": list(FED_HOSTS),
                 "members": dict(zip(FED_MEMBERS, FED_HOSTS)),
                 "suspect_after_s": FED_SUSPECT_S,
                 "gossip_interval_s": FED_GOSSIP_S}
    try:
        for host, child in children.items():
            SC.wait_sidecar_socket(child, socks[host])
        doc["sidecars_start_s"] = time.perf_counter() - t_phase
        asyncio.run(federation_legs(data_dir, lut_root, have_aiohttp, want,
                                    socks, children, doc))
    except Exception:
        for host, log in logs.items():
            log.flush()
            with open(log.name) as f:
                tail = f.read()[-3000:]
            print(f"federation: {host}'s log tail:\n{tail}", flush=True)
        raise
    finally:
        for child in children.values():
            if child.poll() is None:
                child.send_signal(signal.SIGTERM)
        for child in children.values():
            try:
                child.wait(timeout=60)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
        for log in logs.values():
            log.close()
    doc["phase_s"] = time.perf_counter() - t_phase
    print("federation: " + json.dumps(doc), flush=True)
    return doc["serve"]["launches"]


async def federation_legs(data_dir, lut_root, have_aiohttp, want: dict,
                          socks: dict, children: dict, doc: dict) -> None:
    """The six legs: join, serve, epoch roll, cross-host drain, netsplit,
    death."""
    from omero_ms_image_region_tpu_torch.parallel import federation as F
    from omero_ms_image_region_tpu_torch.server import sidecar as SC
    from omero_ms_image_region_tpu_torch.server.config import AppConfig
    from omero_ms_image_region_tpu_torch.utils import faultinject, telemetry

    grid = [(x, y) for y in range(AUTOSCALE_GRID)
            for x in range(AUTOSCALE_GRID)]
    routes = [tile_route(*xy) for xy in grid]          # the 64 probes
    luts = [next(xy for xy in grid if fed_owner(xy, FED_SEEDS[0]) == m)
            for m in ("a0", "b0")]
    lut_want = await reference_bodies(data_dir, lut_root, have_aiohttp,
                                      [lut_tile(xy) for xy in luts])
    config = AppConfig.from_dict({
        "data-dir": data_dir,
        "omero.server": {"omero.script_repo_root": lut_root},
        "raw-cache": {"prefetch": False},
        "telemetry": {"provenance-header": True,
                      "ready-max-queue-depth": 1_000_000},
        # No stealing: every tile is served by its ring owner.
        "fleet": {"steal-min-backlog": 0},
        "federation": fed_block("hostA", socks)})
    client = Client(config, None, have_aiohttp)
    await client.start()
    front = client.app_front
    router, coord = front.router, front.federation
    check(coord is not None and router.order == list(FED_MEMBERS),
          "federation: the app built no federation over a0, b0, c0")
    gossip = None
    if client.via == "front":
        # The app's startup does this over HTTP.
        await coord.agree(strict=True)
        gossip = asyncio.create_task(coord.run())
    # Control clients, unstamped (never partitioned) and breakerless.
    ctl = {h: SC.SidecarClient(s, breaker=None) for h, s in socks.items()}

    async def op(host, name, **extra):
        status, body = await ctl[host].call(name, {}, extra=extra)
        check(status == 200, f"federation: {name} on {host}: {status}")
        return json.loads(bytes(body).decode())

    async def owners_everywhere(manifest):
        """Each host's own ring over the 64 probes, and its digest."""
        owners = {"hostA": [router.ring.member(k) for k in routes]}
        digests = {"hostA": F.current().digest()}
        for host in FED_HOSTS[1:]:
            answer = await op(host, "manifest_hello",
                              manifest=manifest.to_json(),
                              probe_keys=routes, from_host="hostA")
            check(answer.get("agreed") is True,
                  f"federation: {host} did not agree: {answer}")
            owners[host], digests[host] = answer["owners"], answer["digest"]
        want_owners = [seeded_ring_owner(FED_MEMBERS, k, manifest.ring_seed)
                       for k in routes]
        for host, mine in owners.items():
            check(mine == want_owners,
                  f"federation: {host}'s ring disagrees with the seeded "
                  f"ring over the probes")
        check(set(digests.values()) == {manifest.digest()},
              f"federation: the digests differ: {digests}")
        return {"digest": manifest.digest(), "epoch": manifest.version,
                "owners": {m: want_owners.count(m) for m in FED_MEMBERS}}

    async def gets(reqs, depth=8):
        sem = asyncio.Semaphore(depth)

        async def one(r):
            async with sem:
                return await client.request(*r)
        t0 = time.perf_counter()
        out = await asyncio.gather(*(one(r) for r in reqs))
        return out, time.perf_counter() - t0

    def checked(leg, tiles, out, seed=None, allow_shed=False,
                avoid=None) -> dict:
        """Every 200 is the default app's body (on the seed's owner, or
        not on ``avoid``); a 503 is a shed where allowed; nothing else."""
        counts = {"200": 0, "503": 0}
        for xy, (status, headers, body, _) in zip(tiles, out):
            if status == 503 and allow_shed:
                counts["503"] += 1
                continue
            check(status == 200, f"federation {leg}: HTTP {status} for "
                                 f"{xy}")
            check(body == want[xy], f"federation {leg}: {xy} differs from "
                                    f"the default app's body")
            member = member_of(headers)
            if seed is not None:
                check(member == fed_owner(xy, seed),
                      f"federation {leg}: {xy} served by {member}, not "
                      f"its ring owner {fed_owner(xy, seed)}")
            check(member != avoid, f"federation {leg}: {xy} served by "
                                   f"{avoid}")
            counts["200"] += 1
        return counts

    try:
        # 1. Join: one digest, each host's own ring over 64 probes.
        check(coord.agreement == {"b0": "agreed", "c0": "agreed"},
              f"federation: the startup agreement {coord.agreement}")
        doc["join"] = await owners_everywhere(coord.manifest)
        doc["join"]["agreement"] = dict(coord.agreement)

        # 2. Serve: 48 cold, the same 48 warm, the LUT GETs.
        serve = grid[:48]
        reset_launch_counts()
        cold, cold_wall = await gets([autoscale_tile(*xy) for xy in serve])
        doc_serve = {"cold": checked("cold", serve, cold, FED_SEEDS[0])}
        warm, warm_wall = await gets([autoscale_tile(*xy) for xy in serve])
        doc_serve["warm"] = checked("warm", serve, warm, FED_SEEDS[0])
        lut = [await client.request(*lut_tile(xy)) for xy in luts]
        for xy, body, (status, headers, got, _) in zip(luts, lut_want, lut):
            check(status == 200 and got == body
                  and member_of(headers) == fed_owner(xy, FED_SEEDS[0]),
                  f"federation: the LUT GET of {xy} ({status}, "
                  f"{member_of(headers)}) differs from the default app's")
        launches = launch_counts()
        for name in ("render_ramp", "render_lut", *SPARSE_WIRE, "unpack16"):
            check(launches[name] >= 1, f"federation: {name} was not "
                                       f"launched by the serve leg")
        served_by = {m: sum(member_of(h) == m for _, h, _, _ in cold)
                     for m in FED_MEMBERS}
        check(all(served_by.values()), f"federation: a member served "
                                       f"nothing: {served_by}")
        # fed.hop: any the GETs' traces hold (the peer byte tier's), and
        # one traced agreement and gossip round with the two other hosts.
        get_hops = sum(sp["name"] == "fed.hop"
                       for tr in telemetry.TRACES.recent()
                       for sp in tr.export_spans())
        tid = telemetry.new_trace_id()
        with telemetry.trace_scope(tid):
            await coord.agree(strict=True)
            await coord.gossip_once()
        hops = [sp for sp in telemetry.TRACES.finish(tid).export_spans()
                if sp["name"] == "fed.hop"]
        doc_serve.update({
            "tiles": len(serve), "in_flight": 8,
            "cold_p50_ms": statistics.median(ms for *_, ms in cold),
            "warm_p50_ms": statistics.median(ms for *_, ms in warm),
            "cold_tiles_per_s": len(serve) / cold_wall,
            "warm_tiles_per_s": len(serve) / warm_wall,
            "warm_tiers": {t: sum(tier_of(h) == t for _, h, _, _ in warm)
                           for t in {tier_of(h) for _, h, _, _ in warm}},
            "served_by": served_by,
            "lut_gets": [[list(xy), fed_owner(xy, FED_SEEDS[0])]
                         for xy in luts],
            "fed_hop": {"count": len(hops),
                        "p50_ms": (statistics.median(
                            sp["dur_ms"] for sp in hops) if hops else None),
                        "kinds": sorted({sp.get("kind") for sp in hops}),
                        "in_get_traces": get_hops},
            "launches": launches})
        doc["serve"] = doc_serve
        check(len(hops) >= 4, f"federation: {len(hops)} fed.hop spans in "
                              f"a traced agreement and gossip round")

        # 3. The epoch roll with 8 GETs in flight.
        new = F.FleetManifest(coord.manifest.members, version=2,
                              ring_seed=FED_SEEDS[1],
                              replicas=coord.manifest.replicas)
        during = grid[48:56]
        inflight = asyncio.ensure_future(
            gets([autoscale_tile(*xy) for xy in during]))
        await asyncio.sleep(0)
        t0 = time.perf_counter()
        rolled = await coord.roll_epoch(new)
        roll_ms = (time.perf_counter() - t0) * 1e3
        out, _ = await inflight
        check(rolled["committed"] and rolled["acks"] == 3
              and rolled["verdicts"] == {"hostB": "installed",
                                         "hostC": "installed"},
              f"federation: the roll did not commit on every host: "
              f"{rolled}")
        doc["roll"] = {"ms": roll_ms, "acks": rolled["acks"],
                       "verdicts": rolled["verdicts"],
                       "gets_in_flight": checked("roll", during, out)}
        doc["roll"].update(await owners_everywhere(new))
        moved = sum(fed_owner(xy, FED_SEEDS[0]) != fed_owner(xy, FED_SEEDS[1])
                    for xy in grid)
        doc["roll"]["probes_moved"] = moved
        post, _ = await gets([autoscale_tile(*xy) for xy in serve])
        doc["roll"]["after"] = checked("after roll", serve, post,
                                       FED_SEEDS[1])

        # 4. The cross-host drain of a0: its warm planes ship to the
        # successors over shard_transfer.
        mine = [xy for xy in serve if fed_owner(xy, FED_SEEDS[1]) == "a0"]
        check(mine, "federation: a0 owns none of the served tiles")
        n0, b0_ = (telemetry.FEDERATION.shard_transfers,
                   telemetry.FEDERATION.transfer_bytes)
        t0 = time.perf_counter()
        status, _, body, _ = await client.request_path(
            "POST", "/admin/drain?member=a0")
        drain_ms = (time.perf_counter() - t0) * 1e3
        drained = json.loads(body)
        shipped = telemetry.FEDERATION.shard_transfers - n0
        check(status == 200 and shipped >= 1,
              f"federation: the drain of a0 shipped no plane ({status}, "
              f"{drained.get('prestaged')})")
        out, _ = await gets([autoscale_tile(*xy) for xy in mine])
        counts = checked("drained", mine, out, avoid="a0")
        hits = sum(tier_of(h) == "hbm_warm" for _, h, _, _ in out)
        hit_rate = hits / len(mine)
        check(hit_rate >= 0.8, f"federation: the drained set's raw-cache "
                               f"hit rate on the successors is {hit_rate}")
        await client.request_path("POST", "/admin/undrain?member=a0")
        doc["drain"] = {"member": "a0", "planes": drained.get("planes"),
                        "staged": drained.get("prestaged"),
                        "shard_transfers": shipped,
                        "bytes": telemetry.FEDERATION.transfer_bytes - b0_,
                        "ms": drain_ms, "drained_gets": counts,
                        "successor_hit_rate": hit_rate,
                        "renders_on_a0": 0}

        # 5. The netsplit: host C cut off both ways.
        t_split = time.perf_counter()
        faultinject.PARTITIONS.add("hostA", "hostC")
        await op("hostB", "partition", action="add", src="hostB",
                 dst="hostC")
        for dst in ("hostA", "hostB"):
            await op("hostC", "partition", action="add", src="hostC",
                     dst=dst)
        while True:
            c_state = await op("hostC", "partition", action="show")
            if c_state["quorum"]["fenced"]:
                break
            check(time.perf_counter() - t_split < 30,
                  "federation: host C never fenced")
            await asyncio.sleep(0.05)
        fence_s = time.perf_counter() - t_split
        check(fence_s <= FED_SUSPECT_S + 1.2 * FED_GOSSIP_S + 0.5,
              f"federation: host C fenced after {fence_s:.2f} s")
        b_state = await op("hostB", "partition", action="show")
        check(F.quorum_status()["quorate"] and b_state["quorum"]["quorate"],
              "federation: hosts A and B lost their quorum in the split")
        c_tiles = [xy for xy in grid if fed_owner(xy, FED_SEEDS[1]) == "c0"]
        out, _ = await gets([autoscale_tile(*xy) for xy in c_tiles])
        split_counts = checked("netsplit", c_tiles, out, allow_shed=True,
                               avoid="c0")
        check(split_counts["200"] >= 1,
              "federation: no c0-owned GET failed over in the split")
        # The fenced minority refuses state changes: a roll's propose and
        # an inbound staging, sent over the drill's control client (which
        # no rule cuts) without a from_host, so C hears no one.
        v3 = F.FleetManifest(new.members, version=3, ring_seed="fed-x",
                             replicas=new.replicas)
        refused = [await op("hostC", "epoch_propose",
                            manifest=v3.to_json()),
                   await op("hostC", "prestage", entries=[])]
        check(refused[0].get("reason") == "fenced"
              and refused[1].get("fenced") is True,
              f"federation: fenced host C accepted {refused}")
        c_state = await op("hostC", "partition", action="show")
        refusals = {"hostA": F.quorum_status()["refusals"],
                    "hostB": b_state["quorum"]["refusals"],
                    "hostC": c_state["quorum"]["refusals"]}
        t_heal = time.perf_counter()
        faultinject.PARTITIONS.clear()
        for host in FED_HOSTS[1:]:
            await op(host, "partition", action="clear")
        while True:
            c_state = await op("hostC", "partition", action="show")
            if c_state["quorum"]["quorate"]:
                break
            check(time.perf_counter() - t_heal < 30,
                  "federation: host C never restored its quorum")
            await asyncio.sleep(0.05)
        doc["netsplit"] = {"fence_s": fence_s,
                           "restore_s": time.perf_counter() - t_heal,
                           "c0_gets": split_counts, "refusals": refusals,
                           "c_reachable_after": c_state["quorum"][
                               "reachable"]}

        # 6. Death: host B's process killed with 8 GETs in flight.
        b_tiles = [xy for xy in grid
                   if fed_owner(xy, FED_SEEDS[1]) == "b0"][:8]
        inflight = asyncio.ensure_future(
            gets([autoscale_tile(*xy) for xy in b_tiles]))
        await asyncio.sleep(0.005)
        children["hostB"].kill()
        children["hostB"].wait(timeout=30)
        out, _ = await inflight
        death = checked("death", b_tiles, out, allow_shed=True)
        again, _ = await gets([autoscale_tile(*xy) for xy in b_tiles])
        after = checked("after death", b_tiles, again, allow_shed=True,
                        avoid="b0")
        ready_status, ready = await client.readyz()
        check(ready_status == 200, f"federation: /readyz {ready_status} "
                                   f"after host B died: {ready}")
        doc["death"] = {"in_flight": death, "after": after,
                        "readyz": ready_status,
                        "fleet": ready["checks"].get("fleet"),
                        "federation": ready["checks"].get("federation")}
        status, _, body, _ = await client.request_path(
            "GET", "/admin/federation")
        fed_doc = json.loads(body)
        doc["admin_federation"] = {k: fed_doc.get(k) for k in (
            "epoch", "agreement", "gossip")}
    finally:
        for c in ctl.values():
            await c.close()
        if gossip is not None:
            gossip.cancel()
            await asyncio.gather(gossip, return_exceptions=True)
        faultinject.PARTITIONS.clear()
        await client.stop()
        if client.via == "front":
            for c in front.clients():
                await c.close()
            F.uninstall()


def warm_restart_phase(torch, np, data_dir, lut_root, have_pil,
                       smi: str) -> dict:
    """Two lives of the server with ``persistence`` on (module docstring,
    phase 5); fails on any check."""
    import shutil

    import yaml

    from omero_ms_image_region_tpu_torch import __file__ as pkg_init

    config, handler = front_handler(data_dir, lut_root, {})
    matches_plain = plain_matcher(torch, np, handler, have_pil)
    route = "render_image_region"
    tiles = [{"tile": f"0,{i},5,{TILE},{TILE}", "c": CH, "m": "c",
              "format": "jpeg"} for i in range(8)]
    tiles += [dict(q, c=CH2) for q in tiles]
    rewindowed = [dict(q, c=CH3) for q in tiles[:8]]

    def url(q):
        from urllib.parse import urlencode
        return f"/webgateway/{route}/1/0/0?" + urlencode(q)

    mask_url = "/webgateway/render_shape_mask/1?color=FF00FF"
    with tempfile.TemporaryDirectory() as tmp:
        bin_dir, compilers = compiler_wrappers(tmp)
        warm, flight = os.path.join(tmp, "warm"), os.path.join(tmp, "flight")
        port = free_port()
        cfg = {"port": port, "data-dir": data_dir,
               "omero.server": {"omero.script_repo_root": lut_root},
               "renderer": {"prewarm": [f"4x{TILE}"]},
               "persistence": {"enabled": True, "dir": warm},
               "image-region-cache": {"enabled": True},
               "pixels-metadata-cache": {"enabled": True},
               "shape-mask-cache": {"enabled": True},
               "telemetry": {"provenance-header": True,
                             "flight-recorder-dir": flight}}
        config_path = os.path.join(tmp, "config.yaml")
        with open(config_path, "w") as f:
            yaml.safe_dump(cfg, f)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(pkg_init)))

        # Life 1, from the repo.
        life = ServerLife(repo, config_path, port, bin_dir,
                          os.path.join(tmp, "life1.log"))
        try:
            ready1, _, _ = life.wait_ready(rehydrate=False)
            first = []
            for path in [url(q) for q in tiles] + [mask_url]:
                status, headers, body, _ = http_get(port, path)
                check(status == 200, f"warm_restart: life 1 {path}: "
                                     f"HTTP {status}")
                first.append(body)
        except BaseException:
            life.stop()
            print("warm_restart life 1 log tail:\n" + life.tail(), flush=True)
            raise
        rc1 = life.stop()
        split1 = life.prewarm_split()
        builds1 = builds_logged(compilers)
        check(rc1 == 0, f"warm_restart: life 1 exited with {rc1}")
        manifest_path = os.path.join(warm, "manifest.json")
        check(os.path.exists(manifest_path),
              "warm_restart: life 1 left no manifest")
        with open(manifest_path) as f:
            manifest = json.load(f)
        dumps = sorted(os.listdir(flight)) if os.path.isdir(flight) else []
        check(len(dumps) == 1, f"warm_restart: life 1 left {len(dumps)} "
                               f"flight dumps, not 1")
        with open(os.path.join(flight, dumps[0])) as f:
            kinds = [e["kind"] for e in json.load(f)["events"]]
        check("signal" in kinds and "warmstate.snapshot" in kinds
              and kinds.index("signal") < kinds.index("warmstate.snapshot"),
              f"warm_restart: the dump's events lack the signal or the "
              f"snapshot after it: {kinds[-8:]}")

        # Life 2, from a fresh copy of the package with empty _build/.
        deploy = os.path.join(tmp, "deploy")
        pkg = os.path.join(deploy, "omero_ms_image_region_tpu_torch")
        shutil.copytree(os.path.dirname(os.path.abspath(pkg_init)), pkg,
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        for sub in ("kernels", "native"):
            os.makedirs(os.path.join(pkg, sub, "_build"))
        mark = len(builds_logged(compilers))
        life = ServerLife(deploy, config_path, port, bin_dir,
                          os.path.join(tmp, "life2.log"))
        try:
            ready2, rehydrated2, ready_doc = life.wait_ready(
                rehydrate=True)
            before = scrape(port)
            repeat_ms = []
            for path, body in zip([url(q) for q in tiles] + [mask_url],
                                  first):
                status, headers, again, ms = http_get(port, path)
                tier = headers.get("X-Image-Region-Provenance", "")
                check(status == 200 and again == body
                      and "tier=byte_cache" in tier,
                      f"warm_restart: life 2's repeat of {path}: HTTP "
                      f"{status}, {tier!r}, same bytes: {again == body}")
                repeat_ms.append(ms)
            between = scrape(port)
            rewindow_ms, plain_ok = [], []
            for q in rewindowed:
                status, headers, body, ms = http_get(port, url(q))
                tier = headers.get("X-Image-Region-Provenance", "")
                check(status == 200 and "tier=hbm_warm" in tier,
                      f"warm_restart: re-windowed {q['tile']}: HTTP "
                      f"{status}, {tier!r}")
                rewindow_ms.append(ms)
                plain_ok.append(asyncio.run(matches_plain(route, q,
                                                          body))[3])
            after = scrape(port)
            status, _, ring, _ = http_get(port, "/debug/flightrecorder")
            events = json.loads(ring)["events"]
        except BaseException:
            life.stop()
            print("warm_restart life 2 log tail:\n" + life.tail(), flush=True)
            raise
        rc2 = life.stop()
        split2 = life.prewarm_split()
        builds2 = builds_logged(compilers)[mark:]

    def delta(a, b, name):
        return metric_value(b, name) - metric_value(a, name)

    loads = [e for e in events if e["kind"] == "execcache.load"]
    n_exec = len(manifest["executables"])
    doc = {
        "ready_s": [ready1, ready2], "rehydrated_s": rehydrated2,
        "prewarm_s": [split1, split2],
        "readyz": ready_doc["checks"],
        "rehydrate_ms": metric_value(after,
                                     "imageregion_rehydrate_duration_ms"),
        "rehydrate_items": metric_value(after,
                                        "imageregion_rehydrate_items_total"),
        "bytes_promoted": metric_value(
            after, "imageregion_rehydrate_bytes_promoted_total"),
        "planes_restaged": metric_value(
            after, "imageregion_rehydrate_planes_restaged_total"),
        "executables_loaded": metric_value(
            after, "imageregion_rehydrate_executables_loaded_total"),
        "manifest": {"byte_keys": {k: len(v) for k, v in
                                   manifest["byte_keys"].items()},
                     "planes": len(manifest["planes"]),
                     "executables": n_exec},
        "store_loads": metric_value(after,
                                    "imageregion_execcache_loaded_total"),
        "store_misses": metric_value(after, "imageregion_execcache_misses"),
        "execcache_load_events": len(loads),
        "builds": [len(builds1), len(builds2)],
        "repeat_p50_ms": statistics.median(repeat_ms),
        "repeat_groups": delta(before, between,
                               "imageregion_batches_dispatched"),
        "rewindow_p50_ms": statistics.median(rewindow_ms),
        "rewindow_groups": delta(between, after,
                                 "imageregion_batches_dispatched"),
        "rewindow_tiles": delta(between, after,
                                "imageregion_tiles_rendered"),
        "rewindow_raw_hits": delta(between, after,
                                   "imageregion_rawcache_hits"),
        "rewindow_reads": delta(between, after,
                                'imageregion_span_count{span='
                                '"PixelsService.readRegion"}'),
        "rewindow_plain_equal": sum(plain_ok), "exit": [rc1, rc2],
        "nvidia_smi": smi}
    print("warm_restart: " + json.dumps(doc), flush=True)
    check(builds2 == [], f"warm_restart: life 2 ran a compiler: {builds2}")
    check(ready_doc["checks"].get("rehydrate")
          == f"done {int(doc['rehydrate_items'])}/"
             f"{int(doc['rehydrate_items'])}"
          and doc["rehydrate_items"] > 0,
          f"warm_restart: rehydrate ended as {ready_doc['checks']}")
    # The three CUDA sources and the four C++ ones (on the CPU, the
    # latter alone).
    check(n_exec == (9 if DEVICE == "cuda" else 5)
          and doc["store_loads"] == n_exec
          and doc["store_misses"] == 0 and len(loads) == n_exec
          and doc["executables_loaded"] == n_exec,
          "warm_restart: not every library came from the build store")
    check(doc["repeat_groups"] == 0,
          "warm_restart: a repeat GET dispatched a group")
    # The re-windowed GETs ran the render path's groups (K1, K3, K4a,
    # K4b in the server process, whose launch counts this process cannot
    # read): one tile each.
    check(doc["rewindow_tiles"] == len(rewindowed)
          and doc["rewindow_groups"] >= 1,
          "warm_restart: the re-windowed GETs rendered no group")
    check(doc["rewindow_raw_hits"] >= len(rewindowed)
          and doc["rewindow_reads"] == 0,
          "warm_restart: a re-windowed GET missed the re-staged plane")
    check(all(plain_ok),
          "warm_restart: a re-windowed GET differs from the plain route")
    check(rc2 == 0, f"warm_restart: life 2 exited with {rc2}")
    return doc


async def serve_phase(torch, np, data_dir, lut_root, have_aiohttp,
                      have_pil):
    from omero_ms_image_region_tpu_torch import codecs, native
    from omero_ms_image_region_tpu_torch.io.devicecache import plane_digest
    from omero_ms_image_region_tpu_torch.io.staging import HostPlanes
    from omero_ms_image_region_tpu_torch.ops import jpegenc as J
    from omero_ms_image_region_tpu_torch.ops import render as R
    from omero_ms_image_region_tpu_torch.server.app import build_handler
    from omero_ms_image_region_tpu_torch.server.batcher import (
        BatchingRenderer)
    from omero_ms_image_region_tpu_torch.server.config import AppConfig
    from omero_ms_image_region_tpu_torch.server.ctx import ImageRegionCtx
    from omero_ms_image_region_tpu_torch.utils import telemetry
    from omero_ms_image_region_tpu_torch.utils.stopwatch import REGISTRY

    # The default app: batcher, device raw cache, single-flight and
    # admission on.
    # Without the prefetcher: the cold phases (e2e, digest) count on
    # misses, and a staged neighbour would turn them warm; prefetch: runs
    # the default app with it.
    config = AppConfig(data_dir=data_dir, lut_root=lut_root)
    config.raw_cache.prefetch = False
    handler = build_handler(data_dir, lut_root, device=DEVICE,
                            prefetch=False)
    batcher, cache = handler.s.renderer, handler.s.raw_cache
    check(isinstance(batcher, BatchingRenderer) and cache is not None
          and handler.s.single_flight is not None
          and handler.s.admission is not None
          and handler.s.prefetcher is None,
          "build_handler did not build the default posture (prefetch "
          "off)")
    requests = requests_for(TILE)
    client = Client(config, handler, have_aiohttp)
    await client.start()
    print(f"serve: the default app via {client.via}", flush=True)

    async def get(route, query):
        status, _, body, ms = await client.request(route, query)
        return status, body, ms

    matches_plain = plain_matcher(torch, np, handler, have_pil)

    async def in_flight(reqs, n=8):
        sem = asyncio.Semaphore(n)

        async def limited(r):
            async with sem:
                return await get(*r)
        t0 = time.perf_counter()
        out = await asyncio.gather(*(limited(r) for r in reqs))
        return out, time.perf_counter() - t0

    try:
        # Warm-up (first CUDA context use, library loads, the JPEG
        # route's tables), outside the counted run.
        await get(*requests[0])
        await get(*requests[6])
        reset_launch_counts()
        results = [await get(route, q) for route, q in requests]
        serve_launches = launch_counts()
        print(f"serve: launches in the {len(requests)}-request run: "
              f"{serve_launches}", flush=True)

        device_jpegs = 0
        for (route, query), (status, body, ms) in zip(requests, results):
            check(status == 200, f"{route} {query}: HTTP {status}")
            name, shape, settings, same = await matches_plain(route, query,
                                                              body)
            device_jpegs += name == "device jpeg"
            kernel = ("render_lut" if settings["tables"].ndim == 3
                      else "render_ramp")
            print(f"serve {route} {json.dumps(query)}: status {status} "
                  f"bytes {len(body)} wall_ms {ms:.2f} shape {shape} "
                  f"kernel {kernel} route {name} matches_plain {same}",
                  flush=True)
            check(same, f"{route} {query}: served bytes differ from the "
                        f"plain route")
        for name in ("render_ramp", "render_lut"):
            check(serve_launches[name] >= 1,
                  f"{name} was not launched by the served requests")
        for name in SPARSE_WIRE:
            check(serve_launches[name] >= device_jpegs,
                  f"{name} launched {serve_launches[name]} times for "
                  f"{device_jpegs} device-route JPEG GETs")

        # batch: 8 distinct device-route JPEG GETs at once.  Each is sent
        # once alone first, so the burst is served from the raw cache and
        # reaches the batcher together.
        burst = batch_requests()
        for r in burst:
            await get(*r)
        reset_launch_counts()
        stats = Batches(batcher)
        out, wall = await in_flight(burst)
        launches = launch_counts()
        batch = stats.report()
        for (route, query), (status, body, ms) in zip(burst, out):
            check(status == 200, f"batch {query}: HTTP {status}")
            name, shape, _, same = await matches_plain(route, query, body)
            print(f"batch {json.dumps(query)}: bytes {len(body)} wall_ms "
                  f"{ms:.2f} shape {shape} route {name} matches_plain "
                  f"{same}", flush=True)
            check(name == "device jpeg" and same,
                  f"batch {query}: body differs from the plain route")
        batch.update(wall_ms=wall * 1e3, launches=launches)
        print("batch: " + json.dumps(batch), flush=True)
        check(batch["groups"] < batch["tiles"],
              "batch: no group held 2 or more tiles; the batched path "
              "was not run")
        check(batch["max_groups_in_execute"] <= batcher.device_lanes,
              "batch: more groups in execute than device lanes")
        for name in ("render_ramp", "render_lut", *SPARSE_WIRE):
            check(launches[name] >= 1,
                  f"{name} was not launched by the batch burst")

        # e2e: 4-channel jpeg tiles at resolution 0, default quality,
        # device route, through the batcher, every GET a raw-cache miss.
        tiles = [("render_image_region",
                  {"tile": f"0,{i % 8},{i // 8},{TILE},{TILE}", "c": CH,
                   "m": "c", "format": "jpeg"}) for i in range(64)]
        cache.clear()
        hits0, misses0 = cache.hits, cache.misses
        shed0 = handler.s.admission.shed_total
        stats = Batches(batcher)
        reset_spans(telemetry, REGISTRY)
        reset_launch_counts()
        seq = [(await get(*r))[2] for r in tiles[:16]]
        await settled(batcher)
        seq_spans = span_split(telemetry, REGISTRY)
        seq_groups = stats.report()
        stats = Batches(batcher)
        reset_spans(telemetry, REGISTRY)
        conc, wall = await in_flight(tiles[16:64])
        await settled(batcher)
        conc_spans = span_split(telemetry, REGISTRY)
        check(all(s == 200 for s, _, _ in conc), "timed run: non-200")
        e2e_launches = launch_counts()
        groups = stats.report()
        e2e = {"tile": f"{TILE}x{TILE}x4 uint16 -> jpeg (device route, "
                       f"batcher)",
               "sequential_n": len(seq),
               "sequential_p50_ms": statistics.median(seq),
               "sequential_mean_group_size": seq_groups["mean_group_size"],
               "concurrent_n": len(conc), "in_flight": 8,
               "concurrent_tiles_per_s": len(conc) / wall,
               "concurrent_p50_ms": statistics.median(
                   ms for _, _, ms in conc),
               "mean_group_size": groups["mean_group_size"],
               "group_sizes": groups["group_sizes"],
               "max_groups_in_execute": groups["max_groups_in_execute"],
               "queue_wait_p50_ms": groups["queue_wait_p50_ms"],
               "execute_p50_ms": groups["execute_p50_ms"],
               "sequential_execute_p50_ms": seq_groups["execute_p50_ms"],
               "raw_cache_hits": cache.hits - hits0,
               "raw_cache_misses": cache.misses - misses0,
               "sheds": handler.s.admission.shed_total - shed0,
               "launches": e2e_launches,
               "prefetch": False, "via": client.via}
        print("e2e: " + json.dumps(e2e), flush=True)
        check(e2e_launches["unpack16"] > 0,
              "e2e: the cold misses never launched K10 (unpack16)")
        check(e2e["raw_cache_hits"] == 0,
              "e2e: the cold run had raw-cache hits")
        check(e2e["sheds"] == 0, "e2e: the default app shed a request")

        # spans: the per-request split of the two e2e runs, and the scrape.
        spans = {"sequential": seq_spans, "in_flight_8": conc_spans,
                 "via": client.via}
        print("spans: " + json.dumps(spans), flush=True)
        for label in ("sequential", "in_flight_8"):
            for name in REQUIRED_SPANS:
                check(spans[label]["spans"][name]["samples"] > 0,
                      f"spans: {name} has no sample in the {label} run")
        scrape = await client.metrics()
        check('imageregion_span_count{span="jfif.encodeBatch"}' in scrape
              and "imageregion_requests_total{" in scrape
              and "imageregion_batches_dispatched " in scrape,
              "spans: /metrics lacks the span, request or batcher series")
        print(f"spans: /metrics {len(scrape.splitlines())} lines, "
              f"{scrape.count('# TYPE ')} families, via {client.via}",
              flush=True)

        # raw_cache: the 16 sequential tiles again with another window,
        # each a raw-cache hit.
        hits0, misses0 = cache.hits, cache.misses
        rewindow = [(route, dict(q, c=CH2)) for route, q in tiles[:16]]
        stats = Batches(batcher)
        warm = []
        for r in rewindow:
            status, body, ms = await get(*r)
            check(status == 200, f"raw_cache {r[1]}: HTTP {status}")
            warm.append(ms)
            _, _, _, same = await matches_plain(*r, body)
            check(same, f"raw_cache {r[1]}: body differs from the plain "
                        f"route")
        rc = {"gets": len(rewindow),
              "hits": cache.hits - hits0, "misses": cache.misses - misses0,
              "warm_p50_ms": statistics.median(warm),
              "cold_p50_ms": e2e["sequential_p50_ms"],
              "entries": len(cache), "resident_bytes": cache.size_bytes,
              "bodies_match_plain": True, "batcher": stats.report()}
        print("raw_cache: " + json.dumps(rc), flush=True)
        check(rc["hits"] == len(rewindow) and rc["misses"] == 0,
              "raw_cache: a re-windowed tile missed the raw cache")

        # digest: the same 16 tiles cold again, with the content-digest
        # dedup on; what it costs a cold GET, and how many misses it saved
        # a copy for.
        cache.clear()
        cache.digest_index = True
        plane0 = cache.plane_hits, cache.plane_misses
        try:
            hashed = [(await get(*r))[2] for r in tiles[:16]]
        finally:
            cache.digest_index = False
        plane_hits = cache.plane_hits - plane0[0]
        plane_misses = cache.plane_misses - plane0[1]
        digest = {"gets": len(hashed),
                  "cold_p50_ms_dedup_on": statistics.median(hashed),
                  "cold_p50_ms_dedup_off": e2e["sequential_p50_ms"],
                  "plane_hits": plane_hits, "plane_misses": plane_misses,
                  "copies_saved_share": plane_hits / max(1, plane_hits
                                                         + plane_misses),
                  "prefetch": False}
        print("digest: " + json.dumps(digest), flush=True)

        # postures: 4 burst GETs at once through the batcher's own call on
        # host planes (staged by the group through one pinned buffer on
        # the lane's stream) and through the direct reference handler.
        reqs = burst[2:6]
        ctxs = [ImageRegionCtx.from_params(params_of(*r)) for r in reqs]
        reads = [await handler.read(c) for c in ctxs]
        host_batcher = BatchingRenderer(DEVICE)
        direct = build_handler(data_dir, lut_root, device=DEVICE,
                               batcher=False)
        try:
            host_bodies = await asyncio.gather(*(
                host_batcher.render_jpeg(
                    raw, s, codecs.quality_percent(c.compression_quality),
                    raw.shape[2], raw.shape[1], c.flip_horizontal,
                    c.flip_vertical) for c, (raw, s) in zip(ctxs, reads)))
        finally:
            await host_batcher.close()
        direct_bodies = await asyncio.gather(*(
            direct.render_image_region(c) for c in ctxs))
        postures = {}
        for label, bodies in (("batcher_host_planes", host_bodies),
                              ("direct", direct_bodies)):
            for r, body in zip(reqs, bodies):
                _, _, _, same = await matches_plain(*r, body)
                check(same, f"{label} {r[1]}: body differs from the plain "
                            f"route")
            postures[label] = {"gets": len(reqs), "bodies_match_plain": True}
        postures["batcher_host_planes"]["group_sizes"] = dict(
            host_batcher.group_sizes)
        print("postures: " + json.dumps(postures), flush=True)

        await staging_phase(torch, np, handler, tiles[:16], e2e)
        await stream_phase(client, data_dir, lut_root, have_aiohttp,
                           tiles[:4], seq_spans)
        await http_cache_phase(client, handler, matches_plain)
        workload_launches = await workload_phases(
            torch, np, client, handler, data_dir, lut_root, matches_plain)
        workload_launches["e2e"] = e2e_launches
        workload_launches["readers"] = await readers_phase(
            torch, np, client, handler, data_dir, requests, results)
        workload_launches["pyramid"] = await pyramid_phase(
            torch, np, client, handler, data_dir)
        workload_launches["omero"] = await omero_phase(
            torch, np, client, handler, data_dir, lut_root, have_aiohttp)
        workload_launches["prefetch"] = await prefetch_phase(
            torch, np, data_dir, lut_root, have_aiohttp, matches_plain, e2e,
            tiles)
        workload_launches["huffman"] = await huffman_phase(
            torch, np, client, data_dir, lut_root, have_aiohttp, have_pil,
            e2e, rc, tiles)
        workload_launches["byte_cache"] = await byte_cache_phase(
            data_dir, lut_root, have_aiohttp, rc)
        workload_launches["bitpack"] = await bitpack_phase(
            torch, np, data_dir, lut_root, have_aiohttp, tiles)
        workload_launches["growth"] = await growth_phase(
            data_dir, lut_root, have_aiohttp)
        await access_log_phase(data_dir, lut_root, have_aiohttp)

        # Device busy share: 8 sequential cold GETs, and 32 cold GETs at
        # 8 in flight (torch.profiler, device time of all kernels and
        # copies over the window's wall time).
        from torch.profiler import ProfilerActivity, profile
        busy = {}
        for label, reqs in (("sequential", tiles[16:24]),
                            ("in_flight_8", tiles[24:56])):
            cache.clear()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if label == "sequential":
                    for r in reqs:
                        await get(*r)
                else:
                    await in_flight(reqs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            busy_us = sum(e.self_device_time_total
                          for e in prof.key_averages())
            busy[label] = {"gets": len(reqs), "wall_ms": wall * 1e3,
                           "device_busy_ms": busy_us / 1e3,
                           "busy_share": busy_us / 1e6 / wall}
        print("device_busy: " + json.dumps(busy), flush=True)

        # One tile's layers, medians of 5, on a cold host read.
        ctx = ImageRegionCtx.from_params(params_of(*tiles[9]))
        q = codecs.quality_percent(ctx.compression_quality)
        layers = {k: [] for k in (
            "read_ms", "digest_ms", "pinned_h2d_ms", "h2d_ms",
            "render_kernel_ms", "front_end_ms", "wire_d2h_ms", "wire_bytes",
            "entropy_ms", "rgba_d2h_ms", "pil_encode_ms")}
        for _ in range(5):
            t0 = time.perf_counter()
            raw, settings = await handler.read(ctx)
            t1 = time.perf_counter()
            plane_digest(raw)
            tp = time.perf_counter()
            # The served miss: the DMA out of an already filled pinned
            # buffer (the handler reads straight into it).
            planes = HostPlanes(raw.shape, raw.dtype, DEVICE)
            np.copyto(planes.array, raw)
            tp0 = time.perf_counter()
            planes.upload()
            torch.cuda.synchronize()
            tp1 = time.perf_counter()
            # raw_to_tensor: a host copy into a pinned buffer, then the DMA.
            td = time.perf_counter()
            raw_t = R.raw_to_tensor(raw, DEVICE)[None]
            st = R.batched_settings(R.settings_to_tensors(settings, DEVICE))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            packed = R.render_tile_batch_packed(raw_t, *st)
            ev[1].record()
            _, H, W = packed.shape
            cap = J.default_sparse_cap(H, W, q) * (
                2 if J._CAP_MEMO.get(("sparse", H, W, q)) else 1)
            y, cb, cr = J.packed_to_jpeg_coefficients(packed, q)
            comp = J.compact_sparse_rows(J.sparse_pack(y, cb, cr, cap), 1,
                                         cap, J.blocks_per_tile(H, W))
            ev[2].record()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            row = J.fetch_rows(comp, 1)[0]
            t4 = time.perf_counter()
            native.jpeg_encode_sparse(row, W, H, q, cap)
            t5 = time.perf_counter()
            rgba = R.unpack_rgba(packed[0].cpu().numpy())
            t6 = time.perf_counter()
            codecs.encode_rgba(rgba, "jpeg", None)
            t7 = time.perf_counter()
            for k, v in zip(layers, (
                    (t1 - t0) * 1e3, (tp - t1) * 1e3, (tp1 - tp0) * 1e3,
                    (t2 - td) * 1e3,
                    ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                    (t4 - t3) * 1e3, 4 + len(row), (t5 - t4) * 1e3,
                    (t6 - t5) * 1e3, (t7 - t6) * 1e3)):
                layers[k].append(v)
        print("breakdown: " + json.dumps(
            {k: statistics.median(v) for k, v in layers.items()}),
            flush=True)
        print("digest_rates: " + json.dumps(digest_rates(raw)), flush=True)
        print("encode_overlap: " + json.dumps(
            encode_overlap(np, rgba, row, W, H, q, cap)), flush=True)

        await admission_phase(data_dir, lut_root, have_aiohttp,
                              matches_plain)
        await watchdog_phase(data_dir, lut_root, have_aiohttp,
                             matches_plain)
        smi = smi_line()
        workload_launches["forensics"] = await forensics_phase(
            data_dir, lut_root, have_aiohttp, smi)
        workload_launches["pressure"] = await pressure_phase(
            data_dir, lut_root, have_aiohttp, smi, matches_plain)
        fleet = await fleet_phase(torch, data_dir, lut_root, have_aiohttp,
                                  e2e, matches_plain, smi)
        workload_launches["fleet"] = fleet["launches"]
        return launches, serve_launches, workload_launches, fleet
    finally:
        await client.stop()
        await batcher.close()


# ------------------------------------------------------------ mesh phase

MESH_SOURCE = "omero_ms_image_region_tpu_torch/kernels/csrc/mesh.cu"
MESH_REPLACES = {
    "composite_partial": "omero_ms_image_region_tpu/parallel/mesh.py:227",
    "composite_pack": "omero_ms_image_region_tpu/parallel/mesh.py:271"}
MESH_NOTE = ("no single PyTorch call quantizes and composites a channel "
             "slice, or sums partials in shard order and packs")


def mesh_shards(R, raw, args, chan):
    """K12a over each of ``chan`` channel slices of ``raw`` (the shards of
    one mesh row), then K12b over the stacked partials, and the same by
    the plain versions: (partials, plain partials, packed, plain packed)."""
    C = raw.shape[1]
    per = C // chan
    parts = [R.composite_partial(raw, *args, c0=s * per, c1=(s + 1) * per)
             for s in range(chan)]
    plain = [R.composite_partial_plain(raw, *args, c0=s * per,
                                       c1=(s + 1) * per)
             for s in range(chan)]
    import torch
    stacked = torch.stack(parts)
    return (stacked, torch.stack(plain), R.composite_pack(stacked),
            R.composite_pack_plain(stacked))


def mesh_bound(raw, chan: int, table):
    """K12a's and K12b's least times at chan = ``chan``: bytes (the
    shard's raw channels, settings and tables read once, the f32[3, B, H,
    W] partial written once; the S partials read once, the packed words
    written once) against f32 operations (~17 a pixel-channel; 3 S adds
    and 12 to round, clip and pack a pixel)."""
    B, C, H, W = raw.shape
    px = B * H * W
    cl = C // chan
    part_bytes = (px * cl * raw.element_size() + px * 12 + B * cl * 4 * 5
                  + table.numel() // chan * 4)
    pack_bytes = chan * px * 12 + px * 4
    return (bytes_bound(part_bytes, px * 17 * cl),
            bytes_bound(pack_bytes, px * (3 * chan + 12)))


def mesh_kernel_phase(torch, np):
    """K12a (composite_partial) and K12b (composite_pack) against their
    plain versions: B=8 and B=1 flagship tiles, C=4, 1024^2 u16, the
    channels split as chan 1, 2 and 4; ramp and LUT; a reversed channel
    and the curved families; raw in f32 and u8; C=3 padded to 4 with
    inert channels; a ragged 1000x1020 tile; B=3 padded to 4 (data = 2).
    Returns the two kernels' entries (timed on a chan-2 shard)."""
    from omero_ms_image_region_tpu_torch.flagship import (
        flagship_rdef, synthetic_wsi_tiles)
    from omero_ms_image_region_tpu_torch.models.rendering import Family
    from omero_ms_image_region_tpu_torch.ops import render as R
    from omero_ms_image_region_tpu_torch.ops.lut import LutProvider
    from omero_ms_image_region_tpu_torch.parallel.serve import _pad_group

    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    raw_np = synthetic_wsi_tiles(rng, 8, 4, TILE, TILE)
    raw8 = R.raw_to_tensor(raw_np, dev)
    luts = LutProvider()
    luts.add("smoke.lut", smoke_lut(np))
    lut = flagship_rdef(4)
    lut.channel_bindings[1].lut = "smoke.lut"
    families = flagship_rdef(4)
    for cb, fam, k in zip(families.channel_bindings,
                          (Family.LINEAR, Family.POLYNOMIAL,
                           Family.LOGARITHMIC, Family.EXPONENTIAL),
                          (1.0, 0.7, 1.0, 0.35)):
        cb.family, cb.coefficient = fam, k
    families.channel_bindings[1].reverse_intensity = True
    reverse = flagship_rdef(4)
    reverse.channel_bindings[2].reverse_intensity = True

    def args_for(rdef, B, provider=None):
        s = R.settings_to_tensors(R.pack_settings(rdef, provider), dev)
        return R.batched_settings(s, B)

    entries = {name: {
        "name": name, "route": "cuda", "source": MESH_SOURCE,
        "replaces": MESH_REPLACES[name], "max_abs_err": 0,
        "mismatched_px": 0, "tolerance": 0, "library_ms": None,
        "library_note": MESH_NOTE, "checks": 0}
        for name in ("composite_partial", "composite_pack")}

    def compare(label, raw, args, chan, tol=0):
        """K12a on each of ``chan`` shards and K12b over them, against the
        plain versions: the partials (exact unless ``tol``), K12b against
        its plain version on the same partials (exact), and the kernels'
        bytes against the plain chain's (within ``tol``: a curved family's
        quantize may differ by one step, powf/logf/expf against
        PyTorch's, K1's tolerance)."""
        parts, plain, packed, plain_packed = mesh_shards(R, raw, args,
                                                         chan)
        chain = R.composite_pack_plain(plain)
        torch.cuda.synchronize()
        part_err = float((parts - plain).abs().max())
        pack_err, pack_mism = byte_diff(packed, plain_packed)
        chain_err, chain_mism = byte_diff(packed, chain)
        print(f"check mesh {label} chan={chan} {list(raw.shape)}: partial "
              f"max_abs_diff {part_err}, pack max_abs_diff {pack_err}, "
              f"kernels against the plain chain {chain_err} "
              f"({chain_mism} px; tolerance {tol})", flush=True)
        check((part_err == 0 or tol > 0) and pack_err == 0
              and chain_err <= tol,
              f"mesh {label} chan={chan}: K12 disagrees with its plain "
              f"versions (partial {part_err}, pack {pack_err}, chain "
              f"{chain_err})")
        a, b = entries["composite_partial"], entries["composite_pack"]
        a["max_abs_err"] = max(a["max_abs_err"],
                               part_err if tol == 0 else float(chain_err))
        a["tolerance"] = max(a["tolerance"], tol)
        a["mismatched_px"] += chain_mism
        b["max_abs_err"] = max(b["max_abs_err"], pack_err)
        b["mismatched_px"] += pack_mism
        a["checks"] += 1
        b["checks"] += 1
        if chan == 1 and tol == 0:
            # One shard is K1's composite: its plain version's bytes.
            k1_err, _ = byte_diff(
                packed, R.render_tile_batch_packed_plain(raw, *args))
            check(k1_err == 0, f"mesh {label}: chan 1 differs from K1's "
                               f"plain render by {k1_err}")
        return packed

    for B in (8, 1):
        raw = raw8[:B].contiguous()
        for label, rdef, provider, tol in (
                ("ramp", flagship_rdef(4), None, 0),
                ("lut", lut, luts, 0), ("reverse", reverse, None, 0),
                ("families_reversed", families, None, 1)):
            args = args_for(rdef, B, provider)
            outs = [compare(f"{label} B={B}", raw, args, chan, tol)
                    for chan in (1, 2, 4)]
            if tol == 0:
                # The shard order's sums: every split gives the same bytes
                # on the flagship settings.
                for o in outs[1:]:
                    check(bool(torch.equal(o, outs[0])),
                          f"mesh {label} B={B}: chan splits disagree")
    args = args_for(flagship_rdef(4), 2)
    f32 = (raw8[:2].view(torch.int16).to(torch.int32) & 0xFFFF).to(
        torch.float32)
    compare("raw f32 B=2", f32, args, 2)
    u8 = (raw8[:2].view(torch.int16).to(torch.int32) & 0xFF).to(torch.uint8)
    compare("raw u8 B=2", u8.contiguous(), args, 2)
    # C=3 padded to 4 with inert channels, and B=3 padded to 4 (data=2),
    # as the MeshRenderer pads a group.
    s3 = R.pack_settings(flagship_rdef(3))
    stacked = {k: np.stack([s3[k]] * 3) for k in (
        "window_start", "window_end", "family", "coefficient", "reverse",
        "tables")}
    stacked.update(cd_start=int(s3["cd_start"]), cd_end=int(s3["cd_end"]))
    raw3 = raw_np[:3, :3]
    padded, st = _pad_group(raw3, stacked, 2, 2)
    check(padded.shape == (4, 4, TILE, TILE), "mesh: the group was not "
                                              "padded to (4, 4)")
    pargs = (*(torch.from_numpy(st[k]).to(dev) for k in (
        "window_start", "window_end", "family", "coefficient", "reverse")),
        st["cd_start"], st["cd_end"], torch.from_numpy(st["tables"]).to(dev))
    packed = compare("C=3->4 B=3->4", R.raw_to_tensor(padded, dev), pargs,
                     2)
    unpadded = R.render_tile_batch_packed_plain(
        R.raw_to_tensor(np.ascontiguousarray(raw3), dev),
        *(t[:3, :3] for t in pargs[:5]), st["cd_start"], st["cd_end"],
        pargs[7][:3, :3])
    check(bool(torch.equal(packed[:3], unpadded)),
          "mesh: inert channels changed the composite")
    ragged = R.raw_to_tensor(synthetic_wsi_tiles(rng, 2, 4, 1000, 1020),
                             dev)
    compare("ragged 1000x1020", ragged, args_for(flagship_rdef(4), 2), 2)

    # Times.  K12 serves chan > 1 only (at chan 1 the step runs K1/K2):
    # the headline is a chan-2 shard's K12a and K12b over two shards, at
    # B=8 and B=1; beside them a chan-4 shard and four shards, K12a with
    # the LUT, and chan 1 (the whole channel range, one shard).
    def timed(e, key, fn, plain, bnd, raw):
        e[key + "ms"] = time_ms(torch, fn, 25)
        if plain is not None:
            e[key + "plain_ms"] = time_ms(torch, plain, 5)
        e[key + "bound_ms"], e[key + "bound_by"] = bnd
        e[key + "shape"] = list(raw.shape)

    a_e, b_e = entries["composite_partial"], entries["composite_pack"]
    for B, b1 in ((8, ""), (1, "b1_")):
        raw = raw8[:B].contiguous()
        for kind, args in (("", args_for(flagship_rdef(4), B)),
                           ("lut_", args_for(lut, B, luts))):
            for chan in ((2, 4, 1) if not kind else (2,)):
                per = 4 // chan
                part_bound, pack_bound = mesh_bound(raw, chan, args[-1])
                key = "" if chan == 2 else f"chan{chan}_"
                timed(a_e, kind + b1 + key,
                      lambda: R.composite_partial(raw, *args, c0=0, c1=per),
                      (lambda: R.composite_partial_plain(raw, *args, c0=0,
                                                         c1=per))
                      if chan == 2 else None, part_bound, raw)
                if kind:
                    continue
                parts = torch.stack([R.composite_partial(
                    raw, *args, c0=s * per, c1=(s + 1) * per)
                    for s in range(chan)])
                timed(b_e, b1 + key, lambda: R.composite_pack(parts),
                      (lambda: R.composite_pack_plain(parts))
                      if chan == 2 else None, pack_bound, raw)
    for e in entries.values():
        print(f"kernel {e['name']}: {e['ms']:.4f} ms at B=8 chan 2 (bound "
              f"{e['bound_ms']:.4f} ms by {e['bound_by']}, plain "
              f"{e['plain_ms']:.3f} ms); {e['b1_ms']:.4f} ms at B=1 (bound "
              f"{e['b1_bound_ms']:.4f}); chan 4 {e['chan4_ms']:.4f} / "
              f"{e['b1_chan4_ms']:.4f}, chan 1 {e['chan1_ms']:.4f} / "
              f"{e['b1_chan1_ms']:.4f}", flush=True)
    print(f"kernel composite_partial lut: {a_e['lut_ms']:.4f} ms at B=8 "
          f"chan 2 (bound {a_e['lut_bound_ms']:.4f}), {a_e['lut_b1_ms']:.4f}"
          f" at B=1 (bound {a_e['lut_b1_bound_ms']:.4f})", flush=True)
    return entries


def mesh_config(data_dir, lut_root, engine, joined):
    from omero_ms_image_region_tpu_torch.server.config import AppConfig
    parallel = {"enabled": True}
    if joined:
        parallel.update({"coordinator-address": f"127.0.0.1:{free_port()}",
                         "num-processes": 1, "process-id": 0})
    return AppConfig.from_dict({
        "data-dir": data_dir,
        "omero.server": {"omero.script_repo_root": lut_root},
        "raw-cache": {"prefetch": False},
        "renderer": {"jpeg-engine": engine},
        "parallel": parallel})


async def mesh_serve_phase(torch, np, data_dir, lut_root, have_aiohttp,
                           e2e: dict, smi: str) -> dict:
    """``mesh:`` (b): the mesh app (``parallel: {enabled: true}``) for
    the sparse and the Huffman engines, standalone and joined to a process
    group of one (NCCL and gloo up, the collectives run): the 11 flagship
    GETs, 16 cold JPEG tiles one at a time and again warm, and 16 other
    cold tiles at 8 in flight, each body byte-equal to the default app's
    for the same request.  The one card's mesh is (1, 1): at chan 1 the
    step renders with K1 and K2, so they launch and K12a and K12b do not.
    Returns K1's and K2's launches over the four runs."""
    import torch.distributed as dist
    from omero_ms_image_region_tpu_torch.kernels import jpeg as KJ
    from omero_ms_image_region_tpu_torch.kernels import mesh as KM
    from omero_ms_image_region_tpu_torch.kernels import render as K
    from omero_ms_image_region_tpu_torch.ops import jpegenc as J
    from omero_ms_image_region_tpu_torch.parallel.serve import MeshRenderer
    from omero_ms_image_region_tpu_torch.server.config import AppConfig

    requests = requests_for(TILE)

    def tiles(row):
        return [("render_image_region",
                 {"tile": f"0,{i % 8},{row + i // 8},{TILE},{TILE}",
                  "c": CH, "m": "c", "format": "jpeg"}) for i in range(16)]
    # 16 cold JPEG tiles one at a time (then again, warm: raw-cache hits)
    # and 16 others at 8 in flight, as e2e: runs its tiles.
    seq, burst = tiles(4), tiles(6)
    # The Huffman wire of the mesh codes with the fixed tables (as JAX's
    # mesh): the default app's workload tables are pinned to the fixed
    # ones for the comparison, and restored after.
    saved = dict(J._TUNED_TABLES)
    for edge in (256, 512, 1024, 2048):
        for q in (85, 90):
            J._TUNED_TABLES[(edge, edge, q)] = None
    launches = {"render_ramp": 0, "render_lut": 0}
    doc = {"card": smi, "runs": {}}
    try:
        for engine in ("sparse", "huffman"):
            config = AppConfig.from_dict({
                "data-dir": data_dir,
                "omero.server": {"omero.script_repo_root": lut_root},
                "raw-cache": {"prefetch": False},
                "renderer": {"jpeg-engine": engine}})
            client = Client(config, None, have_aiohttp)
            await client.start()
            try:
                want = [(await client.request(*r))[2]
                        for r in requests + seq + burst]
            finally:
                await client.stop()
            for joined in (False, True):
                label = f"{engine}_{'joined' if joined else 'standalone'}"
                client = Client(mesh_config(data_dir, lut_root, engine,
                                            joined), None, have_aiohttp)
                await client.start()
                try:
                    renderer = client.app_front.services.renderer
                    check(isinstance(renderer, MeshRenderer)
                          and dist.is_initialized() == joined,
                          f"mesh {label}: the app did not build a mesh "
                          f"renderer ({type(renderer).__name__}, joined "
                          f"{dist.is_initialized()})")
                    K.reset_launches()
                    KJ.reset_launches()
                    KM.reset_launches()
                    flagship = [await client.request(*r) for r in requests]
                    cold = [await client.request(*r) for r in seq]
                    warm = [await client.request(*r) for r in seq]
                    stats = Batches(renderer)
                    sem = asyncio.Semaphore(8)

                    async def one(r):
                        async with sem:
                            return await client.request(*r)
                    t0 = time.perf_counter()
                    out = await asyncio.gather(*(one(r) for r in burst))
                    wall = time.perf_counter() - t0
                    groups = stats.report()
                    got = flagship + cold + warm + out
                    statuses = [r[0] for r in got]
                    check(statuses == [200] * len(statuses),
                          f"mesh {label}: not every GET answered 200: "
                          f"{statuses}")
                    n = len(requests)
                    equal = [r[2] == w for r, w in zip(
                        got, want[:n] + want[n:n + 16] * 2 + want[n + 16:])]
                    check(all(equal),
                          f"mesh {label}: bodies differ from the default "
                          f"app's: {equal}")
                    k1 = dict(K.LAUNCHES)
                    k12 = dict(KM.LAUNCHES)
                    wire = {k: KJ.LAUNCHES[k] for k in (
                        "jpeg_coefficients", "sparse_pack", "huffman_pack",
                        "compact_rows")}
                    # At chan 1 the step is K1/K2's render: no partial.
                    check(all(v >= 1 for v in k1.values()),
                          f"mesh {label}: K1/K2 not launched: {k1}")
                    check(sum(k12.values()) == 0,
                          f"mesh {label}: K12 launched at chan 1: {k12}")
                    check(wire["jpeg_coefficients"] >= 1
                          and wire["sparse_pack" if engine == "sparse"
                                   else "huffman_pack"] >= 1,
                          f"mesh {label}: the {engine} wire was not "
                          f"launched: {wire}")
                    for k, v in k1.items():
                        launches[k] += v
                    doc["runs"][label] = {
                        "mesh": renderer.mesh.shape,
                        "device": str(renderer.device),
                        "joined": joined,
                        "backend": (dist.get_backend() if joined else None),
                        "gets": len(got),
                        "bodies_equal_default_app": True,
                        "flagship_p50_ms": statistics.median(
                            ms for *_, ms in flagship),
                        "cold_p50_ms": statistics.median(
                            ms for *_, ms in cold),
                        "warm_p50_ms": statistics.median(
                            ms for *_, ms in warm),
                        "burst_tiles_per_s": len(out) / wall,
                        "burst_p50_ms": statistics.median(
                            ms for *_, ms in out),
                        "burst_mean_group_size": groups["mean_group_size"],
                        "launches": k12, "k1_k2_launches": k1,
                        "wire_launches": wire}
                finally:
                    await client.stop()
                    if dist.is_initialized():
                        dist.destroy_process_group()
    finally:
        J._TUNED_TABLES.clear()
        J._TUNED_TABLES.update(saved)
    doc["e2e_default_app"] = {
        "sequential_p50_ms": e2e["sequential_p50_ms"],
        "concurrent_p50_ms": e2e["concurrent_p50_ms"],
        "concurrent_tiles_per_s": e2e["concurrent_tiles_per_s"],
        "mean_group_size": e2e["mean_group_size"]}
    print("mesh: " + json.dumps(doc), flush=True)
    return launches


def mesh_ranks_inputs(np, tile: int):
    """Eight flagship tiles (``tile``^2, 4 channels, uint16) and two stacked
    per-tile settings of them, windows differing by tile: ramp weights,
    and a LUT on channel 1 (tables [B, C, 256, 3])."""
    from omero_ms_image_region_tpu_torch.flagship import (
        flagship_rdef, synthetic_wsi_tiles)
    from omero_ms_image_region_tpu_torch.ops import render as R
    from omero_ms_image_region_tpu_torch.ops.lut import LutProvider

    B = 8
    raw = synthetic_wsi_tiles(np.random.default_rng(23), B, 4, tile, tile)
    luts = LutProvider()
    luts.add("smoke.lut", smoke_lut(np))
    out = {}
    for label in ("ramp", "lut"):
        settings = []
        for b in range(B):
            rdef = flagship_rdef(4)
            for k, cb in enumerate(rdef.channel_bindings):
                cb.input_start = 100.0 + 150.0 * b + 40.0 * k
                cb.input_end = 30000.0 + 1500.0 * b - 900.0 * k
            if label == "lut":
                rdef.channel_bindings[1].lut = "smoke.lut"
            settings.append(R.pack_settings(rdef, luts))
        stacked = {k: np.stack([s[k] for s in settings]) for k in (
            "window_start", "window_end", "family", "coefficient",
            "reverse", "tables")}
        stacked.update(cd_start=int(settings[0]["cd_start"]),
                       cd_end=int(settings[0]["cd_end"]))
        out[label] = stacked
    return raw, out


def mesh_ranks_worker(rank: int, port: int, queue, device: str,
                      tile: int) -> None:
    """One rank of a (1, 2) mesh on the one card, joined over gloo: the
    mesh step (``render_step_sharded_batched``) on its channel shard of
    ``mesh_ranks_inputs``' group, ramp then LUT, with K12's counts set to
    0 just before and read just after; the rows checked against K1's and
    K2's render of the whole group (after the counts are read)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from omero_ms_image_region_tpu_torch.kernels import mesh as KM
    from omero_ms_image_region_tpu_torch.ops import render as R
    from omero_ms_image_region_tpu_torch.parallel import mesh as M

    out = {"rank": rank}
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", 0)
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                                f"{port}", world_size=2, rank=rank)
        sync = (torch.cuda.synchronize if dev.type == "cuda"
                else (lambda: None))
        mesh = M.make_mesh(2, chan_parallel=2, device=dev)
        raw, inputs = mesh_ranks_inputs(np, tile)
        step = M.render_step_sharded_batched(mesh)
        shards = {label: M.shard_batch_batched(mesh, raw, stacked)
                  for label, stacked in inputs.items()}
        sync()
        KM.reset_launches()
        t0 = time.perf_counter()
        rows = {label: step(*args) for label, args in shards.items()}
        sync()
        out["step_ms"] = (time.perf_counter() - t0) * 1e3
        out["launches"] = dict(KM.LAUNCHES)
        raw_t = R.raw_to_tensor(raw, dev)
        out["equal"] = {}
        for label, stacked in inputs.items():
            args = (*(torch.from_numpy(stacked[k]).to(dev) for k in (
                "window_start", "window_end", "family", "coefficient",
                "reverse")), stacked["cd_start"], stacked["cd_end"],
                torch.from_numpy(stacked["tables"]).to(dev))
            want = R.render_tile_batch_packed(raw_t, *args)
            out["equal"][label] = bool(torch.equal(rows[label], want))
        out.update(shape=mesh.shape, position=list(mesh.position),
                   backend=dist.get_backend(),
                   shard=list(shards["ramp"][0].shape))
    except Exception as exc:   # reported by the parent, which fails
        out["error"] = f"{type(exc).__name__}: {exc}"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        queue.put(out)


def mesh_ranks_phase(smi: str) -> dict:
    """``mesh_ranks:`` the chan > 1 mesh step, K12's path: two processes
    on the one card as the ranks of a (1, 2) mesh over gloo (NCCL refuses
    two ranks on one GPU).  Each rank's rows must equal K1's and K2's,
    and each must launch K12a and K12b.  Returns K12's launches over both
    ranks."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=mesh_ranks_worker,
                         args=(r, port, queue, DEVICE, TILE))
             for r in (0, 1)]
    for p in procs:
        p.start()
    results = []
    try:
        # Each rank puts one result, also when it fails; a rank that dies
        # without one ends the wait.
        deadline = time.monotonic() + 300
        while len(results) < len(procs) and time.monotonic() < deadline:
            try:
                results.append(queue.get(timeout=5))
            except Exception:
                if not all(p.is_alive() for p in procs):
                    break
        results.sort(key=lambda r: r["rank"])
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    check(len(results) == len(procs),
          f"mesh_ranks: {len(results)} of {len(procs)} ranks answered "
          f"(exit codes {[p.exitcode for p in procs]})")
    for r in results:
        check("error" not in r, f"mesh_ranks rank {r['rank']}: "
                                f"{r.get('error')}")
        check(all(r["equal"].values()),
              f"mesh_ranks rank {r['rank']}: rows differ from K1/K2's "
              f"render: {r['equal']}")
        check(all(v >= 1 for v in r["launches"].values()),
              f"mesh_ranks rank {r['rank']}: K12 not launched: "
              f"{r['launches']}")
    print("mesh_ranks: " + json.dumps({"card": smi, "wall_s": wall,
                                       "ranks": results}), flush=True)
    return {name: sum(r["launches"][name] for r in results)
            for name in ("composite_partial", "composite_pack")}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from omero_ms_image_region_tpu_torch import native
    from omero_ms_image_region_tpu_torch.kernels import build
    from omero_ms_image_region_tpu_torch.kernels import jpeg as KJ
    from omero_ms_image_region_tpu_torch.kernels import mesh as KM
    from omero_ms_image_region_tpu_torch.kernels import render as K
    from omero_ms_image_region_tpu_torch.kernels import staging as KS
    from omero_ms_image_region_tpu_torch.kernels import workloads as KW

    # 1. probe
    smi = smi_line()
    have_aiohttp, have_pil = importable("aiohttp"), importable("PIL")
    pil_j2k = None
    if have_pil:
        from PIL import features
        pil_j2k = features.check("jpg_2000")
    print("probe: " + json.dumps({
        "nvidia_smi": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "device": torch.cuda.get_device_name(0),
        "aiohttp": have_aiohttp, "PIL": have_pil,
        "PIL_jpeg2000": pil_j2k}), flush=True)

    # 2. readyz: a fresh app's startup prewarm does the builds (one nvcc
    # per CUDA source, g++ for the codecs) and the first launches behind
    # /readyz; then the build step below finds everything built.  The mesh
    # kernels, which the prewarm does not build (the default app never
    # runs them), build beside it, one more nvcc started at once.
    import concurrent.futures as cf

    mesh_pool = cf.ThreadPoolExecutor(1)
    mesh_built = mesh_pool.submit(build.build_all,
                                  [(KM.SOURCE, KM.NVCC_FLAGS)])
    asyncio.run(readyz_phase(have_aiohttp))
    mesh_built.result()
    mesh_pool.shutdown()

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(2) as pool:
        host = pool.submit(native.build_all)
        build.build_all([(K.SOURCE, K.NVCC_FLAGS),
                         (KJ.SOURCE, KJ.NVCC_FLAGS),
                         (KW.SOURCE, KW.NVCC_FLAGS),
                         (KS.SOURCE, KS.NVCC_FLAGS),
                         (KM.SOURCE, KM.NVCC_FLAGS)])
        host.result()
    K.library()
    KJ.library()
    KW.library()
    KS.library()
    KM.library()
    native.library()
    native.decoder_library()
    native.bitops_library()
    native.jp2k_library()
    native.wirepack_library()
    print(f"build: {time.perf_counter() - t0:.2f} s after the prewarm's "
          f"builds (render.cu, jpeg.cu, workloads.cu, staging.cu; "
          f"native/jpegenc.cpp, jpegdec.cpp, tilecache.cpp, jp2kt1.cpp, "
          f"wirepack.cpp; mesh.cu beside them)", flush=True)
    for source in (K.SOURCE, KJ.SOURCE, KW.SOURCE, KS.SOURCE, KM.SOURCE):
        for line in build.build_log(source.name).splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                print(f"build {source.name}: " + line.strip(), flush=True)

    # 3. kernels against their plain versions
    entries, raw8, args8 = kernel_phase(torch, np)
    entries.update(jpeg_kernel_phase(torch, np, raw8, args8))
    huffman_entries, huffman_rows = huffman_kernel_phase(torch, np, raw8,
                                                         args8)
    entries.update(huffman_entries)
    entries["compact_rows"]["huffman_rows"] = huffman_rows
    entries.update(bitpack_kernel_phase(torch, np, raw8, args8))
    del raw8, args8
    torch.cuda.empty_cache()
    b16 = b16_kernel_phase(torch, np)
    for name, ms in b16["ms"].items():
        entries[name]["b16_ms"] = ms
        entries[name]["b16_exact"] = True
    torch.cuda.empty_cache()
    workload_entries = workloads_kernel_phase(torch, np)
    workload_entries.update(pyramid_kernel_phase(torch, np))
    staging_entries = staging_kernel_phase(torch, np)
    torch.cuda.empty_cache()

    # 4. serve
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        lut_root = os.path.join(tmp, "luts")
        os.makedirs(data_dir)
        os.makedirs(lut_root)
        secs = build_data(np, data_dir, lut_root)
        print(f"serve: built a {PLANE}x{PLANE} 4-channel uint16 pyramid "
              f"(and its level 0 as an OME-TIFF and an NGFF group), a "
              f"{RGB_PLANE}^2 RGB JPEG-in-TIFF, a {TILE}x{TILE}x{Z_STACK} "
              f"4-channel uint16 Z-stack and {len(MASK_SHAPES)} masks in "
              f"{secs:.1f} s", flush=True)
        launches, serve_launches, workload_launches, fleet = asyncio.run(
            serve_phase(torch, np, data_dir, lut_root, have_aiohttp,
                        have_pil))
        sidecar_phase(torch, np, data_dir, lut_root, have_aiohttp, smi)
        fleet_sidecars_phase(data_dir, lut_root, smi, fleet)
        t_auto = time.perf_counter()
        want, workload_launches["autoscale"], rate = asyncio.run(
            autoscale_phase(data_dir, lut_root, have_aiohttp, fleet["e2e"],
                            smi))
        autoscale_units_phase(data_dir, lut_root, have_aiohttp, want, rate,
                              smi)
        print(f"autoscale: phase {time.perf_counter() - t_auto:.1f} s",
              flush=True)
        workload_launches["federation"] = federation_phase(
            data_dir, lut_root, have_aiohttp, want, smi)
        # mesh: K12 against its plain versions, then the mesh app.
        t_mesh = time.perf_counter()
        mesh_entries = mesh_kernel_phase(torch, np)
        torch.cuda.empty_cache()
        mesh_app_launches = asyncio.run(mesh_serve_phase(
            torch, np, data_dir, lut_root, have_aiohttp, fleet["e2e"], smi))
        mesh_launches = mesh_ranks_phase(smi)
        print(f"mesh: phase {time.perf_counter() - t_mesh:.1f} s",
              flush=True)
        warm_restart_phase(torch, np, data_dir, lut_root, have_pil, smi)
    front_cost_phase(smi)

    # launches: the batch burst for K1-K4b; the workload phases together
    # for K7, K8a, K8b and K9 (K9 runs in the pyramid phase).  Every
    # kernel also carries its launches in each workload phase (the
    # readers and pyramid phases included).
    for name, e in entries.items():
        e["launches"] = launches[name]
        e["serve_launches"] = serve_launches[name]
    # K5's path is the Huffman engine's serve (the huffman phase), K6's
    # the direct bitpack app's (the bitpack phase).
    entries["huffman_pack"]["launches"] = workload_launches["huffman"][
        "huffman_pack"]
    check(entries["huffman_pack"]["launches"] >= 1,
          "huffman_pack was not launched by the huffman phase")
    entries["bitpack_fixed"]["launches"] = workload_launches["bitpack"][
        "bitpack_fixed"]
    check(entries["bitpack_fixed"]["launches"] >= 1,
          "bitpack_fixed was not launched by the bitpack phase")
    for name, e in workload_entries.items():
        e["launches"] = sum(p[name] for p in workload_launches.values())
        check(e["launches"] >= 1,
              f"{name} was not launched by the workload phases")
    entries.update(workload_entries)
    # K10's path is the cold misses: the e2e run's (all misses).
    for name, e in staging_entries.items():
        e["launches"] = workload_launches["e2e"][name]
        e["serve_launches"] = serve_launches[name]
        check(e["launches"] >= 1, f"{name} was not launched by the cold "
                                  f"misses of the e2e run")
    entries.update(staging_entries)
    # K12's path is the chan > 1 step (the two ranks of mesh_ranks:); the
    # one card's mesh app (chan 1) runs K1 and K2 instead.
    for name, e in mesh_entries.items():
        e["launches"] = mesh_launches[name]
    entries.update(mesh_entries)
    for name, n in mesh_app_launches.items():
        entries[name]["mesh_app_launches"] = n
    for name, e in entries.items():
        e["workload_launches"] = {phase: p.get(name, 0) for phase, p in
                                  workload_launches.items()}
        e["card"], e["power_limit"] = [s.strip() for s in smi.split(",")]
    check(len(entries) == 14, f"the kernel line lists {len(entries)} "
                              f"kernels, not 14")
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
