"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times   # kernel times only (A/B runs)

Drives the port (``python_audio_mastering_tpu_torch``, never jax) through
its entry points, called without a ``device`` argument (they run on the
card by default), on a seeded 180 s 44.1 kHz stereo track with the bench
settings, multiband off (phases 2-6) and on (phases 7-12), in quality
mode through every single-file and cloud engine (phases 14-17), and on
the bench's 12-track album through the album path, the album engine and
the job worker (phases 18-21), the legacy chain (phases 22-25), the
automaster, the engine's and the CLI's (phases 26-30), sequence
parallelism on one, two and four ranks (phases 31-34), and data
parallelism (the album's tracks and the automaster's batch over ranks)
and the fast profile (phases 35-38), the exact filter path on the scan
kernel and a comp_hop that does not divide the block (phases 39-44), and
the boundary walk K5 on the runs it meets and on four program materials
(phase 45), the chain's tail K9 at the track's and the album's shape
(phase 46), and the quality mode's limiter K10 at the track and on an
album's tracks (phase 47), after
building its CUDA kernels from the sources in the checkout and checking
each against its plain PyTorch version at the shapes the chain gives it.
Phases:

  0  device, torch/CUDA versions, TF32 flags (refuses without a GPU)
  1  build the kernels (nvcc, sm_90a)
  2  front_chain kernel (x @ T in 3xTF32 on wgmma after the exciter, the
     states term in fp32) vs plain (fp32 cuBLAS), (2, 20672, 384),
     emit_mono off and on: max abs <= 1e-4
  3  kweight_cells kernel (x @ T in 3xTF32 on wgmma, the states term in
     fp32) vs plain, (1, 20672, 384), at the chain's h = 6 and at h = 192
     (48 kHz's bucket, which spans three 64-column tiles): max |diff| /
     max |plain| <= 1e-4, and a second launch bitwise the first
  4  master() without a device argument: on the card, finite, |y| <= 1,
     BS.1770 oracle loudness within 0.15 LU of -14, both kernels
     launched and gain_limit once, and within 2e-4 max abs / 1e-3 LU of the port's plain path
     on the CPU
  5  engine.process_audio and master_streamed without a device argument,
     on a temp WAV: both launch the kernels; process_audio equals one-shot
     master() within 2e-4
  6  timings: the chain (CUDA events, warm, median of 5), each kernel
     (its device time under torch.profiler, mean of 10 launches), its
     plain version and, for the product kernels, one torch.matmul of the
     same operands (the yardstick, product only; CUDA events, median of
     5); kweight_cells also at the streamed runner's chunk, (1, 2940, 384)
  7  band_energies kernel (x @ T in 3xTF32 on wgmma, the states term in
     fp32) vs plain,
     (2, 20672, 384), at the chain's hop 8 and at hop 3 (buckets that
     cross the kernel's 64-column tiles): max |diff| / max |plain| <= 1e-4
  8  band_gain_apply kernel (as band_energies) vs plain (fp32
     cuBLAS), emit_mono off and on: max |diff| / max |plain| <= 1e-4
  9  ballistics on the track's own detector targets (3, 992256): K5's two
     launches (hull pass with its stop words, run walk) bitwise equal to
     their plain twins at full T, and the walk's statistics per band
     (collapsed, frozen and live blocks, runs, the longest run and its
     live blocks, the most live blocks of a run); K5 bitwise equal to the
     serial walk pass1_bnd_ref on the first
     65 536 steps (a Python loop of one step per iteration, too slow at
     full T); replay and replay_bnd (every fixed-point round as a
     one-round launch, and all rounds in one launch, ctrl included)
     bitwise equal to their plain versions at full T, and all rounds in
     one launch on a bursty (3, 8388608) timeline, too long for the
     grid's shared memory; at full T the collapse mode, the serial mode
     and the forced fallback (iters=1) bitwise equal; fixed-point rounds
     reported
 10  multiband master(): finite, |y| <= 1, oracle loudness within 0.15 LU
     of -14, every kernel of the path launched (replay_bnd once: the
     whole fixed point is one launch), host synchronisations
     counted (no more than 10), the samples over 2e-4 from the CPU path
     counted, and within 1.2e-3 max abs / 1.3e-5 rms / 1e-3 LU of the
     port's plain path on the CPU (the JAX package's on-chip
     kernels-vs-XLA residual from detector threshold flips)
 11  multiband engine.process_audio (no device argument): equals one-shot
     master() within 2e-4
 12  multiband timings: master(), process_audio, the ballistics in serial
     and collapse mode, each kernel vs its plain version (and the
     yardstick product for the band kernels; the band kernels also at
     the streamed runner's chunk); replay_bnd as one launch
     for the whole fixed point; K5's two launches alone and its latency
     bound (the longest run's live steps, K5_CHAIN_CYCLES each, at the SM
     clock nvidia-smi reads under K5)
 13  where the time goes: torch.profiler over 5 calls of master(),
     multiband on and off: device time per call, the kernels that take
     it, and the share of the wall the device is idle
 14  quality-mode ops on the track made hot (x2) and on a 48 kHz track:
     true_peak_linear (both exclude_pad settings), _peak_env,
     lookahead_limiter and lookahead_limiter_chunk over 30 s chunks and a
     flush, resample 44.1 -> 48 kHz and 48 -> 44.1 kHz, each in float32
     on the card against the port's float64 run on the CPU: <= 5e-5 max
     abs (limiter), <= 1e-5 (resampler), <= 1e-5 of the max (true peak);
     the limiter's sample peak <= the ceiling x (1 + 1e-6) and its true
     peak <= -0.8 dBTP; then everything again with the global
     torch.backends.cudnn.allow_tf32 = True: bitwise the same results
 15  quality master() (no device argument) at -14 and -8 LUFS, multiband
     off and on: finite, sample peak <= the ceiling x (1 + 1e-6), true
     peak <= -0.8 dBTP, oracle loudness printed, every kernel of the path
     launched, the limiter K10 once and its plain twin never, within 2e-4
     max abs (multiband off) or phase 10's limits (on) of the port's CPU
     quality path; an album of the track cut to 180, 97 and 31 s through
     forward_tracks at -8 LUFS: K10 once a track on the chain's strided
     track view, the twin never, each track within 2e-4 of its own quality
     master() and zeros after its end; quality master_streamed equals
     one-shot within 2e-4
 16  engines without a device argument: process_audio with quality and
     output_sample_rate 48000 (a 48 kHz WAV of ceil(N*160/147) frames,
     oracle loudness within 0.1 LU of the 44.1 kHz quality master()'s),
     batch_process_audio over a folder of a 44.1 kHz and a 48 kHz WAV,
     process_audio_from_uri on a local:// store (output blob, .complete
     flag, .meters.json with the target loudness within 1e-2 and the
     written audio's true peak within 0.05 dB)
 17  timings (CUDA events, warm, median of 5): quality vs soft-limiter
     master() with multiband, master_streamed with and without
     return_meters, resample 44.1 -> 48 kHz of 180 s; device time
     (torch.profiler) of the quality master(); host synchronisations per
     quality master() (the limiter alone, K10, is phase 47's)

The album path (``parallel.batch``), on the JAX bench's album: 12 seeded
300 s 44.1 kHz stereo tracks (seeds 10-21, its ``_mk_audio``), the bench
settings with multiband on, the pcm16 wire:

 18  master_album_streamed (no device argument), resident on the card:
     every track finite, |y| <= 1, its own length, oracle loudness within
     0.15 LU of -14; launch counts: K1-K4, K6 and K7 once a chunk for all
     12 tracks together, K5's two launches at most once; tracks 0, 6, 11
     against the port's own master_streamed of the track, pcm16 and
     float32, within 2e-4 (bitwise printed); pcm16 vs float32 < 3e-3; a
     30 s track on the card against the port's CPU path (phase 10's
     limits); K1-K4 against their plain twins at the album chunk's
     shapes, (2, 35280, 384) and K4's (1, 35280, 384), K3 with the
     chunk's own detector gains (phases 2, 3, 7 and 8's limits); K5-K7
     bitwise against their plain twins on the album's own targets (36,
     141184) and on 20 tracks' (60 rows), with the K7 staging each takes
     by its wrapper's rule (shared memory, then device memory)
 19  the same album under a 1 GiB device budget (spills, equal to the
     resident run within 1e-6); checkpointed every 4 chunks, interrupted
     after chunk 6 and resumed: bitwise the uninterrupted run; quality
     mode on tracks 0, 6, 11 at -9 LUFS: each within 2e-4 of its quality
     master(), under the ceiling; tracks 0, 6, 11 with settings of their
     own (two front groups): front_chain launched once per group and
     chunk, each track within 2e-4 / 1e-3 LU of its own master_streamed;
     master_streamed of the 180 s track with
     the pcm16 wire (< 3e-3 from float32) and interrupted and resumed
     (bitwise)
 20  engines without a device argument on a local:// store of 4 WAVs (44.1
     kHz stereo, 48 kHz stereo, mono, 16-bit): process_album_from_uris
     (its decode path printed) and serving.worker.run_job with an album
     and a single payload under the default job_options() (pcm16): blobs,
     .meters.json and .complete flags, no .failed, each output within 2e-4
     of master_streamed of its conformed track
 21  timings with the card's name and power limit: the album's wall and
     realtime factor (median of 3), its timings split for float32 and
     pcm16 (median of 3), torch.profiler of one album chunk's pass A
     (device time, idle share), host synchronisations per chunk and per
     album, and each kernel's device time at the album chunk beside phase
     6 and 12's single-track times

The legacy chain (the monolith service's engine), ``variant="legacy"``
under ``serving.monolith.legacy_config`` (``gpu_default``), on the 180 s
track with the bench settings:

 22  legacy master() (no device argument), multiband off and on: finite,
     |y| <= 1, oracle loudness within 0.15 LU of -14; kweight_cells once,
     with multiband K5's two launches, replay and replay_bnd (once), and
     no front_chain, band_energies or band_gain_apply (the one-shot legacy
     front and split are plain torch); against the port's CPU path within
     2e-4 max abs / 1e-3 LU (multiband off) and phase 10's 1.2e-3 max /
     1.3e-5 rms / 1e-3 LU (on)
 23  front_chain with the legacy exciter (0, 1/g, g) vs plain at
     (2, 20672, 384), phase 2's 1e-4; legacy master_streamed (no device
     argument), multiband off and on: front_chain once a chunk (the
     worker EQ behind the legacy saturation, as the JAX streamed runner
     runs it), no worker band kernel, against the port's CPU streamed run
     within phase 22's limits, and its distance from the one-shot legacy
     master() printed (the reference's quirk); run_legacy_job on a local
     store (no device argument) with a 30 s WAV: processed/ key, "done"
     flag, within 3.052e-5 of master_streamed
 24  the ballistics executions on the track's targets (3, 992256), the
     worker chain's and the legacy chain's (its real mid band): K5's walk
     statistics per band (phase 9's: frozen, live, the longest run's live
     blocks); comp_ballistics "scan" bitwise "auto"; "blocked"
     (2048-step blocks, the 4410-step overlap) on its (1455, 6458)
     windows, padded to 6528, bitwise its plain twins' result on the CPU;
     blocked vs exact printed in dB (max, rms) and linear rms
 25  timings with the card's name and power limit: legacy master()
     multiband off and on (CUDA events, median of 5) and its
     torch.profiler device time and idle share, K5's share of it with
     multiband; the device time of the ballistics in "auto", "scan" and
     "blocked" on both chains' targets

The automaster (``models.automaster``, the system's training path), K1
and K4 under autograd, on the 180 s track with ``gpu_default``:

 26  K1's autograd.Function (the kernel forward, the VJP in plain torch)
     at (2, 20672, 384), emit_mono off and on, every input and slider,
     and K4's at (1, 20672, 384) h = 6, against autograd through their
     plain twins for one seeded upstream gradient: within 1e-5 of each
     gradient's max
 27  the automaster loss and its six-component gradient on the card
     (float32, no device argument) against the port's CPU path in
     float64, at theta = 0 and a seeded theta, the target the profile of
     the track mastered with bass +5 and treble -3: |dloss| <= 1e-5 of
     the loss, |dgrad| <= 2e-6 (theta = 0) and 1e-5 (seeded) of max
     |grad|, no component 0; the control, the chain's EQ operators built
     in float32 as JAX builds them, must exceed the limit at theta = 0
 28  one fit step (forward, backward, Adam): front_chain launched once,
     kweight_cells twice, gain_limit once, no other kernel, and no plain
     twin called
 29  engine.automaster_audio (no device argument) on the 180 s WAV pair,
     40 steps: the loss falls below 0.8 x its start, bass_boost > 0.5,
     treble_boost < 0.5, the output within 0.15 LU of -14 by the BS.1770
     oracle; the fit's wall, one step's time (CUDA events, median of 10),
     its host synchronisations and its torch.profiler breakdown
 30  the port's CLI in a subprocess (no --device) on 10 s WAVs: master
     (within 3.052e-5, one 16-bit step, of engine.process_audio's output)
     and automaster (5 steps) exit 0

Sequence parallelism (``parallel.sequence`` over ``parallel.mesh``), one
process a rank through ``parallel.mesh.launch``, every rank on the card;
the 180 s track grown to a seeded 600 s one, ``gpu_default``, the bench
settings, each run called without a device argument after a warm call:

 31  D = 1 over NCCL: master_track_sharded multiband off, "approx" and
     "exact"
 32  D = 2 over gloo (the ranks share the card): the same three, quality
     mode with multiband off and on and the legacy variant (the row-major
     body) and return_meters
 33  D = 4 over gloo: the same three, and master_album_sharded of 4 seeded
     180 s tracks (multiband, "exact") on a 2 x 2 mesh
     For every run and rank: K1-K7's launches and the plain twins' calls
     (the rows body with multiband launches every kernel on every rank,
     no plain twin; without multiband K1 and K4; the row-major body none),
     the wall (the port's utils.tracing.span, closed after a device
     synchronise; CUDA events on the rank's stream) and the collectives'
     host time (the mesh's collective/* spans inside it); every rank
     returns the same audio.  Rank 0 checks each output against its
     reference on the card: the one-shot master() (multiband off and
     quality < 2e-4 max abs and < 1e-3 LU, quality's sample peak <= the
     ceiling x (1 + 1e-6); "exact" and the album's tracks within phase
     10's limits; "approx" and quality with multiband within the JAX
     package's fast SP budget, rms < 4e-3 and max < 0.1), the streamed legacy chain (the legacy run:
     < 2e-4, the worker EQ behind the legacy saturation, as JAX's SP body
     runs it), master_streamed's meters (the meters run); and the
     oracle within 0.15 LU of -14 (but quality's, printed).  Every rank
     holds what K1-K4 returned on the main path
     against their plain twins on the same operands, on the card (phases
     2, 3, 7 and 8's 1e-4), and every call of the ballistics entry points
     (ballistics_rates_bt: K5-K7; attenuation_blocked_bt: K5/K6 rows, in
     the row-major body with multiband) bitwise against their plain twins
     on the CPU; each multiband run must have held every one it ran.
     Quality with multiband (the row-major body) launches K5 and K6 on
     every rank and stays within the fast SP budget of its one-shot
     master().  The meters run: measured loudness, integrated, series,
     LRA and true peak against master_streamed's within SP_METER_LIMITS,
     each limit's control (the K-filter's shard-incoming state dropped,
     a float32 running sum, the windows across a shard boundary dropped,
     the sample peak for the true peak) required above it.  Rank 0's
     device time, idle share and top activities of the first multiband
     run, under torch.profiler
 34  the walls of every run beside the card's name and power limit: D
     ranks share one card's SMs, so they measure the machinery, not a
     scaling

Data parallelism (``parallel.batch`` and ``models.automaster`` with a
mesh: each rank masters its own tracks), one process a rank through
``parallel.mesh.launch``, every rank on the card, the entry points called
without a mesh or a device argument (``make_mesh()`` over the launched
ranks); 5 seeded 44.1 kHz stereo tracks of 180, 171, 162, 153 and 144 s
(seeds 50-54), ``gpu_default``, the bench settings:

 35  master_album multiband off and on at D = 1 (NCCL), 2 and 4 (gloo,
     the ranks sharing the card; 5 tracks pad to 6 and 8 with silent
     ones): on every rank K1 and K4 (with multiband K1-K7) launched and
     no plain twin, K1-K4's outputs held to their plain twins on that
     rank's operands (phases 2, 3, 7 and 8's 1e-4) and every ballistics
     call bitwise to its plain twins on the CPU; every rank returns the
     same audio; rank 0's tracks against the one-card master_album (no
     mesh, no group) within 2e-4 max and 1e-3 LU (multiband off) or phase
     10's 1.2e-3 max / 1.3e-5 rms / 1e-3 LU (on; the LU by the oracle of
     both outputs), bitwise printed; the oracle within 0.15 LU of -14
 36  master_album_streamed(transfer="pcm16", return_meters=True) at D = 2,
     multiband on: phase 35's checks against the one-card streamed album,
     its measured loudness within 1e-3 LU and its meters within 1e-3;
     on_track_done once a real track, on the rank that mastered it;
     interrupted after each rank's chunk 3 and resumed from the ranks'
     checkpoints: bitwise the uninterrupted run
 37  the automaster's shared theta: 10 Adam steps (lr 0.05) over phase
     26's track (fitted to itself mastered with bass +5 / treble -3 dB)
     and a second seeded 180 s track (seed 55), multiband off, at D = 1
     (both tracks folded into one chain call) and D = 2 (a track a rank,
     the gradient all-reduced): K1 once, K4 twice and K9 once a step on
     every rank, no plain twin; theta bitwise across ranks, D = 2's within
     1e-4 of D = 1's; the loss falls; the step's wall, CUDA-event time and
     the psum's host time
     Every run prints its wall (host, CUDA events), the collectives' host
     time and, for the streamed album, each rank's upload, compute,
     readback and gather legs, beside the card's name and power limit:
     the ranks share one card, so they show the machinery's cost, not a
     scaling
 38  make_master_fn(ChainConfig.gpu_fast(FS)) (no device argument) on the
     180 s track, multiband on: K2 and K3 at hop 16 held to their plain
     twins (1e-4), K5-K7's calls bitwise on the CPU, every kernel
     launched, the output within phase 10's limits of the port's CPU
     path; its time against gpu_default's (CUDA events, median of 5)
     and its device time (torch.profiler over 5 calls)

The exact filter path (``filter_method="scan"``: the JAX package's
row-major body, its filters ``lax.scan``s) on the scan kernel K8
(``ops.sos_scan``, ``csrc/sos_scan.cu``), and a ``comp_hop`` that does
not divide the block:

 39  K8 bitwise its plain version (on the CPU), final states too, on a 2 s
     window at the start of the 180 s track and on one at 90 s entered
     from K8's own state carried there (also bitwise the whole-track
     launch's samples), for each of the scan body's launches: the worker
     EQ (4 sections) on the saturated track, the crossovers' low and high
     pass in one launch and the legacy mid band's 4-section cascade on the
     front's output, the K-weighting on its mono mean
 40  K8 over the whole track in float64 against scipy.signal.sosfilt
     (within 1e-9 of the max) and in float32 (within 1e-3), max abs and
     rms printed; each launch's time at 180 s (CUDA events; the EQ's the
     median of 5) beside the one-thread-a-column design's, its byte bound
     and its latency bound
     (the 180 s column's samples one after another, SCAN_CHAIN_CYCLES
     each, at the SM clock nvidia-smi reads while K8 runs) and its share
     of it; the float32 EQ within SCAN_EQ_MS_MAX; the sweep
     (scan_sweep: k = 1, 2, 3, 4, 8 sections over one 20 s column, ns a
     sample, float32 and float64, the earlier design's beside), float32's
     k = 8
     within SCAN_SWEEP_RATIO_MAX of k = 1; the EQ on the 2 s window,
     kernel and plain version
 41  master() with filter_method="scan" (gpu_default otherwise, no device
     argument), worker multiband off and on, legacy multiband on: finite,
     |y| <= 1, the oracle within 0.15 LU of -14; K8 launched 2, 3 and 6
     times (EQ, crossovers, K-weighting; the legacy EQ's four filters), no
     K1-K4, K5-K7 with multiband, no plain twin; against the blocked
     gpu_default chain on the card: within 1e-3 LU, and, the blocked
     output scaled by the two gains' ratio (the scan's K-weighting has
     JAX's float32 coefficients, the blocked one float64 operators: the
     loudness of the track's mono mean by each is printed), within phase
     10's max and rms for the worker chain and within LEGACY_SCAN_SPREAD,
     the JAX package's own scan-vs-blocked spread, for the legacy one
     (samples over 1e-5 printed: detector threshold flips); multiband on, on a 3 s
     prefix against the port's CPU path (< 2e-4); wall and realtime
     factor, device time, K8's share (every launch of the call timed by
     CUDA events) and the idle share (torch.profiler for the rest)
 42  the scanned master_streamed (30 s chunks, every filter state carried)
     against the one-shot scan (< 2e-4, bitwise printed); phase 35's five
     tracks as one scanned master_album in one process (D = 1): K8 three
     times for all of them, the first and last track within 2e-4 of
     their own scan master(), the oracle within 0.15 LU
 43  master() with comp_hop=5 at block 384 (gpu_default otherwise,
     multiband on): K2 and K3 launched at hop 1 (JAX's pad-and-reshape
     buckets and repeated gains around them) and held to their plain
     twins, K5-K7 bitwise on the CPU, no K8; against the port's CPU path
     within phase 10's limits
 44  five automaster steps under the scan at 180 s (Adam, lr 0.05, phase
     27's target mastered by the scan chain): the step's time (CUDA
     events), K8 seven times a step (forward: EQ, the chain's and the
     loss's K-weighting; backward: the EQ's 8-section adjoint and its
     sections recorded, the two K-weighting adjoints), no K1/K4, no plain
     twin; on a 3 s signal at a seeded theta, the card's float32 loss and
     gradient against the CPU's float64 (the plain version), within 1e-4
     of the loss and 1e-3 of max |grad|

The boundary walk K5 on the runs it meets:

 45  K5 alone (its two launches, CUDA events, queued behind a sleeping
     kernel so the host's issue time stays out) on the worker and the
     legacy chain's targets (3, 992256), bitwise its plain twins at full
     T, and on the legacy mid band (one run of mostly frozen blocks)
     bitwise the serial walk at full T (numpy float32 scalars on the
     CPU): ms, steps walked, the longest chain's steps, ns a step of it,
     the latency bound (K5_CHAIN_CYCLES a step, counted in the SASS by
     scripts/k5_probe.py, at the SM clock read under K5) and its share;
     K5 on the legacy targets within 0.5 ms.  The four program materials
     of scripts/bal_materials.py (bench_raw, pink, pulse, sustained: 180 s
     raw signals into the crossovers, K2 and the detector): the walk's
     statistics per band, K5 bitwise its plain twins, K5 alone on each
     band, the fixed point's rounds and whether it certifies, serial ==
     collapse bitwise, and the device time of ballistics_rates_bt in each
     mode (CUDA events, queued); both modes on both chains' targets too

The chain's tail:

 46  gain_limit (K9: the loudness gain, the soft limiter, the unfold to
     (T, N, C)) on the 180 s track's post-front rows (2, 1, nb·L) with
     its chain's gain, and on the benchmark's album shape, 12 tracks
     padded to 420 s (2, 12, nb·L), seeded rows with gains 0.6-2.2, in
     both variants: bitwise equal to gain_limit_ref; the kernel's time
     (CUDA events, queued as phase 45's), the plain version's (CUDA
     events) and the bound (bytes: every kept frame read and written
     once, the gains read once), which the kernel may not beat by more
     than 5 %

The quality mode's limiter:

 47  lookahead_limit (K10: the 4x true-peak envelope, erosion, float64
     moving average and release, the gain) on the 180 s track made hot
     (x2) and on an album's 12 hot stereo tracks of 150-420 s (the
     benchmark's lengths, stratified), each limited to its own length as
     forward_tracks limits it: lookahead_limiter's route, one launch a
     track, against
     lookahead_limit_ref within 1e-6 max abs and the gain within 2e-6 of
     the twin's; the kernel's time (CUDA events, queued as phase 45's), the
     twin's (CUDA events) and the bound (arithmetic: the FIR's 256 FLOP a
     sample and channel and 12 a frame over 67 TFLOP/s, against 8 bytes a
     sample over 3.35 TB/s), which the kernel may not beat by more than
     5 %

Each kernel's bound is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations over the
peak rate of their type (67 TFLOP/s fp32 on the CUDA cores; 495 TFLOP/s
TF32 on the tensor cores for the three products per multiply-add of K1,
K2, K3 and K4's x @ T, with K4's states term on the fp32 cores; each
product kernel's bound all on the fp32 cores is printed beside it),
H100 SXM data-sheet rates at 700 W, from this run's shapes (and, for K5,
this run's collapsed blocks; for K7, the rounds this run's fixed point
ran).

Exits non-zero at the first failed phase.  The last two lines of output
are the kernel record (each kernel's ``launches`` from phases 4 and 10,
K1-K4's ``design``, K4's ``streamed_chunk_ms`` from phase 6, K3's
``phase10_over_2e4`` (phase 10's samples over 2e-4), ``album_launches`` / ``album_max_abs_err`` / ``album_ms`` from phases
18 and 21, ``legacy_launches`` from phases 22 and 23, and
``automaster_launches`` (one fit step) and, for K1 and K4,
``vjp_rel_err`` from phases 26 and 28, and ``sp_launches``, rank 0's in
phase 32's "approx" run, and for K1-K4 ``sp_max_abs_err``, the largest
distance from the plain twin over every rank of phases 31-33, and
``dp_launches``, rank 0's in phase 35's multiband album at D = 2; K8's
``launches`` from phase 41's worker multiband scan master(), its
``ms``, bound, ``latency_bound_ms`` and ``window_ms`` / ``plain_ms``
from phase 40, its ``max_abs_err`` from phase 39; K5's
``latency_bound_ms`` from phase 12 and ``worker_events_ms`` /
``legacy_events_ms`` with their latency bounds from phase 45; K9's
``launches`` from phase 4 and its times and bounds from phase 46; K10's
launches from phase 15 and its times and bounds from phase 47) and
``{"ok": true, "device": {...}}``.

``--kernel-times`` builds the kernels of the checkout it sits in and
prints, as one JSON line, the device time of K1-K4 at the main path's
shapes, K2-K4 at the streamed chunk, and the fixed point's K7 launches of
one ``_run_collapse`` (their sum and count): run in two checkouts in one
call, it compares two versions on one card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FS = 44100
SECONDS = 180
L = 384
SETTINGS = {"saturation": 20, "preset": "techno", "width": 1.3,
            "lufs": -14.0}
MB_SETTINGS = {**SETTINGS, "multiband": True}
NO_MB_KERNELS = ("front_chain", "kweight_cells")
MB_KERNELS = ("band_energies", "band_gain_apply", "pass1_bnd", "replay",
              "replay_bnd")
K5_LAUNCHES = ("pass1_hull", "pass1_runs")   # K5's two kernels
BALLISTICS = ("pass1_bnd", "replay", "replay_bnd")
# the multiband kernels by the names of their launch counts
MB_COUNTED = ("band_energies", "band_gain_apply", *K5_LAUNCHES, "replay",
              "replay_bnd")
K5_PLAIN_STEPS = 65536
# K5's dependent chain a step, counted in the run walker's SASS
# (scripts/k5_probe.py): the state's add (5 cycles after it), the attack
# clamp (5 after the add), the release clamp written over it under the
# compare's predicate (7 after the first clamp) of ballistics_step
K5_CHAIN_CYCLES = 17
CHUNK_BLOCKS = 2940        # the streamed runner's chunk, 1 128 960 frames
K4_HOPS = (6, 192)         # h at 44.1 kHz (the chain's) and at 48 kHz
K7_LONG_T = 8388608        # steps a band: more than the grid's shared memory
# the benchmark's album (bench_port): 12 tracks padded to 420 s
BENCH_ALBUM_TRACKS, BENCH_ALBUM_SECONDS = 12, 420
# K9's operations a sample: the worker limiter's pointwise steps (abs,
# subtract, divide, square, add, sqrt, divide, add, sign, multiply,
# compare, select), the gain's multiply counted apart
K9_FLOPS = 12
FP32_FLOPS = 67e12    # H100 SXM, fp32 on the CUDA cores, dense
TF32_FLOPS = 495e12   # H100 SXM, TF32 on the tensor cores, dense
HBM_BYTES = 3.35e12   # H100 SXM, HBM3 bytes/s
# multiband card vs CPU path: the JAX package's on-chip kernels-vs-XLA
# residual from detector threshold flips (DESIGN.md:126-129)
MB_MAX, MB_RMS = 1.2e-3, 1.3e-5
# phase 10's host synchronisations: no more than 10 (8 of them operator
# uploads)
MB_MAX_SYNCS = 10
# the band kernels on mma.sync with the states term in 3xTF32, H100 700 W
# (PERF.md, PR 14): phases 7-8's max |diff| / max |plain|, and phase 10's
# samples over 2e-4 from the CPU path
MMA_SYNC_BAND_ERR = "5.9e-6-7.1e-6"
MMA_SYNC_OVER_2E4 = 161
FS48 = 48000
CEILING = 10.0 ** (-1.0 / 20.0)   # the lookahead limiter's -1 dBTP
QUALITY_LUFS = (-14.0, -8.0)
# the JAX bench's album (bench.py, album_12x5min_streamed): 12 x 300 s
ALBUM_SECONDS = 300
ALBUM_SEEDS = tuple(range(10, 22))
ALBUM_KERNELS = ("front_chain", "kweight_cells", "band_energies",
                 "band_gain_apply", "replay", "replay_bnd")
CHECK_TRACKS = (0, 6, 11)  # the first, a middle and the last track
# phase 19's album of CHECK_TRACKS with settings of their own: two front
# groups (tracks 0 and 11 share one), per-track detector and loudness
MIXED_SETTINGS = ({}, {"preset": "pop", "width": 1.0, "lufs": -12.0,
                       "low_thresh": -30.0, "high_ratio": 6.0}, {})
K7_TRACKS = 20            # rows past the grid's shared memory
ALBUM_STOP_AFTER = 6      # phase 19 interrupts the album after this chunk
ALBUM_CKPT_EVERY = 4      # and checkpoints it every this many chunks
ALBUM_BUDGET = 1 << 30    # phase 19's device budget, under the album's need
ENGINE_SECONDS = 30       # phase 20's uploads
# the automaster (phases 26-30): VJPs vs autograd through the plain twins
# (relative to each gradient's max); card float32 vs the CPU's float64 loss
# (relative) and gradient (of its max), set from the H100's readings: loss
# <= 2.4e-6 at both thetas, gradient 2.1e-7 at theta = 0 and 4.7e-6 at the
# seeded theta.  At theta = 0 the control (the EQ operators built in
# float32) reads 1.3e-5, so that limit sits between the two; at the seeded
# theta the float32 forward's residual is the larger (the control reads
# 3.3e-6) and no limit there can see the build.  The engine's steps; the
# CLI's
AM_VJP = 1e-5
AM_LOSS = 1e-5
AM_GRAD = {"theta = 0": 2e-6, "seeded theta": 1e-5}
AM_STEPS = 40
CLI_SECONDS = 10
CLI_STEPS = 5
AUTOMASTER_SLIDERS = ("saturation", "bass_boost", "mid_cut", "presence_boost",
                      "treble_boost", "width")
_PMB = "python_audio_mastering_tpu/ops/pallas_multiband.py"
_PK = "python_audio_mastering_tpu/ops/pallas_kernels.py"
REPLACES = {
    "front_chain": f"{_PMB}:228",
    "kweight_cells": f"{_PMB}:312",
    "band_energies": f"{_PMB}:421",
    "band_gain_apply": f"{_PMB}:477",
    "pass1_bnd": f"{_PK}:152",
    "replay": f"{_PK}:184",
    "replay_bnd": f"{_PK}:217",
    # no pallas_call: the JAX package's exact filter is a lax.scan
    "sos_scan": "python_audio_mastering_tpu/ops/iir.py:67",
    "gain_limit": "none: XLA's fused elementwise",
    "lookahead_limit": "none: XLA's jnp ops of ops/limiter.py",
}
_CSRC = "python_audio_mastering_tpu_torch/csrc"
# the tensor-core kernels' design, in the kernel record
_WGMMA = (f"{_CSRC}/tf32_wgmma.cuh: x @ T in 3xTF32 on wgmma (the signal "
          f"split in registers, a pre-split packed operator by bulk copies, "
          f"the signal by TMA, a warp-specialised ring, a persistent grid), "
          f"the states term in fp32 on epilogue warpgroups")
DESIGNS = {
    "front_chain": {"design": f"{_WGMMA}; one filter, 128-column tiles, "
                              f"the exciter in the consumers' registers"},
    "kweight_cells": {"design": f"{_WGMMA}; one filter, 64-column tiles, "
                                f"items of lcm(h, 64) columns, buckets "
                                f"carried across a span's tiles"},
    "band_energies": {"design": f"{_WGMMA}; two filters, 64 columns each"},
    "band_gain_apply": {"design": f"{_WGMMA}; two filters, 64 columns "
                                  f"each"},
}
SOURCES = {
    "front_chain": f"{_CSRC}/front_chain.cu",
    "kweight_cells": f"{_CSRC}/kweight_cells.cu",
    "band_energies": f"{_CSRC}/band_energies.cu",
    "band_gain_apply": f"{_CSRC}/band_gain_apply.cu",
    "pass1_bnd": f"{_CSRC}/ballistics.cu",
    "replay": f"{_CSRC}/ballistics.cu",
    "replay_bnd": f"{_CSRC}/ballistics.cu",
    "sos_scan": f"{_CSRC}/sos_scan.cu",
    "gain_limit": f"{_CSRC}/gain_limit.cu",
    "lookahead_limit": f"{_CSRC}/lookahead_limit.cu",
}


class PhaseFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise PhaseFailed(what)


def make_signal(n, fs, seed):
    """Tonal mix + noise under a slow envelope (the tests' signal)."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / fs
    base = (0.4 * np.sin(2 * np.pi * 55 * t)
            + 0.25 * np.sin(2 * np.pi * 440 * t + 0.3)
            + 0.15 * np.sin(2 * np.pi * 5200 * t + 1.1)
            + 0.1 * r.standard_normal(n))
    base = base * (0.3 + 0.7 * (0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t)) ** 2)
    out = np.stack([base, np.roll(base, 17) * 0.9
                    + 0.05 * r.standard_normal(n)], axis=1)
    return (out * 0.5).astype(np.float32)


def cuda_ms(fn, reps=10):
    """Device milliseconds per call of ``fn`` over ``reps`` calls."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def median_of(fn, runs=5):
    fn()                                   # warm
    torch.cuda.synchronize()
    return statistics.median(fn() for _ in range(runs))


def count_syncs(fn):
    """Run ``fn`` with PyTorch's sync debug mode on; returns ``(result,
    number of host synchronisations it reported)``."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) for w in caught)


def compare(what, got, ref, limit, relative=True):
    """Print and check ``max |got - ref|`` (over ``max |ref|`` when
    ``relative``) against ``limit``; returns the max abs difference."""
    d = (got - ref).abs()
    mx = d.max().item()
    val = mx / ref.abs().max().item() if relative else mx
    print(f"  {what} {tuple(got.shape)}: max abs {mx:.3e}"
          + (f", / max |plain| {val:.3e}" if relative else ""))
    check(np.isfinite(val) and val <= limit, f"{what}: {val} > {limit}")
    return mx


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops, n_bytes, rate=FP32_FLOPS):
    """The least time the card could take: ``{"bound_ms", "bound_by"}``."""
    t_ops, t_bytes = flops / rate * 1e3, n_bytes / HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def product_bounds(flops, n_bytes, tf32):
    """``(bound, bound on the fp32 cores)`` of a product kernel: the first
    at the 3xTF32 rate (three TF32 products a multiply-add) where
    ``tf32``, else the second."""
    fp32 = bound(flops, n_bytes)
    return (bound(3 * flops, n_bytes, TF32_FLOPS) if tf32 else fp32), fp32


def product_flops(rows, L, S, filters=1):
    """Operations of ``[x | s] @ [T ; Wt]`` per filter, T's zero triangle
    skipped (2 per multiply-add)."""
    return 2.0 * rows * filters * (L * (L + 1) / 2 + S * L)


def kweight_bounds(rows, L, S, n_bytes, filters=1):
    """``(bound, bound on the fp32 cores)`` of K4 (and, with two filters,
    K2 and K3): ``x @ T`` in 3xTF32 on the tensor cores and the states
    term ``s @ Wt`` on the fp32 cores, their times added; the second all
    on the fp32 cores."""
    x_ops = 2.0 * rows * filters * L * (L + 1) / 2
    s_ops = 2.0 * rows * filters * S * L
    t_ops = (3 * x_ops / TF32_FLOPS + s_ops / FP32_FLOPS) * 1e3
    t_bytes = n_bytes / HBM_BYTES * 1e3
    return ({"bound_ms": max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes"},
            bound(x_ops + s_ops, n_bytes))


def detector_targets(xb, params, hop, dev):
    """The multiband detector's per-step targets of the band energies
    ``xb`` (``(3, t)``, or an album's ``(3·T, t)``) as the chain forms
    them, padded to whole 128-step blocks, with the bands' rate factors
    and zero incoming states: ``(m, ca, cr, att0)``."""
    from python_audio_mastering_tpu_torch.ops import ballistics as bal
    from python_audio_mastering_tpu_torch.ops import multiband as mb

    rows, t = xb.shape
    tracks = rows // 3
    stats, _ = mb._fused_stats_from_ctrl(
        xb, t, FS, (params.low_thresh, params.mid_thresh, params.high_thresh),
        (params.low_ratio, params.mid_ratio, params.high_ratio), hop, None,
        mb.detector_lookpad(FS, hop) // hop)
    # whole 128-step blocks (992256 = 7752 blocks at 180 s: no padding)
    m = torch.nn.functional.pad(stats["max_att"], (0, -t % bal.BLOCK))
    ca = torch.tensor([hop / max(a * FS / 1000.0, 1.0)
                       for a, _ in mb.BAND_BALLISTICS_MS
                       for _ in range(tracks)], device=dev)
    cr = torch.tensor([hop / max(r * FS / 1000.0, 1.0)
                       for _, r in mb.BAND_BALLISTICS_MS
                       for _ in range(tracks)], device=dev)
    return m.contiguous(), ca, cr, torch.zeros(rows, device=dev)


def walk_line(st, nblk):
    """One band's :func:`ballistics.walk_stats` as a line of text."""
    return (f"{st['collapsed']} of {nblk} blocks collapsed "
            f"({100.0 * st['collapsed'] / nblk:.1f} %), {st['frozen']} frozen"
            f" (passed over), {st['live']} live (walked); {st['runs']} runs "
            f"of non-collapsed blocks, the longest {st['longest']} blocks, "
            f"{st['longest_live']} of them live; the most live blocks of a "
            f"run {st['chain']} ({st['chain'] * 128} steps walked in a row)")


def k5_latency_ms(steps, clock_mhz):
    """K5's latency bound: ``steps`` dependent steps (the live steps of the
    longest run) of :data:`K5_CHAIN_CYCLES` each at the SM clock."""
    return steps * K5_CHAIN_CYCLES / (clock_mhz * 1e6) * 1e3


def yardstick(a, b):
    """``library_ms``: one torch.matmul of the product's operands."""
    return median_of(lambda: cuda_ms(lambda: torch.matmul(a, b)))


def device_profile(fn, calls, counts=None):
    """``fn`` run ``calls`` times (after a warm call) under torch.profiler
    (CUPTI): ``({device activity name: ms per call}, wall ms per call)``.
    ``counts``, a dict, receives the number of events of each name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / calls)
            if counts is not None:
                counts[e.name] = counts.get(e.name, 0) + 1
    return by_name, wall


# kernel_ms' profiler windows: how many, those that showed no launch of
# a kernel asked for, and (kernel, launches seen, made) where it saw
# fewer than were made (PERF.md, open questions)
WINDOWS = {"profiled": 0, "empty": [], "short": []}


def kernel_ms(fn, name, calls=10):
    """Device time per call of the port's kernels ``pam::<name>_kernel``
    (each name of a tuple) launched by ``fn``: the kernels alone, without
    the wrapper's host work or allocations.  Each kernel's time is the
    mean of the launches the profiler recorded times the launches a call
    makes (its launch counter's count)."""
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb

    names = (name,) if isinstance(name, str) else name
    # the profiler now and then hands back a window with none, or only
    # some, of the launches (an open question): a window with none of a
    # kernel's is printed and profiled again, a short one is counted
    for attempt in range(5):
        before, counts = cmb.launch_counts(), {}
        by_name, _ = device_profile(fn, calls, counts)
        after = cmb.launch_counts()
        WINDOWS["profiled"] += 1
        total, missing = 0.0, []
        for n in names:
            per_call = (after[n] - before[n]) / (calls + 1)  # + the warm call
            hits = [k for k in by_name if f"pam::{n}_kernel" in k]
            seen = sum(counts[k] for k in hits)
            if not seen:
                missing.append(n)
                continue
            if seen != per_call * calls:
                WINDOWS["short"].append((n, seen, int(per_call * calls)))
            total += sum(by_name[k] for k in hits) * calls / seen * per_call
        if not missing:
            return total
        WINDOWS["empty"].append(tuple(missing))
        print(f"  the profiler saw no launch of {missing} (try {attempt + 1}; "
              f"{len(by_name)} device activities: {sorted(by_name)})")
    raise PhaseFailed(f"the profiler saw no launch of {names}")


def profile_calls(fn, calls=5, top=12):
    """Print the device time per call of ``fn``, its wall per call, the
    device's idle share of the wall and the ``top`` device activities;
    returns ``{device activity name: ms per call}``."""
    by_name, wall = device_profile(fn, calls)
    device = sum(by_name.values())
    check(device > 0.0, "the profiler recorded no device time")
    print(f"    device {device:.3f} ms per call, wall {wall:.3f} ms per call "
          f"(profiler on), device idle {100.0 * (1 - device / wall):.1f} % "
          f"of the wall")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {ms:8.4f} ms {100.0 * ms / device:5.1f} %  {name[:90]}")
    return by_name


def check_bitwise(what, got, ref):
    same = torch.equal(got, ref)
    n_diff = int((got != ref).sum()) if got.shape == ref.shape else -1
    print(f"  {what} {tuple(got.shape)}: bitwise equal {same}")
    check(same, f"{what}: not bitwise equal ({n_diff} elements differ)")


def setup_card():
    """Refuse without a GPU; turn TF32 off for torch's own products; print
    and return the card's name and power limit as nvidia-smi gives them."""
    check(torch.cuda.is_available(), "phase 0: torch.cuda.is_available() "
                                     "is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card)
    sys.path.insert(0, ROOT)
    return card


def main_path_operands(dev):
    """The seeded track and what the main path gives its kernels, built as
    the chain builds them: the track ``x``, the chain, its rows, the EQ and
    K-weighting operators and states, K1's and K4's arguments (K4 also at
    the streamed chunk), the multiband compressor's input ``xf`` and the
    band kernels' arguments."""
    from types import SimpleNamespace

    from python_audio_mastering_tpu_torch import (
        ChainConfig,
        MasteringChain,
        MasteringParams,
    )
    from python_audio_mastering_tpu_torch.ops import iir
    from python_audio_mastering_tpu_torch.ops import multiband as mb
    from python_audio_mastering_tpu_torch.ops.waveshaper import saturate

    x = make_signal(SECONDS * FS, FS, seed=0)            # (N, 2)
    nb = -(-x.shape[0] // L)
    params = MasteringParams.from_settings(SETTINGS)
    mb_params = MasteringParams.from_settings(MB_SETTINGS)
    chain = MasteringChain(ChainConfig.gpu_default(FS)).to(dev)
    xrows = torch.nn.functional.pad(torch.from_numpy(x.T.copy()).to(dev),
                                    (0, nb * L - x.shape[0])).reshape(2, nb, L)
    eq = chain.eq_ops(params)
    s_eq, _, _ = iir.sosfilt_states_rows(
        None, saturate(xrows, params.saturation), ops=eq)
    mono = xrows.mean(dim=0, keepdim=True).contiguous()
    kw = chain.kweight_ops()
    s_kw, _, _ = iir.sosfilt_states_rows(None, mono, ops=kw)
    xf = chain.front(xrows, mb_params)
    sos = mb._crossover_sos(FS, 250.0, 4000.0)
    (s_lp, s_hp), _ = iir.sosfilt_states_multi_rows(
        sos, xf, ops_list=chain.crossover_ops())
    return SimpleNamespace(
        x=x, nb=nb, params=params, mb_params=mb_params, chain=chain,
        hop=chain.config.comp_hop, xrows=xrows, eq=eq, s_eq=s_eq, mono=mono,
        kw=kw, s_kw=s_kw,
        k1_args=(xrows, s_eq, eq.t, eq.w, params.saturation, params.width),
        k4_chunk=tuple(v[:, :CHUNK_BLOCKS].contiguous()
                       for v in (mono, s_kw)),
        xf=xf, sos=sos, s_lp=s_lp, s_hp=s_hp,
        band_args=(xf, s_lp, s_hp, *sos))


def kernel_times():
    """``--kernel-times`` (see the module docstring)."""
    setup_card()
    from python_audio_mastering_tpu_torch.ops import ballistics as bal
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb

    o = main_path_operands(torch.device("cuda"))
    kw, h, hop = o.kw, K4_HOPS[0], o.hop
    xb = cmb.band_energies(*o.band_args, hop=hop)
    m, ca, cr, att0 = detector_targets(xb, o.mb_params, hop, xb.device)
    cols = torch.ones((3, xb.shape[1]), device=xb.device)
    chunk = tuple(v[:, :CHUNK_BLOCKS].contiguous() for v in o.band_args[:3])
    times = {
        "front_chain": kernel_ms(lambda: cmb.front_chain(*o.k1_args, True),
                                 "front_chain"),
        "kweight_cells": kernel_ms(lambda: cmb.kweight_cells(
            o.mono, o.s_kw, kw.t, kw.w, h), "kweight_cells"),
        "kweight_cells_chunk": kernel_ms(lambda: cmb.kweight_cells(
            *o.k4_chunk, kw.t, kw.w, h), "kweight_cells"),
        "band_energies": kernel_ms(lambda: cmb.band_energies(
            *o.band_args, hop=hop), "band_energies"),
        "band_gain_apply": kernel_ms(lambda: cmb.band_gain_apply(
            *o.band_args[:3], cols, *o.sos, hop=hop, emit_mono=True),
            "band_gain_apply"),
        "band_energies_chunk": kernel_ms(lambda: cmb.band_energies(
            *chunk, *o.sos, hop=hop), "band_energies"),
        "band_gain_apply_chunk": kernel_ms(lambda: cmb.band_gain_apply(
            *chunk, cols[:, :CHUNK_BLOCKS * (L // hop)].contiguous(),
            *o.sos, hop=hop, emit_mono=True), "band_gain_apply"),
        "replay_bnd_fixed_point": kernel_ms(
            lambda: bal._run_collapse(m, ca, cr, att0), "replay_bnd"),
    }
    cmb.reset_launch_counts()
    _, ctrl = bal._run_collapse(m, ca, cr, att0)
    torch.cuda.synchronize()
    print(json.dumps({"kernel_times_ms": times,
                      "replay_bnd_launches":
                          cmb.launch_counts()["replay_bnd"],
                      "fixed_point_ctrl": ctrl.tolist(), "checkout": ROOT}))
    return 0


def main():
    # phase 0 ---------------------------------------------------------------
    card = setup_card()
    print(f"phase 0 ok: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()} allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} float32_matmul_precision="
          f"{torch.get_float32_matmul_precision()}", flush=True)

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles.bs1770_ref import integrated_loudness as oracle_lufs

    from python_audio_mastering_tpu_torch import (
        MasteringChain,
        engine,
        master,
    )
    from python_audio_mastering_tpu_torch.parallel.streaming import (
        master_streamed,
    )
    from python_audio_mastering_tpu_torch.io import wavio
    from python_audio_mastering_tpu_torch.ops import _kernels
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
    from python_audio_mastering_tpu_torch.ops import loudness as loud

    dev = torch.device("cuda")

    # phase 1 ---------------------------------------------------------------
    t0 = time.perf_counter()
    kl = _kernels.library()
    print(f"phase 1 ok: built {kl.path.name} in {kl.build_seconds:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s)")
    for line in kl.compiler_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    sys.stdout.flush()

    o = main_path_operands(dev)
    x, nb, params, chain = o.x, o.nb, o.params, o.chain
    cfg = chain.config
    xrows, eq, s_eq, k1_args = o.xrows, o.eq, o.s_eq, o.k1_args
    kernels = {}

    # phase 2 ---------------------------------------------------------------
    err = 0.0
    for emit in (False, True):
        got = cmb.front_chain(*k1_args, emit_mono=emit)
        ref = cmb.front_chain_ref(*k1_args, emit_mono=emit)
        torch.cuda.synchronize()
        for what, g, r in zip(("y", "mono"), got if emit else (got,),
                              ref if emit else (ref,)):
            d = (g - r).abs()
            mx, rms = d.max().item(), d.pow(2).mean().sqrt().item()
            print(f"phase 2 front_chain emit_mono={emit} {what} "
                  f"{tuple(g.shape)}: max abs {mx:.3e} rms {rms:.3e}")
            check(np.isfinite(mx) and mx <= 1e-4,
                  f"front_chain max abs {mx} > 1e-4")
            err = max(err, mx)
    kernels["front_chain"] = {"max_abs_err": err}
    print("phase 2 ok", flush=True)

    # phase 3 ---------------------------------------------------------------
    mono, kw, s_kw = o.mono, o.kw, o.s_kw
    h = int(np.gcd(loud._gating_geometry(FS)[0], L))
    check(h == K4_HOPS[0], f"the chain's bucket is {h}, not {K4_HOPS[0]}")
    k4_args = (mono, s_kw, kw.t, kw.w, h)
    err = 0.0
    for hh in K4_HOPS:
        got = cmb.kweight_cells(*k4_args[:4], hh)
        err = max(err, compare(f"phase 3 kweight_cells h={hh}", got,
                               cmb.kweight_cells_ref(*k4_args[:4], hh), 1e-4))
        check_bitwise(f"phase 3 kweight_cells h={hh}, a second launch",
                      cmb.kweight_cells(*k4_args[:4], hh), got)
    kernels["kweight_cells"] = {"max_abs_err": err}
    print("phase 3 ok", flush=True)

    # phase 4 ---------------------------------------------------------------
    cmb.reset_launch_counts()
    res = master(x, params, cfg, return_result=True)   # no device argument
    torch.cuda.synchronize()
    counts = cmb.launch_counts()
    check(res.audio.device.type == "cuda",
          f"master() without a device ran on {res.audio.device}")
    y = res.audio.cpu().numpy()
    check(y.shape == x.shape, f"output shape {y.shape}")
    check(bool(np.isfinite(y).all()), "non-finite output")
    peak = float(np.abs(y).max())
    check(peak <= 1.0, f"|y| max {peak} > 1")
    lufs_out = oracle_lufs(y.astype(np.float64).mean(axis=1), FS)
    print(f"phase 4 master() (no device argument, output on "
          f"{res.audio.device}): shape {y.shape} peak {peak:.4f} measured "
          f"{float(res.measured_lufs):.4f} LUFS gain "
          f"{float(res.applied_gain_db):.4f} dB; oracle output loudness "
          f"{lufs_out:.4f} LUFS; launches {counts}")
    check(abs(lufs_out - SETTINGS["lufs"]) <= 0.15,
          f"output loudness {lufs_out} not within 0.15 LU of -14")
    for name in NO_MB_KERNELS:
        check(counts[name] > 0, f"kernel {name} was not launched by master()")
        kernels[name]["launches"] = counts[name]
    check(counts["gain_limit"] == 1,
          f"master() launched gain_limit {counts['gain_limit']} times")
    kernels["gain_limit"] = {"launches": 1}
    cpu = MasteringChain(cfg)(x, params, return_result=True)
    d_cpu = float(np.abs(y - cpu.audio.numpy()).max())
    d_lufs = abs(float(res.measured_lufs) - float(cpu.measured_lufs))
    print(f"phase 4 card vs CPU plain path: max abs {d_cpu:.3e}, "
          f"|dLUFS| {d_lufs:.3e}")
    check(d_cpu < 2e-4, f"card vs CPU max abs {d_cpu} >= 2e-4")
    check(d_lufs < 1e-3, f"card vs CPU |dLUFS| {d_lufs} >= 1e-3")
    print("phase 4 ok", flush=True)

    # phase 5 ---------------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.wav"), os.path.join(tmp, "out.wav")
        wavio.write_wav(src, x, FS, float_format=True)
        msgs = []
        job = {**SETTINGS, "input_file": src, "output_file": dst}
        cmb.reset_launch_counts()
        ok = engine.process_audio(job, msgs.append)   # no device argument
        check(ok, f"process_audio failed: {msgs[-1] if msgs else ''}")
        streamed_counts = cmb.launch_counts()
        out, fs_out = wavio.read_wav(dst)
        d_eng = float(np.abs(out - y).max())
        print(f"phase 5 process_audio (no device argument): {msgs[-1]!r}; "
              f"launches {streamed_counts}; max abs vs master() "
              f"{d_eng:.3e}")
        check(fs_out == FS and out.shape == x.shape, "process_audio output")
        check(all(streamed_counts[k] > 0 for k in NO_MB_KERNELS),
              "process_audio did not launch every kernel")
        check(d_eng < 2e-4, f"process_audio vs master() {d_eng} >= 2e-4")
        cmb.reset_launch_counts()
        out_s, _, _ = master_streamed(x, params, cfg)   # no device argument
        counts_s = cmb.launch_counts()
        d_str = float(np.abs(out_s - y).max())
        print(f"phase 5 master_streamed (no device argument): launches "
              f"{counts_s}; max abs vs master() {d_str:.3e}")
        check(all(counts_s[k] > 0 for k in NO_MB_KERNELS),
              "master_streamed without a device did not run on the card")
        check(d_str < 2e-4, f"master_streamed vs master() {d_str} >= 2e-4")
        print("phase 5 ok", flush=True)

        # phase 6 -----------------------------------------------------------
        x_dev = torch.from_numpy(x).to(dev)

        def master_ms():
            return cuda_ms(lambda: chain(x_dev, params), reps=1)

        def engine_s():
            t0 = time.perf_counter()
            engine.process_audio(job)
            return time.perf_counter() - t0

        t_master = median_of(master_ms)
        t_engine = median_of(engine_s)
        print(f"phase 6 master() {t_master:.3f} ms for {SECONDS} s "
              f"(x{SECONDS * 1e3 / t_master:.0f} realtime, input on the "
              f"card); process_audio wall {t_engine:.3f} s (WAV read, "
              f"upload, chain, readback, WAV write)")
    s_k1, s_k4 = s_eq.shape[2], s_kw.shape[2]
    shapes = {
        "front_chain": (
            cmb.front_chain, cmb.front_chain_ref, k1_args + (True,),
            (xrows, s_eq, eq.t, eq.w.T.contiguous()),
            product_bounds(product_flops(2 * nb, L, s_k1),
                           nbytes(xrows, s_eq, eq.t, eq.w) + nbytes(xrows)
                           + 4 * nb * L, tf32=True)),
        "kweight_cells": (
            cmb.kweight_cells, cmb.kweight_cells_ref, k4_args,
            (mono, s_kw, kw.t, kw.w.T.contiguous()),
            kweight_bounds(nb, L, s_k4, nbytes(mono, s_kw, kw.t, kw.w)
                           + 4 * nb * (L // h)))}
    for name, (kern, plain, args, (rows, st, t_op, wt), (bnd_, fp32_)) in \
            shapes.items():
        ms = kernel_ms(lambda: kern(*args), name)
        plain_ms = median_of(lambda: cuda_ms(lambda: plain(*args)))
        lib_ms = yardstick(
            torch.cat([rows.reshape(-1, L), st.reshape(-1, st.shape[2])], 1),
            torch.cat([t_op, wt], 0))
        kernels[name].update(ms=ms, plain_ms=plain_ms, **bnd_,
                             library_ms=lib_ms)
        print(f"phase 6 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library (torch.matmul, product only) {lib_ms:.4f} ms, bound "
              f"{bnd_['bound_ms']:.4f} ms ({bnd_['bound_by']}; on the fp32 "
              f"cores {fp32_['bound_ms']:.4f} ms)")
    chunk = o.k4_chunk
    k4_chunk = kernel_ms(lambda: cmb.kweight_cells(*chunk, kw.t, kw.w, h),
                         "kweight_cells")
    c_bnd, _ = kweight_bounds(CHUNK_BLOCKS, L, s_k4,
                              nbytes(*chunk, kw.t, kw.w)
                              + 4 * CHUNK_BLOCKS * (L // h))
    kernels["kweight_cells"].update(streamed_chunk_ms=k4_chunk,
                                    streamed_chunk_bound_ms=c_bnd["bound_ms"])
    print(f"phase 6 kweight_cells at the streamed chunk {tuple(chunk[0].shape)}"
          f": kernel {k4_chunk:.4f} ms, bound {c_bnd['bound_ms']:.4f} ms "
          f"({c_bnd['bound_by']})")
    print("phase 6 ok", flush=True)

    multiband_phases(o, kernels)
    quality_phases(o, kernels, card)
    album_phases(o, kernels, card)
    legacy_phases(o, kernels, card)
    automaster_phases(o, kernels, card)
    sp_phases(kernels, card)
    dp_phases(kernels, card)
    fast_phase(o, kernels, card)
    scan_phases(o, kernels, card)
    k5_phase(o, kernels, card)
    gain_limit_phase(o, kernels, card)
    lookahead_limit_phase(o, kernels, card)

    record = [{"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], **DESIGNS.get(name, {}),
               **kernels[name]}
              for name in NO_MB_KERNELS + MB_KERNELS
              + ("sos_scan", "gain_limit", "lookahead_limit")]
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def multiband_phases(o, kernels):
    """Phases 7-13: the multiband chain on the same track (``o`` from
    :func:`main_path_operands`)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles.bs1770_ref import integrated_loudness as oracle_lufs

    from python_audio_mastering_tpu_torch import MasteringChain, MasteringParams
    from python_audio_mastering_tpu_torch import engine
    from python_audio_mastering_tpu_torch.io import wavio
    from python_audio_mastering_tpu_torch.ops import ballistics as bal
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb

    x, chain, params, hop, nb = o.x, o.chain, o.mb_params, o.hop, o.nb
    cfg = chain.config
    dev = o.xrows.device
    xf, sos, s_lp, s_hp = o.xf, o.sos, o.s_lp, o.s_hp
    band_args = o.band_args
    for name in MB_KERNELS:
        kernels[name] = {}

    # phase 7 ---------------------------------------------------------------
    # the chain's hop, then hop 3, whose buckets cross the 64-column tiles
    err, rel = 0.0, 0.0
    for h in (hop, 3):
        got = cmb.band_energies(*band_args, hop=h)
        ref = cmb.band_energies_ref(*band_args, hop=h)
        d = compare(f"phase 7 band_energies hop={h}", got, ref, 1e-4)
        err, rel = max(err, d), max(rel, d / ref.abs().max().item())
        if h == hop:
            xb = got
    kernels["band_energies"]["max_abs_err"] = err
    print(f"phase 7 band_energies max |diff| / max |plain| {rel:.3e} "
          f"(the mma.sync kernel with the states term in 3xTF32: "
          f"{MMA_SYNC_BAND_ERR})")
    print("phase 7 ok", flush=True)

    # the track's own detector targets and the gain columns
    t = xb.shape[1]
    m, ca, cr, att0 = detector_targets(xb, params, hop, dev)
    att, _ = bal.ballistics_rates_bt(m, ca, cr, att0)
    g = 10.0 ** (-att[:, :t] / 20.0)
    cols = torch.stack([g[1], g[0] - g[1], g[2] - g[1]]).contiguous()

    # phase 8 ---------------------------------------------------------------
    err, rel = 0.0, 0.0
    for emit in (False, True):
        got = cmb.band_gain_apply(*band_args[:3], cols, *sos, hop=hop,
                                  emit_mono=emit)
        ref = cmb.band_gain_apply_ref(*band_args[:3], cols, *sos, hop=hop,
                                      emit_mono=emit)
        for what, gg, rr in zip(("y", "mono"), got if emit else (got,),
                                ref if emit else (ref,)):
            d = compare(f"phase 8 band_gain_apply emit_mono={emit} {what}",
                        gg, rr, 1e-4)
            err, rel = max(err, d), max(rel, d / rr.abs().max().item())
    kernels["band_gain_apply"]["max_abs_err"] = err
    print(f"phase 8 band_gain_apply max |diff| / max |plain| {rel:.3e} "
          f"(the mma.sync kernel with the states term in 3xTF32: "
          f"{MMA_SYNC_BAND_ERR})")
    print("phase 8 ok", flush=True)

    # phase 9 ---------------------------------------------------------------
    print(f"phase 9 targets {tuple(m.shape)}: {int((m > 0).sum())} steps "
          f"above threshold")
    hmax = torch.maximum(att0, m.amax(dim=1)).contiguous()
    hull = bal.pass1_hull(m, ca, cr, hmax)
    hull_p = bal.pass1_hull_ref(m, ca, cr, hmax)
    for what, got, ref in zip(("lo", "hi", "stops"), hull, hull_p):
        check_bitwise(f"phase 9 K5 pass1_hull {what}", got, ref)
    check_bitwise("phase 9 K5 pass1_runs",
                  bal.pass1_runs(m, ca, cr, att0, *hull),
                  bal.pass1_runs_ref(m, ca, cr, att0, *hull))
    nblk = hull[0].shape[1]
    hull_stats = bal.walk_stats(*hull)
    for band, st in zip(("low", "mid", "high"), hull_stats):
        print(f"phase 9 K5 hull, {band} band: {walk_line(st, nblk)}")
    walked = sum(st["live"] for st in hull_stats)
    chain_steps = bal.BLOCK * max(st["chain"] for st in hull_stats)
    bnd = bal.pass1_bnd(m, ca, cr, att0)
    check_bitwise("phase 9 K5 pass1_bnd vs its plain twin (full T)", bnd,
                  bal.pass1_runs_ref(m, ca, cr, att0, *hull_p))
    cut = m[:, :K5_PLAIN_STEPS].contiguous()
    check_bitwise(f"phase 9 K5 pass1_bnd vs the serial walk pass1_bnd_ref "
                  f"(first {K5_PLAIN_STEPS} steps)",
                  bal.pass1_bnd(cut, ca, cr, att0),
                  bal.pass1_bnd_ref(cut, ca, cr, att0))
    kernels["pass1_bnd"]["max_abs_err"] = 0.0
    incomes = torch.cat([att0[:, None], bnd[:, :-1]], dim=1).contiguous()
    check_bitwise("phase 9 replay", bal.replay(m, ca, cr, incomes),
                  bal.replay_ref(m, ca, cr, incomes))
    kernels["replay"]["max_abs_err"] = 0.0
    idx = bal._frozen_index(m)
    s = torch.zeros_like(bnd)
    ck, cp = bal.new_ctrl(dev), bal.new_ctrl(dev)
    for k in range(bal.FIXPOINT_ITERS):
        s_k = bal.replay_bnd(m, ca, cr, att0, idx, s, ck)
        s_p = bal.replay_bnd_ref(m, ca, cr, att0, idx, s, cp)
        check_bitwise(f"phase 9 replay_bnd round {k + 1}", s_k, s_p)
        check(torch.equal(ck, cp), f"replay_bnd ctrl {ck.tolist()} != "
                                   f"plain {cp.tolist()}")
        s = s_k
    # every round in one launch, against the plain loop of one-round calls:
    # the track's targets (held in the grid's shared memory), then a
    # bursty timeline of 3 x 65 536 blocks, more than the ~59 000 blocks
    # that the H100's shared memory holds, whose rounds read m from device
    # memory
    gen = torch.Generator(device=dev).manual_seed(5)
    m_long = (torch.rand((3, K7_LONG_T), generator=gen, device=dev) * 12.0
              * (torch.rand(K7_LONG_T, generator=gen, device=dev) < 0.5))
    m_long[:, K7_LONG_T // 3: K7_LONG_T // 2] = 0.0   # read through
    for what, mm in (("the track's targets", m), ("a long timeline", m_long)):
        idx_m = bal._frozen_index(mm)
        s0 = torch.zeros((3, mm.shape[1] // bal.BLOCK), device=dev)
        ck, cp = bal.new_ctrl(dev), bal.new_ctrl(dev)
        check_bitwise(f"phase 9 replay_bnd, {bal.FIXPOINT_ITERS} rounds in one "
                      f"launch, {what}",
                      bal.replay_bnd(mm, ca, cr, att0, idx_m, s0, ck,
                                     rounds=bal.FIXPOINT_ITERS),
                      bal.replay_bnd_ref(mm, ca, cr, att0, idx_m, s0, cp,
                                         rounds=bal.FIXPOINT_ITERS))
        check(torch.equal(ck, cp), f"replay_bnd ctrl {ck.tolist()} != "
                                   f"plain {cp.tolist()}")
        print(f"phase 9 replay_bnd, {what}: ctrl {ck.tolist()}")
    del m_long
    kernels["replay_bnd"]["max_abs_err"] = 0.0
    collapse, ctrl = bal._run_collapse(m, ca, cr, att0)
    rounds, certified = int(ctrl[bal.ROUND]), int(ctrl[bal.CNT]) == 0
    print(f"phase 9 fixed point: {rounds} rounds, certified {certified} "
          f"(ctrl {ctrl.tolist()})")
    check_bitwise("phase 9 serial == collapse", bal._run(m, ca, cr, att0),
                  collapse)
    forced, fctrl = bal._run_collapse(m, ca, cr, att0, iters=1)
    check_bitwise(f"phase 9 forced fallback (iters=1, certified "
                  f"{int(fctrl[bal.CNT]) == 0}) == collapse", forced,
                  collapse)
    print("phase 9 ok", flush=True)

    # phase 10 --------------------------------------------------------------
    x_dev = torch.from_numpy(x).to(dev)
    chain(x_dev, params)                       # first call builds operators
    cmb.reset_launch_counts()
    res, syncs = count_syncs(lambda: chain(x_dev, params, return_result=True))
    counts = cmb.launch_counts()
    y = res.audio.cpu().numpy()
    check(y.shape == x.shape, f"output shape {y.shape}")
    check(bool(np.isfinite(y).all()), "non-finite output")
    peak = float(np.abs(y).max())
    check(peak <= 1.0, f"|y| max {peak} > 1")
    lufs_out = oracle_lufs(y.astype(np.float64).mean(axis=1), FS)
    print(f"phase 10 multiband master(): shape {y.shape} peak {peak:.4f} "
          f"measured {float(res.measured_lufs):.4f} LUFS gain "
          f"{float(res.applied_gain_db):.4f} dB; oracle output loudness "
          f"{lufs_out:.4f} LUFS; launches {counts}; host synchronisations "
          f"{syncs}")
    check(abs(lufs_out - SETTINGS["lufs"]) <= 0.15,
          f"output loudness {lufs_out} not within 0.15 LU of -14")
    for name in NO_MB_KERNELS + MB_COUNTED:
        check(counts[name] > 0, f"kernel {name} was not launched by the "
                                f"multiband master()")
    check(counts["replay_bnd"] == 1, f"replay_bnd launched "
                                     f"{counts['replay_bnd']} times, not once")
    launched = {**counts, "pass1_bnd": sum(counts[k] for k in K5_LAUNCHES)}
    for name in MB_KERNELS:
        kernels[name]["launches"] = launched[name]
    kernels["pass1_bnd"]["launches_by_kernel"] = {k: counts[k]
                                                  for k in K5_LAUNCHES}
    t0 = time.perf_counter()
    cpu = MasteringChain(cfg)(x, params, return_result=True)
    d = np.abs(y - cpu.audio.numpy())
    d_max, d_rms = float(d.max()), float(np.sqrt(np.mean(d ** 2)))
    d_lufs = abs(float(res.measured_lufs) - float(cpu.measured_lufs))
    print(f"phase 10 card vs CPU plain path ({time.perf_counter() - t0:.1f} s"
          f" on the CPU): max abs {d_max:.3e}, rms {d_rms:.3e}, |dLUFS| "
          f"{d_lufs:.3e}; elements over 2e-4: {int((d > 2e-4).sum())} (the "
          f"band kernels on mma.sync: {MMA_SYNC_OVER_2E4})")
    kernels["band_gain_apply"]["phase10_over_2e4"] = int((d > 2e-4).sum())
    check(syncs <= MB_MAX_SYNCS, f"{syncs} host synchronisations in the "
                                 f"multiband master(), over {MB_MAX_SYNCS}")
    check(d_max < MB_MAX, f"card vs CPU max abs {d_max} >= {MB_MAX}")
    check(d_rms < MB_RMS, f"card vs CPU rms {d_rms} >= {MB_RMS}")
    check(d_lufs < 1e-3, f"card vs CPU |dLUFS| {d_lufs} >= 1e-3")
    print("phase 10 ok", flush=True)

    # phase 11 --------------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.wav"), os.path.join(tmp, "out.wav")
        wavio.write_wav(src, x, FS, float_format=True)
        msgs = []
        job = {**MB_SETTINGS, "input_file": src, "output_file": dst}
        cmb.reset_launch_counts()
        ok = engine.process_audio(job, msgs.append)   # no device argument
        check(ok, f"process_audio failed: {msgs[-1] if msgs else ''}")
        streamed_counts = cmb.launch_counts()
        out, fs_out = wavio.read_wav(dst)
        d_eng = float(np.abs(out - y).max())
        print(f"phase 11 multiband process_audio (no device argument): "
              f"{msgs[-1]!r}; launches {streamed_counts}; max abs vs "
              f"master() {d_eng:.3e}")
        check(fs_out == FS and out.shape == x.shape, "process_audio output")
        check(all(streamed_counts[k] > 0 for k in NO_MB_KERNELS + MB_COUNTED),
              "process_audio did not launch every kernel")
        check(d_eng < 2e-4, f"process_audio vs master() {d_eng} >= 2e-4")
        print("phase 11 ok", flush=True)

        # phase 12 ----------------------------------------------------------
        def engine_s():
            t0 = time.perf_counter()
            engine.process_audio(job)
            return time.perf_counter() - t0

        t_master = median_of(lambda: cuda_ms(lambda: chain(x_dev, params),
                                             reps=1))
        t_engine = median_of(engine_s)
    print(f"phase 12 multiband master() {t_master:.3f} ms for {SECONDS} s "
          f"(x{SECONDS * 1e3 / t_master:.0f} realtime, input on the card); "
          f"process_audio wall {t_engine:.3f} s; fixed point {rounds} "
          f"rounds, {syncs} host synchronisations per master()")
    for mode in ("serial", "collapse", "serial", "collapse"):
        t_mode = median_of(lambda: cuda_ms(
            lambda: bal.ballistics_rates_bt(m, ca, cr, att0, mode=mode)))
        print(f"phase 12 ballistics_rates_bt mode={mode} at full T: "
              f"{t_mode:.4f} ms")
    ctrl0 = bal.new_ctrl(dev)
    zero = torch.zeros_like(bnd)
    xrows_b, s_lp_b, s_hp_b = (v.reshape(-1, v.shape[2])
                               for v in band_args[:3])
    t2, wt2 = cmb.crossover_operands(*sos, L, dev)
    zeros = torch.zeros_like(wt2[0])
    band_a = torch.cat([xrows_b, s_lp_b, s_hp_b], 1)
    band_b = torch.cat([torch.cat([t2[0], t2[1]], 1),
                        torch.cat([wt2[0], zeros], 1),
                        torch.cat([zeros, wt2[1]], 1)], 0)
    s_x = s_lp.shape[2]
    rows_b = xrows_b.shape[0]
    band_in = nbytes(xf, s_lp, s_hp, t2, wt2)
    b_, t_ = m.shape
    step_flops = 4.0 * b_ * t_
    # K2 and K3: x @ T at the 3xTF32 rate (three TF32 products a
    # multiply-add), the states term at the fp32 rate, as K4's
    k2_bnd, k2_fp32 = kweight_bounds(rows_b, L, s_x, band_in + nbytes(xb),
                                     filters=2)
    k3_bnd, k3_fp32 = kweight_bounds(rows_b, L, s_x, band_in
                                     + nbytes(cols, xf) + 4 * nb * L,
                                     filters=2)
    fp32_bound = {"band_energies": k2_fp32, "band_gain_apply": k3_fp32}
    timed = {
        "band_energies": (
            lambda: cmb.band_energies(*band_args, hop=hop),
            lambda: cmb.band_energies_ref(*band_args, hop=hop),
            k2_bnd, True),
        "band_gain_apply": (
            lambda: cmb.band_gain_apply(*band_args[:3], cols, *sos, hop=hop,
                                        emit_mono=True),
            lambda: cmb.band_gain_apply_ref(*band_args[:3], cols, *sos,
                                            hop=hop, emit_mono=True),
            k3_bnd, True),
        # K5's two launches; operations: two steps per step of the hull
        # pass, one per step of the live blocks walked
        "pass1_bnd": (
            lambda: bal.pass1_runs(m, ca, cr, att0,
                                   *bal.pass1_hull(m, ca, cr, hmax)),
            lambda: bal.pass1_runs_ref(m, ca, cr, att0,
                                       *bal.pass1_hull_ref(m, ca, cr, hmax)),
            bound(2 * step_flops + 4.0 * walked * bal.BLOCK,
                  nbytes(m, ca, cr, att0, bnd)), False),
        "replay": (
            lambda: bal.replay(m, ca, cr, incomes),
            lambda: bal.replay_ref(m, ca, cr, incomes),
            bound(step_flops, nbytes(m, ca, cr, incomes, m)), False),
        # the whole fixed point, one launch from a fresh (active) ctrl;
        # bytes: m read once, and each round run reads a block's income
        # index and state and writes its state (16 bytes)
        "replay_bnd": (
            lambda: bal.replay_bnd(m, ca, cr, att0, idx, zero, ctrl0.clone(),
                                   rounds=bal.FIXPOINT_ITERS),
            lambda: bal.replay_bnd_ref(m, ca, cr, att0, idx, zero,
                                       ctrl0.clone(),
                                       rounds=bal.FIXPOINT_ITERS),
            bound(step_flops * rounds, nbytes(m, ca, cr, att0, ctrl0)
                  + 16 * rounds * zero.numel()), False),
    }
    for name, (kern, plain, bnd_, product) in timed.items():
        ms = kernel_ms(kern, K5_LAUNCHES if name == "pass1_bnd" else name)
        plain_ms = median_of(lambda: cuda_ms(plain, reps=1))
        lib_ms = yardstick(band_a, band_b) if product else None
        kernels[name].update(ms=ms, plain_ms=plain_ms, **bnd_,
                             library_ms=lib_ms)
        print(f"phase 12 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
              + (f", library (torch.matmul, product only) {lib_ms:.4f} ms"
                 if product else ", library none")
              + f", bound {bnd_['bound_ms']:.4f} ms ({bnd_['bound_by']}"
              + (f"; on the fp32 cores {fp32_bound[name]['bound_ms']:.4f} ms"
                 if name in fp32_bound else "") + ")")
    k2_h3 = kernel_ms(lambda: cmb.band_energies(*band_args, hop=3),
                      "band_energies")
    print(f"phase 12 band_energies hop=3 alone: {k2_h3:.4f} ms")
    # the streamed runner's chunk of the track
    chunk = tuple(v[:, :CHUNK_BLOCKS].contiguous() for v in band_args[:3])
    c_cols = cols[:, :CHUNK_BLOCKS * (L // hop)].contiguous()
    c_in = nbytes(*chunk, t2, wt2)
    for name, fn, out_bytes in (
            ("band_energies", lambda: cmb.band_energies(*chunk, *sos,
                                                        hop=hop),
             nbytes(c_cols)),
            ("band_gain_apply", lambda: cmb.band_gain_apply(
                *chunk, c_cols, *sos, hop=hop, emit_mono=True),
             nbytes(c_cols, chunk[0]) + 4 * CHUNK_BLOCKS * L)):
        ms = kernel_ms(fn, name)
        c_bnd, _ = kweight_bounds(2 * CHUNK_BLOCKS, L, s_x, c_in + out_bytes,
                                  filters=2)
        kernels[name]["chunk_ms"] = ms
        print(f"phase 12 {name} at the streamed chunk {tuple(chunk[0].shape)}"
              f": kernel {ms:.4f} ms, bound {c_bnd['bound_ms']:.4f} ms "
              f"({c_bnd['bound_by']})")
    for name, fn in (("pass1_hull", lambda: bal.pass1_hull(m, ca, cr, hmax)),
                     ("pass1_runs", lambda: bal.pass1_runs(m, ca, cr, att0,
                                                           *hull))):
        print(f"phase 12 K5 {name} alone: {kernel_ms(fn, name):.4f} ms")
    clock, _ = sm_clock_under(lambda: bal.pass1_bnd(m, ca, cr, att0))
    latency = k5_latency_ms(chain_steps, clock)
    kernels["pass1_bnd"]["latency_bound_ms"] = latency
    print(f"phase 12 K5 latency bound: the longest run's live steps "
          f"{chain_steps} x {K5_CHAIN_CYCLES} cycles at {clock:.0f} MHz (SM "
          f"clock under K5) = {latency:.4f} ms; K5 "
          f"{kernels['pass1_bnd']['ms']:.4f} ms, "
          f"{100 * latency / kernels['pass1_bnd']['ms']:.0f} % of it")
    k7_one = kernel_ms(lambda: bal.replay_bnd(m, ca, cr, att0, idx, zero,
                                              ctrl0.clone()), "replay_bnd")
    print(f"phase 12 replay_bnd: the fixed point's {rounds} rounds in one "
          f"launch {kernels['replay_bnd']['ms']:.4f} ms; one round alone "
          f"{k7_one:.4f} ms")
    print("phase 12 ok", flush=True)

    # phase 13 --------------------------------------------------------------
    no_mb = MasteringParams.from_settings(SETTINGS)
    for what, p in (("multiband on", params), ("multiband off", no_mb)):
        print(f"phase 13 profile of master(), {what}, 180 s, input on the "
              f"card:")
        profile_calls(lambda: chain(x_dev, p))
    for mode in ("serial", "collapse"):
        print(f"phase 13 profile of ballistics_rates_bt mode={mode}, the "
              f"track's targets {tuple(m.shape)}:")
        profile_calls(lambda: bal.ballistics_rates_bt(m, ca, cr, att0,
                                                      mode=mode), top=6)
    print(f"phase 13 kernel timings: {WINDOWS['profiled']} profiler windows, "
          f"{len(WINDOWS['empty'])} without a kernel {WINDOWS['empty']}, "
          f"short of launches (kernel, seen, made) {WINDOWS['short']}")
    print("phase 13 ok", flush=True)


def quality_ops(x44, x48):
    """Phase 14's ops on a 44.1 kHz and a 48 kHz ``(N, 2)`` track: ``{name:
    (result, limit, relative)}``."""
    from python_audio_mastering_tpu_torch.ops import limiter as lim
    from python_audio_mastering_tpu_torch.ops import meters as met
    from python_audio_mastering_tpu_torch.ops import resample as rs

    out = {}
    for ex in ((False, False), (True, True)):
        out[f"true_peak_linear exclude_pad={ex}"] = (
            met.true_peak_linear(x44, exclude_pad=ex), 1e-5, True)
    out["_peak_env"] = (lim._peak_env(x44, True), 1e-5, True)
    out["lookahead_limiter"] = (lim.lookahead_limiter(x44, FS), 5e-5, False)
    state = lim.lookahead_limiter_init(2, x44.dtype, x44.device)
    pieces, step = [], 30 * FS
    for start in range(0, x44.shape[0], step):
        y, state = lim.lookahead_limiter_chunk(x44[start:start + step],
                                               state, FS)
        pieces.append(y)
    pieces.append(lim.lookahead_limiter_chunk(None, state, FS,
                                              flush=True)[0])
    out["lookahead_limiter_chunk"] = (torch.cat(pieces), 5e-5, False)
    out["resample 44100->48000"] = (rs.resample(x44, FS, FS48), 1e-5, False)
    out["resample 48000->44100"] = (rs.resample(x48, FS48, FS), 1e-5, False)
    return out


def quality_phases(o, kernels, card):
    """Phases 14-17: quality mode, the resampler, the meters and the
    engines around them, on the same track (``o`` from
    :func:`main_path_operands`)."""
    import dataclasses

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles.bs1770_ref import integrated_loudness as oracle_lufs

    from python_audio_mastering_tpu_torch import (
        MasteringChain,
        MasteringParams,
        engine,
        master,
    )
    from python_audio_mastering_tpu_torch.io import wavio
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
    from python_audio_mastering_tpu_torch.ops import meters as met
    from python_audio_mastering_tpu_torch.ops import resample as rs
    from python_audio_mastering_tpu_torch.parallel.streaming import (
        master_streamed,
    )
    from python_audio_mastering_tpu_torch.serving.store import (
        LocalFSBlobStore,
    )

    dev = o.xrows.device
    x = o.x
    qcfg = dataclasses.replace(o.chain.config,
                               limiter_mode="lookahead_truepeak")

    # phase 14 --------------------------------------------------------------
    hot = x * 2.0
    hot48 = make_signal(SECONDS * FS48, FS48, seed=1) * 2.0
    t0 = time.perf_counter()
    ref = quality_ops(*(torch.from_numpy(a.astype(np.float64))
                        for a in (hot, hot48)))
    print(f"phase 14 the CPU float64 references took "
          f"{time.perf_counter() - t0:.1f} s")
    hot_dev, hot48_dev = (torch.from_numpy(a).to(dev) for a in (hot, hot48))
    got = quality_ops(hot_dev, hot48_dev)
    torch.backends.cudnn.allow_tf32 = True
    try:
        again = quality_ops(hot_dev, hot48_dev)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    for name, (g, limit, relative) in got.items():
        r = ref[name][0]
        check(g.dtype == torch.float32 and g.shape == r.shape,
              f"{name}: {g.dtype} {tuple(g.shape)} vs {tuple(r.shape)}")
        compare(f"phase 14 {name}", g.double().cpu(), r, limit, relative)
        check_bitwise(f"phase 14 {name} with cudnn.allow_tf32 = True",
                      again[name][0], g)
    for name in ("lookahead_limiter", "lookahead_limiter_chunk"):
        y = got[name][0]
        peak = y.abs().max().item()
        tp_db = met.true_peak_db(y).item()
        print(f"phase 14 {name}: sample peak {peak:.8f} (ceiling "
              f"{CEILING:.8f}), true peak {tp_db:.4f} dBTP")
        check(peak <= CEILING * (1 + 1e-6), f"{name}: peak {peak} over the "
                                            f"ceiling")
        check(tp_db <= -0.8, f"{name}: true peak {tp_db} dBTP > -0.8")
    del ref, again
    print("phase 14 ok", flush=True)

    # phase 15 --------------------------------------------------------------
    one_shot = {}
    for lufs in QUALITY_LUFS:
        for mb in (False, True):
            p = MasteringParams.from_settings({**SETTINGS, "lufs": lufs,
                                               "multiband": mb})
            cmb.reset_launch_counts()
            res = master(x, p, qcfg, return_result=True)   # no device
            torch.cuda.synchronize()
            counts, twins = cmb.launch_counts(), cmb.plain_calls()
            check(res.audio.device.type == "cuda",
                  f"quality master() ran on {res.audio.device}")
            y = res.audio.cpu().numpy()
            one_shot[lufs, mb] = y
            check(y.shape == x.shape and bool(np.isfinite(y).all()),
                  f"quality master() output {y.shape}, finite "
                  f"{bool(np.isfinite(y).all())}")
            peak = float(np.abs(y).max())
            tp_db = met.true_peak_db(res.audio).item()
            lufs_out = oracle_lufs(y.astype(np.float64).mean(axis=1), FS)
            cpu = MasteringChain(qcfg)(x, p).numpy()
            d = np.abs(y - cpu)
            d_max, d_rms = float(d.max()), float(np.sqrt(np.mean(d ** 2)))
            print(f"phase 15 quality master() {lufs} LUFS multiband {mb}: "
                  f"peak {peak:.8f}, true peak {tp_db:.4f} dBTP, measured "
                  f"{float(res.measured_lufs):.4f} LUFS, oracle output "
                  f"loudness {lufs_out:.4f} LUFS (target {lufs}); launches "
                  f"{counts}; vs CPU quality path max abs {d_max:.3e} rms "
                  f"{d_rms:.3e}")
            check(peak <= CEILING * (1 + 1e-6), f"peak {peak} over the "
                                                f"ceiling")
            check(tp_db <= -0.8, f"true peak {tp_db} dBTP > -0.8")
            for name in NO_MB_KERNELS + (MB_COUNTED if mb else ()):
                check(counts[name] > 0, f"kernel {name} was not launched by "
                                        f"the quality master()")
            check(counts["lookahead_limit"] == 1
                  and twins["lookahead_limit_ref"] == 0,
                  f"quality master(): {counts['lookahead_limit']} K10 "
                  f"launches, {twins['lookahead_limit_ref']} twin calls")
            limit, limit_rms = (MB_MAX, MB_RMS) if mb else (2e-4, None)
            check(d_max < limit, f"card vs CPU max abs {d_max} >= {limit}")
            check(limit_rms is None or d_rms < limit_rms,
                  f"card vs CPU rms {d_rms} >= {limit_rms}")
    # the album path: each track limited to its own end on the chain's
    # strided view of its rows, one K10 launch a track
    p = MasteringParams.from_settings({**SETTINGS, "lufs": -8.0})
    lengths = [x.shape[0], 97 * FS + 31, 31 * FS + 7]
    batch = np.zeros((len(lengths),) + x.shape, np.float32)
    for i, v in enumerate(lengths):
        batch[i, :v] = x[:v]
    album_chain = MasteringChain(qcfg).to(dev)
    cmb.reset_launch_counts()
    y_album, _, _ = album_chain.forward_tracks(
        torch.from_numpy(batch).to(dev), p, lengths)
    torch.cuda.synchronize()
    counts, twins = cmb.launch_counts(), cmb.plain_calls()
    print(f"phase 15 quality album of {lengths} frames through "
          f"forward_tracks: lookahead_limit launches "
          f"{counts['lookahead_limit']}, lookahead_limit_ref calls "
          f"{twins['lookahead_limit_ref']}")
    check(counts["lookahead_limit"] == len(lengths)
          and twins["lookahead_limit_ref"] == 0,
          f"quality album: {counts['lookahead_limit']} K10 launches for "
          f"{len(lengths)} tracks, {twins['lookahead_limit_ref']} twin calls")
    for i, v in enumerate(lengths):
        one = master(x[:v], p, qcfg).cpu().numpy()
        y_i = y_album[i].cpu().numpy()
        d = float(np.abs(y_i[:v] - one).max())
        print(f"phase 15 quality album track {i} ({v} frames): vs its "
              f"quality master() max abs {d:.3e}")
        check(d <= 2e-4, f"quality album track {i} vs master() {d}")
        check(not y_i[v:].any(), f"quality album track {i}: not zero after "
                                 f"its end")
    kernels["lookahead_limit"] = {"launches": 1,
                                  "album_launches": len(lengths)}
    del y_album, album_chain
    for mb in (False, True):
        p = MasteringParams.from_settings({**SETTINGS, "lufs": -8.0,
                                           "multiband": mb})
        cmb.reset_launch_counts()
        out_s, _, _ = master_streamed(x, p, qcfg)   # no device argument
        counts = cmb.launch_counts()
        d_str = float(np.abs(out_s - one_shot[-8.0, mb]).max())
        print(f"phase 15 quality master_streamed -8 LUFS multiband {mb}: "
              f"launches {counts}; max abs vs one-shot {d_str:.3e}")
        check(all(counts[k] > 0 for k in
                  NO_MB_KERNELS + (MB_COUNTED if mb else ())),
              "quality master_streamed did not launch every kernel")
        check(d_str < 2e-4, f"streamed vs one-shot {d_str} >= 2e-4")
    print("phase 15 ok", flush=True)

    # phase 16 --------------------------------------------------------------
    quality = {**SETTINGS, "quality": True}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "track.wav")
        wavio.write_wav(src, x, FS, float_format=True)
        dst = os.path.join(tmp, "out48.wav")
        msgs = []
        cmb.reset_launch_counts()
        ok = engine.process_audio({**quality, "output_sample_rate": FS48,
                                   "input_file": src, "output_file": dst},
                                  msgs.append)   # no device argument
        counts = cmb.launch_counts()
        check(ok, f"process_audio failed: {msgs[-1] if msgs else ''}")
        y48, fs_out = wavio.read_wav(dst)
        want = -(-x.shape[0] * 160 // 147)
        l48 = oracle_lufs(y48.astype(np.float64).mean(axis=1), FS48)
        l44 = oracle_lufs(one_shot[-14.0, False].astype(np.float64).mean(
            axis=1), FS)
        print(f"phase 16 process_audio quality -> 48 kHz: {fs_out} Hz, "
              f"{y48.shape[0]} frames (want {want}); oracle {l48:.4f} LUFS "
              f"vs {l44:.4f} at 44.1 kHz; launches {counts}")
        check(fs_out == FS48 and y48.shape == (want, 2),
              "resampled output rate or length")
        check(abs(l48 - l44) <= 0.1, f"48 kHz loudness {l48} vs {l44}")
        check(all(counts[k] > 0 for k in NO_MB_KERNELS),
              "process_audio did not launch every kernel")

        folder, outdir = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(folder)
        wavio.write_wav(os.path.join(folder, "a.wav"), x[: 30 * FS], FS)
        wavio.write_wav(os.path.join(folder, "b.wav"),
                        hot48[: 30 * FS48] * 0.25, FS48)
        msgs = []
        cmb.reset_launch_counts()
        done = engine.batch_process_audio(quality, folder, outdir,
                                          msgs.append)   # no device
        counts = cmb.launch_counts()
        rates = {n: wavio.read_wav(os.path.join(outdir, n))[1]
                 for n in sorted(os.listdir(outdir))}
        print(f"phase 16 batch_process_audio: {done} mastered, {rates}; "
              f"{msgs[-1]!r}; launches {counts}")
        check(done == 2 and rates == {"a_mastered.wav": FS,
                                      "b_mastered.wav": FS48},
              "batch_process_audio outputs")
        check(all(counts[k] > 0 for k in NO_MB_KERNELS),
              "batch_process_audio did not launch every kernel")

        store = LocalFSBlobStore(os.path.join(tmp, "blobs"), bucket="jobs")
        with open(src, "rb") as f:
            store.upload("uploads/track.wav", f.read())
        cmb.reset_launch_counts()
        key = engine.process_audio_from_uri(
            "local://jobs/uploads/track.wav", quality, store=store,
            progress_cb=lambda m: None)   # no device argument
        counts = cmb.launch_counts()
        side = json.loads(store.download(f"{key}.meters.json"))
        y, _ = wavio.read_wav(store.download(key))
        tp_db = met.true_peak_db(torch.from_numpy(y).to(dev)).item()
        print(f"phase 16 process_audio_from_uri: {key}, complete "
              f"{store.exists(key + '.complete')}, meters {side}, written "
              f"audio's true peak {tp_db:.4f} dBTP; launches {counts}")
        check(key == "processed/mastered_track.wav"
              and store.exists(f"{key}.complete"), "output blob or flag")
        check(abs(side["integrated_lufs"] - SETTINGS["lufs"]) <= 1e-2,
              f"sidecar loudness {side['integrated_lufs']}")
        check(abs(side["true_peak_dbtp"] - tp_db) <= 0.05,
              f"sidecar true peak {side['true_peak_dbtp']} vs {tp_db}")
        check(all(counts[k] > 0 for k in NO_MB_KERNELS),
              "process_audio_from_uri did not launch every kernel")
    print("phase 16 ok", flush=True)

    # phase 17 --------------------------------------------------------------
    params = o.mb_params
    x_dev = torch.from_numpy(x).to(dev)
    chain_q = MasteringChain(qcfg).to(dev)
    timed = {
        "quality master(), multiband": lambda: chain_q(x_dev, params),
        "soft-limiter master(), multiband": lambda: o.chain(x_dev, params),
        "quality master_streamed, multiband": lambda: master_streamed(
            x, params, qcfg),
        "quality master_streamed, multiband, return_meters":
            lambda: master_streamed(x, params, qcfg, return_meters=True),
        "resample 44.1 -> 48 kHz, 180 s": lambda: rs.resample(x_dev, FS,
                                                               FS48),
    }
    for what, fn in timed.items():
        ms = median_of(lambda: cuda_ms(fn, reps=1))
        print(f"phase 17 {what}: {ms:.3f} ms ({card})")
    _, syncs = count_syncs(lambda: chain_q(x_dev, params))
    print(f"phase 17 host synchronisations per quality master(): {syncs}")
    print("phase 17 profile of the quality master(), multiband, 180 s, "
          "input on the card:")
    profile_calls(timed["quality master(), multiband"], top=8)
    print("phase 17 ok", flush=True)


def bench_audio(seconds, fs=FS, seed=0):
    """The JAX bench's synthetic track (``bench.py`` ``_mk_audio``): three
    tones and noise under a slow envelope, the right channel a 29-sample
    roll of the left."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * fs)) / fs
    sig = (0.4 * np.sin(2 * np.pi * 55 * t)
           + 0.2 * np.sin(2 * np.pi * 880 * t)
           + 0.1 * np.sin(2 * np.pi * 4200 * t)
           + 0.05 * rng.standard_normal(t.shape[0]))
    sig = sig * (0.4 + 0.6 * (0.5 + 0.5 * np.sin(2 * np.pi * 0.5 * t)) ** 2)
    return np.stack([sig, np.roll(sig, 29)], axis=1).astype(np.float32)


def album_chunk(tracks, chunk_frames, dev):
    """The album's first chunk as the runner folds it, ``(C, T, nb, L)``
    float32 on the card."""
    x = np.stack([t[:chunk_frames].T for t in tracks], axis=1)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev).view(
        x.shape[0], len(tracks), chunk_frames // L, L)


def album_operands(chain, params, x4):
    """What one album chunk ``x4 (C, T, nb, L)`` gives its kernels, built
    as the chain builds them (tracks folded into the block axis): K1's and
    K4's arguments, the band kernels' arguments and the detector's targets
    ``(m, ca, cr, att0)`` at ``(3·T, t)``."""
    from types import SimpleNamespace

    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
    from python_audio_mastering_tpu_torch.ops import iir
    from python_audio_mastering_tpu_torch.ops import multiband as mb
    from python_audio_mastering_tpu_torch.ops.waveshaper import saturate

    c, tracks, nb, _ = x4.shape
    hop = chain.config.comp_hop
    eq = chain.eq_ops(params)
    s_eq, _, _ = iir.sosfilt_states_rows(
        None, saturate(x4, params.saturation).reshape(c * tracks, nb, L),
        ops=eq)
    rows = x4.reshape(c, tracks * nb, L)
    k1_args = (rows, s_eq.reshape(c, tracks * nb, -1), eq.t, eq.w,
               params.saturation, params.width)
    y, mono = cmb.front_chain(*k1_args, emit_mono=True)
    kw = chain.kweight_ops()
    s_kw, _, _ = iir.sosfilt_states_rows(None, mono.reshape(tracks, nb, L),
                                         ops=kw)
    sos = mb._crossover_sos(FS, 250.0, 4000.0)
    (s_lp, s_hp), _ = iir.sosfilt_states_multi_rows(
        sos, y.reshape(c * tracks, nb, L), ops_list=chain.crossover_ops())
    band_args = (y, s_lp.reshape(c, tracks * nb, -1),
                 s_hp.reshape(c, tracks * nb, -1), *sos)
    xb = cmb.band_energies(*band_args, hop=hop)
    m, ca, cr, att0 = detector_targets(xb.reshape(3 * tracks, -1), params,
                                       hop, x4.device)
    return SimpleNamespace(
        k1_args=k1_args, k4_args=(mono.reshape(1, tracks * nb, L),
                                  s_kw.reshape(1, tracks * nb, -1), kw.t,
                                  kw.w),
        band_args=band_args, sos=sos, hop=hop, m=m, ca=ca, cr=cr, att0=att0)


def chain_targets(o):
    """The detector targets ``(m, ca, cr, att0)`` of both chains on the
    track (``o`` from :func:`main_path_operands`): ``{"worker": the
    worker chain's, from K2's band energies, "legacy": the legacy chain's,
    from its real bands}`` (at 180 s and hop 8, 7 752 whole blocks)."""
    from python_audio_mastering_tpu_torch import MasteringChain, MasteringParams
    from python_audio_mastering_tpu_torch.ops import compressor as comp
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
    from python_audio_mastering_tpu_torch.ops import multiband as mb
    from python_audio_mastering_tpu_torch.serving import monolith

    dev, hop = o.xrows.device, o.hop
    params = MasteringParams.from_settings(MB_SETTINGS)
    chain = MasteringChain(monolith.legacy_config(FS)).to(dev)
    xb = cmb.band_energies(*o.band_args, hop=hop)
    front = chain.front(o.xrows, params, legacy_eq=True)
    bands, _ = mb._legacy_bands(front[:, None], {}, chain.crossover_ops(),
                                False, None)
    xb_leg = torch.stack([comp.bucket_sums((b * b).mean(dim=0).reshape(-1),
                                           hop) for b in bands])
    return {name: detector_targets(e, params, hop, dev)
            for name, e in (("worker", xb), ("legacy", xb_leg))}


def check_ballistics(what, m, ca, cr, att0, serial_steps=16384):
    """K5's two launches against their plain twins at full T and against
    the serial walk on the first ``serial_steps``, K6 and K7 (all rounds
    in one launch) against theirs, and collapse == serial, all bitwise.
    Returns the fixed point's ``ctrl``."""
    from python_audio_mastering_tpu_torch.ops import ballistics as bal

    dev = m.device
    hmax = torch.maximum(att0, m.amax(dim=1)).contiguous()
    hull = bal.pass1_hull(m, ca, cr, hmax)
    hull_p = bal.pass1_hull_ref(m, ca, cr, hmax)
    for name, got, ref in zip(("lo", "hi", "stops"), hull, hull_p):
        check_bitwise(f"{what} K5 pass1_hull {name}", got, ref)
    lo, hi, _ = hull
    bnd = bal.pass1_runs(m, ca, cr, att0, *hull)
    check_bitwise(f"{what} K5 pass1_runs", bnd,
                  bal.pass1_runs_ref(m, ca, cr, att0, *hull_p))
    cut = m[:, :serial_steps].contiguous()
    check_bitwise(f"{what} K5 pass1_bnd vs the serial walk (first "
                  f"{serial_steps} steps)", bal.pass1_bnd(cut, ca, cr, att0),
                  bal.pass1_bnd_ref(cut, ca, cr, att0))
    incomes = torch.cat([att0[:, None], bnd[:, :-1]], dim=1).contiguous()
    check_bitwise(f"{what} K6 replay", bal.replay(m, ca, cr, incomes),
                  bal.replay_ref(m, ca, cr, incomes))
    idx = bal._frozen_index(m)
    s0 = torch.zeros_like(bnd)
    ck, cp = bal.new_ctrl(dev), bal.new_ctrl(dev)
    check_bitwise(f"{what} K7 replay_bnd, {bal.FIXPOINT_ITERS} rounds in "
                  f"one launch", bal.replay_bnd(m, ca, cr, att0, idx, s0, ck,
                                                rounds=bal.FIXPOINT_ITERS),
                  bal.replay_bnd_ref(m, ca, cr, att0, idx, s0, cp,
                                     rounds=bal.FIXPOINT_ITERS))
    check(torch.equal(ck, cp), f"replay_bnd ctrl {ck.tolist()} != plain "
                               f"{cp.tolist()}")
    collapse, ctrl = bal._run_collapse(m, ca, cr, att0)
    check_bitwise(f"{what} serial == collapse", bal._run(m, ca, cr, att0),
                  collapse)
    n_coll = int((lo == hi).sum())
    print(f"  {what} {tuple(m.shape)}: {m.shape[0] * m.shape[1] // bal.BLOCK}"
          f" blocks, {n_coll} collapsed in the hull pass; fixed point ctrl "
          f"{ctrl.tolist()}")
    return ctrl


def k7_staging(rows, t):
    """Where K7 holds a ``(rows, t)`` timeline, by its wrapper's own rule
    (``csrc/ballistics.cu``, ``pam_replay_bnd``): in shared memory when
    ``ceil(blocks / SMs)`` padded block rows of 129 floats fit one CTA's
    opt-in shared memory, else read from device memory every round."""
    from python_audio_mastering_tpu_torch.ops import ballistics as bal

    props = torch.cuda.get_device_properties(0)
    per_sm = -(-rows * (t // bal.BLOCK) // props.multi_processor_count)
    fits = per_sm * 4 * (bal.BLOCK + 1) <= props.shared_memory_per_block_optin
    return "shared memory" if fits else "device memory"


class Interrupt(Exception):
    pass


def album_phases(o, kernels, card):
    """Phases 18-21: the album path (``parallel.batch``), the rest of the
    streamed runner, the album engine and the job worker, on the bench's
    12 x 300 s album (``o`` from :func:`main_path_operands`)."""
    import dataclasses
    import shutil

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles.bs1770_ref import integrated_loudness as oracle_lufs

    from python_audio_mastering_tpu_torch import (
        ChainConfig,
        MasteringChain,
        MasteringParams,
        engine,
        master,
    )
    from python_audio_mastering_tpu_torch.io import wavio
    from python_audio_mastering_tpu_torch.ops import ballistics as bal
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
    from python_audio_mastering_tpu_torch.parallel import batch, streaming
    from python_audio_mastering_tpu_torch.serving import worker
    from python_audio_mastering_tpu_torch.serving.store import (
        LocalFSBlobStore,
    )

    dev = o.xrows.device
    cfg = ChainConfig.gpu_default(FS)
    params = MasteringParams.from_settings(MB_SETTINGS)
    t0 = time.perf_counter()
    tracks = [bench_audio(ALBUM_SECONDS, seed=s) for s in ALBUM_SEEDS]
    n = tracks[0].shape[0]
    cf = streaming.default_chunk_frames(cfg)
    chunks = -(-n // cf)
    n_tr = len(tracks)
    print(f"phase 18 album: {n_tr} tracks x {ALBUM_SECONDS} s, seeds "
          f"{ALBUM_SEEDS[0]}-{ALBUM_SEEDS[-1]} ({time.perf_counter() - t0:.1f}"
          f" s to make), {chunks} chunks of {cf} frames, pcm16 wire")

    def album(trs=tracks, p=params, c=cfg, **kw):
        return batch.master_album_streamed(trs, p, c, **kw)

    # phase 18 --------------------------------------------------------------
    album(transfer="pcm16")                    # warm: operators, pinned pool
    torch.cuda.synchronize()
    cmb.reset_launch_counts()
    stats = {}
    t0 = time.perf_counter()
    outs, measured, meters = album(transfer="pcm16", return_meters=True,
                                   timings=stats)
    wall = time.perf_counter() - t0
    counts = cmb.launch_counts()
    per_chunk = {k: v / chunks for k, v in counts.items()}
    print(f"phase 18 master_album_streamed (no device argument): wall "
          f"{wall:.3f} s; device resident {stats['device_resident']}, wire in"
          f" {stats['wire_bytes_in'] / 1e6:.1f} MB, retained "
          f"{stats['max_retained_bytes'] / 1e9:.3f} GB; launches {counts}, "
          f"per chunk for all {n_tr} tracks {per_chunk}")
    check(stats["device_resident"], "the bench album did not stay resident")
    for name in ALBUM_KERNELS:
        check(counts[name] == chunks, f"{name} launched {counts[name]} times "
                                      f"in {chunks} chunks, not once a chunk")
    for name in K5_LAUNCHES:
        check(counts[name] <= chunks, f"{name} launched {counts[name]} times "
                                      f"in {chunks} chunks")
    for name in ALBUM_KERNELS:
        kernels[name]["album_launches"] = counts[name]
    kernels["pass1_bnd"]["album_launches"] = sum(counts[k]
                                                 for k in K5_LAUNCHES)
    for i, (x, y) in enumerate(zip(tracks, outs)):
        check(y.shape == x.shape and bool(np.isfinite(y).all()),
              f"track {i}: output {y.shape}")
        peak = float(np.abs(y).max())
        lufs = oracle_lufs(y.astype(np.float64).mean(axis=1), FS)
        print(f"phase 18 track {i}: peak {peak:.4f}, measured "
              f"{measured[i]:.4f} LUFS, oracle output {lufs:.4f} LUFS, "
              f"meters integrated {meters[i]['integrated_lufs']:.4f} LUFS, "
              f"true peak {meters[i]['true_peak_dbtp']:.4f} dBTP, LRA "
              f"{meters[i]['lra_lu']:.4f} LU")
        check(peak <= 1.0, f"track {i}: |y| max {peak} > 1")
        check(abs(lufs - MB_SETTINGS["lufs"]) <= 0.15,
              f"track {i}: output loudness {lufs} not within 0.15 LU")
    outs_f, measured_f = album()
    for i in CHECK_TRACKS:
        for what, got, transfer in (("pcm16", outs[i], "pcm16"),
                                    ("float32", outs_f[i], "float32")):
            ref, m_ref, _ = streaming.master_streamed(tracks[i], params, cfg,
                                                      transfer=transfer)
            d = float(np.abs(got - ref).max())
            ms = measured if transfer == "pcm16" else measured_f
            print(f"phase 18 track {i} {what}: album vs its own "
                  f"master_streamed max abs {d:.3e}, bitwise "
                  f"{np.array_equal(got, ref)}, |dLUFS| "
                  f"{abs(ms[i] - m_ref):.3e}")
            check(d <= 2e-4, f"track {i} {what}: album vs master_streamed {d}")
            check(abs(ms[i] - m_ref) <= 1e-3, f"track {i}: LUFS")
    d_wire = max(float(np.abs(a - b).max()) for a, b in zip(outs, outs_f))
    print(f"phase 18 pcm16 vs float32 album, every track: max abs "
          f"{d_wire:.3e}")
    check(d_wire < 3e-3, f"pcm16 vs float32 {d_wire} >= 3e-3")
    x30 = tracks[0][: 30 * FS]
    card30 = album([x30])[0][0]
    t0 = time.perf_counter()
    cpu30 = album([x30], device="cpu")[0][0]
    d = np.abs(card30 - cpu30)
    d_max, d_rms = float(d.max()), float(np.sqrt(np.mean(d ** 2)))
    print(f"phase 18 30 s track, album on the card vs the port's CPU path "
          f"({time.perf_counter() - t0:.1f} s on the CPU): max abs "
          f"{d_max:.3e}, rms {d_rms:.3e}")
    check(d_max < MB_MAX and d_rms < MB_RMS, "30 s track vs the CPU path")
    chain = MasteringChain(cfg).to(dev)
    x4 = album_chunk(tracks, cf, dev)
    ao = album_operands(chain, params, x4)
    hop = ao.hop
    # K1-K4 against their plain twins at the album chunk's shapes, K3 with
    # the chunk's own detector gains (phases 2, 3, 7 and 8's limits)
    t_tr = ao.band_args[0].shape[1] * (L // hop) // n_tr   # steps a track
    att, _ = bal.ballistics_rates_bt(ao.m, ao.ca, ao.cr, ao.att0)
    g = (10.0 ** (-att[:, :t_tr] / 20.0)).reshape(3, n_tr * t_tr)
    cols = torch.stack([g[1], g[0] - g[1], g[2] - g[1]]).contiguous()
    pairs = {
        "front_chain": (cmb.front_chain, cmb.front_chain_ref, ao.k1_args,
                        {"emit_mono": True}, False),
        "kweight_cells": (cmb.kweight_cells, cmb.kweight_cells_ref,
                          (*ao.k4_args, K4_HOPS[0]), {}, True),
        "band_energies": (cmb.band_energies, cmb.band_energies_ref,
                          ao.band_args, {"hop": hop}, True),
        "band_gain_apply": (cmb.band_gain_apply, cmb.band_gain_apply_ref,
                            (*ao.band_args[:3], cols, *ao.sos),
                            {"hop": hop, "emit_mono": True}, True)}
    for name, (kern, plain, args, kw, rel) in pairs.items():
        got, ref = kern(*args, **kw), plain(*args, **kw)
        gots = (got,) if torch.is_tensor(got) else got
        refs = (ref,) if torch.is_tensor(ref) else ref
        err = max(compare(f"phase 18 {name} at the album chunk, out {k}", a,
                          b, 1e-4, relative=rel)
                  for k, (a, b) in enumerate(zip(gots, refs)))
        kernels[name]["album_max_abs_err"] = err
    m20 = torch.cat([ao.m, ao.m[: 3 * (K7_TRACKS - n_tr)]]).contiguous()
    rep = lambda v: torch.cat([v, v[: 3 * (K7_TRACKS - n_tr)]])  # noqa: E731
    # which of K7's two stagings each case takes, by its wrapper's rule
    stagings = [k7_staging(*v.shape) for v in (ao.m, m20)]
    print(f"phase 18 K7 staging: {tuple(ao.m.shape)} {stagings[0]}, "
          f"{tuple(m20.shape)} {stagings[1]}")
    check(stagings == ["shared memory", "device memory"],
          f"K7 stagings {stagings}: the two cases do not cover both")
    ctrl = check_ballistics(f"phase 18 album targets ({n_tr} tracks)", ao.m,
                            ao.ca, ao.cr, ao.att0)
    check_ballistics(f"phase 18 {K7_TRACKS}-track targets (K7 reads them "
                     f"from device memory)", m20, rep(ao.ca), rep(ao.cr),
                     rep(ao.att0))
    print("phase 18 ok", flush=True)

    # phase 19 --------------------------------------------------------------
    tm = {}
    outs_b, _ = album(c=dataclasses.replace(
        cfg, device_budget_bytes=ALBUM_BUDGET), transfer="pcm16", timings=tm)
    d_b = max(float(np.abs(a - b).max()) for a, b in zip(outs_b, outs))
    print(f"phase 19 bounded ({ALBUM_BUDGET / 2 ** 30:.3f} GiB budget): "
          f"resident {tm['device_resident']},"
          f" spilled {tm['spilled_chunks']} chunks, retained at most "
          f"{tm['max_retained_bytes'] / 1e9:.3f} GB; vs resident max abs "
          f"{d_b:.3e}")
    check(not tm["device_resident"] and tm["spilled_chunks"] > 0,
          "the budget did not spill")
    check(d_b <= 1e-6, f"bounded vs resident {d_b}")
    ckpt = tempfile.mkdtemp(prefix="pam_album_ckpt_")
    try:
        def stop(msg):
            if msg.startswith(f"Processed chunk {ALBUM_STOP_AFTER}/"):
                raise Interrupt()

        try:
            album(transfer="pcm16", checkpoint_dir=ckpt,
                  checkpoint_every=ALBUM_CKPT_EVERY, progress_cb=stop)
            check(False, "the interrupting progress_cb did not stop the run")
        except Interrupt:
            pass
        saved = sorted(os.listdir(ckpt))
        msgs = []
        outs_r, _ = album(transfer="pcm16", checkpoint_dir=ckpt,
                          checkpoint_every=ALBUM_CKPT_EVERY,
                          progress_cb=msgs.append)
        same = all(np.array_equal(a, b) for a, b in zip(outs_r, outs))
        durable = ALBUM_STOP_AFTER // ALBUM_CKPT_EVERY * ALBUM_CKPT_EVERY
        print(f"phase 19 checkpoint every {ALBUM_CKPT_EVERY} chunks, "
              f"interrupted after chunk {ALBUM_STOP_AFTER}: saved {saved}; "
              f"{[m for m in msgs if m.startswith('Resuming')]}; resumed vs "
              f"uninterrupted bitwise {same}")
        check(saved == [f"chunk_{k - 1:05d}.npz" for k in range(
            ALBUM_CKPT_EVERY, durable + 1, ALBUM_CKPT_EVERY)],
              f"checkpoint files {saved}")
        check(same, "resumed album differs from the uninterrupted run")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    qcfg = dataclasses.replace(cfg, limiter_mode="lookahead_truepeak")
    qparams = MasteringParams.from_settings({**MB_SETTINGS, "lufs": -9.0})
    q_tracks = [tracks[i] for i in CHECK_TRACKS]
    q_outs, _ = album(q_tracks, qparams, qcfg)
    for i, x, y in zip(CHECK_TRACKS, q_tracks, q_outs):
        one = master(x, qparams, qcfg).cpu().numpy()
        d = float(np.abs(y - one).max())
        peak = float(np.abs(y).max())
        print(f"phase 19 quality album -9 LUFS, track {i}: vs its quality "
              f"master() max abs {d:.3e}, peak {peak:.8f} (ceiling "
              f"{CEILING:.8f})")
        check(d <= 2e-4, f"quality track {i} vs master() {d}")
        check(peak <= CEILING * (1 + 1e-6), f"quality track {i} peak {peak}")
    # tracks with their own front settings: K1 once per group and chunk
    mix = [MasteringParams.from_settings({**MB_SETTINGS, **s})
           for s in MIXED_SETTINGS]
    n_groups = len(chain.front_groups(mix))
    cmb.reset_launch_counts()
    mix_outs, mix_meas = album(q_tracks, mix)
    counts = cmb.launch_counts()
    print(f"phase 19 album of tracks {CHECK_TRACKS} with settings "
          f"{MIXED_SETTINGS}: {n_groups} front groups, launches {counts}")
    check(n_groups == 2, f"{n_groups} front groups, not 2")
    check(counts["front_chain"] == n_groups * chunks,
          f"front_chain launched {counts['front_chain']} times, not "
          f"{n_groups} groups x {chunks} chunks")
    for name in ALBUM_KERNELS[1:]:
        check(counts[name] == chunks, f"{name} launched {counts[name]} times "
                                      f"in {chunks} chunks")
    for i, x, p, y, m_i in zip(CHECK_TRACKS, q_tracks, mix, mix_outs,
                               mix_meas):
        ref, m_ref, _ = streaming.master_streamed(x, p, cfg)
        d = float(np.abs(y - ref).max())
        print(f"phase 19 mixed-settings album, track {i}: vs its own "
              f"master_streamed max abs {d:.3e}, bitwise "
              f"{np.array_equal(y, ref)}, |dLUFS| {abs(m_i - m_ref):.3e}")
        check(d <= 2e-4, f"mixed-settings track {i} vs master_streamed {d}")
        check(abs(m_i - m_ref) <= 1e-3, f"mixed-settings track {i}: LUFS")
    x180 = o.x
    plain, _, _ = streaming.master_streamed(x180, params, cfg)
    pcm, _, _ = streaming.master_streamed(x180, params, cfg,
                                          transfer="pcm16")
    d_pcm = float(np.abs(pcm - plain).max())
    ckpt = tempfile.mkdtemp(prefix="pam_stream_ckpt_")
    try:
        def stop3(msg):
            if msg.startswith("Processed chunk 3/"):
                raise Interrupt()

        try:
            streaming.master_streamed(x180, params, cfg, checkpoint_dir=ckpt,
                                      progress_cb=stop3)
        except Interrupt:
            pass
        resumed, _, _ = streaming.master_streamed(x180, params, cfg,
                                                  checkpoint_dir=ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    same = np.array_equal(resumed, plain)
    print(f"phase 19 master_streamed 180 s: pcm16 vs float32 max abs "
          f"{d_pcm:.3e}; interrupted after chunk 3 and resumed, bitwise "
          f"{same}")
    check(d_pcm < 3e-3, f"master_streamed pcm16 vs float32 {d_pcm}")
    check(same, "resumed master_streamed differs")
    print("phase 19 ok", flush=True)

    # phase 20 --------------------------------------------------------------
    sec = ENGINE_SECONDS
    files = (("a44k.wav", FS, bench_audio(sec, FS, 30), True),
             ("b48k.wav", FS48, make_signal(sec * FS48, FS48, 31), True),
             ("c_mono.wav", FS, bench_audio(sec, FS, 32)[:, :1], True),
             ("d16.wav", FS48, make_signal(sec * FS48 * 5 // 6, FS48, 33),
              False))
    with tempfile.TemporaryDirectory() as tmp:
        store = LocalFSBlobStore(os.path.join(tmp, "blobs"), bucket="jobs")
        loaded = []
        for name, fs, x, flt in files:
            path = os.path.join(tmp, name)
            wavio.write_wav(path, x, fs, float_format=flt)
            with open(path, "rb") as f:
                store.upload(f"uploads/{name}", f.read())
            loaded.append(wavio.read_wav(path))
        uris = [f"local://jobs/uploads/{f[0]}" for f in files]
        conformed, fs_album = engine.conform_album_tracks(
            loaded, progress_cb=lambda m: None)

        def check_job(what, keys, transfer, which=range(len(files))):
            for key, i in zip(keys, which):
                uri, x = uris[i], conformed[i]
                ref, _, _ = streaming.master_streamed(
                    x, params, engine.default_config(fs_album),
                    transfer=transfer)
                y, fs_out = wavio.read_wav(store.download(key))
                side = json.loads(store.download(f"{key}.meters.json"))
                d = float(np.abs(y - ref).max())
                print(f"phase 20 {what} {uri}: {key}, {fs_out} Hz "
                      f"{y.shape}, complete {store.exists(key + '.complete')},"
                      f" meters {side}; vs master_streamed of the conformed "
                      f"track max abs {d:.3e}")
                check(store.exists(f"{key}.complete")
                      and not store.exists(f"{key}.failed"), f"{key} flags")
                check(fs_out == fs_album and y.shape == x.shape, "shape")
                check(abs(side["integrated_lufs"] - MB_SETTINGS["lufs"])
                      <= 1e-2, f"{key} sidecar loudness")
                check(d <= 2e-4, f"{key} vs master_streamed {d}")

        msgs = []
        cmb.reset_launch_counts()
        keys = engine.process_album_from_uris(uris, MB_SETTINGS, store=store,
                                              progress_cb=msgs.append)
        counts = cmb.launch_counts()
        print(f"phase 20 process_album_from_uris (no device argument): "
              f"{[m for m in msgs if m.startswith(('Decod', 'Resampl', 'Upmix'))]}"
              f"; launches {counts}")
        check(all(counts[k] > 0 for k in ALBUM_KERNELS),
              "process_album_from_uris did not launch every kernel")
        check_job("process_album_from_uris", keys, "float32")
        for k in keys:
            store.delete(k)
            store.delete(f"{k}.complete")
        for var in ("PAM_TRANSFER", "PAM_CHECKPOINT", "PAM_METERS"):
            os.environ.pop(var, None)
        opts = worker.job_options()
        print(f"phase 20 worker job_options() {opts}")
        keys = worker.run_job({"gcs_uris": uris, "settings": MB_SETTINGS},
                              store)                  # no device argument
        check_job("run_job album", keys, opts["transfer"])
        store.delete(f"{keys[1]}.complete")
        key = worker.run_job({"gcs_uri": uris[1], "settings": MB_SETTINGS},
                             store)
        check(key == keys[1] and store.exists(f"{key}.complete")
              and not store.exists(f"{key}.failed"), "single job")
        check_job("run_job single", [key], opts["transfer"], [1])
    print("phase 20 ok", flush=True)

    # phase 21 --------------------------------------------------------------
    def album_wall():
        t0 = time.perf_counter()
        album(transfer="pcm16")
        return time.perf_counter() - t0

    walls = [album_wall() for _ in range(3)]
    w = statistics.median(walls)
    print(f"phase 21 album wall, pcm16, {n_tr} x {ALBUM_SECONDS} s, median "
          f"of 3 warm runs: "
          f"{w:.3f} s (runs {[round(v, 3) for v in walls]}), x"
          f"{n_tr * ALBUM_SECONDS / w:.0f} realtime ({card})")
    for transfer in ("float32", "pcm16"):
        runs = []
        for _ in range(3):
            tm = {}
            album(transfer=transfer, timings=tm)
            runs.append(tm)
        med = {k: statistics.median(r[k] for r in runs)
               for k in ("h2d_s", "compute_s", "d2h_s")}
        print(f"phase 21 timings split {transfer} (median of 3, device "
              f"barriers between phases): h2d {med['h2d_s']:.3f} s, compute "
              f"{med['compute_s']:.3f} s, d2h {med['d2h_s']:.3f} s; wire in "
              f"{runs[0]['wire_bytes_in'] / 1e6:.1f} MB, out "
              f"{runs[0]['wire_bytes_out'] / 1e6:.1f} MB ({card})")
    state = streaming.StreamState()
    groups = chain.front_groups([params] * n_tr)
    tp = [params] * n_tr

    def one_chunk():
        return streaming._fx_chunk(x4, tp, cfg, state, chain, True, groups)

    print(f"phase 21 profile of one album chunk (pass A, {n_tr} tracks x "
          f"{cf / FS:.1f} s, input on the card):")
    profile_calls(one_chunk, calls=3)
    _, syncs = count_syncs(one_chunk)
    _, syncs_album = count_syncs(lambda: album(transfer="pcm16"))
    print(f"phase 21 host synchronisations: {syncs} per album chunk (pass "
          f"A), {syncs_album} per album run of {chunks} chunks")
    hmax =torch.maximum(ao.att0, ao.m.amax(dim=1)).contiguous()
    bnd = bal.pass1_bnd(ao.m, ao.ca, ao.cr, ao.att0)
    incomes = torch.cat([ao.att0[:, None], bnd[:, :-1]], 1).contiguous()
    timed = {
        "front_chain": (lambda: cmb.front_chain(*ao.k1_args, True),
                        "front_chain"),
        "kweight_cells": (lambda: cmb.kweight_cells(*ao.k4_args, 6),
                          "kweight_cells"),
        "band_energies": (lambda: cmb.band_energies(*ao.band_args, hop=hop),
                          "band_energies"),
        "band_gain_apply": (lambda: cmb.band_gain_apply(
            *ao.band_args[:3], cols, *ao.sos, hop=hop, emit_mono=True),
            "band_gain_apply"),
        "pass1_bnd": (lambda: bal.pass1_runs(
            ao.m, ao.ca, ao.cr, ao.att0,
            *bal.pass1_hull(ao.m, ao.ca, ao.cr, hmax)), K5_LAUNCHES),
        "replay": (lambda: bal.replay(ao.m, ao.ca, ao.cr, incomes), "replay"),
        "replay_bnd": (lambda: bal._run_collapse(ao.m, ao.ca, ao.cr,
                                                 ao.att0), "replay_bnd"),
    }
    for name, (fn, names) in timed.items():
        ms = kernel_ms(fn, names)
        kernels[name]["album_ms"] = ms
        shape = tuple({"front_chain": ao.k1_args[0],
                       "kweight_cells": ao.k4_args[0]}.get(
            name, ao.m if name in BALLISTICS else ao.band_args[0]).shape)
        print(f"phase 21 {name} at the album chunk {shape}: {ms:.4f} ms; "
              f"the single 180 s track (phases 6, 12) "
              f"{kernels[name]['ms']:.4f} ms ({card})")
    print(f"phase 21 fixed point on the album targets: ctrl {ctrl.tolist()};"
          f" {WINDOWS['profiled']} profiler windows in all, "
          f"{len(WINDOWS['empty'])} without a kernel {WINDOWS['empty']}, "
          f"short of launches (kernel, seen, made) {WINDOWS['short']}")
    print("phase 21 ok", flush=True)


def legacy_phases(o, kernels, card):
    """Phases 22-25: the legacy chain (the monolith service's engine) on
    the 180 s track, one-shot and streamed, the monolith job, and the
    ballistics executions (``o`` from :func:`main_path_operands`)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles.bs1770_ref import integrated_loudness as oracle_lufs

    from python_audio_mastering_tpu_torch import (
        MasteringChain,
        MasteringParams,
        master,
    )
    from python_audio_mastering_tpu_torch.io import wavio
    from python_audio_mastering_tpu_torch.ops import ballistics as bal
    from python_audio_mastering_tpu_torch.ops import compressor as comp
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
    from python_audio_mastering_tpu_torch.ops import iir
    from python_audio_mastering_tpu_torch.ops import multiband as mb
    from python_audio_mastering_tpu_torch.ops import waveshaper as ws
    from python_audio_mastering_tpu_torch.parallel import streaming
    from python_audio_mastering_tpu_torch.serving import monolith
    from python_audio_mastering_tpu_torch.serving.store import (
        LocalFSBlobStore,
    )

    x, dev, hop = o.x, o.xrows.device, o.hop
    cfg = monolith.legacy_config(FS)
    settings = {False: SETTINGS, True: MB_SETTINGS}
    limits = {False: (2e-4, None), True: (MB_MAX, MB_RMS)}

    def check_run(what, y, measured, mbon, ref_y, ref_measured):
        """Finite, |y| <= 1, oracle loudness, and against the CPU run
        within the phase's limits; returns (max abs, rms, |dLUFS|)."""
        check(bool(np.isfinite(y).all()), f"{what}: non-finite output")
        peak = float(np.abs(y).max())
        check(peak <= 1.0, f"{what}: |y| max {peak} > 1")
        lufs_out = oracle_lufs(y.astype(np.float64).mean(axis=1), FS)
        d = np.abs(y - ref_y)
        d_max, d_rms = float(d.max()), float(np.sqrt(np.mean(d ** 2)))
        d_lufs = abs(float(measured) - float(ref_measured))
        print(f"  {what}: peak {peak:.4f}, oracle loudness {lufs_out:.4f} "
              f"LUFS; vs the port's CPU path max abs {d_max:.3e}, rms "
              f"{d_rms:.3e}, |dLUFS| {d_lufs:.3e}")
        check(abs(lufs_out - SETTINGS["lufs"]) <= 0.15,
              f"{what}: output loudness {lufs_out} not within 0.15 LU")
        lim_max, lim_rms = limits[mbon]
        check(d_max < lim_max, f"{what}: max abs {d_max} >= {lim_max}")
        check(lim_rms is None or d_rms < lim_rms,
              f"{what}: rms {d_rms} >= {lim_rms}")
        check(d_lufs < 1e-3, f"{what}: |dLUFS| {d_lufs} >= 1e-3")

    # phase 22 --------------------------------------------------------------
    legacy = {}
    for mbon in (False, True):
        params = MasteringParams.from_settings(settings[mbon])
        cmb.reset_launch_counts()
        res = master(x, params, cfg, return_result=True)  # no device argument
        torch.cuda.synchronize()
        counts = cmb.launch_counts()
        check(res.audio.device.type == "cuda",
              f"legacy master() without a device ran on {res.audio.device}")
        y = res.audio.cpu().numpy()
        check(y.shape == x.shape, f"legacy output shape {y.shape}")
        print(f"phase 22 legacy master() multiband {mbon} (no device "
              f"argument): launches {counts}")
        check(counts["kweight_cells"] == 1, "kweight_cells not launched once")
        for name in ("front_chain", "band_energies", "band_gain_apply"):
            check(counts[name] == 0, f"{name} launched by the legacy chain")
        if mbon:
            for name in (*K5_LAUNCHES, "replay"):
                check(counts[name] > 0, f"{name} not launched")
            check(counts["replay_bnd"] == 1,
                  f"replay_bnd launched {counts['replay_bnd']} times")
            launched = {**counts,
                        "pass1_bnd": sum(counts[k] for k in K5_LAUNCHES)}
            for name in ("kweight_cells",) + BALLISTICS:
                kernels[name]["legacy_launches"] = launched[name]
        t0 = time.perf_counter()
        cpu = MasteringChain(cfg)(x, params, return_result=True)
        print(f"  the CPU run took {time.perf_counter() - t0:.1f} s")
        check_run(f"phase 22 legacy master() multiband {mbon}", y,
                  res.measured_lufs, mbon, cpu.audio.numpy(),
                  cpu.measured_lufs)
        legacy[mbon] = y
    print("phase 22 ok", flush=True)

    # phase 23 --------------------------------------------------------------
    chain = MasteringChain(cfg).to(dev)
    params = MasteringParams.from_settings(SETTINGS)
    coefs = ws.exciter_coefs(params.saturation, "legacy")
    eq = chain.eq_ops(params)
    s_leg, _, _ = iir.sosfilt_states_rows(None, ws.exciter(o.xrows, coefs),
                                          ops=eq)
    err = 0.0
    for emit in (False, True):
        args = (o.xrows, s_leg, eq.t, eq.w, coefs, params.width)
        got = cmb.front_chain(*args, emit_mono=emit)
        ref = cmb.front_chain_ref(*args, emit_mono=emit)
        for what, g, r in zip(("y", "mono"), got if emit else (got,),
                              ref if emit else (ref,)):
            err = max(err, compare(f"phase 23 front_chain, legacy exciter "
                                   f"{tuple(round(c, 6) for c in coefs)}, "
                                   f"emit_mono={emit} {what}", g, r, 1e-4,
                                   relative=False))
    kernels["front_chain"]["legacy_max_abs_err"] = err
    chunks = -(-x.shape[0] // streaming.default_chunk_frames(cfg))
    for mbon in (False, True):
        params = MasteringParams.from_settings(settings[mbon])
        cmb.reset_launch_counts()
        out, measured, _ = streaming.master_streamed(x, params, cfg)
        counts = cmb.launch_counts()
        print(f"phase 23 legacy master_streamed multiband {mbon} (no device "
              f"argument): {chunks} chunks, launches {counts}")
        check(counts["front_chain"] == chunks,
              f"front_chain launched {counts['front_chain']} times in "
              f"{chunks} chunks")
        check(counts["band_energies"] == counts["band_gain_apply"] == 0,
              "the worker band kernels ran in the legacy chain")
        if mbon:
            check(counts["replay_bnd"] == chunks,
                  "replay_bnd not launched once a chunk")
            kernels["front_chain"]["legacy_launches"] = counts["front_chain"]
        t0 = time.perf_counter()
        ref, ref_measured, _ = streaming.master_streamed(x, params, cfg,
                                                         device="cpu")
        print(f"  the CPU run took {time.perf_counter() - t0:.1f} s")
        check_run(f"phase 23 legacy master_streamed multiband {mbon}", out,
                  measured, mbon, ref, ref_measured)
        d_one = np.abs(out - legacy[mbon])
        print(f"  streamed (worker EQ) vs one-shot (legacy EQ), the "
              f"reference's quirk: max abs {d_one.max():.4f}, rms "
              f"{np.sqrt(np.mean(d_one ** 2)):.4f}")
    with tempfile.TemporaryDirectory() as tmp:
        store = LocalFSBlobStore(tmp, bucket="mono")
        x30 = x[: ENGINE_SECONDS * FS]
        buf = io.BytesIO()
        wavio.write_wav(buf, x30, FS, float_format=True)
        store.upload("uploads/song.wav", buf.getvalue())
        job = {**SETTINGS, "use_multiband": True}
        key = monolith.run_legacy_job(store, "uploads/song.wav", job)
        out, fs_out = wavio.read_wav(store.download(key))
        ref, _, _ = streaming.master_streamed(
            x30, MasteringParams.from_settings(job), cfg)
        d_job = float(np.abs(out - ref).max())
        print(f"phase 23 run_legacy_job (no device argument): {key}, "
              f"complete {store.download(key + '.complete')!r}; vs "
              f"master_streamed max abs {d_job:.3e}")
        check(key == "processed/song.wav" and fs_out == FS
              and out.shape == x30.shape, "monolith output")
        check(store.download(key + ".complete") == b"done", ".complete")
        check(d_job <= 3.052e-5, f"monolith vs master_streamed {d_job}")
    print("phase 23 ok", flush=True)

    # phase 24 --------------------------------------------------------------
    params = MasteringParams.from_settings(MB_SETTINGS)
    both = chain_targets(o)
    t = both["worker"][0].shape[1]
    block = cfg.comp_block_ctrl
    overlap = comp._default_overlap(FS, 200.0, hop)
    nbk = -(-t // block)
    span = -(-(overlap + block) // bal.BLOCK) * bal.BLOCK
    print(f"phase 24 blocked ballistics: {nbk} blocks of {block} steps a "
          f"band, overlap {overlap}: windows ({3 * nbk}, {overlap + block}) "
          f"padded to ({3 * nbk}, {span})")
    targets = {}
    for chain_name, (m, ca, cr, att0) in both.items():
        stats = {"max_att": m, "ca": ca, "cr": cr}
        targets[chain_name] = (stats, att0)
        what = f"the {chain_name} chain's targets"
        hull = bal.pass1_hull(m, ca, cr, torch.maximum(att0, m.amax(dim=1)))
        for band, st in zip(("low", "mid", "high"), bal.walk_stats(*hull)):
            print(f"phase 24 {what}, {band} band: "
                  f"{walk_line(st, hull[0].shape[1])}")
        run = {b: mb._run_ballistics_bt(stats, FS, hop, b, att0, block)
               for b in ("auto", "scan", "blocked")}
        check_bitwise(f"phase 24 {what}: comp_ballistics scan == auto",
                      run["scan"][0], run["auto"][0])
        t0 = time.perf_counter()
        plain, _ = comp.attenuation_blocked_bt(m.cpu(), ca.cpu(), cr.cpu(),
                                               block, overlap, att0.cpu())
        print(f"  the plain twins on the CPU took "
              f"{time.perf_counter() - t0:.1f} s")
        check_bitwise(f"phase 24 {what}: blocked on the kernels vs their "
                      f"plain twins", run["blocked"][0].cpu(), plain)
        d_db = (run["blocked"][0] - run["auto"][0]).abs()   # gains in dB
        d_lin = 10.0 ** (-run["blocked"][0] / 20.0) - 10.0 ** (
            -run["auto"][0] / 20.0)
        print(f"phase 24 {what}: blocked vs exact, the gains: max "
              f"{d_db.max().item():.3e} dB, rms "
              f"{d_db.pow(2).mean().sqrt().item():.3e} dB; linear rms "
              f"{d_lin.pow(2).mean().sqrt().item():.3e}")
        # printed, not held to a limit: the block-parallel approximation is
        # the JAX package's, and a band whose blocks never collapse (the
        # legacy mid band here) keeps a memory its warm-up cannot rebuild
    print("phase 24 ok", flush=True)

    # phase 25 --------------------------------------------------------------
    x_dev = torch.from_numpy(x).to(dev)
    for mbon in (False, True):
        params = MasteringParams.from_settings(settings[mbon])
        t_ms = median_of(lambda: cuda_ms(lambda: chain(x_dev, params),
                                         reps=1))
        print(f"phase 25 legacy master() multiband {mbon}: {t_ms:.3f} ms for "
              f"{SECONDS} s (x{SECONDS * 1e3 / t_ms:.0f} realtime, input on "
              f"the card; CUDA events, median of 5) ({card})")
        print(f"phase 25 profile of legacy master() multiband {mbon}:")
        by_name = profile_calls(lambda: chain(x_dev, params), calls=5)
        if mbon:
            k5 = sum(v for k, v in by_name.items() if "pam::pass1_" in k)
            print(f"phase 25 K5 (pass1_hull + pass1_runs) in the legacy "
                  f"multiband master(): {k5:.4f} ms of "
                  f"{sum(by_name.values()):.4f} ms of device time "
                  f"({100.0 * k5 / sum(by_name.values()):.1f} %; the walk "
                  f"of every step: {K5_WALK_EVERY_STEP_LEGACY_MS} of "
                  f"17.606, 61 %) ({card})")
    for chain_name, (stats, att0) in targets.items():
        for b in ("auto", "scan", "blocked"):
            by_name, wall = device_profile(
                lambda: mb._run_ballistics_bt(stats, FS, hop, b, att0,
                                              block), calls=5)
            print(f"phase 25 comp_ballistics={b} on the {chain_name} chain's "
                  f"targets {tuple(stats['max_att'].shape)}: device "
                  f"{sum(by_name.values()):.4f} ms, wall {wall:.3f} ms per "
                  f"call ({card})")
    print("phase 25 ok", flush=True)


@contextlib.contextmanager
def float32_built_eq_ops():
    """Phase 27's control: the chain's traced EQ operators built in
    float32, as the JAX chain builds them without x64, then widened to
    float64 for the states pass (the port builds them in float64)."""
    from python_audio_mastering_tpu_torch.ops import iir

    build = iir.blocked_ops_traced

    def build_f32(sos, block_size, dtype=torch.float32):
        saved, iir._STATES_DTYPE = iir._STATES_DTYPE, torch.float32
        try:
            ops = build(sos, block_size, dtype)
        finally:
            iir._STATES_DTYPE = saved
        return dataclasses.replace(ops, g=ops.g.double(), al=ops.al.double(),
                                   powers=ops.powers.double())

    iir.blocked_ops_traced = build_f32
    try:
        yield
    finally:
        iir.blocked_ops_traced = build


def automaster_phases(o, kernels, card):
    """Phases 26-30: the automaster (``models.automaster``), K1 and K4
    under autograd, on the 180 s track; ``engine.automaster_audio`` and the
    port's CLI (``o`` from :func:`main_path_operands`)."""

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles.bs1770_ref import integrated_loudness as oracle_lufs

    from python_audio_mastering_tpu_torch import (
        ChainConfig,
        MasteringParams,
        engine,
        master,
    )
    from python_audio_mastering_tpu_torch.io import wavio
    from python_audio_mastering_tpu_torch.models import automaster as am
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
    from python_audio_mastering_tpu_torch.ops.waveshaper import exciter_coefs

    x, dev = o.x, o.xrows.device
    cfg = ChainConfig.gpu_default(FS)
    gen = torch.Generator(device=dev).manual_seed(26)

    def vjp_check(what, fn, plain, args, n_out):
        """Gradients of ``fn`` (the autograd.Function) and of ``plain``
        (autograd through the plain twin) for one seeded upstream gradient:
        each within AM_VJP of its own max."""
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        ref_leaves = [a.detach().clone().requires_grad_(True) for a in args]
        outs, refs = fn(*leaves), plain(*ref_leaves)
        outs = outs if n_out > 1 else (outs,)
        refs = refs if n_out > 1 else (refs,)
        ups = [torch.randn(r.shape, generator=gen, device=dev) for r in refs]
        got = torch.autograd.grad(outs, leaves, ups)
        want = torch.autograd.grad(refs, ref_leaves, ups)
        worst = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            rel = ((g - w).abs().max() / w.abs().max()).item()
            worst = max(worst, rel)
            print(f"  {what} d(arg {i}) {tuple(w.shape)}: max |diff| / max "
                  f"|grad| {rel:.3e}")
            check(np.isfinite(rel) and rel <= AM_VJP,
                  f"{what}: gradient {i} off by {rel} > {AM_VJP}")
        return worst

    # phase 26 --------------------------------------------------------------
    # K1 with every input and slider in the graph, K4 with its signal and
    # states (the chain's K-filter operators are constants)
    coefs = [torch.tensor(c, device=dev)
             for c in exciter_coefs(o.params.saturation)]
    width = torch.tensor(float(o.params.width), device=dev)
    k1 = (o.xrows, o.s_eq, o.eq.t, o.eq.w, *coefs, width)
    for emit in (False, True):
        def fn(x_, s_, t_, w_, dry, wet, drive, wd, emit=emit):
            return cmb.front_chain(x_, s_, t_, w_, (dry, wet, drive), wd,
                                   emit_mono=emit)

        def plain(x_, s_, t_, w_, dry, wet, drive, wd, emit=emit):
            return cmb.front_chain_ref(x_, s_, t_, w_, (dry, wet, drive), wd,
                                       emit_mono=emit)

        kernels["front_chain"]["vjp_rel_err"] = max(
            kernels["front_chain"].get("vjp_rel_err", 0.0),
            vjp_check(f"phase 26 front_chain VJP emit_mono={emit}", fn, plain,
                      k1, 2 if emit else 1))
    h = K4_HOPS[0]
    kernels["kweight_cells"]["vjp_rel_err"] = vjp_check(
        f"phase 26 kweight_cells VJP h={h}",
        lambda *a: cmb.kweight_cells(*a, h),
        lambda *a: cmb.kweight_cells_ref(*a, h),
        (o.mono, o.s_kw, o.kw.t, o.kw.w), 1)
    print("phase 26 ok", flush=True)

    # phase 27 --------------------------------------------------------------
    target_params = MasteringParams.from_settings(
        {"bass_boost": 5.0, "treble_boost": -3.0, "lufs": -14.0})
    y_ref = master(x, target_params, cfg)          # no device argument
    target = am.spectral_profile(y_ref, FS)
    model = am.AutoMasterModel(config=cfg)         # no device argument
    check(model.device.type == "cuda", f"the model is on {model.device}")
    cpu64 = am.AutoMasterModel(
        config=dataclasses.replace(cfg, dtype="float64"), device="cpu")
    audio, audio64 = model.as_audio(x), cpu64.as_audio(x)
    target64 = target.double().cpu()
    rng = np.random.default_rng(27)

    def loss_grad(m, theta0, audio_, target_, dtype):
        th = torch.tensor(theta0, dtype=dtype, device=m.device,
                          requires_grad=True)
        loss = m.loss(th, audio_, target_)
        loss.backward()
        return loss.item(), th.grad.double().cpu()

    for name, theta0 in (("theta = 0", np.zeros(6)),
                         ("seeded theta", rng.standard_normal(6) * 0.5)):
        t0 = time.perf_counter()
        loss64, g64 = loss_grad(cpu64, theta0, audio64, target64,
                                torch.float64)
        t_cpu = time.perf_counter() - t0
        readings = {}
        for what, build in (("card", contextlib.nullcontext),
                            ("control", float32_built_eq_ops)):
            with build():
                loss, g = loss_grad(model, theta0, audio, target,
                                    torch.float32)
            readings[what] = (abs(loss - loss64) / loss64,
                              ((g - g64).abs().max() / g64.abs().max()).item())
            print(f"phase 27 {what} at {name}, float32 vs the port's CPU "
                  f"float64 ({t_cpu:.1f} s): loss {loss:.6f} vs "
                  f"{loss64:.6f} (|diff| / loss {readings[what][0]:.3e}); "
                  f"gradient {[round(v, 6) for v in g.tolist()]} vs "
                  f"{[round(v, 6) for v in g64.tolist()]}, max |diff| / max "
                  f"|grad| {readings[what][1]:.3e}")
            if what == "card":
                check(bool((g != 0).all()),
                      f"a gradient component is 0: {g}")
        (d_loss, d_grad), (c_loss, c_grad) = (readings["card"],
                                              readings["control"])
        limit = AM_GRAD[name]
        check(d_loss <= AM_LOSS, f"loss off by {d_loss} > {AM_LOSS}")
        check(d_grad <= limit, f"gradient off by {d_grad} > {limit}")
        if name == "theta = 0":
            check(c_grad > limit, f"the control's gradient ({c_grad}) is "
                                  f"within {limit}: the limit is blind to it")
    print("phase 27 ok", flush=True)

    # phase 28 --------------------------------------------------------------
    def fresh_step():
        th = torch.zeros(6, device=dev, requires_grad=True)
        step = am.make_train_step(model, torch.optim.Adam([th], lr=0.05))
        return lambda: step(th, audio[None], target[None])

    step = fresh_step()
    step()                                         # warm
    torch.cuda.synchronize()
    cmb.reset_launch_counts()
    step()
    torch.cuda.synchronize()
    counts, plain = cmb.launch_counts(), cmb.plain_calls()
    print(f"phase 28 one fit step (forward, backward, Adam): launches "
          f"{counts}, plain twins called {plain}")
    want = {k: 0 for k in counts}
    want.update(front_chain=1, kweight_cells=2, gain_limit=1)
    check(counts == want, f"fit step launches {counts}, expected {want}")
    check(all(v == 0 for v in plain.values()),
          f"a plain twin ran in the fit step: {plain}")
    launched = {**counts, "pass1_bnd": sum(counts[k] for k in K5_LAUNCHES)}
    for name in NO_MB_KERNELS + MB_KERNELS:
        kernels[name]["automaster_launches"] = launched[name]
    print("phase 28 ok", flush=True)

    # phase 29 --------------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        src, ref_wav, dst = (os.path.join(tmp, f) for f in
                             ("in.wav", "ref.wav", "out.wav"))
        wavio.write_wav(src, x, FS, float_format=True)
        wavio.write_wav(ref_wav, y_ref.cpu().numpy(), FS, float_format=True)
        msgs, stamps = [], []

        def cb(m):
            msgs.append(m)
            stamps.append(time.perf_counter())

        t0 = time.perf_counter()
        fitted = engine.automaster_audio(
            {"input_file": src, "reference_file": ref_wav,
             "output_file": dst, "lufs": -14.0}, cb, steps=AM_STEPS)
        wall = time.perf_counter() - t0
        check(fitted is not None, f"automaster_audio failed: {msgs[-1:]}")
        losses = [float(m.rsplit("loss ", 1)[1]) for m in msgs
                  if m.startswith("Fitting")]
        i_ref = next(i for i, m in enumerate(msgs) if m.startswith("Analyz"))
        i_master = msgs.index("Mastering with fitted settings...")
        fit_wall = stamps[i_master] - stamps[i_ref]
        out, fs_out = wavio.read_wav(dst)
        lufs_out = oracle_lufs(out.astype(np.float64).mean(axis=1), FS)
        ratio = losses[-1] / losses[0]
        sliders = {k: round(fitted[k], 3) for k in AUTOMASTER_SLIDERS}
        print(f"phase 29 automaster_audio (no device argument), {SECONDS} s, "
              f"{AM_STEPS} steps: wall {wall:.2f} s, fit {fit_wall:.2f} s "
              f"(reference profile and {len(losses)} steps); loss "
              f"{losses[0]:.5f} -> {losses[-1]:.5f} (x{ratio:.3f}); fitted "
              f"{sliders}; output {out.shape}, oracle loudness "
              f"{lufs_out:.4f} LUFS; last message {msgs[-1]!r}")
        check(len(losses) == AM_STEPS, f"{len(losses)} Fitting lines")
        check(losses[-1] < 0.8 * losses[0],
              f"loss {losses[-1]} not below 0.8 x {losses[0]}")
        check(fitted["bass_boost"] > 0.5,
              f"fitted bass_boost {fitted['bass_boost']} <= 0.5")
        check(fitted["treble_boost"] < 0.5,
              f"fitted treble_boost {fitted['treble_boost']} >= 0.5")
        check(fs_out == FS and out.shape == x.shape, "automaster output")
        check(abs(lufs_out - (-14.0)) <= 0.15,
              f"output loudness {lufs_out} not within 0.15 LU of -14")

        # the fit's step: CUDA events, the profiler, host syncs
        step = fresh_step()

        def step_ms():
            return cuda_ms(step, reps=1)

        t_step = median_of(step_ms, runs=10)
        _, syncs = count_syncs(step)
        print(f"phase 29 one fit step: {t_step:.3f} ms (CUDA events, median "
              f"of 10), {syncs} host synchronisations ({card})")
        print("phase 29 profile of one fit step:")
        profile_calls(step, calls=5, top=14)
        print("phase 29 ok", flush=True)

        # phase 30 ----------------------------------------------------------
        x_cli = x[: CLI_SECONDS * FS]
        cli_in, cli_ref = (os.path.join(tmp, f) for f in ("c.wav", "r.wav"))
        wavio.write_wav(cli_in, x_cli, FS)
        wavio.write_wav(cli_ref, y_ref[: CLI_SECONDS * FS].cpu().numpy(), FS)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

        def run_cli(*argv):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "python_audio_mastering_tpu_torch.cli",
                 *argv], cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=600)
            print(f"phase 30 cli {argv[0]} (no --device): exit "
                  f"{proc.returncode} in {time.perf_counter() - t0:.1f} s; "
                  f"last line {proc.stdout.strip().splitlines()[-1:]!r}")
            check(proc.returncode == 0,
                  f"cli {argv[0]} exit {proc.returncode}: "
                  f"{proc.stderr[-2000:]}")
            return proc.stdout

        cli_out = os.path.join(tmp, "cli.wav")
        run_cli("master", cli_in, cli_out, "--preset", "techno",
                "--saturation", "20", "--width", "1.3", "--lufs", "-14")
        eng_out = os.path.join(tmp, "eng.wav")
        check(engine.process_audio({**SETTINGS, "input_file": cli_in,
                                    "output_file": eng_out}),
              "process_audio of the CLI's input failed")
        y_cli, _ = wavio.read_wav(cli_out)
        y_eng, _ = wavio.read_wav(eng_out)
        d_cli = float(np.abs(y_cli - y_eng).max())
        print(f"phase 30 cli master vs engine.process_audio: max abs "
              f"{d_cli:.3e}")
        check(d_cli <= 3.052e-5, f"cli master vs process_audio {d_cli}")
        text = run_cli("automaster", cli_in, os.path.join(tmp, "cli_am.wav"),
                       "--reference", cli_ref, "--steps", str(CLI_STEPS))
        check(f"step {CLI_STEPS - 1}: loss" in text
              and "Processing complete!" in text, "cli automaster output")
    print("phase 30 ok", flush=True)


# sequence parallelism (phases 31-34): one process a rank, all on the card;
# the JAX package's fast-mode SP budget (tests/test_sequence.py:33-34)
SP_SECONDS = 600
SP_APPROX_RMS, SP_APPROX_MAX = 4e-3, 0.1
SP_ALBUM_SECONDS = 180
SP_ALBUM_SEEDS = (40, 41, 42, 43)
SP_COUNTED = NO_MB_KERNELS + MB_COUNTED
# run: (settings, ChainConfig fields, sp_ballistics, return_meters)
SP_RUNS = {
    "off": (SETTINGS, {}, "approx", False),
    "approx": (MB_SETTINGS, {}, "approx", False),
    "exact": (MB_SETTINGS, {}, "exact", False),
    "quality": (SETTINGS, {"limiter_mode": "lookahead_truepeak"}, "approx",
                False),
    "legacy": (SETTINGS, {"variant": "legacy"}, "approx", False),
    "quality_mb": (MB_SETTINGS, {"limiter_mode": "lookahead_truepeak"},
                   "approx", False),
    "meters": (SETTINGS, {}, "approx", True),
    "album": (MB_SETTINGS, {}, "exact", False),
}
# D ranks -> the runs of its launch; the first multiband run is profiled
SP_PLAN = {1: ("off", "approx", "exact"),
           2: ("off", "approx", "exact", "quality", "quality_mb", "legacy",
               "meters"),
           4: ("off", "approx", "exact", "album")}
# the plain twin of each kernel the SP path launches, and whether its limit
# (phases 2, 3, 7 and 8's 1e-4) is relative to max |plain|
SP_PLAIN = {"front_chain": ("front_chain_ref", False),
            "kweight_cells": ("kweight_cells_ref", True),
            "band_energies": ("band_energies_ref", True),
            "band_gain_apply": ("band_gain_apply_ref", True)}
SP_BALLISTICS = ("ballistics_rates_bt", "attenuation_blocked_bt")
# the meters run against master_streamed's meters, each limit between the
# sound runs' largest reading and its control's (600 s, D = 2, H100; PERF.md,
# my chip runs): measured (the cells' gated loudness, LU; reads 0) and the
# integrated meter (measured + gain_db, the target on both sides; 7.0e-9)
# against the K-filter's shard-incoming state dropped (1.14e-5, 4.8e-7):
# 2 float32 ulps at 16-32 LU, and under the control for the second; the
# series (3.8e-6) and LRA (0, at most twice the series' reading) against
# their running sum in float32 (9.4e-3, 7.0e-5); the true peak (0 dB)
# within what the output's 2e-4 allows at full scale, against the sample
# peak (1.5 dB).  The windows across a shard boundary dropped are printed:
# LRA reads them at 7.6e-6 only, the series' length shows them
SP_METER_LIMITS = {"measured": 4e-6, "integrated_lufs": 2e-7,
                   "series": 2e-5, "lra_lu": 2e-5, "true_peak_dbtp": 1.7e-3}
SP_METER_CONTROLS = {"measured": "shard K-state dropped",
                     "integrated_lufs": "shard K-state dropped",
                     "series": "float32 running sum",
                     "lra_lu": "float32 running sum",
                     "true_peak_dbtp": "sample peak"}


def sp_reference(name, x, params, cfg):
    """Rank 0's reference of a run, on the card: the one-shot master()
    (the legacy run: master_streamed, whose worker EQ behind the legacy
    saturation the SP body shares; the meters run: master_streamed with
    its meters)."""
    from python_audio_mastering_tpu_torch import master
    from python_audio_mastering_tpu_torch.parallel.streaming import (
        master_streamed,
    )

    if name in ("legacy", "meters"):
        res = master_streamed(x, params, cfg, return_meters=name == "meters")
        return res[0], res[1], res[3] if name == "meters" else None
    r = master(x, params, cfg, return_result=True)
    return r.audio.cpu().numpy(), float(r.measured_lufs), None


def sp_check(name, y, measured, ref, oracle_lufs, extra=""):
    """Rank 0's checks of one output against its reference (the limits
    of the module docstring); returns the printed summary."""
    y_ref, m_ref, _ = ref
    check(y.shape == y_ref.shape, f"{name}: shape {y.shape}")
    check(bool(np.isfinite(y).all()), f"{name}: non-finite output")
    d = np.abs(y - y_ref)
    d_max, d_rms = float(d.max()), float(np.sqrt(np.mean(d ** 2)))
    d_lu = abs(measured - m_ref)
    peak = float(np.abs(y).max())
    lufs_out = oracle_lufs(y.astype(np.float64).mean(axis=1), FS)
    line = (f"max abs {d_max:.3e}, rms {d_rms:.3e}, |dLU| {d_lu:.3e}, "
            f"peak {peak:.6f}, oracle {lufs_out:.4f} LUFS{extra}")
    # the lookahead limiter trades loudness for its ceiling (phase 15)
    quality = name.startswith("quality")
    check(quality or abs(lufs_out - SETTINGS["lufs"]) <= 0.15,
          f"{name}: output loudness {lufs_out} not within 0.15 LU of -14")
    if name.startswith("album") or name == "exact":
        limits = (MB_MAX, MB_RMS, 1e-3)
    elif name in ("approx", "quality_mb"):
        limits = (SP_APPROX_MAX, SP_APPROX_RMS, None)
    else:
        limits = (2e-4, None, 1e-3)
    check(d_max < limits[0], f"{name}: max abs {d_max} >= {limits[0]}")
    check(limits[1] is None or d_rms < limits[1],
          f"{name}: rms {d_rms} >= {limits[1]}")
    check(limits[2] is None or d_lu < limits[2],
          f"{name}: |dLU| {d_lu} >= {limits[2]}")
    if quality:
        check(peak <= CEILING * (1 + 1e-6), f"quality: peak {peak} over the "
                                            f"ceiling")
    else:
        check(peak <= 1.0, f"{name}: |y| max {peak} > 1")
    return line


@contextlib.contextmanager
def sp_recording(captured, where=None):
    """Record every call of the SP path's kernel wrappers (K1 as the
    chain's front calls it, K4 as the rows meter does, K2 and K3 as
    ``parallel.sequence`` does) and of its ballistics entry points, or of
    the wrappers ``where`` names (``{name: the module that calls it}``):
    ``captured`` gets ``(name, the real function, args, kwargs, out)``."""
    from python_audio_mastering_tpu_torch.models import chain as chain_mod
    from python_audio_mastering_tpu_torch.ops import loudness
    from python_audio_mastering_tpu_torch.parallel import sequence

    if where is None:
        where = {"front_chain": chain_mod, "kweight_cells": loudness,
                 **{k: sequence for k in ("band_energies", "band_gain_apply",
                                          *SP_BALLISTICS)}}
    saved = {name: getattr(mod, name) for name, mod in where.items()}

    def recorder(name, real):
        def call(*args, **kw):
            out = real(*args, **kw)
            captured.append((name, real, args, kw, out))
            return out
        return call

    for name, mod in where.items():
        setattr(mod, name, recorder(name, saved[name]))
    try:
        yield captured
    finally:
        for name, mod in where.items():
            setattr(mod, name, saved[name])


def sp_hold(captured, rank):
    """Hold what the SP path's kernels returned against their plain twins
    on the same operands: K1-K4 on the card within phases 2, 3, 7 and 8's
    1e-4, the ballistics (K5-K7 through ``ballistics_rates_bt``, K5/K6
    rows through ``attenuation_blocked_bt``) bitwise on the CPU.  Fails on
    any miss.  Returns ``({kernel: (input shapes, max abs)}, [(entry
    point, targets shape)])``."""
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb

    def cpu(v):
        return v.cpu() if torch.is_tensor(v) else v

    errs, bitwise = {}, []
    for name, real, args, kw, out in captured:
        shape = tuple(args[0].shape)
        if name in SP_PLAIN:
            plain, rel = SP_PLAIN[name]
            ref = getattr(cmb, plain)(*args, **kw)
            pairs = zip(*((v,) if torch.is_tensor(v) else v
                          for v in (out, ref)))
            for a, b in pairs:
                mx, top = (a - b).abs().max().item(), b.abs().max().item()
                val = mx / top if rel and top > 0 else mx
                check(np.isfinite(val) and val <= 1e-4,
                      f"rank {rank}: SP {name} {shape} vs {plain}: {val}")
                shapes, e = errs.get(name, ([], 0.0))
                errs[name] = (shapes + [shape] * (shape not in shapes),
                              max(e, mx))
        else:
            plain = real(*map(cpu, args), **{k: cpu(v) for k, v in kw.items()})
            same = all(torch.equal(a.cpu(), b) for a, b in zip(out, plain))
            check(same, f"rank {rank}: SP {name} {shape} not bitwise its "
                        f"plain twins on the CPU")
            bitwise.append((name, shape))
    return errs, bitwise


def sp_sliding_f32(cell_ms, k):
    """``ops.meters._sliding_loudness`` with its running sum in float32:
    the series control."""
    from python_audio_mastering_tpu_torch.ops import meters as met
    from python_audio_mastering_tpu_torch.ops.loudness import channel_weights

    csum = torch.nn.functional.pad(torch.cumsum(cell_ms.float(), dim=0),
                                   (0, 0, 1, 0))
    win = (csum[k:] - csum[:-k]) / k
    w = channel_weights(cell_ms.shape[1], dtype=win.dtype, device=win.device)
    return met._LOUDNESS_OFFSET + 10.0 * torch.log10(
        torch.clamp_min(win @ w, float(np.finfo(np.float32).tiny)))


def sp_meter_readings(got, measured, want, m_want):
    """``{meter: |got - want|}``, the series as their max."""
    out = {"measured": abs(measured - m_want)}
    for k in ("integrated_lufs", "lra_lu", "true_peak_dbtp"):
        if k in got:
            out[k] = abs(got[k] - want[k])
    if "short_term_lufs" in got:
        out["series"] = max(float(np.abs(got[k] - want[k]).max())
                            for k in ("momentary_lufs", "short_term_lufs"))
    return out


def sp_meters(res, ref, meter_in, ctrl, shard_cells):
    """Rank 0's meters checks: the SP run's meters and measured loudness
    against master_streamed's within SP_METER_LIMITS, and each limit's
    control above it.  ``meter_in``: what the SP run handed
    ``_meters_dict`` (the gathered cells scaled by gain², ...); ``ctrl``:
    the run again with the K-filter's shard-incoming state dropped;
    ``shard_cells``: cells a shard.  Returns the printed summary."""
    from python_audio_mastering_tpu_torch.ops import meters as met

    want, m_want = ref[2], ref[1]
    sound = sp_meter_readings(res[3], res[1], want, m_want)
    cells, _, _, _, n, cell = meter_in
    valid = cells[: n // cell]
    st32 = sp_sliding_f32(valid, 30)
    f32 = {"momentary_lufs": sp_sliding_f32(valid, 4).cpu().numpy(),
           "short_term_lufs": st32.cpu().numpy()}
    st_local = torch.cat([met._sliding_loudness(valid[i:i + shard_cells], 30)
                          for i in range(0, valid.shape[0], shard_cells)])
    peak = float(np.abs(res[0]).max())
    controls = {
        "shard K-state dropped": sp_meter_readings(ctrl[3], ctrl[1], want,
                                                   m_want),
        "float32 running sum": {
            "series": sp_meter_readings(f32, res[1], want, m_want)["series"],
            "lra_lu": abs(float(met.lra_from_shortterm(st32))
                          - want["lra_lu"])},
        "boundary windows dropped": {
            "lra_lu": abs(float(met.lra_from_shortterm(st_local))
                          - want["lra_lu"])},
        "sample peak": {"true_peak_dbtp": abs(
            20.0 * np.log10(peak) - want["true_peak_dbtp"])},
    }
    line = ("; meters vs master_streamed: "
            + ", ".join(f"{k} {v:.3e}" for k, v in sound.items())
            + "; controls: " + "; ".join(
                f"{c} " + ", ".join(f"{k} {v:.3e}" for k, v in r.items())
                for c, r in controls.items()))
    for k, lim in SP_METER_LIMITS.items():
        check(sound[k] < lim, f"meters: {k} {sound[k]} >= {lim}{line}")
        c = SP_METER_CONTROLS[k]
        check(controls[c][k] > lim, f"meters: the control {c!r} reads {k} "
                                    f"{controls[c][k]} <= {lim}: the limit "
                                    f"cannot see it{line}")
    return line


def sp_rank(plan):
    """One rank of phases 31-33: every run of ``plan`` through the port's
    SP entry points (no device argument: the card), each timed on the
    host and by CUDA events, its launches, plain-twin calls and the
    collectives' host time (the mesh's ``collective/*`` spans) counted;
    every rank holds what its kernels returned against their plain twins
    on the same operands (``sp_hold``), and rank 0 checks each output
    against its reference on the card.  Returns one record a run."""
    import hashlib

    import torch.distributed as dist

    from python_audio_mastering_tpu_torch import ChainConfig, MasteringParams
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
    from python_audio_mastering_tpu_torch.parallel import sequence
    from python_audio_mastering_tpu_torch.utils import tracing

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles.bs1770_ref import integrated_loudness as oracle_lufs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rank, d = dist.get_rank(), dist.get_world_size()
    x = make_signal(SP_SECONDS * FS, FS, seed=0)
    tracks = [make_signal(SP_ALBUM_SECONDS * FS, FS, seed=s)
              for s in SP_ALBUM_SEEDS]
    # warm: the first call builds the library's state, cuBLAS and the
    # collectives' paths
    sequence.master_track_sharded(x[:10 * FS], MasteringParams.from_settings(
        SETTINGS), ChainConfig.gpu_default(FS))
    records = []
    profiled = False
    for name in plan:
        settings, fields, sp, meters = SP_RUNS[name]
        params = MasteringParams.from_settings(settings)
        cfg = dataclasses.replace(ChainConfig.gpu_default(FS), **fields)
        if name == "album":
            def call():
                return sequence.master_album_sharded(tracks, params, cfg,
                                                     sp_ballistics=sp)
        else:
            def call():
                return sequence.master_track_sharded(
                    x, params, cfg, sp_ballistics=sp, return_meters=meters)
        captured, meter_in = [], []
        real_md = sequence._meters_dict

        def md(*args):
            meter_in.extend(args)
            return real_md(*args)

        sequence._meters_dict = md
        cmb.reset_launch_counts()
        torch.cuda.synchronize()
        dist.barrier()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with sp_recording(captured), tracing.recording(), \
                tracing.span(name, sync=torch.cuda.synchronize) as timed:
            ev[0].record()
            res = call()
            ev[1].record()
        sequence._meters_dict = real_md
        wall = timed["dur_ms"]
        spans = [r["dur_ms"] for r in tracing.get_trace()
                 if r["name"].startswith(f"{name}/collective/")]
        outs = res[0] if name == "album" else [res[0]]
        rec = {"run": name, "rank": rank, "launches": cmb.launch_counts(),
               "plain": cmb.plain_calls(), "wall_ms": wall,
               "event_ms": ev[0].elapsed_time(ev[1]),
               "collective_ms": sum(spans), "collectives": len(spans),
               "digest": hashlib.sha1(b"".join(
                   np.ascontiguousarray(o).tobytes() for o in outs))
               .hexdigest()}
        rec["held"], rec["bitwise"] = sp_hold(captured, rank)
        del captured[:]
        ctrl = None
        if meters:
            # the control: the K-filter's shard-incoming state dropped
            real_bce = sequence.block_cell_energies_rows
            sequence.block_cell_energies_rows = (
                lambda meter, fs, zi=None, **kw: real_bce(meter, fs, **kw))
            try:
                ctrl = call()
            finally:
                sequence.block_cell_energies_rows = real_bce
        if rank == 0:
            if name == "album":
                rec["check"] = [
                    sp_check(f"album track {i}", o, float(res[1][i]),
                             sp_reference("album", t, params, cfg),
                             oracle_lufs)
                    for i, (o, t) in enumerate(zip(outs, tracks))]
            else:
                ref = sp_reference(name, x, params, cfg)
                extra = ""
                if meters:
                    align = sequence._align(cfg, d, True)
                    n_pad = -(-x.shape[0] // align) * align
                    extra = sp_meters(res, ref, meter_in, ctrl,
                                      n_pad // d // meter_in[5])
                rec["check"] = [sp_check(name, res[0], res[1], ref,
                                         oracle_lufs, extra)]
        if not profiled and SP_RUNS[name][0].get("multiband"):
            # rank 0's device time and idle share of one more call
            profiled = True
            if rank == 0:
                by_name, prof_wall = device_profile(call, 1)
                rec["device_ms"] = sum(by_name.values())
                rec["profile_wall_ms"] = prof_wall
                rec["top"] = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            else:
                call()
                call()
        records.append(rec)
    return records


def sp_rows_body(name):
    """Whether a run takes the rows body (worker + reference limiter)."""
    fields = SP_RUNS[name][1]
    return (fields.get("variant", "worker") == "worker"
            and fields.get("limiter_mode", "reference") == "reference")


def sp_phases(kernels, card):
    """Phases 31-34: ``master_track_sharded`` on the 600 s track at D = 1
    (NCCL), 2 and 4 (gloo, the ranks sharing the card) and
    ``master_album_sharded`` on a 2 x 2 mesh, through
    ``parallel.mesh.launch`` (see the module docstring)."""
    from python_audio_mastering_tpu_torch.parallel.mesh import launch

    table = []
    for phase, d in ((31, 1), (32, 2), (33, 4)):
        t0 = time.perf_counter()
        ranks = launch(sp_rank, d, (SP_PLAN[d],), devices=["cuda:0"] * d)
        backend = "nccl" if d == 1 else "gloo"
        print(f"phase {phase} D={d} ({backend}, one card): launch "
              f"{time.perf_counter() - t0:.1f} s")
        for k, name in enumerate(SP_PLAN[d]):
            recs = [r[k] for r in ranks]
            for rec in recs:
                held = {n: f"{v[1]:.2e} at {v[0]}"
                        for n, v in rec["held"].items()}
                print(f"  {name} rank {rec['rank']}: wall "
                      f"{rec['wall_ms']:.1f} ms (host), "
                      f"{rec['event_ms']:.1f} ms (CUDA events), collectives "
                      f"{rec['collective_ms']:.1f} ms host in "
                      f"{rec['collectives']}; launches {rec['launches']}; "
                      f"plain twins {rec['plain']}; vs plain twins (max abs)"
                      f" {held}; bitwise {rec['bitwise']}")
            for i, line in enumerate(recs[0].get("check", [])):
                what = f"{name} track {i}" if name == "album" else name
                print(f"  {what} rank 0 vs its reference on the card: {line}")
            if "device_ms" in recs[0]:
                dev_ms, wall = recs[0]["device_ms"], recs[0]["profile_wall_ms"]
                print(f"  {name} rank 0 profile: device {dev_ms:.2f} ms, wall "
                      f"{wall:.1f} ms, device idle "
                      f"{100.0 * (1 - dev_ms / wall):.1f} % ({card})")
                for act, ms in recs[0]["top"]:
                    print(f"    {ms:9.3f} ms  {act[:90]}")
            check(len({r["digest"] for r in recs}) == 1,
                  f"D={d} {name}: the ranks returned different audio")
            multiband = SP_RUNS[name][0].get("multiband")
            if sp_rows_body(name):
                want = SP_COUNTED if multiband else NO_MB_KERNELS
                held = tuple(SP_PLAIN) if multiband else NO_MB_KERNELS
                entries = {"ballistics_rates_bt"} if multiband else set()
            else:
                want = (*K5_LAUNCHES, "replay") if multiband else ()
                held = ()
                entries = set(SP_BALLISTICS) if multiband else set()
            for rec in recs:
                missing = [k for k in want if rec["launches"][k] == 0]
                check(not missing, f"D={d} {name} rank {rec['rank']}: "
                                   f"{missing} not launched")
                check(all(v == 0 for v in rec["plain"].values()),
                      f"D={d} {name}: a plain twin ran: {rec['plain']}")
                unheld = [k for k in held if k not in rec["held"]]
                unheld += sorted(entries - {e for e, _ in rec["bitwise"]})
                check(not unheld, f"D={d} {name} rank {rec['rank']}: "
                                  f"{unheld} not held to a plain twin")
            table.append((d, name, recs))
        print(f"phase {phase} ok", flush=True)

    # phase 34 --------------------------------------------------------------
    print(f"phase 34 SP walls on one card ({card}); D ranks share its SMs, "
          f"so these are the machinery's cost, not a scaling:")
    def each(recs, key):
        return ", ".join(f"{r[key]:.1f}" for r in recs)

    for d, name, recs in table:
        print(f"  D={d} {name}: host wall max over ranks "
              f"{max(r['wall_ms'] for r in recs):.1f} ms, CUDA events "
              f"{each(recs, 'event_ms')} ms, collectives "
              f"{each(recs, 'collective_ms')} ms host")
    main_run = next(recs for d, name, recs in table
                    if d == 2 and name == "approx")
    counts = main_run[0]["launches"]
    launched = {**counts, "pass1_bnd": sum(counts[k] for k in K5_LAUNCHES)}
    for name in NO_MB_KERNELS + MB_KERNELS:
        kernels[name]["sp_launches"] = launched[name]
    for name in SP_PLAIN:
        kernels[name]["sp_max_abs_err"] = max(
            r["held"][name][1] for _, _, recs in table for r in recs
            if name in r["held"])
    print("phase 34 ok", flush=True)


# data parallelism (phases 35-38): the album's tracks and the automaster's
# batch sharded over ranks, one process a rank through parallel.mesh.launch
DP_SECONDS = (180, 171, 162, 153, 144)
DP_SEEDS = (50, 51, 52, 53, 54)
DP_STOP_AFTER = 3          # phase 36 interrupts each rank after this chunk
DP_METERS = 1e-3           # meters against the one-card album's
AM_DP_STEPS = 10
AM_DP_LR = 0.05
AM_DP_SEED = 55            # phase 37's second track
AM_DP_THETA = 1e-4         # D = 2's theta against D = 1's
# D ranks -> the runs of its launch
DP_PLAN = {1: ("album_off", "album_on", "automaster"),
           2: ("album_off", "album_on", "streamed", "automaster"),
           4: ("album_off", "album_on")}
DP_RUNS = {"album_off": SETTINGS, "album_on": MB_SETTINGS,
           "streamed": MB_SETTINGS}


def dp_where():
    """Where the album path calls its kernel wrappers (for
    ``sp_recording``): K1 from the chain's front, K4 from the loudness
    cells, K2, K3 and the ballistics from the multiband compressor."""
    from python_audio_mastering_tpu_torch.models import chain as chain_mod
    from python_audio_mastering_tpu_torch.ops import loudness, multiband

    return {"front_chain": chain_mod, "kweight_cells": loudness,
            **{k: multiband for k in ("band_energies", "band_gain_apply",
                                      "ballistics_rates_bt")}}


def dp_tracks():
    return [make_signal(sec * FS, FS, seed=s)
            for sec, s in zip(DP_SECONDS, DP_SEEDS)]


def dp_digest(outs):
    import hashlib

    return hashlib.sha1(b"".join(np.ascontiguousarray(o).tobytes()
                                 for o in outs)).hexdigest()


def dp_check(name, outs, measured, ref_dir, oracle_lufs):
    """Rank 0's checks of an album run against the one-card album saved
    in ``ref_dir``: each track within phase 10's limits with multiband
    (2e-4 max and 1e-3 LU without), the loudness against the one card's
    measured (the oracle's reading of both outputs for ``master_album``,
    which returns none), the oracle within 0.15 LU of -14.  Returns the
    printed lines."""
    ref = np.load(os.path.join(ref_dir, f"{name}.npz"))
    mb = DP_RUNS[name].get("multiband", False)
    limits = (MB_MAX, MB_RMS, 1e-3) if mb else (2e-4, None, 1e-3)
    lines = []
    for i, y in enumerate(outs):
        y_ref = ref[f"y{i}"]
        check(y.shape == y_ref.shape, f"{name} track {i}: shape {y.shape}")
        check(bool(np.isfinite(y).all()), f"{name} track {i}: non-finite")
        d = np.abs(y - y_ref)
        d_max, d_rms = float(d.max()), float(np.sqrt(np.mean(d ** 2)))
        lufs = oracle_lufs(y.astype(np.float64).mean(axis=1), FS)
        d_lu = abs((measured[i] if measured is not None else lufs)
                   - float(ref["measured"][i]))
        peak = float(np.abs(y).max())
        lines.append(f"track {i} ({y.shape[0] / FS:.0f} s): max abs "
                     f"{d_max:.3e} (bitwise {np.array_equal(y, y_ref)}), rms "
                     f"{d_rms:.3e}, |dLU| {d_lu:.3e}, oracle {lufs:.4f} LUFS,"
                     f" peak {peak:.6f}")
        check(d_max < limits[0], f"{name} track {i}: max abs {d_max}")
        check(limits[1] is None or d_rms < limits[1],
              f"{name} track {i}: rms {d_rms}")
        check(d_lu < limits[2], f"{name} track {i}: |dLU| {d_lu}")
        check(abs(lufs - SETTINGS["lufs"]) <= 0.15,
              f"{name} track {i}: oracle loudness {lufs}")
        check(peak <= 1.0, f"{name} track {i}: |y| max {peak} > 1")
    return lines


def dp_automaster(rank):
    """Phase 37 on one rank: AM_DP_STEPS Adam steps with a shared theta
    over phase 26's track (fitted to itself mastered with bass +5 / treble
    -3 dB) and a second seeded track, the batch sharded over the ranks
    (``make_train_step(mesh=)``; on one rank both tracks fold into one
    chain call).  Every step's launches, wall, CUDA-event time and the
    psum's host time."""
    from python_audio_mastering_tpu_torch import (
        ChainConfig,
        MasteringParams,
        master,
    )
    from python_audio_mastering_tpu_torch.models import automaster as am
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
    from python_audio_mastering_tpu_torch.parallel.mesh import make_mesh
    from python_audio_mastering_tpu_torch.utils import tracing

    cfg = ChainConfig.gpu_default(FS)
    target_params = MasteringParams.from_settings(
        {"bass_boost": 5.0, "treble_boost": -3.0, "lufs": -14.0})
    model = am.AutoMasterModel(config=cfg)
    tracks = [make_signal(SECONDS * FS, FS, seed=s) for s in (0, AM_DP_SEED)]
    batch_ = torch.stack([model.as_audio(t) for t in tracks])
    targets = torch.stack([am.spectral_profile(master(t, target_params, cfg),
                                               FS) for t in tracks])
    theta = torch.zeros(6, device=batch_.device, requires_grad=True)
    step = am.make_train_step(model, torch.optim.Adam([theta], lr=AM_DP_LR),
                              shared=True, mesh=make_mesh())
    out = {"losses": [], "wall_ms": [], "event_ms": [], "psum_ms": [],
           "launches": [], "plain": []}
    for _ in range(AM_DP_STEPS):
        cmb.reset_launch_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with tracing.recording(), \
                tracing.span("step", sync=torch.cuda.synchronize) as timed:
            ev[0].record()
            loss = step(theta, batch_, targets)
            ev[1].record()
        out["losses"].append(float(loss))
        out["wall_ms"].append(timed["dur_ms"])
        out["event_ms"].append(ev[0].elapsed_time(ev[1]))
        out["psum_ms"].append(sum(r["dur_ms"] for r in tracing.get_trace()
                                  if r["name"] == "step/collective/psum"))
        out["launches"].append(cmb.launch_counts())
        out["plain"].append(cmb.plain_calls())
    out["theta"] = theta.detach().cpu().numpy()
    out["rank"] = rank
    return out


def dp_rank(plan, ref_dir):
    """One rank of phases 35-37: the album runs of ``plan`` through
    ``parallel.batch`` (no mesh and no device argument: ``make_mesh()``
    over the launched ranks, each on the card), its launches and
    plain-twin calls counted, what K1-K7 returned held against their
    plain twins (``sp_hold``), rank 0 checking the outputs against the
    one-card album in ``ref_dir``, then run again unrecorded (bitwise the
    same) and timed on the host and by CUDA events with the collectives'
    host time; the streamed run also interrupted and resumed from its
    checkpoints; and the automaster's steps.  Returns one record a run."""
    import pickle

    import torch.distributed as dist

    from python_audio_mastering_tpu_torch import ChainConfig, MasteringParams
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
    from python_audio_mastering_tpu_torch.parallel import batch
    from python_audio_mastering_tpu_torch.utils import tracing

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles.bs1770_ref import integrated_loudness as oracle_lufs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rank, d = dist.get_rank(), dist.get_world_size()
    tracks = dp_tracks()
    cfg = ChainConfig.gpu_default(FS)
    # warm: operators, cuBLAS and the collectives' paths
    batch.master_album([t[:10 * FS] for t in tracks[:d]],
                       MasteringParams.from_settings(MB_SETTINGS), cfg)
    records = {}
    for name in plan:
        if name == "automaster":
            records[name] = dp_automaster(rank)
            continue
        params = MasteringParams.from_settings(DP_RUNS[name])
        timings, done = {}, []
        if name == "streamed":
            def call(**kw):
                return batch.master_album_streamed(
                    tracks, params, cfg, transfer="pcm16",
                    return_meters=True, **kw)
            kw = {"timings": timings, "on_track_done": lambda i, a, m:
                  done.append((i, a.shape[0], m is not None))}
        else:
            def call(**kw):
                return batch.master_album(tracks, params, cfg, **kw)
            kw = {}
        captured = []
        cmb.reset_launch_counts()
        torch.cuda.synchronize()
        dist.barrier()
        with sp_recording(captured, dp_where()):
            res = call(**kw)
        outs, measured = (res[0], res[1]) if name == "streamed" else (res,
                                                                      None)
        rec = {"run": name, "rank": rank, "launches": cmb.launch_counts(),
               "plain": cmb.plain_calls(), "digest": dp_digest(outs),
               "done": sorted(done)}
        rec["held"], rec["bitwise"] = sp_hold(captured, rank)
        del captured[:]
        # timed again, unrecorded: the recording holds every operand
        timings.clear()
        torch.cuda.synchronize()
        dist.barrier()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with tracing.recording(), \
                tracing.span(name, sync=torch.cuda.synchronize) as timed:
            ev[0].record()
            again = call(timings=timings) if name == "streamed" else call()
            ev[1].record()
        spans = [r["dur_ms"] for r in tracing.get_trace()
                 if r["name"].startswith(f"{name}/collective/")]
        rec.update(wall_ms=timed["dur_ms"],
                   event_ms=ev[0].elapsed_time(ev[1]),
                   collective_ms=sum(spans), collectives=len(spans),
                   timings=dict(timings),
                   repeat_bitwise=dp_digest(again[0] if name == "streamed"
                                            else again) == rec["digest"])
        if rank == 0:
            rec["check"] = dp_check(name, outs, measured, ref_dir,
                                    oracle_lufs)
        if name == "streamed":
            if rank == 0:
                with open(os.path.join(ref_dir, "streamed_meters.pkl"),
                          "rb") as f:
                    want = pickle.load(f)
                worst = 0.0
                for got_m, want_m in zip(res[2], want, strict=True):
                    for k, v in want_m.items():
                        worst = max(worst, float(np.max(np.abs(
                            np.asarray(got_m[k]) - np.asarray(v)))))
                rec["meters_err"] = worst
                check(worst <= DP_METERS, f"streamed meters off by {worst}")

            class Stop(Exception):
                pass

            def stop(msg):
                if msg.startswith(f"Processed chunk {DP_STOP_AFTER}/"):
                    raise Stop(msg)

            ckpt = os.path.join(ref_dir, "ckpt")
            try:
                call(checkpoint_dir=ckpt, progress_cb=stop)
                check(False, "the checkpointed run was not interrupted")
            except Stop:
                pass
            resumed = call(checkpoint_dir=ckpt)
            rec["resumed_bitwise"] = (
                dp_digest(resumed[0]) == rec["digest"]
                and np.array_equal(resumed[1], measured))
        records[name] = rec
    return records


def dp_phases(kernels, card):
    """Phases 35-37: the album (``master_album``, multiband off and on) at
    D = 1 (NCCL), 2 and 4 (gloo, the ranks sharing the card), the streamed
    album with pcm16, meters, on_track_done and a checkpoint resume at
    D = 2, and the automaster's shared theta at D = 1 and 2, through
    ``parallel.mesh.launch``; every rank's kernels held to their plain
    twins, every rank's outputs the same, rank 0's against the one-card
    album (see the module docstring)."""
    import pickle
    import shutil

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles.bs1770_ref import integrated_loudness as oracle_lufs

    from python_audio_mastering_tpu_torch import ChainConfig, MasteringParams
    from python_audio_mastering_tpu_torch.parallel import batch
    from python_audio_mastering_tpu_torch.parallel.mesh import launch

    cfg = ChainConfig.gpu_default(FS)
    tracks = dp_tracks()
    ref_dir = tempfile.mkdtemp(prefix="pam_dp_")
    one = {}
    try:
        for name, settings in DP_RUNS.items():
            params = MasteringParams.from_settings(settings)
            if name == "streamed":
                def call():
                    return batch.master_album_streamed(
                        tracks, params, cfg, transfer="pcm16",
                        return_meters=True)
            else:
                def call():
                    return batch.master_album(tracks, params, cfg)
            call()                                  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = call()
            one[name] = (time.perf_counter() - t0) * 1e3
            outs = res[0] if name == "streamed" else res
            measured = (res[1] if name == "streamed" else
                        [oracle_lufs(y.astype(np.float64).mean(axis=1), FS)
                         for y in outs])
            np.savez(os.path.join(ref_dir, f"{name}.npz"), measured=measured,
                     **{f"y{i}": y for i, y in enumerate(outs)})
            if name == "streamed":
                with open(os.path.join(ref_dir, "streamed_meters.pkl"),
                          "wb") as f:
                    pickle.dump(res[2], f)
        print(f"phase 35 {len(tracks)} tracks of {DP_SECONDS} s, seeds "
              f"{DP_SEEDS}; the one-card album (no mesh) as the reference: "
              + ", ".join(f"{k} {v:.1f} ms" for k, v in one.items())
              + f" ({card})", flush=True)
        table = {}
        for d in (1, 2, 4):
            t0 = time.perf_counter()
            ranks = launch(dp_rank, d, (DP_PLAN[d], ref_dir),
                           devices=["cuda:0"] * d)
            backend = "nccl" if d == 1 else "gloo"
            print(f"phases 35-37 D={d} ({backend}, one card): launch "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            table[d] = {name: [r[name] for r in ranks] for name in DP_PLAN[d]}
            shutil.rmtree(os.path.join(ref_dir, "ckpt"), ignore_errors=True)
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)

    for phase, names in ((35, ("album_off", "album_on")), (36, ("streamed",))):
        for d in (1, 2, 4):
            for name in names:
                if name not in table[d]:
                    continue
                dp_report(phase, d, name, table[d][name], card)
        print(f"phase {phase} ok", flush=True)

    # phase 37 --------------------------------------------------------------
    thetas = {}
    for d in (1, 2):
        recs = table[d]["automaster"]
        for rec in recs:
            for k, (counts, plain) in enumerate(zip(rec["launches"],
                                                    rec["plain"])):
                want = {n: 0 for n in counts}
                want.update(front_chain=1, kweight_cells=2, gain_limit=1)
                check(counts == want, f"D={d} rank {rec['rank']} step {k}: "
                                      f"launches {counts}, expected {want}")
                check(all(v == 0 for v in plain.values()),
                      f"D={d} step {k}: a plain twin ran: {plain}")
            med = statistics.median
            print(f"phase 37 D={d} rank {rec['rank']}: losses "
                  f"{rec['losses'][0]:.5f} -> {rec['losses'][-1]:.5f}; step "
                  f"wall median {med(rec['wall_ms'][1:]):.2f} ms (first "
                  f"{rec['wall_ms'][0]:.2f}), CUDA events median "
                  f"{med(rec['event_ms'][1:]):.2f} ms, psum host median "
                  f"{med(rec['psum_ms'][1:]):.3f} ms; launches a step "
                  f"{rec['launches'][-1]} ({card})")
            check(rec["losses"][-1] < rec["losses"][0],
                  f"D={d}: the loss did not fall: {rec['losses']}")
        for rec in recs[1:]:
            check(np.array_equal(rec["theta"], recs[0]["theta"]),
                  f"D={d}: theta differs across ranks")
            check(rec["losses"] == recs[0]["losses"],
                  f"D={d}: the loss differs across ranks")
        thetas[d] = recs[0]["theta"]
    d_theta = float(np.abs(thetas[2] - thetas[1]).max())
    print(f"phase 37 theta bitwise across ranks; D=2 vs D=1 max |dtheta| "
          f"{d_theta:.3e} (theta {np.array2string(thetas[2], precision=5)})")
    check(d_theta <= AM_DP_THETA, f"D=2 theta {d_theta} from D=1's")
    print("phase 37 ok", flush=True)

    counts = table[2]["album_on"][0]["launches"]
    launched = {**counts, "pass1_bnd": sum(counts[k] for k in K5_LAUNCHES)}
    for name in NO_MB_KERNELS + MB_KERNELS:
        kernels[name]["dp_launches"] = launched[name]


def dp_report(phase, d, name, recs, card):
    """Print one album run's ranks and check them (see dp_phases)."""
    mb = DP_RUNS[name].get("multiband", False)
    want = SP_COUNTED if mb else NO_MB_KERNELS
    held = tuple(SP_PLAIN) if mb else NO_MB_KERNELS
    for rec in recs:
        held_err = {n: f"{v[1]:.2e} at {v[0]}" for n, v in rec["held"].items()}
        t = rec["timings"]
        legs = (f"; upload {t['h2d_s'] * 1e3:.1f} ms, compute "
                f"{t['compute_s'] * 1e3:.1f} ms, readback "
                f"{t['d2h_s'] * 1e3:.1f} ms, gather "
                f"{t.get('gather_s', 0.0) * 1e3:.1f} ms" if t else "")
        print(f"phase {phase} D={d} {name} rank {rec['rank']}: wall "
              f"{rec['wall_ms']:.1f} ms (host), {rec['event_ms']:.1f} ms (CUDA"
              f" events), collectives {rec['collective_ms']:.1f} ms host in "
              f"{rec['collectives']}{legs}; launches {rec['launches']}; plain "
              f"twins {rec['plain']}; vs plain twins (max abs) {held_err}; "
              f"bitwise {sorted(set(rec['bitwise']))} ({card})")
        missing = [k for k in want if rec["launches"][k] == 0]
        check(not missing, f"D={d} {name} rank {rec['rank']}: {missing} "
                           f"not launched")
        check(all(v == 0 for v in rec["plain"].values()),
              f"D={d} {name}: a plain twin ran: {rec['plain']}")
        unheld = [k for k in held if k not in rec["held"]]
        if mb and not any(e == "ballistics_rates_bt" for e, _ in
                          rec["bitwise"]):
            unheld.append("ballistics_rates_bt")
        check(not unheld, f"D={d} {name} rank {rec['rank']}: {unheld} not "
                          f"held to a plain twin")
        check(rec["repeat_bitwise"], f"D={d} {name} rank {rec['rank']}: "
                                     f"the timed repeat is not bitwise")
    for line in recs[0]["check"]:
        print(f"  D={d} {name} rank 0 vs the one-card album: {line}")
    check(len({r["digest"] for r in recs}) == 1,
          f"D={d} {name}: the ranks returned different audio")
    if name == "streamed":
        tracks_done = sorted(x for r in recs for x in r["done"])
        print(f"  D={d} streamed: on_track_done {tracks_done}; meters vs the "
              f"one-card album's max {recs[0]['meters_err']:.3e}; resumed "
              f"after chunk {DP_STOP_AFTER} bitwise "
              f"{[r['resumed_bitwise'] for r in recs]}")
        check([i for i, _, _ in tracks_done] == list(range(len(DP_SECONDS)))
              and all(m for _, _, m in tracks_done),
              f"on_track_done calls {tracks_done}")
        check(all(r["resumed_bitwise"] for r in recs),
              "the resumed run is not bitwise the uninterrupted one")


def fast_phase(o, kernels, card):
    """Phase 38: ``make_master_fn(ChainConfig.gpu_fast(FS))`` (no device
    argument) on the 180 s track with multiband: K2 and K3 at hop 16 held
    to their plain twins (1e-4), every kernel launched, the output within
    phase 10's limits of the port's CPU path, the device time against
    ``gpu_default``'s (``o`` from :func:`main_path_operands`)."""
    from python_audio_mastering_tpu_torch import (
        ChainConfig,
        MasteringChain,
        make_master_fn,
    )
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb

    cfg = ChainConfig.gpu_fast(FS)
    fn = make_master_fn(cfg)                           # no device argument
    params = o.mb_params
    fn(o.x, params)                                    # warm
    torch.cuda.synchronize()
    captured = []
    cmb.reset_launch_counts()
    with sp_recording(captured, dp_where()):
        res = fn(o.x, params)
    torch.cuda.synchronize()
    counts = cmb.launch_counts()
    hops = {n: kw.get("hop") for n, _, _, kw, _ in captured
            if n in ("band_energies", "band_gain_apply")}
    held, bitwise = sp_hold(captured, 0)
    del captured[:]
    print(f"phase 38 make_master_fn(gpu_fast) (no device argument, output on "
          f"{res.audio.device}): launches {counts}; hops {hops}; vs plain "
          f"twins (max abs) "
          f"{ {n: f'{v[1]:.2e} at {v[0]}' for n, v in held.items()} }; "
          f"bitwise {sorted(set(bitwise))}")
    check(res.audio.device.type == "cuda", "make_master_fn ran off the card")
    check(hops == {"band_energies": 16, "band_gain_apply": 16},
          f"the band kernels ran at hops {hops}, not 16")
    check(all(counts[k] > 0 for k in SP_COUNTED),
          f"a kernel was not launched: {counts}")
    check(all(k in held for k in SP_PLAIN), f"not held: {sorted(held)}")
    y = res.audio.cpu().numpy()
    cpu = MasteringChain(cfg)(o.x, params, return_result=True)
    d = np.abs(y - cpu.audio.numpy())
    d_max, d_rms = float(d.max()), float(np.sqrt(np.mean(d ** 2)))
    d_lu = abs(float(res.measured_lufs) - float(cpu.measured_lufs))
    print(f"phase 38 card vs CPU path: max abs {d_max:.3e}, rms {d_rms:.3e},"
          f" |dLU| {d_lu:.3e}")
    check(d_max < MB_MAX and d_rms < MB_RMS and d_lu < 1e-3,
          f"gpu_fast card vs CPU: {d_max}, {d_rms}, {d_lu}")
    x_dev = torch.from_numpy(o.x).cuda()
    default = make_master_fn(ChainConfig.gpu_default(FS))
    for what, f in (("gpu_fast", fn), ("gpu_default", default)):
        t = median_of(lambda: cuda_ms(lambda: f(x_dev, params), reps=1))
        by_name, wall = device_profile(lambda: f(x_dev, params), 5)
        dev_ms = sum(by_name.values())
        print(f"phase 38 {what} multiband master, input on the card: "
              f"{t:.3f} ms (CUDA events, median of 5), device time "
              f"{dev_ms:.3f} ms a call (torch.profiler, 5 calls; wall "
              f"{wall:.3f} ms, device idle {100.0 * (1 - dev_ms / wall):.1f}"
              f" %) ({card})")
    print("phase 38 ok", flush=True)


# ---------------------------------------------------------------------------
# The exact filter path (phases 39-44)
# ---------------------------------------------------------------------------

SCAN_WINDOW_S = 2          # phase 39's windows
SCAN_MID_S = 90            # the second window starts here
SCAN_PREFIX_S = 3          # phase 41's and 44's CPU comparisons
SCAN_AM_STEPS = 5
SCAN_OPS = 9               # K8: 5 products and 4 sums a sample and section
# phase 44: the card's float32 loss and gradient under the scan against the
# CPU's float64, relative to the loss and to max |grad| (prediction, PERF.md
# PR 12: the float32 K-weighting scan alone is ~5e-5 of its max from float64)
SCAN_AM_LOSS, SCAN_AM_GRAD = 1e-4, 1e-3
# phase 41, legacy multiband: the JAX package's own scan and blocked legacy
# chains part by 0.24197 max abs (a detector event at 63.17 s) and
# 1.0754e-4 rms on the first 120 s of this track, on the CPU
# (scripts/jax_scan_vs_blocked.py); the port's two are held to that spread
LEGACY_SCAN_SPREAD = (0.25, 1.1e-4)
SWEEP_SECTIONS = (1, 2, 3, 4, 8)   # phase 40's sweep of K8 by sections
SWEEP_SECONDS = 20                 # over one column of this length
# K8's dependent chain a section and sample, counted in its SASS: the y
# add, the a1*y product, the subtraction and the z1 add, 4 cycles each
SCAN_CHAIN_CYCLES = 16
# K8's bars: the 4-section float32 EQ at 180 s within a quarter of the
# one-thread-a-column design's 1139 ms, and the float32 sweep's k = 8
# within 1.5x of k = 1
SCAN_EQ_MS_MAX, SCAN_SWEEP_RATIO_MAX = 285.0, 1.5
# K8's earlier design (one thread a column, its sections in a loop) on the
# H100, 700 W: each phase-40 launch at 180 s, ms, and its sweep, ns a
# sample (scripts/k8_probe.py; PERF.md §6)
ONE_THREAD_MS = {"eq": "1139.31", "lp_hp": "691.9-696.9",
           "kweight": "691.9-696.9", "legacy_mid": "not recorded"}
ONE_THREAD_SWEEP_NS = {
    "float32": {1: 78.65, 2: 87.84, 3: 134.90, 4: 144.23, 8: 257.74},
    "float64": {1: 96.12, 2: 116.83, 3: 173.74, 4: 194.57, 8: 369.40}}


def scan_bounds(n_in, n_out, section_samples):
    """K8's bound: its bytes (``n_in`` samples read, ``n_out`` written,
    float32) and its operations (:data:`SCAN_OPS` a sample and section,
    on the fp32 cores)."""
    return bound(SCAN_OPS * section_samples, 4 * (n_in + n_out))


def sm_clock_under(run):
    """The SM clock in MHz, and its maximum, that ``nvidia-smi`` reads
    while ``run`` keeps the card busy."""
    query = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], stdout=subprocess.PIPE, text=True)
    while query.poll() is None:
        run()
        torch.cuda.synchronize()
    out, _ = query.communicate(timeout=60)
    return [float(v) for v in out.split(",")]


def scan_sweep(dev, seconds=SWEEP_SECONDS, runs=3):
    """Phase 40's sweep: one K8 launch over one seeded column of
    ``seconds`` at 44.1 kHz through a cascade of k sections (a Butterworth
    low pass of order 2k at 1 kHz), for each k of :data:`SWEEP_SECTIONS`,
    in float32 and float64: ``{dtype: {k: ns a sample}}`` (CUDA events,
    the median of ``runs`` after a warm launch)."""
    import scipy.signal as ss

    from python_audio_mastering_tpu_torch.ops.sos_scan import sos_scan

    n = seconds * FS
    col = np.random.default_rng(40).standard_normal((1, n)) * 0.1
    out = {}
    for dtype in (torch.float32, torch.float64):
        x = torch.from_numpy(col).to(dev, dtype)
        out[str(dtype).removeprefix("torch.")] = {
            k: median_of(lambda: cuda_ms(lambda: sos_scan(x, [sos]), reps=1),
                         runs=runs) * 1e6 / n
            for k in SWEEP_SECTIONS
            for sos in [ss.butter(2 * k, 1000.0, fs=FS, output="sos")]}
    return out


def scan_launches(o, dev):
    """K8's launches on the main path's scan body, with their operands:
    ``{name: (columns (R, N) float32 on the card, cascades)}``: the worker
    EQ on the saturated track, the crossovers' low and high pass in one
    launch on the front's output, the K-weighting on its mono mean, the
    legacy mid band's 4-section cascade on the front's output."""
    from python_audio_mastering_tpu_torch.models.chain import eq_sos
    from python_audio_mastering_tpu_torch.ops import multiband as mb
    from python_audio_mastering_tpu_torch.ops.loudness import kweight_sos
    from python_audio_mastering_tpu_torch.ops.sos_scan import sos_scan
    from python_audio_mastering_tpu_torch.ops.stereo import stereo_width
    from python_audio_mastering_tpu_torch.ops.waveshaper import (
        exciter,
        exciter_coefs,
    )

    p = o.mb_params
    xt = torch.from_numpy(np.ascontiguousarray(o.x.T)).to(dev)
    xs = exciter(xt, exciter_coefs(p.saturation, "worker", torch.float32))
    eq = eq_sos(p, FS)
    xf = stereo_width(sos_scan(xs, [eq])[0][0], p.width,
                      channel_axis=0).contiguous()
    return {"eq": (xs.contiguous(), [eq]),
            "lp_hp": (xf, list(mb._crossover_sos(FS, 250.0, 4000.0))),
            "kweight": (xf.mean(dim=0, keepdim=True), [kweight_sos(FS)]),
            "legacy_mid": (xf, [mb._mid_sos(FS, 250.0, 4000.0)])}


@contextlib.contextmanager
def k8_timed():
    """Every K8 launch made in the block timed with CUDA events (the
    launch's few-microsecond operand uploads included): yields a list that
    receives each launch's device ms, in order, when the block ends."""
    from python_audio_mastering_tpu_torch.ops import sos_scan as k8

    real, pairs, times = k8._launch, [], []

    def launch(*args, **kw):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        out = real(*args, **kw)
        stop.record()
        pairs.append((start, stop))
        return out

    k8._launch = launch
    try:
        yield times
    finally:
        k8._launch = real
        torch.cuda.synchronize()
        times.extend(a.elapsed_time(b) for a, b in pairs)


def scan_kweighting_readings(x, dev):
    """Phase 41's reading of where the scan and blocked chains' loudness
    parts: the gated loudness of the track's mono mean by the K-weighting
    scan in float32 (the chain's), in float64 with the same float32
    coefficients, in float64 with float64 coefficients, and by the blocked
    K-weighting (K4), printed beside each other."""
    from python_audio_mastering_tpu_torch.ops import loudness as loud
    from python_audio_mastering_tpu_torch.ops.sos_scan import sos_scan

    mono = torch.from_numpy(x).to(dev).mean(dim=1)
    cell = loud._gating_geometry(FS)[0]
    n_cells = mono.shape[0] // cell
    sos = loud.kweight_sos(FS)

    def lufs(y):
        ms = (y[: n_cells * cell] ** 2).reshape(n_cells, cell).mean(dim=1)
        return float(loud.loudness_from_cells(ms[:, None].double()))

    readings = {
        "scan float32": lufs(sos_scan(mono[None], [sos])[0][0, 0].double()),
        "scan float64, float32 coefficients": lufs(sos_scan(
            mono[None].double(), [sos.astype(np.float32)])[0][0, 0]),
        "scan float64": lufs(sos_scan(mono[None].double(), [sos])[0][0, 0]),
        "blocked (K4)": float(loud.integrated_loudness(
            mono, FS, filter_method="blocked")),
    }
    print("phase 41 the track's mono mean, gated loudness by K-weighting: "
          + ", ".join(f"{k} {v:.6f}" for k, v in readings.items()))


def scan_phases(o, kernels, card):
    """Phases 39-44: the exact filter path (``filter_method="scan"``), the
    scan kernel K8 (``ops.sos_scan``) and a ``comp_hop`` that does not
    divide the block (``o`` from :func:`main_path_operands`)."""
    import scipy.signal as ss

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles.bs1770_ref import integrated_loudness as oracle_lufs

    from python_audio_mastering_tpu_torch import (
        ChainConfig,
        MasteringChain,
        MasteringParams,
        master,
    )
    from python_audio_mastering_tpu_torch.models import automaster as am
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
    from python_audio_mastering_tpu_torch.ops.sos_scan import (
        sos_scan,
        sos_scan_ref,
    )
    from python_audio_mastering_tpu_torch.parallel import batch
    from python_audio_mastering_tpu_torch.parallel.streaming import (
        master_streamed,
    )

    dev = o.xrows.device
    x = o.x
    n = x.shape[0]
    rec = kernels.setdefault("sos_scan", {})

    # phase 39 --------------------------------------------------------------
    ops = scan_launches(o, dev)
    w, mid = SCAN_WINDOW_S * FS, SCAN_MID_S * FS
    for name, (cols, sos) in ops.items():
        r = cols.shape[0]
        full, z_mid = sos_scan(cols, sos, n_valid=mid)  # K8's own carry
        for start, zi in ((0, None), (mid, z_mid)):
            seg = cols[:, start:start + w].contiguous()
            y, zf = sos_scan(seg, sos, zi)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y_ref, zf_ref = sos_scan_ref(
                seg.cpu(), sos, None if zi is None else [z.cpu() for z in zi])
            t_cpu = time.perf_counter() - t0
            check_bitwise(f"phase 39 K8 {name} ({r} columns, {len(sos)} "
                          f"cascades) {SCAN_WINDOW_S} s at {start // FS} s "
                          f"vs its plain version on the CPU ({t_cpu:.1f} s)",
                          y.cpu(), y_ref)
            check(all(torch.equal(a.cpu(), b) for a, b in zip(zf, zf_ref)),
                  f"phase 39 K8 {name}: final states not bitwise")
            check_bitwise(f"phase 39 K8 {name} from its carried state vs the "
                          f"whole-track launch", y, full[:, :, start:start + w])
    rec["max_abs_err"] = 0.0
    print("phase 39 ok", flush=True)

    # phase 40 --------------------------------------------------------------
    cols, sos = ops["eq"]
    y64, _ = sos_scan(cols.double(), sos)
    ref = ss.sosfilt(sos[0], cols.double().cpu().numpy(), axis=1)
    d = np.abs(y64[0].cpu().numpy() - ref)
    y32, _ = sos_scan(cols, sos)
    ref32 = ss.sosfilt(sos[0].astype(np.float32).astype(np.float64),
                       cols.double().cpu().numpy(), axis=1)
    d32 = np.abs(y32[0].double().cpu().numpy() - ref32)
    print(f"phase 40 K8 EQ over the whole track {tuple(cols.shape)} vs "
          f"scipy.signal.sosfilt in float64: K8 float64 max abs "
          f"{d.max():.3e} rms {np.sqrt(np.mean(d ** 2)):.3e}; K8 float32 max "
          f"abs {d32.max():.3e} rms {np.sqrt(np.mean(d32 ** 2)):.3e} (max "
          f"|y| {np.abs(ref).max():.3f})")
    check(d.max() <= 1e-9 * np.abs(ref).max(), "K8 float64 vs scipy")
    check(d32.max() <= 1e-3 * np.abs(ref).max(), "K8 float32 vs scipy")
    cols, sos = ops["eq"]
    clock, clock_max = sm_clock_under(lambda: sos_scan(cols, sos))
    # the latency bound: a column's samples one after another, each the
    # dependent chain's cycles, at the SM clock read while K8 runs
    latency = n * SCAN_CHAIN_CYCLES / (clock * 1e6) * 1e3
    print(f"phase 40 SM clock under K8 {clock:.0f} MHz (max {clock_max:.0f});"
          f" latency bound at 180 s {latency:.2f} ms ({SCAN_CHAIN_CYCLES} "
          f"cycles a sample, the sections overlapped)")
    for name, (cols, sos) in ops.items():
        r = cols.shape[0]
        runs = 5 if name == "eq" else 1
        t = median_of(lambda: cuda_ms(lambda: sos_scan(cols, sos), reps=1),
                      runs=runs)
        secs = sum(s.shape[0] for s in sos)
        bnd = scan_bounds(r * n, len(sos) * r * n, secs * r * n)
        print(f"phase 40 K8 {name} at 180 s ({r} columns, {len(sos)} "
              f"cascades, {secs} sections): {t:.3f} ms (CUDA events, median of"
              f" {runs}; one thread a column {ONE_THREAD_MS[name]} ms), {t * 1e6 / n:.2f} ns a "
              f"sample; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
              f"latency bound {latency:.2f} ms, {100 * latency / t:.0f} % of "
              f"it ({card})")
        if name == "eq":
            rec.update(ms=t, **bnd, latency_bound_ms=latency)
            check(t <= SCAN_EQ_MS_MAX, f"K8 EQ at 180 s {t:.1f} ms > "
                                       f"{SCAN_EQ_MS_MAX} ms")
    sweep = scan_sweep(dev)
    for dtype, by_k in sweep.items():
        print(f"phase 40 K8 {dtype} on one {SWEEP_SECONDS} s column, ns a "
              f"sample by sections (one thread a column in brackets): " + ", ".join(
                  f"k={k} {v:.2f} ({ONE_THREAD_SWEEP_NS[dtype][k]:.2f})"
                  for k, v in by_k.items())
              + f"; k=8 / k=1 {by_k[8] / by_k[1]:.3f} ({card})")
    f32 = sweep["float32"]
    check(f32[8] <= SCAN_SWEEP_RATIO_MAX * f32[1],
          f"K8 float32 k=8 {f32[8]:.2f} ns a sample > "
          f"{SCAN_SWEEP_RATIO_MAX} x k=1 {f32[1]:.2f}")
    cols, sos = ops["eq"]
    seg = cols[:, :w].contiguous()
    plain = cuda_ms(lambda: sos_scan_ref(seg, sos), reps=1)
    window = median_of(lambda: cuda_ms(lambda: sos_scan(seg, sos), reps=1))
    rec.update(plain_ms=plain, library_ms=None, window_ms=window,
               plain_window_s=SCAN_WINDOW_S)
    print(f"phase 40 K8 EQ on the {SCAN_WINDOW_S} s window: kernel "
          f"{window:.3f} ms (median of 5), plain version on the card "
          f"{plain:.1f} ms (one call) (CUDA events); no PyTorch call computes a DF2T recurrence "
          f"(library: none) ({card})")
    print("phase 40 ok", flush=True)

    # phase 41 --------------------------------------------------------------
    scan_cfg = dataclasses.replace(ChainConfig.gpu_default(FS),
                                   filter_method="scan")
    legacy_cfg = dataclasses.replace(scan_cfg, variant="legacy")
    blocked_legacy = dataclasses.replace(ChainConfig.gpu_default(FS),
                                         variant="legacy")
    runs = {"worker_off": (scan_cfg, o.params, ChainConfig.gpu_default(FS),
                           2),
            "worker_on": (scan_cfg, o.mb_params, ChainConfig.gpu_default(FS),
                          3),
            "legacy_on": (legacy_cfg, o.mb_params, blocked_legacy, 6)}
    x_dev = torch.from_numpy(x).to(dev)
    outs = {}
    for name, (cfg, params, blocked_cfg, k8_want) in runs.items():
        cmb.reset_launch_counts()
        t0 = time.perf_counter()
        res = master(x, params, cfg, return_result=True)   # no device arg
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, plain = cmb.launch_counts(), cmb.plain_calls()
        y = res.audio.cpu().numpy()
        outs[name] = (y, float(res.measured_lufs))
        check(res.audio.device.type == "cuda", f"{name} ran off the card")
        check(bool(np.isfinite(y).all()) and float(np.abs(y).max()) <= 1.0,
              f"{name}: non-finite or over 1")
        lufs_out = oracle_lufs(y.astype(np.float64).mean(axis=1), FS)
        print(f"phase 41 scan master() {name} (no device argument): launches "
              f"{counts}, plain twins {plain}; oracle {lufs_out:.4f} LUFS; "
              f"wall {wall * 1e3:.1f} ms (upload and readback included, x"
              f"{SECONDS / wall:.0f} realtime) ({card})")
        check(abs(lufs_out - SETTINGS["lufs"]) <= 0.15,
              f"{name}: oracle {lufs_out} not within 0.15 LU of -14")
        check(counts["sos_scan"] == k8_want,
              f"{name}: K8 launched {counts['sos_scan']} times, not "
              f"{k8_want}")
        check(all(counts[k] == 0 for k in NO_MB_KERNELS + (
            "band_energies", "band_gain_apply")),
            f"{name}: a blocked kernel ran on the scan path: {counts}")
        check(not any(plain.values()), f"{name}: a plain twin ran: {plain}")
        if params.multiband:
            check(all(counts[k] > 0 for k in (*K5_LAUNCHES, "replay",
                                              "replay_bnd")),
                  f"{name}: the ballistics kernels did not run: {counts}")
        if name == "worker_on":
            rec["launches"] = counts["sos_scan"]
        blk = master(x, params, blocked_cfg, return_result=True)
        y_blk = blk.audio.cpu().numpy()
        d = np.abs(y - y_blk)
        d_lu = abs(float(res.measured_lufs) - float(blk.measured_lufs))
        # the two chains measure the loudness with two K-weightings: the
        # scan's coefficients rounded to float32 (JAX's sosfilt_scan casts
        # them so), the blocked one's operators built in float64; their
        # gains differ by that, and the rest is held to phase 10's rms
        ratio = 10.0 ** ((float(res.applied_gain_db)
                          - float(blk.applied_gain_db)) / 20.0)
        d_gain = np.abs(y - y_blk * ratio)
        rms, rms_gain = (float(np.sqrt(np.mean(v ** 2)))
                         for v in (d, d_gain))
        print(f"phase 41 {name} scan vs blocked on the card: max abs "
              f"{d.max():.3e}, rms {rms:.3e} ({rms_gain:.3e} with the "
              f"blocked output scaled by the gains' ratio {ratio:.7f}), "
              f"|dLU| {d_lu:.3e}; samples over 1e-5 (detector threshold "
              f"flips) {int((d_gain > 1e-5).sum())}")
        lim_max, lim_rms = ((MB_MAX, MB_RMS) if cfg.variant == "worker"
                            else LEGACY_SCAN_SPREAD)
        check(d.max() < lim_max and rms_gain < lim_rms and d_lu < 1e-3,
              f"{name}: scan vs blocked out of budget")
        if name == "worker_off":
            scan_kweighting_readings(x, dev)
        if name != "worker_off":
            pre = x[:SCAN_PREFIX_S * FS]
            t0 = time.perf_counter()
            cpu = master(pre, params, cfg, device="cpu").numpy()
            t_cpu = time.perf_counter() - t0
            card_pre = master(pre, params, cfg).cpu().numpy()
            d = float(np.abs(card_pre - cpu).max())
            print(f"phase 41 {name} on a {SCAN_PREFIX_S} s prefix, card vs "
                  f"the port's CPU path ({t_cpu:.1f} s): max abs {d:.3e}")
            check(d < 2e-4, f"{name}: card vs CPU {d} >= 2e-4")
        # a profiler window now and then holds only some of a call's
        # launches, and in a process that has run the earlier phases it
        # drops K8's (PERF.md, open questions): profile again, at most
        # twice; K8's own time comes from CUDA events around each of the
        # call's launches, the rest of the device time from the profiler
        for attempt in range(3):
            seen = {}
            with k8_timed() as k8_times:
                by_name, pwall = device_profile(
                    lambda: master(x_dev, params, cfg), 1, seen)
            k8_seen = sum(v for k, v in seen.items() if "sos_scan" in k)
            if k8_seen == k8_want:
                break
            WINDOWS["short"].append(("sos_scan", k8_seen, k8_want))
            print(f"  the profiler saw {k8_seen} of {k8_want} K8 launches "
                  f"(try {attempt + 1}; {sum(seen.values())} device "
                  f"activities in the window)")
        # device_profile's warm call made the first half of the launches
        check(len(k8_times) == 2 * k8_want,
              f"{name}: {len(k8_times)} K8 launches timed, not "
              f"{2 * k8_want}")
        k8_ms = sum(k8_times[k8_want:])
        dev_ms = k8_ms + sum(v for k, v in by_name.items()
                             if "sos_scan" not in k)
        print(f"phase 41 {name}, input on the card: wall {pwall:.1f} ms (x"
              f"{SECONDS * 1e3 / pwall:.0f} realtime), device time "
              f"{dev_ms:.1f} ms a call, K8 {k8_ms:.1f} ms of it ({k8_want} "
              f"launches, CUDA events; the profiler saw {k8_seen}), device "
              f"idle {100.0 * (1 - dev_ms / pwall):.1f} % (torch.profiler "
              f"for the rest) ({card})")
    print("phase 41 ok", flush=True)

    # phase 42 --------------------------------------------------------------
    y_one = outs["worker_on"][0]
    cmb.reset_launch_counts()
    y_str, _, _ = master_streamed(x, o.mb_params, scan_cfg)  # no device
    counts = cmb.launch_counts()
    d = float(np.abs(y_str - y_one).max())
    print(f"phase 42 scanned master_streamed vs the one-shot scan: max abs "
          f"{d:.3e} (bitwise {bool(np.array_equal(y_str, y_one))}); "
          f"launches {counts}")
    check(d < 2e-4 and counts["sos_scan"] > 0 and counts["front_chain"] == 0,
          f"scanned master_streamed: {d}, {counts}")
    tracks = dp_tracks()
    cmb.reset_launch_counts()
    t0 = time.perf_counter()
    album = batch.master_album(tracks, o.mb_params, scan_cfg)  # no device
    wall = time.perf_counter() - t0
    counts = cmb.launch_counts()
    print(f"phase 42 the {len(tracks)}-track album (phase 35's) scanned in "
          f"one process (D = 1): wall {wall:.2f} s; launches {counts}")
    check(counts["sos_scan"] == 3 and counts["front_chain"] == 0,
          f"scanned album launches {counts}")
    for i in (0, len(tracks) - 1):
        one = master(tracks[i], o.mb_params, scan_cfg).cpu().numpy()
        d = float(np.abs(album[i] - one).max())
        lufs_out = oracle_lufs(album[i].astype(np.float64).mean(axis=1), FS)
        print(f"  album track {i} ({tracks[i].shape[0] / FS:.0f} s) vs its "
              f"own scan master(): max abs {d:.3e}; oracle {lufs_out:.4f} "
              f"LUFS")
        check(d < 2e-4 and abs(lufs_out - SETTINGS["lufs"]) <= 0.15,
              f"album track {i}: {d}, {lufs_out}")
    print("phase 42 ok", flush=True)

    # phase 43 --------------------------------------------------------------
    hop_cfg = dataclasses.replace(ChainConfig.gpu_default(FS), comp_hop=5)
    captured = []
    cmb.reset_launch_counts()
    with sp_recording(captured, dp_where()):
        res = master(x, o.mb_params, hop_cfg, return_result=True)
    torch.cuda.synchronize()
    counts = cmb.launch_counts()
    hops = {nm: kw.get("hop") for nm, _, _, kw, _ in captured
            if nm in ("band_energies", "band_gain_apply")}
    held, _ = sp_hold(captured, 0)
    del captured[:]
    print(f"phase 43 master() comp_hop=5 at block {L}: launches {counts}; "
          f"band kernel hops {hops}; vs plain twins (max abs) "
          f"{ {nm: f'{v[1]:.2e}' for nm, v in held.items()} }")
    check(hops == {"band_energies": 1, "band_gain_apply": 1},
          f"the band kernels ran at hops {hops}, not 1")
    check(all(counts[k] > 0 for k in SP_COUNTED) and counts["sos_scan"] == 0,
          f"comp_hop=5 launches {counts}")
    y = res.audio.cpu().numpy()
    cpu = MasteringChain(hop_cfg)(x, o.mb_params, return_result=True)
    d = np.abs(y - cpu.audio.numpy())
    d_lu = abs(float(res.measured_lufs) - float(cpu.measured_lufs))
    print(f"phase 43 card vs CPU path: max abs {d.max():.3e}, rms "
          f"{np.sqrt(np.mean(d ** 2)):.3e}, |dLU| {d_lu:.3e}")
    check(d.max() < MB_MAX and np.sqrt(np.mean(d ** 2)) < MB_RMS
          and d_lu < 1e-3, "comp_hop=5 card vs CPU out of phase 10's limits")
    print("phase 43 ok", flush=True)

    # phase 44 --------------------------------------------------------------
    target_params = MasteringParams.from_settings(
        {"bass_boost": 5.0, "treble_boost": -3.0, "lufs": -14.0})
    target = am.spectral_profile(master(x, target_params, scan_cfg), FS)
    model = am.AutoMasterModel(config=scan_cfg)        # no device argument
    audio = model.as_audio(x)
    th = torch.zeros(6, device=dev, requires_grad=True)
    step = am.make_train_step(model, torch.optim.Adam([th], lr=0.05))
    times, losses, per_step = [], [], []
    for _ in range(SCAN_AM_STEPS):
        cmb.reset_launch_counts()
        t = cuda_ms(lambda: losses.append(float(step(th, audio[None],
                                                     target[None]))), reps=1)
        times.append(t)
        per_step.append((cmb.launch_counts(), cmb.plain_calls()))
    counts, plain = per_step[-1]
    print(f"phase 44 {SCAN_AM_STEPS} automaster steps under the scan at "
          f"{SECONDS} s: step {statistics.median(times):.1f} ms (CUDA events,"
          f" median; first {times[0]:.1f}); losses {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; launches a step {counts}, plain twins {plain} "
          f"({card})")
    check(counts["sos_scan"] == 7 and counts["front_chain"] == 0
          and counts["kweight_cells"] == 0 and not any(plain.values()),
          f"scan fit step launches {counts}, plain {plain}")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    pre = x[:SCAN_PREFIX_S * FS]
    tgt_pre = am.spectral_profile(master(pre, target_params, scan_cfg), FS)
    cpu64 = am.AutoMasterModel(
        config=dataclasses.replace(scan_cfg, dtype="float64"), device="cpu")
    theta0 = np.random.default_rng(44).standard_normal(6) * 0.5

    def loss_grad(m, dtype, tgt):
        th = torch.tensor(theta0, dtype=dtype, device=m.device,
                          requires_grad=True)
        loss = m.loss(th, m.as_audio(pre), tgt)
        loss.backward()
        return loss.item(), th.grad.double().cpu()

    loss, g = loss_grad(model, torch.float32, tgt_pre)
    t0 = time.perf_counter()
    loss64, g64 = loss_grad(cpu64, torch.float64, tgt_pre.double().cpu())
    t_cpu = time.perf_counter() - t0
    d_loss = abs(loss - loss64) / abs(loss64)
    d_grad = ((g - g64).abs().max() / g64.abs().max()).item()
    print(f"phase 44 on a {SCAN_PREFIX_S} s signal, the card's float32 vs "
          f"the CPU's float64 ({t_cpu:.1f} s): loss {loss:.6f} vs "
          f"{loss64:.6f} (|diff| / loss {d_loss:.3e}); gradient "
          f"{[round(v, 6) for v in g.tolist()]} vs "
          f"{[round(v, 6) for v in g64.tolist()]}, max |diff| / max |grad| "
          f"{d_grad:.3e}")
    check(d_loss <= SCAN_AM_LOSS and d_grad <= SCAN_AM_GRAD,
          f"scan automaster: loss {d_loss}, gradient {d_grad}")
    check(bool((g != 0).all()), f"a gradient component is 0: {g}")
    print("phase 44 ok", flush=True)


# K5 on the runs it meets (phase 45): the four program materials of
# scripts/bal_materials.py (which imports jax), raw signals fed straight
# into the multiband detector, its generators copied here
MATERIALS = ("bench_raw", "pink", "pulse", "sustained")
# K5 when it walked every step of a run, frozen blocks too, on the 180 s
# legacy targets, ms (NVIDIA H100 80GB HBM3, 700 W; PERF.md)
K5_WALK_EVERY_STEP_LEGACY_MS = 10.766


def materials(n=SECONDS * FS, fs=FS):
    """scripts/bal_materials.py's four signals, ``{name: (n, 2) float32}``,
    from its one generator seeded 0, drawn in its order."""
    rng = np.random.default_rng(0)
    t = np.arange(n) / fs

    def bench_raw():
        sig = (0.4 * np.sin(2 * np.pi * 55 * t)
               + 0.2 * np.sin(2 * np.pi * 880 * t)
               + 0.1 * np.sin(2 * np.pi * 4200 * t)
               + 0.05 * rng.standard_normal(n))
        env = 0.4 + 0.6 * (0.5 + 0.5 * np.sin(2 * np.pi * 0.5 * t)) ** 2
        return np.stack([sig * env, np.roll(sig * env, 29)], axis=1)

    def pink():
        w = rng.standard_normal(n + 1)
        f = np.fft.rfft(w)
        f /= np.maximum(np.sqrt(np.arange(f.size)), 1.0)
        p = np.fft.irfft(f)[:n]
        p = 0.5 * p / np.abs(p).max()
        return np.stack([p, np.roll(p, 13)], axis=1)

    def pulse():
        beat = int(fs * 0.5)
        envp = np.exp(-5.0 * ((np.arange(n) % beat) / beat))
        sig = envp * (np.sin(2 * np.pi * 60 * t)
                      + 0.3 * rng.standard_normal(n))
        sig = 0.8 * sig / np.abs(sig).max()
        return np.stack([sig, np.roll(sig, 7)], axis=1)

    def sustained():
        env2 = (0.55 + 0.1 * np.sin(2 * np.pi * 0.2 * t)
                + 0.05 * np.sin(2 * np.pi * 3.1 * t))
        sig = env2 * (np.sin(2 * np.pi * 220 * t)
                      + 0.5 * np.sin(2 * np.pi * 3300 * t))
        return np.stack([sig, np.roll(sig, 11)], axis=1)

    return {name: fn().astype(np.float32) for name, fn in zip(
        MATERIALS, (bench_raw, pink, pulse, sustained))}


def material_targets(x, o):
    """The multiband detector's targets ``(m, ca, cr, att0)`` of a raw
    ``(n, 2)`` signal, as scripts/bal_materials.py forms them: the
    crossovers and K2 at the chain's hop on the signal itself (no front),
    the bench settings' thresholds and ratios."""
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
    from python_audio_mastering_tpu_torch.ops import iir

    dev = o.xrows.device
    nb = -(-x.shape[0] // L)
    xrows = torch.nn.functional.pad(torch.from_numpy(x.T.copy()).to(dev),
                                    (0, nb * L - x.shape[0])).reshape(2, nb, L)
    (s_lp, s_hp), _ = iir.sosfilt_states_multi_rows(
        o.sos, xrows, ops_list=o.chain.crossover_ops())
    xb = cmb.band_energies(xrows, s_lp, s_hp, *o.sos, hop=o.hop)
    return detector_targets(xb, o.mb_params, o.hop, dev)


def queued_ms(fn, reps=20, runs=3):
    """Device ms a call of ``fn`` by CUDA events, the ``reps`` calls queued
    behind a sleeping kernel so that the host's time to issue them stays
    out of the reading: the median of ``runs``."""
    fn()
    torch.cuda.synchronize()

    def once():
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        torch.cuda._sleep(50_000_000)   # ~25 ms: the host issues meanwhile
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    return statistics.median(once() for _ in range(runs))


def serial_walk_np(row, ca, cr, att0):
    """One band's serial walk in numpy float32 scalars, one step a Python
    iteration, each product and sum rounded to float32 on its own as
    ``ballistics_step``: the outgoing state of every 128-step block."""
    a, r, att = np.float32(ca), np.float32(cr), np.float32(att0)
    zero = np.float32(0.0)
    out = np.empty(len(row) // 128, np.float32)
    for i, mi in enumerate(row.astype(np.float32)):
        if att <= mi:
            att = min(np.float32(att + np.float32(mi * a)), mi)
        else:
            att = max(np.float32(att - np.float32(mi * r)), zero)
        if i % 128 == 127:
            out[i // 128] = att
    return out


def k5_phase(o, kernels, card):
    """Phase 45: K5 on the runs it meets (``o`` from
    :func:`main_path_operands`)."""
    from python_audio_mastering_tpu_torch.ops import ballistics as bal

    rec = kernels["pass1_bnd"]
    dev = o.xrows.device

    def k5(m, ca, cr, att0):
        hmax = torch.maximum(att0, m.amax(dim=1)).contiguous()
        return lambda: bal.pass1_runs(m, ca, cr, att0,
                                      *bal.pass1_hull(m, ca, cr, hmax))

    def timed(what, m, ca, cr, att0, clock):
        """K5 alone on ``m`` by CUDA events against its latency bound."""
        hull = bal.pass1_hull(m, ca, cr, torch.maximum(att0, m.amax(dim=1)))
        stats = bal.walk_stats(*hull)
        chain = bal.BLOCK * max(st["chain"] for st in stats)
        walked = bal.BLOCK * sum(st["live"] for st in stats)
        ms = queued_ms(k5(m, ca, cr, att0))
        latency = k5_latency_ms(chain, clock)
        per_step = (f"{ms * 1e6 / chain:.2f} ns a step of it" if chain
                    else "no step walked")
        print(f"phase 45 K5 on {what} {tuple(m.shape)}: {ms:.4f} ms (CUDA "
              f"events); {walked} steps walked, {chain} in the longest "
              f"chain, {per_step}; latency bound {latency:.4f} ms, "
              f"{100 * latency / ms:.0f} % of it ({card})")
        return ms, latency

    targets = chain_targets(o)
    legacy = targets["legacy"]
    clock, clock_max = sm_clock_under(k5(*legacy))
    print(f"phase 45 SM clock under K5 {clock:.0f} MHz (max {clock_max:.0f});"
          f" {K5_CHAIN_CYCLES} cycles a step (scripts/k5_probe.py)")
    for name, (m, ca, cr, att0) in targets.items():
        hull_p = bal.pass1_hull_ref(m, ca, cr,
                                    torch.maximum(att0, m.amax(dim=1)))
        bnd = bal.pass1_bnd(m, ca, cr, att0)
        check_bitwise(f"phase 45 K5 on the {name} targets vs its plain "
                      f"twins (full T)", bnd,
                      bal.pass1_runs_ref(m, ca, cr, att0, *hull_p))
        for band in (1,) if name == "legacy" else ():
            t0 = time.perf_counter()
            ser = serial_walk_np(m[band].cpu().numpy(), float(ca[band]),
                                 float(cr[band]), float(att0[band]))
            check_bitwise(f"phase 45 K5 on the legacy mid band vs the serial"
                          f" walk at full T ({time.perf_counter() - t0:.1f} s"
                          f" on the CPU)", bnd[band].cpu(),
                          torch.from_numpy(ser))
        ms, latency = timed(f"the {name} chain's targets", m, ca, cr, att0,
                            clock)
        rec[f"{name}_events_ms"] = ms
        rec[f"{name}_latency_bound_ms"] = latency
    ms = rec["legacy_events_ms"]
    print(f"phase 45 K5 on the legacy targets {ms:.4f} ms against "
          f"{K5_WALK_EVERY_STEP_LEGACY_MS} ms for the walk of every step "
          f"({card})")
    check(ms <= 0.5, f"K5 on the legacy targets {ms} ms > 0.5 ms")
    print("phase 45 the program materials (scripts/bal_materials.py), raw "
          "signals into the multiband detector:")
    for name, x in materials().items():
        m, ca, cr, att0 = material_targets(x, o)
        hull = bal.pass1_hull(m, ca, cr, torch.maximum(att0, m.amax(dim=1)))
        nblk = hull[0].shape[1]
        for band, st in zip(("low", "mid", "high"), bal.walk_stats(*hull)):
            print(f"phase 45 {name}, {band} band: {walk_line(st, nblk)}")
        check_bitwise(f"phase 45 {name}: K5 vs its plain twins (full T)",
                      bal.pass1_bnd(m, ca, cr, att0),
                      bal.pass1_runs_ref(m, ca, cr, att0, *bal.pass1_hull_ref(
                          m, ca, cr, torch.maximum(att0, m.amax(dim=1)))))
        for band, bname in enumerate(("low", "mid", "high")):
            one = (m[band:band + 1].contiguous(), ca[band:band + 1],
                   cr[band:band + 1], att0[band:band + 1])
            timed(f"{name}'s {bname} band", *one, clock)
        out, ctrl = bal._run_collapse(m, ca, cr, att0)
        check_bitwise(f"phase 45 {name}: serial == collapse",
                      bal._run(m, ca, cr, att0), out)
        mode_ms = {mode: queued_ms(lambda: bal.ballistics_rates_bt(
            m, ca, cr, att0, mode=mode)) for mode in ("serial", "collapse")}
        print(f"phase 45 {name}: the fixed point ran {int(ctrl[bal.ROUND])} "
              f"rounds, certified {int(ctrl[bal.CNT]) == 0}; "
              f"ballistics_rates_bt device time (CUDA events) serial "
              f"{mode_ms['serial']:.4f} ms, collapse "
              f"{mode_ms['collapse']:.4f} ms ({card})")
    for name, (m, ca, cr, att0) in targets.items():
        _, ctrl = bal._run_collapse(m, ca, cr, att0)
        mode_ms = {mode: queued_ms(lambda: bal.ballistics_rates_bt(
            m, ca, cr, att0, mode=mode)) for mode in ("serial", "collapse")}
        print(f"phase 45 the {name} chain's targets: the fixed point ran "
              f"{int(ctrl[bal.ROUND])} rounds, certified "
              f"{int(ctrl[bal.CNT]) == 0}; serial {mode_ms['serial']:.4f} "
              f"ms, collapse {mode_ms['collapse']:.4f} ms ({card})")
    print("phase 45 ok", flush=True)


def gain_limit_phase(o, kernels, card):
    """Phase 46: K9 ``gain_limit`` at the track's and the album's shape
    (``o`` from :func:`main_path_operands`)."""
    from python_audio_mastering_tpu_torch.ops import gain_limit as k9

    dev = o.xrows.device
    thr = o.chain.config.limiter_threshold
    _, _, gain_db = o.chain.forward_tracks(
        torch.from_numpy(o.x).to(dev)[None], o.params)
    n_album = BENCH_ALBUM_SECONDS * FS
    m_album = -(-n_album // L) * L
    gen = torch.Generator(device=dev).manual_seed(46)
    album = torch.randn((2, BENCH_ALBUM_TRACKS, m_album), generator=gen,
                        device=dev) * 0.5
    album[:, :, n_album:] = 0.0
    cases = {
        "track": (o.chain.front(o.xrows, o.params).reshape(2, 1, -1),
                  10.0 ** (gain_db / 20.0), o.x.shape[0]),
        "album": (album, torch.linspace(0.6, 2.2, BENCH_ALBUM_TRACKS,
                                        device=dev), n_album)}
    rec = kernels["gain_limit"]
    for what, (xr, gain, n) in cases.items():
        c, tracks, _ = xr.shape
        kept = c * tracks * n
        over = (xr[:, :, :n] * gain.view(1, tracks, 1)).abs() > thr
        bnd = bound(kept * (K9_FLOPS + 1), 4 * (2 * kept + tracks))
        for variant in ("worker", "legacy"):
            args = (xr, gain, n, thr, variant)
            check_bitwise(f"phase 46 gain_limit {what} {variant} vs "
                          f"gain_limit_ref", k9.gain_limit(*args),
                          k9.gain_limit_ref(*args))
            ms = queued_ms(lambda: k9.gain_limit(*args))
            check(bnd["bound_ms"] / ms <= 1.05,
                  f"gain_limit {what} {variant}: {ms} ms, under its bound "
                  f"{bnd['bound_ms']} ms: the time leaves out some work")
            plain_ms = median_of(lambda: cuda_ms(
                lambda: k9.gain_limit_ref(*args)))
            key = "" if what == "track" else "album_"
            key += "" if variant == "worker" else "legacy_"
            rec.update({f"{key}ms": ms, f"{key}plain_ms": plain_ms})
            print(f"phase 46 gain_limit {what} {variant} "
                  f"{tuple(xr.shape)} -> ({tracks}, {n}, {c}), "
                  f"{100 * over.float().mean().item():.2f} % over the "
                  f"threshold: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}),"
                  f" {100 * bnd['bound_ms'] / ms:.1f} % of it ({card})")
        prefix = "" if what == "track" else "album_"
        rec.update({f"{prefix}bound_ms": bnd["bound_ms"],
                    f"{prefix}bound_by": bnd["bound_by"]})
    rec["library_ms"] = None
    print("phase 46 ok", flush=True)


LIMITER_FLOPS = (256, 12)   # the FIR's a sample and channel; a frame's


def limiter_case(what, tracks, kernels_rec, card):
    """K10 through the limiter's route against its twin on ``tracks``
    (each a whole track), timed."""
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
    from python_audio_mastering_tpu_torch.ops import limiter as lim

    def route():
        return [lim.lookahead_limiter(x, FS) for x in tracks]

    worst = [0.0, 0.0]
    cmb.reset_launch_counts()
    for x in tracks:
        got = lim.lookahead_limiter(x, FS)
        want = lim.lookahead_limit_ref(x, FS)
        # the gain on each frame's loudest channel, relative to the twin's
        big = x.abs().argmax(dim=1, keepdim=True)
        xb = x.gather(1, big).double()[:, 0]
        keep = xb.abs() > 1e-3
        g_got = got.gather(1, big).double()[:, 0] / xb
        g_want = want.gather(1, big).double()[:, 0] / xb
        g_rel = ((g_got - g_want).abs() / g_want)[keep].max()
        worst = [max(worst[0], (got - want).abs().max().item()),
                 max(worst[1], g_rel.item())]
        del got, want
    launches = cmb.launch_counts()["lookahead_limit"]
    frames = sum(x.shape[0] for x in tracks)
    c = tracks[0].shape[1]
    bnd = bound((LIMITER_FLOPS[0] * c + LIMITER_FLOPS[1]) * frames,
                8 * c * frames)
    print(f"phase 47 lookahead_limit {what}: {len(tracks)} tracks, {frames} "
          f"frames x {c}: launches {launches}, max abs vs the twin "
          f"{worst[0]:.3e}, gain {worst[1]:.3e} of the twin's", flush=True)
    check(launches == len(tracks), f"{what}: {launches} launches for "
                                   f"{len(tracks)} tracks")
    check(worst[0] <= 1e-6 and worst[1] <= 2e-6,
          f"{what}: K10 vs its twin {worst}")
    ms = queued_ms(route, reps=5)
    check(bnd["bound_ms"] / ms <= 1.05,
          f"lookahead_limit {what}: {ms} ms, under its bound "
          f"{bnd['bound_ms']} ms: the time leaves out some work")
    plain_ms = median_of(lambda: cuda_ms(
        lambda: [lim.lookahead_limit_ref(x, FS) for x in tracks], reps=2),
        runs=3)
    key = "" if what == "track" else "album_"
    kernels_rec.update({f"{key}ms": ms, f"{key}plain_ms": plain_ms,
                        f"{key}bound_ms": bnd["bound_ms"],
                        f"{key}bound_by": bnd["bound_by"]})
    print(f"phase 47 lookahead_limit {what}: kernel {ms:.4f} ms, twin "
          f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']}), {100 * bnd['bound_ms'] / ms:.1f} % of it "
          f"({card})", flush=True)


def lookahead_limit_phase(o, kernels, card):
    """Phase 47: K10 ``lookahead_limit`` on the 180 s track made hot and on
    an album's 12 tracks (``o`` from :func:`main_path_operands`): its
    agreement with its twin and its time; the main path's launches are
    phase 15's."""
    dev = o.xrows.device
    rec = kernels.setdefault("lookahead_limit", {})
    limiter_case("track", [torch.from_numpy(o.x * 2.0).to(dev)], rec, card)
    gen = torch.Generator(device=dev).manual_seed(47)
    tracks = []
    for i in range(BENCH_ALBUM_TRACKS):
        n = int(FS * (150 + 270 * (i + 0.5) / BENCH_ALBUM_TRACKS))
        t = torch.arange(n, device=dev) / FS
        x = (0.5 * torch.sin(2 * np.pi * 55.0 * t)[:, None]
             + 0.4 * torch.randn((n, 2), generator=gen, device=dev))
        x[n // 4: n // 2] *= 3.0                   # hard limiting
        tracks.append(x)
    limiter_case("album", tracks, rec, card)
    rec["library_ms"] = None
    print("phase 47 ok", flush=True)


if __name__ == "__main__":
    try:
        sys.exit(kernel_times() if sys.argv[1:] == ["--kernel-times"]
                 else main())
    except PhaseFailed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
