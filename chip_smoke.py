#!/usr/bin/env python3
"""On-card smoke test and first measurements of sed_tpu_torch.

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_smoke.py

It drives the PyTorch + CUDA port only (nothing of JAX or sed_tpu) and exits
non-zero on the first failure.  Phases:

  1. card     device name, ``nvidia-smi`` name and power limit; builds the
              kernels from ``sed_tpu_torch/ops/csrc`` with nvcc and prints
              the build time and ptxas' registers, shared memory and spills;
              the lesion builds (``LESIONS``: K6's three, the drain's
              exchange of K3 and K1, K5's epilogue, K2's copies and sums,
              K6t's frame split, table copies and drain) start after it,
              beside phases 2-7, one nvcc for each distinct edit, each with
              only its entry point's object of the source (``LESION_FLAGS``);
  2. kernels  K1 and K2 against their plain versions computed in float64 on
              the card, at the batch path's shapes (16 x 60 s), and K2 on the
              batch's rows from row 1 on (off a 16-byte boundary, up to the
              allocation's end) equal to the aligned rows' result; K3 at the
              streaming tick's shape (32 slots x 5 frames = 160 rows), float32
              and int16, K2 on its 160 rows and K3 + K2 (``logmel_frames``)
              against the float64 chain;
  3. slice    ``make_batch_predictor(device="cuda")`` with
              CnnAvgPooling(TRAIN_CHANNEL_AND_POOL) on 16 x 60 s int16 clips,
              then one uint8 µ-law batch; launch counts reset just before and
              read just after; clip 0 against ``device="cpu"``;
  4. CLI      ``python -m sed_tpu_torch.cli.infer --batch`` on two WAV files;
  5. pool     ``StreamPool(device="cuda")``, 32 slots, 1 s chunks: 32 streams
              of 60 s int16 audio fed in uneven pieces through feed/tick, two
              joining late and one leaving early; launch counts reset just
              before and read just after; every stream's scores (ticks + tail)
              against ``make_batch_predictor`` on the same audio;
  6. stream   ``python -m sed_tpu_torch.cli.stream`` on three WAV files;
  7. server   ``StreamServer`` on 127.0.0.1: four pcm16 clients, then one
              µ-law client, each against offline scoring of its audio;
  8. times    CUDA-event medians of K1, K2, K3, their plain versions, a
              PyTorch yardstick for each, the featurizer, the model and the
              whole 16 x 60 s batch; K3's share of its bound and its ratio
              to ``torch.fft.rfft`` + abs^2, each also with the calls
              queued (K3 takes tens of microseconds, less than one call's
              launch latency), and K3 and K1 rebuilt without their drain's
              exchange (wrong results, timing only: what the exchange
              costs); K2 at the tick's 160 rows, one call and queued, beside
              its bound, and K2 rebuilt without its copies and without its
              sums at both row counts (its time split into copies and sums);
              a
              single-round tick and a 16-round block of the 32-slot pool,
              and the tick's device time by kernel
              (``torch.profiler``); the pool run's profile split, audio-s per
              wall-s and peak device memory;
  9. impls    every implementation name of sed_tpu's featurizer on phase 3's
              16 x 60 s batch, ingested to f32 on the card: each of
              ``logmel_waveform(impl=...)`` with launch counts reset just
              before and read just after (exactly the kernels its row of
              ``IMPL_KERNELS`` names, once each) and within 1e-4 dB of the
              float64 chain; the K4 route ``logmel_features_batch(...,
              use_pallas=True)`` likewise; K5 against K1 then K2 (equal),
              K6 against its float64 plain version, 'pack''s and 'eo''s power
              against float64; CUDA-event medians of K4–K10 through their own
              entry points, their plain versions and PyTorch yardsticks, and
              of the whole ``logmel_waveform`` for each name; K6's share of
              its bound and its ratio to ``torch.fft.fft``, K6 rebuilt
              without its loads, its exchanges or its twiddles, and K5
              without its band epilogue (wrong results, timing only: what
              each part of their time is);
 10. files    the per-file path of ``cli/infer.py`` without ``--batch``, on
              two seeded WAVs (noise with tonal bursts, 48 kHz int16): 10
              minutes (1,819 frames: uniform windows of 1,152 frames and a
              ragged tail; cut from 20 minutes to hold the script near 700
              s) and 2 minutes, with CnnAvgPooling
              (TRAIN_CHANNEL_AND_POOL), MobileNetV1 and M5, each with seeded
              weights and BatchNorm statistics: ``predict_file`` (window 1024,
              halo 64, 88 after MobileNetV1's floor) equal to the whole
              forward on the card, one K1 and one K2 launch per file (counts
              reset just before, read just after), and equal to the CPU on the
              2-minute file; ``predict_file_m5`` with both stems, the card's
              framing equal to the host's, card against CPU;
              ``make_batch_predictor`` with MobileNetV1 on phase 3's batch;
              ``python -m sed_tpu_torch.cli.infer --no_plot --arch ...`` for
              the three archs (run side by side) against the in-process
              scores; the long file's K1 rows and K2 on them, and each
              ``predict_file``'s log-mel, against float64, and the 2-minute
              file's log-mel against the CPU; per-file calls split into WAV
              read, featurizer and model inside each call (median and range),
              audio-s/s with and without the read, M5's direct stem against
              its space-to-depth stem and its frame bucket (32, 128, 256),
              MobileNetV1's batch, and peak device memory.
 11. train    training of the spectrogram family on the card: a seeded
              FilmClap-layout corpus (32 x 60 s 48 kHz int16 WAVs, 3-5 s
              tonal bursts as the labelled events) preprocessed in logMel
              mode by ``preprocess_film_clap_data`` (exactly one K1 and one
              K2 launch a file, counts reset just before and read just
              after; one file within 1e-4 dB of ``device="cpu"``) and 8 of
              them in Complex mode (no launch); ``train`` of CnnAvgPooling
              (TRAIN_CHANNEL_AND_POOL) at batch 128, 400 steps at lr 3e-3:
              the validation loss falls and AP > max(AP0, 0.5), metrics.jsonl
              with sed_tpu's keys, no featurizer launch while training; the
              first 5 steps on the card against the CPU from one state, in
              float64 (losses 1e-4 relative, first gradients 1e-4 of each
              tensor's largest; in float32 the card's BatchNorm backward
              sums in float32 and its gradients part from float64 by ~4e-3,
              so the first float32 loss is compared and the float32
              gradients reported); resume from a checkpoint at step 10 equal
              to the uninterrupted run (cuDNN deterministic for both), and
              the checkpoint scored through ``cli/infer.load_model``;
              Complex mode with augmentation (finite losses, the transform
              card against CPU within 1e-4 dB); MobileNetV1 (emit='logits');
              ``make_batch_evaluator`` on 4 x 60 s int16 clips against
              ``make_batch_predictor`` (one K1 and one K2 launch); times:
              the train step for each arch, mode and augmentation, its split
              by profiler range, im/sec, evaluate ms per recording,
              preprocess ms per file (read, featurize), peak memory.

 12. wavetrain M5 training on the card, on phase 11's corpus:
              ``WaveformDataset`` (0.25 validation) and
              ``waveform_buffers_from_dataset`` (one upload);
              ``train(mode="waveform")`` of M5(1) at batch 128 x 31,680
              samples, 400 steps at lr 3e-3: the validation loss falls and AP
              > max(AP0, 0.5), metrics.jsonl with sed_tpu's keys, no launch of
              any K1–K10 kernel while training (counts reset just before, read
              just after); the first 5 steps on the card against the CPU from
              one state in float64 at batch 32 (losses 1e-4 relative, first
              gradients 1e-4 of each tensor's largest), the first float32
              loss, and the float32 gradients' distance from float64;
              augmentation on (finite losses, the apply card against CPU
              within 1e-6 on one set of draws); ``make_multi_step`` with K = 4
              against 4 single calls (one state, one generator seed, cuDNN
              deterministic) for M5 and CnnAvgPooling: equal; resume at step
              10 equal to the uninterrupted run; ``profile_dir`` with
              steps_per_call 4: one trace of steps 12-20 holding
              ``train_step/forward`` and ``/backward``;
              ``make_batch_predictor`` and ``make_batch_evaluator`` called
              again after ``model.train()`` score as in eval mode, leave the
              running statistics alone, and a train step runs after them (P2);
              both TF32 flags off inside each call and the caller's after it
              (P3); ``python -m sed_tpu_torch.cli.main --no_plot`` with its
              defaults (Waveform, M5) on 4 of the files for 4 steps (run
              beside the untimed checks), its checkpoint scored by ``python -m
              sed_tpu_torch.cli.infer --arch M5`` against the in-process
              scores; times: M5's step with augmentation off and on (and once
              with cuDNN's benchmark mode), its split by profiler range and
              the kernels' share, the step with steps_per_call 1 and 4 for M5,
              CnnAvgPooling and MobileNetV1, im/sec, evaluate ms a recording,
              peak memory.

 13. serve    sed_tpu's checkpoints and the live serving of MobileNetV1 and M5,
              at full width with seeded weights and BatchNorm statistics:
              for each arch a port ``iteration_7.pt`` through ``python -m
              sed_tpu_torch.cli.export_torch`` (a reference ``.pth``) and
              ``cli.import_torch`` (``iteration_7.pt`` again), every weight
              bit-equal; ``load_model_and_state`` of the ``.pth`` and of the
              imported ``.pt`` on the card scores phase 10's 2-minute WAV as
              the original weights (one K1 and one K2 a spectrogram file,
              counts reset just before, read just after), and so does ``cli.infer
              --no_plot`` of the imported file; MobileNetV1 (its logits view,
              halo 88) in a 32-slot ``StreamPool`` on phase 5's run (uneven
              pieces, late joins, an early leaver), every stream against
              ``make_batch_predictor``, K3 and K2 on its ticks, and again with
              ``featurizer="xla"`` (no launch); M5 in
              ``DeviceWaveformStreamPool`` and ``WaveformStreamPool`` on the
              same run with one mulaw stream and a 20 s backlog (blocks of 16
              rounds), every stream against offline framing, the two pools
              against each other, no K1–K10 launch; ``cli.stream --arch
              MobileNetV1`` and ``--arch M5`` (both ``--m5_pool``) on three
              WAVs; ``StreamServer`` over a MobileNetV1 pool and an M5 device
              pool, two pcm16 clients and one mulaw client each, against
              offline scoring; times: MobileNetV1's tick and M5's device
              round at 32 slots (CUDA events), each pool's feed + tick by the
              host clock, the device time of both by kernel
              (``torch.profiler``), audio-s per wall-s and peak memory of the
              three pool runs.

 14. int8    int8 PTQ and QAT on the card (``ops/int8.py``: im2col gathers and
              ``torch._int_mm``; ``models/quantize.py``, ``models/qat.py``),
              at full width with seeded weights and BatchNorm statistics:
              ``int8_matmul`` at odd shapes (rows 1-16, K 9/79/288/1152, N
              1/11/64) and five int8 convolutions equal to their plain
              versions; ``predict_file(quantize="int8")`` on phase 10's
              2-minute WAV for CnnAvgPooling and MobileNetV1 (one K1 and one
              K2 a file, counts reset just before, read just after) and
              ``predict_file_m5(quantize="int8")`` (no K1–K10), each equal to
              its artifact's forward on the card, the artifact's card scores
              within 5e-3 of its CPU scores (M5 on 32 frames), and against
              the float run of the same file (reported); ``cli.infer
              --quantize int8`` for the three archs (side by side) against
              the in-process scores; an int8 ``StreamPool`` (CnnAvgPooling,
              calibrated on stream 0) on phase 5's run, every stream within
              5e-3 of offline int8 scoring, K3 + K2 on its ticks; an int8
              ``DeviceWaveformStreamPool`` (M5) on phase 13's run within 1e-6
              of offline int8, no K1–K10; ``qat_finetune(mode="distill")`` at
              full width on the served CnnAvgPooling: 20 float32 steps on
              the card lower the int8 deviation (timed), and from one state
              the first 5 losses on the card follow the CPU's in float64
              (1e-4 relative; float32 reported); on phase 3's model (every folded
              BatchNorm bias exactly 0, so exactly cancelled sums sit on the
              ReLU's kink) the float64 first-step gradients card vs CPU and
              CPU vs CPU with the activation scales one ulp up (reported),
              and with the biases moved 1e-6 off 0 card vs CPU (1e-10);
              times:
              int8 against float32 forwards of each arch (16 x 60 s, M5 on a
              128-frame block), ``_int_mm``'s share of the int8 forward's
              device time (``torch.profiler``), each int8 forward's peak
              memory, and the 32-slot tick in float32 and int8.

 15. aot     AOT serving artifacts (``sed_tpu_torch.export``, ``cli/serve.py``)
              at full width, 16 x 60 s int16: eight artifacts built by
              ``python -m sed_tpu_torch.cli.serve build`` side by side
              (CnnAvgPooling float32, int8, QAT int8 and bf16; MobileNetV1
              float32 and int8; M5 float32 and int8; the spectrogram archs
              with phase 3's statistics, int8 calibrated on a WAV); each
              loaded here (``load_aot_fn``) and held against the eager path on
              the same PCM with the artifact's own weights (float32 and bf16
              within 1e-5, int8 equal), one call's launch counts reset just
              before and read just after (one K1 and one K2 for each
              spectrogram artifact, none for M5), CnnAvgPooling's float32
              artifact within 1e-5 of ``make_batch_predictor`` and its bf16
              one within 0.05 of it; ``cli.serve run`` in a fresh process on a
              copy of the package with no ``_build/`` and an ``nvcc`` that
              only records being called, twice (cold: the artifact installs
              its library; warm), nvcc never running, its scores against
              this process's; times: build seconds and bytes per artifact,
              artifact_load_seconds and load_to_first_result_seconds cold and
              warm beside phase 1's nvcc seconds, each artifact's batch
              against the same work called eagerly and ``make_batch_predictor``,
              and bf16 against float32 forwards of each arch.

 16. bf16    the bf16 tier on the live paths and in training, and the native
              WAV reader (``sed_tpu_torch/io/native.py``, built with g++ from
              ``io/csrc/sed_native.cpp`` in phase 1): phase 3's CnnAvgPooling
              as a bfloat16-compute copy in a 32-slot ``StreamPool`` on phase
              5's run beside the float32 pool (every stream within 0.05, not
              equal; the same K3 and K2 launches, counts reset just before
              and read just after each run), MobileNetV1's logits view (halo
              88) and M5 in ``DeviceWaveformStreamPool``, bf16 against float32,
              on phase 13's 32 streams cut to 20 s; CnnAvgPooling (logMel) and
              M5 trained 100 steps at batch 128 on phase 11's corpus in bf16
              and float32 from one init (the bf16 validation loss falls;
              parameters, optimizer state, BatchNorm statistics and the
              checkpoint float32; no featurizer launch), M5's
              ``WaveformDataset`` read with ``workers=8`` equal to
              ``workers=0``'s; the reader: phase 10's 10-minute WAV through
              ``read_wav`` equal to the scipy plain version, phase 11's 32
              WAVs through ``read_multichannel_audio_batch(workers=8)`` equal
              to ``workers=0`` and to the plain path, and ``preprocess_data
              (workers=8)`` (one K1 and one K2 a file) writing ``workers=0``'s
              pickles; times: the tick and M5's round in bf16 and float32
              (with the tick's device time by kernel), the bf16 and float32
              train steps, the 10-minute read native against scipy, the
              corpus read and the preprocessing with 8 workers against 0.
 17. mesh    data parallelism (``sed_tpu_torch.parallel``) at world size 1
              over NCCL, in this process: ``create_mesh(1)``; ``train(mesh=)``
              against ``train()`` for one float32 CnnAvgPooling step at batch
              128 on phase 11's corpus (loss, parameters at lr 1e-6,
              BatchNorm statistics, the gradients it applied within
              ``MESH_GRAD32_REL`` of their tensor's largest, the checkpoint),
              the float32 step of CnnAvgPooling and M5 through
              ``shard_train_step`` against the plain step (the same, with the
              first gradients), and 5 float64 steps with augmentation of each (M5 as two calls of
              ``steps_per_call=2`` and one single step) against the plain
              steps, at ``tests/test_parallel.py``'s tolerances;
              ``make_batch_predictor(mesh=)`` on phase 3's batch (one K1 and
              one K2 launch a call, counts reset just before and read just
              after, within 1e-6 of the plain predictor) and
              ``batch_predict_files(mesh=)`` on 3 of phase 11's WAVs; a
              32-slot ``StreamPool(mesh=)`` on phase 5's run cut to 20 s,
              with 'auto' (K3 and K2 on the rank, in pairs, counts reset
              just before and read just after) and with 'xla' (no launch),
              each against ``make_batch_predictor`` and against each other,
              and ``featurizer='pallas'`` refused with ``sed_tpu``'s error;
              the group torn down after; ``python -m
              sed_tpu_torch.cli.main --num_devices 2`` refused with
              ``sed_tpu``'s message on a one-card host (with two cards or
              more: 20 steps of ``cli.main`` and ``cli.infer --batch`` at 2
              ranks against 1); times: the float32 train step of each arch
              (and its host enqueue time) and the 16 x 60 s scoring batch,
              plain and on the mesh, in turns, and the train steps again in
              two child processes (``mesh_step_child``), NCCL's flight
              recorder off in one and on in the other.
 18. shard   sharded AOT artifacts and the resume of ``sed_tpu``'s ``.ckpt``:
              phase 3's CnnAvgPooling in float32 and int8 (calibrated on the
              batch's features) exported plain and with ``mesh=`` on
              ``create_mesh(1)`` over NCCL, the sharded ones loaded with
              ``load_aot_fn(mesh=)`` (placed on the rank's device; its rows,
              then the gather), one call's launch counts reset just before
              and read just after (one K1 and one K2 through the exported
              graph), scores within 1e-6 of the plain artifact's; the
              full-width CnnAvgPooling and M5 trained 2 float32 steps on
              phase 11's corpus, saved as the port's ``.pt`` and written as
              ``sed_tpu``'s ``.ckpt`` by ``tests/torch_flax_ckpt.py`` (no
              JAX on the card's host), 3 float64 steps from each equal to
              1e-12; ``python -m sed_tpu_torch.cli.main --resume auto`` (M5)
              for 4 steps in a run directory that holds only a ``.ckpt``;
              times: each sharded artifact's batch against the plain one's,
              in turns.
 19. classical the SVM baseline (``sed_tpu_torch.classical``), ``sed_tpu``'s
              orbax checkpoints and the exploration scripts: a seeded
              FilmClap-layout corpus made on the card (16 x 342 s and one
              20 s 48 kHz int16 WAV, clap-like events in noise);
              ``get_raw_data`` on the card (16,619 rows), the short file's
              rows within 1e-4 dB of ``device="cpu"``; ``SVMDetector(
              soft_svm=True)`` fitted on 16,384 rows x 64 mel bins on the
              card (recall-priority weights; fit and predict times, SMO
              iterations, support vectors, peak memory beside the card's
              name and power limit; ``evaluate_model`` on the short file);
              the same fit of the first 2,048 rows against the CPU's float64
              fit in a process of its own (``svm_cpu_child``, run beside the
              card's fits): decision values and probabilities within 1e-3;
              libzstd loaded, the committed orbax fixture
              (``tests/golden/torch_orbax``) read equal to its msgpack twin
              and resumed on the card for 2 steps, equal to the ``.ckpt``'s
              resume; ``python -m sed_tpu_torch.scripts.analyze_spectogram
              --no_plot`` on a 60 s WAV (called in this process: one K1 and
              one K2 launch, counts reset just before and read just after;
              within 1e-4 dB of the CPU), ``scripts.play_with_spectograms``
              on 4 of the WAVs (one K1 and one K2 a preprocessed file; its
              held-out accuracy within 2 rows of the same features through
              the CPU's SVC) and ``scripts.plot_waveform_frames --no_plot``
              on one (20 crops).
 20. tiers   the reduced-precision featurizer tiers: ``cli.serve build
              --featurizer_precision turbo`` started in the background; K1t
              (``wave_dft_power_bf16``, the bf16 tensor-core DFT with K1's
              framing: the split pass, then ``tier_fused_kernel``; the tier
              GEMMs at bf16x6, as the library's plan says) on a 16 x
              60 s batch and K3t (``frames_dft_power_bf16``, K3's rows,
              float32 and int16) at the tick's 160 rows, each at
              ``TIER_PRECISIONS`` (fast, turbo, bf16x4, bf16x6 and the pair
              (bf16x1, bf16x3)) against its plain version (``tier_rel_tol``);
              K2's bf16x1 and bf16x3 product modes at 2912 and 160 rows
              against theirs (1.5e-5 dB); each kernel's output nearer its
              own mode's plain version than the next modes' (``kernels.
              mode_fraction``, ``TIER_NEIGHBOURS``, ``MEL_NEIGHBOURS``);
              fast's and turbo's log-mel against float64 on broadband noise (1e-3 and 0.05 dB; sums of sines
              reported only); ``make_batch_predictor`` at fast and turbo (one
              K1t and one K2 launch a call, counts reset just before and read
              just after; scores within 1e-4 and 2e-3 of parity's),
              ``cli.infer --batch --featurizer_precision fast`` in this
              process, ``predict_file`` at turbo, a 32-slot ``StreamPool`` at
              turbo on phase 5's run cut to 20 s (K3t, no K3), and
              ``logmel_waveform(mel_precision=)`` (K2's bf16 modes), each
              against the batch path at its tier; the turbo artifact: its
              custom operators, one call's launches (one K1t, one K2), equal
              to the eager path, and ``cli.serve run`` in a fresh process;
              times: each tier's K1t and K3t (one call and queued) beside K1
              and K3, K1t's split pass and fused kernel on their own and the
              tier GEMMs' route over the same frames (through the C calls),
              their plain versions, ``torch.stft`` + abs^2 (a higher
              fidelity), the same split operands through cuBLAS bf16
              matmuls, the bound (bytes, or tensor FLOPs at the card's dense
              bf16 peak), K2's modes, and the batch at each tier.

 21. fusepack 'fuse' and 'pack' at the reduced tiers, on phase 3's 16 x 60 s
              batch ingested to f32: ``logmel_waveform(impl='fuse')`` at
              each of ``TIER_PRECISIONS`` and at the mel modes
              (``FUSE_MEL_RUNS``: K5b at parity, K5t at a tier), and
              ``impl='pack'`` at each precision, launch counts reset just
              before and read just after each (exactly ``impl_kernels``' row,
              once each: ``REDUCED_IMPL_KERNELS``' at a tier); K5t equal to K1t
              then K2 and K5b to K1 then K2's mode (bit for bit; 1e-5 dB at
              most); K6t (``wave_packed_fft_bf16``) against its plain version
              (``tier_rel_tol`` x the frame's peak |Z|) and nearer its own
              mode than the next ones on broadband noise (``mode_fraction``);
              both impls' log-mel against float64 on broadband noise at fast
              and turbo (1e-3 and 0.05 dB); times: K5t beside K1t then K2 and
              K6t beside 'pack' at each precision, K5b beside K1 then K2b and
              K5, the parity 'fuse' and 'pack', the plain versions at fast,
              each bound (tensor FLOPs at the dense bf16 peak, the mel's at
              FP32, or bytes) and the PyTorch yardsticks (``torch.stft`` +
              abs^2 + ``matmul`` + ``log10``; ``torch.fft.fft`` of the packed
              frames); K6t (the wgmma kernel) through its C call at fast and
              turbo, whole and rebuilt without its frame split, its table
              copies and its drain's stores (phase 1's lesion builds: wrong
              results, timing only).
 22. wide    n_fft 65536 and 131072 (96 and 192 kHz) through every
              featurizer kernel: at both rates, on two signals of 5 hops
              (frames over the reflection edges and interior ones), K1, K3
              (float32, int16) and K6 over a cluster of 2 or 4 CTAs a frame
              against float64 (1e-5 x the frame's peak), K1 then K2 within
              1e-4 dB, K5 and K5b (mel bf16x1, bf16x3) equal to K1 then K2
              bit for bit, and K1t, K3t, K6t at fast, turbo and bf16x6
              (n1 256: K1t and K3t on the tier GEMMs, which the library's
              fused plan gives them there) against their plain versions
              (``tier_rel_tol``) and K5t equal to K1t then K2; at 96 kHz on
              phase 3's 16 x 60 s batch: ``make_batch_predictor`` (one K1
              and one K2 launch, counts reset just before and read just
              after; clip 0 against the CPU within 1e-4), 'fuse', 'pack',
              and 'roll', 'fuse', 'pack' at fast (exactly ``impl_kernels``'
              row each, the tier GEMMs' kernels once a frame group), a
              4-slot ``StreamPool`` for 8 s (the tick: K3 and
              K2; scores against the batch path), ``logmel_frames`` within
              1e-4 dB of float64; times at 96 kHz: K1, K2, K5, K6, K3 (at a
              32-slot tick's 160 rows, cut from the batch's clips, checked
              against float64 and timed queued), K1t, K5t and K6t at fast and the
              predictor, beside their bounds, plain versions and PyTorch
              yardsticks.
 23. range   the ends of the n_fft range through every featurizer
              kernel: at 1 kHz (n_fft 1024: the tiers' small end), 384 kHz,
              768 kHz and 1.536 MHz (n_fft 2^18, 2^19, 2^20: the global cross
              pass and the tier GEMMs), on two 10 s signals of noise, every
              impl sed_tpu computes there at parity and fast, launch counts
              reset just before and read just after each (exactly
              ``impl_kernels(impl, precision, n_fft=)``' row, once each),
              within 1e-4 dB (parity) and 1e-3 dB (fast) of the float64
              chain; K1, K3 (float32, int16) and K6 within 1e-5 x peak of
              float64, K5 and K5b equal to K1 then K2, K1t, K3t, K6t at fast,
              turbo and bf16x6 within ``tier_rel_tol`` of their plain
              versions and each nearer its own mode than the next
              (``mode_fraction``), K5t equal to K1t then K2; at 384 kHz on a
              16 x 60 s batch the predictor (its row once each; clips 0 and
              15 within 1e-5 of the CPU path); times at 384 kHz and 1.536
              MHz, 16 x 60 s: K1, K2, K5, K6, K1t, K5t and K6t beside their
              bounds, plain versions (the tier ones on one clip's frames)
              and PyTorch calls, and that batch itself (and an untimed one
              at 768 kHz) checked clip by clip:
              K1, K3 (float32, int16) and K6 within 1e-5 x peak of float64,
              K1 then K2 within 1e-4 dB, K1t, K3t and K6t at fast within
              ``tier_rel_tol`` of their plain versions, K5 and K5t equal to
              their chains; at 384 kHz each launch of the Stockham route on
              its own through its C call (the cross pass, the sub-rows' FFT,
              the unpack) beside a plain version of it, its error on the
              first and the last clip's frames; at 1 kHz (K1t and K6t at
              fast too), 384 kHz and 1.536 MHz the tier GEMMs' launches of
              K1t at fast on their own over every frame group (the split
              pass, stage 1, stage 2), each beside its plain version, the
              same chunk planes through cuBLAS bf16 matmuls and its bound.
              On the routes of more than one launch the counts are the
              kernels' (the cross pass, the sub-rows, the unpack, the tier
              GEMMs' split pass and stages, K2), never the wrapper's name.

Then one ``{"kernels": [...]}`` JSON line (K1–K10, then K1t, K3t and K2's
bf16 modes with phase 20's figures, then K5t, K5b and K6t with phase 21's,
then the n_fft 65536 instances of K1, K2, K3, K5, K6, K1t, K5t and K6t with
phase 22's, then K1, K2, K5, K6, K1t, K5t and K6t at 384 kHz and 1.536 MHz
(a multi-launch route's ``launches``: its kernels' in the main-path run,
summed, and each in ``route_launches``), K1t and K6t at 1 kHz, and the
routes' own kernels (the cross pass, the sub-rows' FFT, the unpack at 384
kHz; the tier GEMMs' split pass and two stages at 1 kHz, 384 kHz and 1.536
MHz) with phase 23's; K1's and K2's with the training path's
launches, every entry with phase 12's, 0, phase 13's, phase 14's, phase
15's, phase 16's, phase 17's, phase 18's, phase 19's, phase 20's, phase
21's, phase 22's and phase 23's), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"
BATCH = 16          # clips in the scored batch (bench.py's production batch)
SECONDS = 60
POOL_SLOTS = 32     # streaming pool: slots and streams
POOL_SECONDS = 60
LATE_JOINS = {POOL_SLOTS - 2: 3, POOL_SLOTS - 1: 7}   # stream -> tick it joins
EARLY_LEAVER, EARLY_SECONDS = 5, 25.25
CLI_SECONDS = (20.0, 33.3, 45.0)                      # stream CLI files
SERVER_SECONDS = (12.0, 15.5, 9.1, 20.0)              # pcm16 clients
MULAW_SECONDS = 14.0
K1_REL_TOL = 1e-5   # K1, K3: abs error / frame peak power, against float64
DB_TOL = 1e-4       # K2, K1+K2 and K3+K2: dB, against float64
SCORE_TOL = 1e-4    # scores, against the batch path or the CPU
FILE_SECONDS = (600.0, 120.0)   # per-file phase: the long file (card), the short one (+ CPU)
FILE_WINDOW, FILE_HALO = 1024, 64  # cli/infer.py's defaults
FILE_REPS = 5       # per-file calls timed by stage (they read the WAV)
M5_BUCKETS = [32, 128, 256]  # M5 frame buckets timed in phase 10
TRAIN_FILES, TRAIN_SECONDS = 32, 60.0   # phase 11 corpus: FilmClap layout, 48 kHz mono
TRAIN_COMPLEX_FILES = 8   # of them, also preprocessed in Complex mode
TRAIN_BATCH = 128         # cli/main.py's batch (crop: cfg.train_crop_size, 30 frames)
TRAIN_STEPS, TRAIN_LR = 400, 3e-3   # tests/test_loop.py's learning rate
CPU_STEPS = 5             # card against CPU
RESUME_AT, RESUME_STEPS = 10, 20
FEW_STEPS = 10            # Complex + augmentation, MobileNetV1
EVAL_CLIPS = 4            # make_batch_evaluator: 4 x 60 s int16 clips
TRAIN_REL_TOL = 1e-4      # card against CPU: losses (relative), gradients (x largest |grad|)
TRAIN_PROFILE_STEPS = 5
WAVE_BATCH = 128          # cli/main.py's batch: 128 crops of 31,680 samples (M5)
WAVE_CPU_BATCH = 32       # M5 card against CPU in float64 (cut from 128: the CPU's time)
WAVE_VAL = 0.25           # validation share of phase 11's corpus (8 of 32 files)
WAVE_CLI_FILES = 4        # the training CLI's run: a subset of the corpus
CONV_BIASES = (".0.bias", ".3.bias")   # M5's conv biases, each removed by a BatchNorm
STEPS_PER_CALL = 4
SERVE_ARCHS = ("CnnAvgPooling", "MobileNetV1", "M5")
SERVE_STEP = 7            # the step the converted checkpoints carry
SERVE_MULAW = 4           # the M5 pools' mulaw stream
SERVE_BACKLOG = (3, 20 * 48000)   # M5 stream 3's first piece: 20 s, more than 16 rounds
SERVE_STREAM_RUNS = (("MobileNetV1", []), ("M5", ["--m5_pool", "device"]),
                     ("M5", ["--m5_pool", "host"]))
JSONL_KEYS = {"iteration", "train_loss", "val_loss", "AP", "max_f1", "max_f5", "event_tp",
              "event_fp", "event_fn", "event_precision", "event_recall", "event_f1",
              "segment_tp", "segment_fp", "segment_fn", "segment_precision", "segment_recall",
              "segment_f1", "segment_substitutions", "segment_deletions", "segment_insertions",
              "segment_n_ref", "segment_error_rate", "AP_per_class", "macro_AP",
              "event_macro_precision", "event_macro_recall", "event_macro_f1",
              "segment_macro_precision", "segment_macro_recall", "segment_macro_f1"}
INT8_SHAPES = [(m, k, n) for m in (1, 5, 16) for k in (9, 79, 288, 1152) for n in (1, 11, 64)]
INT8_BAND = 5e-3    # card int8 against the CPU's on one artifact (sed_tpu's band
                    # between its own two int8 graphs)
M5_INT8_TOL = 1e-6  # M5 streamed int8 against offline int8 (sed_tpu's)
M5_CPU_FRAMES = 32  # frames of the 2-minute file M5's CPU int8 scores
M5_BLOCK = 128      # M5's timed block of frames
# QAT at full width: Adam moves each of a layer's ~147k weights by about lr a
# step, so the 20 distill steps take lr 1e-6.
QAT_STEPS, QAT_LR = 20, 1e-6
# The serving artifacts of phase 15: (tag, arch, build flags).  "CALIB" is
# the calibration WAV.
AOT_BUILDS = (
    ("cnn_f32", "CnnAvgPooling", []),
    ("cnn_int8", "CnnAvgPooling", ["--quantize", "int8", "--calib_wav", "CALIB"]),
    ("cnn_qat", "CnnAvgPooling", ["--quantize", "int8", "--calib_wav", "CALIB",
                                  "--qat_steps", "10", "--qat_lr", "1e-6"]),
    ("cnn_bf16", "CnnAvgPooling", ["--bf16"]),
    ("mobilenet_f32", "MobileNetV1", []),
    ("mobilenet_int8", "MobileNetV1", ["--quantize", "int8", "--calib_wav", "CALIB"]),
    ("m5_f32", "M5", []),
    ("m5_int8", "M5", ["--quantize", "int8", "--calib_wav", "CALIB"]),
)
AOT_TOL = 1e-5      # a float32 artifact against the eager path
AOT_M5_REPS = 5     # timed groups of M5's artifacts (device-bound: 58 and 166 ms)
BF16_BAND = 0.05    # bf16 scores against float32's (sed_tpu's band, tests/test_stream_pool.py:737)
BF16_SECONDS = 20   # phase 16's MobileNetV1 and M5 streams (phase 13's, cut from 60 s)
BF16_STEPS = 100    # phase 16's bf16 training steps a model
MESH_LR = 1e-6      # phase 17's float32 steps (the training CLI's lr; see mesh_phase)
MESH_STEPS = 5      # phase 17's float64 steps a model, mesh against plain
MESH_POOL_SECONDS = 20   # phase 17's pool run: phase 5's, cut from 60 s
MESH_LOSS_RTOL, MESH_PARAM_ATOL = 1e-5, 1e-5   # tests/test_parallel.py:70, :72
MESH_BN_RTOL, MESH_BN_ATOL = 1e-5, 1e-6        # tests/test_parallel.py:75
MESH_GRAD_RTOL, MESH_GRAD_ATOL = 1e-3, 5e-6    # tests/test_parallel.py:214-215
MESH_SCORE_TOL = 1e-6                          # tests/test_parallel.py:95
# Phase 17's float32 first gradients, mesh against plain: each tensor's
# largest difference over its largest value.  The readings were 2.8e-3 to
# 6.6e-3 (PERF.md, PR 16), as far as cuDNN's own float32 gradients sit from
# float64 (4.4e-3, PR 10); a wrong gradient (a sign, a missing term) is O(1).
MESH_GRAD32_REL = 2e-2
MESH_CLI_RTOL = 1e-4    # cli.main's float32 losses, 2 ranks against 1, over 20 steps
SHARD_STEPS = 3     # phase 18's float64 steps a model from the .ckpt and from the .pt
SHARD_RESUME_REL = 1e-12   # phase 18: the .ckpt resume against the .pt resume, float64
SHARD_CLI_BATCH = 16       # phase 18's cli.main --resume auto (M5) batch
SVM_FILES, SVM_SECONDS = 16, 342.0   # phase 19's corpus: 16 x 342 s (16,560 rows) + a short file
SVM_SHORT_SECONDS = 20.0  # its last file, also featurized on the CPU
SVM_ROWS = 16384          # the soft SVC fitted on the card: 16,384 rows x 64 mel bins
SVM_CPU_ROWS = 2048       # the fit held against the CPU's float64 fit of the same rows
SVM_TOL = 1e-3            # that bound: decision values and probabilities (the solver's tol)
SCRIPT_FILES = 4          # play_with_spectograms' subset of phase 19's corpus
PLOT_FILES = 1            # plot_waveform_frames' (it keeps the first 20 positive crops)
SCRIPT_HOLDOUT = 100      # play_with_spectograms' held-out rows (its default)
ANALYZE_SECONDS = 60.0    # scripts.analyze_spectogram's WAV
READ_WORKERS = 8    # the native reader's threads (the card's host has 8 cores)
READ_REPS = 3       # reads timed a case

REPS = 20
QUEUED = 20         # calls in a row between one pair of events (time_ms's calls)

# The launch counters (``cuda_featurizer.LAUNCHES``) of each entry of the
# kernels line.
ENTRY_COUNTERS = {
    "wave_stft_power": ("wave_stft_power",), "mel_log": ("mel_log",),
    "frames_stft_power": ("frames_stft_power",), "power_to_logmel_cuda": ("mel_log",),
    "wave_stft_mel_log": ("wave_stft_mel_log",), "wave_packed_fft": ("wave_packed_fft",),
    "stft_eo_power_from_waveform": ("wave_stft_power",),
    "stft_power_from_waveform_raw": ("wave_stft_power",),
    "logmel_waveform_rolledge": ("wave_stft_power", "mel_log"),
    "stft_power_from_waveform(slice, roll_nodb)": ("wave_stft_power",),
    "wave_dft_power_bf16": ("wave_dft_power_bf16",),
    "frames_dft_power_bf16": ("frames_dft_power_bf16",), "mel_log_bf16": ("mel_log_bf16",),
    "wave_stft_mel_log_bf16": ("wave_stft_mel_log_bf16",),
    "wave_stft_mel_log_mel_bf16": ("wave_stft_mel_log_mel_bf16",),
    "wave_packed_fft_bf16": ("wave_packed_fft_bf16",),
    "fft_cross_pass": ("fft_cross_pass",), "fft_subrows": ("fft_subrows",),
    "packed_power": ("packed_power",), "tier_split": ("tier_split",),
    "tier_inner": ("tier_inner",), "tier_outer": ("tier_outer",),
}

# Memory rate (B/s), FP32 rate outside the tensor cores and dense bf16
# tensor-core rate (FLOP/s, without sparsity) of the card, from NVIDIA's
# data sheets, by product name; the SXM part by default.
PEAKS = {"PCIe": (2.0e12, 51.2e12, 756e12), "NVL": (3.9e12, 60.0e12, 835e12)}
DEFAULT_PEAK = (3.35e12, 67.0e12, 989e12)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    return DEFAULT_PEAK


def smi_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return smi.splitlines()[0]


def time_ms(torch, fn, reps: int = REPS, warmup: int = 3, calls: int = 1) -> float:
    """Median device time of one call of ``fn()`` by CUDA events around
    ``calls`` calls in a row, over ``reps`` such groups.  With one call a
    group the card waits for each launch, so a kernel of tens of
    microseconds is timed with its host launch latency; ``calls`` queued
    back to back keep the card busy and time the kernel itself."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def make_signals(torch, n, samples, sr, device, seed):
    """Noise, tones, a silent stretch and a quiet signal: float32 (n, samples)."""
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(samples, device=device, dtype=torch.float64) / sr
    out = 0.3 * torch.randn(n, samples, generator=g, device=device, dtype=torch.float64)
    for i in range(n):
        out[i] += 0.5 * torch.sin(2 * np.pi * 440.0 * (i + 1) * t)
    out[0, : 10 * sr] = 0.0
    out[-1] *= 1e-3
    return out.clamp(-1, 1).float().contiguous()


def fft_ops(rows: int, m: int, win_nnz: int, unpack: bool = True) -> int:
    """FP32 operations of ``rows`` windowed n_fft = 2m real DFTs and their
    power: the m-point complex FFT, the hermitian unpack and |X|^2 (left out
    when not ``unpack``: K6 stops after the FFT), and the window product."""
    return rows * (5 * m * (m.bit_length() - 1) + (19 * m if unpack else 0) + win_nnz)


def run_cli(args, what: str) -> str:
    """Run ``python -m <args>`` from the repository root; returns stdout."""
    proc = subprocess.run([sys.executable, "-m", *map(str, args)], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
    check(proc.returncode == 0, f"{what} exit code {proc.returncode}")
    return proc.stdout


_cli_runs = []


def start_cli(args, log_path):
    """Start ``python -m <args>`` from the repository root in the background,
    its output to ``log_path``; ``finish_cli`` waits for it."""
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", *map(str, args)], cwd=REPO,
                                stdout=f, stderr=subprocess.STDOUT)
    _cli_runs.append(proc)
    return proc


def finish_cli(proc, log_path, what: str) -> None:
    proc.wait(timeout=600)
    if proc.returncode != 0:
        print(Path(log_path).read_text()[-4000:], file=sys.stderr)
    check(proc.returncode == 0, f"{what} exit code {proc.returncode}")


def profile_ticks(torch, fn, n: int):
    """Device time per call of ``fn`` by kernel, from ``torch.profiler`` over
    ``n`` calls: ``[(kernel name, ms per call), ...]``, largest first; empty
    when the profiler captured no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / n) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


# A kernel with one part of its work removed (wrong results, timing only):
# how much of its time that part holds.  Each is featurizer.cu with one edit,
# built beside the real library and timed on the same inputs through the same
# C call as the real kernel: K3's and K1's in phase 8, K6's and K5's in phase
# 9, K6t's in phase 21.  name -> (C entry point, ((anchor, replacement),
# ...)).  The edits apply to the whole file; only the named entry point is
# called.
LESIONS = {
    "K6 loads": ("sed_wave_packed_fft", (("  load.template fill<T, P>(v, t);",
                 "#pragma unroll\n  for (int s = 0; s < kPoints; ++s)\n"
                 "    v[s] = make_float2(t * 1e-3f + s, s * 0.5f - t);"),)),
    "K6 exchanges": ("sed_wave_packed_fft", ((
        "      if (pass + 1 < a || r > 1) stockham_exchange<16, 1>(v, sre, sim, t, T, p);",
        ""),)),
    "K6 twiddles": ("sed_wave_packed_fft", (("    if (p > 1) {\n      const int k = (t + b * T)",
                                             "    if (false) {\n      const int k = (t + b * T)"),)),
    "K3 drain exchange": ("sed_frames_stft_power", (("    constexpr bool in_registers = T == 1;",
                                                     "    constexpr bool in_registers = true;"),)),
    "K1 drain exchange": ("sed_wave_stft_power", (("    constexpr bool in_registers = T == 1;",
                                                   "    constexpr bool in_registers = true;"),)),
    "K5 epilogue": ("sed_wave_stft_mel_log", ((
        "    mel_log_row_mode<kWarps>(mel_passes, power, seg, band_first, weights, power + m + 1, "
        "row,\n                             n_mels, n_seg);",
        "    (void)kWarps;"),)),
    "K2 copies": ("sed_mel_log", (("        stage_chunk<R>(a, ring, full, g, k, seq, lane);",
                                   "        mbar_arrive(full + seq % D); if (lane == 0) "
                                   "mbar_arrive(full + seq % D);"),)),
    "K2 sums": ("sed_mel_log", (("        segment_sums<R, kPasses>(x, w, s.y, lane, sum);",
                                 "        for (int r = 0; r < R; ++r) sum[r] = 0.f;"),)),
    # K6t (tier_packed_fft_kernel) without its frame split (no sample loads,
    # no bf16 split, no X stores), without its table copies (no bulk copy of
    # W2 or W1 tiles), without its drain's stores of Z.
    "K6t frame split": ("sed_tier_packed_fft", (
        ("      for (int it = 0; it < ITEMS; ++it) {\n        const int q = pt + PT * it;\n"
         "        const int b = q % N1P, o = q / N1P;\n        // Re (part 0)",
         "      for (int it = 0; it < 0; ++it) {\n        const int q = pt + PT * it;\n"
         "        const int b = q % N1P, o = q / N1P;\n        // Re (part 0)"),
        ("          xs[it][e] = paired ? __ldg(pairs + j) : frame.raw(2 * j);\n          ws[it][e] = __ldg(window + j);",
         "          xs[it][e] = make_float2(j, e);\n          ws[it][e] = make_float2(e, j);"))),
    "K6t table copies": ("sed_tier_packed_fft", (
        ("      if (pt == 0) {\n        mbar_expect_tx(full1 + slot, A1_BYTES);",
         "      if (false) {\n        mbar_expect_tx(full1 + slot, A1_BYTES);"),
        ("            mbar_arrive_expect_tx(full2 + slot2, S2);\n            bulk_copy(",
         "            mbar_arrive(full2 + slot2);\n            if (false) bulk_copy("))),
    "K6t drain": ("sed_tier_packed_fft", (("      for (int i = 0; i < 2 * 32 * KB / 4 / 128; ++i) {",
                                           "      for (int i = 0; i < 0; ++i) {"),)),
}
# Each lesion build holds only what phases 8, 9 and 21 call: K1-K6 without
# the tier kernels' instances, or K6t's entry with the instances of n_fft
# 32768 alone (log2 m 14), which would otherwise multiply each build's time.
LESION_FLAGS = {"sed_tier_packed_fft": ("-DSED_FEATURIZER_PACKED_TIERS_ONLY",
                                        "-DSED_FEATURIZER_PACKED_ONE_SIZE=14")}
DEFAULT_LESION_FLAGS = ("-DSED_FEATURIZER_NO_TIERS",)
_lesion_builds = []


def start_lesions(kernels):
    """Start one nvcc per distinct edit (all at once, after the main build);
    lesions that make the same edit share its library."""
    src = kernels.SOURCE.read_text()
    out = kernels.BUILD_DIR / "lesions"
    out.mkdir(parents=True, exist_ok=True)
    started = {}
    for name, (entry, edits) in LESIONS.items():
        edited = src
        for old, new in edits:
            check(src.count(old) == 1, f"lesion {name!r}: its anchor is in featurizer.cu")
            edited = edited.replace(old, new)
        flags = LESION_FLAGS.get(entry, DEFAULT_LESION_FLAGS)
        if (edits, flags) in started:
            _lesion_builds.append((name, *started[edits, flags]))
            continue
        stem = name.replace(" ", "_")
        cu, so, build_log = out / f"{stem}.cu", out / f"lib{stem}.so", out / f"{stem}.log"
        cu.write_text(edited)
        with open(build_log, "w") as f:
            proc = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, *flags,
                                     "-o", str(so), str(cu)], stdout=f, stderr=subprocess.STDOUT)
        started[edits, flags] = (proc, so, build_log)
        _lesion_builds.append((name, proc, so, build_log))


def stop_background() -> None:
    """Stop what the script started and has not waited for: lesion builds
    and CLI runs."""
    for proc in [proc for _, proc, _, _ in _lesion_builds] + _cli_runs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def finish_lesions():
    """Wait for the lesion builds; returns {name: its C entry point}, typed
    as ``cuda_featurizer._library()`` types it."""
    import ctypes

    from sed_tpu_torch.ops import cuda_featurizer as kernels

    fns = {}
    for name, proc, so, build_log in _lesion_builds:
        proc.wait(timeout=600)
        check(proc.returncode == 0,
              f"lesion {name!r} builds: {build_log.read_text()[-2000:]}")
        entry = LESIONS[name][0]
        fn = getattr(ctypes.CDLL(str(so)), entry)
        typed = getattr(kernels._library(), entry)
        fn.argtypes, fn.restype = typed.argtypes, typed.restype
        fns[name] = fn
    return fns


def drive_pool(torch, dev, pool, clips, chunk, seed, backlog=None):
    """Phase 5's run of a pool: every clip a stream, fed in pieces of 0.4 to
    1.6 chunks a tick (stream ``backlog[0]``'s first piece ``backlog[1]``
    samples), the streams of ``LATE_JOINS`` joining late, each stream leaving
    through ``leave_many`` when its audio ends.  The launch counts and the
    peak memory are reset just before and read just after.  Returns (each
    stream's scores, wall seconds, launches, peak MiB, ticks)."""
    from sed_tpu_torch.ops import cuda_featurizer as kernels

    rng = np.random.default_rng(seed)
    recs = [{"wav": c, "pos": 0, "blocks": []} for c in clips]
    waiting = list(range(len(clips)))
    active, tick = {}, 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    while waiting or active:
        for i in [i for i in waiting if LATE_JOINS.get(i, 0) <= tick]:
            active[pool.join()] = recs[i]
            waiting.remove(i)
        leaving = []
        for slot, rec in active.items():
            n = int(chunk * rng.uniform(0.4, 1.6))
            if backlog and rec is recs[backlog[0]] and rec["pos"] == 0:
                n = backlog[1]
            piece = rec["wav"][rec["pos"]: rec["pos"] + n]
            pool.feed(slot, piece)
            rec["pos"] += len(piece)
            if rec["pos"] >= len(rec["wav"]):
                leaving.append(slot)
        for slot, sc in pool.tick().items():
            active[slot]["blocks"].append(sc)
        tails = pool.leave_many(leaving) if leaving else {}
        for slot in leaving:
            tail = tails[slot]
            if isinstance(tail, Exception):
                raise tail
            active.pop(slot)["blocks"].append(tail)
        tick += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([np.concatenate(r["blocks"]) for r in recs], wall, dict(kernels.LAUNCHES),
            torch.cuda.max_memory_allocated(dev) / 2**20, tick)


def score_all(torch, predict, clips):
    """Offline scores of (samples,) int16 or uint8 clips of one length, in
    batches of up to ``BATCH``: (n, frames', classes) numpy."""
    outs = []
    for i in range(0, len(clips), BATCH):
        batch = torch.from_numpy(np.stack(clips[i:i + BATCH]))[..., None]
        outs.append(predict(batch).cpu().numpy())
    return np.concatenate(outs)


def impls_phase(torch, cfg, dev, bound, win_nnz, lesions):
    """Phase 9: every implementation name of sed_tpu's featurizer on the card
    (see the module docstring).  Returns the ``kernels`` entries of K4–K10."""
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.ops import stft as stft_ops
    from sed_tpu_torch.ops.featurizer import ingest_to_f32, logmel_features_batch
    from sed_tpu_torch.ops.mel import mel_filterbank

    t0 = time.perf_counter()
    sr, hop, n_fft, n_bins = cfg.working_sample_rate, cfg.hop_size, cfg.nfft, cfg.freq_bins
    m, n_mels = n_fft // 2, cfg.mel_bins
    samples = sr * SECONDS
    window = kernels.stft_window(cfg, dev)
    bands = kernels.mel_bands(cfg, dev)
    fb64 = torch.from_numpy(mel_filterbank(cfg, np.float64)).to(dev)
    # Phase 3's batch (same seed), ingested to f32 on the card.
    pcm = (make_signals(torch, BATCH, samples, sr, dev, 1) * 32767).round().to(torch.int16)
    waves = ingest_to_f32(pcm).contiguous()
    ref_power = kernels.wave_stft_power_plain(waves.double(), window, hop, n_fft)
    frames = ref_power.shape[0] * ref_power.shape[1]
    power_peak = ref_power.amax(dim=-1, keepdim=True)
    chain = kernels.mel_log_plain(ref_power.reshape(-1, n_bins), fb64).reshape(
        BATCH, -1, n_mels)

    def power_errors(power):
        err = (power.double() - ref_power).abs()
        return float(err.max()), float((err / power_peak.clamp_min(1e-30)).max())

    # Each impl name: launch counts reset just before and read just after.
    runs = {}
    for impl, names in kernels.IMPL_KERNELS.items():
        kernels.reset_launch_counts()
        out = kernels.logmel_waveform(waves, cfg, impl=impl)
        torch.cuda.synchronize()
        launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
        err = float((out.double() - chain).abs().max())
        runs[impl] = (launched, err)
        log(f"[impls] logmel_waveform(impl={impl!r}) {tuple(out.shape)}: launches "
            f"{launched}; vs float64 chain {err:.3e} dB (tol {DB_TOL})")
        check(out.shape == chain.shape, f"impl {impl} shape {tuple(out.shape)}")
        check(launched == dict.fromkeys(names, 1), f"impl {impl} launched {names} once each")
        check(err <= DB_TOL, f"impl {impl} within 1e-4 dB of the float64 chain")
    # K4's route: the STFT in PyTorch, then the mel kernel.
    kernels.reset_launch_counts()
    route = logmel_features_batch(pcm[..., None], cfg, use_pallas=True)
    torch.cuda.synchronize()
    k4_launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    k4_route_err = float((route[:, 0].double() - chain).abs().max())
    log(f"[impls] logmel_features_batch(use_pallas=True) {tuple(route.shape)}: "
        f"launches {k4_launched}; vs float64 chain {k4_route_err:.3e} dB (tol {DB_TOL})")
    check(k4_launched == {"mel_log": 1}, "the use_pallas=True route launched K4 only")
    check(k4_route_err <= DB_TOL, "use_pallas=True within 1e-4 dB of the float64 chain")
    del route

    # K4 alone on that route's power, against its plain version in float64.
    re, im = stft_ops.stft_realimag(waves, cfg, "fft")
    k4_power = (re * re + im * im).contiguous()
    del re, im
    k4_out = kernels.power_to_logmel_cuda(k4_power, cfg)
    k4_err = float((k4_out.double() - kernels.mel_log_plain(
        k4_power.double().reshape(-1, n_bins), fb64).reshape(k4_out.shape)).abs().max())
    log(f"[kernels] K4 power_to_logmel_cuda (mel_log) {tuple(k4_out.shape)}: max err "
        f"{k4_err:.3e} dB against float64 (tol {DB_TOL})")
    check(k4_err <= DB_TOL, "K4 within 1e-4 dB of float64")

    # K5 against K1 then K2, and against float64.
    fused = kernels.wave_stft_mel_log(waves, window, hop, n_fft, bands)
    k1_power = kernels.wave_stft_power(waves, window, hop, n_fft)
    two = kernels.mel_log(k1_power.reshape(-1, n_bins), bands).reshape(fused.shape)
    torch.cuda.synchronize()
    k5_vs_two = float((fused - two).abs().max())
    k5_err = float((fused.double() - chain).abs().max())
    log(f"[kernels] K5 wave_stft_mel_log {tuple(fused.shape)}: vs K1 then K2 "
        f"{k5_vs_two:.3e} dB (0 expected, tol 1e-5), {int((fused != two).sum())} "
        f"values differ; vs float64 chain {k5_err:.3e} dB (tol {DB_TOL})")
    check(k5_vs_two <= 1e-5, "K5 equals K1 then K2 within 1e-5 dB")
    check(k5_err <= DB_TOL, "K5 within 1e-4 dB of the float64 chain")
    del fused, two

    # K6 against its plain version in float64; 'pack''s power against K1's.
    zr, zi = kernels.wave_packed_fft(waves, window, hop, n_fft)
    wr, wi = kernels.wave_packed_fft_plain(waves.double(), window, hop, n_fft)
    z_peak = torch.hypot(wr, wi).amax(dim=-1, keepdim=True).clamp_min(1e-30)
    k6_abs, k6_rel = 0.0, 0.0
    for got, want in ((zr, wr), (zi, wi)):
        err = (got.double() - want).abs()
        k6_abs = max(k6_abs, float(err.max()))
        k6_rel = max(k6_rel, float((err / z_peak).max()))
    del wr, wi, z_peak, err
    log(f"[kernels] K6 wave_packed_fft 2 x {tuple(zr.shape)}: max abs err {k6_abs:.3e}, "
        f"max err / frame peak |Z| {k6_rel:.3e} (tol {K1_REL_TOL})")
    check(k6_rel <= K1_REL_TOL, "K6 within 1e-5 x frame peak of float64")
    pack_power = kernels.packed_power_onesided(zr, zi, n_fft)
    pack_vs_k1 = float(((pack_power - k1_power).abs()
                        / k1_power.amax(dim=-1, keepdim=True).clamp_min(1e-30)).max())
    _, pack_rel = power_errors(pack_power)
    log(f"[kernels] 'pack' power (K6 + unpack) vs K1 power: {pack_vs_k1:.3e}, vs "
        f"float64 {pack_rel:.3e} of the frame peak (tol {K1_REL_TOL})")
    check(pack_rel <= K1_REL_TOL, "'pack' power within 1e-5 x frame peak of float64")
    del pack_power

    # K7, K8, K10 (K1 under their own names): power against float64.
    k1_named = {}
    for tag, fn in (("K7 eo", lambda: kernels.stft_eo_power_from_waveform(waves, cfg)),
                    ("K8 rollraw", lambda: kernels.stft_power_from_waveform_raw(waves, cfg)),
                    ("K10 slice", lambda: kernels.stft_power_from_waveform(
                        waves, cfg, impl="slice"))):
        k1_named[tag] = power_errors(fn())
        log(f"[kernels] {tag} (wave_stft_power): max abs err {k1_named[tag][0]:.3e}, "
            f"max err / frame peak {k1_named[tag][1]:.3e} (tol {K1_REL_TOL})")
        check(k1_named[tag][1] <= K1_REL_TOL, f"{tag} within 1e-5 x frame peak")
    del ref_power, power_peak
    log(f"[impls] checks {time.perf_counter() - t0:.1f} s")

    # Times.
    t0 = time.perf_counter()
    rows = k1_power.reshape(-1, n_bins)
    windowed = stft_ops.frame_signal(waves, n_fft, hop) * window
    packed = torch.complex(windowed[..., 0::2].contiguous(), windowed[..., 1::2].contiguous())
    del windowed
    ms = {
        "k4": time_ms(torch, lambda: kernels.power_to_logmel_cuda(k1_power, cfg)),
        "k4_plain": time_ms(torch, lambda: kernels.mel_log_plain(rows, bands.dense)),
        "k4_lib": time_ms(torch, lambda: 10.0 * torch.log10(
            torch.clamp(torch.matmul(rows, bands.dense), min=1e-10))),
        "k5": time_ms(torch, lambda: kernels.wave_stft_mel_log(waves, window, hop, n_fft,
                                                               bands)),
        "k5_plain": time_ms(torch, lambda: kernels.wave_stft_mel_log_plain(
            waves, window, hop, n_fft, bands.dense)),
        "k1k2": time_ms(torch, lambda: kernels.mel_log(kernels.wave_stft_power(
            waves, window, hop, n_fft).reshape(-1, n_bins), bands)),
        "stft_mel_lib": time_ms(torch, lambda: 10.0 * torch.log10(torch.clamp(
            torch.matmul(torch.stft(waves, n_fft, hop, window=window, center=True,
                                    pad_mode="reflect", return_complex=True
                                    ).abs().square().transpose(1, 2), bands.dense),
            min=1e-10))),
        "k6": time_ms(torch, lambda: kernels.wave_packed_fft(waves, window, hop, n_fft)),
        "k6_plain": time_ms(torch, lambda: kernels.wave_packed_fft_plain(
            waves, window, hop, n_fft)),
        "k6_lib": time_ms(torch, lambda: torch.fft.fft(packed, dim=-1)),
        "k7": time_ms(torch, lambda: kernels.stft_eo_power_from_waveform(waves, cfg)),
        "k8": time_ms(torch, lambda: kernels.stft_power_from_waveform_raw(waves, cfg)),
        "k9": time_ms(torch, lambda: kernels.logmel_waveform_rolledge(waves, cfg)),
        "k10": time_ms(torch, lambda: kernels.stft_power_from_waveform(
            waves, cfg, impl="slice")),
        "k1_plain": time_ms(torch, lambda: kernels.wave_stft_power_plain(
            waves, window, hop, n_fft)),
        "stft_lib": time_ms(torch, lambda: torch.stft(
            waves, n_fft, hop, window=window, center=True, pad_mode="reflect",
            return_complex=True).abs() ** 2),
    }
    del packed
    # K6 without its loads, exchanges or twiddles (wrong results): each part's share.
    zr, zi = kernels.wave_packed_fft(waves, window, hop, n_fft)
    tw = kernels._stockham_twiddles(n_fft, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def lesion_run(fn):
        err = fn(waves.data_ptr(), window.data_ptr(), tw.data_ptr(), zr.data_ptr(),
                 zi.data_ptr(), BATCH, samples, zr.shape[1], hop, n_fft.bit_length() - 2,
                 dev.index, stream)
        check(err == 0, f"K6 lesion launch ({err})")

    lesion_ms = {name[3:]: time_ms(torch, lambda fn=fn: lesion_run(fn))
                 for name, fn in lesions.items() if name.startswith("K6 ")}
    ms["k6_again"] = time_ms(torch, lambda: lesion_run(kernels._library().sed_wave_packed_fft))
    del zr, zi
    # K5 without its band epilogue (wrong results): what the epilogue costs.
    k5_out = kernels.wave_stft_mel_log(waves, window, hop, n_fft, bands)
    unpack = kernels._twiddles(n_fft, dev)

    def k5_raw_run(fn):
        err = fn(waves.data_ptr(), window.data_ptr(), tw.data_ptr(), unpack.data_ptr(),
                 bands.segments.data_ptr(), bands.band_first.data_ptr(),
                 bands.weights.data_ptr(), k5_out.data_ptr(), BATCH, samples,
                 k5_out.shape[1], hop, n_fft.bit_length() - 2, n_mels, bands.n_segments, 0,
                 dev.index, stream)
        check(err == 0, f"K5 raw launch ({err})")

    ms["k5_no_epilogue"] = time_ms(torch, lambda: k5_raw_run(lesions["K5 epilogue"]))
    ms["k5_again"] = time_ms(torch, lambda: k5_raw_run(kernels._library().sed_wave_stft_mel_log))
    del k5_out
    impl_ms = {impl: time_ms(torch, lambda impl=impl: kernels.logmel_waveform(
        waves, cfg, impl=impl)) for impl in kernels.IMPL_KERNELS}

    nnz = bands.nnz
    # The window and the twiddles: K6 reads the pass-ordered table, K1 and
    # K5 the W_N^k table too.
    fixed = 4 * (n_fft + 2 * m)
    fixed_power = fixed + 4 * 2 * m
    wave_b = 4 * waves.numel()
    mel_b = 4 * (frames * n_mels + nnz + 5 * bands.n_segments + n_mels + 1)
    k4_bound = bound(4 * rows.numel() + mel_b, 2 * nnz * frames)
    k5_bound = bound(wave_b + fixed_power + mel_b,
                     fft_ops(frames, m, win_nnz) + 2 * nnz * frames)
    k6_bound = bound(wave_b + fixed + 2 * 4 * frames * m,
                     fft_ops(frames, m, win_nnz, unpack=False))
    k1_bound = bound(wave_b + fixed_power + 4 * rows.numel(), fft_ops(frames, m, win_nnz))
    log(f"[times] impls, {BATCH} x {SECONDS} s, {frames} frames (CUDA-event median "
        f"of {REPS}):")
    log(f"[times] K4 power_to_logmel_cuda (mel_log) {ms['k4']:.4f} ms | plain "
        f"{ms['k4_plain']:.4f} ms | matmul+log10 {ms['k4_lib']:.4f} ms | bound "
        f"{k4_bound[0]:.4f} ms ({k4_bound[1]})")
    log(f"[times] K5 wave_stft_mel_log {ms['k5']:.4f} ms | plain {ms['k5_plain']:.4f} ms "
        f"| K1 then K2 {ms['k1k2']:.4f} ms | torch.stft+abs^2+matmul+log10 "
        f"{ms['stft_mel_lib']:.4f} ms | bound {k5_bound[0]:.4f} ms ({k5_bound[1]}) | bound "
        f"share {k5_bound[0] / ms['k5']:.1%} | K5 / torch.stft chain "
        f"{ms['k5'] / ms['stft_mel_lib']:.3f}")
    log(f"[times] K5 without its band epilogue (wrong results, timing only) "
        f"{ms['k5_no_epilogue']:.4f} ms; K5 through the same C call {ms['k5_again']:.4f} ms "
        f"(the epilogue's share {ms['k5_again'] - ms['k5_no_epilogue']:.4f} ms)")
    log(f"[times] K6 wave_packed_fft {ms['k6']:.4f} ms | plain {ms['k6_plain']:.4f} ms | "
        f"torch.fft.fft of the packed frames {ms['k6_lib']:.4f} ms | bound "
        f"{k6_bound[0]:.4f} ms ({k6_bound[1]}) | bound share {k6_bound[0] / ms['k6']:.1%} "
        f"| K6 / torch.fft.fft {ms['k6'] / ms['k6_lib']:.3f}")
    log(f"[times] K6 with a part of its work removed (wrong results, timing only; K6 "
        f"timed again beside them through the same C call {ms['k6_again']:.4f} ms): " + ", ".join(
            f"without {name} {t:.4f} ms (their share {ms['k6_again'] - t:.4f} ms)"
            for name, t in lesion_ms.items()))
    log(f"[times] K1 under sed_tpu's names: K7 eo {ms['k7']:.4f} ms | K8 rollraw "
        f"{ms['k8']:.4f} ms | K10 slice {ms['k10']:.4f} ms | plain {ms['k1_plain']:.4f} ms "
        f"| torch.stft+abs^2 {ms['stft_lib']:.4f} ms | bound {k1_bound[0]:.4f} ms "
        f"({k1_bound[1]}) | K7 / torch.stft+abs^2 {ms['k7'] / ms['stft_lib']:.3f}")
    log(f"[times] K9 rolledge (K1 then K2) {ms['k9']:.4f} ms | bound {k5_bound[0]:.4f} ms")
    log("[times] logmel_waveform by impl: " + ", ".join(
        f"{impl} {t:.4f} ms" for impl, t in impl_ms.items()))
    log(f"[impls] times {time.perf_counter() - t0:.1f} s")

    source = "sed_tpu_torch/ops/csrc/featurizer.cu"
    replaces = "sed_tpu/ops/pallas_featurizer.py:"

    def entry(name, kernel, line, launches, err, t, plain, bnd, lib):
        return {"name": name, "kernel": kernel, "route": "cuda", "source": source,
                "replaces": replaces + str(line), "launches": launches,
                "max_abs_err": err, "ms": t, "plain_ms": plain, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": lib}

    def launched(*impls, kernel):
        return sum(runs[i][0].get(kernel, 0) for i in impls)

    return [
        entry("power_to_logmel_cuda", "mel_log_kernel<R>", 38, k4_launched["mel_log"], k4_err,
              ms["k4"], ms["k4_plain"], k4_bound, ms["k4_lib"]),
        entry("wave_stft_mel_log",
              "wave_stft_mel_log_kernel<LOG2_M> (stockham_fft, PowerStore, mel_log_row)", 550,
              launched("fuse", kernel="wave_stft_mel_log"), k5_err, ms["k5"],
              ms["k5_plain"], k5_bound, ms["stft_mel_lib"]),
        entry("wave_packed_fft", "wave_packed_fft", 882,
              launched("pack", kernel="wave_packed_fft"), k6_abs, ms["k6"],
              ms["k6_plain"], k6_bound, ms["k6_lib"]),
        entry("stft_eo_power_from_waveform", "wave_stft_power", 748,
              launched("eo", kernel="wave_stft_power"), k1_named["K7 eo"][0], ms["k7"],
              ms["k1_plain"], k1_bound, ms["stft_lib"]),
        entry("stft_power_from_waveform_raw", "wave_stft_power", 1156,
              launched("rollraw", kernel="wave_stft_power"), k1_named["K8 rollraw"][0],
              ms["k8"], ms["k1_plain"], k1_bound, ms["stft_lib"]),
        entry("logmel_waveform_rolledge", "wave_stft_power + mel_log", 1321,
              launched("rolledge", kernel="wave_stft_power")
              + launched("rolledge", kernel="mel_log"), runs["rolledge"][1], ms["k9"],
              ms["k5_plain"], k5_bound, ms["stft_mel_lib"]),
        entry("stft_power_from_waveform(slice, roll_nodb)", "wave_stft_power", 352,
              launched("slice", "roll_nodb", kernel="wave_stft_power"),
              k1_named["K10 slice"][0], ms["k10"], ms["k1_plain"], k1_bound,
              ms["stft_lib"]),
    ]


def seed_batch_norms(torch, model, seed):
    """Seeded, non-trivial BatchNorm statistics, scales and biases."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.uniform_(-0.5, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.3, 0.3, generator=g)
    return model.eval()


def burst_wav(path, seconds, sr, seed):
    """Noise with tonal bursts (a 2 kHz tone on for 4 s of every 20 s, a
    sweeping one for 1 s of every 7 s), 48 kHz mono int16."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr), dtype=np.float64) / sr
    x = 0.1 * rng.standard_normal(t.size)
    x += 0.5 * ((t % 20.0) < 4.0) * np.sin(2 * np.pi * 2000.0 * t)
    x += 0.4 * ((t % 7.0) < 1.0) * np.sin(2 * np.pi * (300.0 + 50.0 * (t % 7.0)) * t)
    wavfile.write(path, sr, (np.clip(x, -1, 1) * 32767).astype(np.int16))
    return path


def files_phase(torch, cfg, dev, smi, tmp):
    """Phase 10: the per-file path of ``cli/infer.py`` without ``--batch``
    (see the module docstring).  Returns the K1 and K2 launches of the two
    spectrogram ``predict_file`` runs on the long file."""
    from sed_tpu_torch.cli import infer
    from sed_tpu_torch.configs import WaveformConfig
    from sed_tpu_torch.inference import emits_scores, make_batch_predictor
    from sed_tpu_torch.io.audio import read_multichannel_audio
    from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling, MobileNetV1
    from sed_tpu_torch.models.m5 import M5
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.ops.featurizer import logmel_features
    from sed_tpu_torch.ops.mel import mel_filterbank

    t0 = time.perf_counter()
    sr = cfg.working_sample_rate
    hop, n_fft = cfg.hop_size, cfg.nfft
    wcfg = WaveformConfig()
    long_s, short_s = FILE_SECONDS
    long_wav = str(burst_wav(tmp / "long.wav", long_s, sr, 10))
    short_wav = str(burst_wav(tmp / "short.wav", short_s, sr, 11))
    models = {
        "CnnAvgPooling": CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL,
                                       generator=torch.Generator().manual_seed(10)),
        "MobileNetV1": MobileNetV1(cfg.classes_num, generator=torch.Generator().manual_seed(11)),
        "M5": M5(cfg.classes_num, generator=torch.Generator().manual_seed(12)),
    }
    for i, model in enumerate(models.values()):
        seed_batch_norms(torch, model, 20 + i)
    cpu_models = {arch: copy.deepcopy(m) for arch, m in models.items()}
    for model in models.values():
        model.to(dev)
    # Per-mel-bin normalization from the long file's own log-mel, as
    # preprocessing computes it from training features.
    wav_long = read_multichannel_audio(long_wav, target_fs=sr, cfg=cfg).astype(np.float32)
    with torch.inference_mode():
        feats = logmel_features(torch.from_numpy(wav_long).to(dev), cfg)
    mean = feats.mean(dim=(0, 1)).cpu().numpy()
    std = feats.std(dim=(0, 1)).cpu().numpy()
    del feats
    with open(tmp / "files_mean_std.pkl", "wb") as f:
        pickle.dump({"mean": mean, "std": std}, f)
    frames_long = 1 + wav_long.shape[0] // cfg.hop_size
    log(f"[files] {long_s:.0f} s and {short_s:.0f} s WAVs written ({frames_long} frames in "
        f"the long one); {time.perf_counter() - t0:.1f} s")

    # K1 and K2 at the long file's shape, one signal of 1,819 rows, against
    # float64: the log-mel of each predict_file below is held against the
    # float64 chain too.
    wave_dev = torch.from_numpy(wav_long).to(dev)
    window = kernels.stft_window(cfg, dev)
    fb64 = torch.from_numpy(mel_filterbank(cfg, np.float64)).to(dev)
    wave64 = wave_dev.T.double()
    ref_power = kernels.wave_stft_power_plain(wave64, window, hop, n_fft)[0]
    power = kernels.wave_stft_power(wave_dev.T.contiguous(), window, hop, n_fft)[0]
    check(power.shape == ref_power.shape == (frames_long, n_fft // 2 + 1),
          f"K1 on the long file {tuple(power.shape)}")
    k1_rel = float(((power.double() - ref_power).abs()
                    / ref_power.amax(dim=-1, keepdim=True).clamp_min(1e-30)).max())
    mel = kernels.mel_log(power, kernels.mel_bands(cfg, dev))
    k2_err = float((mel.double() - kernels.mel_log_plain(power.double(), fb64)).abs().max())
    ref_mel = kernels.mel_log_plain(ref_power, fb64)
    del ref_power, power, mel, wave64
    log(f"[files] K1 on the long file ({frames_long} rows of one signal): max err / frame "
        f"peak {k1_rel:.3e} (tol {K1_REL_TOL}); K2 on its rows vs float64 {k2_err:.3e} dB "
        f"(tol {DB_TOL})")
    check(k1_rel <= K1_REL_TOL, "K1 on the long file within 1e-5 x frame peak of float64")
    check(k2_err <= DB_TOL, "K2 on the long file within 1e-4 dB of float64")

    # The spectrogram archs: windowed == whole forward, one K1 + K2 a file.
    scores, file_launches, peak_mib, halos = {}, {}, {}, {}
    for arch in ("CnnAvgPooling", "MobileNetV1"):
        model = models[arch]
        halo = halos[arch] = infer.halo_floor(model, FILE_HALO)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        kernels.reset_launch_counts()
        log_mel, got = infer.predict_file(model, long_wav, cfg, mean, std, window=FILE_WINDOW,
                                          halo=FILE_HALO, device=DEVICE)
        torch.cuda.synchronize()
        launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
        peak_mib[arch] = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
        file_launches[arch] = launched
        with torch.inference_mode():
            norm = (log_mel - torch.from_numpy(mean).to(dev)) / torch.from_numpy(std).to(dev)
            whole = model(norm[None])[0]
            whole = whole if emits_scores(model) else torch.sigmoid(whole)
        whole = whole.cpu().numpy()
        mel_err = float((log_mel[0].double() - ref_mel).abs().max())
        log(f"[files] {arch} predict_file's log-mel {tuple(log_mel.shape)} vs the float64 "
            f"chain {mel_err:.3e} dB (tol {DB_TOL})")
        check(log_mel.shape == (1,) + tuple(ref_mel.shape) and mel_err <= DB_TOL,
              f"{arch} predict_file's log-mel within 1e-4 dB of the float64 chain")
        check(got.shape == whole.shape == (8 * (frames_long // 8), cfg.classes_num),
              f"{arch} windowed frames {got.shape} == whole {whole.shape}")
        check(bool(np.isfinite(got).all()), f"{arch} scores finite")
        err = float(np.abs(got - whole).max())
        log(f"[files] {arch} predict_file on the long file, window {FILE_WINDOW}, halo "
            f"{FILE_HALO} ({halo} after the floor): {got.shape[0]} frames, scores min "
            f"{got.min():.6f} max {got.max():.6f} std {got.std():.6f}; launches {launched}; "
            f"vs the whole forward on the card {err:.3e} (tol {SCORE_TOL})")
        check(launched == {"wave_stft_power": 1, "mel_log": 1},
              f"{arch} predict_file launched one K1 and one K2")
        check(err <= SCORE_TOL, f"{arch} windowed scores equal the whole forward")
        short_mel, short = infer.predict_file(model, short_wav, cfg, mean, std,
                                              window=FILE_WINDOW, halo=halo, device=DEVICE)
        short_mel_cpu, short_cpu = infer.predict_file(cpu_models[arch], short_wav, cfg, mean,
                                                      std, window=FILE_WINDOW, halo=halo,
                                                      device="cpu")
        cpu_err = float(np.abs(short - short_cpu).max())
        cpu_mel_err = float((short_mel.cpu() - short_mel_cpu).abs().max())
        log(f"[files] {arch} on the short file, card vs CPU: log-mel {cpu_mel_err:.3e} dB "
            f"(tol {DB_TOL}), scores {cpu_err:.3e} (tol {SCORE_TOL})")
        check(short_mel.shape == short_mel_cpu.shape and cpu_mel_err <= DB_TOL,
              f"{arch} log-mel on the card matches the CPU")
        check(short.shape == short_cpu.shape and cpu_err <= SCORE_TOL,
              f"{arch} card matches the CPU")
        scores[arch] = (got, short)

    # M5: both stems on the long file, the card's framing, card vs CPU.
    m5 = models["M5"]
    m5_s2d = M5(cfg.classes_num, conv1_s2d=True)
    m5_s2d.load_state_dict(m5.state_dict(), strict=True)
    m5_s2d = m5_s2d.to(dev).eval()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    got = infer.predict_file_m5(m5, long_wav, wcfg, device=DEVICE)
    peak_mib["M5"] = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
    got_s2d = infer.predict_file_m5(m5_s2d, long_wav, wcfg, device=DEVICE)
    n_m5 = (wav_long.shape[0] - wcfg.frame_size) // wcfg.hop_size + 1
    stem_err = float(np.abs(got - got_s2d).max())
    log(f"[files] M5 predict_file_m5 on the long file: {got.shape[0]} frames, scores min "
        f"{got.min():.6f} max {got.max():.6f} std {got.std():.6f}; direct vs "
        f"space-to-depth stem {stem_err:.3e} (tol {SCORE_TOL})")
    check(got.shape == got_s2d.shape == (n_m5, cfg.classes_num), f"M5 frames {got.shape}")
    check(stem_err <= SCORE_TOL, "M5's two stems agree")
    framed = infer.hop_frames(wave_dev, wcfg)
    host = torch.from_numpy(wav_long[:, 0]).unfold(0, wcfg.frame_size, wcfg.hop_size)
    check(framed.shape == (n_m5, 1, wcfg.frame_size) and torch.equal(framed[:, 0].cpu(), host),
          "M5's framing on the card equals unfold on the host")
    del framed, host
    short = infer.predict_file_m5(m5, short_wav, wcfg, device=DEVICE)
    short_cpu = infer.predict_file_m5(cpu_models["M5"], short_wav, wcfg, device="cpu")
    cpu_err = float(np.abs(short - short_cpu).max())
    log(f"[files] M5 framing on the card equals the host's; on the short file, card vs "
        f"CPU: {cpu_err:.3e} (tol {SCORE_TOL})")
    check(short.shape == short_cpu.shape and cpu_err <= SCORE_TOL, "M5 card matches the CPU")
    scores["M5"] = (got, short)

    # MobileNetV1 on phase 3's batch.
    samples = sr * SECONDS
    pcm = (make_signals(torch, BATCH, samples, sr, dev, 1)
           * 32767).round().to(torch.int16)[..., None]
    predict_mn = make_batch_predictor(models["MobileNetV1"], cfg, mean=mean, std=std,
                                      device=DEVICE)
    kernels.reset_launch_counts()
    mn_batch = predict_mn(pcm)
    torch.cuda.synchronize()
    mn_launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    mn_cpu = make_batch_predictor(cpu_models["MobileNetV1"], cfg, mean=mean, std=std,
                                  device="cpu")(pcm[:1].cpu())
    mn_err = float((mn_batch[:1].cpu() - mn_cpu).abs().max())
    log(f"[files] MobileNetV1 make_batch_predictor on {BATCH} x {SECONDS} s: "
        f"{tuple(mn_batch.shape)}, min {float(mn_batch.min()):.6f} max "
        f"{float(mn_batch.max()):.6f}; launches {mn_launched}; clip 0 vs CPU {mn_err:.3e} "
        f"(tol {SCORE_TOL})")
    check(mn_launched == {"wave_stft_power": 1, "mel_log": 1},
          "MobileNetV1's batch launched one K1 and one K2")
    check(bool(((mn_batch >= 0) & (mn_batch <= 1)).all()), "MobileNetV1 batch scores in [0, 1]")
    check(mn_err <= SCORE_TOL, "MobileNetV1 clip 0 matches the CPU")
    log(f"[files] checks {time.perf_counter() - t0:.1f} s")

    # The CLI without --batch, the three archs side by side.
    t1 = time.perf_counter()
    procs = {}
    for arch, model in models.items():
        torch.save({"iterations": 0, "model": model.state_dict(), "optimizer": {}},
                   tmp / f"{arch}.pth")
        out = tmp / f"out_{arch}"
        args = ["sed_tpu_torch.cli.infer", "--no_plot", "--arch", arch, "--ckpt",
                tmp / f"{arch}.pth", "--device", DEVICE, "--outputs_dir", out]
        if arch != "M5":
            args += ["--mean_std_file", tmp / "files_mean_std.pkl"]
        procs[arch] = (out, subprocess.Popen(
            [sys.executable, "-m", *map(str, args), long_wav, short_wav], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    cli_err = {}
    for arch, (out, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode != 0:
            print(stdout[-4000:], stderr[-4000:], file=sys.stderr)
        check(proc.returncode == 0, f"cli.infer --arch {arch} exit code {proc.returncode}")
        err = 0.0
        for path, want in zip((long_wav, short_wav), scores[arch]):
            got = np.load(out / f"{Path(path).stem}_scores.npy")
            check(got.shape == want.shape, f"cli.infer --arch {arch} shape {got.shape}")
            err = max(err, float(np.abs(got - want).max()))
        cli_err[arch] = err
        check(err <= SCORE_TOL, f"cli.infer --arch {arch} scores match predict_file")
    log(f"[files] python -m sed_tpu_torch.cli.infer --no_plot --arch ..., both files: max "
        f"diff vs the in-process scores " + ", ".join(f"{a} {e:.3e}" for a, e in cli_err.items())
        + f" (tol {SCORE_TOL}); {time.perf_counter() - t1:.1f} s")

    # Times: per-file calls on the long file, each split into its stages
    # inside the same call (the device synchronized at each stage's end).
    t1 = time.perf_counter()

    def staged(call):
        """{stage: [ms]} of FILE_REPS calls after one warm-up, with the whole
        call ("file") and the call without the read as the stages' sums."""
        runs = {}
        for rep in range(FILE_REPS + 1):
            timings = {}
            torch.cuda.synchronize()
            call(timings)
            for stage, sec in timings.items():
                if rep:
                    runs.setdefault(stage, []).append(sec * 1e3)
        runs["no_read"] = [f + m for f, m in zip(runs["featurizer"], runs["model"])]
        runs["file"] = [r + n for r, n in zip(runs["read"], runs["no_read"])]
        return runs

    ms = {arch: staged(lambda timings, model=models[arch], halo=halos[arch]: infer.predict_file(
        model, long_wav, cfg, mean, std, FILE_WINDOW, halo, device=DEVICE, timings=timings))
        for arch in ("CnnAvgPooling", "MobileNetV1")}
    ms["M5"] = staged(lambda timings: infer.predict_file_m5(m5, long_wav, wcfg, device=DEVICE,
                                                            timings=timings))
    # M5's stems in turns: direct, s2d, s2d, direct (model only, long file).
    stem_ms = {"direct": [], "s2d": []}
    for stem in ("direct", "s2d", "s2d", "direct"):
        net = m5 if stem == "direct" else m5_s2d
        stem_ms[stem].append(time_ms(torch, lambda net=net: infer.score_frames_m5(
            net, infer.hop_frames(wave_dev, wcfg))))
    # M5's frame bucket in turns, up and down (direct stem, model only).
    bucket_ms = {b: [] for b in M5_BUCKETS}
    for b in M5_BUCKETS + M5_BUCKETS[::-1]:
        bucket_ms[b].append(time_ms(torch, lambda b=b: infer.score_frames_m5(
            m5, infer.hop_frames(wave_dev, wcfg), b), reps=REPS // 2))
    mn_batch_ms = time_ms(torch, lambda: predict_mn(pcm))

    def spread(xs):
        return f"{statistics.median(xs):.4f} ms [{min(xs):.4f}, {max(xs):.4f}]"

    log(f"[times] {smi}; per-file calls on the {long_s:.0f} s file ({frames_long} frames; M5 "
        f"{n_m5} frames): median [min, max] of {FILE_REPS} calls after one warm-up, each call "
        f"split into its stages (perf_counter, the device synchronized at each stage's end)")
    for arch in models:
        t = ms[arch]
        what = ("float32 cast on the host, upload, hop framing" if arch == "M5"
                else "float32 cast on the host, upload, K1 + K2, normalization")
        file_s, no_read_s = statistics.median(t["file"]), statistics.median(t["no_read"])
        log(f"[times] {arch}: WAV read (native decode, float64, mono) {spread(t['read'])} | "
            f"featurizer ({what}) {spread(t['featurizer'])} | model (+ sigmoid + scores to the "
            f"host) {spread(t['model'])} | per file {spread(t['file'])} "
            f"({long_s / file_s * 1e3:.1f} audio-s/s) | without the read {spread(t['no_read'])} "
            f"({long_s / no_read_s * 1e3:.1f} audio-s/s) | peak device memory "
            f"{peak_mib[arch]:.1f} MiB above what was allocated before the call")
    log(f"[times] M5 stem A/B (model only, {n_m5} frames in buckets of 32, CUDA-event medians "
        f"of {REPS}, in turns direct, s2d, s2d, direct): direct {stem_ms['direct'][0]:.4f} / "
        f"{stem_ms['direct'][1]:.4f} ms, space-to-depth {stem_ms['s2d'][0]:.4f} / "
        f"{stem_ms['s2d'][1]:.4f} ms (s2d / direct "
        f"{statistics.mean(stem_ms['s2d']) / statistics.mean(stem_ms['direct']):.3f})")
    log(f"[times] M5 frame bucket (direct stem, model only, CUDA-event medians of {REPS // 2}, "
        f"in turns up then down): " + ", ".join(
            f"{b}: {t[0]:.4f} / {t[1]:.4f} ms" for b, t in bucket_ms.items()))
    log(f"[times] MobileNetV1 batch {BATCH} x {SECONDS} s {mn_batch_ms:.4f} ms "
        f"({BATCH * SECONDS / mn_batch_ms * 1e3:.1f} audio-s/s)")
    log(f"[files] times {time.perf_counter() - t1:.1f} s; phase {time.perf_counter() - t0:.1f} s")
    return {k: sum(file_launches[a].get(k, 0) for a in file_launches)
            for k in ("wave_stft_power", "mel_log")}


def film_clap_corpus(root, files, seconds, sr, seed):
    """A FilmClap-layout corpus (io/film_clap.py): ``files`` mono int16 WAVs
    of noise with tonal bursts as the labelled events, and the label JSON
    beside them.  FilmClap labels are event centres, each event spanning
    +-time_margin (0.33 s); a burst of 3-5 s is labelled by centres 0.33 s
    apart along it, whose intervals join into one event of the burst's
    length (long enough for the model's 8-frame output steps).  One burst
    per 15 s.  Returns the WAV paths."""
    import json as _json

    from scipy.io import wavfile

    from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM
    from sed_tpu_torch.io.film_clap import LABEL_FILE

    half = DEFAULT_SPECTROGRAM.time_margin
    film_dir = root / "FilmClap" / "film"
    film_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    slot = 15.0
    labels, paths = {}, []
    for i in range(files):
        x = 0.05 * rng.standard_normal(n)
        x += 0.03 * np.sin(2 * np.pi * rng.uniform(200, 6000) * np.arange(n) / sr)
        centers = []
        for j in range(max(1, int(seconds // slot))):
            length = rng.uniform(3.0, 5.0)
            start = j * slot + rng.uniform(1.0, slot - length - 1.0)
            a, b = int(start * sr), int((start + length) * sr)
            t = np.arange(b - a) / sr
            x[a:b] += 0.3 * (np.sin(2 * np.pi * 2000.0 * t) + np.sin(2 * np.pi * 3100.0 * t))
            centers += list(np.arange(start + half, start + length - half + 1e-9, half))
        path = str(film_dir / f"clip_{i:02d}.wav")
        wavfile.write(path, sr, (np.clip(x, -1, 1) * 32767).astype(np.int16))
        labels[path] = [float(c) for c in centers]
        paths.append(path)
    with open(root / "FilmClap" / LABEL_FILE, "w") as f:
        _json.dump(labels, f)
    return paths


def subset_corpus(root, paths, source_root):
    """A FilmClap root whose label file lists ``paths`` of ``source_root``'s."""
    import json as _json

    from sed_tpu_torch.io.film_clap import LABEL_FILE

    with open(source_root / "FilmClap" / LABEL_FILE) as f:
        labels = _json.load(f)
    (root / "FilmClap").mkdir(parents=True, exist_ok=True)
    with open(root / "FilmClap" / LABEL_FILE, "w") as f:
        _json.dump({p: labels[p] for p in paths}, f)


def profile_parts(torch, fn, n: int):
    """``torch.profiler`` over ``n`` calls of ``fn``: (device ms per call of
    the kernels each ``train_step/...`` range launched on the calling
    thread, [(kernel, ms per call), ...] largest first).  Both empty when
    the profiler captured no device time.  The ranges' own device-side
    annotations are not kernels and are left out of the list."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.events():
        if e.name.startswith("train_step/") and e.device_type == DeviceType.CPU:
            parts[e.name] = parts.get(e.name, 0.0) + e.device_time_total / 1e3 / n
    kernels_ = sorted(((e.key, e.self_device_time_total / 1e3 / n) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                       and not e.key.startswith("train_step/")), key=lambda r: -r[1])
    return {k: v for k, v in parts.items() if v > 0}, kernels_


def grad_err(a, b):
    """(largest of |a - b| / b's largest |grad| over the tensors, that tensor)."""
    return max((float((a[k] - g).abs().max() / g.abs().max().clamp_min(1e-300)), k)
               for k, g in b.items())


def train_phase(torch, cfg, dev, smi, tmp):
    """Phase 11: training of the spectrogram family (see the module
    docstring).  Returns the K1 and K2 launches of its path (the logMel
    preprocess and the batch evaluator), and the corpus (``tmp / "data"``:
    its WAVs, ``wavs``) and logMel dataset (``dataset``) for phase 12."""
    import contextlib
    import io
    import re

    from sed_tpu_torch.cli import infer
    from sed_tpu_torch.data import device_pipeline as pipe
    from sed_tpu_torch.data.events import create_event_matrix
    from sed_tpu_torch.data.preprocess import featurize_file
    from sed_tpu_torch.data.spectrogram_dataset import (SpectrogramDataset,
                                                        preprocess_film_clap_data)
    from sed_tpu_torch.inference import make_batch_evaluator, make_batch_predictor
    from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling, MobileNetV1
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.train import checkpoint, loop
    from sed_tpu_torch.train.state import init_state

    t0 = time.perf_counter()
    sr = cfg.working_sample_rate
    # Model output frames of one file: 8 * floor(frames / 8).
    out_frames = 8 * ((1 + int(TRAIN_SECONDS * sr) // cfg.hop_size) // 8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    data = tmp / "data"
    wavs = film_clap_corpus(data, TRAIN_FILES, TRAIN_SECONDS, sr, 30)
    log(f"[train] {TRAIN_FILES} x {TRAIN_SECONDS:.0f} s WAVs written (FilmClap layout, a 3-5 s "
        f"tonal burst per 15 s); {time.perf_counter() - t0:.1f} s")

    # ---- preprocess: logMel (K1 + K2 once a file), Complex on a subset ----
    launches = {}
    pre_t = {}
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    features_dir, mean_std = preprocess_film_clap_data(str(data), "logMel", cfg=cfg,
                                                       device=DEVICE, plot_sample=False)
    pre_s = time.perf_counter() - t1
    launches["preprocess"] = {k: kernels.LAUNCHES[k] for k in ("wave_stft_power", "mel_log")}
    log(f"[train] preprocess logMel: {TRAIN_FILES} files in {pre_s:.2f} s; launches "
        f"{launches['preprocess']}")
    for k in ("wave_stft_power", "mel_log"):
        check(launches["preprocess"][k] == TRAIN_FILES,
              f"{k} launched once per preprocessed file ({launches['preprocess'][k]})")
    pre_t = {}
    for path in wavs[:4]:   # the read / featurize split, timed apart
        featurize_file(path, cfg, "logMel", device=DEVICE, timings=pre_t)
    with open(Path(features_dir) / "film_clip_00_logMel_features_and_labels.pkl", "rb") as f:
        card_feats = pickle.load(f)["features"]
    cpu_feats = featurize_file(wavs[0], cfg, "logMel", device="cpu")
    pre_db = float(np.abs(card_feats - cpu_feats).max())
    log(f"[train] preprocessed log-mel, card against device='cpu' (one file, "
        f"{card_feats.shape}): {pre_db:.3e} dB (tol {DB_TOL})")
    check(pre_db <= DB_TOL, "preprocessed features on the card within 1e-4 dB of the CPU's")

    cx_root = tmp / "data_complex"
    subset_corpus(cx_root, wavs[:TRAIN_COMPLEX_FILES], data)
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    cx_dir, cx_mean_std = preprocess_film_clap_data(str(cx_root), "Complex", cfg=cfg,
                                                    device=DEVICE, plot_sample=False)
    cx_s = time.perf_counter() - t1
    cx_launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    log(f"[train] preprocess Complex: {TRAIN_COMPLEX_FILES} files in {cx_s:.2f} s; "
        f"launches {cx_launched}")
    check(not cx_launched, "Complex preprocessing launches no featurizer kernel")

    # ---- CnnAvgPooling(TRAIN_CHANNEL_AND_POOL), logMel, 400 steps ---------
    dataset = SpectrogramDataset(features_dir, mean_std, 0.25, preprocessed_mode="logMel",
                                 cfg=cfg, seed=0)
    n_val = len(dataset.val_feature_paths)
    model = CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL)
    state = init_state(model, TRAIN_LR, dev, seed=0)
    init_sd = copy.deepcopy({k: v.cpu() for k, v in state.model.state_dict().items()})
    out_dir = tmp / "run_cnn"

    def eval_all(st):
        res = loop.evaluate(st.model, st, dataset, "spectogram", 5.0, str(out_dir), 0,
                            make_plots=False, cfg=cfg)
        return float(np.mean(res[0])), float(np.mean(res[3]))

    loss0, ap0 = eval_all(state)
    kernels.reset_launch_counts()
    printed = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        state = loop.train(model, dataset, "spectogram", num_steps=TRAIN_STEPS, lr=TRAIN_LR,
                           log_freq=TRAIN_STEPS // 2, outputs_dir=str(out_dir),
                           batch_size=TRAIN_BATCH, cfg=cfg, initial_state=state,
                           make_plots=False, device=DEVICE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    launches["train"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    t1 = time.perf_counter()
    loss1, ap1 = eval_all(state)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t1) / n_val * 1e3
    im_sec = [float(x) for x in re.findall(r"im/sec: ([0-9.]+)", printed.getvalue())]
    records = [json.loads(line) for line in open(out_dir / "metrics.jsonl")]
    log(f"[train] CnnAvgPooling(TRAIN_CHANNEL_AND_POOL) logMel, batch {TRAIN_BATCH}, "
        f"{len(dataset)} starts, {n_val} validation recordings: {TRAIN_STEPS} steps at lr "
        f"{TRAIN_LR} in {train_s:.2f} s (with {len(records)} evaluations); val loss "
        f"{loss0:.4f} -> {loss1:.4f}, AP {ap0:.4f} -> {ap1:.4f}; im/sec as train prints it "
        f"{im_sec}; launches during training {launches['train']}")
    check(loss1 < loss0, f"validation loss falls ({loss0:.4f} -> {loss1:.4f})")
    check(ap1 > max(ap0, 0.5), f"AP {ap1:.4f} > max(AP0 {ap0:.4f}, 0.5)")
    check(len(records) == 2 and set(records[0]) == JSONL_KEYS,
          f"metrics.jsonl records with sed_tpu's keys ({sorted(set(records[0]) ^ JSONL_KEYS)})")
    check(not launches["train"], "training launches no featurizer kernel")
    check({p.name for p in (out_dir / "checkpoints").iterdir()} ==
          {f"iteration_{TRAIN_STEPS // 2}.pt", f"iteration_{TRAIN_STEPS}.pt"},
          "train() writes a checkpoint each log point")

    # ---- card against CPU: the same state, batches, no augmentation -------
    # In float64 for the 5 steps.  In float32 the card's first gradients part
    # from float64 by ~4e-3 of a tensor's largest (at block 3's second
    # BatchNorm bias, a sum over 14,336 terms a channel, whose backward the
    # card sums in float32), where the CPU's, which sums float32 in float64,
    # stay within ~6e-6; Adam's sign-like first update carries that into
    # later losses.  In float32 the first loss is compared, and the first
    # gradients reported with the tensor where they differ most.
    batches = list(dataset.epoch_start_indices(TRAIN_BATCH))
    step = pipe.make_spectrogram_train_step(cfg, 5.0, "logMel", augment=False)

    def run(where, dtype, n):
        m = CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL)
        m.load_state_dict(init_sd)
        st = init_state(m.to(dtype), TRAIN_LR, where)
        bufs = pipe.spectrogram_buffers_from_dataset(dataset, where)
        bufs = dataclasses.replace(bufs, features=bufs.features.to(dtype),
                                   events=bufs.events.to(dtype), mean=bufs.mean.to(dtype),
                                   std=bufs.std.to(dtype))
        losses, grads = [], None
        for i in range(n):
            losses.append(float(step(st, bufs, batches[i])))
            if i == 0:
                grads = {k: p.grad.detach().cpu().double()
                         for k, p in st.model.named_parameters()}
        return losses, grads

    t1 = time.perf_counter()
    cpu64, cpu64_g = run("cpu", torch.float64, CPU_STEPS)
    card64, card64_g = run(DEVICE, torch.float64, CPU_STEPS)
    cpu32, cpu32_g = run("cpu", torch.float32, 1)
    card32, card32_g = run(DEVICE, torch.float32, 1)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card64, cpu64))
    grad_rel = grad_err(card64_g, cpu64_g)[0]
    loss32_rel = abs(card32[0] - cpu32[0]) / abs(cpu32[0])
    log(f"[train] card against CPU from one state, float64, {CPU_STEPS} steps: losses {card64} "
        f"vs {cpu64}, max rel err {loss_rel:.3e}; first gradients max err / tensor's largest "
        f"|grad| {grad_rel:.3e} (tol {TRAIN_REL_TOL}); {time.perf_counter() - t1:.1f} s")
    log(f"[train] card against CPU, float32, first step: loss {card32[0]} vs {cpu32[0]} (rel err "
        f"{loss32_rel:.3e}, tol {TRAIN_REL_TOL}); gradients max err / tensor's largest |grad| "
        f"(the tensor): card against CPU %.3e (%s), card against float64 %.3e (%s), CPU "
        f"against float64 %.3e (%s)" % (*grad_err(card32_g, cpu32_g), *grad_err(card32_g, cpu64_g),
                                        *grad_err(cpu32_g, cpu64_g)))
    check(loss_rel <= TRAIN_REL_TOL, "card losses within 1e-4 relative of the CPU's (float64)")
    check(grad_rel <= TRAIN_REL_TOL, "card gradients within 1e-4 of the CPU's (float64)")
    check(loss32_rel <= TRAIN_REL_TOL, "card's first float32 loss within 1e-4 of the CPU's")

    # ---- resume: save at step S, load, continue == uninterrupted ----------
    bufs = pipe.spectrogram_buffers_from_dataset(dataset, dev)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        def fresh(seed=None):
            m = CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL)
            m.load_state_dict(init_sd)
            return init_state(m, TRAIN_LR, dev, seed=seed)

        cont = fresh()
        cont_losses = [float(step(cont, bufs, batches[i])) for i in range(RESUME_STEPS)]
        first = fresh()
        for i in range(RESUME_AT):
            step(first, bufs, batches[i])
        ckpt = checkpoint.save_checkpoint(first, str(tmp / "run_resume"), RESUME_AT)
        resumed = checkpoint.load_checkpoint(ckpt, fresh(seed=99), model_only=False)
        res_losses = [float(step(resumed, bufs, batches[i]))
                      for i in range(RESUME_AT, RESUME_STEPS)]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    res_loss_err = max(abs(a - b) for a, b in zip(res_losses, cont_losses[RESUME_AT:]))
    res_param_err = max(float((a - b).abs().max()) for a, b in
                        zip(cont.model.state_dict().values(), resumed.model.state_dict().values()))
    log(f"[train] resume at step {RESUME_AT} of {RESUME_STEPS} (cuDNN deterministic for both "
        f"runs): max loss err {res_loss_err:.3e}, max parameter / statistic err "
        f"{res_param_err:.3e} (tol 1e-6)")
    check(resumed.step == RESUME_STEPS and res_loss_err <= 1e-6 and res_param_err <= 1e-6,
          "resumed training equals the uninterrupted run")
    scorer = infer.load_model(ckpt, cfg.classes_num, "CnnAvgPooling")
    _, scores = infer.predict_file(scorer, wavs[-1], cfg, dataset.mean, dataset.std,
                                   device=DEVICE)
    check(scores.shape == (out_frames, cfg.classes_num) and np.isfinite(scores).all(),
          f"iteration_{RESUME_AT}.pt scores a WAV through cli/infer.load_model")
    log(f"[train] iteration_{RESUME_AT}.pt loads into cli/infer.load_model and scores "
        f"{Path(wavs[-1]).name}: {scores.shape}")
    del bufs, cont, first, resumed

    # ---- Complex mode with augmentation -----------------------------------
    cx_data = SpectrogramDataset(cx_dir, cx_mean_std, 0.25, augment_data=True,
                                 preprocessed_mode="Complex", cfg=cfg, seed=0)
    cx_printed = io.StringIO()
    with contextlib.redirect_stdout(cx_printed):
        cx_state = loop.train(CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL), cx_data,
                              "spectogram", num_steps=FEW_STEPS, lr=TRAIN_LR,
                              log_freq=FEW_STEPS, outputs_dir=str(tmp / "run_complex"),
                              batch_size=TRAIN_BATCH, augment=True, preprocessed_mode="Complex",
                              cfg=cfg, make_plots=False, device=DEVICE)
    cx_rec = json.loads(open(tmp / "run_complex" / "metrics.jsonl").read().splitlines()[-1])
    cx_bufs = pipe.spectrogram_buffers_from_dataset(cx_data, dev)
    cx_starts = torch.as_tensor(cx_data.train_start_indices[:16], device=dev)
    f, _ = pipe.make_gather_crops(cfg)(cx_bufs, cx_starts)
    transform = pipe.make_transform(cfg, "Complex")
    with torch.no_grad():
        card_x = transform(cx_bufs, f).cpu()
        cpu_bufs = pipe.spectrogram_buffers_from_dataset(cx_data, "cpu")
        cpu_x = transform(cpu_bufs, f.cpu())
    cx_db = float((card_x - cpu_x).abs().max())
    log(f"[train] Complex + augmentation: {FEW_STEPS} steps, last train loss "
        f"{cx_rec['train_loss']:.4f}, val loss {cx_rec['val_loss']:.4f}; the transform's "
        f"log-mel of 16 crops, card against CPU: {cx_db:.3e} dB (tol {DB_TOL})")
    check(np.isfinite(cx_rec["train_loss"]) and np.isfinite(cx_rec["val_loss"]),
          "Complex-mode training losses are finite")
    check(cx_db <= DB_TOL, "Complex transform on the card within 1e-4 dB of the CPU's")
    del cx_bufs, cpu_bufs, f, cx_state

    # ---- MobileNetV1 (emit='logits') --------------------------------------
    mn_printed = io.StringIO()
    with contextlib.redirect_stdout(mn_printed):
        mn_state = loop.train(MobileNetV1(cfg.classes_num, emit="logits"), dataset, "spectogram",
                              num_steps=FEW_STEPS, lr=TRAIN_LR, log_freq=FEW_STEPS,
                              outputs_dir=str(tmp / "run_mobilenet"), batch_size=TRAIN_BATCH,
                              cfg=cfg, make_plots=False, device=DEVICE)
    mn_rec = json.loads(open(tmp / "run_mobilenet" / "metrics.jsonl").read().splitlines()[-1])
    mn_ckpt = tmp / "run_mobilenet" / "checkpoints" / f"iteration_{FEW_STEPS}.pt"
    mn_loaded = infer.load_model(str(mn_ckpt), cfg.classes_num, "MobileNetV1")
    check(torch.equal(mn_loaded.fc1.weight, mn_state.model.fc1.weight.cpu()),
          "the MobileNetV1 checkpoint loads into load_model(arch='MobileNetV1')")
    log(f"[train] MobileNetV1 (emit='logits'): {FEW_STEPS} steps and one evaluation, train "
        f"loss {mn_rec['train_loss']:.4f}, val loss {mn_rec['val_loss']:.4f}, AP "
        f"{mn_rec['AP']:.4f}; iteration_{FEW_STEPS}.pt loads into load_model(arch='MobileNetV1')")
    check(np.isfinite(mn_rec["train_loss"]) and np.isfinite(mn_rec["val_loss"]),
          "MobileNetV1 training losses are finite")

    # ---- make_batch_evaluator on 4 x 60 s int16 clips ---------------------
    from scipy.io import wavfile

    clips = np.stack([wavfile.read(p)[1] for p in wavs[:EVAL_CLIPS]])[..., None]
    with open(data / "FilmClap" / "paths_and_labels_fixed_Meron.txt") as f:
        centers = json.load(f)
    targets = np.stack([create_event_matrix(
        out_frames, np.array(centers[p]) - cfg.time_margin, np.array(centers[p]) + cfg.time_margin,
        cfg) for p in wavs[:EVAL_CLIPS]])
    evaluate = make_batch_evaluator(state.model, cfg, dataset.mean, dataset.std, device=DEVICE)
    predict = make_batch_predictor(state.model, cfg, dataset.mean, dataset.std, device=DEVICE)
    clips_dev = torch.from_numpy(clips).to(dev)
    kernels.reset_launch_counts()
    ev_scores, ev_losses, _, _, ev_aps = evaluate(clips_dev, targets)
    torch.cuda.synchronize()
    launches["evaluator"] = {k: kernels.LAUNCHES[k] for k in ("wave_stft_power", "mel_log")}
    ev_err = float((ev_scores - predict(clips_dev)[:, :out_frames]).abs().max())
    log(f"[train] make_batch_evaluator on {EVAL_CLIPS} x {TRAIN_SECONDS:.0f} s int16 clips: "
        f"scores against make_batch_predictor {ev_err:.3e} (tol {SCORE_TOL}); losses "
        f"{[round(float(v), 4) for v in ev_losses]}, APs {[round(float(v), 4) for v in ev_aps]}; "
        f"launches {launches['evaluator']}")
    check(ev_err <= SCORE_TOL, "batch evaluator scores equal the batch predictor's")
    check(launches["evaluator"] == {"wave_stft_power": 1, "mel_log": 1},
          "one K1 and one K2 launch per make_batch_evaluator call")

    # ---- times -------------------------------------------------------------
    log(f"[times] phase 11 on {smi}; each line's card is this one:")
    log(f"[times] preprocess (logMel, {TRAIN_SECONDS:.0f} s files, mean of 4): read (native decode, mono) "
        f"{pre_t['read'] / 4 * 1e3:.2f} ms | featurize (float32 cast, upload, K1 + K2, "
        f"download) {pre_t['featurize'] / 4 * 1e3:.2f} ms per file; whole job "
        f"{pre_s / TRAIN_FILES * 1e3:.2f} ms per file logMel, {cx_s / TRAIN_COMPLEX_FILES * 1e3:.2f}"
        f" ms Complex; {smi}")
    log(f"[times] evaluate (bucketed exact forward, host metrics): {eval_ms:.2f} ms per "
        f"{TRAIN_SECONDS:.0f} s validation recording; train() im/sec {im_sec} "
        f"(the reference's definition: steps x batch / wall-s since the start, evaluations "
        f"included; {smi})")
    step_ms, parts, top = {}, {}, []
    cx_bufs = pipe.spectrogram_buffers_from_dataset(cx_data, dev)
    lm_bufs = pipe.spectrogram_buffers_from_dataset(dataset, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    for arch in ("CnnAvgPooling", "MobileNetV1"):
        for mode, bufs, data_ in (("logMel", lm_bufs, dataset), ("Complex", cx_bufs, cx_data)):
            for aug in (False, True):
                m = (CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL) if arch == "CnnAvgPooling"
                     else MobileNetV1(cfg.classes_num, emit="logits"))
                st = init_state(m, TRAIN_LR, dev, seed=1)
                fn_step = pipe.make_spectrogram_train_step(cfg, 5.0, mode, augment=aug)
                starts = torch.as_tensor(data_.train_start_indices[:TRAIN_BATCH], device=dev)
                step_ms[arch, mode, aug] = time_ms(
                    torch, lambda: fn_step(st, bufs, starts, gen))
                if arch == "CnnAvgPooling" and mode == "logMel" and not aug:
                    parts, top = profile_parts(torch, lambda: fn_step(st, bufs, starts, gen),
                                               TRAIN_PROFILE_STEPS)
    for (arch, mode, aug), ms in step_ms.items():
        log(f"[times] train step {arch} {mode} augmentation {'on' if aug else 'off'}, batch "
            f"{TRAIN_BATCH} x {cfg.train_crop_size} frames: {ms:.4f} ms (CUDA-event median of "
            f"{REPS}; {TRAIN_BATCH / ms * 1e3:.1f} im/sec; {smi})")
    if parts and top:
        part = {k.split("/")[1]: v for k, v in parts.items()}
        busy = sum(ms for _, ms in top)
        # The autograd engine runs the backward on its own thread, outside
        # the train_step/backward range: its kernels are the rest of the step's.
        part["backward"] = busy - sum(v for k, v in part.items() if k != "backward")
        log(f"[times] CnnAvgPooling logMel step by part (torch.profiler, "
            f"{TRAIN_PROFILE_STEPS} steps, device ms per step, {smi}; backward = the kernels outside "
            f"the other ranges): gather + transform "
            f"{part.get('gather', 0.0) + part.get('transform', 0.0):.4f}, forward + backward "
            f"{part.get('forward', 0.0) + part['backward']:.4f}, optimizer "
            f"{part.get('optimizer', 0.0):.4f} (" + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(part.items(), key=lambda r: -r[1])) + ")")
        log(f"[times] its kernels: {busy:.4f} ms a step "
            f"({busy / step_ms['CnnAvgPooling', 'logMel', False]:.1%} of the step); the 8 largest:")
        for kname, ms in top[:8]:
            log(f"[times]   {ms:.4f} ms  {kname[:90]}")
    else:
        log("[times] step by part: torch.profiler captured no device time (not measured)")
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    log(f"[times] phase 11 peak device memory {peak:.1f} MiB ({smi})")
    log(f"[train] phase {time.perf_counter() - t0:.1f} s")
    return ({k: launches["preprocess"][k] + launches["evaluator"][k]
             for k in ("wave_stft_power", "mel_log")}, {"wavs": wavs, "dataset": dataset})


def trace_names(path):
    """The event names of a Chrome trace file."""
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def wavetrain_phase(torch, cfg, dev, smi, tmp, spec):
    """Phase 12: M5 training on the card (see the module docstring), on
    phase 11's corpus under ``tmp`` (``spec``: its WAVs and logMel dataset).
    Returns the launch counts of every kernel wrapper while M5 trained."""
    import contextlib
    import io
    import itertools
    import re

    from scipy.io import wavfile

    from sed_tpu_torch.cli import infer
    from sed_tpu_torch.configs import WaveformConfig
    from sed_tpu_torch.data import device_pipeline as pipe
    from sed_tpu_torch.data.waveform_dataset import WaveformDataset
    from sed_tpu_torch.inference import make_batch_evaluator, make_batch_predictor
    from sed_tpu_torch.io.film_clap import get_film_clap_paths_and_labels
    from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling, MobileNetV1
    from sed_tpu_torch.models.m5 import M5
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.train import checkpoint, loop
    from sed_tpu_torch.train.state import init_state

    t0 = time.perf_counter()
    wcfg = WaveformConfig()
    data, wavs = tmp / "data", spec["wavs"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    # ---- the dataset and its buffers (one upload) --------------------------
    quiet = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(quiet):
        dataset = WaveformDataset(get_film_clap_paths_and_labels(str(data / "FilmClap"),
                                                                 wcfg.time_margin),
                                  WAVE_VAL, cfg=wcfg, seed=0)
    ds_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    bufs = pipe.waveform_buffers_from_dataset(dataset, dev)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t1
    n_val, total = len(dataset.val_file_names), dataset.long_waveform.shape[1]
    up_mib = sum(t.numel() * t.element_size() for t in (bufs.waveform, bufs.labels,
                                                         bufs.start_indices)) / 2**20
    check(bufs.waveform.shape == (1, total) and bufs.waveform.dtype == torch.float32
          and bufs.labels.shape == (total,) and bufs.labels.dtype == torch.float32
          and bufs.start_indices.dtype == torch.int64 and bufs.waveform.device == dev,
          "waveform buffers on the card: samples and labels float32, starts int64")
    check(torch.equal(bufs.waveform[0, -wcfg.frame_size:].cpu(),
                      torch.from_numpy(dataset.long_waveform[0, -wcfg.frame_size:]))
          and torch.equal(bufs.start_indices[:1000].cpu(), torch.from_numpy(
              dataset.possible_start_indices[:1000]).long()),
          "the uploaded buffers equal the dataset's arrays")
    log(f"[wavetrain] WaveformDataset on phase 11's corpus: {total} samples of "
        f"{len(wavs) - n_val} files, {len(dataset)} starts, {n_val} validation recordings "
        f"in {ds_s:.2f} s; one upload ({up_mib:.1f} MiB) in {up_s:.2f} s")

    # ---- M5(1), 400 steps at batch 128 ---------------------------------------
    model = M5(wcfg.classes_num)
    state = init_state(model, TRAIN_LR, dev, seed=0)
    init_sd = copy.deepcopy({k: v.cpu() for k, v in state.model.state_dict().items()})
    out_dir = tmp / "run_m5"

    def eval_all(st):
        res = loop.evaluate(st.model, st, dataset, "waveform", 5.0, str(out_dir), 0,
                            make_plots=False, cfg=wcfg)
        return float(np.mean(res[0])), float(np.mean(res[3]))

    loss0, ap0 = eval_all(state)
    kernels.reset_launch_counts()
    printed = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        state = loop.train(model, dataset, "waveform", num_steps=TRAIN_STEPS, lr=TRAIN_LR,
                           log_freq=TRAIN_STEPS // 2, outputs_dir=str(out_dir),
                           batch_size=WAVE_BATCH, cfg=wcfg, initial_state=state,
                           make_plots=False, device=DEVICE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)
    t1 = time.perf_counter()
    loss1, ap1 = eval_all(state)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t1) / n_val * 1e3
    im_sec = [float(x) for x in re.findall(r"im/sec: ([0-9.]+)", printed.getvalue())]
    records = [json.loads(line) for line in open(out_dir / "metrics.jsonl")]
    log(f"[wavetrain] M5(1), batch {WAVE_BATCH} x {wcfg.frame_size} samples: {TRAIN_STEPS} steps "
        f"at lr {TRAIN_LR} in {train_s:.2f} s (with {len(records)} evaluations); val loss "
        f"{loss0:.4f} -> {loss1:.4f}, AP {ap0:.4f} -> {ap1:.4f}; im/sec as train prints it "
        f"{im_sec}; launches during training {launches}")
    check(loss1 < loss0, f"validation loss falls ({loss0:.4f} -> {loss1:.4f})")
    check(ap1 > max(ap0, 0.5), f"AP {ap1:.4f} > max(AP0 {ap0:.4f}, 0.5)")
    check(len(records) == 2 and set(records[0]) == JSONL_KEYS,
          f"metrics.jsonl records with sed_tpu's keys ({sorted(set(records[0]) ^ JSONL_KEYS)})")
    check(not any(launches.values()), "M5 training launches none of K1-K10")
    check({p.name for p in (out_dir / "checkpoints").iterdir()} ==
          {f"iteration_{TRAIN_STEPS // 2}.pt", f"iteration_{TRAIN_STEPS}.pt"},
          "train() writes a checkpoint each log point")
    del state

    # The training CLI with its defaults (Waveform, M5, batch 128) on a few
    # of the files runs beside the checks below, none of which is timed.
    cli_root, cli_log = tmp / "data_cli", tmp / "cli_main.log"
    subset_corpus(cli_root, wavs[:WAVE_CLI_FILES], data)
    t_cli = time.perf_counter()
    cli_proc = start_cli(["sed_tpu_torch.cli.main", "--dataset_dir", cli_root, "--outputs_root",
                          tmp / "cli_runs", "--num_train_steps", 4, "--log_freq", 4, "--no_plot",
                          "--device", DEVICE], cli_log)

    # ---- card against CPU: one state, the same batches ---------------------
    # Float64 at batch WAVE_CPU_BATCH (the CPU's time); in float32 the first
    # loss is compared and the gradients' distances reported.  M5's conv
    # biases each feed a BatchNorm, which removes them: their gradients are
    # zero up to rounding, so they are left out of the gradient comparison
    # (their largest |grad| is printed).
    cpu_bufs = pipe.waveform_buffers_from_dataset(dataset, "cpu")
    step = pipe.make_waveform_train_step(wcfg, 5.0, augment=False)

    def as_dtype(b, dtype):
        return dataclasses.replace(b, waveform=b.waveform.to(dtype), labels=b.labels.to(dtype))

    def run(where, b, dtype, n):
        m = M5(wcfg.classes_num)
        m.load_state_dict(init_sd)
        st = init_state(m.to(dtype), TRAIN_LR, where)
        b = as_dtype(b, dtype)
        losses, grads = [], None
        for s in itertools.islice(dataset.epoch_start_indices(WAVE_CPU_BATCH), n):
            losses.append(float(step(st, b, s)))
            if grads is None:
                grads = {k: p.grad.detach().cpu().double() for k, p in st.model.named_parameters()}
        biases = max(float(g.abs().max()) for k, g in grads.items() if k.endswith(CONV_BIASES))
        return losses, {k: g for k, g in grads.items() if not k.endswith(CONV_BIASES)}, biases

    t1 = time.perf_counter()
    cpu64, cpu64_g, cpu64_b = run("cpu", cpu_bufs, torch.float64, CPU_STEPS)
    card64, card64_g, card64_b = run(DEVICE, bufs, torch.float64, CPU_STEPS)
    cpu32, cpu32_g, _ = run("cpu", cpu_bufs, torch.float32, 1)
    card32, card32_g, card32_b = run(DEVICE, bufs, torch.float32, 1)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card64, cpu64))
    grad_rel = grad_err(card64_g, cpu64_g)[0]
    loss32_rel = abs(card32[0] - cpu32[0]) / abs(cpu32[0])
    log(f"[wavetrain] card against CPU from one state, float64, batch {WAVE_CPU_BATCH}, "
        f"{CPU_STEPS} steps: losses {card64} vs {cpu64}, max rel err {loss_rel:.3e}; first "
        f"gradients max err / tensor's largest |grad| {grad_rel:.3e} (tol {TRAIN_REL_TOL}; "
        f"the conv biases' largest |grad|: card {card64_b:.3e}, CPU {cpu64_b:.3e}, card "
        f"float32 {card32_b:.3e}); {time.perf_counter() - t1:.1f} s")
    log(f"[wavetrain] card against CPU, float32, first step: loss {card32[0]} vs {cpu32[0]} "
        f"(rel err {loss32_rel:.3e}, tol {TRAIN_REL_TOL}); gradients max err / tensor's largest "
        f"|grad| (the tensor): card against CPU %.3e (%s), card against float64 %.3e (%s), CPU "
        f"against float64 %.3e (%s)" % (*grad_err(card32_g, cpu32_g), *grad_err(card32_g, cpu64_g),
                                        *grad_err(cpu32_g, cpu64_g)))
    check(loss_rel <= TRAIN_REL_TOL, "card losses within 1e-4 relative of the CPU's (float64)")
    check(grad_rel <= TRAIN_REL_TOL, "card gradients within 1e-4 of the CPU's (float64)")
    check(loss32_rel <= TRAIN_REL_TOL, "card's first float32 loss within 1e-4 of the CPU's")

    # ---- augmentation: a short run, and the apply card against CPU ---------
    aug_out = tmp / "run_m5_aug"
    with contextlib.redirect_stdout(io.StringIO()):
        loop.train(M5(wcfg.classes_num), dataset, "waveform", num_steps=FEW_STEPS, lr=TRAIN_LR,
                   log_freq=FEW_STEPS, outputs_dir=str(aug_out), batch_size=WAVE_BATCH,
                   augment=True, cfg=wcfg, make_plots=False, limit_val_samples=1,
                   device=DEVICE)
    aug_rec = json.loads(open(aug_out / "metrics.jsonl").read().splitlines()[-1])
    gather = pipe.make_waveform_gather(wcfg)
    starts = torch.as_tensor(dataset.possible_start_indices[:WAVE_BATCH], device=dev)
    w, y = gather(bufs, starts)
    d = pipe.draw_augmentation(torch.Generator(device=dev).manual_seed(3), bufs, w.shape, False)
    card_x, card_y = pipe.apply_augmentation(bufs, w, y, d, gather, False, pipe.WAVE_MIX_CUM)
    cpu_d = pipe.AugmentDraws(d.u_mix.cpu(), d.ptr.cpu(), d.u_noise.cpu(), d.noise.cpu())
    cpu_x, cpu_y = pipe.apply_augmentation(cpu_bufs, w.cpu(), y.cpu(), cpu_d, gather, False,
                                           pipe.WAVE_MIX_CUM)
    aug_err = float((card_x.cpu() - cpu_x).abs().max())
    log(f"[wavetrain] augmentation on: {FEW_STEPS} steps, last train loss "
        f"{aug_rec['train_loss']:.4f}, val loss {aug_rec['val_loss']:.4f}; the apply on one set "
        f"of {WAVE_BATCH} draws, card against CPU: {aug_err:.3e} (tol 1e-6), labels "
        f"{'equal' if torch.equal(card_y.cpu(), cpu_y) else 'differ'}")
    check(np.isfinite(aug_rec["train_loss"]) and np.isfinite(aug_rec["val_loss"]),
          "augmented M5 training losses are finite")
    check(aug_err <= 1e-6 and torch.equal(card_y.cpu(), cpu_y),
          "the augmentation apply on the card equals the CPU's")
    del cpu_bufs, w, y, d, card_x, cpu_x

    # ---- K steps in one call against K single calls, resume ----------------
    spec_data = spec["dataset"]
    spec_bufs = pipe.spectrogram_buffers_from_dataset(spec_data, dev)
    block = np.stack(list(itertools.islice(dataset.epoch_start_indices(WAVE_BATCH),
                                           STEPS_PER_CALL)))
    spec_block = np.stack(list(itertools.islice(spec_data.epoch_start_indices(TRAIN_BATCH),
                                                STEPS_PER_CALL)))
    families = {
        "M5": (lambda: M5(wcfg.classes_num), pipe.make_waveform_train_step(wcfg, 5.0, True),
               bufs, block),
        "CnnAvgPooling": (lambda: CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL),
                          pipe.make_spectrogram_train_step(cfg, 5.0, "logMel", True),
                          spec_bufs, spec_block),
        "MobileNetV1": (lambda: MobileNetV1(cfg.classes_num, emit="logits"),
                        pipe.make_spectrogram_train_step(cfg, 5.0, "logMel", True),
                        spec_bufs, spec_block),
    }
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for arch in ("M5", "CnnAvgPooling"):
            fresh, fn_step, b, blk = families[arch]
            single = init_state(fresh(), TRAIN_LR, dev, seed=2)
            gen = torch.Generator(device=dev).manual_seed(11)
            want = torch.stack([fn_step(single, b, s, gen) for s in blk])
            multi = init_state(fresh(), TRAIN_LR, dev, seed=2)
            gen = torch.Generator(device=dev).manual_seed(11)
            got = pipe.make_multi_step(fn_step, STEPS_PER_CALL)(multi, b, blk, gen)
            p_err = max(float((u - v).abs().max()) for u, v in zip(
                single.model.state_dict().values(), multi.model.state_dict().values()))
            log(f"[wavetrain] make_multi_step, {arch}, K = {STEPS_PER_CALL} with augmentation "
                f"against {STEPS_PER_CALL} single calls (one state, one generator seed, cuDNN "
                f"deterministic): losses {got.tolist()} vs {want.tolist()}, max parameter / "
                f"statistic err {p_err:.3e}")
            check(torch.equal(got, want) and p_err == 0.0,
                  f"{arch}: K steps in one call equal K single calls")

        cont = init_state(M5(wcfg.classes_num), TRAIN_LR, dev, seed=0)
        batches = list(itertools.islice(dataset.epoch_start_indices(WAVE_BATCH), RESUME_STEPS))
        cont_losses = [float(step(cont, bufs, s)) for s in batches]
        first = init_state(M5(wcfg.classes_num), TRAIN_LR, dev, seed=0)
        for s in batches[:RESUME_AT]:
            step(first, bufs, s)
        ckpt = checkpoint.save_checkpoint(first, str(tmp / "run_m5_resume"), RESUME_AT)
        resumed = checkpoint.load_checkpoint(
            ckpt, init_state(M5(wcfg.classes_num), TRAIN_LR, dev, seed=99), model_only=False)
        res_losses = [float(step(resumed, bufs, s)) for s in batches[RESUME_AT:]]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    res_loss_err = max(abs(a - b) for a, b in zip(res_losses, cont_losses[RESUME_AT:]))
    res_param_err = max(float((a - b).abs().max()) for a, b in
                        zip(cont.model.state_dict().values(), resumed.model.state_dict().values()))
    log(f"[wavetrain] resume at step {RESUME_AT} of {RESUME_STEPS} (cuDNN deterministic for both "
        f"runs): max loss err {res_loss_err:.3e}, max parameter / statistic err "
        f"{res_param_err:.3e} (tol 1e-6)")
    check(resumed.step == RESUME_STEPS and res_loss_err <= 1e-6 and res_param_err <= 1e-6,
          "resumed M5 training equals the uninterrupted run")
    del cont, first, resumed

    # ---- profile_dir: a trace of steps 12-20 in K-step calls ---------------
    prof_dir = tmp / "m5_profile"
    with contextlib.redirect_stdout(io.StringIO()):
        loop.train(M5(wcfg.classes_num), dataset, "waveform", num_steps=20, lr=TRAIN_LR,
                   log_freq=20, outputs_dir=str(tmp / "run_m5_profile"), batch_size=WAVE_BATCH,
                   cfg=wcfg, make_plots=False, limit_val_samples=1, profile_dir=str(prof_dir),
                   steps_per_call=STEPS_PER_CALL, device=DEVICE)
    traces = sorted(p.name for p in prof_dir.iterdir())
    names = trace_names(prof_dir / traces[0]) if traces else set()
    log(f"[wavetrain] profile_dir with steps_per_call {STEPS_PER_CALL}: {traces}, "
        f"{(prof_dir / traces[0]).stat().st_size / 2**20 if traces else 0:.1f} MiB, ranges "
        f"{sorted(n for n in names if str(n).startswith('train_step/'))}")
    check(traces == ["train_steps_12-20.json"]
          and {"train_step/forward", "train_step/backward"} <= names,
          "profile_dir holds a trace of steps 12-20 with the step's ranges")

    # ---- the predictor and the evaluator after model.train(); TF32 flags ---
    clips = np.stack([wavfile.read(p)[1] for p in wavs[:EVAL_CLIPS]])[..., None]
    clips_dev = torch.from_numpy(clips).to(dev)
    out_frames = 8 * ((1 + clips.shape[1] // cfg.hop_size) // 8)
    targets = torch.zeros(EVAL_CLIPS, out_frames, 1, device=dev)
    cnn = seed_batch_norms(torch, CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL,
                                                generator=torch.Generator().manual_seed(4)), 4)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    seen, after = [], []
    hook = cnn.register_forward_hook(lambda *_: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        predict = make_batch_predictor(cnn, cfg, spec_data.mean, spec_data.std, device=DEVICE)
        evaluate = make_batch_evaluator(cnn, cfg, spec_data.mean, spec_data.std, device=DEVICE)
        calls = []
        for mode in ("eval", "train"):
            if mode == "train":
                stats = {k: v.clone() for k, v in cnn.state_dict().items() if "running" in k}
                cnn.train()
            calls.append((predict(clips_dev), evaluate(clips_dev, targets)[0]))
            after.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        stats_same = all(torch.equal(v, stats[k]) for k, v in cnn.state_dict().items()
                         if k in stats)
        p2_loss = float(pipe.make_spectrogram_train_step(cfg)(
            init_state(cnn, TRAIN_LR, dev), spec_bufs, spec_block[0]))
        after.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
    finally:
        hook.remove()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    p2_err = max(float((a - b).abs().max()) for a, b in zip(calls[0], calls[1]))
    log(f"[wavetrain] P2: make_batch_predictor and make_batch_evaluator on {EVAL_CLIPS} x "
        f"{TRAIN_SECONDS:.0f} s "
        f"int16 clips, called again after model.train(): scores differ by {p2_err:.3e} "
        f"(tol 1e-6), running statistics {'unchanged' if stats_same else 'CHANGED'} (then "
        f"changed by the train step), a train step after them: loss {p2_loss:.4f}")
    log(f"[wavetrain] P3: TF32 flags (cuDNN, matmul) set True by the caller: inside the calls "
        f"{sorted(set(seen))}, after each call {after}")
    check(p2_err <= 1e-6, "the predictor and evaluator score in eval mode after model.train()")
    check(stats_same, "scoring after model.train() leaves the running statistics alone")
    check(np.isfinite(p2_loss), "a train step runs after the scoring calls")
    check(set(seen) == {(False, False)} and set(after) == {(True, True)},
          "TF32 off inside each call, the caller's flags after it")
    del predict, evaluate, cnn, calls

    # ---- the CLI's checkpoint scored by cli.infer --arch M5 ------------------
    finish_cli(cli_proc, cli_log, "cli.main (Waveform)")
    (cli_ckpt,) = (tmp / "cli_runs").glob("*/checkpoints/iteration_4.pt")
    cli_out = tmp / "cli_infer"
    run_cli(["sed_tpu_torch.cli.infer", "--arch", "M5", "--no_plot", "--ckpt", cli_ckpt,
             "--outputs_dir", cli_out, "--device", DEVICE, wavs[0]], "cli.infer --arch M5")
    cli_scores = np.load(cli_out / f"{Path(wavs[0]).stem}_scores.npy")
    ref = infer.predict_file_m5(infer.load_model(str(cli_ckpt), 1, "M5"), wavs[0], wcfg,
                                device=DEVICE)
    cli_err = float(np.abs(cli_scores - ref).max())
    log(f"[wavetrain] python -m sed_tpu_torch.cli.main --no_plot (defaults: Waveform, M5, batch "
        f"128) on {WAVE_CLI_FILES} files, 4 steps -> {cli_ckpt.relative_to(tmp)}; cli.infer "
        f"--arch M5 scores {Path(wavs[0]).name}: {cli_scores.shape}, against the in-process "
        f"predict_file_m5 {cli_err:.3e} (tol {SCORE_TOL}); {time.perf_counter() - t_cli:.1f} s "
        f"since the training CLI started")
    check(cli_scores.shape == ref.shape == (1 + (clips.shape[1] - wcfg.frame_size)
                                            // wcfg.hop_size, 1),
          f"cli.infer --arch M5 scores one value a frame ({cli_scores.shape})")
    check(cli_err <= SCORE_TOL, "the CLI's M5 scores equal the in-process ones")

    # ---- times ---------------------------------------------------------------
    log(f"[times] phase 12 on {smi}; each line's card is this one:")
    gen = torch.Generator(device=dev).manual_seed(5)
    step_ms, parts, top = {}, {}, []
    for aug in (False, True):
        st = init_state(M5(wcfg.classes_num), TRAIN_LR, dev, seed=1)
        fn_step = pipe.make_waveform_train_step(wcfg, 5.0, augment=aug)
        step_ms[aug] = time_ms(torch, lambda: fn_step(st, bufs, starts, gen))
        if not aug:
            parts, top = profile_parts(torch, lambda: fn_step(st, bufs, starts, gen),
                                       TRAIN_PROFILE_STEPS)
        log(f"[times] train step M5 augmentation {'on' if aug else 'off'}, batch {WAVE_BATCH} x "
            f"{wcfg.frame_size} samples: {step_ms[aug]:.4f} ms (CUDA-event median of {REPS}; "
            f"{WAVE_BATCH / step_ms[aug] * 1e3:.1f} im/sec; {smi})")
    if parts and top:
        part = {k.split("/")[1]: v for k, v in parts.items()}
        busy = sum(ms for _, ms in top)
        part["backward"] = busy - sum(v for k, v in part.items() if k != "backward")
        log(f"[times] M5 step by part (torch.profiler, {TRAIN_PROFILE_STEPS} steps, device ms per "
            f"step, {smi}; backward = the kernels outside the other ranges): " + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(part.items(), key=lambda r: -r[1])))
        log(f"[times] its kernels: {busy:.4f} ms a step ({busy / step_ms[False]:.1%} of the "
            f"step); the 8 largest:")
        for kname, ms in top[:8]:
            log(f"[times]   {ms:.4f} ms  {kname[:90]}")
    else:
        log("[times] M5 step by part: torch.profiler captured no device time (not measured)")
    # cuDNN picks its algorithms by heuristics (the port leaves benchmark
    # mode off); timed once with them measured at the first call instead.
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        st = init_state(M5(wcfg.classes_num), TRAIN_LR, dev, seed=1)
        fn_step = pipe.make_waveform_train_step(wcfg, 5.0, augment=False)
        bench_ms = time_ms(torch, lambda: fn_step(st, bufs, starts, gen))
    finally:
        torch.backends.cudnn.benchmark = benchmark
    log(f"[times] train step M5 augmentation off with cuDNN's benchmark mode on (a measurement "
        f"only): {bench_ms:.4f} ms (CUDA-event median of {REPS}; {smi})")
    # Both forms with STEPS_PER_CALL steps between the events, as train()
    # queues its steps without waiting for the card.
    for arch, (fresh, fn_step, b, blk) in families.items():
        st = init_state(fresh(), TRAIN_LR, dev, seed=1)
        blk_dev = torch.as_tensor(blk, device=dev)
        multi = pipe.make_multi_step(fn_step, STEPS_PER_CALL)
        one = [time_ms(torch, lambda: fn_step(st, b, blk_dev[0], gen), calls=STEPS_PER_CALL)]
        many = time_ms(torch, lambda: multi(st, b, blk_dev, gen)) / STEPS_PER_CALL
        one.append(time_ms(torch, lambda: fn_step(st, b, blk_dev[0], gen), calls=STEPS_PER_CALL))
        log(f"[times] train step {arch} (augmentation on), {STEPS_PER_CALL} steps between the "
            f"events: steps_per_call 1 {one[0]:.4f} / {one[1]:.4f} ms, steps_per_call "
            f"{STEPS_PER_CALL} {many:.4f} ms a step (CUDA-event medians of {REPS}, single steps "
            f"before and after; {smi})")
    log(f"[times] evaluate (M5, frames padded to {loop.WAVEFORM_EVAL_BUCKET}, host metrics): "
        f"{eval_ms:.2f} ms per {TRAIN_SECONDS:.0f} s validation recording; train() im/sec "
        f"{im_sec} (the reference's definition; {smi})")
    del bufs, spec_bufs, families

    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    log(f"[times] phase 12 peak device memory {peak:.1f} MiB ({smi})")
    log(f"[wavetrain] phase {time.perf_counter() - t0:.1f} s")
    return launches


def serve_phase(torch, cfg, dev, smi, tmp, mean, std):
    """Phase 13: sed_tpu's checkpoints and the live serving of MobileNetV1
    and M5 on the card (see the module docstring).  ``mean``, ``std``:
    phase 3's normalization.  Returns the launch counts of the phase's
    main-path runs, summed."""
    from scipy.io import wavfile

    from sed_tpu_torch.cli import infer
    from sed_tpu_torch.cli.serve_socket import warmup_pool
    from sed_tpu_torch.configs import WaveformConfig
    from sed_tpu_torch.inference import make_batch_predictor
    from sed_tpu_torch.models.cnn import MobileNetV1
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.ops.mulaw import mulaw_decode_np, mulaw_encode
    from sed_tpu_torch.serve_socket import StreamClient, StreamServer
    from sed_tpu_torch.stream_pool import StreamPool
    from sed_tpu_torch.train.checkpoint import save_checkpoint
    from sed_tpu_torch.train.state import init_state
    from sed_tpu_torch.waveform_streaming import DeviceWaveformStreamPool, WaveformStreamPool

    t0 = time.perf_counter()
    sr = chunk = cfg.working_sample_rate
    wcfg = WaveformConfig()
    served = dict.fromkeys(kernels.LAUNCHES, 0)

    def count(launches):
        for k, v in launches.items():
            served[k] += v

    # ---- the weights, their files and the audio ------------------------------
    models, pts = {}, {}
    for i, arch in enumerate(SERVE_ARCHS):
        model = infer.build_model(arch, cfg.classes_num)
        model.reset_parameters(torch.Generator().manual_seed(30 + i))
        models[arch] = seed_batch_norms(torch, model, 40 + i)
        state = init_state(copy.deepcopy(model), 1e-3, "cpu")
        state.step = SERVE_STEP
        pts[arch] = save_checkpoint(state, str(tmp / arch), SERVE_STEP)
        models[arch].to(dev)
    logits = MobileNetV1(cfg.classes_num, emit="logits")
    logits.load_state_dict(models["MobileNetV1"].state_dict())
    halo = infer.halo_floor(logits, 64)
    check(halo == 88, f"MobileNetV1's halo floor {halo}")
    with open(tmp / "mean_std.pkl", "wb") as f:
        pickle.dump({"mean": mean, "std": std}, f)
    short = str(burst_wav(tmp / "short.wav", FILE_SECONDS[1], sr, 11))
    audio = (make_signals(torch, POOL_SLOTS, sr * POOL_SECONDS, sr, dev, 13) * 32767
             ).round().to(torch.int16).cpu().numpy()
    clips = [audio[i] for i in range(POOL_SLOTS)]
    clips[EARLY_LEAVER] = clips[EARLY_LEAVER][: int(EARLY_SECONDS * sr)]
    m5_clips = list(clips)
    m5_clips[SERVE_MULAW] = mulaw_encode(clips[SERVE_MULAW])
    wavs = []
    for i, secs in enumerate(CLI_SECONDS):
        wavs.append(tmp / f"stream{i}.wav")
        wavfile.write(wavs[-1], sr, audio[i, : int(secs * sr)])

    # ---- the CLIs, in the background: converters, cli.infer, cli.stream -------
    def spec_args(arch):
        return ["--mean_std_file", tmp / "mean_std.pkl"] if arch != "M5" else []

    stream_runs = {}
    for arch, extra in SERVE_STREAM_RUNS:
        out = tmp / f"out_stream_{arch}_{'_'.join(extra)}"
        args = ["sed_tpu_torch.cli.stream", "--ckpt", pts[arch], "--arch", arch, *extra,
                *spec_args(arch), "--device", DEVICE, "--outputs_dir", out, "--slots", "2",
                "--stagger_ticks", "2", *wavs]
        stream_runs[arch, tuple(extra)] = (out, start_cli(args, out.with_suffix(".log")))
    chain = {}

    def conversions():
        """export_torch, then import_torch, then cli.infer of the imported
        file: each step the three archs side by side."""
        try:
            for step in ("export", "import", "infer"):
                procs = {}
                for arch in SERVE_ARCHS:
                    pth, run = tmp / f"{arch}.pth", tmp / f"imported_{arch}"
                    args = {
                        "export": ["sed_tpu_torch.cli.export_torch", "--ckpt", pts[arch],
                                   "--out", pth],
                        "import": ["sed_tpu_torch.cli.import_torch", "--pth", pth,
                                   "--out", run],
                        "infer": ["sed_tpu_torch.cli.infer", "--no_plot", "--ckpt",
                                  run / "checkpoints" / f"iteration_{SERVE_STEP}.pt",
                                  *spec_args(arch), "--outputs_dir", tmp / f"out_infer_{arch}",
                                  short],
                    }[step] + ["--arch", arch, "--device", DEVICE]
                    log_path = tmp / f"{step}_{arch}.log"
                    procs[arch] = (start_cli(args, log_path), log_path)
                for arch, (proc, log_path) in procs.items():
                    finish_cli(proc, log_path, f"cli.{step} --arch {arch}")
        except Exception as e:  # noqa: BLE001 - raised in the main thread
            chain["error"] = e

    chain_thread = threading.Thread(target=conversions)
    chain_thread.start()

    # ---- untimed checks beside the CLIs ---------------------------------------
    predict_mn = make_batch_predictor(models["MobileNetV1"], cfg, mean=mean, std=std,
                                      device=DEVICE)
    full = [i for i in range(POOL_SLOTS) if i != EARLY_LEAVER]
    want_mn = dict(zip(full, score_all(torch, predict_mn, [clips[i] for i in full])))
    want_mn[EARLY_LEAVER] = score_all(torch, predict_mn, [clips[EARLY_LEAVER]])[0]
    m5 = models["M5"]

    def m5_offline(y):
        f32 = mulaw_decode_np(y) if y.dtype == np.uint8 else y.astype(np.float32) / 32768.0
        frames = infer.hop_frames(torch.from_numpy(f32).to(dev)[:, None], wcfg)
        with torch.inference_mode():
            return infer.score_frames_m5(m5, frames).cpu().numpy()

    want_m5 = [m5_offline(y) for y in m5_clips]

    def max_err(got, want, what):
        err = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            check(g.shape == w.shape, f"{what} stream {i}: {g.shape} != offline {w.shape}")
            err = max(err, float(np.abs(g - w).max()))
        check(err <= SCORE_TOL, f"{what} within {SCORE_TOL} of offline scoring")
        return err

    xpool = StreamPool(copy.deepcopy(logits), cfg, slots=POOL_SLOTS, chunk_samples=chunk,
                       halo=halo, mean=mean, std=std, featurizer="xla", device=DEVICE)
    got, _, xla_launches, _, _ = drive_pool(torch, dev, xpool, clips, chunk, seed=13)
    count(xla_launches)
    xla_err = max_err(got, [want_mn[i] for i in range(POOL_SLOTS)], "MobileNetV1 pool, xla")
    check(sum(xla_launches.values()) == 0, "featurizer='xla' launches no kernel of the port")
    del xpool
    log(f"[serve] MobileNetV1 StreamPool(featurizer='xla'), {POOL_SLOTS} streams: launches "
        f"{xla_launches}; max diff vs make_batch_predictor {xla_err:.3e} (tol {SCORE_TOL})")

    server_err, server_launches = {}, dict.fromkeys(kernels.LAUNCHES, 0)
    for arch in ("MobileNetV1", "M5"):
        server_err[arch] = 0.0
        for wire, sent in (("pcm16", [audio[i, : int(s * sr)] for i, s in
                                      enumerate(SERVER_SECONDS[:2])]),
                           ("mulaw", [audio[2, : int(MULAW_SECONDS * sr)]])):
            if arch == "M5":
                spool = DeviceWaveformStreamPool(m5, wcfg, slots=len(sent), device=DEVICE)
            else:
                spool = StreamPool(copy.deepcopy(logits), cfg, slots=len(sent),
                                   chunk_samples=chunk, halo=halo, mean=mean, std=std,
                                   device=DEVICE)
            warmup_pool(spool, wire)
            kernels.reset_launch_counts()
            server = StreamServer(spool, host="127.0.0.1", port=0, tick_interval=0.02,
                                  wire=wire)
            server.start()
            results = {}

            def client(i, y, server=server, wire=wire, results=results):
                try:
                    c = StreamClient(*server.address, classes_num=cfg.classes_num, wire=wire)
                    for pos in range(0, len(y), 20000):
                        c.send(y[pos: pos + 20000])
                    results[i] = c.finish()
                except Exception as e:  # noqa: BLE001 - reported below
                    results[i] = e

            try:
                threads = [threading.Thread(target=client, args=(i, y))
                           for i, y in enumerate(sent)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=300)
                    check(not t.is_alive(), f"{arch} {wire} client finished")
            finally:
                server.stop()
            torch.cuda.synchronize()
            count(kernels.LAUNCHES)
            for k, n in kernels.LAUNCHES.items():
                server_launches[k] += n
            for i, y in enumerate(sent):
                if isinstance(results[i], Exception):
                    raise results[i]
                y = mulaw_encode(y) if wire == "mulaw" else y
                ref = m5_offline(y) if arch == "M5" else score_all(torch, predict_mn, [y])[0]
                server_err[arch] = max(server_err[arch], max_err([results[i]], [ref],
                                                                 f"{arch} {wire} client"))
            del spool
    log(f"[serve] StreamServer: MobileNetV1 and M5 (device pool), each with 2 pcm16 clients "
        f"and 1 mulaw client: max diff vs offline MobileNetV1 {server_err['MobileNetV1']:.3e}, "
        f"M5 {server_err['M5']:.3e} (tol {SCORE_TOL}); launches {server_launches}")
    check(server_launches["frames_stft_power"] > 0 and server_launches["mel_log"] > 0,
          "K3 and K2 ran in the MobileNetV1 server")

    # ---- the CLIs' results -------------------------------------------------------
    chain_thread.join(timeout=900)
    check(not chain_thread.is_alive(), "the converter CLIs finished")
    if "error" in chain:
        raise chain["error"]
    cpu_sd = {a: {k: v.cpu() for k, v in m.state_dict().items()} for a, m in models.items()}
    conv_err = {}
    for arch in SERVE_ARCHS:
        pth = tmp / f"{arch}.pth"
        pt = tmp / f"imported_{arch}" / "checkpoints" / f"iteration_{SERVE_STEP}.pt"
        ref = torch.load(pth, map_location="cpu", weights_only=True)
        imported = torch.load(pt, map_location="cpu", weights_only=True)
        check(ref["iterations"] == imported["step"] == SERVE_STEP, f"{arch} step carried")
        for key, value in cpu_sd[arch].items():
            if key.endswith("num_batches_tracked"):
                check(int(imported["model"][key]) == 0, f"{arch} {key} exported as 0")
            elif key.startswith("bn0."):   # MobileNetV1's dead bn0: its initial values
                fill = 1.0 if key.endswith(("weight", "running_var")) else 0.0
                check(bool((imported["model"][key] == fill).all()), f"{arch} {key}")
            else:
                check(torch.equal(ref["model"][key], value)
                      and torch.equal(imported["model"][key], value),
                      f"{arch} {key} bit-equal after export and import")
        acfg = wcfg if arch == "M5" else cfg
        if arch == "M5":
            want = infer.predict_file_m5(models[arch], short, wcfg, device=DEVICE)
        else:
            _, want = infer.predict_file(models[arch], short, cfg, mean, std, device=DEVICE)
        conv_err[arch] = 0.0
        for path in (pth, pt):
            loaded, state = infer.load_model_and_state(str(path), acfg, arch=arch,
                                                       device=DEVICE)
            check(state.step == 0 and next(loaded.parameters()).device.type == dev.type,
                  f"{arch} {path.name} loaded on the card with a fresh state")
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            if arch == "M5":
                got = infer.predict_file_m5(loaded, short, wcfg, device=DEVICE)
            else:
                _, got = infer.predict_file(loaded, short, cfg, mean, std, device=DEVICE)
            torch.cuda.synchronize()
            launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
            count(kernels.LAUNCHES)
            want_launched = {} if arch == "M5" else {"wave_stft_power": 1, "mel_log": 1}
            check(launched == want_launched, f"{arch} {path.name}: launches {launched}")
            check(got.shape == want.shape, f"{arch} {path.name} scores shape {got.shape}")
            conv_err[arch] = max(conv_err[arch], float(np.abs(got - want).max()))
        cli_got = np.load(tmp / f"out_infer_{arch}" / "short_scores.npy")
        check(cli_got.shape == want.shape, f"cli.infer --arch {arch} shape {cli_got.shape}")
        conv_err[arch] = max(conv_err[arch], float(np.abs(cli_got - want).max()))
        check(conv_err[arch] <= SCORE_TOL, f"{arch}: converted files score as the original")
    log(f"[serve] export_torch -> import_torch on the card: every weight bit-equal, step "
        f"{SERVE_STEP} carried; the .pth and the imported .pt through load_model_and_state "
        f"(one K1 + one K2 a spectrogram file) and cli.infer --no_plot on the {FILE_SECONDS[1]:.0f} "
        f"s WAV: max diff vs the original weights " + ", ".join(
            f"{a} {e:.3e}" for a, e in conv_err.items()) + f" (tol {SCORE_TOL})")
    stream_err = {}
    for (arch, extra), (out, proc) in stream_runs.items():
        finish_cli(proc, out.with_suffix(".log"), f"cli.stream --arch {arch} {extra}")
        summary = json.loads(out.with_suffix(".log").read_text().strip().splitlines()[-1])
        for path in wavs:
            got = np.load(out / f"{path.stem}_scores.npy")
            y = wavfile.read(path)[1]
            want = m5_offline(y) if arch == "M5" else score_all(torch, predict_mn, [y])[0]
            stream_err[arch, extra] = max(stream_err.get((arch, extra), 0.0),
                                          max_err([got], [want], f"cli.stream {arch} {extra}"))
        launched = summary["kernel_launches"]
        if arch == "M5":
            check(sum(launched.values()) == 0, f"cli.stream --arch M5 {extra}: no launch")
        else:
            check(launched["frames_stft_power"] > 0 and launched["mel_log"] > 0,
                  "K3 and K2 ran in cli.stream --arch MobileNetV1")
    log(f"[serve] cli.stream on {len(wavs)} WAVs (2 slots, staggered): max diff vs offline "
        + ", ".join(f"{a} {' '.join(e) or '(halo 88)'} {v:.3e}" for (a, e), v in
                    stream_err.items()) + f" (tol {SCORE_TOL}); checks "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- timed: the pools' runs, ticks and memory, nothing beside them --------
    pool = StreamPool(copy.deepcopy(logits), cfg, slots=POOL_SLOTS, chunk_samples=chunk,
                      halo=halo, mean=mean, std=std, device=DEVICE)
    got, mn_wall, mn_launches, mn_peak, ticks = drive_pool(torch, dev, pool, clips, chunk,
                                                           seed=13)
    count(mn_launches)
    mn_err = max_err(got, [want_mn[i] for i in range(POOL_SLOTS)], "MobileNetV1 pool")
    check(mn_launches["frames_stft_power"] > 0 and mn_launches["mel_log"] > 0,
          "K3 and K2 ran on MobileNetV1's streaming path")
    check(mn_launches["frames_stft_power"] == mn_launches["mel_log"]
          and sum(mn_launches.values()) == 2 * mn_launches["mel_log"],
          "MobileNetV1's pool launches K3 and K2 only, in pairs")
    del pool
    m5_runs, blocks = {}, []
    for name, make in (("device", lambda: DeviceWaveformStreamPool(m5, wcfg, slots=POOL_SLOTS,
                                                                   device=DEVICE)),
                       ("host", lambda: WaveformStreamPool(m5, wcfg, slots=POOL_SLOTS,
                                                           device=DEVICE))):
        mpool = make()
        if name == "device":
            push_rounds = mpool._push_rounds
            mpool._push_rounds = lambda rounds: (blocks.append(len(rounds)),
                                                 push_rounds(rounds))[1]
        got, wall, launches, peak, _ = drive_pool(torch, dev, mpool, m5_clips, chunk, seed=14,
                                                  backlog=SERVE_BACKLOG)
        count(launches)
        check(sum(launches.values()) == 0, f"M5 {name} pool launches no K1-K10 kernel")
        m5_runs[name] = (got, wall, peak, max_err(got, want_m5, f"M5 {name} pool"))
        if name == "device":
            check(max(blocks) == DeviceWaveformStreamPool.ROUNDS_PER_CALL,
                  f"the backlog went in blocks of {DeviceWaveformStreamPool.ROUNDS_PER_CALL} "
                  f"rounds ({max(blocks)})")
        del mpool
    pools_err = max(float(np.abs(a - b).max())
                    for a, b in zip(m5_runs["device"][0], m5_runs["host"][0]))
    check(pools_err <= SCORE_TOL, "the M5 device and host pools agree")
    log(f"[serve] MobileNetV1 StreamPool (halo {halo}), {POOL_SLOTS} streams x {POOL_SECONDS} s "
        f"int16 as phase 5, {ticks} ticks: launches {mn_launches}; max diff vs "
        f"make_batch_predictor {mn_err:.3e} (tol {SCORE_TOL})")
    log(f"[serve] M5 DeviceWaveformStreamPool and WaveformStreamPool, {POOL_SLOTS} streams "
        f"(stream {SERVE_MULAW} mulaw, stream {SERVE_BACKLOG[0]}'s first piece "
        f"{SERVE_BACKLOG[1] // sr} s: blocks of up to {max(blocks)} rounds): no launch; max "
        f"diff vs offline framing device {m5_runs['device'][3]:.3e}, host "
        f"{m5_runs['host'][3]:.3e}; device vs host {pools_err:.3e} (tol {SCORE_TOL})")

    # Ticks at 32 slots: MobileNetV1's (K3 + K2 + the model) and M5's device
    # round, one 1 s chunk a slot, by CUDA events; each pool's tick with
    # its feeds by the host clock (the host pool's work is on the host).
    tpool = StreamPool(copy.deepcopy(logits), cfg, slots=POOL_SLOTS, chunk_samples=chunk,
                       halo=halo, mean=mean, std=std, device=DEVICE)
    tslots = [tpool.join() for _ in range(POOL_SLOTS)]
    for k in range(2):
        tpool.push({s: audio[s, k * chunk: (k + 1) * chunk] for s in tslots})
    check(len(tpool._admitted) == POOL_SLOTS, "every timing slot admitted")
    one = {s: audio[s, 2 * chunk: 3 * chunk] for s in tslots}
    mn_tick_ms = time_ms(torch, lambda: tpool._push_rounds([one]))
    mn_kernels = profile_ticks(torch, lambda: tpool._push_rounds([one]), n=5)
    dpool = DeviceWaveformStreamPool(m5, wcfg, slots=POOL_SLOTS, device=DEVICE)
    dslots = [dpool.join() for _ in range(POOL_SLOTS)]
    for k in range(2):
        dpool.push({s: audio[s, k * chunk: (k + 1) * chunk] for s in dslots})
    m5_tick_ms = time_ms(torch, lambda: dpool._push_rounds([one]))
    m5_kernels = profile_ticks(torch, lambda: dpool._push_rounds([one]), n=5)
    hpool = WaveformStreamPool(m5, wcfg, slots=POOL_SLOTS, device=DEVICE)
    hslots = [hpool.join() for _ in range(POOL_SLOTS)]

    def host_tick_ms(p, slots):
        times = []
        for rep in range(REPS + 3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for s in slots:
                p.feed(s, one[s])
            p.tick()
            torch.cuda.synchronize()
            if rep >= 3:
                times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    dev_tick_host_ms = host_tick_ms(dpool, dslots)
    host_tick_host_ms = host_tick_ms(hpool, hslots)
    del tpool, dpool, hpool

    audio_s = sum(len(c) for c in clips) / sr
    log(f"[times] phase 13 on {smi}; each line's card is this one:")
    log(f"[times] MobileNetV1 pool tick, one round of {POOL_SLOTS} slots (K3 + K2 + "
        f"MobileNetV1): {mn_tick_ms:.4f} ms (CUDA-event median of {REPS})")
    log(f"[times] M5 device pool round, {POOL_SLOTS} slots x 1 s ({POOL_SLOTS} x "
        f"{(chunk - 1) // wcfg.hop_size + 1} frames scored): {m5_tick_ms:.4f} ms (CUDA-event "
        f"median of {REPS})")
    log(f"[times] feed {POOL_SLOTS} x 1 s + tick(), host clock, median of {REPS}: M5 device "
        f"pool {dev_tick_host_ms:.4f} ms | M5 host pool {host_tick_host_ms:.4f} ms (host / "
        f"device {host_tick_host_ms / dev_tick_host_ms:.3f})")
    for what, rows, tick_ms in (("MobileNetV1 pool tick", mn_kernels, mn_tick_ms),
                                ("M5 device pool round", m5_kernels, m5_tick_ms)):
        if rows:
            busy = sum(ms for _, ms in rows)
            log(f"[times] {what} on the device (torch.profiler, 5 ticks): {busy:.4f} ms of "
                f"kernels a tick, {busy / tick_ms:.1%} of the {tick_ms:.4f} ms tick; the 8 "
                f"largest and the port's own:")
            for i, (kname, ms) in enumerate(rows):
                if i < 8 or any(k in kname for k in kernels.LAUNCHES):
                    log(f"[times]   {ms:.4f} ms  {kname[:90]}")
        else:
            log(f"[times] {what} on the device: torch.profiler captured no device time "
                f"(not measured)")
    for what, wall, peak in (("MobileNetV1 pool", mn_wall, mn_peak),
                             ("M5 device pool", m5_runs["device"][1], m5_runs["device"][2]),
                             ("M5 host pool", m5_runs["host"][1], m5_runs["host"][2])):
        log(f"[times] {what} run: {audio_s:.1f} audio-s in {wall:.3f} wall-s = "
            f"{audio_s / wall:.1f} audio-s per wall-s; peak device memory {peak:.1f} MiB")
    log(f"[serve] launches on phase 13's main path: {served}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return served


def profile_int_mm(torch, fn, n: int):
    """``torch.profiler`` over ``n`` calls of ``fn``: (device ms per call of
    every kernel, of those ``aten::_int_mm`` launched, the largest kernels
    [(name, ms per call), ...]); all empty when the profiler captured no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / n) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    int_mm = sum(e.device_time_total for e in prof.key_averages()
                 if e.key == "aten::_int_mm") / 1e3 / n
    return sum(ms for _, ms in rows), int_mm, sorted(rows, key=lambda r: -r[1])


def int8_phase(torch, cfg, dev, smi, tmp, model, mean, std):
    """Phase 14: int8 PTQ and QAT on the card (see the module docstring).
    ``model``, ``mean``, ``std``: phase 3's CnnAvgPooling and normalization.
    Returns the launch counts of the phase's main-path runs, summed."""
    from sed_tpu_torch.cli import infer
    from sed_tpu_torch.cli.stream import calibrate_int8
    from sed_tpu_torch.configs import WaveformConfig
    from sed_tpu_torch.inference import emits_scores
    from sed_tpu_torch.io.audio import read_multichannel_audio
    from sed_tpu_torch.models import quantize as q
    from sed_tpu_torch.models.qat import qat_cnn_forward, qat_export, qat_finetune, qat_init
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.ops import int8
    from sed_tpu_torch.ops.featurizer import logmel_features, logmel_features_batch
    from sed_tpu_torch.parallel.time_shard import windowed_forward
    from sed_tpu_torch.stream_pool import StreamPool
    from sed_tpu_torch.utils.precision import full_float32
    from sed_tpu_torch.waveform_streaming import DeviceWaveformStreamPool

    t0 = time.perf_counter()
    sr = chunk = cfg.working_sample_rate
    wcfg = WaveformConfig()
    launched = dict.fromkeys(kernels.LAUNCHES, 0)
    mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=dev)
    std_t = torch.as_tensor(np.asarray(std, np.float32), device=dev)

    def count(launches):
        for k, v in launches.items():
            launched[k] += v

    def normalized(feats):
        return (feats - mean_t) / std_t

    models = {}
    for i, arch in enumerate(SERVE_ARCHS):
        m = infer.build_model(arch, cfg.classes_num)
        m.reset_parameters(torch.Generator().manual_seed(50 + i))
        models[arch] = seed_batch_norms(torch, m, 60 + i)
        torch.save({"model": m.state_dict()}, tmp / f"{arch}.pth")
        m.to(dev)
    with open(tmp / "mean_std.pkl", "wb") as f:
        pickle.dump({"mean": mean, "std": std}, f)
    short = str(burst_wav(tmp / "short.wav", FILE_SECONDS[1], sr, 11))
    cli_runs = {}
    for arch in SERVE_ARCHS:
        out = tmp / f"out_infer_{arch}"
        spec = ["--mean_std_file", tmp / "mean_std.pkl"] if arch != "M5" else []
        cli_runs[arch] = (out, start_cli(
            ["sed_tpu_torch.cli.infer", "--no_plot", "--quantize", "int8", "--arch", arch,
             "--ckpt", tmp / f"{arch}.pth", *spec, "--device", DEVICE, "--outputs_dir", out,
             short], out.with_suffix(".log")))

    # ---- the int8 products against their plain version ----------------------
    g = torch.Generator().manual_seed(14)

    def rand_int8(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)

    for m, k, n in INT8_SHAPES:
        a, b = rand_int8(m, k), rand_int8(k, n)
        got = int8.int8_matmul(a.to(dev), b.to(dev))
        check(torch.equal(got.cpu(), int8.int8_matmul_plain(a, b)),
              f"int8_matmul ({m}, {k}) @ ({k}, {n}) equals the plain version")
    convs = [("2d", (2, 182, 64, 1), (32, 1, 3, 3), 1), ("2d", (2, 91, 32, 32), (64, 32, 3, 3), 1),
             ("2d", (2, 23, 8, 1024), (1024, 1024, 1, 1), 0),
             ("1d", (2, wcfg.frame_size, 1), (64, 1, 79), (4, 39)),
             ("1d", (2, 1980, 64), (64, 64, 3), (1, 1))]
    for kind, xs, ws, pad in convs:
        x, w = rand_int8(*xs), rand_int8(*ws)
        run = ((lambda x, w, pad=pad: int8.int8_conv2d_nhwc(x, w, pad)) if kind == "2d"
               else (lambda x, w, pad=pad: int8.int8_conv1d_nwc(x, w, *pad)))
        check(torch.equal(run(x.to(dev), w.to(dev)).cpu(), run(x, w)),
              f"int8 conv{kind} {xs} x {ws} equals the plain version")
    log(f"[int8] int8_matmul at {len(INT8_SHAPES)} shapes (rows 1-16, K 9/79/288/1152, N "
        f"1/11/64) and {len(convs)} convolutions (CnnAvgPooling's first two, MobileNetV1's "
        f"widest pointwise, M5's stem and a 3-tap) equal their plain versions exactly")

    # ---- the per-file path with --quantize int8 -------------------------------
    wav = read_multichannel_audio(short, target_fs=sr, cfg=cfg).astype(np.float32)
    in_process, lines = {}, []
    for arch in ("CnnAvgPooling", "MobileNetV1"):
        net = models[arch]
        halo = infer.halo_floor(net, FILE_HALO, log=lambda msg: None)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        int8.reset_launch_counts()
        _, got = infer.predict_file(net, short, cfg, mean, std, FILE_WINDOW, FILE_HALO,
                                    quantize="int8", device=DEVICE)
        torch.cuda.synchronize()
        launches, int_mm = dict(kernels.LAUNCHES), int8.LAUNCHES["int_mm"]
        count(launches)
        check(launches["wave_stft_power"] == 1 and launches["mel_log"] == 1
              and sum(launches.values()) == 2, f"{arch} int8 file: one K1 and one K2 ({launches})")
        check(int_mm > 0, f"{arch} int8 file reached _int_mm")
        _, flt = infer.predict_file(net, short, cfg, mean, std, FILE_WINDOW, FILE_HALO,
                                    device=DEVICE)
        # The same artifact on the card and on the CPU.
        with torch.inference_mode(), full_float32():
            x = normalized(logmel_features(torch.from_numpy(wav).to(dev), cfg))[None]
            qp, fwd = q.quantize_model(net, [x[:, :, ::max(1, x.shape[2] // 2048)]])
            qp_cpu = q.qparams_to(qp, "cpu")
            act = (lambda v: v) if emits_scores(net) else torch.sigmoid
            card = act(windowed_forward(lambda b: fwd(qp, b), x, FILE_WINDOW, halo)[0])
            cpu = act(windowed_forward(lambda b: fwd(qp_cpu, b), x.cpu(), FILE_WINDOW, halo)[0])
        card, cpu = card.cpu().numpy(), cpu.numpy()
        check(got.shape == flt.shape == card.shape == cpu.shape and np.isfinite(got).all(),
              f"{arch} int8 file scores {got.shape}")
        entry_err = float(np.abs(got - card).max())
        cpu_err = float(np.abs(card - cpu).max())
        dev_f = float(np.abs(got - flt).max())
        corr = float(np.corrcoef(got.ravel(), flt.ravel())[0, 1])
        check(entry_err <= INT8_BAND, f"{arch} predict_file int8 equals its own artifact's")
        check(cpu_err <= INT8_BAND, f"{arch} card int8 within {INT8_BAND} of the CPU's")
        in_process[arch] = got
        lines.append(f"{arch}: launches {launches} + {int_mm} _int_mm; predict_file vs the "
                     f"artifact's windowed forward {entry_err:.3e}, card vs CPU on one "
                     f"artifact {cpu_err:.3e} (tol {INT8_BAND}); int8 vs float32 max "
                     f"{dev_f:.3e}, corr {corr:.6f}")
    m5 = models["M5"]
    kernels.reset_launch_counts()
    int8.reset_launch_counts()
    got = infer.predict_file_m5(m5, short, wcfg, quantize="int8", device=DEVICE)
    torch.cuda.synchronize()
    launches, int_mm = dict(kernels.LAUNCHES), int8.LAUNCHES["int_mm"]
    count(launches)
    check(sum(launches.values()) == 0 and int_mm > 0,
          f"M5 int8 file: no K1-K10 launch, _int_mm reached ({launches}, {int_mm})")
    flt = infer.predict_file_m5(m5, short, wcfg, device=DEVICE)
    frames = infer.hop_frames(torch.from_numpy(wav).to(dev), wcfg)
    qp = q.quantize_m5(m5, [frames[::max(1, frames.shape[0] // 256)]])
    card = torch.cat([torch.sigmoid(q.quantized_m5_forward(qp, frames[i:i + 32]))
                      for i in range(0, frames.shape[0], 32)]).cpu().numpy()
    cpu = torch.sigmoid(q.quantized_m5_forward(q.qparams_to(qp, "cpu"),
                                               frames[:M5_CPU_FRAMES].cpu())).numpy()
    entry_err = float(np.abs(got - card).max())
    cpu_err = float(np.abs(card[:M5_CPU_FRAMES] - cpu).max())
    dev_f = float(np.abs(got - flt).max())
    corr = float(np.corrcoef(got.ravel(), flt.ravel())[0, 1])
    check(got.shape == flt.shape == card.shape and np.isfinite(got).all(),
          f"M5 int8 file scores {got.shape}")
    check(entry_err <= INT8_BAND and cpu_err <= INT8_BAND, "M5 int8 file: entry and CPU")
    in_process["M5"] = got
    lines.append(f"M5: launches {launches} + {int_mm} _int_mm; predict_file_m5 vs the "
                 f"artifact's forward {entry_err:.3e}, card vs CPU on one artifact "
                 f"({M5_CPU_FRAMES} frames) {cpu_err:.3e}; int8 vs float32 max {dev_f:.3e}, "
                 f"corr {corr:.6f}")
    for line in lines:
        log(f"[int8] {FILE_SECONDS[1]:.0f} s file, {line}")
    del frames

    # ---- int8 StreamPool (CnnAvgPooling) on phase 5's run ----------------------
    audio = (make_signals(torch, POOL_SLOTS, sr * POOL_SECONDS, sr, dev, 2) * 32767
             ).round().to(torch.int16).cpu().numpy()
    clips = [audio[i] for i in range(POOL_SLOTS)]
    clips[EARLY_LEAVER] = clips[EARLY_LEAVER][: int(EARLY_SECONDS * sr)]
    qp_pool = calibrate_int8(model, "CnnAvgPooling", cfg, clips[0].astype(np.float32) / 32768.0,
                             mean, std)
    pool = StreamPool(model, cfg, slots=POOL_SLOTS, chunk_samples=chunk, mean=mean, std=std,
                      qparams=qp_pool, device=DEVICE)
    int8.reset_launch_counts()
    got_pool, pool_wall, pool_launches, pool_peak, ticks = drive_pool(
        torch, dev, pool, clips, chunk, seed=2)
    pool_int_mm = int8.LAUNCHES["int_mm"]
    count(pool_launches)
    check(pool_launches["frames_stft_power"] > 0 and pool_launches["mel_log"] > 0
          and pool_int_mm > 0, f"K3, K2 and _int_mm ran in the int8 pool ({pool_launches})")
    pool_err = 0.0
    with torch.inference_mode(), full_float32():
        for i, clip in enumerate(clips):
            x = normalized(logmel_features_batch(torch.from_numpy(clip).to(dev)[None, :, None],
                                                 cfg))
            want = q.quantized_scores(qp_pool, x)[0].cpu().numpy()
            check(got_pool[i].shape == want.shape,
                  f"int8 stream {i}: {got_pool[i].shape} != offline {want.shape}")
            pool_err = max(pool_err, float(np.abs(got_pool[i] - want).max()))
    check(pool_err <= INT8_BAND, "int8 pool within 5e-3 of offline int8 scoring")
    pool_audio_s = sum(len(c) for c in clips) / sr
    log(f"[int8] StreamPool int8 (CnnAvgPooling, calibrated on stream 0): {POOL_SLOTS} "
        f"streams, {ticks} ticks; launches {pool_launches} + {pool_int_mm} _int_mm; max diff "
        f"vs offline int8 {pool_err:.3e} (tol {INT8_BAND}); {pool_audio_s / pool_wall:.1f} "
        f"audio-s per wall-s; peak {pool_peak:.1f} MiB")
    del pool

    # ---- int8 DeviceWaveformStreamPool (M5) on phase 13's run --------------------
    audio13 = (make_signals(torch, POOL_SLOTS, sr * POOL_SECONDS, sr, dev, 13) * 32767
               ).round().to(torch.int16).cpu().numpy()
    m5_clips = [audio13[i] for i in range(POOL_SLOTS)]
    m5_clips[EARLY_LEAVER] = m5_clips[EARLY_LEAVER][: int(EARLY_SECONDS * sr)]
    qp_m5 = calibrate_int8(m5, "M5", wcfg, m5_clips[0].astype(np.float32) / 32768.0)
    m5_pool = DeviceWaveformStreamPool(m5, wcfg, slots=POOL_SLOTS, qparams=qp_m5, device=DEVICE)
    got_m5, m5_wall, m5_launches, m5_peak, m5_ticks = drive_pool(
        torch, dev, m5_pool, m5_clips, chunk, seed=13)
    count(m5_launches)
    check(sum(m5_launches.values()) == 0, f"no K1-K10 launch in the M5 int8 pool ({m5_launches})")
    m5_err = 0.0
    for i, clip in enumerate(m5_clips):
        fr = infer.hop_frames(torch.from_numpy(clip.astype(np.float32) / 32768.0)
                              .to(dev)[:, None], wcfg)
        want = torch.cat([torch.sigmoid(q.quantized_m5_forward(qp_m5, fr[j:j + 32]))
                          for j in range(0, fr.shape[0], 32)]).cpu().numpy()
        check(got_m5[i].shape == want.shape, f"M5 int8 stream {i}: {got_m5[i].shape}")
        m5_err = max(m5_err, float(np.abs(got_m5[i] - want).max()))
    check(m5_err <= M5_INT8_TOL, f"M5 int8 pool within {M5_INT8_TOL} of offline int8")
    m5_audio_s = sum(len(c) for c in m5_clips) / sr
    log(f"[int8] DeviceWaveformStreamPool int8 (M5): {m5_ticks} ticks, launches {m5_launches}; "
        f"max diff vs offline int8 {m5_err:.3e} (tol {M5_INT8_TOL}); "
        f"{m5_audio_s / m5_wall:.1f} audio-s per wall-s; peak {m5_peak:.1f} MiB")
    del m5_pool, audio13, m5_clips

    # ---- the CLI runs against the in-process int8 scores ------------------------
    cli_err = 0.0
    for arch, (out, proc) in cli_runs.items():
        finish_cli(proc, out.with_suffix(".log"), f"cli.infer --quantize int8 --arch {arch}")
        got = np.load(out / "short_scores.npy")
        check(got.shape == in_process[arch].shape, f"cli.infer int8 {arch} shape")
        cli_err = max(cli_err, float(np.abs(got - in_process[arch]).max()))
    check(cli_err <= INT8_BAND, "cli.infer --quantize int8 within 5e-3 of in-process int8")
    log(f"[int8] python -m sed_tpu_torch.cli.infer --quantize int8 for the three archs: max "
        f"diff vs in-process int8 {cli_err:.3e} (tol {INT8_BAND})")

    # ---- QAT on the card ---------------------------------------------------------
    # Full width: the served CnnAvgPooling (seeded BatchNorm statistics, so
    # its folded biases are not 0) on 2 x 16 x crop frames of the pool's
    # log-mel, the float model's logits as targets.
    with torch.inference_mode(), full_float32():
        feats = normalized(logmel_features_batch(
            torch.from_numpy(audio[:BATCH]).to(dev)[..., None], cfg))      # (16, 1, 182, 64)
    crop = cfg.train_crop_size
    qat_xs = [feats[:, :, :crop].clone(), feats[:, :, -crop:].clone()]
    served = models["CnnAvgPooling"]

    def qat_state(net):
        with torch.no_grad(), full_float32():
            teachers = [net.eval()(x) for x in qat_xs]
        tr, st = qat_init(net, qat_xs)
        return teachers, tr, st, [(x.cpu().numpy(), t.cpu().numpy())
                                  for x, t in zip(qat_xs, teachers)]

    def tree64(tr):
        tr = q.qparams_to(tr, "cpu")
        return {"blocks": [{k: [t.double() for t in v] for k, v in b.items()}
                           for b in tr["blocks"]],
                "dense": {k: v.double() for k, v in tr["dense"].items()}}

    def ex64(ex):
        return [(x.astype(np.float64), t.astype(np.float64)) for x, t in ex]

    def max_dev(teachers, tr, st):
        exported = qat_export(tr, st)
        return max(float((q.quantized_scores(exported, x) - torch.sigmoid(t)).abs().max())
                   for x, t in zip(qat_xs, teachers))

    def qat_losses(tr, st, ex):
        """The loss after k = 0..CPU_STEPS-1 steps on the k-th example, on the
        card and on the CPU from one state, and their largest relative
        difference."""
        losses = {}
        for where in (DEVICE, "cpu"):
            st_w = q.qparams_to(st, where)
            losses[where] = []
            for k in range(CPU_STEPS):
                x, t = ex[k % 2]
                tuned = qat_finetune(tr, st, ex, mode="distill", steps=k, lr=QAT_LR,
                                     device=where)
                with torch.no_grad(), full_float32():
                    logits = qat_cnn_forward(tuned, st_w, torch.from_numpy(x).to(where))
                    losses[where].append(float(((logits - torch.from_numpy(t).to(where)) ** 2)
                                               .mean()))
        return losses, max(abs(a - b) / abs(b) for a, b in zip(losses[DEVICE], losses["cpu"]))

    def first_grads(tr, st, x, t, where):
        leaves = []

        def leaf(v):
            leaves.append(v.detach().to(where).clone().requires_grad_(True))
            return leaves[-1]
        tr = {"blocks": [{k: [leaf(v) for v in vs] for k, vs in b.items()} for b in tr["blocks"]],
              "dense": {k: leaf(v) for k, v in tr["dense"].items()}}
        with full_float32():
            loss = ((qat_cnn_forward(tr, q.qparams_to(st, where), torch.from_numpy(x).to(where))
                     - torch.from_numpy(t).to(where)) ** 2).mean()
            loss.backward()
        return [v.grad.cpu() for v in leaves]

    def grad_rel(a, b):
        return max(float((u - v).abs().max() / v.abs().max()) for u, v in zip(a, b))

    teachers, tr, st, ex = qat_state(served)
    losses64, rel64 = qat_losses(tree64(tr), st, ex64(ex))
    losses32, rel32 = qat_losses(tr, st, ex)
    torch.cuda.synchronize()
    t_qat = time.perf_counter()
    tuned = qat_finetune(tr, st, ex, mode="distill", steps=QAT_STEPS, lr=QAT_LR, device=DEVICE)
    torch.cuda.synchronize()
    qat_s = time.perf_counter() - t_qat
    dev_before, dev_after = max_dev(teachers, tr, st), max_dev(teachers, tuned, st)
    log(f"[int8] QAT at full width (served CnnAvgPooling, 2 x {BATCH} x {crop} frames), "
        f"{QAT_STEPS} float32 distill steps at lr {QAT_LR} on the card: {qat_s:.3f} s; max int8 "
        f"deviation {dev_before:.4e} -> {dev_after:.4e}")
    log(f"[int8] QAT first {CPU_STEPS} losses, card vs CPU from one state: float64 card "
        f"{[f'{v:.12e}' for v in losses64[DEVICE]]} CPU {[f'{v:.12e}' for v in losses64['cpu']]}"
        f" max relative diff {rel64:.3e}; float32 card {[f'{v:.6e}' for v in losses32[DEVICE]]}"
        f" CPU {[f'{v:.6e}' for v in losses32['cpu']]} max relative diff {rel32:.3e} "
        f"(float64 held to {TRAIN_REL_TOL}; float32 reported: its summation orders flip "
        f"fake-quant roundings)")
    check(dev_after < dev_before, "QAT lowers the int8 deviation at full width")
    check(rel64 <= TRAIN_REL_TOL, "QAT float64 losses on the card follow the CPU's")

    # Phase 3's model has BatchNorm at its initial statistics, so every folded
    # bias is exactly 0: a ReLU input that is an exactly cancelled lattice sum
    # (an int32 dot product of 0 in the int8 forward) is then 0 or a rounding
    # residue of either sign, which sets its gradient to 1/2, 1 or 0 by the
    # summation order.  Reported: the float64 first-step gradients card vs
    # CPU and the CPU against itself with the activation scales one ulp up,
    # with the biases at 0 and moved 1e-6 off it, and the largest weights'
    # w/scale (the clip's bound) and gradients; held: with the biases moved
    # the card's gradients follow the CPU's.
    _, tr3, st3, ex3 = qat_state(model)
    x3, t3 = ex64(ex3)[0]
    w64 = tree64(tr3)
    zero_bias = sum(int((v == 0).sum()) for b in w64["blocks"] for v in b["b"])
    n_bias = sum(v.numel() for b in w64["blocks"] for v in b["b"])
    g_card, g_cpu = first_grads(w64, st3, x3, t3, DEVICE), first_grads(w64, st3, x3, t3, "cpu")

    # The activation scales one float64 ulp up: every fake-quant activation
    # keeps its integer and moves by about an ulp, the weights' lattice and
    # its clip stay as they were.
    inf = torch.tensor(float("inf"), dtype=torch.float64)
    st_ulp = dict(st3, act_scales=[torch.nextafter(s.double().cpu(), inf)
                                   for s in st3["act_scales"]])
    g_ulp = first_grads(w64, st_ulp, x3, t3, "cpu")
    moved = {"blocks": [dict(b, b=[v + 1e-6 for v in b["b"]]) for b in w64["blocks"]],
             "dense": w64["dense"]}
    g_moved = first_grads(moved, st3, x3, t3, "cpu")
    moved_rel = grad_rel(first_grads(moved, st3, x3, t3, DEVICE), g_moved)
    moved_ulp_rel = grad_rel(first_grads(moved, st_ulp, x3, t3, "cpu"), g_moved)
    weights = [w for b in w64["blocks"] for w in b["w"]] + [w64["dense"]["w"]]
    leaf_names = [k for b in w64["blocks"] for k in b for _ in b[k]] + list(w64["dense"])
    w_grads = {"card": [g for g, n in zip(g_card, leaf_names) if n == "w"],
               "cpu": [g for g, n in zip(g_cpu, leaf_names) if n == "w"]}
    bound_q, bound_g = [], {"card": 0.0, "cpu": 0.0}
    for i, w in enumerate(weights):
        flat = w.flatten(1)
        top = flat.abs().argmax(1, keepdim=True)
        scale = flat.abs().amax(1) * (1.0 / 127.0)
        bound_q.append(flat.abs().gather(1, top).squeeze(1) / scale)
        for where in bound_g:
            g = w_grads[where][i].flatten(1).gather(1, top)
            bound_g[where] = max(bound_g[where], float(g.abs().max()))
    bound_q = torch.cat(bound_q)
    log(f"[int8] QAT, phase 3's model (BatchNorm at its initial statistics: {zero_bias} of "
        f"{n_bias} folded biases exactly 0), float64 first-step gradients: card vs CPU "
        f"{grad_rel(g_card, g_cpu):.3e}, CPU vs CPU with the activation scales one ulp up "
        f"{grad_rel(g_ulp, g_cpu):.3e} (x the largest |grad| of each tensor); with the biases "
        f"moved 1e-6: card vs CPU {moved_rel:.3e}, CPU vs CPU with the scales one ulp up "
        f"{moved_ulp_rel:.3e}; each channel's largest weight at w/scale "
        f"{float(bound_q.min()):.17g} to {float(bound_q.max()):.17g} (the clip's bound is 127), "
        f"its gradient at most {bound_g['card']:.3e} (card) / {bound_g['cpu']:.3e} (CPU)")
    check(moved_rel <= 1e-10, "QAT gradients off the ReLU ties: the card follows the CPU")

    # ---- times ------------------------------------------------------------------
    mob = models["MobileNetV1"]
    block = infer.hop_frames(torch.from_numpy(audio[0].astype(np.float32) / 32768.0)
                             .to(dev)[:, None], wcfg)[:M5_BLOCK].contiguous()
    with torch.inference_mode():
        arts = {"CnnAvgPooling": (model, feats), "MobileNetV1": (mob, feats), "M5": (m5, block)}
        times = {}
        for arch, (net, x) in arts.items():
            qp, fwd = q.quantize_model(net, [x])
            float_ms = time_ms(torch, lambda net=net, x=x: net(x))
            int8_ms = time_ms(torch, lambda qp=qp, fwd=fwd, x=x: fwd(qp, x))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            fwd(qp, x)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
            busy, mm, top = profile_int_mm(torch, lambda qp=qp, fwd=fwd, x=x: fwd(qp, x), 5)
            times[arch] = (float_ms, int8_ms, peak, busy, mm, top)
    # The 32-slot tick, float and int8.
    tick = {}
    for tag, qparams in (("float32", None), ("int8", qp_pool)):
        tpool = StreamPool(model, cfg, slots=POOL_SLOTS, chunk_samples=chunk, mean=mean,
                           std=std, qparams=qparams, device=DEVICE)
        slots = [tpool.join() for _ in range(POOL_SLOTS)]
        for k in range(2):
            tpool.push({s: audio[s, k * chunk: (k + 1) * chunk] for s in slots})
        one = {s: audio[s, 2 * chunk: 3 * chunk] for s in slots}
        tick[tag] = time_ms(torch, lambda tpool=tpool, one=one: tpool._push_rounds([one]))
        del tpool
    log(f"[times] {smi}; int8 against float32, CUDA-event medians of {REPS}:")
    for arch, (float_ms, int8_ms, peak, busy, mm, top) in times.items():
        shape = (f"a block of {M5_BLOCK} frames" if arch == "M5"
                 else f"{BATCH} x {SECONDS} s, {feats.shape[2]} frames")
        share = (f"_int_mm {mm:.4f} ms of {busy:.4f} ms of kernels ({mm / busy:.1%})"
                 if busy > 0 else "torch.profiler captured no device time (not measured)")
        log(f"[times] {arch} forward ({shape}): float32 {float_ms:.4f} ms | int8 "
            f"{int8_ms:.4f} ms ({int8_ms / float_ms:.2f}x); {share}; int8 peak above its "
            f"inputs {peak:.1f} MiB")
        for name, ms in top[:4]:
            log(f"[times]   {ms:.4f} ms  {name[:90]}")
    log(f"[times] {POOL_SLOTS}-slot tick (one round): float32 {tick['float32']:.4f} ms | int8 "
        f"{tick['int8']:.4f} ms ({tick['int8'] / tick['float32']:.2f}x)")
    log(f"[int8] {time.perf_counter() - t0:.1f} s")
    return launched


def start_fresh_run(tmp, artifact, wavs, copy, env, tag):
    """Start ``cli.serve run`` in a fresh process on the package copy
    ``copy``; ``finish_fresh_run`` waits for it."""
    out = tmp / f"fresh_{tag}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "sed_tpu_torch.cli.serve", "run", "--artifact", str(artifact),
         *map(str, wavs), "--outputs_dir", str(out), "--event_threshold", "0.5",
         "--device", DEVICE], cwd=copy, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    _cli_runs.append(proc)
    return proc, time.perf_counter(), out, tag


def finish_fresh_run(run):
    """(the run's JSON line, its load stages line, wall seconds, outputs dir)."""
    proc, t0, out, tag = run
    stdout, stderr = proc.communicate(timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(stdout[-4000:], stderr[-4000:], file=sys.stderr)
    check(proc.returncode == 0, f"fresh cli.serve run ({tag}) exit code {proc.returncode}")
    stages = [ln for ln in stderr.splitlines() if ln.startswith("load stages")]
    return json.loads(stdout.strip().splitlines()[-1]), stages[-1], wall, out


def aot_phase(torch, cfg, dev, smi, tmp, model, mean, std, nvcc_s):
    """Phase 15: AOT serving artifacts (see the module docstring).
    ``model``, ``mean``, ``std``: phase 3's CnnAvgPooling and normalization;
    ``nvcc_s``: phase 1's build seconds.  Returns the launch counts of the
    artifacts' calls on the batch, summed."""
    import os
    import shutil

    from scipy.io import wavfile

    from sed_tpu_torch import export as ex
    from sed_tpu_torch.cli import infer, serve
    from sed_tpu_torch.configs import WaveformConfig
    from sed_tpu_torch.inference import make_batch_predictor
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.ops.featurizer import logmel_features_batch
    from sed_tpu_torch.utils.precision import full_float32

    t0 = time.perf_counter()
    sr = cfg.working_sample_rate
    samples = sr * SECONDS
    wcfg = WaveformConfig()
    ckpts = {"CnnAvgPooling": tmp / "CnnAvgPooling.pth"}
    torch.save({"model": model.state_dict()}, ckpts["CnnAvgPooling"])
    for i, arch in enumerate(("MobileNetV1", "M5")):
        m = infer.build_model(arch, cfg.classes_num)
        m.reset_parameters(torch.Generator().manual_seed(70 + i))
        seed_batch_norms(torch, m, 80 + i)
        ckpts[arch] = tmp / f"{arch}.pth"
        torch.save({"model": m.state_dict()}, ckpts[arch])
    with open(tmp / "mean_std.pkl", "wb") as f:
        pickle.dump({"mean": mean, "std": std}, f)
    pcm = (make_signals(torch, BATCH, samples, sr, dev, 15) * 32767).round() \
        .to(torch.int16)[..., None]
    pcm_np = pcm.cpu().numpy()
    calib = tmp / "calib.wav"
    wavfile.write(calib, sr, pcm_np[1, :, 0])
    # The fresh process's files: clip 0 whole, clip 1's first three quarters.
    cut = 3 * samples // 4
    run_wavs = [tmp / "serve0.wav", tmp / "serve1.wav"]
    wavfile.write(run_wavs[0], sr, pcm_np[0, :, 0])
    wavfile.write(run_wavs[1], sr, pcm_np[1, :cut, 0])

    def build_argv(arch, flags, out):
        flags = [str(calib) if f == "CALIB" else f for f in flags]
        spec = ["--mean_std_file", str(tmp / "mean_std.pkl")] if arch != "M5" else []
        return ["build", "--ckpt", str(ckpts[arch]), "--arch", arch, "--batch", str(BATCH),
                "--seconds", str(SECONDS), "--out", str(out), *spec, *flags,
                "--device", DEVICE]

    # ---- the builds, side by side; the same heads built here meanwhile ---------
    t_build = time.perf_counter()
    procs = {tag: start_cli(["sed_tpu_torch.cli.serve", *build_argv(arch, flags,
                                                                     tmp / f"{tag}.aot")],
                            tmp / f"{tag}.log") for tag, arch, flags in AOT_BUILDS}
    heads = {tag: serve.build_head(serve.build_arg_parser().parse_args(
        build_argv(arch, flags, tmp / "x.aot")), dev)[0].to(dev)
        for tag, arch, flags in AOT_BUILDS}
    built = {}
    for tag, proc in procs.items():
        finish_cli(proc, tmp / f"{tag}.log", f"cli.serve build {tag}")
        lines = [ln for ln in (tmp / f"{tag}.log").read_text().splitlines()
                 if ln.startswith("{")]
        built[tag] = json.loads(lines[-1])
    builds_wall = time.perf_counter() - t_build

    # ---- a fresh process on a copy of the package with no _build/ -------------
    copy = tmp / "fresh"
    shutil.copytree(REPO / "sed_tpu_torch", copy / "sed_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    fake = tmp / "cuda_home" / "bin"
    fake.mkdir(parents=True)
    marker = tmp / "nvcc_ran"
    (fake / "nvcc").write_text(f"#!/bin/sh\ntouch {marker}\nexit 1\n")
    (fake / "nvcc").chmod(0o755)
    env = dict(os.environ, PYTHONPATH=str(copy), CUDA_HOME=str(tmp / "cuda_home"))
    lib = copy / "sed_tpu_torch" / "ops" / "_build" / kernels.library_path().name
    check(not lib.exists(), "the copy starts with no kernel library")
    # The cold run alone; the warm one beside this process's checks below.
    fresh = {"cold": finish_fresh_run(start_fresh_run(tmp, tmp / "cnn_f32.aot", run_wavs,
                                                      copy, env, "cold"))}
    check(lib.is_file(), "the cold run installed the kernel library in the copy's _build/")
    warm = start_fresh_run(tmp, tmp / "cnn_f32.aot", run_wavs, copy, env, "warm")
    # What a fresh process pays to import torch, then torch.export's
    # deserializer (which brings torch._dynamo): the loader's "program" stage
    # holds the second when nothing imported it before.
    probe = subprocess.Popen(
        [sys.executable, "-c", "import time; t0 = time.perf_counter(); import torch; "
         "t1 = time.perf_counter(); import torch._export.serde.serialize; "
         "print(f'{t1 - t0:.3f} {time.perf_counter() - t1:.3f}')"],
        stdout=subprocess.PIPE, text=True)
    _cli_runs.append(probe)

    # ---- each artifact in this process against the eager path -----------------
    predict = make_batch_predictor(model, cfg, mean=mean, std=std, device=DEVICE)
    with torch.inference_mode():
        feats = logmel_features_batch(pcm, cfg)
        main_eager = predict(pcm)

    def m5_windows(x):
        return torch.cat([infer.hop_frames(x[b].float() / 32768.0, wcfg)
                          for b in range(x.shape[0])])

    launched = dict.fromkeys(kernels.LAUNCHES, 0)
    got_scores, rows, calls, eager_fns = {}, [], {}, {}
    for tag, arch, flags in AOT_BUILDS:
        call = ex.load_aot_fn((tmp / f"{tag}.aot").read_bytes())
        spectrogram = arch != "M5"
        check(call.header["device_type"] == dev.type
              and call.header["custom_ops"] == (["mel_log", "wave_stft_power"]
                                                if spectrogram else []),
              f"{tag}: a {dev.type} program holding {call.header['custom_ops']}")
        check((call.header["kernel_library"] is not None) == spectrogram,
              f"{tag}: carries the kernel library exactly when it holds K1 and K2")
        head = heads.pop(tag)
        shipped = {k.removeprefix("head."): v for k, v in call.module.state_dict().items()
                   if k.startswith("head.")}
        same_weights = all(torch.equal(v, shipped[k]) for k, v in head.state_dict().items())
        head.load_state_dict(shipped)   # the artifact's own (QAT trains per process)
        head.eval()
        with torch.inference_mode(), full_float32():
            if spectrogram:
                eager_fn = lambda head=head: head(logmel_features_batch(pcm, cfg))  # noqa: E731
            else:
                eager_fn = lambda head=head: head(m5_windows(pcm)).reshape(  # noqa: E731
                    BATCH, -1, cfg.classes_num)
            eager = eager_fn()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = call(pcm)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        for k, v in launches.items():
            launched[k] += v
        want_launches = ({"wave_stft_power": 1, "mel_log": 1} if spectrogram else {})
        check({k: v for k, v in launches.items() if v} == want_launches,
              f"{tag}: one call launched {launches}")
        check(got.shape == eager.shape and bool(torch.isfinite(got).all())
              and got.dtype == torch.float32, f"{tag}: finite float32 scores {tuple(got.shape)}")
        err = float((got - eager).abs().max())
        if "int8" in tag or "qat" in tag:
            check(torch.equal(got, eager), f"{tag}: equal to the eager int8 forward ({err:.3e})")
        else:
            check(err <= AOT_TOL, f"{tag}: within {AOT_TOL} of the eager forward ({err:.3e})")
        got_scores[tag], calls[tag], eager_fns[tag] = got, call, eager_fn
        rows.append((tag, built[tag], err, same_weights, launches, call.load_timings))
        del eager
    fresh["warm"] = finish_fresh_run(warm)
    import_s = probe.communicate(timeout=300)[0].split()
    check(probe.returncode == 0 and len(import_s) == 2, "the import probe ran")
    check(not marker.exists(), "nvcc did not run in either fresh process")
    # Alone on the card again.  M5's batch is device-bound (58 and 166 ms of
    # kernels), so 5 groups time it as well as 20 and save ~8 s.
    times = {}
    for tag, call in calls.items():
        reps = AOT_M5_REPS if tag.startswith("m5") else REPS
        with torch.inference_mode(), full_float32():
            times[tag] = (time_ms(torch, lambda call=call: call(pcm), reps=reps, warmup=1),
                          time_ms(torch, eager_fns[tag], reps=reps, warmup=1))
    main_err = float((got_scores["cnn_f32"] - main_eager).abs().max())
    check(main_err <= AOT_TOL, f"cnn_f32 within {AOT_TOL} of make_batch_predictor "
                               f"({main_err:.3e})")
    bf16_dev = float((got_scores["cnn_bf16"] - got_scores["cnn_f32"]).abs().max())
    check(bf16_dev <= BF16_BAND, f"bf16 within {BF16_BAND} of float32 ({bf16_dev:.3e})")

    # The fresh process's scores against this process's artifact scores.
    fresh_err = 0.0
    for tag, (_, _, _, out) in fresh.items():
        for i, (row, n) in enumerate(((0, samples), (1, cut))):
            got = np.load(out / f"serve{i}_scores.npy")
            n_frames = min(got_scores["cnn_f32"].shape[1], 1 + n // cfg.hop_size)
            want = got_scores["cnn_f32"][row, :n_frames].cpu().numpy()
            check(got.shape == want.shape, f"fresh {tag} serve{i}: {got.shape} != {want.shape}")
            if i == 0:   # a zero-padded tail changes the last frames' context
                fresh_err = max(fresh_err, float(np.abs(got - want).max()))
    check(fresh_err <= AOT_TOL, f"the fresh process's scores within {AOT_TOL} ({fresh_err:.3e})")

    # ---- bf16 against float32 forwards --------------------------------------------
    bf16_rows = []
    norm = (feats - torch.as_tensor(mean, device=dev)) / torch.as_tensor(std, device=dev)
    block = m5_windows(pcm[:1])[:M5_BLOCK].contiguous()
    for arch in SERVE_ARCHS:
        nets = [infer.load_model_and_state(str(ckpts[arch]), wcfg if arch == "M5" else cfg,
                                           arch=arch, bf16=b, device=dev)[0].eval()
                for b in (False, True)]
        x = block if arch == "M5" else norm
        with torch.inference_mode(), full_float32():
            f32_ms, bf16_ms = (time_ms(torch, lambda net=net: net(x)) for net in nets)
        bf16_rows.append((arch, f32_ms, bf16_ms))

    log(f"[aot] {len(AOT_BUILDS)} artifacts built by `python -m sed_tpu_torch.cli.serve build` "
        f"side by side in {builds_wall:.1f} s; phase 1's nvcc build {nvcc_s:.2f} s")
    for tag, b, err, same, launches, stages in rows:
        log(f"[aot] {tag}: {b['bytes']} B, build_seconds {b['build_seconds']}; loaded here "
            f"in " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f" s; one call on "
            f"{BATCH} x {SECONDS} s int16: launches {({k: v for k, v in launches.items() if v})}, "
            f"max |artifact - eager| {err:.3e}, in-process build reproduces its weights: {same}")
    log(f"[aot] cnn_f32 against make_batch_predictor: max {main_err:.3e} (tol {AOT_TOL}, "
        f"equal: {bool(torch.equal(got_scores['cnn_f32'], main_eager))}); cnn_bf16 against "
        f"cnn_f32: max {bf16_dev:.3e} (band {BF16_BAND}); cnn_int8 / cnn_qat against cnn_f32: "
        f"{float((got_scores['cnn_int8'] - got_scores['cnn_f32']).abs().max()):.3e} / "
        f"{float((got_scores['cnn_qat'] - got_scores['cnn_f32']).abs().max()):.3e}")
    beside = " (beside this process's checks)"
    for tag, (line, stages, wall, _) in fresh.items():
        log(f"[aot] fresh process, {tag} (`cli.serve run` of cnn_f32.aot on 2 WAVs, copy of the "
            f"package {'with an empty' if tag == 'cold' else 'with the installed'} _build/): "
            f"artifact_load_seconds {line['artifact_load_seconds']}, "
            f"load_to_first_result_seconds {line['load_to_first_result_seconds']}, process "
            f"wall {wall:.2f} s{beside if tag == 'warm' else ''}; "
            f"{stages}; nvcc never ran; scores within {fresh_err:.3e} of this process's")
    log(f"[aot] a fresh process (beside the warm one) imports torch in {import_s[0]} s, then "
        f"torch.export's deserializer (torch._export.serde.serialize) in {import_s[1]} s")
    log(f"[times] {smi}; AOT artifacts against the eager path, CUDA-event medians of {REPS} "
        f"({AOT_M5_REPS} for M5), {BATCH} x {SECONDS} s int16 in, scores out:")
    for tag, (ms, eager_ms) in times.items():
        log(f"[times] {tag}: artifact {ms:.4f} ms | eager {eager_ms:.4f} ms "
            f"({ms / eager_ms:.3f}x)")
    main_ms = time_ms(torch, lambda: predict(pcm))
    art_ms = times["cnn_f32"][0]
    log(f"[times] make_batch_predictor on the same batch {main_ms:.4f} ms (cnn_f32 artifact "
        f"{art_ms:.4f} ms, {art_ms / main_ms:.3f}x)")
    profiles = {}
    for what, fn, ms in (("cnn_f32 artifact", lambda: calls["cnn_f32"](pcm), art_ms),
                         ("make_batch_predictor", lambda: predict(pcm), main_ms)):
        profiles[what] = dict(profile_ticks(torch, fn, 5))
        busy = sum(profiles[what].values())
        log(f"[times] {what}: {busy:.4f} ms of kernels a call (torch.profiler, 5 calls), the "
            f"card idle {max(0.0, 1 - busy / ms):.1%} of its {ms:.4f} ms" if busy else
            f"[times] {what}: torch.profiler captured no device time (not measured)")
    art, eager = profiles.values()
    for name in sorted(set(art) | set(eager), key=lambda n: -abs(art.get(n, 0) - eager.get(n, 0)))[:8]:
        log(f"[times]   artifact {art.get(name, 0):.4f} ms | predictor {eager.get(name, 0):.4f} ms  "
            f"{name[:90]}")
    for arch, f32_ms, bf16_ms in bf16_rows:
        shape = (f"a block of {M5_BLOCK} frames" if arch == "M5"
                 else f"{BATCH} x {SECONDS} s, {feats.shape[2]} frames")
        log(f"[times] {arch} forward ({shape}): float32 {f32_ms:.4f} ms | bf16 {bf16_ms:.4f} ms "
            f"({bf16_ms / f32_ms:.2f}x)")
    log(f"[aot] {time.perf_counter() - t0:.1f} s")
    return launched


def stored_float32(state) -> bool:
    """Every floating tensor of the model's state dict and of the
    optimizer's state is float32."""
    tensors = list(state.model.state_dict().values()) + [
        v for s in state.optimizer.state.values() for v in s.values() if hasattr(v, "dtype")]
    return all(t.dtype == state_dtype(t) for t in tensors)


def state_dtype(t):
    """float32 for a floating tensor, its own dtype otherwise."""
    import torch

    return torch.float32 if t.is_floating_point() else t.dtype


def median_seconds(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def bf16_phase(torch, cfg, dev, smi, tmp, model, mean, std, spec):
    """Phase 16: the bf16 tier on the live paths and in training, and the
    native reader (see the module docstring).  ``model``, ``mean``, ``std``:
    phase 3's; ``spec``: phase 11's corpus under ``tmp``.  Returns the launch
    counts of the phase's main-path runs, summed."""
    import contextlib
    import io

    from sed_tpu_torch.configs import WaveformConfig
    from sed_tpu_torch.data import device_pipeline as pipe
    from sed_tpu_torch.data.preprocess import preprocess_data
    from sed_tpu_torch.data.waveform_dataset import WaveformDataset
    from sed_tpu_torch.io import audio as audio_io
    from sed_tpu_torch.io import native
    from sed_tpu_torch.io.film_clap import get_film_clap_paths_and_labels
    from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling, MobileNetV1
    from sed_tpu_torch.models.m5 import M5
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.stream_pool import StreamPool
    from sed_tpu_torch.train import loop
    from sed_tpu_torch.train.state import init_state
    from sed_tpu_torch.waveform_streaming import DeviceWaveformStreamPool

    t0 = time.perf_counter()
    sr = chunk = cfg.working_sample_rate
    wcfg = WaveformConfig()
    bf16 = torch.bfloat16
    counted = dict.fromkeys(kernels.LAUNCHES, 0)

    def count(launches):
        for k, v in launches.items():
            counted[k] += v

    def tier_of(make, weights, dtype):
        m = make(dtype)
        m.load_state_dict(weights.state_dict())
        return m.to(dev).eval()

    def compare(tag, runs, launch_keys):
        """bf16 against float32 scores of every stream of one pool's run."""
        (f_scores, f_wall, f_launch, f_peak, ticks), (b_scores, b_wall, b_launch, b_peak, _) = (
            runs["f32"], runs["bf16"])
        err = 0.0
        for i, (a, b) in enumerate(zip(b_scores, f_scores)):
            check(a.shape == b.shape and a.shape[0] > 0, f"{tag} stream {i}: bf16 {a.shape} "
                  f"frames, float32 {b.shape}")
            err = max(err, float(np.abs(a - b).max()))
        audio_s = sum(len(s) for s in streams[tag]) / sr
        log(f"[bf16] {tag}, {len(f_scores)} streams, {ticks} ticks: bf16 against float32 "
            f"scores max {err:.3e} (band {BF16_BAND}); launches bf16 {b_launch}, float32 "
            f"{f_launch}; wall {b_wall:.3f} / {f_wall:.3f} s ({audio_s / b_wall:.1f} / "
            f"{audio_s / f_wall:.1f} audio-s per wall-s), peak {b_peak:.1f} / {f_peak:.1f} MiB "
            f"(bf16 / float32; {smi})")
        check(0.0 < err <= BF16_BAND, f"{tag}: bf16 within {BF16_BAND} of float32 (and not "
              f"equal to it: {err:.3e})")
        for k in launch_keys:
            check(b_launch[k] == f_launch[k] > 0, f"{tag}: {k} launched on the bf16 run as on "
                  f"the float32 one ({b_launch[k]}, {f_launch[k]})")
        check(not any(v for k, v in b_launch.items() if k not in launch_keys),
              f"{tag}: no other kernel launched")
        count(b_launch)

    # ---- the bf16 tick: CnnAvgPooling on phase 5's run ------------------------
    cnn = {"f32": model, "bf16": tier_of(
        lambda d: CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL, dtype=d), model, bf16)}
    audio = (make_signals(torch, POOL_SLOTS, sr * POOL_SECONDS, sr, dev, 2) * 32767
             ).round().to(torch.int16).cpu().numpy()
    clips = [audio[i] for i in range(POOL_SLOTS)]
    clips[EARLY_LEAVER] = clips[EARLY_LEAVER][: int(EARLY_SECONDS * sr)]
    streams = {"CnnAvgPooling StreamPool": clips}
    runs = {}
    for tier, m in cnn.items():
        pool = StreamPool(m, cfg, slots=POOL_SLOTS, chunk_samples=chunk, mean=mean, std=std,
                          device=DEVICE)
        runs[tier] = drive_pool(torch, dev, pool, clips, chunk, seed=2)
    compare("CnnAvgPooling StreamPool", runs, ("frames_stft_power", "mel_log"))
    tick_ms, tick_dev = {}, {}
    for tier, m in cnn.items():
        tpool = StreamPool(m, cfg, slots=POOL_SLOTS, chunk_samples=chunk, mean=mean, std=std,
                           device=DEVICE)
        tslots = [tpool.join() for _ in range(POOL_SLOTS)]
        for k in range(2):
            tpool.push({s: audio[s, k * chunk: (k + 1) * chunk] for s in tslots})
        one = {s: audio[s, 2 * chunk: 3 * chunk] for s in tslots}
        tick_ms[tier] = time_ms(torch, lambda: tpool._push_rounds([one]))
        tick_dev[tier] = profile_ticks(torch, lambda: tpool._push_rounds([one]), n=5)
        del tpool
    for tier in ("f32", "bf16"):
        rows = tick_dev[tier]
        busy = sum(ms for _, ms in rows)
        log(f"[times] {tier} tick, {POOL_SLOTS} slots, CnnAvgPooling: {tick_ms[tier]:.4f} ms "
            f"(CUDA-event median of {REPS}); kernels {busy:.4f} ms a tick (torch.profiler, 5 "
            f"ticks), the largest: " + ", ".join(f"{n[:48]} {ms:.4f}" for n, ms in rows[:3])
            + f" ({smi})" if rows else
            f"[times] {tier} tick: {tick_ms[tier]:.4f} ms; device time not measured ({smi})")
    log(f"[times] bf16 tick / float32 tick {tick_ms['bf16'] / tick_ms['f32']:.3f} ({smi})")

    # ---- MobileNetV1 and M5 bf16 pools on phase 13's streams ------------------
    short = (make_signals(torch, POOL_SLOTS, sr * BF16_SECONDS, sr, dev, 13) * 32767
             ).round().to(torch.int16).cpu().numpy()
    clips = [short[i] for i in range(POOL_SLOTS)]
    # Phase 13's weights: MobileNetV1 and M5 seeded as its SERVE_ARCHS.
    mobilenet = seed_batch_norms(
        torch, MobileNetV1(cfg.classes_num, generator=torch.Generator().manual_seed(31)), 41)
    runs = {}
    for tier, d in (("f32", None), ("bf16", bf16)):
        logits = tier_of(lambda d: MobileNetV1(cfg.classes_num, emit="logits", dtype=d),
                         mobilenet, d)
        pool = StreamPool(logits, cfg, slots=POOL_SLOTS, chunk_samples=chunk, halo=88,
                          mean=mean, std=std, device=DEVICE)
        runs[tier] = drive_pool(torch, dev, pool, clips, chunk, seed=13)
    streams["MobileNetV1 StreamPool (halo 88)"] = clips
    compare("MobileNetV1 StreamPool (halo 88)", runs, ("frames_stft_power", "mel_log"))
    m5 = seed_batch_norms(torch, M5(wcfg.classes_num, generator=torch.Generator().manual_seed(32)),
                          42)
    runs, round_ms = {}, {}
    for tier, d in (("f32", None), ("bf16", bf16)):
        m = tier_of(lambda d: M5(wcfg.classes_num, dtype=d), m5, d)
        runs[tier] = drive_pool(torch, dev, DeviceWaveformStreamPool(
            m, wcfg, slots=POOL_SLOTS, device=DEVICE), clips, chunk, seed=13)
        dpool = DeviceWaveformStreamPool(m, wcfg, slots=POOL_SLOTS, device=DEVICE)
        dslots = [dpool.join() for _ in range(POOL_SLOTS)]
        for k in range(2):
            dpool.push({s: short[s, k * chunk: (k + 1) * chunk] for s in dslots})
        one = {s: short[s, 2 * chunk: 3 * chunk] for s in dslots}
        round_ms[tier] = time_ms(torch, lambda: dpool._push_rounds([one]))
        del dpool
    streams["M5 DeviceWaveformStreamPool"] = clips
    compare("M5 DeviceWaveformStreamPool", runs, ())
    log(f"[times] M5 device pool round, {POOL_SLOTS} slots: bf16 {round_ms['bf16']:.4f} ms, "
        f"float32 {round_ms['f32']:.4f} ms (CUDA-event medians of {REPS}; {smi})")
    del runs, audio, short, clips, streams

    # ---- bf16 training: CnnAvgPooling (logMel) and M5 at batch 128 ---------
    data = tmp / "data"
    quiet = io.StringIO()
    wave_sets = {}
    for w in (0, READ_WORKERS):
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(quiet):
            wave_sets[w] = WaveformDataset(get_film_clap_paths_and_labels(
                str(data / "FilmClap"), wcfg.time_margin), WAVE_VAL, cfg=wcfg, seed=0, workers=w)
        wave_sets[w, "s"] = time.perf_counter() - t1
    a, b = wave_sets[0], wave_sets[READ_WORKERS]
    check(np.array_equal(a.long_waveform, b.long_waveform)
          and np.array_equal(a.possible_start_indices, b.possible_start_indices)
          and np.array_equal(a.all_start_indices_labels, b.all_start_indices_labels),
          f"WaveformDataset(workers={READ_WORKERS}) equals workers=0's")
    log(f"[bf16] WaveformDataset on phase 11's corpus: workers={READ_WORKERS} (the native "
        f"reader's threads) {wave_sets[READ_WORKERS, 's']:.2f} s, workers=0 "
        f"{wave_sets[0, 's']:.2f} s, equal arrays ({smi})")
    cases = (("CnnAvgPooling logMel", spec["dataset"], "spectogram", cfg, TRAIN_BATCH,
              lambda d: CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL, dtype=d)),
             ("M5", wave_sets[READ_WORKERS], "waveform", wcfg, WAVE_BATCH,
              lambda d: M5(wcfg.classes_num, dtype=d)))
    for name, dataset, mode, mcfg, batch, make in cases:
        init = make(None)
        init.reset_parameters(torch.Generator().manual_seed(16))
        out, step_ms = {}, {}
        for tier, d in (("f32", None), ("bf16", bf16)):
            m = make(d)
            m.load_state_dict(init.state_dict())
            state = init_state(m, TRAIN_LR, dev)
            run_dir = tmp / f"run16_{mode}_{tier}"

            def val_loss(st):
                res = loop.evaluate(st.model, st, dataset, mode, 5.0, str(run_dir), 0,
                                    make_plots=False, cfg=mcfg)
                return float(np.mean(res[0]))

            loss0 = val_loss(state)
            kernels.reset_launch_counts()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(quiet):
                state = loop.train(m, dataset, mode, num_steps=BF16_STEPS, lr=TRAIN_LR,
                                   log_freq=BF16_STEPS, outputs_dir=str(run_dir),
                                   batch_size=batch, cfg=mcfg, initial_state=state,
                                   make_plots=False, device=DEVICE)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t1
            launched = dict(kernels.LAUNCHES)
            count(launched)
            loss1 = val_loss(state)
            rec = json.loads((run_dir / "metrics.jsonl").read_text().splitlines()[-1])
            ckpt = torch.load(run_dir / "checkpoints" / f"iteration_{BF16_STEPS}.pt",
                              weights_only=True)
            ckpt_ok = all(t.dtype == state_dtype(t) for t in list(ckpt["model"].values()) + [
                v for s in ckpt["optimizer"]["state"].values() for v in s.values()
                if hasattr(v, "dtype")])
            out[tier] = (loss0, loss1, rec["train_loss"], train_s)
            if tier == "bf16":
                check(loss1 < loss0 and np.isfinite(rec["train_loss"]),
                      f"{name} bf16: the validation loss falls ({loss0:.4f} -> {loss1:.4f})")
                check(state.model.dtype == bf16 and stored_float32(state) and ckpt_ok,
                      f"{name} bf16: parameters, optimizer state, BatchNorm statistics and "
                      f"the checkpoint are float32")
                check(not any(launched.values()), f"{name} bf16 training launches no "
                      f"featurizer kernel ({launched})")
            if mode == "spectogram":
                bufs = pipe.spectrogram_buffers_from_dataset(dataset, dev)
                fn = pipe.make_spectrogram_train_step(mcfg, 5.0, "logMel", augment=False)
            else:
                bufs = pipe.waveform_buffers_from_dataset(dataset, dev)
                fn = pipe.make_waveform_train_step(mcfg, 5.0, augment=False)
            starts = torch.as_tensor(dataset.train_start_indices[:batch] if mode == "spectogram"
                                     else dataset.possible_start_indices[:batch], device=dev)
            step_ms[tier] = time_ms(torch, lambda: fn(state, bufs, starts))
            del bufs, state
        log(f"[bf16] {name}, batch {batch}, {BF16_STEPS} steps at lr {TRAIN_LR} from one "
            f"init: val loss bf16 {out['bf16'][0]:.4f} -> {out['bf16'][1]:.4f}, float32 "
            f"{out['f32'][0]:.4f} -> {out['f32'][1]:.4f}; last train loss bf16 "
            f"{out['bf16'][2]:.4f}, float32 {out['f32'][2]:.4f}; train() {out['bf16'][3]:.2f} / "
            f"{out['f32'][3]:.2f} s (bf16 / float32, evaluation included)")
        log(f"[times] {name} train step, batch {batch}: bf16 {step_ms['bf16']:.4f} ms, float32 "
            f"{step_ms['f32']:.4f} ms (CUDA-event medians of {REPS}; bf16 / float32 "
            f"{step_ms['bf16'] / step_ms['f32']:.3f}; {smi})")
    del wave_sets, cases

    # ---- the native reader -------------------------------------------------
    info = native.build()
    log(f"[reader] native reader library {info.path.name} (g++ {' '.join(native.CXXFLAGS)})")
    long_path = str(burst_wav(tmp / "long16.wav", FILE_SECONDS[0], sr, 10))  # phase 10
    got, _ = audio_io.read_wav(long_path)
    want, _ = audio_io.read_wav_plain(long_path)
    check(np.array_equal(got, want), "the native read_wav equals the scipy decode (int16)")
    del got, want
    native_s = median_seconds(lambda: audio_io.read_wav(long_path), READ_REPS)
    plain_s = median_seconds(lambda: audio_io.read_wav_plain(long_path), READ_REPS)
    log(f"[times] read_wav of the {FILE_SECONDS[0] / 60:.0f}-minute 48 kHz int16 WAV: native "
        f"{native_s * 1e3:.1f} ms, scipy (the plain version) {plain_s * 1e3:.1f} ms (medians of "
        f"{READ_REPS}; native / scipy {native_s / plain_s:.3f}; {smi})")
    wavs = spec["wavs"]
    batches, batch_s = {}, {}
    for w in (READ_WORKERS, 0):
        batches[w] = audio_io.read_multichannel_audio_batch(wavs, sr, cfg, workers=w)
        batch_s[w] = median_seconds(
            lambda: audio_io.read_multichannel_audio_batch(wavs, sr, cfg, workers=w), READ_REPS)
    plain = audio_io.read_multichannel_audio_batch_plain(wavs, sr, cfg, workers=READ_WORKERS)
    check(all(np.array_equal(a, b) and np.array_equal(a, c) for a, b, c in
              zip(batches[READ_WORKERS], batches[0], plain)),
          f"the corpus read with workers={READ_WORKERS}, workers=0 and the plain path: equal")
    log(f"[times] read_multichannel_audio_batch of phase 11's {len(wavs)} x "
        f"{TRAIN_SECONDS:.0f} s WAVs: workers={READ_WORKERS} {batch_s[READ_WORKERS] * 1e3:.1f} "
        f"ms, workers=0 {batch_s[0] * 1e3:.1f} ms (medians of {READ_REPS}; "
        f"{batch_s[0] / batch_s[READ_WORKERS]:.2f}x; {smi})")
    del batches, plain
    items = get_film_clap_paths_and_labels(str(data / "FilmClap"), cfg.time_margin)
    pre_s = {}
    for w in (READ_WORKERS, 0):
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(quiet):
            preprocess_data(items, str(tmp / f"pre16_{w}"), str(tmp / f"pre16_{w}.pkl"),
                            cfg=cfg, workers=w, device=DEVICE, plot_sample=False)
        torch.cuda.synchronize()
        pre_s[w] = time.perf_counter() - t1
        if w:
            launched = dict(kernels.LAUNCHES)
            count(launched)
            check(launched["wave_stft_power"] == launched["mel_log"] == len(items),
                  f"preprocess_data(workers={w}): one K1 and one K2 a file ({launched})")
    same = True
    for name in sorted(p.name for p in (tmp / "pre16_0").iterdir()) + [None]:
        pa, pb = ((tmp / f"pre16_{w}" / name) if name else tmp / f"pre16_{w}.pkl"
                  for w in (0, READ_WORKERS))
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            da, db = pickle.load(fa), pickle.load(fb)
        same = same and da.keys() == db.keys() and all(
            np.array_equal(np.asarray(da[k]), np.asarray(db[k])) for k in da if da[k] is not None)
    check(same, f"preprocess_data(workers={READ_WORKERS}) pickles equal workers=0's")
    log(f"[times] preprocess_data (logMel) of the {len(items)} files: workers={READ_WORKERS} "
        f"{pre_s[READ_WORKERS]:.2f} s, workers=0 {pre_s[0]:.2f} s "
        f"({pre_s[0] / pre_s[READ_WORKERS]:.2f}x; {smi}); pickles equal")
    log(f"[bf16] phase {time.perf_counter() - t0:.1f} s; launches on its main paths {counted}")
    return counted


def mesh_step_child() -> None:
    """Phase 17's child process: the float32 train step of CnnAvgPooling
    (logMel crops) and of M5 at batch 128 on seeded buffers, plain and
    through ``shard_train_step`` on ``create_mesh(1)``, in turns plain,
    mesh, mesh, plain: the CUDA-event median of ``REPS`` calls and the
    host's mean ms a call without a sync.  Prints one JSON line ``{arch:
    {tag: [[ms, host ms], ...]}}``.  NCCL's flight recorder is as this
    process's environment has it; torch reads its buffer size once a
    process, so phase 17 starts one child with it off and one with it on."""
    import torch

    from sed_tpu_torch.configs import WaveformConfig
    from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM as cfg
    from sed_tpu_torch.data import device_pipeline as pipe
    from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling
    from sed_tpu_torch.models.m5 import M5
    from sed_tpu_torch.parallel.data_parallel import shard_train_step
    from sed_tpu_torch.parallel.mesh import create_mesh
    from sed_tpu_torch.parallel.multihost import shutdown_multihost
    from sed_tpu_torch.train.state import init_state

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE, 0)
    rng = np.random.default_rng(0)
    wcfg = WaveformConfig()
    frames, samples = 20000, 40 * wcfg.frame_size

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    spec = pipe.SpectrogramBuffers(
        features=up(rng.standard_normal((1, frames, cfg.mel_bins))),
        events=up(rng.random((frames, 1)) > 0.8),
        start_indices=torch.arange(frames - cfg.train_crop_size, device=dev),
        mean=torch.zeros(cfg.mel_bins, device=dev), std=torch.ones(cfg.mel_bins, device=dev))
    wave = pipe.WaveformBuffers(
        waveform=up(0.1 * rng.standard_normal((1, samples))),
        labels=up(rng.random(samples) > 0.8),
        start_indices=torch.arange(samples - wcfg.frame_size, device=dev))
    archs = {
        "CnnAvgPooling": (lambda: CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL), spec,
                          pipe.make_spectrogram_train_step(cfg, 5.0, "logMel", False),
                          rng.integers(0, frames - cfg.train_crop_size, TRAIN_BATCH)),
        "M5": (lambda: M5(1), wave, pipe.make_waveform_train_step(wcfg, 5.0, False),
               rng.integers(0, samples - wcfg.frame_size, WAVE_BATCH)),
    }
    mesh = create_mesh(1)
    out = {}
    try:
        for arch, (make, bufs, raw, starts) in archs.items():
            for tag in ("plain", "mesh", "mesh", "plain"):
                st = init_state(make(), MESH_LR, dev, seed=0)
                step = raw if tag == "plain" else shard_train_step(raw, mesh)
                ms = time_ms(torch, lambda: step(st, bufs, starts))
                t1 = time.perf_counter()
                for _ in range(REPS):
                    step(st, bufs, starts)
                host = (time.perf_counter() - t1) / REPS * 1e3
                torch.cuda.synchronize()
                out.setdefault(arch, {}).setdefault(tag, []).append([ms, host])
    finally:
        shutdown_multihost()
    print(json.dumps(out), flush=True)


def recorder_phase(smi) -> None:
    """Phase 17's times of the mesh step with NCCL's flight recorder off
    (``TORCH_FR_BUFFER_SIZE=0``, as ``multihost.launch``'s ranks run) and on
    (2000 entries, torch's default), a fresh process each
    (:func:`mesh_step_child`)."""
    got = {}
    for tag, size in (("off", "0"), ("on", "2000")):
        env = {k: v for k, v in os.environ.items()
               if k not in ("TORCH_FR_BUFFER_SIZE", "TORCH_NCCL_TRACE_BUFFER_SIZE")}
        env["TORCH_FR_BUFFER_SIZE"] = size
        proc = subprocess.run([sys.executable, "-c", "import chip_smoke; "
                               "chip_smoke.mesh_step_child()"], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"the mesh step's child with the flight recorder {tag} "
              f"(exit {proc.returncode}): {proc.stderr[-3000:]}")
        got[tag] = json.loads(proc.stdout.strip().splitlines()[-1])
    for arch in got["off"]:
        parts = []
        for tag in ("off", "on"):
            t = got[tag][arch]
            ratio = min(t["mesh"])[0] / min(t["plain"])[0]
            parts.append(f"recorder {tag}: " + "; ".join(
                f"{k} " + ", ".join(f"{a:.4f} ({h:.4f})" for a, h in v) for k, v in t.items())
                + f" ({ratio:.3f}x)")
        log(f"[times] {arch} float32 train step at batch "
            f"{TRAIN_BATCH if arch != 'M5' else WAVE_BATCH}, plain and on create_mesh(1), a "
            f"fresh process for each setting of NCCL's flight recorder, ms (host enqueue ms): "
            + " | ".join(parts) + f" (CUDA-event medians of {REPS}, the host's mean over "
            f"{REPS} calls without a sync; in turns plain, mesh, mesh, plain; {smi})")


def mesh_phase(torch, cfg, dev, smi, tmp, model, mean, std, spec):
    """Phase 17: the data-parallel paths at world size 1 over NCCL (see the
    module docstring).  ``model``, ``mean``, ``std``: phase 3's; ``spec``:
    phase 11's corpus under ``tmp``.  Returns the launch counts of the
    phase's main-path runs, summed."""
    import contextlib
    import io

    import torch.distributed as dist

    from sed_tpu_torch.configs import WaveformConfig
    from sed_tpu_torch.data import device_pipeline as pipe
    from sed_tpu_torch.data.waveform_dataset import WaveformDataset
    from sed_tpu_torch.inference import batch_predict_files, make_batch_predictor
    from sed_tpu_torch.io.film_clap import get_film_clap_paths_and_labels
    from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling
    from sed_tpu_torch.models.m5 import M5
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.parallel.data_parallel import shard_train_step
    from sed_tpu_torch.parallel.mesh import create_mesh
    from sed_tpu_torch.parallel.multihost import shutdown_multihost
    from sed_tpu_torch.stream_pool import StreamPool
    from sed_tpu_torch.train import loop
    from sed_tpu_torch.train.state import init_state

    t0 = time.perf_counter()
    sr = chunk = cfg.working_sample_rate
    wcfg = WaveformConfig()
    counted = dict.fromkeys(kernels.LAUNCHES, 0)
    quiet = io.StringIO()

    def count(launches):
        for k, v in launches.items():
            counted[k] += v

    def state_errs(got, want):
        """(max parameter error, max BatchNorm-statistic excess over rtol
        1e-5 / atol 1e-6) of two state dicts."""
        p_err, bn_excess = 0.0, 0.0
        for key, w in want.items():
            if key.endswith("num_batches_tracked"):
                continue
            d = (got[key].double() - w.double()).abs()
            if "running_" in key:
                bn_excess = max(bn_excess, float(
                    (d - (MESH_BN_ATOL + MESH_BN_RTOL * w.double().abs())).max()))
            else:
                p_err = max(p_err, float(d.max()))
        return p_err, bn_excess

    def grad_rel(got, want):
        """The largest of each tensor's largest gradient difference over its
        largest value; M5's conv biases aside (each feeds a BatchNorm, so
        their gradients are rounding noise)."""
        return max(float((got[k] - g).abs().max() / g.abs().max())
                   for k, g in want.items()
                   if float(g.abs().max()) > 0 and not k.endswith(CONV_BIASES))

    mesh = create_mesh(1)
    try:
        check(mesh.size == 1 and mesh.device == dev and dist.get_backend() == "nccl",
              f"create_mesh(1): one rank over NCCL on {dev} ({mesh})")
        log(f"[mesh] create_mesh(1): {mesh}, backend {dist.get_backend()}")

        # ---- training: one float32 step through train(), CnnAvgPooling ----
        dataset = spec["dataset"]
        runs = {}
        for tag, m in (("plain", None), ("mesh", mesh)):
            st = init_state(CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL), MESH_LR,
                            dev, seed=0)
            out = tmp / f"run17_{tag}"
            with contextlib.redirect_stdout(quiet):
                st = loop.train(st.model, dataset, "spectogram", num_steps=1, lr=MESH_LR,
                                log_freq=1, outputs_dir=str(out), batch_size=TRAIN_BATCH,
                                cfg=cfg, initial_state=st, make_plots=False, device=DEVICE,
                                mesh=m)
            record = json.loads((out / "metrics.jsonl").read_text().splitlines()[0])
            runs[tag] = (record["train_loss"], {k: v.cpu() for k, v in
                                                st.model.state_dict().items()},
                         sorted(p.name for p in (out / "checkpoints").iterdir()),
                         {k: p.grad.detach().double().cpu()
                          for k, p in st.model.named_parameters()})
        loss_rel = abs(runs["mesh"][0] - runs["plain"][0]) / abs(runs["plain"][0])
        p_err, bn_excess = state_errs(runs["mesh"][1], runs["plain"][1])
        g_rel = grad_rel(runs["mesh"][3], runs["plain"][3])
        log(f"[mesh] train(mesh=) against train(), CnnAvgPooling logMel, one float32 step at "
            f"batch {TRAIN_BATCH}, lr {MESH_LR}: loss {runs['mesh'][0]:.7f} vs "
            f"{runs['plain'][0]:.7f} (rel {loss_rel:.3e}, tol {MESH_LOSS_RTOL}), parameters "
            f"{p_err:.3e} (tol {MESH_PARAM_ATOL}), BatchNorm statistics excess over rtol "
            f"{MESH_BN_RTOL} / atol {MESH_BN_ATOL}: {bn_excess:.3e}; the gradients it applied, "
            f"largest difference relative to its tensor's largest: {g_rel:.3e} (tol "
            f"{MESH_GRAD32_REL})")
        check(loss_rel <= MESH_LOSS_RTOL and p_err <= MESH_PARAM_ATOL and bn_excess <= 0
              and g_rel <= MESH_GRAD32_REL, "train(mesh=) float32 step equals train()")
        check(runs["mesh"][2] == runs["plain"][2] == ["iteration_1.pt"],
              f"train(mesh=) writes train()'s checkpoint ({runs['mesh'][2]})")

        # ---- the steps themselves: float32 M5, float64 K steps, and times ----
        with contextlib.redirect_stdout(quiet):
            wave = WaveformDataset(get_film_clap_paths_and_labels(
                str(tmp / "data" / "FilmClap"), wcfg.time_margin), WAVE_VAL, cfg=wcfg, seed=0)
        spec_bufs = pipe.spectrogram_buffers_from_dataset(dataset, dev)
        wave_bufs = pipe.waveform_buffers_from_dataset(wave, dev)
        archs = {
            "CnnAvgPooling": (lambda: CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL),
                              spec_bufs, lambda aug: pipe.make_spectrogram_train_step(
                                  cfg, 5.0, "logMel", aug),
                              list(dataset.epoch_start_indices(TRAIN_BATCH))),
            "M5": (lambda: M5(wcfg.classes_num), wave_bufs,
                   lambda aug: pipe.make_waveform_train_step(wcfg, 5.0, aug),
                   list(wave.epoch_start_indices(WAVE_BATCH))),
        }

        def as_dtype(bufs, dtype):
            return dataclasses.replace(bufs, **{
                f.name: getattr(bufs, f.name).to(dtype)
                for f in dataclasses.fields(bufs)
                if getattr(bufs, f.name).is_floating_point() and f.name != "events"
                and f.name != "labels"})

        step_ms = {}

        def time_step(arch, tag, on):
            """The float32 step of ``arch``, plain or on the mesh ``on``:
            (CUDA-event ms, the host's ms a call without a sync)."""
            make, bufs, maker, batches = archs[arch]
            st = init_state(make(), MESH_LR, dev, seed=0)
            raw = maker(False)
            step = raw if on is None else shard_train_step(raw, on)
            ms = time_ms(torch, lambda: step(st, bufs, batches[1]))
            t1 = time.perf_counter()
            for _ in range(REPS):
                step(st, bufs, batches[1])
            host = (time.perf_counter() - t1) / REPS * 1e3
            torch.cuda.synchronize()
            step_ms.setdefault(arch, {}).setdefault(tag, []).append((ms, host))

        for arch, (make, bufs, maker, batches) in archs.items():
            # One float32 step: loss, parameters (lr 1e-6), statistics and
            # the first gradients (MESH_GRAD32_REL).
            outs = {}
            for tag in ("plain", "mesh"):
                st = init_state(make(), MESH_LR, dev, seed=0)
                raw = maker(False)
                step = raw if tag == "plain" else shard_train_step(raw, mesh)
                loss = float(step(st, bufs, batches[0]))
                outs[tag] = (loss, {k: p.grad.detach().double().cpu()
                                    for k, p in st.model.named_parameters()},
                             {k: v.cpu() for k, v in st.model.state_dict().items()})
            loss_rel = abs(outs["mesh"][0] - outs["plain"][0]) / abs(outs["plain"][0])
            p_err, bn_excess = state_errs(outs["mesh"][2], outs["plain"][2])
            g_rel = grad_rel(outs["mesh"][1], outs["plain"][1])
            log(f"[mesh] {arch} float32 step at batch {len(batches[0])}, mesh against "
                f"plain: loss rel {loss_rel:.3e}, parameters {p_err:.3e} (lr {MESH_LR}), "
                f"BatchNorm excess {bn_excess:.3e}; first gradients (M5's conv biases "
                f"aside), largest difference relative to its tensor's largest: {g_rel:.3e} "
                f"(tol {MESH_GRAD32_REL})")
            check(loss_rel <= MESH_LOSS_RTOL and p_err <= MESH_PARAM_ATOL and bn_excess <= 0
                  and g_rel <= MESH_GRAD32_REL,
                  f"{arch}: the mesh's float32 step equals the plain step")

            # MESH_STEPS float64 steps with augmentation; M5 as two calls of
            # steps_per_call=2 and one single step.
            outs = {}
            for tag in ("plain", "mesh"):
                st = init_state(make().double(), TRAIN_LR, dev, seed=0)
                b64 = as_dtype(bufs, torch.float64)
                gen = torch.Generator(device=dev).manual_seed(17)
                raw = maker(True)
                wrap = (lambda f, k=1: f) if tag == "plain" else \
                    (lambda f, k=1: shard_train_step(f, mesh, steps_per_call=k))
                losses, grads = [], None
                if arch == "M5":
                    multi = wrap(pipe.make_multi_step(raw, 2), 2)
                    for i in (0, 2):
                        losses += multi(st, b64, np.stack(batches[i:i + 2]), gen).tolist()
                        if grads is None:
                            grads = {k: p.grad.detach().cpu()
                                     for k, p in st.model.named_parameters()}
                    losses.append(float(wrap(raw)(st, b64, batches[4], gen)))
                else:
                    for i in range(MESH_STEPS):
                        losses.append(float(wrap(raw)(st, b64, batches[i], gen)))
                        if grads is None:
                            grads = {k: p.grad.detach().cpu()
                                     for k, p in st.model.named_parameters()}
                outs[tag] = (np.array(losses), grads,
                             {k: v.cpu() for k, v in st.model.state_dict().items()})
            loss_rel = float(np.abs(outs["mesh"][0] / outs["plain"][0] - 1).max())
            p_err, bn_excess = state_errs(outs["mesh"][2], outs["plain"][2])
            g_excess = max(float(((outs["mesh"][1][k] - g).abs()
                                  - (MESH_GRAD_ATOL + MESH_GRAD_RTOL * g.abs())).max())
                           for k, g in outs["plain"][1].items())
            how = ("2 calls of steps_per_call=2 and one single step" if arch == "M5"
                   else f"{MESH_STEPS} single steps")
            log(f"[mesh] {arch} float64, augmentation on, {how}, mesh against plain: losses "
                f"rel {loss_rel:.3e}, parameters {p_err:.3e} (lr {TRAIN_LR}), BatchNorm "
                f"excess {bn_excess:.3e}, first gradients' excess over rtol {MESH_GRAD_RTOL} "
                f"/ atol {MESH_GRAD_ATOL}: {g_excess:.3e}")
            check(len(outs["mesh"][0]) == MESH_STEPS and loss_rel <= MESH_LOSS_RTOL
                  and p_err <= MESH_PARAM_ATOL and bn_excess <= 0 and g_excess <= 0,
                  f"{arch}: {MESH_STEPS} float64 mesh steps equal the plain steps")

            # Times: the float32 step, plain and on the mesh, in turns.
            kernels.reset_launch_counts()
            for tag in ("plain", "mesh", "mesh", "plain"):
                time_step(arch, tag, None if tag == "plain" else mesh)
            check(not any(kernels.LAUNCHES.values()), "training launches no featurizer kernel")
        for arch, t in step_ms.items():
            log(f"[times] {arch} float32 train step at batch "
                f"{TRAIN_BATCH if arch != 'M5' else WAVE_BATCH}, ms (host enqueue ms): "
                + "; ".join(f"{tag} " + ", ".join(f"{a:.4f} ({h:.4f})" for a, h in v)
                            for tag, v in t.items())
                + f" (CUDA-event medians of {REPS}, the host's mean over {REPS} calls without "
                f"a sync; in turns plain, mesh, mesh, plain: the all-gathers, all-reduces and "
                f"the global BatchNorm cost {min(t['mesh'])[0] / min(t['plain'])[0]:.3f}x; "
                f"in this process, TORCH_FR_BUFFER_SIZE "
                f"{os.environ.get('TORCH_FR_BUFFER_SIZE', 'unset')}; {smi})")
        del spec_bufs, wave_bufs, wave

        # ---- batch scoring: phase 3's batch through make_batch_predictor ----
        pcm = (make_signals(torch, BATCH, SECONDS * sr, sr, dev, 1)
               * 32767).round().to(torch.int16)[..., None]
        predict = make_batch_predictor(model, cfg, mean=mean, std=std, device=DEVICE)
        sharded = make_batch_predictor(model, cfg, mean=mean, std=std, mesh=mesh)
        scores = predict(pcm)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = sharded(pcm)
        torch.cuda.synchronize()
        launched = dict(kernels.LAUNCHES)
        count(launched)
        err = float((got - scores).abs().max())
        log(f"[mesh] make_batch_predictor(mesh=) on phase 3's {BATCH} x {SECONDS} s int16 "
            f"batch: launches {launched}; scores {tuple(got.shape)}, max diff vs phase 3 "
            f"{err:.3e} (tol {MESH_SCORE_TOL})")
        check(launched["wave_stft_power"] == 1 and launched["mel_log"] == 1
              and sum(launched.values()) == 2, "one K1 and one K2 launch a mesh predictor call")
        check(got.shape == scores.shape and err <= MESH_SCORE_TOL,
              "mesh scores equal phase 3's")
        wavs = [str(p) for p in spec["wavs"][:3]]
        want = batch_predict_files(model, wavs, cfg, mean, std, device=DEVICE)
        kernels.reset_launch_counts()
        files = batch_predict_files(model, wavs, cfg, mean, std, mesh=mesh)
        torch.cuda.synchronize()
        count(kernels.LAUNCHES)
        f_err = max(float(np.abs(files[p] - want[p]).max()) for p in wavs)
        log(f"[mesh] batch_predict_files(mesh=) on 3 of phase 11's WAVs: launches "
            f"{dict(kernels.LAUNCHES)}; max diff vs the plain call {f_err:.3e}")
        check(sorted(files) == sorted(wavs) and f_err <= MESH_SCORE_TOL,
              "batch_predict_files(mesh=) equals the plain call")
        score_ms = {}
        for tag in ("plain", "mesh", "mesh", "plain"):
            fn = predict if tag == "plain" else sharded
            score_ms.setdefault(tag, []).append(time_ms(torch, lambda fn=fn: fn(pcm)))
        log(f"[times] {BATCH} x {SECONDS} s scoring: plain "
            f"{', '.join(f'{x:.4f}' for x in score_ms['plain'])} ms, mesh of 1 "
            f"{', '.join(f'{x:.4f}' for x in score_ms['mesh'])} ms (CUDA-event medians of "
            f"{REPS}, in turns; {min(score_ms['mesh']) / min(score_ms['plain']):.3f}x; {smi})")

        # ---- streaming: phase 5's run cut to 20 s on a 32-slot mesh pool ----
        audio = (make_signals(torch, POOL_SLOTS, sr * POOL_SECONDS, sr, dev, 2) * 32767
                 ).round().to(torch.int16).cpu().numpy()[:, : sr * MESH_POOL_SECONDS]
        clips = [audio[i] for i in range(POOL_SLOTS)]
        want = score_all(torch, predict, clips)
        try:
            StreamPool(model, cfg, slots=POOL_SLOTS, chunk_samples=chunk, mean=mean, std=std,
                       featurizer="pallas", mesh=mesh)
            refused = ""
        except ValueError as e:
            refused = str(e)
        check(refused.startswith("featurizer='pallas' is not supported with a mesh"),
              f"featurizer='pallas' with a mesh raises sed_tpu's error ({refused!r})")
        pooled = {}
        for feat in ("auto", "xla"):
            pool = StreamPool(model, cfg, slots=POOL_SLOTS, chunk_samples=chunk, mean=mean,
                              std=std, mesh=mesh, featurizer=feat)
            got_pool, wall, launched, peak, ticks = drive_pool(torch, dev, pool, clips, chunk,
                                                               seed=2)
            count(launched)
            del pool
            p_err = 0.0
            for i, g in enumerate(got_pool):
                check(g.shape == want[i].shape,
                      f"mesh pool ({feat}) stream {i}: {g.shape} vs {want[i].shape}")
                p_err = max(p_err, float(np.abs(g - want[i]).max()))
            pooled[feat] = got_pool
            log(f"[mesh] StreamPool(mesh=, featurizer={feat!r}), {POOL_SLOTS} slots, phase "
                f"5's run cut to {MESH_POOL_SECONDS} s: {ticks} ticks in {wall:.2f} s, "
                f"launches {launched}; max diff vs make_batch_predictor {p_err:.3e} (tol "
                f"{SCORE_TOL}); peak {peak:.0f} MiB")
            check(p_err <= SCORE_TOL, f"mesh pool ({feat}) scores match make_batch_predictor")
            if feat == "auto":
                check(launched["frames_stft_power"] >= ticks
                      and launched["frames_stft_power"] == launched["mel_log"]
                      and sum(launched.values()) == 2 * launched["mel_log"],
                      "the mesh pool's 'auto' tick runs K3 and K2 on its rank, in pairs")
            else:
                check(not any(launched.values()), "the mesh pool's 'xla' launches no kernel")
        x_err = max(float(np.abs(a - b).max()) for a, b in zip(pooled["auto"], pooled["xla"]))
        log(f"[mesh] the mesh pool's K3 + K2 tick against its 'xla' tick: max diff "
            f"{x_err:.3e} (tol {SCORE_TOL})")
        check(x_err <= SCORE_TOL, "the mesh pool's K3 + K2 tick matches its 'xla' tick")
        del got_pool, pooled, audio, clips
    finally:
        shutdown_multihost()
    check(not dist.is_initialized(), "no process group is left after phase 17")
    recorder_phase(smi)

    # ---- the CLIs: --num_devices 2 on this host -------------------------------
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        proc = subprocess.run(
            [sys.executable, "-m", "sed_tpu_torch.cli.main", "--num_devices", "2",
             "--dataset_dir", str(tmp / "absent"), "--outputs_root", str(tmp / "absent_run"),
             "--no_plot", "--device", DEVICE], cwd=REPO, capture_output=True, text=True,
            timeout=300)
        said = proc.stderr.strip().splitlines()[-1] if proc.stderr.strip() else ""
        log(f"[mesh] cli.main --num_devices 2 on {n_cards} card: exit {proc.returncode}, "
            f"{said!r}")
        check(proc.returncode != 0
              and said == f"--num_devices 2 but only {n_cards} devices are visible"
              and not (tmp / "absent_run").exists(),
              "cli.main --num_devices 2 refuses a one-card host before any work")
    else:
        sub = tmp / "data17"
        subset_corpus(sub, spec["wavs"][:4], tmp / "data")
        outs = {}
        for n in (1, 2):
            run_cli(["sed_tpu_torch.cli.main", "--dataset_dir", sub, "--train_features",
                     "Spectogram", "--outputs_root", tmp / f"cli17_{n}", "--batch_size", "32",
                     "--num_train_steps", "20", "--log_freq", "10", "--val_descriptor",
                     "clip_03", "--no_plot", "--device", DEVICE, "--num_devices", n],
                    f"cli.main --num_devices {n}")
            (run,) = (tmp / f"cli17_{n}").iterdir()
            outs[n] = [json.loads(x)["train_loss"]
                       for x in (run / "metrics.jsonl").read_text().splitlines()]
            if n == 1:
                ckpt = run / "checkpoints" / "iteration_20.pt"
        for n in (1, 2):
            run_cli(["sed_tpu_torch.cli.infer", *spec["wavs"][:3], "--ckpt", ckpt, "--batch",
                     "--no_plot", "--outputs_dir", tmp / f"infer17_{n}", "--device", DEVICE,
                     "--num_devices", n], f"cli.infer --batch --num_devices {n}")
        rel = float(np.abs(np.array(outs[2]) / np.array(outs[1]) - 1).max())
        s_err = max(float(np.abs(np.load(tmp / "infer17_2" / f"{Path(p).stem}_scores.npy")
                                 - np.load(tmp / "infer17_1" / f"{Path(p).stem}_scores.npy"))
                          .max()) for p in spec["wavs"][:3])
        log(f"[mesh] {n_cards} cards: cli.main 20 steps at 2 ranks against 1: losses rel "
            f"{rel:.3e} (tol {MESH_CLI_RTOL}); cli.infer --batch at 2 ranks against 1 on one "
            f"checkpoint: {s_err:.3e} (tol {MESH_SCORE_TOL})")
        check(rel <= MESH_CLI_RTOL and len(outs[2]) == len(outs[1]) == 2,
              "cli.main at 2 ranks follows 1 rank")
        check(s_err <= MESH_SCORE_TOL, "cli.infer --batch at 2 ranks equals 1 rank")
    log(f"[mesh] phase {time.perf_counter() - t0:.1f} s; launches on its main paths {counted}")
    return counted


def sharded_phase(torch, cfg, dev, smi, tmp, model, mean, std, spec):
    """Phase 18: sharded AOT artifacts at world size 1 and the resume of
    ``sed_tpu``'s ``.ckpt`` (see the module docstring).  ``model``,
    ``mean``, ``std``: phase 3's; ``spec``: phase 11's corpus under
    ``tmp``.  Returns the launch counts of the sharded artifacts' calls."""
    import contextlib
    import io

    sys.path.insert(0, str(REPO / "tests"))
    import torch_flax_ckpt   # sed_tpu's msgpack .ckpt, written without flax

    from sed_tpu_torch import export as ex
    from sed_tpu_torch.configs import WaveformConfig
    from sed_tpu_torch.data import device_pipeline as pipe
    from sed_tpu_torch.data.waveform_dataset import WaveformDataset
    from sed_tpu_torch.io.film_clap import get_film_clap_paths_and_labels
    from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling
    from sed_tpu_torch.models.m5 import M5
    from sed_tpu_torch.models.quantize import quantize_cnn
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.ops.featurizer import logmel_features_batch
    from sed_tpu_torch.parallel.mesh import create_mesh
    from sed_tpu_torch.parallel.multihost import shutdown_multihost
    from sed_tpu_torch.train import checkpoint
    from sed_tpu_torch.train.state import init_state
    from sed_tpu_torch.utils.precision import full_float32

    t0 = time.perf_counter()
    sr = cfg.working_sample_rate
    samples = sr * SECONDS
    launched = dict.fromkeys(kernels.LAUNCHES, 0)
    pcm = (make_signals(torch, BATCH, samples, sr, dev, 18) * 32767).round() \
        .to(torch.int16)[..., None]
    with torch.inference_mode():
        feats = logmel_features_batch(pcm, cfg)
        norm = (feats - torch.as_tensor(mean, device=dev)) / torch.as_tensor(std, device=dev)
    heads = {"cnn_f32": ex.cnn_serving(model, mean, std),
             "cnn_int8": ex.quantized_serving(quantize_cnn(model, [norm.clone()]), mean, std)}
    del feats, norm

    # ---- sharded artifacts on a one-rank NCCL mesh against the plain ones ----
    mesh = create_mesh(1)
    try:
        check(mesh.size == 1 and mesh.device == dev, f"create_mesh(1) on {dev} ({mesh})")
        rows, times = [], {}
        for tag, head in heads.items():
            t1 = time.perf_counter()
            blobs = {"plain": ex.aot_export_pipeline(head, BATCH, samples, cfg, device=DEVICE),
                     "sharded": ex.aot_export_pipeline(head, BATCH, samples, cfg, mesh=mesh)}
            export_s = time.perf_counter() - t1
            hdr = ex.load_aot_fn(blobs["sharded"], mesh=mesh).header
            check(hdr["n_devices"] == 1 and hdr["shard_shape"] == hdr["input_shape"]
                  == [BATCH, samples, 1] and hdr["custom_ops"] == ["mel_log", "wave_stft_power"],
                  f"{tag}: the sharded artifact's header ({hdr['n_devices']} device, shard "
                  f"{hdr['shard_shape']}, {hdr['custom_ops']})")
            calls = {"plain": ex.load_aot_fn(blobs["plain"]),
                     "sharded": ex.load_aot_fn(blobs["sharded"], mesh=mesh)}
            check(calls["sharded"].device == dev, f"{tag}: placed on the rank's {dev}")
            plain = calls["plain"](pcm)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            got = calls["sharded"](pcm)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            for k, v in launches.items():
                launched[k] += v
            check({k: v for k, v in launches.items() if v} == {"wave_stft_power": 1,
                                                                "mel_log": 1},
                  f"{tag}: one sharded call launched {launches}")
            err = float((got - plain).abs().max())
            check(got.shape == plain.shape and bool(torch.isfinite(got).all())
                  and err <= MESH_SCORE_TOL,
                  f"{tag}: sharded scores {tuple(got.shape)} within {MESH_SCORE_TOL} of the "
                  f"plain artifact's ({err:.3e})")
            with torch.inference_mode(), full_float32():
                for which in ("plain", "sharded", "sharded", "plain"):
                    times.setdefault(tag, {}).setdefault(which, []).append(
                        time_ms(torch, lambda c=calls[which]: c(pcm)))
                split = {}
                for which, call in calls.items():
                    # The host's enqueue ms a call (no sync) and the device's
                    # ms by kernel (torch.profiler): the gather's share.
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    for _ in range(REPS):
                        call(pcm)
                    host = (time.perf_counter() - t1) / REPS * 1e3
                    torch.cuda.synchronize()
                    split[which] = (host, dict(profile_ticks(torch, lambda c=call: c(pcm), 5)))
            rows.append((tag, export_s, err, bool(torch.equal(got, plain)), launches,
                         calls["sharded"].load_timings, split))
            del calls, got, plain
    finally:
        shutdown_multihost()
    check(not torch.distributed.is_initialized(), "no process group is left after phase 18")
    for tag, export_s, err, equal, launches, stages, split in rows:
        log(f"[shard] {tag}: plain and sharded (create_mesh(1), NCCL) artifacts exported in "
            f"{export_s:.1f} s; sharded loaded in " + ", ".join(
                f"{k} {v:.3f}" for k, v in stages.items()) + f" s; one sharded call on "
            f"{BATCH} x {SECONDS} s int16: launches {({k: v for k, v in launches.items() if v})}"
            f"; max |sharded - plain| {err:.3e} (equal: {equal})")
        gather = {w: sum(v for k, v in by_kernel.items() if "nccl" in k.lower())
                  for w, (_, by_kernel) in split.items()}
        log(f"[times] {tag} a call, plain | sharded: host enqueue (mean of {REPS}, no sync) "
            f"{split['plain'][0]:.4f} | {split['sharded'][0]:.4f} ms; kernels (torch.profiler, "
            f"5 calls) {sum(split['plain'][1].values()):.4f} | "
            f"{sum(split['sharded'][1].values()):.4f} ms, of which NCCL "
            f"{gather['plain']:.4f} | {gather['sharded']:.4f} ms ({smi})")
    for tag, t in times.items():
        log(f"[times] {tag} artifact, {BATCH} x {SECONDS} s, plain "
            f"{', '.join(f'{x:.4f}' for x in t['plain'])} ms | sharded on create_mesh(1) "
            f"{', '.join(f'{x:.4f}' for x in t['sharded'])} ms (CUDA-event medians of {REPS}, "
            f"in turns plain, sharded, sharded, plain; "
            f"{min(t['sharded']) / min(t['plain']):.3f}x; {smi})")

    # ---- sed_tpu's .ckpt resumed, against the .pt of the same state ----------
    wcfg = WaveformConfig()
    with contextlib.redirect_stdout(io.StringIO()):
        wave = WaveformDataset(get_film_clap_paths_and_labels(
            str(tmp / "data" / "FilmClap"), wcfg.time_margin), WAVE_VAL, cfg=wcfg, seed=0)
    dataset = spec["dataset"]
    archs = {
        "CnnAvgPooling": (lambda: CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL),
                          pipe.spectrogram_buffers_from_dataset(dataset, dev),
                          pipe.make_spectrogram_train_step(cfg, 5.0, "logMel", False),
                          list(dataset.epoch_start_indices(TRAIN_BATCH))),
        "M5": (lambda: M5(wcfg.classes_num), pipe.waveform_buffers_from_dataset(wave, dev),
               pipe.make_waveform_train_step(wcfg, 5.0, False),
               list(wave.epoch_start_indices(WAVE_BATCH))),
    }

    def as_float64(bufs):
        return dataclasses.replace(bufs, **{
            f.name: getattr(bufs, f.name).double() for f in dataclasses.fields(bufs)
            if getattr(bufs, f.name).is_floating_point() and f.name not in ("events", "labels")})

    m5_state = None
    for arch, (make, bufs, step, batches) in archs.items():
        t1 = time.perf_counter()
        state = init_state(make(), TRAIN_LR, dev, seed=0)
        for i in range(2):
            step(state, bufs, batches[i])
        out = tmp / f"resume18_{arch}"
        pt = Path(checkpoint.save_checkpoint(state, str(out), 2))
        ckpt = pt.with_suffix(".ckpt")
        torch_flax_ckpt.write_flax_checkpoint(ckpt, state, arch)
        b64 = as_float64(bufs)
        runs = {}
        # cuDNN's deterministic algorithms: its default float64 convolution
        # backward of M5 parts two runs of one state by ~4e-10 on an H100.
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for path in (pt, ckpt):
                resumed = checkpoint.load_checkpoint(
                    str(path), init_state(make().double(), TRAIN_LR, dev, seed=1))
                losses = [float(step(resumed, b64, batches[i]))
                          for i in range(2, 2 + SHARD_STEPS)]
                runs[path.suffix] = (np.array(losses), resumed)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        (l_pt, s_pt), (l_ck, s_ck) = runs[".pt"], runs[".ckpt"]
        loss_rel = float(np.abs(l_ck / l_pt - 1).max())
        p_rel = max(float((a.double() - b.double()).abs().max()
                          / b.double().abs().max().clamp_min(1e-300))
                    for (k, a), b in zip(s_ck.model.state_dict().items(),
                                         s_pt.model.state_dict().values())
                    if a.is_floating_point())
        log(f"[shard] {arch} at full width: 2 float32 steps at batch {len(batches[0])}, saved "
            f"as the port's {pt.name} ({pt.stat().st_size} B) and written as sed_tpu's "
            f"{ckpt.name} ({ckpt.stat().st_size} B, tests/torch_flax_ckpt.py); "
            f"{SHARD_STEPS} float64 steps from each: losses {l_ck.tolist()} vs "
            f"{l_pt.tolist()}, largest relative difference {loss_rel:.3e}, parameters and "
            f"statistics {p_rel:.3e} of each tensor's largest (tol {SHARD_RESUME_REL}); "
            f"{time.perf_counter() - t1:.1f} s")
        check(s_ck.step == s_pt.step == 2 + SHARD_STEPS and np.isfinite(l_ck).all()
              and loss_rel <= SHARD_RESUME_REL and p_rel <= SHARD_RESUME_REL,
              f"{arch}: the .ckpt resume equals the .pt resume in float64")
        if arch == "M5":
            m5_state = state
        del runs, s_pt, s_ck, b64, bufs
    del archs, wave

    # ---- cli.main --resume auto from a run directory holding only a .ckpt -----
    data = tmp / "data18"
    subset_corpus(data, spec["wavs"][:WAVE_CLI_FILES], tmp / "data")
    lr = 1e-6   # the CLI's default, which names the run directory
    run_dir = (tmp / "cli18" / f"FilmClap_cfg({wcfg.cfg_descriptor}_b{SHARD_CLI_BATCH}_lr{lr}_"
               / "checkpoints")
    run_dir.mkdir(parents=True)
    torch_flax_ckpt.write_flax_checkpoint(run_dir / "iteration_2.ckpt", m5_state, "M5")
    del m5_state
    said = run_cli(["sed_tpu_torch.cli.main", "--dataset_dir", data, "--outputs_root",
                    tmp / "cli18", "--batch_size", SHARD_CLI_BATCH, "--num_train_steps", 6,
                    "--log_freq", 2, "--val_descriptor", 0.5, "--resume", "auto", "--no_plot",
                    "--device", DEVICE],
                   "cli.main --resume auto from a .ckpt")
    records = [json.loads(x) for x in (run_dir.parent / "metrics.jsonl").read_text().splitlines()]
    saved = torch.load(run_dir / "iteration_6.pt", map_location="cpu", weights_only=True)
    resumed_from = [ln for ln in said.splitlines() if "Auto-resuming" in ln]
    log(f"[shard] cli.main --resume auto (M5, batch {SHARD_CLI_BATCH}) in a run directory "
        f"holding only iteration_2.ckpt: {resumed_from}; logged iterations {[r['iteration'] for r in records]}, train losses "
        f"{[r['train_loss'] for r in records]}; iteration_6.pt at step {saved['step']}")
    check(f"Auto-resuming from {run_dir / 'iteration_2.ckpt'}" in said
          and [r["iteration"] for r in records] == [4, 6]
          and all(np.isfinite(r["train_loss"]) for r in records)
          and saved["step"] == 6 and int(saved["optimizer"]["state"][0]["step"]) == 6
          and saved["scheduler"]["last_epoch"] == 6,
          "cli.main --resume auto continues from sed_tpu's .ckpt for 4 steps")
    log(f"[shard] phase {time.perf_counter() - t0:.1f} s; launches of the sharded calls "
        f"{({k: v for k, v in launched.items() if v})}")
    return launched


def svm_corpus(torch, root, files, seconds, short_seconds, sr, seed, dev):
    """Phase 19's FilmClap-layout corpus, made on the card: ``files`` mono
    int16 WAVs of ``seconds`` and one of ``short_seconds``, noise with a
    faint tone and clap-like events (a decaying 2 kHz + 3.1 kHz burst of
    0.4-0.8 s, one per 6 s slot at a random offset), labelled as
    ``film_clap_corpus`` labels: centres 0.33 s apart along each event.
    Returns the WAV paths."""
    import json as _json

    from scipy.io import wavfile

    from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM
    from sed_tpu_torch.io.film_clap import LABEL_FILE

    half = DEFAULT_SPECTROGRAM.time_margin
    film_dir = root / "FilmClap" / "film"
    film_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    slot = 6.0
    labels, paths = {}, []
    for i, secs in enumerate([seconds] * files + [short_seconds]):
        n = int(secs * sr)
        t = torch.arange(n, device=dev, dtype=torch.float64) / sr
        x = 0.05 * torch.randn(n, generator=g, device=dev, dtype=torch.float64)
        x += 0.03 * torch.sin(2 * np.pi * rng.uniform(200, 6000) * t)
        centers = []
        for j in range(int(secs // slot)):
            length = rng.uniform(0.4, 0.8)
            start = j * slot + rng.uniform(0.5, slot - length - 0.5)
            a, b = int(start * sr), int((start + length) * sr)
            u = t[: b - a]
            x[a:b] += rng.uniform(0.2, 0.4) * torch.exp(-2.0 * u / length) * (
                torch.sin(2 * np.pi * 2000.0 * u) + torch.sin(2 * np.pi * 3100.0 * u))
            centers += list(np.arange(start + half, start + length - half + 1e-9, half)) or \
                [start + length / 2]
        pcm = (x.clamp(-1, 1) * 32767).to(torch.int16).cpu().numpy()
        path = str(film_dir / f"svm_{i:02d}.wav")
        wavfile.write(path, sr, pcm)
        labels[path] = [float(c) for c in centers]
        paths.append(path)
    with open(root / "FilmClap" / LABEL_FILE, "w") as f:
        _json.dump(labels, f)
    return paths


def svm_cpu_child(rows_path: str, out_path: str) -> None:
    """Phase 19's CPU reference, in a process of its own (it runs beside
    the card's fit): ``SVMDetector(soft_svm=True, device="cpu")`` on the
    rows, labels and weights of ``rows_path``; saves its decision values,
    probabilities, iterations, A, B and fit seconds to ``out_path``."""
    import torch

    from sed_tpu_torch.classical.svm import SVMDetector

    torch.set_num_threads(1)
    d = np.load(rows_path)
    det = SVMDetector(soft_svm=True, device="cpu").fit(d["x"], d["y"], d["w"])
    np.savez(out_path, dec=det.decision_function(d["x"]), prob=det.predict(d["x"]),
             n_iter=det.n_iter, prob_ab=[det.prob_a, det.prob_b], seconds=det.fit_seconds,
             n_sv=len(det.support))


def classical_phase(torch, cfg, dev, smi, tmp):
    """Phase 19: the SVM baseline at full size, sed_tpu's orbax fixture
    resumed, and the three exploration scripts (see the module docstring).
    Returns the launch counts of the scripts' runs, summed."""
    import contextlib
    import io

    from sed_tpu_torch.classical import svm
    from sed_tpu_torch.configs import DEFAULT_WAVEFORM as wcfg
    from sed_tpu_torch.data import device_pipeline as pipe
    from sed_tpu_torch.io.film_clap import get_film_clap_paths_and_labels
    from sed_tpu_torch.models.cnn import CnnAvgPooling
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.scripts import analyze_spectogram, play_with_spectograms
    from sed_tpu_torch.scripts import plot_waveform_frames
    from sed_tpu_torch.train import checkpoint
    from sed_tpu_torch.train.flax_ckpt import read_flax_checkpoint
    from sed_tpu_torch.train.orbax_ckpt import read_orbax_checkpoint, zstd_library
    from sed_tpu_torch.train.state import init_state
    from sed_tpu_torch.utils.metrics import calculate_metrics

    t0 = time.perf_counter()
    sr = wcfg.working_sample_rate
    data = tmp / "data19"

    # ---- the corpus and get_raw_data on the card ------------------------------------
    t1 = time.perf_counter()
    wavs = svm_corpus(torch, data, SVM_FILES, SVM_SECONDS, SVM_SHORT_SECONDS, sr, 19, dev)
    corpus_s = time.perf_counter() - t1
    with contextlib.redirect_stdout(io.StringIO()):
        items = get_film_clap_paths_and_labels(str(data / "FilmClap"), wcfg.time_margin)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    raw = svm.get_raw_data(items, wcfg, dev)
    raw_s = time.perf_counter() - t1
    short = [r for r in raw if r[2].endswith(f"svm_{SVM_FILES:02d}")]
    check(len(raw) == SVM_FILES + 1 and len(short) == 1, "get_raw_data: one entry a file")
    t1 = time.perf_counter()
    cpu_short = svm.get_raw_data([it for it in items if it[3] == short[0][2]], wcfg, "cpu")
    cpu_s = time.perf_counter() - t1
    db_err = float(np.abs(short[0][0] - cpu_short[0][0]).max())
    n_rows = sum(len(r[0]) for r in raw)
    log(f"[classical] corpus: {SVM_FILES} x {SVM_SECONDS:.0f} s + {SVM_SHORT_SECONDS:.0f} s "
        f"48 kHz WAVs ({sum(os.path.getsize(w) for w in wavs) / 2**20:.0f} MiB) made in "
        f"{corpus_s:.2f} s; get_raw_data on the card: {n_rows} rows in {raw_s:.2f} s "
        f"({n_rows / raw_s:.0f} rows/s: read, frames, float64 rFFT, log-mel); the short "
        f"file's {len(short[0][0])} rows against the CPU ({cpu_s:.2f} s): {db_err:.3e} dB "
        f"(tol {DB_TOL})")
    check(db_err <= DB_TOL and all(np.isfinite(r[0]).all() for r in raw),
          "get_raw_data on the card equals the CPU's rows")
    check(np.array_equal(short[0][1], cpu_short[0][1]), "the same coverage labels")

    long_rows = [r for r in raw if r is not short[0]]
    x = np.concatenate([r[0] for r in long_rows])[:SVM_ROWS]
    y = np.concatenate([r[1] for r in long_rows])[:SVM_ROWS]
    w = y * 10.0 + (1 - y)
    check(x.shape == (SVM_ROWS, 64), f"{SVM_ROWS} rows of 64 mel bins ({x.shape})")

    # ---- the CPU reference of SVM_CPU_ROWS rows, beside the card's fits -------------
    rows_path, out_path = tmp / "svm_rows.npz", tmp / "svm_cpu.npz"
    np.savez(rows_path, x=x[:SVM_CPU_ROWS], y=y[:SVM_CPU_ROWS], w=w[:SVM_CPU_ROWS])
    child = subprocess.Popen([sys.executable, "-c", "import chip_smoke; chip_smoke."
                              f"svm_cpu_child({str(rows_path)!r}, {str(out_path)!r})"],
                             cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
    _cli_runs.append(child)   # stop_background ends it if a check fails first

    # ---- SVMDetector(soft_svm=True) on 16,384 rows on the card ------------------------
    torch.cuda.reset_peak_memory_stats()
    det = svm.SVMDetector(soft_svm=True, device=dev)
    with contextlib.redirect_stdout(io.StringIO()):
        det.learn([x], [y])
    peak = torch.cuda.max_memory_allocated() / 2**20
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prob = det.predict(x)
    predict_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    hard = svm.SVMDetector(soft_svm=False, device=dev).fit(x, y, w)
    hard_s = time.perf_counter() - t1
    ap_train = calculate_metrics(prob.reshape(-1, 1), y.reshape(-1, 1))[2]
    with contextlib.redirect_stdout(io.StringIO()) as said:
        _, _, aps, accs = svm.evaluate_model(det, [short[0]], plot=False)
    log(f"[classical] {smi}: SVMDetector(soft_svm=True) on {SVM_ROWS} x 64 rows on the "
        f"card: fit {det.fit_seconds:.2f} s (5 fold fits for Platt's A, B = "
        f"{det.prob_a:.4f}, {det.prob_b:.4f}, then the final fit: {det.n_iter} SMO "
        f"iterations, {len(det.support)} support vectors), the hard fit alone "
        f"{hard_s:.2f} s ({hard.n_iter} iterations, {hard_s / max(1, hard.n_iter) * 1e3:.3f} "
        f"ms an iteration); predict of {SVM_ROWS} rows {predict_s * 1e3:.1f} ms; peak "
        f"device memory {peak:.1f} MiB; training-set AP {ap_train:.4f}; the short file "
        f"(evaluate_model): AP {aps[0]:.4f}, accuracy {accs[0]:.4f}")
    check(np.isfinite(prob).all() and ((prob >= 0) & (prob <= 1)).all()
          and det.n_iter > 0 and hard.n_iter == det.n_iter and ap_train > 0.5,
          "the 16,384-row soft SVC fits on the card")

    # ---- 2,048 rows: the card against the CPU's float64 fit ---------------------------
    t1 = time.perf_counter()
    small = svm.SVMDetector(soft_svm=True, device=dev).fit(x[:SVM_CPU_ROWS], y[:SVM_CPU_ROWS],
                                                           w[:SVM_CPU_ROWS])
    small_s = time.perf_counter() - t1
    said_child = child.communicate(timeout=600)[0]
    if child.returncode != 0:
        print(said_child[-4000:], file=sys.stderr)
    check(child.returncode == 0, f"the CPU SVM child exit code {child.returncode}")
    ref = np.load(out_path)
    dec_gap = float(np.abs(small.decision_function(x[:SVM_CPU_ROWS]) - ref["dec"]).max())
    prob_gap = float(np.abs(small.predict(x[:SVM_CPU_ROWS]) - ref["prob"]).max())
    log(f"[classical] {SVM_CPU_ROWS} rows: card fit {small_s:.2f} s ({small.n_iter} "
        f"iterations) against the CPU's float64 fit {float(ref['seconds']):.2f} s "
        f"({int(ref['n_iter'])} iterations, one thread, its own process): decision values "
        f"{dec_gap:.3e}, probabilities {prob_gap:.3e} apart (tol {SVM_TOL}); A, B "
        f"{small.prob_a!r}, {small.prob_b!r} vs {ref['prob_ab'].tolist()}")
    check(dec_gap <= SVM_TOL and prob_gap <= SVM_TOL, "the card's SVM fit follows the CPU's")
    del x, y, w, raw, det, hard, small

    # ---- sed_tpu's orbax fixture: libzstd, the reader, a resume on the card ------------
    t1 = time.perf_counter()
    golden = REPO / "tests" / "golden" / "torch_orbax"
    zver = zstd_library().ZSTD_versionNumber()
    tree = read_orbax_checkpoint(str(golden / "iteration_2.ckpt.orbax"))
    twin = read_flax_checkpoint(str(golden / "iteration_2.ckpt"))

    def same(a, b):
        if isinstance(b, dict):
            return isinstance(a, dict) and a.keys() == b.keys() and all(
                same(a[k], b[k]) for k in b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)

    read_s = time.perf_counter() - t1
    check(same(tree, twin), "the orbax fixture equals its msgpack twin")
    small_cfg = ((8, 2), (16, 2))
    rng = np.random.default_rng(19)
    crop, mel, total = cfg.train_crop_size, cfg.mel_bins, 4 * cfg.train_crop_size
    bufs = pipe.SpectrogramBuffers(
        features=torch.from_numpy(rng.standard_normal((1, total, mel)).astype(np.float32)).to(dev),
        events=torch.from_numpy((rng.random((total, 1)) > 0.7).astype(np.float32)).to(dev),
        start_indices=torch.arange(total - crop, device=dev),
        mean=torch.zeros(mel, device=dev), std=torch.ones(mel, device=dev))
    step = pipe.make_spectrogram_train_step(cfg, 5.0, "logMel", False)
    starts = [rng.integers(0, total - crop, 8) for _ in range(2)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for name in ("iteration_2.ckpt.orbax", "iteration_2.ckpt"):
            st = checkpoint.load_checkpoint(str(golden / name), init_state(
                CnnAvgPooling(1, small_cfg), 1e-3, dev, seed=5))
            runs.append(([float(step(st, bufs, s)) for s in starts], st.step))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"[classical] orbax: libzstd {zver} loaded; the fixture "
        f"(tests/golden/torch_orbax, sed_tpu's CnnAvgPooling{small_cfg} after 2 steps) read "
        f"equal to its msgpack twin ({read_s:.3f} s for both reads); resumed on the card, "
        f"2 steps: losses {runs[0][0]} (from the .ckpt: {runs[1][0]}), step {runs[0][1]}; "
        f"{time.perf_counter() - t1:.2f} s")
    check(runs[0] == runs[1] and runs[0][1] == 4 and np.isfinite(runs[0][0]).all(),
          "the orbax resume on the card equals the .ckpt resume")

    # ---- the scripts --------------------------------------------------------------------
    launched = {k: 0 for k in kernels.LAUNCHES}
    wav = burst_wav(str(tmp / "analyze.wav"), ANALYZE_SECONDS, sr, 19)
    t1 = time.perf_counter()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        feature = analyze_spectogram.main([wav, "--out", str(tmp / "analysis.png"),
                                           "--device", DEVICE, "--no_plot"])
    counts = dict(kernels.LAUNCHES)
    analyze_s = time.perf_counter() - t1
    for k, v in counts.items():
        launched[k] += v
    want, _ = analyze_spectogram.segment_features(wav, device="cpu")
    err = float(np.abs(feature - want).max())
    log(f"[classical] scripts.analyze_spectogram --no_plot on a {ANALYZE_SECONDS:.0f} s WAV: "
        f"{said.getvalue().strip()!r} in {analyze_s:.2f} s; launches "
        f"{({k: v for k, v in counts.items() if v})}; against the CPU {err:.3e} dB")
    check(counts["wave_stft_power"] == 1 and counts["mel_log"] == 1
          and sum(counts.values()) == 2, "analyze_spectogram launches K1 and K2 once each")
    check(err <= DB_TOL and (tmp / "analysis.npz").exists(), "analyze_spectogram's features")

    sub = tmp / "data19s"
    subset_corpus(sub, wavs[:SCRIPT_FILES], data)
    t1 = time.perf_counter()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        acc = play_with_spectograms.main(["--dataset_dir", str(sub), "--holdout",
                                          str(SCRIPT_HOLDOUT),
                                          "--device", DEVICE, "--no_plot"])
    counts = dict(kernels.LAUNCHES)
    play_s = time.perf_counter() - t1
    for k, v in counts.items():
        launched[k] += v
    with contextlib.redirect_stdout(io.StringIO()):   # the card's features, the CPU's SVM
        cpu_acc = play_with_spectograms.main(["--dataset_dir", str(sub), "--holdout",
                                              str(SCRIPT_HOLDOUT), "--device", "cpu",
                                              "--no_plot"])
    log(f"[classical] scripts.play_with_spectograms on {SCRIPT_FILES} of the WAVs: "
        f"{said.getvalue().strip().splitlines()[-1]!r} in {play_s:.2f} s (preprocessing "
        f"included); launches {({k: v for k, v in counts.items() if v})}; the same "
        f"features through the CPU's SVC: accuracy {cpu_acc}")
    check(counts["wave_stft_power"] == counts["mel_log"] == SCRIPT_FILES
          and abs(acc - cpu_acc) <= 2 / SCRIPT_HOLDOUT,
          "play_with_spectograms preprocesses on the card and classifies as the CPU")
    sub1 = tmp / "data19p"
    subset_corpus(sub1, wavs[:PLOT_FILES], data)
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        indices, frames = plot_waveform_frames.main([
            "--dataset_dir", str(sub1), "--out_dir", str(tmp / "debug19"), "--num_frames",
            "20", "--device", DEVICE, "--no_plot"])
    saved = np.load(tmp / "debug19" / plot_waveform_frames.NPZ_NAME)
    log(f"[classical] scripts.plot_waveform_frames --no_plot on {PLOT_FILES} of the WAVs: "
        f"{said.getvalue().strip().splitlines()[-1]!r} in {time.perf_counter() - t1:.2f} s; "
        f"frames {saved['frames'].shape}")
    check(saved["frames"].shape == (20, 1, wcfg.frame_size)
          and np.isfinite(saved["frames"]).all(), "plot_waveform_frames writes 20 crops")
    log(f"[classical] phase {time.perf_counter() - t0:.1f} s; launches of the scripts' runs "
        f"{({k: v for k, v in launched.items() if v})}")
    return launched


# The featurizer tiers (phase 20): each precision the kernels are held at;
# the score and fidelity bounds of the tiers that have names.
TIER_PRECISIONS = ("bf16x3", "bf16x1", "bf16x4", "bf16x6", ("bf16x1", "bf16x3"))
TIER_NAMES = {"bf16x3": "fast", "bf16x1": "turbo"}
TIER_SCORE_TOL = {"fast": 1e-4, "turbo": 2e-3}   # against the parity scores (record 0, 6.2e-4)
TIER_DB_TOL = {"fast": 1e-3, "turbo": 0.05}      # log-mel on broadband noise vs float64
TIER_POOL_SECONDS = 20    # phase 20's pool run: phase 5's, cut from 60 s as phase 17's
TIER_PLAIN_REPS = 5       # the plain versions' float64 chains, timed fewer times
# The modes next to each precision, which its kernel's output must not lean
# towards (mode_fraction): the lo.lo term, each stage's lo chunks, the x6
# terms.  K2's bf16x3 next to its f32 product (None) and to bf16x1.
TIER_NEIGHBOURS = {
    "bf16x3": ("bf16x4", ("bf16x1", "bf16x3")),
    "bf16x1": (("bf16x3", "bf16x1"), ("bf16x1", "bf16x3")),
    "bf16x4": ("bf16x3", "bf16x6"),
    "bf16x6": ("bf16x4",),
    ("bf16x1", "bf16x3"): ("bf16x3", "bf16x1"),
}
MEL_NEIGHBOURS = {"bf16x1": ("bf16x3",), "bf16x3": (None, "bf16x1")}
# Nearer its own mode's plain version than the next's (kernels.mode_fraction),
# and, run at the next mode, nearer that one's: where two modes differ by
# terms ~2^-16 of the products (lo.lo, bf16x6's), the tensor cores' float32
# sums keep only part of them, so neither reading is 0 or 1 (PERF.md).
MODE_FRACTION_TOL = 0.5
MEL_MODE_DB_TOL = 1.5e-5   # K2's bf16 modes vs their plain versions (readings 7.5e-6, 7.9e-6)


def tier_rel_tol(passes) -> float:
    """K1t and K3t against their plain versions, x the frame's peak power.
    The tensor cores' f32 accumulation (its order, its alignment of the
    terms) against the plain version's exact float64 sums: ~1e-5; where the
    outer stage is bf16x1, an ulp of difference in the twiddled T flips its
    one bf16 rounding (2^-8 of it): 7.3e-5 at 16 x 60 s.  The modes next to
    each other are told apart by ``kernels.mode_fraction``, not by these
    limits."""
    return 1.5e-3 if passes[1] == 1 else 3e-5


def fractions_text(entry) -> str:
    """``entry``'s mode fractions, each beside the kernel's own fraction when
    run at that mode and the gap to that mode."""
    return ", ".join(f"{nb} {v['fraction']:.3e} (run at {nb}: {v['at_next']:.4f}; gap "
                     f"{v['gap']:.2e})" for nb, v in entry["mode_fraction"].items())


def tier_tag(precision) -> str:
    if isinstance(precision, tuple):
        return "(" + ", ".join(str(p) for p in precision) + ")"
    return f"{precision} ({TIER_NAMES[precision]})" if precision in TIER_NAMES else precision


def tiers_phase(torch, cfg, dev, smi, tmp, model, mean, std, peaks):
    """Phase 20: the featurizer tiers (see the module docstring).  ``model``,
    ``mean``, ``std``: phase 3's CnnAvgPooling and normalization;
    ``peaks``: the card's (memory B/s, FP32 FLOP/s, dense bf16 FLOP/s).
    Returns (the kernels line's entries of K1t, K3t and K2's bf16 modes, the
    launch counts of the phase's runs, summed)."""
    from sed_tpu_torch import export as ex
    from sed_tpu_torch.cli import infer as infer_cli
    from sed_tpu_torch.inference import make_batch_predictor
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.ops import stft as stft_ops
    from sed_tpu_torch.ops import tier_gemm_sweep as tier_sweep
    from sed_tpu_torch.ops.mel import mel_filterbank
    from sed_tpu_torch.stream_pool import StreamPool
    from scipy.io import wavfile

    t0 = time.perf_counter()
    bw, _, bf16_peak = peaks
    sr, hop, n_fft, n_bins = cfg.working_sample_rate, cfg.hop_size, cfg.nfft, cfg.freq_bins
    samples = sr * SECONDS
    n1 = 1 << ((n_fft.bit_length() - 1) // 2)
    n2 = n_fft // n1
    window = kernels.stft_window(cfg, dev)
    bands = kernels.mel_bands(cfg, dev)
    fb64 = torch.from_numpy(mel_filterbank(cfg, np.float64)).to(dev)
    total = dict.fromkeys(kernels.LAUNCHES, 0)

    def add(counts):
        for k, n in counts.items():
            total[k] += n

    # The artifact: cli.serve build at turbo, in the background from the start.
    torch.save({"model": model.state_dict()}, tmp / "model.pth")
    with open(tmp / "mean_std.pkl", "wb") as f:
        pickle.dump({"mean": mean, "std": std}, f)
    common = ["--ckpt", tmp / "model.pth", "--mean_std_file", tmp / "mean_std.pkl",
              "--device", DEVICE]
    build = start_cli(["sed_tpu_torch.cli.serve", "build", *common, "--batch", str(BATCH),
                       "--seconds", str(SECONDS), "--featurizer_precision", "turbo",
                       "--out", tmp / "turbo.aot"], tmp / "build.log")

    # ---- the kernels against their plain versions ----------------------------
    # Each kernel's error on tones, silence and a quiet signal; which mode it
    # ran on broadband noise, where every bin of a frame counts alike (on
    # tones a few bins carry a frame, too few to see the modes' gap).
    waves = make_signals(torch, BATCH, samples, sr, dev, 20)    # tones, silence, a quiet one
    g = torch.Generator(device=dev).manual_seed(21)
    noise = (0.3 * torch.randn(BATCH, samples, generator=g, device=dev)).contiguous()
    k3_rows = POOL_SLOTS * (-(-sr // hop) + 1)
    per = k3_rows // BATCH

    def tick_rows(x):
        rows = x[:, : n_fft + (per - 1) * hop].unfold(1, n_fft, hop)
        f32 = rows.reshape(-1, n_fft)[:k3_rows].clamp(-1, 1).contiguous()
        return {"float32": f32, "int16": (f32 * 32767).round().to(torch.int16)}

    rows, noise_rows = tick_rows(waves), tick_rows(noise)
    rows_f32 = rows["float32"]
    n_frames = 1 + samples // hop
    frames = BATCH * n_frames
    k1t, k3t = {}, {}
    plain = {}

    def plain_of(name, x, prec):
        """The plain version of K1t (``name`` "K1t ...") or K3t at ``prec``,
        kept for the modes next to it."""
        if (name, prec) not in plain:
            plain[name, prec] = (
                kernels.wave_dft_power_bf16_plain(x, window, hop, n_fft, prec)
                if name.startswith("K1t") else
                kernels.frames_dft_power_bf16_plain(x, window, n_fft, prec))
        return plain[name, prec]

    def against_plain(name, kernel, x, x_noise, prec, tol):
        """{max_abs_err, rel_err, mode_fraction: {neighbour: {fraction,
        gap}}} of ``kernel`` at ``prec``: on ``x`` against its plain version,
        on ``x_noise`` against the next modes', checked."""
        got = kernel(x, prec)
        want = plain_of(name, x, prec)
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"{name} at {prec}: shape")
        err = (got - want).abs()
        rel = float((err / want.amax(dim=-1, keepdim=True).clamp_min(1e-30)).max())
        check(rel <= tol, f"{name} at {prec} within {tol} x frame peak of its plain version")
        got, want = kernel(x_noise, prec), plain_of(name + " noise", x_noise, prec)
        peak = want.amax(dim=-1, keepdim=True)
        fractions = {}
        for nb in TIER_NEIGHBOURS[prec]:
            other = plain_of(name + " noise", x_noise, nb)
            t = kernels.mode_fraction(got, want, other, peak)
            t_next = kernels.mode_fraction(kernel(x_noise, nb), want, other, peak)
            gap = float(((other - want).abs() / peak).max())
            fractions[tier_tag(nb)] = {"fraction": t, "at_next": t_next, "gap": gap}
            check(abs(t) <= MODE_FRACTION_TOL,
                  f"{name} at {prec} runs its own mode, not {nb}'s (fraction {t:.3e})")
            check(t_next >= 1 - MODE_FRACTION_TOL,
                  f"{name} at {nb} lies nearer {nb}'s plain version than {prec}'s "
                  f"(fraction {t_next:.3e})")
        return {"max_abs_err": float(err.max()), "rel_err": rel, "mode_fraction": fractions}

    def k1t_kernel(x, prec):
        return kernels.wave_dft_power_bf16(x, window, hop, n_fft, prec)

    def k3t_kernel(x, prec):
        return kernels.frames_dft_power_bf16(x, window, n_fft, prec)

    for prec in TIER_PRECISIONS:
        tol = tier_rel_tol(kernels.tier_passes(prec))
        k1t[prec] = {**against_plain("K1t", k1t_kernel, waves, noise, prec, tol), "tol": tol}
        for tag in ("float32", "int16"):
            k3t[prec, tag] = against_plain(f"K3t {tag}", k3t_kernel, rows[tag],
                                           noise_rows[tag], prec, tol)
        log(f"[tiers] {tier_tag(prec)}: K1t ({BATCH}, {n_frames}, {n_bins}) vs plain max err / "
            f"frame peak {k1t[prec]['rel_err']:.3e}, K3t {k3_rows} rows float32 "
            f"{k3t[prec, 'float32']['rel_err']:.3e}, int16 {k3t[prec, 'int16']['rel_err']:.3e} "
            f"(tol {tol}); on noise, fraction towards the next modes (tol {MODE_FRACTION_TOL}): "
            f"K1t {fractions_text(k1t[prec])}; K3t float32 "
            f"{fractions_text(k3t[prec, 'float32'])}; int16 {fractions_text(k3t[prec, 'int16'])}")
    plain.clear()
    power = kernels.wave_stft_power(waves, window, hop, n_fft).reshape(-1, n_bins)
    tick_power = kernels.frames_stft_power(rows_f32, window, n_fft)
    mel_err, mel_fraction = {}, {}
    for mp in ("bf16x1", "bf16x3"):
        mel_fraction[mp] = {}
        for rows_tag, p in (("rows", power), ("tick", tick_power)):
            got = kernels.mel_log(p, bands, mp)
            torch.cuda.synchronize()
            want = kernels.mel_log_plain(p.double(), fb64, mp)
            db = float((got.double() - want).abs().max())
            mel_err[mp] = max(mel_err.get(mp, 0.0), db)
            for nb in MEL_NEIGHBOURS[mp]:
                other = kernels.mel_log_plain(p.double(), fb64, nb)
                t = kernels.mode_fraction(got, want, other)
                t_next = kernels.mode_fraction(kernels.mel_log(p, bands, nb), want, other)
                gap = float((other - want).abs().max())
                mel_fraction[mp][f"{nb or 'f32'}, {rows_tag}"] = {
                    "fraction": t, "at_next": t_next, "gap": gap}
                check(abs(t) <= MODE_FRACTION_TOL,
                      f"K2 at {mp} runs its own mode, not {nb or 'f32'}'s (fraction {t:.3e})")
                check(t_next >= 1 - MODE_FRACTION_TOL,
                      f"K2 at {nb or 'f32'} lies nearer its plain version than {mp}'s "
                      f"(fraction {t_next:.3e})")
        log(f"[tiers] K2 at mel_precision {mp} ({power.shape[0]} and {tick_power.shape[0]} "
            f"rows) vs its plain version: {mel_err[mp]:.3e} dB (tol {MEL_MODE_DB_TOL}); "
            f"fraction towards the next modes (tol {MODE_FRACTION_TOL}): "
            f"{fractions_text({'mode_fraction': mel_fraction[mp]})}")
        check(mel_err[mp] <= MEL_MODE_DB_TOL,
              f"K2's {mp} mode within {MEL_MODE_DB_TOL} dB of its plain version")

    # ---- fidelity: the tiers' log-mel against float64 ------------------------
    for tag, x in (("broadband noise", noise), ("sum of sines", waves)):
        ref = kernels.mel_log_plain(kernels.wave_stft_power_plain(
            x.double(), window.double(), hop, n_fft).reshape(-1, n_bins), fb64)
        for prec, name in TIER_NAMES.items():
            lm = kernels.logmel_waveform(x, cfg, precision=prec).reshape(-1, cfg.mel_bins)
            db = float((lm.double() - ref).abs().max())
            if tag == "broadband noise":
                log(f"[tiers] {name} log-mel vs float64 on {tag}: {db:.3e} dB "
                    f"(tol {TIER_DB_TOL[name]})")
                check(db <= TIER_DB_TOL[name], f"{name} within its dB bound on noise")
            else:
                log(f"[tiers] {name} log-mel vs float64 on {tag} (tones, silence, a quiet "
                    f"signal; report only): {db:.3e} dB")
    del noise, ref, lm

    # ---- the batch path: make_batch_predictor, cli.infer --batch -------------
    pcm = (make_signals(torch, BATCH, samples, sr, dev, 22) * 32767).round() \
        .to(torch.int16)[..., None]
    predict = {tier: make_batch_predictor(model, cfg, mean=mean, std=std,
                                          featurizer_precision=tier, device=DEVICE)
               for tier in ("parity", "fast", "turbo")}
    scores = {"parity": predict["parity"](pcm)}
    batch_launches = {}
    for tier in ("fast", "turbo"):
        kernels.reset_launch_counts()
        scores[tier] = predict[tier](pcm)
        torch.cuda.synchronize()
        batch_launches[tier] = dict(kernels.LAUNCHES)
        add(batch_launches[tier])
        check(batch_launches[tier]["wave_dft_power_bf16"] == 1
              and batch_launches[tier]["mel_log"] == 1
              and batch_launches[tier]["wave_stft_power"] == 0,
              f"the {tier} batch path launched K1t and K2 (and no K1)")
        diff = float((scores[tier] - scores["parity"]).abs().max())
        log(f"[tiers] make_batch_predictor at {tier}: launches {batch_launches[tier]}; scores "
            f"vs parity max {diff:.3e} (tol {TIER_SCORE_TOL[tier]})")
        check(diff <= TIER_SCORE_TOL[tier], f"{tier} scores within their bound of parity")
    wavs = []
    pcm_np = pcm.cpu().numpy()
    for i, secs in enumerate((60, 45)):
        path = tmp / f"tier{i}.wav"
        wavfile.write(path, sr, pcm_np[i, : secs * sr, 0])
        wavs.append(path)
    kernels.reset_launch_counts()
    infer_cli.main([*map(str, wavs), "--batch", "--no_plot", *map(str, common),
                    "--featurizer_precision", "fast", "--outputs_dir", str(tmp / "out_fast")])
    torch.cuda.synchronize()
    cli_launches = dict(kernels.LAUNCHES)
    add(cli_launches)
    check(cli_launches["wave_dft_power_bf16"] > 0 and cli_launches["wave_stft_power"] == 0,
          "cli.infer --batch --featurizer_precision fast launched K1t")
    from sed_tpu_torch.io.audio import read_multichannel_audio

    cli_err = 0.0
    for path in wavs:
        wav = read_multichannel_audio(str(path), target_fs=sr, cfg=cfg)
        want = predict["fast"](wav[None].astype(np.float32))[0].cpu().numpy()
        got = np.load(tmp / "out_fast" / f"{path.stem}_scores.npy")
        check(got.shape == want.shape, f"cli.infer fast {path.stem} shape")
        cli_err = max(cli_err, float(np.abs(got - want).max()))
    log(f"[tiers] cli.infer --batch --featurizer_precision fast on {len(wavs)} files "
        f"(in this process): launches {cli_launches}; max diff vs make_batch_predictor "
        f"{cli_err:.3e} (tol {SCORE_TOL})")
    check(cli_err <= SCORE_TOL, "cli.infer at fast matches make_batch_predictor")

    # ---- the per-file path at turbo -------------------------------------------
    kernels.reset_launch_counts()
    _, file_scores = infer_cli.predict_file(model, str(wavs[0]), cfg, mean, std,
                                            featurizer_precision="turbo", device=DEVICE)
    torch.cuda.synchronize()
    file_launches = dict(kernels.LAUNCHES)
    add(file_launches)
    check(file_launches["wave_dft_power_bf16"] == 1 and file_launches["mel_log"] == 1,
          "predict_file at turbo launched one K1t and one K2")
    file_err = float(np.abs(file_scores - scores["turbo"][0].cpu().numpy()).max())
    log(f"[tiers] predict_file at turbo on the 60 s file: launches {file_launches}; vs the "
        f"turbo batch path {file_err:.3e} (tol {SCORE_TOL})")
    check(file_err <= SCORE_TOL, "predict_file at turbo matches the batch path")

    # ---- the streaming pool at turbo ------------------------------------------
    chunk = sr
    audio = (make_signals(torch, POOL_SLOTS, TIER_POOL_SECONDS * sr, sr, dev, 23) * 32767
             ).round().to(torch.int16).cpu().numpy()
    clips = [audio[i] for i in range(POOL_SLOTS)]
    pool = StreamPool(model, cfg, slots=POOL_SLOTS, chunk_samples=chunk, mean=mean, std=std,
                      featurizer_precision="turbo", device=DEVICE)
    got_pool, pool_wall, pool_launches, pool_peak, ticks = drive_pool(
        torch, dev, pool, clips, chunk, seed=23)
    add(pool_launches)
    check(pool_launches["frames_dft_power_bf16"] > 0 and pool_launches["mel_log"] > 0
          and pool_launches["frames_stft_power"] == 0,
          "the turbo pool launched K3t and K2 (and no K3)")
    want_pool = score_all(torch, predict["turbo"], clips)
    pool_err = max(float(np.abs(g - w).max()) for g, w in zip(got_pool, want_pool))
    check(all(g.shape == w.shape for g, w in zip(got_pool, want_pool)), "pool frame counts")
    log(f"[tiers] {POOL_SLOTS}-slot StreamPool at turbo, {TIER_POOL_SECONDS} s streams, "
        f"{ticks} ticks: launches {pool_launches}; vs the turbo batch path {pool_err:.3e} "
        f"(tol {SCORE_TOL}); {POOL_SLOTS * TIER_POOL_SECONDS / pool_wall:.1f} audio-s per "
        f"wall-s, peak {pool_peak:.1f} MiB")
    check(pool_err <= SCORE_TOL, "the turbo pool matches the turbo batch path")
    del pool

    # ---- K2's bf16 modes through logmel_waveform ------------------------------
    kernels.reset_launch_counts()
    for mp in ("bf16x1", "bf16x3"):
        kernels.logmel_waveform(waves, cfg, mel_precision=mp)
    torch.cuda.synchronize()
    mel_launches = dict(kernels.LAUNCHES)
    add(mel_launches)
    check(mel_launches["mel_log_bf16"] == 2, "logmel_waveform(mel_precision=) launched K2's "
          "bf16 modes")

    # ---- the artifact at turbo: built by cli.serve, called here, run fresh ------
    finish_cli(build, tmp / "build.log", "cli.serve build --featurizer_precision turbo")
    built = json.loads([ln for ln in (tmp / "build.log").read_text().splitlines()
                        if ln.startswith("{")][-1])
    check(built["featurizer_precision"] == "turbo", "the build's JSON line names the tier")
    fresh = start_fresh_run(tmp, tmp / "turbo.aot", wavs, REPO, dict(os.environ), "turbo")
    call = ex.load_aot_fn((tmp / "turbo.aot").read_bytes())
    check(call.header["custom_ops"] == ["mel_log", "wave_dft_power_bf16"]
          and call.header["meta"].get("featurizer_precision") == "turbo",
          f"the turbo artifact holds {call.header['custom_ops']}, meta {call.header['meta']}")
    call(pcm)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    aot_scores = call(pcm)
    torch.cuda.synchronize()
    aot_launches = dict(kernels.LAUNCHES)
    add(aot_launches)
    check(aot_launches["wave_dft_power_bf16"] == 1 and aot_launches["mel_log"] == 1,
          "one call of the turbo artifact launched one K1t and one K2")
    aot_err = float((aot_scores - scores["turbo"]).abs().max())
    check(aot_err <= AOT_TOL, "the turbo artifact equals the eager turbo path")
    _, _, run_wall, run_out = finish_fresh_run(fresh)
    # The 60 s file is row 0 of the batch, whole: its scores are the call's.
    got = np.load(run_out / f"{wavs[0].stem}_scores.npy")
    check(got.shape == tuple(aot_scores[0].shape), "the fresh run's frame count")
    fresh_err = float(np.abs(got - aot_scores[0].cpu().numpy()).max())
    log(f"[tiers] cli.serve build --featurizer_precision turbo: {built['build_seconds']} s, "
        f"custom ops {call.header['custom_ops']}; a call's launches {aot_launches}, vs eager "
        f"{aot_err:.3e} (tol {AOT_TOL}); cli.serve run in a fresh process {run_wall:.1f} s, "
        f"its full-length file vs this process's call {fresh_err:.3e} (tol {SCORE_TOL})")
    check(fresh_err <= SCORE_TOL, "the fresh run of the turbo artifact matches")

    # ---- times -----------------------------------------------------------------
    signals = (pcm[..., 0].float() / 32768.0).contiguous()
    windowed = stft_ops.frame_signal(signals, n_fft, hop) * window      # (B, F, n_fft)
    consts = kernels._tier_constants(n_fft, dev)
    (w2r, w2i), (w1r, w1i), (twr, twi) = consts[2:]
    h = n1 // 2 + 1

    def bf(t, c):
        return [x.to(torch.bfloat16) for x in kernels.split_bf16(t, c)]

    def chain_fn(passes):
        """The same algorithm as cuBLAS bf16 matmuls of the same split operands
        (bf16 outputs: a timing yardstick, not a result)."""
        ci, co = (kernels._tier_chunks(p) for p in passes)
        xs = bf(windowed.reshape(-1, n2, n1), ci)
        a2r, a2i = bf(w2r, ci), bf(w2i, ci)
        b1r, b1i = bf(w1r[:, :h].contiguous(), co), bf(w1i[:, :h].contiguous(), co)
        terms = [kernels._TIER_TERMS[:p] for p in passes]

        def run():
            yr = sum(torch.matmul(a2r[i], xs[j]) for i, j in terms[0]).float()
            yi = sum(torch.matmul(a2i[i], xs[j]) for i, j in terms[0]).float()
            tr, ti = bf(yr * twr - yi * twi, co), bf(yr * twi + yi * twr, co)
            zr = sum(torch.matmul(tr[i], b1r[j]) - torch.matmul(ti[i], b1i[j])
                     for i, j in terms[1]).float()
            zi = sum(torch.matmul(tr[i], b1i[j]) + torch.matmul(ti[i], b1r[j])
                     for i, j in terms[1]).float()
            return zr * zr + zi * zi
        return run

    k1_ms = time_ms(torch, lambda: kernels.wave_stft_power(signals, window, hop, n_fft))
    lib_ms = time_ms(torch, lambda: torch.stft(
        signals, n_fft, hop, window=window, center=True, pad_mode="reflect",
        return_complex=True).abs() ** 2)
    tick_frames = rows_f32
    k3_ms = time_ms(torch, lambda: kernels.frames_stft_power(tick_frames, window, n_fft))
    k3_q_ms = time_ms(torch, lambda: kernels.frames_stft_power(tick_frames, window, n_fft),
                      calls=QUEUED)
    k3_lib_ms = time_ms(torch, lambda: torch.fft.rfft(tick_frames * window).abs() ** 2)
    tw_bytes = 8 * n1 * n2
    win_bytes = 4 * n_fft
    out_bytes = 4 * frames * n_bins
    times = {}
    for prec in TIER_PRECISIONS:
        passes = kernels.tier_passes(prec)
        ci, co = (kernels._tier_chunks(p) for p in passes)
        table_bytes = 2 * (ci * 2 * n2 * n2 + co * (n1 + 8) * 2 * n1) + tw_bytes + win_bytes
        # K1t's parts through the C calls: the split pass, the fused kernel,
        # and the tier GEMMs' route over the same frames as a yardstick.
        parts = tier_sweep._fused_parts(torch, kernels, signals, window, cfg, prec, dev)
        ops_frame = passes[0] * 4 * n2 * n2 * n1 + passes[1] * 8 * n2 * n1 * h
        t = {"ms": time_ms(torch, lambda: kernels.wave_dft_power_bf16(
                 signals, window, hop, n_fft, prec)),
             "plain_ms": time_ms(torch, lambda: kernels.wave_dft_power_bf16_plain(
                 signals, window, hop, n_fft, prec), reps=TIER_PLAIN_REPS, warmup=1),
             "matmul_chain_ms": time_ms(torch, chain_fn(passes), reps=TIER_PLAIN_REPS,
                                        warmup=1)}
        b_bytes, b_ops = 4 * signals.numel() + out_bytes + table_bytes, frames * ops_frame
        t_bytes, t_ops = b_bytes / bw * 1e3, b_ops / bf16_peak * 1e3
        t["bound_ms"], t["bound_by"] = max(t_bytes, t_ops), (
            "bytes" if t_bytes >= t_ops else "operations")
        t["tensor_gflop"] = b_ops / 1e9
        t["mbytes"] = b_bytes / 1e6
        t["split_ms"], t["fused_ms"] = parts[f"split_{sr}_{prec}"], parts[f"fused_{sr}_{prec}"]
        t["gemm_route_ms"] = parts.get(f"gemm_route_{sr}_{prec}")
        # K3t at the tick's rows: one call, and QUEUED calls in a row.
        r_bytes = 4 * tick_frames.numel() + 4 * k3_rows * n_bins + table_bytes
        r_ops = k3_rows * ops_frame
        r_bound = max(r_bytes / bw * 1e3, r_ops / bf16_peak * 1e3)
        t["rows"] = {
            "ms": time_ms(torch, lambda: kernels.frames_dft_power_bf16(
                tick_frames, window, n_fft, prec)),
            "queued_ms": time_ms(torch, lambda: kernels.frames_dft_power_bf16(
                tick_frames, window, n_fft, prec), calls=QUEUED),
            "plain_ms": time_ms(torch, lambda: kernels.frames_dft_power_bf16_plain(
                tick_frames, window, n_fft, prec), reps=TIER_PLAIN_REPS, warmup=1),
            "bound_ms": r_bound,
            "bound_by": "bytes" if r_bytes / bw >= r_ops / bf16_peak else "operations"}
        times[prec] = t
        log(f"[tiers] times {tier_tag(prec)}: K1t {t['ms']:.4f} ms (K1 {k1_ms:.4f}) | plain "
            f"{t['plain_ms']:.4f} ms | bf16 matmul chain {t['matmul_chain_ms']:.4f} ms | "
            f"torch.stft+abs^2 {lib_ms:.4f} ms | bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
            f"{t['mbytes']:.1f} MB, {t['tensor_gflop']:.1f} tensor GFLOP at "
            f"{bf16_peak / 1e12:.0f} TFLOP/s) | bound share {t['bound_ms'] / t['ms']:.1%}; the "
            f"split pass {t['split_ms']:.4f} ms, the fused kernel {t['fused_ms']:.4f} ms, the "
            f"tier GEMMs' route {t['gemm_route_ms']} ms; K3t "
            f"at {k3_rows} rows {t['rows']['ms']:.4f} ms, queued {t['rows']['queued_ms']:.4f} "
            f"ms (K3 {k3_ms:.4f} / {k3_q_ms:.4f}), plain {t['rows']['plain_ms']:.4f} ms, "
            f"bound {r_bound:.4f} ms")
    mel_times = {}
    nnz = bands.nnz
    for mp in ("bf16x1", "bf16x3"):
        mel_times[mp] = {
            "ms": time_ms(torch, lambda: kernels.mel_log(power, bands, mp)),
            "plain_ms": time_ms(torch, lambda: kernels.mel_log_plain(power, bands.dense, mp),
                                reps=TIER_PLAIN_REPS, warmup=1)}
    k2_ms = time_ms(torch, lambda: kernels.mel_log(power, bands))
    k2_lib_ms = time_ms(torch, lambda: 10.0 * torch.log10(
        torch.clamp(torch.matmul(power, bands.dense), min=1e-10)))
    k2_bytes = 4 * (power.numel() + power.shape[0] * bands.n_mels
                    + nnz + 5 * bands.n_segments + bands.n_mels + 1)
    k2_bound = k2_bytes / bw * 1e3
    log(f"[tiers] K2's bf16 modes at {power.shape[0]} rows: bf16x1 "
        f"{mel_times['bf16x1']['ms']:.4f} ms, bf16x3 {mel_times['bf16x3']['ms']:.4f} ms (f32 "
        f"{k2_ms:.4f} ms) | plain {mel_times['bf16x1']['plain_ms']:.4f} / "
        f"{mel_times['bf16x3']['plain_ms']:.4f} ms | matmul+log10 {k2_lib_ms:.4f} ms | bound "
        f"{k2_bound:.4f} ms (bytes)")
    batch_ms = {tier: time_ms(torch, lambda fn=fn: fn(pcm)) for tier, fn in predict.items()}
    log(f"[tiers] {smi}; the {BATCH} x {SECONDS} s batch (make_batch_predictor): " + ", ".join(
        f"{tier} {ms:.4f} ms ({BATCH * SECONDS / (ms / 1e3):.1f} audio-s/s)"
        for tier, ms in batch_ms.items()))
    log(f"[tiers] phase {time.perf_counter() - t0:.1f} s; launches of its runs {total}")

    source = "sed_tpu_torch/ops/csrc/featurizer.cu"
    fast = times["bf16x3"]
    entries = [
        {"name": "wave_dft_power_bf16",
         "kernel": f"tier_split_kernel<C1, false> (K1's framing) + tier_fused_kernel<P1, P2, "
                   f"{n1}> (wgmma, T in shared memory)",
         "route": "cuda", "source": source,
         "replaces": "sed_tpu/ops/pallas_featurizer.py:412",
         "launches": batch_launches["fast"]["wave_dft_power_bf16"],
         "precision": "bf16x3", "max_abs_err": k1t["bf16x3"]["max_abs_err"],
         "ms": fast["ms"], "plain_ms": fast["plain_ms"], "bound_ms": fast["bound_ms"],
         "bound_by": fast["bound_by"], "library_ms": lib_ms,
         "matmul_chain_ms": fast["matmul_chain_ms"], "k1_ms": k1_ms,
         "split_ms": fast["split_ms"], "fused_ms": fast["fused_ms"],
         "gemm_route_ms": fast["gemm_route_ms"],
         "cli_launches": cli_launches["wave_dft_power_bf16"],
         "file_launches": file_launches["wave_dft_power_bf16"],
         "artifact_launches": aot_launches["wave_dft_power_bf16"],
         "tiers": {tier_tag(p): {**k1t[p], **{k: v for k, v in times[p].items()
                                              if k != "rows"}} for p in TIER_PRECISIONS},
         "batch_ms": batch_ms},
        {"name": "frames_dft_power_bf16",
         "kernel": f"tier_split_kernel<C1, false> (K3's rows) + tier_fused_kernel<P1, P2, "
                   f"{n1}> (wgmma, T in shared memory)",
         "route": "cuda", "source": source,
         "replaces": "sed_tpu/ops/pallas_featurizer.py:283",
         "launches": pool_launches["frames_dft_power_bf16"], "precision": "bf16x1",
         "max_abs_err": k3t["bf16x1", "float32"]["max_abs_err"],
         "ms": times["bf16x1"]["rows"]["ms"], "plain_ms": times["bf16x1"]["rows"]["plain_ms"],
         "bound_ms": times["bf16x1"]["rows"]["bound_ms"],
         "bound_by": times["bf16x1"]["rows"]["bound_by"], "library_ms": k3_lib_ms,
         "queued_ms": times["bf16x1"]["rows"]["queued_ms"], "k3_ms": k3_ms,
         "k3_queued_ms": k3_q_ms,
         "tiers": {tier_tag(p): {**{k: v for k, v in k3t[p, "float32"].items()},
                                 **times[p]["rows"]} for p in TIER_PRECISIONS}},
        {"name": "mel_log_bf16",
         "kernel": "mel_log_kernel<R, kPasses> (K2's bf16x1 and bf16x3 product modes)",
         "route": "cuda", "source": source,
         "replaces": "sed_tpu/ops/pallas_featurizer.py:72",
         "launches": mel_launches["mel_log_bf16"], "precision": "bf16x3",
         "max_abs_err": mel_err["bf16x3"], "ms": mel_times["bf16x3"]["ms"],
         "plain_ms": mel_times["bf16x3"]["plain_ms"], "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": k2_lib_ms, "k2_ms": k2_ms,
         "modes": {mp: {"max_abs_err": mel_err[mp], "mode_fraction": mel_fraction[mp],
                        **mel_times[mp]} for mp in mel_times}},
    ]
    return entries, total


# 'fuse' and 'pack' at the tiers (phase 21) run phase 20's precisions and
# bounds; 'fuse' also runs these (precision, mel_precision) pairs: K5b at
# parity, K5t at a tier with a mel mode.
FUSE_MEL_RUNS = ((None, "bf16x1"), (None, "bf16x3"), ("bf16x1", "bf16x3"),
                 ("bf16x3", "bf16x1"))
FUSE_BIT_DB_TOL = 1e-5    # K5t / K5b against their two-kernel chain, if not bit for bit


def fusepack_phase(torch, cfg, dev, smi, peaks, lesions):
    """Phase 21: 'fuse' and 'pack' at the reduced tiers (see the module
    docstring).  ``peaks``: the card's (memory B/s, FP32 FLOP/s, dense bf16
    FLOP/s); ``lesions``: phase 1's lesion builds (K6t's three here).
    Returns (the kernels line's entries of K5t, K5b and K6t, the launch
    counts of the phase's runs, summed)."""
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.ops import stft as stft_ops
    from sed_tpu_torch.ops import tier_gemm_sweep as tier_sweep
    from sed_tpu_torch.ops.featurizer import ingest_to_f32
    from sed_tpu_torch.ops.mel import mel_filterbank

    t0 = time.perf_counter()
    bw, fp32_peak, bf16_peak = peaks
    sr, hop, n_fft, n_bins = cfg.working_sample_rate, cfg.hop_size, cfg.nfft, cfg.freq_bins
    m, n_mels = n_fft // 2, cfg.mel_bins
    samples = sr * SECONDS
    window = kernels.stft_window(cfg, dev)
    bands = kernels.mel_bands(cfg, dev)
    fb64 = torch.from_numpy(mel_filterbank(cfg, np.float64)).to(dev)
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    # Phase 3's batch (same seed), ingested to f32 on the card, as phase 9's.
    pcm = (make_signals(torch, BATCH, samples, sr, dev, 1) * 32767).round().to(torch.int16)
    waves = ingest_to_f32(pcm).contiguous()
    g = torch.Generator(device=dev).manual_seed(24)
    noise = (0.3 * torch.randn(BATCH, samples, generator=g, device=dev)).contiguous()
    n_frames = 1 + samples // hop
    frames = BATCH * n_frames

    def run(impl, prec, mel=None, x=None):
        """logmel_waveform on the batch, launch counts reset just before and
        read just after: exactly impl_kernels' row, once each."""
        kernels.reset_launch_counts()
        out = kernels.logmel_waveform(waves if x is None else x, cfg, impl=impl, precision=prec,
                                      mel_precision=mel)
        torch.cuda.synchronize()
        launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
        for k, n in kernels.LAUNCHES.items():
            total[k] += n
        names = kernels.impl_kernels(impl, prec, mel, n_fft=n_fft)
        check(out.shape == (BATCH, n_frames, n_mels), f"{impl} at {prec}, {mel}: shape")
        check(launched == dict.fromkeys(names, 1),
              f"logmel_waveform({impl!r}, {prec}, {mel}) launched {names} once each, not "
              f"{launched}")
        return out, launched

    # ---- K5t and K5b: 'fuse' against its two-kernel chain ------------------
    fuse_err, fuse_launches = {}, {}
    for prec, mel in [(p, None) for p in TIER_PRECISIONS] + list(FUSE_MEL_RUNS):
        out, launched = run("fuse", prec, mel)
        fuse_launches[prec, mel] = launched
        power = (kernels.wave_stft_power(waves, window, hop, n_fft) if prec is None
                 else kernels.wave_dft_power_bf16(waves, window, hop, n_fft, prec))
        two = kernels.mel_log(power.reshape(-1, n_bins), bands, mel).reshape(out.shape)
        torch.cuda.synchronize()
        differ = int((out != two).sum())
        db = float((out - two).abs().max())
        fuse_err[prec, mel] = db
        log(f"[fusepack] fuse at {tier_tag(prec) if prec else 'parity'}, mel_precision {mel}: "
            f"launches {launched}; vs {'K1' if prec is None else 'K1t'} then K2 {db:.3e} dB, "
            f"{differ} values differ (0 expected; tol {FUSE_BIT_DB_TOL})")
        check(db <= FUSE_BIT_DB_TOL, f"fuse at {prec}, {mel} equals its two-kernel chain")
    del power, two

    # ---- K6t: 'pack' against its plain version; its modes ---------------------
    k6t, pack_launches = {}, {}
    for prec in TIER_PRECISIONS:
        _, pack_launches[prec] = run("pack", prec)
        passes = kernels.tier_passes(prec)
        tol = tier_rel_tol(passes)
        zr, zi = kernels.wave_packed_fft_bf16(waves, window, hop, n_fft, prec)
        wr, wi = kernels.wave_packed_fft_bf16_plain(waves, window, hop, n_fft, prec)
        torch.cuda.synchronize()
        peak = torch.hypot(wr, wi).amax(dim=-1, keepdim=True).clamp_min(1e-30)
        err = max(float((z - w).abs().max()) for z, w in ((zr, wr), (zi, wi)))
        rel = max(float(((z - w).abs() / peak).max()) for z, w in ((zr, wr), (zi, wi)))
        del zr, zi, wr, wi
        check(rel <= tol, f"K6t at {prec} within {tol} x frame peak |Z| of its plain version")

        def packed(fn, p):
            return torch.cat(fn(noise, window, hop, n_fft, p), dim=-1)

        want = packed(kernels.wave_packed_fft_bf16_plain, prec)
        wr, wi = want.chunk(2, dim=-1)
        scale = torch.hypot(wr, wi).amax(dim=-1, keepdim=True)
        got = packed(kernels.wave_packed_fft_bf16, prec)
        fractions = {}
        for nb in TIER_NEIGHBOURS[prec]:
            other = packed(kernels.wave_packed_fft_bf16_plain, nb)
            t = kernels.mode_fraction(got, want, other, scale)
            t_next = kernels.mode_fraction(packed(kernels.wave_packed_fft_bf16, nb), want,
                                           other, scale)
            gap = float(((other - want).abs() / scale).max())
            fractions[tier_tag(nb)] = {"fraction": t, "at_next": t_next, "gap": gap}
            check(abs(t) <= MODE_FRACTION_TOL,
                  f"K6t at {prec} runs its own mode, not {nb}'s (fraction {t:.3e})")
            check(t_next >= 1 - MODE_FRACTION_TOL,
                  f"K6t at {nb} lies nearer {nb}'s plain version than {prec}'s "
                  f"(fraction {t_next:.3e})")
        del want, got, other, wr, wi
        k6t[prec] = {"max_abs_err": err, "rel_err": rel, "tol": tol,
                     "mode_fraction": fractions}
        log(f"[fusepack] pack at {tier_tag(prec)}: launches {pack_launches[prec]}; K6t 2 x "
            f"({BATCH}, {n_frames}, {m}) vs plain max err / frame peak |Z| {rel:.3e} (tol "
            f"{tol}); on noise, fraction towards the next modes (tol {MODE_FRACTION_TOL}): "
            f"{fractions_text(k6t[prec])}")

    # ---- fidelity: log-mel against float64 on broadband noise -----------------
    ref = kernels.mel_log_plain(kernels.wave_stft_power_plain(
        noise.double(), window.double(), hop, n_fft).reshape(-1, n_bins), fb64)
    fidelity = {}
    for impl in ("fuse", "pack"):
        for prec, name in TIER_NAMES.items():
            out, _ = run(impl, prec, x=noise)
            db = float((out.reshape(-1, n_mels).double() - ref).abs().max())
            fidelity[impl, name] = db
            log(f"[fusepack] {impl} at {name} log-mel vs float64 on broadband noise: "
                f"{db:.3e} dB (tol {TIER_DB_TOL[name]})")
            check(db <= TIER_DB_TOL[name], f"{impl} at {name} within its dB bound on noise")
    del ref, out

    # ---- times ----------------------------------------------------------------
    n1 = 1 << ((n_fft.bit_length() - 1) // 2)
    n2 = n_fft // n1
    p1 = 1 << ((m.bit_length() - 1) // 2)
    p2 = m // p1
    h = n1 // 2 + 1
    nnz = bands.nnz
    wave_b = 4 * waves.numel()
    mel_tables = 4 * (nnz + 5 * bands.n_segments + n_mels + 1)
    out_mel_b = 4 * frames * n_mels
    windowed = stft_ops.frame_signal(waves, n_fft, hop) * window
    packed_frames = torch.complex(windowed[..., 0::2].contiguous(),
                                  windowed[..., 1::2].contiguous())
    del windowed
    lib_fuse_ms = time_ms(torch, lambda: 10.0 * torch.log10(torch.clamp(torch.matmul(
        torch.stft(waves, n_fft, hop, window=window, center=True, pad_mode="reflect",
                   return_complex=True).abs().square().transpose(1, 2), bands.dense),
        min=1e-10)))
    lib_pack_ms = time_ms(torch, lambda: torch.fft.fft(packed_frames, dim=-1))
    del packed_frames
    parity = {impl: time_ms(torch, lambda impl=impl: kernels.logmel_waveform(
        waves, cfg, impl=impl)) for impl in ("fuse", "pack")}
    k1k2_ms = time_ms(torch, lambda: kernels.mel_log(kernels.wave_stft_power(
        waves, window, hop, n_fft).reshape(-1, n_bins), bands))

    def bound(n_bytes, t_ops):
        t_bytes = n_bytes / bw * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    times = {}
    for prec in TIER_PRECISIONS:
        passes = kernels.tier_passes(prec)
        ci, co = (kernels._tier_chunks(p) for p in passes)
        k5t_tables = 2 * (ci * 2 * n2 * n2 + co * (n1 + 8) * 2 * n1) + 8 * n1 * n2 + 4 * n_fft
        k6t_tables = 2 * (ci * 2 * p2 * 2 * p2 + co * 2 * p1 * 2 * p1) + 8 * p1 * p2 + 4 * n_fft
        k5t_ops = frames * (passes[0] * 4 * n2 * n2 * n1 + passes[1] * 8 * n2 * n1 * h)
        k6t_ops = frames * (passes[0] * 8 * p2 * p2 * p1 + passes[1] * 8 * p2 * p1 * p1)
        t = {
            "k5t_ms": time_ms(torch, lambda: kernels.wave_stft_mel_log_bf16(
                waves, window, hop, n_fft, bands, prec)),
            "k1t_k2_ms": time_ms(torch, lambda: kernels.mel_log(kernels.wave_dft_power_bf16(
                waves, window, hop, n_fft, prec).reshape(-1, n_bins), bands)),
            "k6t_ms": time_ms(torch, lambda: kernels.wave_packed_fft_bf16(
                waves, window, hop, n_fft, prec)),
            "pack_ms": time_ms(torch, lambda: kernels.logmel_waveform(
                waves, cfg, impl="pack", precision=prec)),
            "k5t_tensor_gflop": k5t_ops / 1e9, "k6t_tensor_gflop": k6t_ops / 1e9}
        t["k5t_bound_ms"], t["k5t_bound_by"] = bound(
            wave_b + k5t_tables + mel_tables + out_mel_b,
            k5t_ops / bf16_peak * 1e3 + 2 * nnz * frames / fp32_peak * 1e3)
        t["k6t_bound_ms"], t["k6t_bound_by"] = bound(
            wave_b + k6t_tables + 2 * 4 * frames * m, k6t_ops / bf16_peak * 1e3)
        times[prec] = t
        log(f"[fusepack] {smi}; times {tier_tag(prec)}: K5t {t['k5t_ms']:.4f} ms | K1t then K2 "
            f"{t['k1t_k2_ms']:.4f} ms | bound {t['k5t_bound_ms']:.4f} ms ({t['k5t_bound_by']}: "
            f"{t['k5t_tensor_gflop']:.1f} tensor GFLOP) | share {t['k5t_bound_ms'] / t['k5t_ms']:.1%}"
            f"; K6t {t['k6t_ms']:.4f} ms | bound {t['k6t_bound_ms']:.4f} ms ({t['k6t_bound_by']}: "
            f"{t['k6t_tensor_gflop']:.1f} tensor GFLOP) | share "
            f"{t['k6t_bound_ms'] / t['k6t_ms']:.1%}; pack (K6t, unpack, K2) {t['pack_ms']:.4f} ms")
    fast = times["bf16x3"]
    # K5t's first launch, the split pass, on its own through its C call.
    split_ms = tier_sweep._fused_parts(torch, kernels, waves, window, cfg, "bf16x3",
                                       dev)[f"split_{cfg.working_sample_rate}_bf16x3"]
    fast["k5t_plain_ms"] = time_ms(torch, lambda: kernels.wave_stft_mel_log_bf16_plain(
        waves, window, hop, n_fft, bands.dense, "bf16x3"), reps=TIER_PLAIN_REPS, warmup=1)
    fast["k6t_plain_ms"] = time_ms(torch, lambda: kernels.wave_packed_fft_bf16_plain(
        waves, window, hop, n_fft, "bf16x3"), reps=TIER_PLAIN_REPS, warmup=1)
    k5b = {mel: {"ms": time_ms(torch, lambda mel=mel: kernels.wave_stft_mel_log(
                     waves, window, hop, n_fft, bands, mel)),
                 "k1_k2b_ms": time_ms(torch, lambda mel=mel: kernels.mel_log(
                     kernels.wave_stft_power(waves, window, hop, n_fft).reshape(-1, n_bins),
                     bands, mel))}
           for mel in ("bf16x1", "bf16x3")}
    k5b["bf16x3"]["plain_ms"] = time_ms(torch, lambda: kernels.wave_stft_mel_log_plain(
        waves, window, hop, n_fft, bands.dense, "bf16x3"), reps=TIER_PLAIN_REPS, warmup=1)
    k5_ms = time_ms(torch, lambda: kernels.wave_stft_mel_log(waves, window, hop, n_fft, bands))
    win_nnz = int(torch.count_nonzero(window))
    k5b_bound = bound(wave_b + 4 * (n_fft + 4 * m) + mel_tables + out_mel_b,
                      (fft_ops(frames, m, win_nnz) + 3 * 2 * nnz * frames) / fp32_peak * 1e3)
    log(f"[fusepack] {smi}; times: K5b bf16x1 {k5b['bf16x1']['ms']:.4f} ms (K1 then K2b "
        f"{k5b['bf16x1']['k1_k2b_ms']:.4f}), bf16x3 {k5b['bf16x3']['ms']:.4f} ms (K1 then K2b "
        f"{k5b['bf16x3']['k1_k2b_ms']:.4f}; plain {k5b['bf16x3']['plain_ms']:.4f}) | K5 "
        f"{k5_ms:.4f} ms | bound at bf16x3 {k5b_bound[0]:.4f} ms ({k5b_bound[1]}); plain at "
        f"fast: K5t {fast['k5t_plain_ms']:.4f} ms, K6t {fast['k6t_plain_ms']:.4f} ms; "
        f"yardsticks: torch.stft+abs^2+matmul+log10 {lib_fuse_ms:.4f} ms, torch.fft.fft of the "
        f"packed frames {lib_pack_ms:.4f} ms; parity fuse {parity['fuse']:.4f} ms, pack "
        f"{parity['pack']:.4f} ms, K1 then K2 {k1k2_ms:.4f} ms")
    # K6t through its C call, whole and without each part (wrong results,
    # timing only: each part's share).
    zr = torch.empty(BATCH, n_frames, m, device=dev)
    zi = torch.empty_like(zr)
    stream = torch.cuda.current_stream(dev).cuda_stream
    k6t_parts = {}
    for prec in TIER_NAMES:
        passes = kernels.tier_passes(prec)
        plan = kernels.packed_plan(p1, *passes)
        tab1, tab2, tw = kernels._packed_tables(m, *(kernels._tier_chunks(p) for p in passes),
                                                dev)

        def k6t_raw(fn):
            err = fn(waves.data_ptr(), window.data_ptr(), tab1.data_ptr(), tab2.data_ptr(),
                     tw.data_ptr(), zr.data_ptr(), zi.data_ptr(), frames, samples, n_frames,
                     hop, m.bit_length() - 1, *passes, dev.index, stream)
            check(err == 0, f"K6t raw launch ({err})")

        parts = {"ms": time_ms(torch, lambda: k6t_raw(kernels._library().sed_tier_packed_fft))}
        for name in ("K6t frame split", "K6t table copies", "K6t drain"):
            parts[f"without_{name[4:].replace(' ', '_')}_ms"] = time_ms(
                torch, lambda fn=lesions[name]: k6t_raw(fn))
        k6t_parts[TIER_NAMES[prec]] = {"plan": plan, **parts}
    del zr, zi, tab1, tab2, tw
    log(f"[fusepack] {smi}; K6t through its C call, whole and without each part (wrong "
        f"results, timing only): {k6t_parts}")
    log(f"[fusepack] {smi}; phase {time.perf_counter() - t0:.1f} s; launches of its runs "
        f"{ {k: v for k, v in total.items() if v} }")

    source = "sed_tpu_torch/ops/csrc/featurizer.cu"
    mel_runs = [k for k in fuse_launches if k[0] is not None]
    entries = [
        {"name": "wave_stft_mel_log_bf16",
         "kernel": f"K1t's route, then K2: tier_split_kernel<C1, false> + "
                   f"tier_fused_kernel<P1, P2, {n1}> + mel_log_kernel<R, kPasses>",
         "route": "cuda", "source": source,
         "replaces": "sed_tpu/ops/pallas_featurizer.py:550",
         "launches": sum(fuse_launches[k].get("wave_stft_mel_log_bf16", 0) for k in mel_runs),
         "precision": "bf16x3", "max_abs_err": max(fuse_err[k] for k in mel_runs),
         "ms": fast["k5t_ms"], "plain_ms": fast["k5t_plain_ms"],
         "bound_ms": fast["k5t_bound_ms"], "bound_by": fast["k5t_bound_by"],
         "library_ms": lib_fuse_ms, "k1t_k2_ms": fast["k1t_k2_ms"],
         "split_ms": split_ms,
         "fidelity_db": {name: fidelity["fuse", name] for name in TIER_NAMES.values()},
         "tiers": {tier_tag(p): {k: v for k, v in times[p].items() if k.startswith(
             ("k5t", "k1t"))} | {"vs_two_kernels_db": fuse_err[p, None]}
                   for p in TIER_PRECISIONS}},
        {"name": "wave_stft_mel_log_mel_bf16",
         "kernel": "wave_stft_mel_log_kernel<LOG2_M> (mel_log_row_mode: K2's product modes)",
         "route": "cuda", "source": source,
         "replaces": "sed_tpu/ops/pallas_featurizer.py:550",
         "launches": sum(fuse_launches[k].get("wave_stft_mel_log_mel_bf16", 0)
                         for k in fuse_launches),
         "precision": "mel bf16x3", "max_abs_err": max(fuse_err[None, mel]
                                                      for mel in ("bf16x1", "bf16x3")),
         "ms": k5b["bf16x3"]["ms"], "plain_ms": k5b["bf16x3"]["plain_ms"],
         "bound_ms": k5b_bound[0], "bound_by": k5b_bound[1], "library_ms": lib_fuse_ms,
         "k5_ms": k5_ms, "modes": k5b},
        {"name": "wave_packed_fft_bf16",
         "kernel": "tier_packed_fft_kernel<N1, P1, P2> (wgmma, bulk-copied tables, "
                   "persistent CTAs)",
         "route": "cuda", "source": source,
         "replaces": "sed_tpu/ops/pallas_featurizer.py:882",
         "launches": sum(pack_launches[p].get("wave_packed_fft_bf16", 0)
                         for p in TIER_PRECISIONS),
         "precision": "bf16x3", "max_abs_err": k6t["bf16x3"]["max_abs_err"],
         "ms": fast["k6t_ms"], "plain_ms": fast["k6t_plain_ms"],
         "bound_ms": fast["k6t_bound_ms"], "bound_by": fast["k6t_bound_by"],
         "library_ms": lib_pack_ms, "parity_pack_ms": parity["pack"],
         "parity_fuse_ms": parity["fuse"],
         "fidelity_db": {name: fidelity["pack", name] for name in TIER_NAMES.values()},
         "parts": k6t_parts,
         "tiers": {tier_tag(p): {**k6t[p], **{k: v for k, v in times[p].items()
                                              if k.startswith(("k6t", "pack"))}}
                   for p in TIER_PRECISIONS}},
    ]
    return entries, total


# Phase 22: n_fft 65536 and 131072.  The rates whose n_fft passes 32768, and
# the clip length of the few-frame checks of every new instance.
WIDE_RATES = (96000, 192000)
WIDE_HOPS = 5        # hops a signal in the instance checks: 6 frames, edges and interior
WIDE_POOL_SLOTS, WIDE_POOL_SECONDS = 4, 8    # the tick at 96 kHz: a few ticks of a few slots
WIDE_TIER_CHECKS = ("bf16x3", "bf16x1", "bf16x6")


def wide_phase(torch, dev, smi, peaks):
    """Phase 22: n_fft 65536 and 131072 (96 and 192 kHz) through every
    featurizer kernel (see the module docstring).  ``peaks``: the card's
    (memory B/s, FP32 FLOP/s, dense bf16 FLOP/s).  Returns (the kernels
    line's entries of the new instances, the launch counts of the phase's
    main-path runs, summed)."""
    from sed_tpu_torch.configs import SpectrogramConfig
    from sed_tpu_torch.inference import make_batch_predictor
    from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.ops import stft as stft_ops
    from sed_tpu_torch.ops.featurizer import ingest_to_f32, logmel_features_batch, logmel_frames
    from sed_tpu_torch.ops.mel import mel_filterbank
    from sed_tpu_torch.stream_pool import StreamPool

    t0 = time.perf_counter()
    bw, fp32_peak, bf16_peak = peaks
    total = dict.fromkeys(kernels.LAUNCHES, 0)

    def counted(fn, *args, **kw):
        """fn(...) with the launch counts reset just before and read just
        after; returns (its result, the kernels it launched)."""
        kernels.reset_launch_counts()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
        for k, n in kernels.LAUNCHES.items():
            total[k] += n
        return out, launched

    def bound(n_bytes, t_ops):
        t_bytes = n_bytes / bw * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    # ---- every new instance at both rates against its plain version ------------
    checks = {}
    for sr in WIDE_RATES:
        cfg = SpectrogramConfig(working_sample_rate=sr)
        hop, n_fft, n_bins = cfg.hop_size, cfg.nfft, cfg.freq_bins
        window, bands = kernels.stft_window(cfg, dev), kernels.mel_bands(cfg, dev)
        fb64 = torch.from_numpy(mel_filterbank(cfg, np.float64)).to(dev)
        g = torch.Generator(device=dev).manual_seed(22)
        n = WIDE_HOPS * hop + 777
        tone = torch.sin(2 * np.pi * 1000.0 * torch.arange(n, device=dev) / sr)
        waves = (0.3 * torch.randn(2, n, generator=g, device=dev) + 0.4 * tone).contiguous()
        got = {}
        power = kernels.wave_stft_power(waves, window, hop, n_fft)
        ref = kernels.wave_stft_power_plain(waves.double(), window, hop, n_fft)
        torch.cuda.synchronize()
        peak = ref.amax(dim=-1, keepdim=True).clamp_min(1e-30)
        got["K1 / peak"] = float(((power.double() - ref).abs() / peak).max())
        check(got["K1 / peak"] <= K1_REL_TOL, f"K1 at n_fft {n_fft} within 1e-5 x frame peak")
        rows = power.reshape(-1, n_bins)
        mel = kernels.mel_log(rows, bands)
        got["K1 then K2 dB"] = float((mel.double() - kernels.mel_log_plain(
            ref.reshape(-1, n_bins), fb64)).abs().max())
        check(got["K1 then K2 dB"] <= DB_TOL, f"K1 then K2 at n_fft {n_fft} within 1e-4 dB")
        for mel_precision in (None, "bf16x1", "bf16x3"):
            fused = kernels.wave_stft_mel_log(waves, window, hop, n_fft, bands, mel_precision)
            chain = kernels.mel_log(rows, bands, mel_precision)
            differ = int((fused.reshape(chain.shape) != chain).sum())
            got[f"K5 {mel_precision} values differing from K1 then K2"] = differ
            check(differ == 0, f"K5 at n_fft {n_fft}, mel {mel_precision} equals K1 then K2")
        frames = waves[:, : n_fft + 2 * hop].unfold(1, n_fft, hop).reshape(-1, n_fft).contiguous()
        pcm16 = (frames.clamp(-1, 1) * 32767).round().to(torch.int16)
        for tag, x in (("float32", frames), ("int16", pcm16)):
            want = kernels.frames_stft_power_plain(x, window, n_fft, dtype=torch.float64)
            err = (kernels.frames_stft_power(x, window, n_fft).double() - want).abs()
            got[f"K3 {tag} / peak"] = float((err / want.amax(dim=-1, keepdim=True)).max())
            check(got[f"K3 {tag} / peak"] <= K1_REL_TOL, f"K3 {tag} at n_fft {n_fft}")
        zr, zi = kernels.wave_packed_fft(waves, window, hop, n_fft)
        wr, wi = kernels.wave_packed_fft_plain(waves.double(), window, hop, n_fft)
        zpeak = torch.hypot(wr, wi).amax(dim=-1, keepdim=True)
        got["K6 / peak"] = max(float(((z.double() - w).abs() / zpeak).max())
                               for z, w in ((zr, wr), (zi, wi)))
        check(got["K6 / peak"] <= K1_REL_TOL, f"K6 at n_fft {n_fft} within 1e-5 x peak |Z|")
        for prec in WIDE_TIER_CHECKS:
            tol = tier_rel_tol(kernels.tier_passes(prec))
            t_pow = kernels.wave_dft_power_bf16(waves, window, hop, n_fft, prec)
            want = kernels.wave_dft_power_bf16_plain(waves, window, hop, n_fft, prec)
            got[f"K1t {tier_tag(prec)} / peak"] = rel = float(
                ((t_pow - want).abs() / want.amax(dim=-1, keepdim=True)).max())
            check(rel <= tol, f"K1t at {prec}, n_fft {n_fft}, within {tol}")
            fused = kernels.wave_stft_mel_log_bf16(waves, window, hop, n_fft, bands, prec)
            differ = int((fused.reshape(-1, bands.n_mels)
                          != kernels.mel_log(t_pow.reshape(-1, n_bins), bands)).sum())
            got[f"K5t {tier_tag(prec)} values differing from K1t then K2"] = differ
            check(differ == 0, f"K5t at {prec}, n_fft {n_fft} equals K1t then K2")
            rows_t = kernels.frames_dft_power_bf16(frames, window, n_fft, prec)
            want_t = kernels.frames_dft_power_bf16_plain(frames, window, n_fft, prec)
            got[f"K3t {tier_tag(prec)} / peak"] = rel = float(
                ((rows_t - want_t).abs() / want_t.amax(dim=-1, keepdim=True)).max())
            check(rel <= tol, f"K3t at {prec}, n_fft {n_fft}, within {tol}")
            zr, zi = kernels.wave_packed_fft_bf16(waves, window, hop, n_fft, prec)
            wr, wi = kernels.wave_packed_fft_bf16_plain(waves, window, hop, n_fft, prec)
            zpeak = torch.hypot(wr, wi).amax(dim=-1, keepdim=True)
            got[f"K6t {tier_tag(prec)} / peak"] = rel = max(
                float(((z - w).abs() / zpeak).max()) for z, w in ((zr, wr), (zi, wi)))
            check(rel <= tol, f"K6t at {prec}, n_fft {n_fft}, within {tol}")
        torch.cuda.synchronize()
        checks[sr] = got
        log(f"[wide] {sr} Hz, n_fft {n_fft} ({kernels.stockham_plan(n_fft)['cluster']} CTAs a "
            f"frame), {2} x {WIDE_HOPS} hops: " + "; ".join(
                f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}" for k, v in got.items()))
        del waves, power, ref, rows, mel, frames, zr, zi, wr, wi, t_pow, want

    # ---- 96 kHz at 16 x 60 s: the predictor, every impl, the kernels' times ------
    sr = WIDE_RATES[0]
    cfg = SpectrogramConfig(working_sample_rate=sr)
    hop, n_fft, n_bins, n_mels = cfg.hop_size, cfg.nfft, cfg.freq_bins, cfg.mel_bins
    m = n_fft // 2
    samples = sr * SECONDS
    window, bands = kernels.stft_window(cfg, dev), kernels.mel_bands(cfg, dev)
    fb64 = torch.from_numpy(mel_filterbank(cfg, np.float64)).to(dev)
    model = CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL,
                          generator=torch.Generator().manual_seed(0))
    cpu_model = copy.deepcopy(model)
    pcm = (make_signals(torch, BATCH, samples, sr, dev, 1) * 32767).round().to(
        torch.int16)[..., None]
    with torch.inference_mode():
        feats = logmel_features_batch(pcm[:4], cfg)
    mean = feats.mean(dim=(0, 1, 2)).cpu().numpy()
    std = feats.std(dim=(0, 1, 2)).cpu().numpy()
    predict = make_batch_predictor(model, cfg, mean=mean, std=std, device=DEVICE)
    scores, predictor_launches = counted(predict, pcm)
    check(predictor_launches == {"wave_stft_power": 1, "mel_log": 1},
          f"the 96 kHz predictor launched K1 and K2 once each, not {predictor_launches}")
    check(bool(torch.isfinite(scores).all()) and bool(((scores >= 0) & (scores <= 1)).all()),
          "96 kHz scores finite, in [0, 1]")
    cpu_predict = make_batch_predictor(cpu_model, cfg, mean=mean, std=std, device="cpu")
    cpu_err = float((scores[:1].cpu() - cpu_predict(pcm[:1].cpu())).abs().max())
    check(cpu_err <= SCORE_TOL, "96 kHz clip 0 matches the CPU path")
    del cpu_model, cpu_predict
    waves = ingest_to_f32(pcm[..., 0]).contiguous()
    frames = waves.shape[0] * (1 + samples // hop)
    ref = kernels.wave_stft_power_plain(waves.double(), window, hop, n_fft)
    power = kernels.wave_stft_power(waves, window, hop, n_fft)
    k1_abs = float((power.double() - ref).abs().max())
    rows = power.reshape(-1, n_bins)
    k2_db = float((kernels.mel_log(rows, bands).double()
                   - kernels.mel_log_plain(ref.reshape(-1, n_bins), fb64)).abs().max())
    check(k2_db <= DB_TOL, "96 kHz K1 then K2 within 1e-4 dB of the float64 chain")
    del ref
    impl_runs = {}
    for impl, prec in (("fuse", None), ("pack", None), ("roll", "bf16x3"), ("fuse", "bf16x3"),
                       ("pack", "bf16x3")):
        out, launched = counted(kernels.logmel_waveform, waves, cfg, impl=impl, precision=prec)
        names = kernels.impl_kernels(impl, prec, n_fft=n_fft)
        want = dict.fromkeys(names, 1)
        if "tier_inner" in names:   # K1t's tier GEMMs (n1 256): each kernel once a frame group
            plan = kernels.gemm_plan(n_fft, False, kernels.tier_passes(prec), frames)
            for k in kernels.GEMM_KERNELS:
                want[k] = len(kernels.frame_groups(frames, plan["group_frames"]))
        check(launched == want,
              f"logmel_waveform({impl!r}, {prec}) at 96 kHz launched {names} ({want}), not "
              f"{launched}")
        check(out.shape == (BATCH, 1 + samples // hop, n_mels) and bool(torch.isfinite(out).all()),
              f"{impl} at {prec}, 96 kHz: finite log-mel")
        impl_runs[impl, prec] = launched
    # The tick at 96 kHz: a few slots, a few ticks, against the batch path.
    clips = [pcm[i, : WIDE_POOL_SECONDS * sr, 0].cpu().numpy() for i in range(WIDE_POOL_SLOTS)]
    pool = StreamPool(model, cfg, slots=WIDE_POOL_SLOTS, chunk_samples=sr, mean=mean, std=std,
                      device=DEVICE)
    got_pool, _, pool_launches, _, ticks = drive_pool(torch, dev, pool, clips, sr, seed=22)
    for k, n in pool_launches.items():
        total[k] += n
    want = score_all(torch, predict, clips)
    pool_err = max(float(np.abs(g - w).max()) for g, w in zip(got_pool, want))
    check(all(g.shape == w.shape for g, w in zip(got_pool, want)), "96 kHz pool frame counts")
    check(pool_err <= SCORE_TOL, "96 kHz pool scores match make_batch_predictor")
    check(pool_launches["frames_stft_power"] > 0 and pool_launches["mel_log"] > 0,
          "K3 and K2 ran in the 96 kHz tick")
    del pool
    tick_rows = (torch.from_numpy(np.stack(clips)[:, : n_fft + 4 * hop]).to(dev).float()
                 / 32768.0).unfold(1, n_fft, hop).reshape(-1, n_fft).contiguous()
    lm = logmel_frames(tick_rows, cfg)
    k3_db = float((lm.double() - kernels.mel_log_plain(kernels.frames_stft_power_plain(
        tick_rows, window, n_fft, dtype=torch.float64), fb64)).abs().max())
    check(k3_db <= DB_TOL, "96 kHz logmel_frames within 1e-4 dB of float64")
    log(f"[wide] 96 kHz, {BATCH} x {SECONDS} s: predictor launches {predictor_launches}, clip 0 "
        f"vs CPU {cpu_err:.3e} (tol {SCORE_TOL}); K1 max abs err {k1_abs:.3e}, K1 then K2 vs "
        f"float64 {k2_db:.3e} dB; impls launched {dict((f'{i} {p}', l) for (i, p), l in impl_runs.items())}; "
        f"{WIDE_POOL_SLOTS}-slot pool, {ticks} ticks: launches {pool_launches}, vs batch "
        f"{pool_err:.3e}; logmel_frames ({tick_rows.shape[0]} rows) vs float64 {k3_db:.3e} dB")

    # ---- times at 96 kHz, 16 x 60 s ------------------------------------------
    win_nnz = int(torch.count_nonzero(window))
    nnz = bands.nnz
    wave_b = 4 * waves.numel()
    fft_tables = 4 * (n_fft + 2 * (kernels.stockham_plan(n_fft)["cluster"] + 1) * 16384 + 2 * m)
    mel_tables = 4 * (nnz + 5 * bands.n_segments + n_mels + 1)
    power_b = 4 * rows.numel()
    out_mel_b = 4 * frames * n_mels
    windowed = stft_ops.frame_signal(waves, n_fft, hop) * window
    packed = torch.complex(windowed[..., 0::2].contiguous(), windowed[..., 1::2].contiguous())
    del windowed
    t = {}
    t["k1"] = time_ms(torch, lambda: kernels.wave_stft_power(waves, window, hop, n_fft))
    t["k1_plain"] = time_ms(torch, lambda: kernels.wave_stft_power_plain(waves, window, hop, n_fft))
    t["k1_lib"] = time_ms(torch, lambda: torch.stft(
        waves, n_fft, hop, window=window, center=True, pad_mode="reflect",
        return_complex=True).abs() ** 2)
    t["k2"] = time_ms(torch, lambda: kernels.mel_log(rows, bands))
    t["k2_plain"] = time_ms(torch, lambda: kernels.mel_log_plain(rows, bands.dense))
    t["k2_lib"] = time_ms(torch, lambda: 10.0 * torch.log10(
        torch.clamp(torch.matmul(rows, bands.dense), min=1e-10)))
    t["k5"] = time_ms(torch, lambda: kernels.wave_stft_mel_log(waves, window, hop, n_fft, bands))
    t["k5_plain"] = time_ms(torch, lambda: kernels.wave_stft_mel_log_plain(
        waves, window, hop, n_fft, bands.dense))
    t["fuse_lib"] = time_ms(torch, lambda: 10.0 * torch.log10(torch.clamp(torch.matmul(
        torch.stft(waves, n_fft, hop, window=window, center=True, pad_mode="reflect",
                   return_complex=True).abs().square().transpose(1, 2), bands.dense),
        min=1e-10)))
    t["k6"] = time_ms(torch, lambda: kernels.wave_packed_fft(waves, window, hop, n_fft))
    t["k6_plain"] = time_ms(torch, lambda: kernels.wave_packed_fft_plain(waves, window, hop, n_fft))
    t["k6_lib"] = time_ms(torch, lambda: torch.fft.fft(packed, dim=-1))
    del packed
    # K3 is timed at the 32-slot tick's rows (POOL_SLOTS x the frames a 1 s
    # chunk adds: 10 frames of each of the batch's 16 clips), as phase 2
    # times it at 48 kHz; the 4-slot pool's rows above only check it.
    k3_rows = POOL_SLOTS * (-(-sr // hop) + 1)
    per = k3_rows // BATCH
    k3_frames = waves[:, : n_fft + (per - 1) * hop].unfold(1, n_fft, hop).reshape(
        -1, n_fft)[:k3_rows].contiguous()
    k3_rows = k3_frames.shape[0]
    k3_want = kernels.frames_stft_power_plain(k3_frames, window, n_fft, dtype=torch.float64)
    k3_rel = float(((kernels.frames_stft_power(k3_frames, window, n_fft).double() - k3_want).abs()
                    / k3_want.amax(dim=-1, keepdim=True).clamp(min=1e-30)).max())
    check(k3_rel <= K1_REL_TOL, f"96 kHz K3 at the tick's {k3_rows} rows within 1e-5 x peak")
    del k3_want
    t["k3"] = time_ms(torch, lambda: kernels.frames_stft_power(k3_frames, window, n_fft),
                      calls=QUEUED)
    t["k3_plain"] = time_ms(torch, lambda: kernels.frames_stft_power_plain(k3_frames, window, n_fft),
                            calls=QUEUED)
    t["k3_lib"] = time_ms(torch, lambda: torch.fft.rfft(k3_frames * window).abs() ** 2,
                          calls=QUEUED)
    t["k1t"] = time_ms(torch, lambda: kernels.wave_dft_power_bf16(waves, window, hop, n_fft,
                                                                  "bf16x3"))
    t["k1t_plain"] = time_ms(torch, lambda: kernels.wave_dft_power_bf16_plain(
        waves, window, hop, n_fft, "bf16x3"), reps=TIER_PLAIN_REPS, warmup=1)
    t["k5t"] = time_ms(torch, lambda: kernels.wave_stft_mel_log_bf16(
        waves, window, hop, n_fft, bands, "bf16x3"))
    t["k6t"] = time_ms(torch, lambda: kernels.wave_packed_fft_bf16(waves, window, hop, n_fft,
                                                                   "bf16x3"))
    t["k6t_plain"] = time_ms(torch, lambda: kernels.wave_packed_fft_bf16_plain(
        waves, window, hop, n_fft, "bf16x3"), reps=TIER_PLAIN_REPS, warmup=1)
    with torch.inference_mode():
        t["predictor"] = time_ms(torch, lambda: predict(pcm))
    audio_s = BATCH * SECONDS / (t["predictor"] / 1e3)
    del rows, power
    n1 = 1 << ((n_fft.bit_length() - 1) // 2)
    n2 = n_fft // n1
    p1 = 1 << ((m.bit_length() - 1) // 2)
    p2 = m // p1
    k1_bound = bound(wave_b + fft_tables + power_b, fft_ops(frames, m, win_nnz) / fp32_peak * 1e3)
    k2_bound = bound(power_b + out_mel_b + mel_tables, 2 * nnz * frames / fp32_peak * 1e3)
    k5_bound = bound(wave_b + fft_tables + mel_tables + out_mel_b,
                     (fft_ops(frames, m, win_nnz) + 2 * nnz * frames) / fp32_peak * 1e3)
    k6_bound = bound(wave_b + fft_tables + 8 * frames * m,
                     fft_ops(frames, m, win_nnz, unpack=False) / fp32_peak * 1e3)
    k3_bound = bound(4 * (k3_frames.numel() + k3_rows * (m + 1)) + fft_tables,
                     fft_ops(k3_rows, m, win_nnz) / fp32_peak * 1e3)
    k1t_ops = frames * 3 * (4 * n2 * n2 * n1 + 8 * n2 * n1 * (n1 // 2 + 1))
    k1t_bound = bound(wave_b + power_b, k1t_ops / bf16_peak * 1e3)
    k5t_bound = bound(wave_b + mel_tables + out_mel_b,
                      k1t_ops / bf16_peak * 1e3 + 2 * nnz * frames / fp32_peak * 1e3)
    k6t_ops = frames * 3 * (8 * p2 * p2 * p1 + 8 * p2 * p1 * p1)
    k6t_bound = bound(wave_b + 8 * frames * m, k6t_ops / bf16_peak * 1e3)
    log(f"[wide] {smi}; 96 kHz, {BATCH} x {SECONDS} s ({frames} frames), CUDA-event medians: "
        f"K1 {t['k1']:.4f} ms (bound {k1_bound[0]:.4f}, {k1_bound[1]}: "
        f"{(wave_b + power_b) / 1e6:.1f} MB of waveform and power; plain {t['k1_plain']:.4f}, "
        f"torch.stft+abs^2 {t['k1_lib']:.4f}) | K2 {t['k2']:.4f} (bound {k2_bound[0]:.4f}; plain "
        f"{t['k2_plain']:.4f}, matmul+log10 {t['k2_lib']:.4f}) | K5 {t['k5']:.4f} (bound "
        f"{k5_bound[0]:.4f}; the torch.stft chain {t['fuse_lib']:.4f}) | K6 {t['k6']:.4f} (bound "
        f"{k6_bound[0]:.4f}; torch.fft.fft {t['k6_lib']:.4f}) | K3 at {k3_rows} rows (peak-relative "
        f"err {k3_rel:.3e}), queued "
        f"{t['k3']:.4f} (bound {k3_bound[0]:.4f}; rfft+abs^2 {t['k3_lib']:.4f}) | fast: K1t "
        f"{t['k1t']:.4f} (bound {k1t_bound[0]:.4f}), K5t {t['k5t']:.4f}, K6t {t['k6t']:.4f} "
        f"(bound {k6t_bound[0]:.4f}) | predictor {t['predictor']:.4f} ms, {audio_s:.1f} "
        f"audio-s/s")
    log(f"[wide] phase {time.perf_counter() - t0:.1f} s; launches of its runs "
        f"{ {k: v for k, v in total.items() if v} }")

    source = "sed_tpu_torch/ops/csrc/featurizer.cu"

    def entry(name, kernel, replaces, launches, err, ms, plain_ms, bnd, library_ms, **extra):
        return {"name": name, "kernel": kernel, "route": "cuda", "source": source,
                "replaces": f"sed_tpu/ops/pallas_featurizer.py:{replaces}", "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": library_ms, "n_fft": n_fft,
                "sample_rate": sr, **extra}

    cluster = kernels.stockham_plan(n_fft)["cluster"]
    fuse, pack = impl_runs["fuse", None], impl_runs["pack", None]
    plan = kernels.launch_plan(n_fft, bands.n_segments)

    def route_launches(impl, name):
        """The launches of ``name``'s route in the 'impl' run at fast: its
        own where it is one launch, its kernels' (each once) summed where
        it is more (n1 256: the tier GEMMs, K5t then K2)."""
        return sum(impl_runs[impl, "bf16x3"].get(k, 0) for k in plan[name]["kernels"])
    got, fast = checks[sr], tier_tag("bf16x3")
    return [
        entry("wave_stft_power", f"wave_stft_power_kernel<15> (a cluster of {cluster} CTAs)",
              412, predictor_launches["wave_stft_power"], k1_abs, t["k1"], t["k1_plain"],
              k1_bound, t["k1_lib"], checks=checks),
        entry("mel_log", f"mel_log_kernel<R> at {n_bins} bins", 72,
              predictor_launches["mel_log"], k2_db, t["k2"], t["k2_plain"], k2_bound, t["k2_lib"]),
        entry("frames_stft_power", f"frames_stft_power_kernel<15, Pair> (a cluster of {cluster})",
              283, pool_launches["frames_stft_power"], k3_db, t["k3"], t["k3_plain"], k3_bound,
              t["k3_lib"], rows=k3_rows, queued=QUEUED),
        entry("wave_stft_mel_log", f"wave_stft_mel_log_kernel<15> (a cluster of {cluster})", 550,
              fuse["wave_stft_mel_log"], got["K5 None values differing from K1 then K2"],
              t["k5"], t["k5_plain"], k5_bound, t["fuse_lib"]),
        entry("wave_packed_fft", f"wave_packed_fft_kernel<15> (a cluster of {cluster})", 882,
              pack["wave_packed_fft"], got["K6 / peak"], t["k6"], t["k6_plain"], k6_bound,
              t["k6_lib"]),
        entry("wave_dft_power_bf16", plan["wave_dft_power_bf16"]["instance"], 412,
              route_launches("roll", "wave_dft_power_bf16"), got[f"K1t {fast} / peak"],
              t["k1t"], t["k1t_plain"], k1t_bound, t["k1_lib"], precision="bf16x3",
              tier_route=plan["wave_dft_power_bf16"]["route"]),
        entry("wave_stft_mel_log_bf16", plan["wave_stft_mel_log_bf16"]["instance"], 550,
              route_launches("fuse", "wave_stft_mel_log_bf16"),
              got[f"K5t {fast} values differing from K1t then K2"], t["k5t"],
              t["k1t_plain"] + t["k2_plain"], k5t_bound, t["fuse_lib"], precision="bf16x3",
              tier_route=plan["wave_stft_mel_log_bf16"]["route"]),
        entry("wave_packed_fft_bf16", f"tier_packed_fft_kernel<{p1}, 3, 3> (wgmma)", 882,
              impl_runs["pack", "bf16x3"]["wave_packed_fft_bf16"], got[f"K6t {fast} / peak"],
              t["k6t"], t["k6t_plain"], k6t_bound, t["k6_lib"], precision="bf16x3"),
    ], total


# Phase 23: the ends of the n_fft range.  The rates of the new sizes checked
# (1 kHz: the tiers' small end, n_fft 1024; 384 kHz, 768 kHz, 1.536 MHz: n_fft
# 2^18, 2^19, 2^20), the seconds of the two clips of every impl's checks, the
# rates timed at 16 x 60 s (and the tier GEMMs' small end), the rates whose
# 16 x 60 s batch is checked (clip by clip against float64 and the plain
# versions), the reps of the tier GEMMs there (up to 0.2 s a call) and the
# clips their plain versions are timed on.
RANGE_RATES = (1000, 384000, 768000, 1536000)
RANGE_CHECK_SECONDS = 10
RANGE_TIMED_RATES = (384000, 1536000)
RANGE_SMALL_RATE = 1000   # the tier GEMMs' small end, timed at 16 x 60 s too
RANGE_BATCH_RATES = (384000, 768000, 1536000)   # 768 kHz: R = 4 sub-rows, checked untimed
RANGE_TIER_CHECKS = ("bf16x3", "bf16x1", "bf16x6")
RANGE_SLOW_REPS = 3
RANGE_PLAIN_CLIPS = 1
RANGE_SCORE_TOL = 1e-5    # the 384 kHz predictor's first and last clips against the CPU path


def cross_pass_plain(torch, z, table, n_fft):
    """Plain version of fft_cross_pass_kernel: packed frames z (frames, m)
    complex -> (frames, R, 2^16) sub-rows, the R-point DFT over the frame's
    chunks (R = 8: radix 4, then radix 2 of each, sub-row r1 + 4 r2) times
    the cross table (``stft.cross_pass_twiddles``, complex)."""
    f, m = z.shape
    M = 1 << 16
    r_count = m // M
    if r_count <= 4:
        return torch.fft.fft(z.view(f, r_count, M), dim=1) * table[: m].view(r_count, M)
    y = torch.fft.fft(z.view(f, 4, 2 * M), dim=1) * table[: m].view(4, 2 * M)
    u = torch.fft.fft(y.view(f, 4, 2, M), dim=2)
    u[:, :, 1] *= table[m:]
    return u.transpose(1, 2).reshape(f, r_count, M)


def range_phase(torch, dev, smi, peaks):
    """Phase 23: the ends of the n_fft range through every featurizer kernel
    (see the module docstring).  ``peaks``: the card's (memory B/s, FP32
    FLOP/s, dense bf16 FLOP/s).  Returns (the kernels line's entries, the
    launch counts of the phase's main-path runs, summed)."""
    from sed_tpu_torch.configs import SpectrogramConfig
    from sed_tpu_torch.inference import make_batch_predictor
    from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.ops import stft as stft_ops
    from sed_tpu_torch.ops.featurizer import ingest_to_f32, logmel_features_batch
    from sed_tpu_torch.ops.mel import mel_filterbank

    t0 = time.perf_counter()
    bw, fp32_peak, bf16_peak = peaks
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    fast = "bf16x3"

    def counted(fn, *args, **kw):
        """fn(...) with the launch counts reset just before and read just
        after; returns (its result, the kernels it launched)."""
        kernels.reset_launch_counts()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
        for k, n in kernels.LAUNCHES.items():
            total[k] += n
        return out, launched

    def bound(n_bytes, t_ops):
        t_bytes = n_bytes / bw * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def rel_peak(got, want):
        want = want.double()
        peak = want.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
        return float(((got.double() - want).abs() / peak).max())

    def rel_z(pair, want_pair):
        peak = torch.hypot(*(w.double() for w in want_pair)).amax(dim=-1, keepdim=True)
        return max(float(((g.double() - w.double()).abs() / peak).max())
                   for g, w in zip(pair, want_pair))

    # ---- every impl and every kernel at each new size, 2 x 10 s of noise -------
    checks, impl_runs = {}, {}
    for sr in RANGE_RATES:
        cfg = SpectrogramConfig(working_sample_rate=sr)
        hop, n_fft, n_bins = cfg.hop_size, cfg.nfft, cfg.freq_bins
        window, bands = kernels.stft_window(cfg, dev), kernels.mel_bands(cfg, dev)
        fb64 = torch.from_numpy(mel_filterbank(cfg, np.float64)).to(dev)
        g = torch.Generator(device=dev).manual_seed(23)
        waves = (0.3 * torch.randn(2, RANGE_CHECK_SECONDS * sr, generator=g, device=dev))
        got = {}
        ref = kernels.wave_stft_power_plain(waves.double(), window, hop, n_fft)
        chain64 = kernels.mel_log_plain(ref.reshape(-1, n_bins), fb64).reshape(2, -1, cfg.mel_bins)
        impls = [i for i in kernels.IMPL_KERNELS
                 if not (i in ("rollraw", "rolledge") and n_fft < 32768)
                 and not (i == "fuse" and n_fft % 2048)]
        worst = {None: 0.0, fast: 0.0}
        for impl in impls:
            for prec in (None, fast):
                out, launched = counted(kernels.logmel_waveform, waves, cfg, impl=impl,
                                        precision=prec)
                names = kernels.impl_kernels(impl, prec, n_fft=n_fft)
                check(launched == dict.fromkeys(names, 1),
                      f"logmel_waveform({impl!r}, {prec}) at n_fft {n_fft} launched {names} once "
                      f"each, not {launched}")
                err = float((out.double() - chain64).abs().max())
                tol = DB_TOL if prec is None else TIER_DB_TOL["fast"]
                check(err <= tol, f"{impl} at {prec}, n_fft {n_fft}: {err:.3e} dB of float64")
                worst[prec] = max(worst[prec], err)
                impl_runs[sr, impl, prec] = launched
        got["parity dB (worst impl)"], got["fast dB (worst impl)"] = worst[None], worst[fast]
        power = kernels.wave_stft_power(waves, window, hop, n_fft)
        got["K1 / peak"] = rel_peak(power, ref)
        check(got["K1 / peak"] <= K1_REL_TOL, f"K1 at n_fft {n_fft} within 1e-5 x frame peak")
        rows = power.reshape(-1, n_bins)
        for mel_precision in (None, "bf16x1", "bf16x3"):
            fused = kernels.wave_stft_mel_log(waves, window, hop, n_fft, bands, mel_precision)
            differ = int((fused.reshape(-1, bands.n_mels)
                          != kernels.mel_log(rows, bands, mel_precision)).sum())
            got[f"K5 {mel_precision} values differing from K1 then K2"] = differ
            check(differ == 0, f"K5 at n_fft {n_fft}, mel {mel_precision} equals K1 then K2")
        frames = waves[:, : n_fft + 2 * hop].unfold(1, n_fft, hop).reshape(-1, n_fft).contiguous()
        pcm16 = (frames.clamp(-1, 1) * 32767).round().to(torch.int16)
        for tag, x in (("float32", frames), ("int16", pcm16)):
            got[f"K3 {tag} / peak"] = rel_peak(kernels.frames_stft_power(x, window, n_fft),
                                               kernels.frames_stft_power_plain(
                                                   x, window, n_fft, dtype=torch.float64))
            check(got[f"K3 {tag} / peak"] <= K1_REL_TOL, f"K3 {tag} at n_fft {n_fft}")
        got["K6 / peak"] = rel_z(kernels.wave_packed_fft(waves, window, hop, n_fft),
                                 kernels.wave_packed_fft_plain(waves.double(), window, hop, n_fft))
        check(got["K6 / peak"] <= K1_REL_TOL, f"K6 at n_fft {n_fft} within 1e-5 x peak |Z|")
        del ref, chain64
        for prec in RANGE_TIER_CHECKS:
            tol = tier_rel_tol(kernels.tier_passes(prec))
            t_pow = kernels.wave_dft_power_bf16(waves, window, hop, n_fft, prec)
            want = kernels.wave_dft_power_bf16_plain(waves, window, hop, n_fft, prec)
            got[f"K1t {tier_tag(prec)} / peak"] = rel = rel_peak(t_pow, want)
            check(rel <= tol, f"K1t at {prec}, n_fft {n_fft}, within {tol}")
            got[f"K3t {tier_tag(prec)} / peak"] = rel = rel_peak(
                kernels.frames_dft_power_bf16(frames, window, n_fft, prec),
                kernels.frames_dft_power_bf16_plain(frames, window, n_fft, prec))
            check(rel <= tol, f"K3t at {prec}, n_fft {n_fft}, within {tol}")
            got[f"K6t {tier_tag(prec)} / peak"] = rel = rel_z(
                kernels.wave_packed_fft_bf16(waves, window, hop, n_fft, prec),
                kernels.wave_packed_fft_bf16_plain(waves, window, hop, n_fft, prec))
            check(rel <= tol, f"K6t at {prec}, n_fft {n_fft}, within {tol}")
            if n_fft >= 2048:
                fused = kernels.wave_stft_mel_log_bf16(waves, window, hop, n_fft, bands, prec)
                differ = int((fused.reshape(-1, bands.n_mels)
                              != kernels.mel_log(t_pow.reshape(-1, n_bins), bands)).sum())
                got[f"K5t {tier_tag(prec)} values differing from K1t then K2"] = differ
                check(differ == 0, f"K5t at {prec}, n_fft {n_fft} equals K1t then K2")
            if prec in TIER_NAMES:   # fast and turbo: nearer its own mode than the next
                nb = TIER_NEIGHBOURS[prec][0]
                peak = want.amax(dim=-1, keepdim=True)
                neighbour = kernels.wave_dft_power_bf16_plain(waves, window, hop, n_fft, nb)
                own = kernels.mode_fraction(t_pow, want, neighbour, peak)
                at_next = kernels.mode_fraction(kernels.wave_dft_power_bf16(
                    waves, window, hop, n_fft, nb), want, neighbour, peak)
                got[f"K1t {tier_tag(prec)} mode fraction (run at {nb})"] = (own, at_next)
                check(abs(own) <= MODE_FRACTION_TOL and at_next >= 1 - MODE_FRACTION_TOL,
                      f"K1t at {prec}, n_fft {n_fft}, runs its own mode")
                zw = kernels.wave_packed_fft_bf16_plain(waves, window, hop, n_fft, prec)
                zn = kernels.wave_packed_fft_bf16_plain(waves, window, hop, n_fft, nb)
                zg = kernels.wave_packed_fft_bf16(waves, window, hop, n_fft, prec)
                za = kernels.wave_packed_fft_bf16(waves, window, hop, n_fft, nb)
                zpeak = torch.hypot(*zw).amax(dim=-1, keepdim=True)
                own = kernels.mode_fraction(torch.cat(zg), torch.cat(zw), torch.cat(zn),
                                            torch.cat([zpeak, zpeak]))
                at_next = kernels.mode_fraction(torch.cat(za), torch.cat(zw), torch.cat(zn),
                                                torch.cat([zpeak, zpeak]))
                got[f"K6t {tier_tag(prec)} mode fraction (run at {nb})"] = (own, at_next)
                check(abs(own) <= MODE_FRACTION_TOL and at_next >= 1 - MODE_FRACTION_TOL,
                      f"K6t at {prec}, n_fft {n_fft}, runs its own mode")
        torch.cuda.synchronize()
        checks[sr] = got
        log(f"[range] {sr} Hz, n_fft {n_fft} ({kernels.launch_plan(n_fft)['wave_stft_power']['route']}"
            f" FFT, {kernels.launch_plan(n_fft)['wave_dft_power_bf16']['route']} tiers), 2 x "
            f"{RANGE_CHECK_SECONDS} s of noise, {len(impls)} impls at parity and fast: " + "; ".join(
                f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}" for k, v in got.items()))
        del waves, power, rows, frames, pcm16, t_pow, want

    # ---- 384 kHz, 16 x 60 s: the predictor ------------------------------------
    sr = 384000
    cfg = SpectrogramConfig(working_sample_rate=sr)
    model = CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL,
                          generator=torch.Generator().manual_seed(0))
    cpu_model = copy.deepcopy(model)
    samples = sr * SECONDS
    pcm = (make_signals(torch, BATCH, samples, sr, dev, 1) * 32767).round().to(
        torch.int16)[..., None]
    with torch.inference_mode():
        feats = logmel_features_batch(pcm[:2], cfg)
    mean = feats.mean(dim=(0, 1, 2)).cpu().numpy()
    std = feats.std(dim=(0, 1, 2)).cpu().numpy()
    del feats
    predict = make_batch_predictor(model, cfg, mean=mean, std=std, device=DEVICE)
    scores, predictor_launches = counted(predict, pcm)
    names = kernels.impl_kernels("roll", n_fft=cfg.nfft)
    check(predictor_launches == dict.fromkeys(names, 1),
          f"the 384 kHz predictor launched {names} once each, not {predictor_launches}")
    check(bool(torch.isfinite(scores).all()) and bool(((scores >= 0) & (scores <= 1)).all()),
          "384 kHz scores finite, in [0, 1]")
    cpu_predict = make_batch_predictor(cpu_model, cfg, mean=mean, std=std, device="cpu")
    ends = [0, BATCH - 1]   # the last clip's frames lie at the batch's largest offsets
    cpu_err = float((scores[ends].cpu() - cpu_predict(pcm[ends].cpu())).abs().max())
    check(cpu_err <= RANGE_SCORE_TOL,
          f"384 kHz clips 0 and {BATCH - 1} within {RANGE_SCORE_TOL} of the CPU path")
    with torch.inference_mode():
        predictor_ms = time_ms(torch, lambda: predict(pcm), reps=5, warmup=1)
    log(f"[range] 384 kHz predictor, {BATCH} x {SECONDS} s: launches {predictor_launches}, clips "
        f"0 and {BATCH - 1} vs CPU {cpu_err:.3e} (tol {RANGE_SCORE_TOL}), {predictor_ms:.4f} ms, "
        f"{BATCH * SECONDS / (predictor_ms / 1e3):.1f} audio-s/s")
    del cpu_model, cpu_predict, predict, model, scores
    waves_384 = ingest_to_f32(pcm[..., 0]).contiguous()
    del pcm

    # ---- times at 384 kHz and 2^20, 16 x 60 s ----------------------------------
    times = {}
    for sr in RANGE_TIMED_RATES:
        cfg = SpectrogramConfig(working_sample_rate=sr)
        hop, n_fft, n_bins, n_mels = cfg.hop_size, cfg.nfft, cfg.freq_bins, cfg.mel_bins
        m = n_fft // 2
        samples = sr * SECONDS
        # 384 kHz: the predictor's batch, ingested; 2^20: make_signals'.
        waves = waves_384 if sr == 384000 else make_signals(torch, BATCH, samples, sr, dev, 1)
        waves_384 = None
        window, bands = kernels.stft_window(cfg, dev), kernels.mel_bands(cfg, dev)
        frames = waves.shape[0] * (1 + samples // hop)
        win_nnz = int(torch.count_nonzero(window))
        t = {"frames": frames}
        slow = dict(reps=RANGE_SLOW_REPS, warmup=1)
        t["k1"] = time_ms(torch, lambda: kernels.wave_stft_power(waves, window, hop, n_fft), **slow)
        t["k1_plain"] = time_ms(torch, lambda: kernels.wave_stft_power_plain(waves, window, hop,
                                                                             n_fft), **slow)
        t["k1_lib"] = time_ms(torch, lambda: torch.stft(
            waves, n_fft, hop, window=window, center=True, pad_mode="reflect",
            return_complex=True).abs() ** 2, **slow)
        rows = kernels.wave_stft_power(waves, window, hop, n_fft).reshape(-1, n_bins)
        t["k2"] = time_ms(torch, lambda: kernels.mel_log(rows, bands), **slow)
        t["k2_plain"] = time_ms(torch, lambda: kernels.mel_log_plain(rows, bands.dense), **slow)
        t["k2_lib"] = time_ms(torch, lambda: 10.0 * torch.log10(
            torch.clamp(torch.matmul(rows, bands.dense), min=1e-10)), **slow)
        del rows
        t["k5"] = time_ms(torch, lambda: kernels.wave_stft_mel_log(waves, window, hop, n_fft,
                                                                   bands), **slow)
        t["fuse_lib"] = time_ms(torch, lambda: 10.0 * torch.log10(torch.clamp(torch.matmul(
            torch.stft(waves, n_fft, hop, window=window, center=True, pad_mode="reflect",
                       return_complex=True).abs().square().transpose(1, 2), bands.dense),
            min=1e-10)), **slow)
        t["k6"] = time_ms(torch, lambda: kernels.wave_packed_fft(waves, window, hop, n_fft), **slow)
        t["k6_plain"] = time_ms(torch, lambda: kernels.wave_packed_fft_plain(waves, window, hop,
                                                                             n_fft), **slow)
        windowed = stft_ops.frame_signal(waves, n_fft, hop) * window
        packed = torch.complex(windowed[..., 0::2].contiguous(), windowed[..., 1::2].contiguous())
        del windowed
        t["k6_lib"] = time_ms(torch, lambda: torch.fft.fft(packed, dim=-1), **slow)
        del packed
        t["k1t"] = time_ms(torch, lambda: kernels.wave_dft_power_bf16(waves, window, hop, n_fft,
                                                                      fast), **slow)
        t["k5t"] = time_ms(torch, lambda: kernels.wave_stft_mel_log_bf16(
            waves, window, hop, n_fft, bands, fast), **slow)
        t["k6t"] = time_ms(torch, lambda: kernels.wave_packed_fft_bf16(waves, window, hop, n_fft,
                                                                       fast), **slow)
        part = waves[:RANGE_PLAIN_CLIPS]
        t["plain_frames"] = part.shape[0] * (1 + samples // hop)
        t["k1t_plain"] = time_ms(torch, lambda: kernels.wave_dft_power_bf16_plain(
            part, window, hop, n_fft, fast), reps=2, warmup=1)
        t["k5t_plain"] = time_ms(torch, lambda: kernels.wave_stft_mel_log_bf16_plain(
            part, window, hop, n_fft, bands.dense, fast), reps=2, warmup=1)
        t["k6t_plain"] = time_ms(torch, lambda: kernels.wave_packed_fft_bf16_plain(
            part, window, hop, n_fft, fast), reps=2, warmup=1)
        t["k5_plain"] = time_ms(torch, lambda: kernels.wave_stft_mel_log_plain(
            waves, window, hop, n_fft, bands.dense), **slow)
        wave_b, power_b = 4 * waves.numel(), 4 * frames * (m + 1)
        out_mel_b, nnz = 4 * frames * n_mels, bands.nnz
        mel_tables = 4 * (nnz + 5 * bands.n_segments + n_mels + 1)
        fft_tables = 4 * (n_fft + 2 * 5 * 16384 + 2 * m + 2 * m)   # pass, sub-row, unpack
        n1 = 1 << ((n_fft.bit_length() - 1) // 2)
        n2 = n_fft // n1
        p1 = 1 << ((m.bit_length() - 1) // 2)
        p2 = m // p1
        k1t_ops = frames * 3 * (4 * n2 * n2 * n1 + 8 * n2 * n1 * (n1 // 2 + 1))
        k6t_ops = frames * 3 * (8 * p2 * p2 * p1 + 8 * p2 * p1 * p1)
        t["bounds"] = {
            "k1": bound(wave_b + fft_tables + power_b, fft_ops(frames, m, win_nnz) / fp32_peak * 1e3),
            "k2": bound(power_b + out_mel_b + mel_tables, 2 * nnz * frames / fp32_peak * 1e3),
            "k5": bound(wave_b + fft_tables + mel_tables + out_mel_b,
                        (fft_ops(frames, m, win_nnz) + 2 * nnz * frames) / fp32_peak * 1e3),
            "k6": bound(wave_b + fft_tables + 8 * frames * m,
                        fft_ops(frames, m, win_nnz, unpack=False) / fp32_peak * 1e3),
            "k1t": bound(wave_b + power_b, k1t_ops / bf16_peak * 1e3),
            "k5t": bound(wave_b + mel_tables + out_mel_b,
                         k1t_ops / bf16_peak * 1e3 + 2 * nnz * frames / fp32_peak * 1e3),
            "k6t": bound(wave_b + 8 * frames * m, k6t_ops / bf16_peak * 1e3)}
        if sr == 384000:   # each launch of the routes on its own, through its C call
            t["parts"] = route_parts(torch, kernels, waves, window, hop, n_fft, bound, peaks)
        t["gemm_parts"] = gemm_parts(torch, kernels, waves, window, hop, n_fft, bound, peaks)
        t["batch"] = batch_checks(torch, kernels, waves, cfg, window, bands, fast)
        times[sr] = t
        bnd = t["bounds"]
        log(f"[range] {smi}; {sr} Hz (n_fft {n_fft}), {BATCH} x {SECONDS} s ({frames} frames), "
            f"CUDA-event medians: K1 {t['k1']:.4f} ms (bound {bnd['k1'][0]:.4f}, {bnd['k1'][1]}; "
            f"plain {t['k1_plain']:.4f}, torch.stft+abs^2 {t['k1_lib']:.4f}) | K2 {t['k2']:.4f} "
            f"(bound {bnd['k2'][0]:.4f}; plain {t['k2_plain']:.4f}, matmul+log10 {t['k2_lib']:.4f})"
            f" | K5 {t['k5']:.4f} (bound {bnd['k5'][0]:.4f}; plain {t['k5_plain']:.4f}, the "
            f"torch.stft chain {t['fuse_lib']:.4f}) | K6 {t['k6']:.4f} (bound {bnd['k6'][0]:.4f}; "
            f"plain {t['k6_plain']:.4f}, torch.fft.fft {t['k6_lib']:.4f}) | fast: K1t "
            f"{t['k1t']:.4f} (bound {bnd['k1t'][0]:.4f}), K5t {t['k5t']:.4f} (bound "
            f"{bnd['k5t'][0]:.4f}), K6t {t['k6t']:.4f} (bound {bnd['k6t'][0]:.4f}); their plain "
            f"versions on {t['plain_frames']} frames: {t['k1t_plain']:.4f}, {t['k5t_plain']:.4f}, "
            f"{t['k6t_plain']:.4f}")
        log(f"[range] {sr} Hz, the timed batch itself ({frames} frames), clip by clip: " + "; ".join(
            f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}" for k, v in t["batch"].items()))
        if "parts" in t:
            log("[range] 384 kHz, each launch on its own: " + "; ".join(
                f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, bound {v['bound_ms']:.4f} "
                f"{v['bound_by']}, err {v['max_abs_err']:.3e})" for k, v in t["parts"].items()))
        log(f"[range] {sr} Hz, the tier GEMMs' launches on their own: " + gemm_parts_text(
            t["gemm_parts"]))
        del waves

    # ---- the tier GEMMs' small end, 1 kHz, 16 x 60 s: K1t and K6t at fast --------
    sr = RANGE_SMALL_RATE
    cfg = SpectrogramConfig(working_sample_rate=sr)
    hop, n_fft, n_bins = cfg.hop_size, cfg.nfft, cfg.freq_bins
    m = n_fft // 2
    waves = make_signals(torch, BATCH, sr * SECONDS, sr, dev, 1)
    window = kernels.stft_window(cfg, dev)
    frames = waves.shape[0] * (1 + waves.shape[1] // hop)
    part = waves[:RANGE_PLAIN_CLIPS]
    windowed = stft_ops.frame_signal(waves, n_fft, hop) * window
    packed = torch.complex(windowed[..., 0::2].contiguous(), windowed[..., 1::2].contiguous())
    del windowed
    t = {"frames": frames, "plain_frames": part.shape[0] * (1 + waves.shape[1] // hop),
         "k1t": time_ms(torch, lambda: kernels.wave_dft_power_bf16(waves, window, hop, n_fft,
                                                                   fast)),
         "k6t": time_ms(torch, lambda: kernels.wave_packed_fft_bf16(waves, window, hop, n_fft,
                                                                    fast)),
         "k1t_plain": time_ms(torch, lambda: kernels.wave_dft_power_bf16_plain(
             part, window, hop, n_fft, fast), reps=2, warmup=1),
         "k6t_plain": time_ms(torch, lambda: kernels.wave_packed_fft_bf16_plain(
             part, window, hop, n_fft, fast), reps=2, warmup=1),
         "k1_lib": time_ms(torch, lambda: torch.stft(
             waves, n_fft, hop, window=window, center=True, pad_mode="reflect",
             return_complex=True).abs() ** 2),
         "k6_lib": time_ms(torch, lambda: torch.fft.fft(packed, dim=-1))}
    del packed
    n1 = 1 << ((n_fft.bit_length() - 1) // 2)
    n2 = n_fft // n1
    p1 = 1 << ((m.bit_length() - 1) // 2)
    p2 = m // p1
    t["bounds"] = {
        "k1t": bound(4 * waves.numel() + 4 * frames * (m + 1), frames * 3 * (
            4 * n2 * n2 * n1 + 8 * n2 * n1 * (n1 // 2 + 1)) / bf16_peak * 1e3),
        "k6t": bound(4 * waves.numel() + 8 * frames * m, frames * 3 * (
            8 * p2 * p2 * p1 + 8 * p2 * p1 * p1) / bf16_peak * 1e3)}
    t["gemm_parts"] = gemm_parts(torch, kernels, waves, window, hop, n_fft, bound, peaks)
    times[sr] = t
    log(f"[range] {smi}; {sr} Hz (n_fft {n_fft}), {BATCH} x {SECONDS} s ({frames} frames), fast: "
        f"K1t {t['k1t']:.4f} ms (bound {t['bounds']['k1t'][0]:.4f}; plain {t['k1t_plain']:.4f} on "
        f"{t['plain_frames']} frames, torch.stft+abs^2 {t['k1_lib']:.4f}), K6t {t['k6t']:.4f} "
        f"(bound {t['bounds']['k6t'][0]:.4f}; plain {t['k6t_plain']:.4f}, torch.fft.fft "
        f"{t['k6_lib']:.4f}); the tier GEMMs' launches on their own: "
        + gemm_parts_text(t["gemm_parts"]))
    del waves, part
    for sr in RANGE_BATCH_RATES:
        if sr in times:
            continue
        cfg = SpectrogramConfig(working_sample_rate=sr)
        waves = make_signals(torch, BATCH, sr * SECONDS, sr, dev, 1)
        batch = batch_checks(torch, kernels, waves, cfg, kernels.stft_window(cfg, dev),
                             kernels.mel_bands(cfg, dev), fast)
        log(f"[range] {sr} Hz, a {BATCH} x {SECONDS} s batch ({waves.shape[0] * (1 + waves.shape[1] // cfg.hop_size)} "
            f"frames), clip by clip: " + "; ".join(
                f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}" for k, v in batch.items()))
        del waves
    log(f"[range] phase {time.perf_counter() - t0:.1f} s; launches of its runs "
        f"{ {k: v for k, v in total.items() if v} }")

    source = "sed_tpu_torch/ops/csrc/featurizer.cu"

    def entry(name, kernel, replaces, launches, err, ms, plain_ms, bnd, library_ms, sr, **extra):
        """``launches`` None: a multi-launch route's, the sum of its kernels'
        (``route_launches`` in ``extra``)."""
        if launches is None:
            launches = sum(extra["route_launches"].values())
        return {"name": name, "kernel": kernel, "route": "cuda", "source": source,
                "replaces": f"sed_tpu/ops/pallas_featurizer.py:{replaces}", "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": library_ms,
                "n_fft": SpectrogramConfig(working_sample_rate=sr).nfft, "sample_rate": sr,
                **extra}

    def route(name, run, n_fft):
        """A multi-launch route's kernels' launches in a main-path run (none is
        counted under the wrapper's name)."""
        return {"route_launches": {k: run.get(k, 0)
                                   for k in kernels.launch_plan(n_fft)[name]["kernels"]}}

    entries = []
    for sr in RANGE_TIMED_RATES:
        t, got, b, bat = times[sr], checks[sr], times[sr]["bounds"], times[sr]["batch"]
        n_fft = SpectrogramConfig(working_sample_rate=sr).nfft
        fast_tag = tier_tag(fast)
        roll, fuse = impl_runs[sr, "roll", None], impl_runs[sr, "fuse", None]
        pack = impl_runs[sr, "pack", None]
        roll_t, fuse_t = impl_runs[sr, "roll", fast], impl_runs[sr, "fuse", fast]
        pack_t = impl_runs[sr, "pack", fast]
        plain_of = {"plain_frames": t["plain_frames"], "frames": t["frames"]}
        entries += [
            entry("wave_stft_power", "fft_cross_pass_kernel<R> + fft_subrows_kernel<false> + "
                  "packed_power_kernel", 412, None, max(got["K1 / peak"], bat["K1 / peak"]),
                  t["k1"], t["k1_plain"], b["k1"], t["k1_lib"], sr,
                  **route("wave_stft_power", roll, n_fft),
                  predictor_launches=sum(route("wave_stft_power", predictor_launches, n_fft)
                                         ["route_launches"].values())
                  if sr == 384000 else None, checks=checks),
            entry("mel_log", f"mel_log_kernel<R> at {SpectrogramConfig(working_sample_rate=sr).freq_bins}"
                  " bins", 72, roll["mel_log"],
                  max(got["parity dB (worst impl)"], bat["K1 then K2 dB"]), t["k2"],
                  t["k2_plain"], b["k2"], t["k2_lib"], sr),
            entry("wave_stft_mel_log", "K1's launches, then mel_log_kernel<R>", 550, None,
                  got["K5 None values differing from K1 then K2"]
                  + bat["K5 values differing from K1 then K2"], t["k5"], t["k5_plain"], b["k5"],
                  t["fuse_lib"], sr, **route("wave_stft_mel_log", fuse, n_fft)),
            entry("wave_packed_fft", "fft_cross_pass_kernel<R> + fft_subrows_kernel<true>", 882,
                  None, max(got["K6 / peak"], bat["K6 / peak"]), t["k6"], t["k6_plain"],
                  b["k6"], t["k6_lib"], sr, **route("wave_packed_fft", pack, n_fft)),
            entry("wave_dft_power_bf16", GEMM_ROUTE.format("false"), 412, None,
                  max(got[f"K1t {fast_tag} / peak"], bat[f"K1t {fast_tag} / peak"]), t["k1t"],
                  t["k1t_plain"], b["k1t"], t["k1_lib"], sr, precision=fast, **plain_of,
                  **route("wave_dft_power_bf16", roll_t, n_fft)),
            entry("wave_stft_mel_log_bf16", "K1t's launches, then mel_log_kernel<R>", 550, None,
                  got[f"K5t {fast_tag} values differing from K1t then K2"]
                  + bat["K5t values differing from K1t then K2"], t["k5t"], t["k5t_plain"],
                  b["k5t"], t["fuse_lib"], sr, precision=fast, **plain_of,
                  **route("wave_stft_mel_log_bf16", fuse_t, n_fft)),
            entry("wave_packed_fft_bf16", GEMM_ROUTE.format("true"), 882, None,
                  max(got[f"K6t {fast_tag} / peak"], bat[f"K6t {fast_tag} / peak"]), t["k6t"],
                  t["k6t_plain"], b["k6t"], t["k6_lib"], sr, precision=fast, **plain_of,
                  **route("wave_packed_fft_bf16", pack_t, n_fft)),
        ]
    sr = RANGE_SMALL_RATE
    t, got = times[sr], checks[sr]
    plain_of = {"plain_frames": t["plain_frames"], "frames": t["frames"]}
    entries += [
        entry("wave_dft_power_bf16", GEMM_ROUTE.format("false"), 412, None,
              got[f"K1t {tier_tag(fast)} / peak"], t["k1t"], t["k1t_plain"], t["bounds"]["k1t"],
              t["k1_lib"], sr, precision=fast, **plain_of,
              **route("wave_dft_power_bf16", impl_runs[sr, "roll", fast], 1024)),
        entry("wave_packed_fft_bf16", GEMM_ROUTE.format("true"), 882, None,
              got[f"K6t {tier_tag(fast)} / peak"], t["k6t"], t["k6t_plain"], t["bounds"]["k6t"],
              t["k6_lib"], sr, precision=fast, **plain_of,
              **route("wave_packed_fft_bf16", impl_runs[sr, "pack", fast], 1024))]
    parts = times[384000]["parts"]
    for name, kernel in {"fft_cross_pass": "fft_cross_pass_kernel<4>",
                         "fft_subrows": "fft_subrows_kernel<false> (cluster_fft, 4 CTAs a sub-row)",
                         "packed_power": "packed_power_kernel"}.items():
        p = parts[name]
        entries.append(entry(name, kernel, 412, total[name], p["max_abs_err"], p["ms"],
                             p["plain_ms"], (p["bound_ms"], p["bound_by"]), p["library_ms"],
                             384000, part_of="K1 and K3 above n_fft 131072 (K6: the first two)"))
    for sr in (RANGE_SMALL_RATE, *RANGE_TIMED_RATES):
        for name, kernel in {"tier_split": "tier_split_kernel<2, false>",
                             "tier_inner": "tier_inner_kernel<3, 2>",
                             "tier_outer": "tier_outer_kernel<3, false>"}.items():
            p = times[sr]["gemm_parts"][name]
            entries.append(entry(name, kernel, 412, total[name], p["max_abs_err"], p["ms"],
                                 p["plain_ms"], (p["bound_ms"], p["bound_by"]), p["library_ms"],
                                 sr, part_of="K1t, K3t, K6t outside the instances' sizes (here "
                                 "K1t's at fast)", plain_frames=p["plain_frames"],
                                 groups=p["groups"], group_frames=p["group_frames"]))
    return entries, total


# The tier GEMMs' route at fast (kPacked as given).
GEMM_ROUTE = "tier_split_kernel<2, {0}> + tier_inner_kernel<3, 2> + tier_outer_kernel<3, {0}>"


def gemm_parts_text(parts) -> str:
    return "; ".join(
        f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f} on {v['plain_frames']} frames, "
        f"cuBLAS {'none' if v['library_ms'] is None else format(v['library_ms'], '.4f')}, bound "
        f"{v['bound_ms']:.4f} {v['bound_by']}, err {v['max_abs_err']:.3e}, {v['groups']} groups "
        f"of {v['group_frames']})" for k, v in parts.items())


def batch_checks(torch, kernels, waves, cfg, window, bands, fast):
    """Phase 23's kernels on the timed 16 x 60 s batch itself, each once on
    all its frames (grids and scratch offsets past 2^31 floats at 2^20),
    held clip by clip (float64 fits a clip beside the batch): K1, K3
    (float32 and int16 rows) and K6 within 1e-5 x peak of float64, K1 then
    K2 within 1e-4 dB of the float64 chain, K1t, K3t and K6t at fast within
    ``tier_rel_tol`` of their plain versions, K5 and K5t equal to their
    chains over the whole batch.  Returns the worst of each."""
    from sed_tpu_torch.ops import stft as stft_ops
    from sed_tpu_torch.ops.mel import mel_filterbank

    hop, n_fft, n_bins = cfg.hop_size, cfg.nfft, cfg.freq_bins
    n_sig, n_frames = waves.shape[0], 1 + waves.shape[1] // hop
    fb64 = torch.from_numpy(mel_filterbank(cfg, np.float64)).to(waves.device)
    tol = tier_rel_tol(kernels.tier_passes(fast))
    fast_tag = tier_tag(fast)
    got = {}

    def worst(key, per_clip):
        got[key] = max(per_clip(i) for i in range(n_sig))
        return got[key]

    def rel(a, b, peak):
        return float(((a.double() - b.double()).abs() / peak.clamp_min(1e-30)).max())

    def clip(i):
        return waves[i:i + 1]

    power = kernels.wave_stft_power(waves, window, hop, n_fft)
    rows = power.reshape(-1, n_bins)
    mel = kernels.mel_log(rows, bands)
    got["K5 values differing from K1 then K2"] = int((kernels.wave_stft_mel_log(
        waves, window, hop, n_fft, bands).reshape(-1, bands.n_mels) != mel).sum())

    def k1_clip(i):
        ref = kernels.wave_stft_power_plain(clip(i).double(), window, hop, n_fft)[0]
        chain = kernels.mel_log_plain(ref, fb64)
        db = float((mel[i * n_frames:(i + 1) * n_frames].double() - chain).abs().max())
        got["K1 then K2 dB"] = max(got.get("K1 then K2 dB", 0.0), db)
        return rel(power[i], ref, ref.amax(dim=-1, keepdim=True))

    check(worst("K1 / peak", k1_clip) <= K1_REL_TOL, f"K1 on the n_fft {n_fft} batch, clip by clip")
    check(got["K1 then K2 dB"] <= DB_TOL, f"K1 then K2 on the n_fft {n_fft} batch")
    check(got["K5 values differing from K1 then K2"] == 0, f"K5 on the n_fft {n_fft} batch")
    del power, rows, mel
    t_pow = kernels.wave_dft_power_bf16(waves, window, hop, n_fft, fast)
    got["K5t values differing from K1t then K2"] = int((kernels.wave_stft_mel_log_bf16(
        waves, window, hop, n_fft, bands, fast).reshape(-1, bands.n_mels)
        != kernels.mel_log(t_pow.reshape(-1, n_bins), bands)).sum())
    check(got["K5t values differing from K1t then K2"] == 0, f"K5t on the n_fft {n_fft} batch")

    def k1t_clip(i):
        want = kernels.wave_dft_power_bf16_plain(clip(i), window, hop, n_fft, fast)[0]
        return rel(t_pow[i], want, want.amax(dim=-1, keepdim=True))

    check(worst(f"K1t {fast_tag} / peak", k1t_clip) <= tol, f"K1t on the n_fft {n_fft} batch")
    del t_pow
    zr, zi = kernels.wave_packed_fft(waves, window, hop, n_fft)

    def k6_clip(i):
        wr, wi = (w[0] for w in kernels.wave_packed_fft_plain(clip(i).double(), window, hop,
                                                              n_fft))
        peak = torch.hypot(wr, wi).amax(dim=-1, keepdim=True)
        return max(rel(zr[i], wr, peak), rel(zi[i], wi, peak))

    check(worst("K6 / peak", k6_clip) <= K1_REL_TOL, f"K6 on the n_fft {n_fft} batch")
    del zr, zi
    zr, zi = kernels.wave_packed_fft_bf16(waves, window, hop, n_fft, fast)

    def k6t_clip(i):
        wr, wi = (w[0] for w in kernels.wave_packed_fft_bf16_plain(clip(i), window, hop, n_fft,
                                                                   fast))
        peak = torch.hypot(wr, wi).amax(dim=-1, keepdim=True)
        return max(rel(zr[i], wr, peak), rel(zi[i], wi, peak))

    check(worst(f"K6t {fast_tag} / peak", k6t_clip) <= tol, f"K6t on the n_fft {n_fft} batch")
    del zr, zi

    def k3_checks(tag, x):
        out = kernels.frames_stft_power(x, window, n_fft)

        def k3_clip(i):
            part = slice(i * n_frames, (i + 1) * n_frames)
            want = kernels.frames_stft_power_plain(x[part], window, n_fft, dtype=torch.float64)
            return rel(out[part], want, want.amax(dim=-1, keepdim=True))

        check(worst(f"K3 {tag} / peak", k3_clip) <= K1_REL_TOL,
              f"K3 {tag} on the n_fft {n_fft} batch")
        del out
        out = kernels.frames_dft_power_bf16(x, window, n_fft, fast)

        def k3t_clip(i):
            part = slice(i * n_frames, (i + 1) * n_frames)
            want = kernels.frames_dft_power_bf16_plain(x[part], window, n_fft, fast)
            return rel(out[part], want, want.amax(dim=-1, keepdim=True))

        check(worst(f"K3t {fast_tag} {tag} / peak", k3t_clip) <= tol,
              f"K3t {tag} on the n_fft {n_fft} batch")

    torch.cuda.empty_cache()
    frames = stft_ops.frame_signal(waves, n_fft, hop).reshape(-1, n_fft).contiguous()
    k3_checks("float32", frames)
    pcm16 = torch.empty(frames.shape, dtype=torch.int16, device=frames.device)
    for i in range(n_sig):   # a clip at a time: no batch-sized float temporaries
        part = slice(i * n_frames, (i + 1) * n_frames)
        pcm16[part] = (frames[part].clamp(-1, 1) * 32767).round().to(torch.int16)
    del frames
    torch.cuda.empty_cache()
    k3_checks("int16", pcm16)
    del pcm16
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return got


def route_parts(torch, kernels, waves, window, hop, n_fft, bound, peaks):
    """Each launch of K1's route above n_fft 131072 (the cross pass, the
    sub-rows' FFTs, the unpack) and of K1t's tier GEMMs at fast, alone
    through the C call its wrapper makes, on ``waves``: its time, its plain
    version's (on the same inputs), the PyTorch call that computes the same
    function where there is one, its bound and its error against the plain
    version (x the frame's peak) on the first and the last clip's frames."""
    bw, fp32_peak, bf16_peak = peaks
    dev = waves.device
    lib = kernels._library()
    stream = kernels._stream(dev)
    n_sig, n = waves.shape
    n_frames = 1 + n // hop
    frames = n_sig * n_frames
    m = n_fft // 2
    log2_m = m.bit_length() - 1
    log2_r = log2_m - 16
    r_count = 1 << log2_r
    cross = kernels._cross_twiddles(n_fft, dev)
    z = torch.empty((frames, m, 2), device=dev)
    slow = dict(reps=RANGE_SLOW_REPS, warmup=1)
    out = {}

    def pass_call():
        return lib.sed_fft_cross_pass(waves.data_ptr(), 0, window.data_ptr(), cross.data_ptr(),
                                      z.data_ptr(), frames, n, n_frames, hop, log2_m, dev.index,
                                      stream)

    def subrows_call(buf):
        return lib.sed_fft_subrows(buf.data_ptr(), kernels._stockham_twiddles(131072, dev)
                                   .data_ptr(), None, None, frames << log2_r, log2_r, 0,
                                   dev.index, stream)

    # Each launch once on the whole batch; its error on the first and the last
    # clip's frames (the last at the largest offsets); plain times on the first.
    pf = n_frames
    ends = torch.cat([torch.arange(pf), torch.arange(frames - pf, frames)]).to(dev)
    check(pass_call() == 0, "the cross pass launches through its C call")
    windowed = stft_ops_frame(torch, waves, window, hop, n_fft)
    zc = torch.complex(windowed[..., 0::2], windowed[..., 1::2]).reshape(frames, m)
    del windowed
    table = torch.complex(cross[:, 0], cross[:, 1])
    want = cross_pass_plain(torch, zc[ends].to(torch.complex128), table.to(torch.complex128),
                            n_fft)
    got = torch.view_as_complex(z.view(frames, r_count, 1 << 16, 2))
    peak = want.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
    err_pass = float(((got[ends] - want).abs() / peak).max())
    sub = z.clone()
    check(subrows_call(sub) == 0, "the sub-rows' FFT launches through its C call")
    fft64 = torch.fft.fft(got[ends].to(torch.complex128), dim=-1)
    # In place, CTA r of a sub-row's cluster keeps its bins r + 4 k1 at
    # r 2^14 + k1: the sub-row in natural order.
    gsub = torch.view_as_complex(sub.view(frames, r_count, 4, 1 << 14, 2)).transpose(2, 3)
    gsub = gsub.reshape(frames, r_count, 1 << 16)
    err_sub = float(((gsub[ends] - fft64).abs()
                     / fft64.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)).max())
    power = torch.empty((frames, m + 1), device=dev)
    unpack = kernels._twiddles(n_fft, dev)

    def power_call():
        return lib.sed_packed_power(sub.data_ptr(), unpack.data_ptr(), power.data_ptr(), frames,
                                    log2_m, log2_r, dev.index, stream)

    check(power_call() == 0, "the unpack launches through its C call")
    natural = gsub[ends].to(torch.complex128).transpose(1, 2).reshape(len(ends), m)
    want_p = kernels.packed_power_onesided(natural.real, natural.imag, n_fft)
    err_pow = float(((power[ends].double() - want_p).abs()
                     / want_p.amax(dim=-1, keepdim=True).clamp_min(1e-30)).max())
    del fft64, natural, want, want_p
    sub_t = zc.view(frames, r_count, 1 << 16)
    out["fft_cross_pass"] = {
        "ms": time_ms(torch, pass_call, **slow),
        "plain_ms": time_ms(torch, lambda: cross_pass_plain(torch, zc, table, n_fft), **slow),
        "library_ms": None, "max_abs_err": err_pass,
        **dict(zip(("bound_ms", "bound_by"), bound(4 * waves.numel() + 8 * frames * m + 8 * m,
                                                   frames * m * 10 / fp32_peak * 1e3)))}
    out["fft_subrows"] = {
        "ms": time_ms(torch, lambda: subrows_call(sub), **slow),
        "plain_ms": time_ms(torch, lambda: torch.fft.fft(sub_t, dim=-1), **slow),
        "library_ms": time_ms(torch, lambda: torch.fft.fft(sub_t, dim=-1), **slow),
        "max_abs_err": err_sub,
        **dict(zip(("bound_ms", "bound_by"), bound(16 * frames * m + 8 * 5 * 16384,
                                                   frames * r_count * 5 * 65536 * 16
                                                   / fp32_peak * 1e3)))}
    del sub_t
    natural = gsub.transpose(1, 2).reshape(frames, m)   # Z[s + R k]
    zr, zi = natural.real.contiguous(), natural.imag.contiguous()
    del natural
    out["packed_power"] = {
        "ms": time_ms(torch, power_call, **slow),
        "plain_ms": time_ms(torch, lambda: kernels.packed_power_onesided(zr, zi, n_fft), **slow),
        "library_ms": None, "max_abs_err": err_pow,
        **dict(zip(("bound_ms", "bound_by"), bound(8 * frames * m + 4 * frames * (m + 1) + 8 * m,
                                                   19 * frames * m / fp32_peak * 1e3)))}
    del zr, zi, sub, z, gsub, power
    return out


def gemm_parts(torch, kernels, waves, window, hop, n_fft, bound, peaks):
    """The tier GEMMs' launches of K1t at fast on ``waves``, each alone over
    every frame group through the C call ``_tier_gemm`` makes: the split
    pass, stage 1, stage 2; each beside its plain version (on the first
    clip's frames), the same split operands through cuBLAS bf16 matmuls (each
    tier term one batched ``torch.matmul`` over the group's chunk planes,
    summed in f32: a time yardstick, not a result; the split pass has no
    PyTorch call), its bound, and its error on the first clip's frames of
    the first group (the split pass: the X planes against split_bf16 of the
    windowed frames, equal; stage 1: T, the sum of its chunks, against the
    plain stage 1, x the frame's peak |T|; stage 2: against the plain stage 2
    of the kernel's T, and the route on the first and the last clip against
    the plain K1t, x the frame's peak power)."""
    from sed_tpu_torch.ops import stft as stft_ops

    bw, fp32_peak, bf16_peak = peaks
    dev = waves.device
    lib, stream = kernels._library(), kernels._stream(dev)
    n_sig, n = waves.shape
    n_frames = 1 + n // hop
    frames = n_sig * n_frames
    m = n_fft // 2
    passes, chunks = (3, 3), 2
    log2_n1, log2_n2 = kernels._gemm_dims(n_fft)
    n1, n2 = 1 << log2_n1, 1 << log2_n2
    plan = kernels.gemm_plan(n_fft, False, passes, frames)
    tab1, tab2, tw = kernels._gemm_images(n_fft, False, chunks, chunks, plan["tab1_rows"],
                                          plan["tab2_rows"], dev)
    groups = kernels.frame_groups(frames, plan["group_frames"])
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8, device=dev)
    x, t = scratch.data_ptr(), scratch.data_ptr() + plan["x_bytes"]
    power = torch.empty((frames, m + 1), device=dev)
    shape = (log2_n1, log2_n2, 0, *passes)

    def split_call(r0, g):
        return lib.sed_tier_split(waves.data_ptr(), 0, window.data_ptr(), x, r0, g, n, n_frames,
                                  hop, *shape, dev.index, stream)

    def inner_call(r0, g):
        return lib.sed_tier_inner(x, tab1.data_ptr(), tw.data_ptr(), t, g, *shape, dev.index,
                                  stream)

    def outer_call(r0, g):
        return lib.sed_tier_outer(t, tab2.data_ptr(), power[r0:].data_ptr(), None, g, *shape,
                                  dev.index, stream)

    def every_group(call):
        return lambda: [call(r0, g) for r0, g in groups]

    for r0, g in groups:   # the route, as _tier_gemm runs it
        check(split_call(r0, g) == inner_call(r0, g) == outer_call(r0, g) == 0,
              "the tier GEMMs launch through their C calls")
    r0, g0 = groups[0]
    check(split_call(r0, g0) == inner_call(r0, g0) == 0, "the first group's planes again")
    torch.cuda.synchronize()
    pf = min(n_frames, g0)   # the first clip's frames in the first group
    xe = stft_ops_frame(torch, waves[:1], window, hop, n_fft)[:pf]
    x_rows = plan["x_bytes"] // (128 * chunks * (-(-n2 // 64)))
    t_rows = (plan["scratch_bytes"] - plan["x_bytes"]) // (128 * chunks * (-(-2 * n1 // 64)))
    got_x = kernels.plane_values(scratch[:plan["x_bytes"]], chunks, x_rows, n2, 0, pf * n1)
    want_x = kernels.split_bf16(xe.view(pf, n2, n1).transpose(1, 2).reshape(pf * n1, n2), chunks)
    err_split = max(float((gx.float() - wx).abs().max()) for gx, wx in zip(got_x, want_x))
    del got_x, want_x
    t_got = kernels.plane_values(scratch[plan["x_bytes"]:], chunks, t_rows, 2 * n1, 0,
                                 pf * n2).float().sum(dim=0).view(pf, n2, 2 * n1)
    tr_want, ti_want = kernels._tier_inner_plain(xe, n_fft, passes[0])
    t_peak = torch.hypot(tr_want, ti_want).flatten(-2).amax(-1).clamp_min(1e-30)[:, None, None]
    err_inner = max(float(((t_got[..., :n1] - tr_want).abs() / t_peak).max()),
                    float(((t_got[..., n1:] - ti_want).abs() / t_peak).max()))
    tr_got, ti_got = t_got[..., :n1].contiguous(), t_got[..., n1:].contiguous()
    del t_got, tr_want, ti_want
    p_want = kernels._tier_outer_plain(tr_got, ti_got, n_fft, passes[1])
    err_outer = float(((power[:pf] - p_want).abs()
                       / p_want.amax(dim=-1, keepdim=True).clamp_min(1e-30)).max())
    for i in (0, n_sig - 1):   # the route on the first and the last clip
        want = kernels.wave_dft_power_bf16_plain(waves[i:i + 1], window, hop, n_fft, "bf16x3")[0]
        rows = power[i * n_frames:(i + 1) * n_frames]
        err_outer = max(err_outer, float(((rows - want).abs()
                                          / want.amax(dim=-1, keepdim=True)).max()))
    del p_want
    # cuBLAS over the same chunk planes, group by group (the largest group's
    # operands, sliced for a smaller one): W (2 n2, n2) by X (g, n2, n1), then
    # T (g n2, 2 n1) by V^T.
    w, v, _ = kernels.gemm_operands(n_fft, False)
    w_c = [c.to(torch.bfloat16) for c in kernels.split_bf16(torch.from_numpy(w).to(dev), chunks)]
    v_c = [c.to(torch.bfloat16).t() for c in kernels.split_bf16(torch.from_numpy(v).to(dev),
                                                                 chunks)]
    gen = torch.Generator(device=dev).manual_seed(24)
    x_c = [torch.randn((g0, n2, n1), generator=gen, device=dev).to(torch.bfloat16)
           for _ in range(chunks)]
    t_c = [torch.randn((g0 * n2, 2 * n1), generator=gen, device=dev).to(torch.bfloat16)
           for _ in range(chunks)]
    terms = kernels._TIER_TERMS[:passes[0]]

    def inner_lib():
        for _, g in groups:
            sum(torch.matmul(w_c[i], x_c[j][:g]).float() for i, j in terms)

    def outer_lib():
        for _, g in groups:
            sum(torch.matmul(t_c[i][:g * n2], v_c[j]).float() for i, j in terms)

    slow = dict(reps=RANGE_SLOW_REPS, warmup=1)
    xf, trf, tif = xe, tr_got, ti_got   # the plain versions' times: the first clip's frames
    plane_b = 2 * chunks * frames * n_fft          # X's chunks, or Tr's and Ti's halves
    ops1 = frames * passes[0] * 4 * n2 * n2 * n1
    ops2 = frames * passes[1] * 8 * n2 * n1 * (n1 // 2 + 1)
    out = {
        "tier_split": {
            "ms": time_ms(torch, every_group(split_call), **slow),
            "plain_ms": time_ms(torch, lambda: kernels.split_bf16(
                stft_ops_frame(torch, waves[:1], window, hop, n_fft)[:pf].view(pf, n2, n1)
                .transpose(1, 2), chunks), reps=2, warmup=1),
            "library_ms": None, "max_abs_err": err_split,
            **dict(zip(("bound_ms", "bound_by"), bound(4 * waves.numel() + plane_b,
                                                       4 * frames * n_fft / fp32_peak * 1e3)))},
        "tier_inner": {
            "ms": time_ms(torch, every_group(inner_call), **slow),
            "plain_ms": time_ms(torch, lambda: kernels._tier_inner_plain(xf, n_fft, passes[0]),
                                reps=2, warmup=1),
            "library_ms": time_ms(torch, inner_lib, **slow), "max_abs_err": err_inner,
            **dict(zip(("bound_ms", "bound_by"), bound(3 * plane_b, ops1 / bf16_peak * 1e3)))},
        "tier_outer": {
            "ms": time_ms(torch, every_group(outer_call), **slow),
            "plain_ms": time_ms(torch, lambda: kernels._tier_outer_plain(trf, tif, n_fft,
                                                                         passes[1]),
                                reps=2, warmup=1),
            "library_ms": time_ms(torch, outer_lib, **slow), "max_abs_err": err_outer,
            **dict(zip(("bound_ms", "bound_by"), bound(2 * plane_b + 4 * frames * (m + 1),
                                                       ops2 / bf16_peak * 1e3)))}}
    for v in out.values():
        v.update(plain_frames=pf, groups=len(groups), group_frames=g0)
    return out


def stft_ops_frame(torch, waves, window, hop, n_fft):
    """(n_sig, n) -> (n_sig * frames, n_fft) windowed centred frames."""
    from sed_tpu_torch.ops import stft as stft_ops

    return (stft_ops.frame_signal(waves, n_fft, hop) * window).reshape(-1, n_fft)


def main() -> int:
    import torch

    phase_t0 = time.perf_counter()
    # ---- 1. card ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; chip_smoke needs a "
              "CUDA card", file=sys.stderr)
        return 1
    from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM as cfg
    from sed_tpu_torch.inference import make_batch_predictor
    from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.ops.featurizer import logmel_features_batch, logmel_frames
    from sed_tpu_torch.ops.mel import mel_filterbank
    from sed_tpu_torch.ops.mulaw import mulaw_encode

    # The script's own reference forwards and timings run in full float32,
    # as each entry point of the port does for its own call.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE, 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0: {name}, device count {count}")
    log(f"[card] nvidia-smi: {smi}")
    info = kernels.build(force=True)
    log(f"[card] nvcc build: {info.seconds:.2f} s -> {info.path.relative_to(REPO)} (its objects, "
        f"side by side, done after: " + ", ".join(
            f"{unit} {sec:.2f} s" for unit, sec in zip(kernels.BUILD_RECIPE["units"],
                                                       info.unit_seconds)) + ")")
    # Phases 8, 9 and 21 time the lesions: their builds run beside phases 2-7,
    # not beside the library's objects, which need the host's cores first.
    start_lesions(kernels)
    from sed_tpu_torch.io import native

    reader = native.build(force=True)
    log(f"[card] g++ build of the native WAV reader: {reader.seconds:.2f} s -> "
        f"{reader.path.relative_to(REPO)}")
    spilling = []
    lines = info.log.splitlines()
    for i, line in enumerate(lines):
        if any(k in line for k in ("Compiling entry", "registers", "spill")):
            log(f"[card] ptxas: {line.strip()}")
        if "Compiling entry" in line and "tier_fused_kernel" in line:
            spill = next((x for x in lines[i + 1:i + 4] if "spill stores" in x), "")
            if spill and " 0 bytes spill stores" not in spill:
                spilling.append(line.strip())
    log(f"[card] ptxas: tier_fused_kernel instances that spill: {len(spilling)}")
    check(not spilling, f"tier_fused_kernel spills no register ({spilling[:2]})")
    n_seg = kernels.mel_bands(cfg, torch.device("cpu")).n_segments
    log(f"[card] K1 wave_stft_power_kernel, K3 frames_stft_power_kernel and K6 "
        f"wave_packed_fft_kernel at n_fft {cfg.nfft}: {cfg.nfft // 32} threads a frame "
        f"(row), {4 * cfg.nfft} B of dynamic shared memory (the exchange buffer); K5 "
        f"wave_stft_mel_log_kernel the same threads, "
        f"{6 * cfg.nfft + 4 + 4 * (n_seg + kernels.MEL_SEGMENT_BINS)} B (the exchange buffer, "
        f"the power row, the sums of the {n_seg} segments, the segment loads' slack)")
    peaks = card_peaks(name)
    bw, flops_peak, _ = peaks

    sr, hop, n_fft, n_bins = cfg.working_sample_rate, cfg.hop_size, cfg.nfft, cfg.freq_bins
    m = n_fft // 2
    samples = sr * SECONDS
    chunk = sr                                  # 1 s chunks
    frames_max = -(-chunk // hop) + 1           # new frames per slot per tick
    k3_rows = POOL_SLOTS * frames_max
    window = kernels.stft_window(cfg, dev)
    win_nnz = int(torch.count_nonzero(window))
    bands = kernels.mel_bands(cfg, dev)
    fb64 = torch.from_numpy(mel_filterbank(cfg, np.float64)).to(dev)

    def bound(n_bytes, n_ops):
        t_bytes, t_ops = n_bytes / bw * 1e3, n_ops / flops_peak * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    # ---- 2. kernels vs their plain versions (float64) ---------------------
    t0 = time.perf_counter()
    waves = make_signals(torch, BATCH, samples, sr, dev, 0)
    power = kernels.wave_stft_power(waves, window, hop, n_fft)
    ref = kernels.wave_stft_power_plain(waves.double(), window, hop, n_fft)
    torch.cuda.synchronize()
    check(power.shape == ref.shape == (BATCH, 1 + samples // hop, n_bins),
          f"K1 shape {tuple(power.shape)}")
    k1_err = (power.double() - ref).abs()
    k1_abs = float(k1_err.max())
    k1_rel = float((k1_err / ref.amax(dim=-1, keepdim=True).clamp_min(1e-30)).max())
    log(f"[kernels] K1 wave_stft_power {tuple(power.shape)}: max abs err {k1_abs:.3e}, "
        f"max err / frame peak {k1_rel:.3e} (tol {K1_REL_TOL})")
    check(k1_rel <= K1_REL_TOL, "K1 within 1e-5 x frame peak of float64")
    rows = power.reshape(-1, n_bins)
    mel = kernels.mel_log(rows, bands)
    k2_err = float((mel.double() - kernels.mel_log_plain(rows.double(), fb64)).abs().max())
    chain_err = float((mel.double() - kernels.mel_log_plain(
        ref.reshape(-1, n_bins), fb64)).abs().max())
    log(f"[kernels] K2 mel_log {tuple(mel.shape)}: max err {k2_err:.3e} dB "
        f"(tol {DB_TOL}); K1+K2 vs float64 chain: {chain_err:.3e} dB (tol {DB_TOL})")
    check(k2_err <= DB_TOL, "K2 within 1e-4 dB of float64")
    check(chain_err <= DB_TOL, "K1+K2 within 1e-4 dB of the float64 chain")
    # Rows from an odd row on (not on a 16-byte boundary), up to the last row
    # of the allocation: the same values as the aligned rows, bit for bit.
    odd = rows[1:]
    odd_mel = kernels.mel_log(odd, bands)
    torch.cuda.synchronize()
    check(odd.data_ptr() % 16 != 0, "the view starts off a 16-byte boundary")
    check(torch.equal(odd_mel, mel[1:]), "K2 on unaligned rows equals K2 on aligned rows")
    log(f"[kernels] K2 mel_log on rows 1.. (base {odd.data_ptr() % 16} bytes past a 16-byte "
        f"boundary, up to the allocation's end): equal to the aligned rows' result")
    del power, ref, k1_err, rows, mel, odd, odd_mel

    # K3 at the tick's shape: 10 frames of each of the 16 signals (signal 0's
    # are silent, signal 15's quiet), as float32 and as int16 PCM.
    per = k3_rows // BATCH
    frames_f32 = waves[:, : n_fft + (per - 1) * hop].unfold(1, n_fft, hop)
    frames_f32 = frames_f32.reshape(-1, n_fft)[:k3_rows].contiguous()
    frames_i16 = (frames_f32 * 32767).round().to(torch.int16)
    k3 = {}
    for tag, x in (("float32", frames_f32), ("int16", frames_i16)):
        got = kernels.frames_stft_power(x, window, n_fft)
        want = kernels.frames_stft_power_plain(x, window, n_fft, dtype=torch.float64)
        lm = logmel_frames(x, cfg)
        torch.cuda.synchronize()
        check(got.shape == want.shape == (k3_rows, n_bins), f"K3 {tag} shape {tuple(got.shape)}")
        err = (got.double() - want).abs()
        rel = float((err / want.amax(dim=-1, keepdim=True).clamp_min(1e-30)).max())
        db = float((lm.double() - kernels.mel_log_plain(want, fb64)).abs().max())
        k2_tick = float((kernels.mel_log(got, bands).double()
                         - kernels.mel_log_plain(got.double(), fb64)).abs().max())
        k3[tag] = float(err.max())
        log(f"[kernels] K3 frames_stft_power {tag} {tuple(got.shape)}: max abs err "
            f"{k3[tag]:.3e}, max err / row peak {rel:.3e} (tol {K1_REL_TOL}); "
            f"logmel_frames vs float64 chain {db:.3e} dB (tol {DB_TOL}); K2 on its "
            f"{k3_rows} rows vs float64 {k2_tick:.3e} dB (tol {DB_TOL})")
        check(rel <= K1_REL_TOL, f"K3 {tag} within 1e-5 x row peak of float64")
        check(db <= DB_TOL, f"K3+K2 {tag} within 1e-4 dB of the float64 chain")
        check(k2_tick <= DB_TOL, "K2 at the tick's rows within 1e-4 dB of float64")
    del waves, got, want, err, lm
    log(f"[kernels] launches so far {kernels.LAUNCHES}; "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 3. the slice through make_batch_predictor ------------------------
    t0 = time.perf_counter()
    model = CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL,
                          generator=torch.Generator().manual_seed(0))
    cpu_model = copy.deepcopy(model)
    pcm = (make_signals(torch, BATCH, samples, sr, dev, 1)
           * 32767).round().to(torch.int16)[..., None]
    mu = torch.from_numpy(mulaw_encode(pcm.cpu().numpy())).to(dev)
    # Per-mel-bin normalization statistics, as preprocessing computes them
    # from training features; they keep the random model out of saturation.
    with torch.inference_mode():
        feats = logmel_features_batch(pcm[:4], cfg)
    mean = feats.mean(dim=(0, 1, 2)).cpu().numpy()
    std = feats.std(dim=(0, 1, 2)).cpu().numpy()
    predict = make_batch_predictor(model, cfg, mean=mean, std=std, device=DEVICE)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    scores = predict(pcm)
    scores_mu = predict(mu)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"[slice] launches on the batch path: {launches}")
    check(launches["wave_stft_power"] > 0 and launches["mel_log"] > 0,
          "K1 and K2 ran on the batch path")
    n_out = 8 * ((((1 + samples // hop) // 2) // 2) // 2)
    for tag, s in (("int16", scores), ("uint8", scores_mu)):
        check(s.shape == (BATCH, n_out, cfg.classes_num), f"{tag} scores shape {tuple(s.shape)}")
        check(bool(torch.isfinite(s).all()), f"{tag} scores finite")
        check(bool(((s >= 0) & (s <= 1)).all()), f"{tag} scores in [0, 1]")
        log(f"[slice] {tag} scores {tuple(s.shape)}: min {float(s.min()):.6f} "
            f"max {float(s.max()):.6f}")
    cpu_predict = make_batch_predictor(cpu_model, cfg, mean=mean, std=std, device="cpu")
    cpu_err = float((scores[:1].cpu() - cpu_predict(pcm[:1].cpu())).abs().max())
    cpu_err_mu = float((scores_mu[:1].cpu() - cpu_predict(mu[:1].cpu())).abs().max())
    log(f"[slice] clip 0, card vs CPU: int16 {cpu_err:.3e}, uint8 {cpu_err_mu:.3e} "
        f"(tol {SCORE_TOL}); {time.perf_counter() - t0:.1f} s")
    check(cpu_err <= SCORE_TOL and cpu_err_mu <= SCORE_TOL, "clip 0 matches the CPU path")
    del cpu_model, cpu_predict

    from scipy.io import wavfile

    from sed_tpu_torch.io.audio import read_multichannel_audio

    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    torch.save({"iterations": 0, "model": model.state_dict(), "optimizer": {}},
               tmp / "model.pth")
    with open(tmp / "mean_std.pkl", "wb") as f:
        pickle.dump({"mean": mean, "std": std}, f)
    common = ["--ckpt", tmp / "model.pth", "--mean_std_file", tmp / "mean_std.pkl",
              "--device", DEVICE]

    def check_cli_outputs(out, wavs, tag):
        err = 0.0
        for path in wavs:
            got = np.load(out / f"{path.stem}_scores.npy")
            wav = read_multichannel_audio(str(path), target_fs=sr, cfg=cfg)
            want = predict(wav[None].astype(np.float32))[0].cpu().numpy()
            check(got.shape == want.shape, f"{tag} scores shape {got.shape} != {want.shape}")
            err = max(err, float(np.abs(got - want).max()))
            check((out / f"{path.stem}_events.csv").is_file(), f"{tag} wrote events")
        check(err <= SCORE_TOL, f"{tag} scores match make_batch_predictor")
        return err

    # ---- 4. the batch CLI entry point --------------------------------------
    t0 = time.perf_counter()
    wavs = []
    for i, secs in enumerate((20, 30)):
        path = tmp / f"clip{i}.wav"
        wavfile.write(path, sr, pcm[i, : secs * sr, 0].cpu().numpy())
        wavs.append(path)
    out = tmp / "out_infer"
    run_cli(["sed_tpu_torch.cli.infer", "--batch", "--no_plot", *common, "--outputs_dir", out,
             "--event_threshold", "0.5", *wavs], "cli.infer")
    for path in wavs:
        check((out / f"{path.stem}_scores.csv").is_file(), "cli.infer wrote scores csv")
    cli_err = check_cli_outputs(out, wavs, "cli.infer")
    log(f"[cli] {len(wavs)} files scored by sed_tpu_torch.cli.infer --batch; "
        f"max diff vs make_batch_predictor {cli_err:.3e} (tol {SCORE_TOL}); "
        f"{time.perf_counter() - t0:.1f} s")
    del pcm, mu, scores, scores_mu

    # ---- 5. the streaming pool at full width (the main path) ---------------
    from sed_tpu_torch.stream_pool import StreamPool

    t0 = time.perf_counter()
    pool_samples = sr * POOL_SECONDS
    audio = (make_signals(torch, POOL_SLOTS, pool_samples, sr, dev, 2) * 32767
             ).round().to(torch.int16).cpu().numpy()
    clips = [audio[i] for i in range(POOL_SLOTS)]
    clips[EARLY_LEAVER] = clips[EARLY_LEAVER][: int(EARLY_SECONDS * sr)]
    pool = StreamPool(model, cfg, slots=POOL_SLOTS, chunk_samples=chunk, mean=mean,
                      std=std, device=DEVICE)
    pool.profile = {}
    got_pool, pool_wall, pool_launches, pool_peak_mib, tick = drive_pool(
        torch, dev, pool, clips, chunk, seed=2)
    pool_audio_s = sum(len(c) for c in clips) / sr
    log(f"[pool] {POOL_SLOTS} streams ({len(LATE_JOINS)} joining late, stream "
        f"{EARLY_LEAVER} leaving after {EARLY_SECONDS} s), {tick} ticks; launches "
        f"on the main path: {pool_launches}")
    check(pool_launches["frames_stft_power"] > 0 and pool_launches["mel_log"] > 0,
          "K3 and K2 ran on the streaming path")
    full = [i for i in range(POOL_SLOTS) if i != EARLY_LEAVER]
    want = dict(zip(full, score_all(torch, predict, [clips[i] for i in full])))
    want[EARLY_LEAVER] = score_all(torch, predict, [clips[EARLY_LEAVER]])[0]
    pool_err = 0.0
    for i, got in enumerate(got_pool):
        check(got.shape == want[i].shape,
              f"stream {i}: {got.shape[0]} frames, offline {want[i].shape[0]}")
        pool_err = max(pool_err, float(np.abs(got - want[i]).max()))
    log(f"[pool] every stream's frame count equals offline; max diff vs "
        f"make_batch_predictor {pool_err:.3e} (tol {SCORE_TOL}); "
        f"{time.perf_counter() - t0:.1f} s")
    check(pool_err <= SCORE_TOL, "pool scores match make_batch_predictor")
    profile = pool.profile
    del pool, got_pool

    # ---- 6. the streaming CLI ----------------------------------------------
    t0 = time.perf_counter()
    wavs = []
    for i, secs in enumerate(CLI_SECONDS):
        path = tmp / f"stream{i}.wav"
        wavfile.write(path, sr, audio[i, : int(secs * sr)])
        wavs.append(path)
    out = tmp / "out_stream"
    stdout = run_cli(["sed_tpu_torch.cli.stream", *common, "--outputs_dir", out,
                      "--slots", "2", "--stagger_ticks", "2", "--event_threshold",
                      "0.5", *wavs], "cli.stream")
    summary = json.loads(stdout.strip().splitlines()[-1])
    cli_launches = summary["kernel_launches"]
    check(cli_launches["frames_stft_power"] > 0 and cli_launches["mel_log"] > 0,
          "K3 and K2 ran in cli.stream")
    stream_err = check_cli_outputs(out, wavs, "cli.stream")
    log(f"[stream] {len(wavs)} files scored by sed_tpu_torch.cli.stream "
        f"(2 slots, staggered) in {summary['ticks']} ticks; launches {cli_launches}; "
        f"max diff vs make_batch_predictor {stream_err:.3e} (tol {SCORE_TOL}); "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 7. the live TCP server --------------------------------------------
    from sed_tpu_torch.cli.serve_socket import warmup_pool
    from sed_tpu_torch.serve_socket import StreamClient, StreamServer

    t0 = time.perf_counter()
    server_launches = dict.fromkeys(kernels.LAUNCHES, 0)
    server_err = 0.0
    for wire, secs in (("pcm16", SERVER_SECONDS), ("mulaw", (MULAW_SECONDS,))):
        sent = [audio[i, : int(s * sr)] for i, s in enumerate(secs)]
        spool = StreamPool(model, cfg, slots=len(sent), chunk_samples=chunk,
                           mean=mean, std=std, device=DEVICE)
        warmup_pool(spool, wire)
        kernels.reset_launch_counts()
        server = StreamServer(spool, host="127.0.0.1", port=0, tick_interval=0.02,
                              wire=wire)
        server.start()
        results = {}

        def client(i, y, server=server, wire=wire, results=results):
            try:
                c = StreamClient(*server.address, classes_num=cfg.classes_num, wire=wire)
                for pos in range(0, len(y), 20000):
                    c.send(y[pos: pos + 20000])
                results[i] = c.finish()
            except Exception as e:  # noqa: BLE001 - reported below
                results[i] = e

        try:
            threads = [threading.Thread(target=client, args=(i, y))
                       for i, y in enumerate(sent)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
                check(not t.is_alive(), f"{wire} client finished")
        finally:
            server.stop()
        for k, n in kernels.LAUNCHES.items():
            server_launches[k] += n
        for i, y in enumerate(sent):
            got = results[i]
            if isinstance(got, Exception):
                raise got
            ref = score_all(torch, predict, [mulaw_encode(y) if wire == "mulaw" else y])[0]
            check(got.shape == ref.shape, f"{wire} client {i}: {got.shape} != {ref.shape}")
            server_err = max(server_err, float(np.abs(got - ref).max()))
    log(f"[server] {len(SERVER_SECONDS)} pcm16 clients and 1 mulaw client on "
        f"127.0.0.1; launches {server_launches}; max diff vs offline "
        f"{server_err:.3e} (tol {SCORE_TOL}); {time.perf_counter() - t0:.1f} s")
    check(server_launches["frames_stft_power"] > 0 and server_launches["mel_log"] > 0,
          "K3 and K2 ran in the server")
    check(server_err <= SCORE_TOL, "server scores match offline")
    tmp_dir.cleanup()

    # ---- 8. times ------------------------------------------------------------
    t0 = time.perf_counter()
    pcm = torch.from_numpy(audio[:BATCH, :samples]).to(dev)[..., None]
    signals = (pcm[..., 0].float() / 32768.0).contiguous()
    power = kernels.wave_stft_power(signals, window, hop, n_fft)
    rows = power.reshape(-1, n_bins)
    frames = rows.shape[0]
    k1_ms = time_ms(torch, lambda: kernels.wave_stft_power(signals, window, hop, n_fft))
    k1_plain_ms = time_ms(torch, lambda: kernels.wave_stft_power_plain(
        signals, window, hop, n_fft))
    k1_lib_ms = time_ms(torch, lambda: torch.stft(
        signals, n_fft, hop, window=window, center=True, pad_mode="reflect",
        return_complex=True).abs() ** 2)
    k2_ms = time_ms(torch, lambda: kernels.mel_log(rows, bands))
    k2_plain_ms = time_ms(torch, lambda: kernels.mel_log_plain(rows, bands.dense))
    k2_lib_ms = time_ms(torch, lambda: 10.0 * torch.log10(
        torch.clamp(torch.matmul(rows, bands.dense), min=1e-10)))
    with torch.inference_mode():
        feats = logmel_features_batch(pcm, cfg)
        feat_ms = time_ms(torch, lambda: logmel_features_batch(pcm, cfg))
        model_ms = time_ms(torch, lambda: model(feats))
    torch.cuda.reset_peak_memory_stats(dev)
    batch_ms = time_ms(torch, lambda: predict(pcm))
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    audio_s_per_s = BATCH * SECONDS / (batch_ms / 1e3)
    del power, feats

    # K3 on a tick's frames: the first frames_max frames of every stream.
    tick_frames = (torch.from_numpy(audio[:, : n_fft + (frames_max - 1) * hop]).to(dev)
                   .float() / 32768.0).unfold(1, n_fft, hop).reshape(-1, n_fft).contiguous()
    # One call between two events, as every kernel here (launch latency
    # included); K3 takes tens of microseconds, so also queued (QUEUED calls
    # in a row), which times the device work alone.
    k3_calls = {
        "k3": lambda: kernels.frames_stft_power(tick_frames, window, n_fft),
        "plain": lambda: kernels.frames_stft_power_plain(tick_frames, window, n_fft),
        "lib": lambda: torch.fft.rfft(tick_frames * window).abs() ** 2,
    }
    k3_ms, k3_plain_ms, k3_lib_ms = (time_ms(torch, fn) for fn in k3_calls.values())
    k3_q_ms, k3_q_plain_ms, k3_q_lib_ms = (time_ms(torch, fn, calls=QUEUED)
                                           for fn in k3_calls.values())
    # K3 without its drain's exchange (wrong results): what the exchange
    # costs, against K3 through the same C call.
    lesions = finish_lesions()
    k3_out = kernels.frames_stft_power(tick_frames, window, n_fft)
    k3_tables = (kernels._stockham_twiddles(n_fft, dev), kernels._twiddles(n_fft, dev))
    k3_stream = torch.cuda.current_stream(dev).cuda_stream

    def k3_raw_run(fn):
        err = fn(tick_frames.data_ptr(), 0, window.data_ptr(), k3_tables[0].data_ptr(),
                 k3_tables[1].data_ptr(), k3_out.data_ptr(), tick_frames.shape[0],
                 n_fft.bit_length() - 2, dev.index, k3_stream)
        check(err == 0, f"K3 raw launch ({err})")

    k3_lesion_ms = time_ms(torch, lambda: k3_raw_run(lesions["K3 drain exchange"]),
                           calls=QUEUED)
    k3_again_ms = time_ms(torch, lambda: k3_raw_run(kernels._library().sed_frames_stft_power),
                          calls=QUEUED)
    del k3_out
    # K1 likewise, on the batch.
    k1_out = kernels.wave_stft_power(signals, window, hop, n_fft)

    def k1_raw_run(fn):
        err = fn(signals.data_ptr(), window.data_ptr(), k3_tables[0].data_ptr(),
                 k3_tables[1].data_ptr(), k1_out.data_ptr(), BATCH, samples, k1_out.shape[1],
                 hop, n_fft.bit_length() - 2, dev.index, k3_stream)
        check(err == 0, f"K1 raw launch ({err})")

    k1_lesion_ms = time_ms(torch, lambda: k1_raw_run(lesions["K1 drain exchange"]))
    k1_again_ms = time_ms(torch, lambda: k1_raw_run(kernels._library().sed_wave_stft_power))
    del k1_out

    # K2 at the tick's rows (K3's power of the tick frames): one call, and
    # QUEUED calls in a row.
    tick_power = kernels.frames_stft_power(tick_frames, window, n_fft)
    k2t_calls = {
        "k2": lambda: kernels.mel_log(tick_power, bands),
        "plain": lambda: kernels.mel_log_plain(tick_power, bands.dense),
        "lib": lambda: 10.0 * torch.log10(torch.clamp(torch.matmul(tick_power, bands.dense),
                                                      min=1e-10)),
    }
    k2t_ms = time_ms(torch, k2t_calls["k2"])
    k2t_q_ms, k2t_q_plain_ms, k2t_q_lib_ms = (time_ms(torch, fn, calls=QUEUED)
                                              for fn in k2t_calls.values())
    # K2 without its copies, and without its sums (wrong results): each side
    # alone, against K2 through the same C call.

    def k2_raw_run(fn, x, out):
        err = fn(x.data_ptr(), bands.segments.data_ptr(), bands.band_first.data_ptr(),
                 bands.work.data_ptr(), bands.weights.data_ptr(), out.data_ptr(), x.shape[0],
                 n_bins, bands.n_mels, bands.n_segments, *bands.span, 0, dev.index,
                 k3_stream)
        check(err == 0, f"K2 raw launch ({err})")

    k2_out = torch.empty(frames, bands.n_mels, device=dev)
    k2t_out = torch.empty(tick_power.shape[0], bands.n_mels, device=dev)
    k2_raw = kernels._library().sed_mel_log
    k2_lesion_ms = time_ms(torch, lambda: k2_raw_run(lesions["K2 copies"], rows, k2_out))
    k2_copies_ms = time_ms(torch, lambda: k2_raw_run(lesions["K2 sums"], rows, k2_out))
    k2_again_ms = time_ms(torch, lambda: k2_raw_run(k2_raw, rows, k2_out))
    k2t_lesion_ms = time_ms(torch, lambda: k2_raw_run(lesions["K2 copies"], tick_power, k2t_out),
                            calls=QUEUED)
    k2t_copies_ms = time_ms(torch, lambda: k2_raw_run(lesions["K2 sums"], tick_power, k2t_out),
                            calls=QUEUED)
    k2t_again_ms = time_ms(torch, lambda: k2_raw_run(k2_raw, tick_power, k2t_out), calls=QUEUED)
    del k2_out, k2t_out

    # The 32-slot pool's tick: every slot admitted, int16 chunks.
    tpool = StreamPool(model, cfg, slots=POOL_SLOTS, chunk_samples=chunk, mean=mean,
                       std=std, device=DEVICE)
    tslots = [tpool.join() for _ in range(POOL_SLOTS)]
    for k in range(2):
        tpool.push({s: audio[s, k * chunk: (k + 1) * chunk] for s in tslots})
    check(len(tpool._admitted) == POOL_SLOTS, "every timing slot admitted")
    one = {s: audio[s, 2 * chunk: 3 * chunk] for s in tslots}
    tick_ms = time_ms(torch, lambda: tpool._push_rounds([one]))
    block_ms = time_ms(torch, lambda: tpool._push_rounds(
        [one] * StreamPool.ROUNDS_PER_CALL), reps=5, warmup=1)
    tick_kernels = profile_ticks(torch, lambda: tpool._push_rounds([one]), n=5)
    del tpool

    # Waveform, window, the two twiddle tables (pass-ordered and W_N^k), power.
    k1_bytes = 4 * (signals.numel() + n_fft + 4 * m + rows.numel())
    k1_bound, k1_by = bound(k1_bytes, fft_ops(frames, m, win_nnz))
    nnz = bands.nnz
    # Power, out, and the band tables: weights, segments (4 int32 each),
    # work, band_first.
    k2_tables = 4 * (nnz + 5 * bands.n_segments + bands.n_mels + 1)
    k2_bytes = 4 * (rows.numel() + frames * bands.n_mels) + k2_tables
    k2_ops = frames * 2 * nnz
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    k2t_n = tick_power.shape[0]
    k2t_bytes = 4 * (tick_power.numel() + k2t_n * bands.n_mels) + k2_tables
    k2t_bound, k2t_by = bound(k2t_bytes, k2t_n * 2 * nnz)
    k3_n = tick_frames.shape[0]
    # Rows, window, the two twiddle tables (pass-ordered and W_N^k), power.
    k3_bytes = 4 * (tick_frames.numel() + n_fft + 4 * m + k3_n * (m + 1))
    k3_ops = fft_ops(k3_n, m, win_nnz)
    k3_bound, k3_by = bound(k3_bytes, k3_ops)
    log(f"[times] {smi}; CUDA-event median of {REPS} unless stated")
    log(f"[times] batch path, {BATCH} x {SECONDS} s, {frames} frames:")
    log(f"[times] K1 wave_stft_power {k1_ms:.4f} ms | plain {k1_plain_ms:.4f} ms | "
        f"torch.stft+abs^2 {k1_lib_ms:.4f} ms | bound {k1_bound:.4f} ms ({k1_by}: "
        f"{k1_bytes / 1e6:.1f} MB, {fft_ops(frames, m, win_nnz) / 1e9:.2f} GFLOP) | bound "
        f"share {k1_bound / k1_ms:.1%} | K1 / torch.stft+abs^2 {k1_ms / k1_lib_ms:.3f}")
    log(f"[times] K1 without its drain's exchange (wrong results, timing only) "
        f"{k1_lesion_ms:.4f} ms; K1 through the same C call {k1_again_ms:.4f} ms (the "
        f"exchange's share {k1_again_ms - k1_lesion_ms:.4f} ms)")
    log(f"[times] K2 mel_log {k2_ms:.4f} ms | plain {k2_plain_ms:.4f} ms | "
        f"matmul+log10 {k2_lib_ms:.4f} ms | bound {k2_bound:.4f} ms ({k2_by}: "
        f"{k2_bytes / 1e6:.1f} MB, {k2_ops / 1e9:.3f} GFLOP) | bound share "
        f"{k2_bound / k2_ms:.1%} | K2 / matmul+log10 {k2_ms / k2_lib_ms:.3f}")
    log(f"[times] K2 without its copies (wrong results, timing only) {k2_lesion_ms:.4f} ms; "
        f"without its sums {k2_copies_ms:.4f} ms; K2 through the same C call "
        f"{k2_again_ms:.4f} ms (what the copies add to the sums {k2_again_ms - k2_lesion_ms:.4f} "
        f"ms, the sums to the copies {k2_again_ms - k2_copies_ms:.4f} ms)")
    log(f"[times] featurizer (int16 ingest + K1 + K2) {feat_ms:.4f} ms | "
        f"CnnAvgPooling {model_ms:.4f} ms | whole batch {batch_ms:.4f} ms")
    log(f"[times] {audio_s_per_s:.1f} audio-s/s; peak device memory {peak_mib:.1f} MiB")
    log(f"[times] streaming path, {POOL_SLOTS} slots x 1 s chunks, {k3_n} frames a tick:")
    log(f"[times] K3 frames_stft_power {k3_ms:.4f} ms | plain {k3_plain_ms:.4f} ms | "
        f"rfft+abs^2 {k3_lib_ms:.4f} ms | bound {k3_bound:.4f} ms ({k3_by}: "
        f"{k3_bytes / 1e6:.1f} MB, {k3_ops / 1e9:.3f} GFLOP) | bound share "
        f"{k3_bound / k3_ms:.1%} | K3 / rfft+abs^2 {k3_ms / k3_lib_ms:.3f}")
    log(f"[times] K3 queued ({QUEUED} calls between two events, per call) {k3_q_ms:.4f} ms "
        f"| plain {k3_q_plain_ms:.4f} ms | rfft+abs^2 {k3_q_lib_ms:.4f} ms | bound share "
        f"{k3_bound / k3_q_ms:.1%} | K3 / rfft+abs^2 {k3_q_ms / k3_q_lib_ms:.3f}")
    log(f"[times] K3 without its drain's exchange (wrong results, timing only, queued) "
        f"{k3_lesion_ms:.4f} ms; K3 through the same C call {k3_again_ms:.4f} ms (the "
        f"exchange's share {k3_again_ms - k3_lesion_ms:.4f} ms)")
    log(f"[times] K2 mel_log at the tick's {k2t_n} rows {k2t_ms:.4f} ms | bound "
        f"{k2t_bound:.4f} ms ({k2t_by}: {k2t_bytes / 1e6:.2f} MB) | bound share "
        f"{k2t_bound / k2t_ms:.1%}")
    log(f"[times] K2 at {k2t_n} rows queued ({QUEUED} calls between two events, per call) "
        f"{k2t_q_ms:.4f} ms | plain {k2t_q_plain_ms:.4f} ms | matmul+log10 {k2t_q_lib_ms:.4f} "
        f"ms | bound share {k2t_bound / k2t_q_ms:.1%} | K2 / matmul+log10 "
        f"{k2t_q_ms / k2t_q_lib_ms:.3f}")
    log(f"[times] K2 at {k2t_n} rows without its copies (wrong results, timing only, queued) "
        f"{k2t_lesion_ms:.4f} ms; without its sums {k2t_copies_ms:.4f} ms; K2 through the "
        f"same C call {k2t_again_ms:.4f} ms")
    log(f"[times] pool tick, one round of {POOL_SLOTS} slots: {tick_ms:.4f} ms | "
        f"one {StreamPool.ROUNDS_PER_CALL}-round block: {block_ms:.4f} ms (median of 5)")
    if tick_kernels:
        busy = sum(ms for _, ms in tick_kernels)
        log(f"[times] pool tick on the device (torch.profiler, 5 ticks): "
            f"{busy:.4f} ms of kernels a tick, {busy / tick_ms:.1%} of the "
            f"{tick_ms:.4f} ms tick; the 8 largest and the port's own:")
        for i, (kname, ms) in enumerate(tick_kernels):
            if i < 8 or any(k in kname for k in kernels.LAUNCHES):
                log(f"[times]   {ms:.4f} ms  {kname[:90]}")
    else:
        log("[times] pool tick on the device: torch.profiler captured no device "
            "time (not measured)")
    log(f"[times] pool run profile: " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in sorted(profile.items())))
    log(f"[times] pool run: {pool_audio_s:.1f} audio-s in {pool_wall:.3f} wall-s = "
        f"{pool_audio_s / pool_wall:.1f} audio-s per wall-s; peak device memory "
        f"{pool_peak_mib:.1f} MiB")
    log(f"[times] {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - phase_t0:.1f} s")

    impl_entries = impls_phase(torch, cfg, dev, bound, win_nnz, lesions)
    log(f"[times] total {time.perf_counter() - phase_t0:.1f} s")

    # ---- 10. the per-file path --------------------------------------------
    with tempfile.TemporaryDirectory() as files_tmp:
        file_launches = files_phase(torch, cfg, dev, smi, Path(files_tmp))
    log(f"[files] total {time.perf_counter() - phase_t0:.1f} s")

    # ---- 11. training; 12. M5 training on the same corpus -------------------
    # The corpus stays until phase 16, which trains and reads it again.
    train_dir = tempfile.TemporaryDirectory()
    train_tmp = Path(train_dir.name)
    train_launches, corpus = train_phase(torch, cfg, dev, smi, train_tmp)
    log(f"[train] total {time.perf_counter() - phase_t0:.1f} s")
    wave_launches = wavetrain_phase(torch, cfg, dev, smi, train_tmp, corpus)
    log(f"[wavetrain] total {time.perf_counter() - phase_t0:.1f} s")

    # ---- 13. checkpoints and the live serving of MobileNetV1 and M5 ----------
    with tempfile.TemporaryDirectory() as serve_tmp:
        serve_launches = serve_phase(torch, cfg, dev, smi, Path(serve_tmp), mean, std)
    log(f"[serve] total {time.perf_counter() - phase_t0:.1f} s")

    # ---- 14. int8 PTQ and QAT ----------------------------------------------------
    with tempfile.TemporaryDirectory() as int8_tmp:
        int8_launches = int8_phase(torch, cfg, dev, smi, Path(int8_tmp), model, mean, std)
    log(f"[int8] total {time.perf_counter() - phase_t0:.1f} s")

    # ---- 15. AOT serving artifacts -------------------------------------------------
    with tempfile.TemporaryDirectory() as aot_tmp:
        aot_launches = aot_phase(torch, cfg, dev, smi, Path(aot_tmp), model, mean, std,
                                 info.seconds)
    log(f"[aot] total {time.perf_counter() - phase_t0:.1f} s")

    # ---- 16. the bf16 tier on the live paths and in training; the reader -------
    bf16_launches = bf16_phase(torch, cfg, dev, smi, train_tmp, model, mean, std, corpus)
    log(f"[bf16] total {time.perf_counter() - phase_t0:.1f} s")

    # ---- 17. data parallelism: a one-rank NCCL mesh ------------------------------
    mesh_launches = mesh_phase(torch, cfg, dev, smi, train_tmp, model, mean, std, corpus)
    log(f"[mesh] total {time.perf_counter() - phase_t0:.1f} s")

    # ---- 18. sharded artifacts; sed_tpu's .ckpt resumed ---------------------------
    shard_launches = sharded_phase(torch, cfg, dev, smi, train_tmp, model, mean, std, corpus)
    del corpus
    train_dir.cleanup()
    log(f"[shard] total {time.perf_counter() - phase_t0:.1f} s")

    # ---- 19. the SVM baseline, sed_tpu's orbax checkpoints, the scripts ----------
    with tempfile.TemporaryDirectory() as classical_tmp:
        classical_launches = classical_phase(torch, cfg, dev, smi, Path(classical_tmp))
    log(f"[classical] total {time.perf_counter() - phase_t0:.1f} s")

    # ---- 20. the featurizer tiers: the bf16 tensor-core DFT, K2's bf16 modes ----
    with tempfile.TemporaryDirectory() as tiers_tmp:
        tier_entries, tier_launches = tiers_phase(torch, cfg, dev, smi, Path(tiers_tmp), model,
                                                  mean, std, peaks)
    log(f"[tiers] total {time.perf_counter() - phase_t0:.1f} s")

    # ---- 21. 'fuse' and 'pack' at the tiers: K5t, K5b, K6t ---------------------------
    fusepack_entries, fusepack_launches = fusepack_phase(torch, cfg, dev, smi, peaks, lesions)
    log(f"[fusepack] total {time.perf_counter() - phase_t0:.1f} s")

    # ---- 22. n_fft 65536 and 131072: 96 and 192 kHz through every kernel ----------
    wide_entries, wide_launches = wide_phase(torch, dev, smi, peaks)
    log(f"[wide] total {time.perf_counter() - phase_t0:.1f} s")

    # ---- 23. the ends of the n_fft range: 1 kHz, 384 kHz, 768 kHz, 1.536 MHz ------
    range_entries, range_launches = range_phase(torch, dev, smi, peaks)
    log(f"[range] total {time.perf_counter() - phase_t0:.1f} s")

    source = "sed_tpu_torch/ops/csrc/featurizer.cu"
    entries = [
        {"name": "wave_stft_power",
         "kernel": "wave_stft_power_kernel<LOG2_M> (stockham_fft, PackedWaveLoad, PowerStore)",
         "route": "cuda", "source": source,
         "replaces": "sed_tpu/ops/pallas_featurizer.py:412",
         "launches": launches["wave_stft_power"],
         "file_launches": file_launches["wave_stft_power"],
         "train_launches": train_launches["wave_stft_power"], "max_abs_err": k1_abs,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib_ms},
        {"name": "mel_log",
         "kernel": "mel_log_kernel<R> (bulk copies into a ring, segment_sums)",
         "route": "cuda", "source": source,
         "replaces": "sed_tpu/ops/pallas_featurizer.py:72",
         "launches": launches["mel_log"], "file_launches": file_launches["mel_log"],
         "train_launches": train_launches["mel_log"],
         "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib_ms, "tick_rows": k2t_n,
         "tick_ms": k2t_ms, "tick_queued_ms": k2t_q_ms,
         "tick_queued_plain_ms": k2t_q_plain_ms, "tick_queued_library_ms": k2t_q_lib_ms,
         "tick_bound_ms": k2t_bound, "pool_launches": pool_launches["mel_log"]},
        {"name": "frames_stft_power",
         "kernel": "frames_stft_power_kernel<LOG2_M, Pair> (stockham_fft, PowerStore)",
         "route": "cuda", "source": source,
         "replaces": "sed_tpu/ops/pallas_featurizer.py:283",
         "launches": pool_launches["frames_stft_power"], "max_abs_err": k3["float32"],
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": k3_lib_ms, "queued_ms": k3_q_ms,
         "queued_plain_ms": k3_q_plain_ms, "queued_library_ms": k3_q_lib_ms},
        *impl_entries,
        *tier_entries,
        *fusepack_entries,
        *wide_entries,
        *range_entries,
    ]
    for e in entries:   # phase 12's path, M5 training: every count is 0
        e["wavetrain_launches"] = sum(wave_launches[k] for k in ENTRY_COUNTERS[e["name"]])
        e["serve_launches"] = sum(serve_launches[k] for k in ENTRY_COUNTERS[e["name"]])
        e["int8_launches"] = sum(int8_launches[k] for k in ENTRY_COUNTERS[e["name"]])
        e["aot_launches"] = sum(aot_launches[k] for k in ENTRY_COUNTERS[e["name"]])
        e["bf16_launches"] = sum(bf16_launches[k] for k in ENTRY_COUNTERS[e["name"]])
        e["mesh_launches"] = sum(mesh_launches[k] for k in ENTRY_COUNTERS[e["name"]])
        e["shard_launches"] = sum(shard_launches[k] for k in ENTRY_COUNTERS[e["name"]])
        e["classical_launches"] = sum(classical_launches[k] for k in ENTRY_COUNTERS[e["name"]])
        e["tier_launches"] = sum(tier_launches[k] for k in ENTRY_COUNTERS[e["name"]])
        e["fusepack_launches"] = sum(fusepack_launches[k] for k in ENTRY_COUNTERS[e["name"]])
        e["wide_launches"] = sum(wide_launches[k] for k in ENTRY_COUNTERS[e["name"]])
        e["range_launches"] = sum(range_launches[k] for k in ENTRY_COUNTERS[e["name"]])
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_background()
