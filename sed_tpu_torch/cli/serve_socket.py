"""Live streaming server CLI: PCM over TCP in, per-frame scores out
(counterpart of ``sed_tpu.cli.serve_socket``).

    python -m sed_tpu_torch.cli.serve_socket --ckpt model.pth --port 8123 \\
        [--arch CnnAvgPooling|MobileNetV1|M5] [--m5_pool device|host] \\
        [--slots 8] [--chunk_seconds 1.0] [--wire pcm16|mulaw] \\
        [--featurizer auto|pallas|xla] [--device cuda|cpu] [--run_seconds N] \\
        [--quantize int8 --calib_wav a.wav | --bf16]

Each TCP connection is one live stream over the pool of ``--arch``
(``cli.stream.build_pool``: ``StreamPool`` for the spectrogram families,
MobileNetV1 as its logits view with its halo floor; the M5 pools of
``sed_tpu_torch/waveform_streaming.py``): clients write length-prefixed
int16 PCM (or µ-law bytes) at their own rate, batched device ticks score
every stream with a full chunk staged, and closing the stream drains the
exact tail (wire protocol: ``sed_tpu_torch/serve_socket.py``).  The server
prints one JSON line with its address, then serves until ``--run_seconds``
pass (0 = forever).

Before it accepts connections on a CUDA device it runs a warmup ladder
(:func:`warmup_pool`) that drives every tick and drain shape once, so the
first clients do not pay the kernel build and the card's first-call costs;
``--no_warmup`` skips it.

``--quantize int8`` serves CnnAvgPooling and M5 through the int8 forward,
its activation scales calibrated on ``--calib_wav`` (no input exists at
start); MobileNetV1 int8 is refused with ``sed_tpu``'s message (it is served
int8 by the per-file path).

``--bf16`` serves CnnAvgPooling and M5 in the bf16 tier, as
``cli.stream --bf16`` does.  MobileNetV1 is served in float32 under it, with
a note on stderr: ``sed_tpu``'s server rebuilds MobileNetV1's logits view
without the bf16 dtype, and the port keeps that behaviour per CLI (its
stream CLI scores MobileNetV1 in bf16).

Not ported yet, and refused rather than ignored: the fast/turbo featurizer
tiers (as in ``sed_tpu_torch.cli.stream``).  Like ``sed_tpu``'s socket CLI
it has no ``--num_devices``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Live PCM streaming scorer "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--ckpt", type=str, required=True,
                   help="a port iteration_{n}.pt, a reference .pth or a sed_tpu .ckpt / .ckpt.orbax")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = pick a free port (printed on stdout)")
    p.add_argument("--slots", type=int, default=8,
                   help="max concurrent streams (pool slots)")
    p.add_argument("--chunk_seconds", type=float, default=1.0)
    p.add_argument("--tick_interval", type=float, default=0.05,
                   help="seconds between batched device ticks")
    p.add_argument("--wire", type=str, default="pcm16", choices=["pcm16", "mulaw"],
                   help="client audio encoding: int16 PCM (default) or "
                        "1-byte/sample µ-law, half the network bytes at ~38 dB "
                        "codec SQNR (a lossy serving tier); clients must send "
                        "the same encoding")
    p.add_argument("--halo", type=int, default=64)
    p.add_argument("--featurizer", type=str, default="auto",
                   help="auto|pallas (K3 + K2) or xla (PyTorch ops)")
    p.add_argument("--featurizer_precision", type=str, default="parity",
                   help="FFT precision tier; only 'parity' is ported")
    p.add_argument("--quantize", choices=["int8"], default=None,
                   help="score with the int8 forward (lossy serving mode, "
                        "CnnAvgPooling and M5); requires --calib_wav")
    p.add_argument("--calib_wav", type=str, default="",
                   help="wav file whose audio calibrates the int8 activation scales "
                        "(no input files exist at server start)")
    p.add_argument("--arch", type=str, default="CnnAvgPooling",
                   choices=["CnnAvgPooling", "MobileNetV1", "M5"],
                   help="model family: the spectrogram families stream over the "
                        "device-ring pool; M5 streams hop-strided waveform frames "
                        "(scored the moment each completes)")
    p.add_argument("--m5_pool", choices=["device", "host"], default="device",
                   help="M5 pool: 'device' (sample rings on the card, raw chunks "
                        "uploaded; scores emit per 1 s chunk; the default) or 'host' "
                        "(rolling host buffers; a frame scores on the tick after its "
                        "last sample arrives)")
    p.add_argument("--bf16", action="store_true", default=False,
                   help="bfloat16 forward (lossy serving tier; MobileNetV1 stays "
                        "float32 here, as in sed_tpu); excludes --quantize")
    p.add_argument("--no_warmup", action="store_true", default=False,
                   help="skip the warmup ladder before serving")
    p.add_argument("--max_frame_bytes", type=int, default=64 << 20,
                   help="reject client frames with a length prefix beyond "
                        "this (garbage/hostile header containment)")
    p.add_argument("--idle_timeout", type=float, default=0.0,
                   help="per-connection socket timeout in seconds; a client "
                        "stalled mid-frame loses its slot after this (0 = "
                        "wait forever, the trusted-client default)")
    p.add_argument("--drain_gather", type=float, default=0.25,
                   help="seconds a finishing stream waits for other finishers "
                        "so concurrent drains share one batched leave")
    p.add_argument("--mean_std_file", type=str, default="")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device to run on: cuda (default) or cpu")
    p.add_argument("--tau_labels", type=str, default="doorslam")
    p.add_argument("--run_seconds", type=float, default=0.0,
                   help="serve for N seconds then exit (0 = forever)")
    return p


def warmup_pool(pool, wire: str = "pcm16") -> float:
    """Drive every tick and drain shape of ``pool`` once and leave it empty;
    returns the seconds it took.

    The ladder: one stream through startup and single-round ticks; then every
    slot joined, two all-slot rounds, and multi-round blocks with 1, 4 and
    all slots active; then one batched drain of every slot.  A pool with no
    fixed chunk (``pool.chunk`` None: M5's host pool, whose piece here is
    one frame) has no multi-round blocks and stops after the first stream,
    which leaves.  It is a plain function (``sed_tpu`` ran
    the same ladder inline, on accelerators only), so the CPU tests run it
    too (fault R4).
    """
    from sed_tpu_torch.ops.mulaw import mulaw_encode

    t0 = time.time()
    rng = np.random.default_rng(0)
    base = (3000 * rng.standard_normal(pool.chunk or pool.cfg.frame_size)).astype(np.int16)
    piece = mulaw_encode(base) if wire == "mulaw" else base
    first = pool.join()
    for _ in range(4):
        pool.feed(first, piece)
        pool.tick()
    if pool.chunk is None:
        pool.leave(first)
        return time.time() - t0
    slots = [first] + [pool.join() for _ in range(pool.slots - 1)]
    for _ in range(2):
        for s in slots:
            pool.feed(s, piece)
        pool.tick()
    for n_active in (1, 4, len(slots)):
        for s in slots[:n_active]:
            pool.feed(s, np.tile(piece, pool.ROUNDS_PER_CALL + 1))
        pool.tick()
    pool.leave_many(slots)
    return time.time() - t0


def main(argv=None):
    from sed_tpu_torch.cli.stream import build_pool, refuse_unported, serving_config

    parser = build_arg_parser()
    args = parser.parse_args(argv)
    refuse_unported(parser, args)

    from sed_tpu_torch.serve_socket import StreamServer

    cfg = serving_config(args)

    def note(msg):
        print(msg, file=sys.stderr, flush=True)

    calib = None
    if args.quantize == "int8":
        if args.arch == "MobileNetV1":
            raise SystemExit("--quantize int8 streaming is implemented for "
                             "CnnAvgPooling and M5; MobileNetV1 int8 serving "
                             "is the batched path (infer/serve --quantize)")
        if not args.calib_wav:
            raise SystemExit("--quantize int8 requires --calib_wav")
        from sed_tpu_torch.io.audio import read_multichannel_audio

        calib = read_multichannel_audio(args.calib_wav, target_fs=cfg.working_sample_rate,
                                        cfg=cfg)[:, 0].astype(np.float32)
        if args.arch == "M5" and len(calib) < 2 * (cfg.frame_size // 2):
            raise SystemExit(
                f"--calib_wav is too short to yield a single {cfg.frame_size}-sample frame "
                f"({cfg.frame_size / cfg.working_sample_rate:.2f}s at "
                f"{cfg.working_sample_rate} Hz); supply a longer wav")
    pool = build_pool(
        args, cfg, args.slots, int(round(args.chunk_seconds * cfg.working_sample_rate)),
        note=note, m5_ignored=["--chunk_seconds"] if args.chunk_seconds != 1.0 else [],
        calib_wav=calib, mobilenet_bf16=False)
    if calib is not None:
        note(f"int8 serving mode: calibrated on {args.calib_wav}")
    if not args.no_warmup and pool.device.type == "cuda":
        secs = warmup_pool(pool, args.wire)
        print(f"warmup: {secs:.1f}s (every tick and drain shape driven once)",
              file=sys.stderr, flush=True)
    server = StreamServer(pool, host=args.host, port=args.port,
                          tick_interval=args.tick_interval, wire=args.wire,
                          max_frame_bytes=args.max_frame_bytes,
                          idle_timeout=args.idle_timeout or None,
                          drain_gather=args.drain_gather)
    server.start()
    print(json.dumps({"host": server.address[0], "port": server.address[1],
                      "slots": args.slots, "arch": args.arch,
                      "chunk_samples": pool.chunk, "wire": args.wire,
                      "device": str(pool.device)}), flush=True)
    try:
        if args.run_seconds > 0:
            time.sleep(args.run_seconds)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        print("shutting down", file=sys.stderr)
    finally:
        server.stop()


if __name__ == "__main__":
    main()
