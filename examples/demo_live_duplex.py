"""Live full-duplex auralization — the reference's microphone path
(audioHandlerWithMic, main.cpp:99-135) with a file standing in for the mic.

A WAV is fed block-by-block through LiveConvolver (circular convolution
against the current IR + ring-buffer overlap accumulation); the interleaved
output streams through the native C++ audio engine (RtAudio-equivalent
paced pump) into a raw sink, then is rewrapped as a WAV.

Usage: python examples/demo_live_duplex.py [out.wav]
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import audiorenderingv2 as ar
from audiorenderingv2 import native, testing
from audiorenderingv2.io import wav as wav_io
from audiorenderingv2.renderer import AudioRenderer
from audiorenderingv2.streaming import LiveConvolver

REF_WAV = "/root/reference/assets/sound_samples/experimento_entrada_16KHz.wav"
BLOCK = 4096  # input frames per callback (main.cpp mic path)


def main(out_path="demo_live.wav"):
    v, t = testing.box_room((12.0, 9.0, 10.0))
    scene = testing.scene_from_arrays(v, t, 0.3)
    renderer = AudioRenderer(scene, ir_seconds=1, sample_rate=16000,
                             n_rays=20_000, base_power=3.62, max_bounces=8)
    renderer.set_receiver(np.array([3.0, 1.0, -2.0], np.float32), 20.0)
    renderer.render()
    print("IR rendered; streaming input blocks through the live path")

    if Path(REF_WAV).exists():
        mic = wav_io.read_wav(REF_WAV).mono()[: 16000 * 6]
    else:
        rng = np.random.default_rng(0)
        mic = (rng.normal(size=16000 * 6) * 0.1).astype(np.float32)

    conv = LiveConvolver(renderer, volume=1.0)
    use_native = native.available()
    engine = None
    raw_sink = Path(out_path).with_suffix(".f64")
    if use_native:
        engine = native.NativeAudioEngine(
            str(raw_sink), ring_capacity=1 << 22, sample_rate=16000,
            channels=2, frames_per_buffer=256, realtime=False)

    outputs = []
    n_blocks = len(mic) // BLOCK
    for i in range(n_blocks):
        block_out = conv.process_block(mic[i * BLOCK:(i + 1) * BLOCK])
        outputs.append(block_out)
        if engine is not None:
            engine.add(block_out)
            engine.drain_ticks(BLOCK // 256)

    if engine is not None:
        print(f"native engine: {engine.frames_streamed} frames streamed, "
              f"{engine.underruns} underruns")
        engine.close()
        data = np.fromfile(raw_sink, dtype="<f8").reshape(-1, 2).T
        raw_sink.unlink()
    else:
        inter = np.concatenate(outputs)
        data = inter.reshape(-1, 2).T
    peak = np.abs(data).max()
    wav_io.write_wav(out_path, (data / peak if peak > 0 else data).astype(np.float32), 16000)
    print(f"wrote {out_path} ({data.shape[1] / 16000:.1f}s, "
          f"native engine: {use_native})")


if __name__ == "__main__":
    main(*sys.argv[1:])
