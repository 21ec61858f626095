"""Command-line entry point.

Mirrors the reference's CLI contract (main.cpp:720-778):

    python -m audiorenderingv2 <config_path> [mode] [export_path]

Modes:
  main            — headless auralization: walks the configured (or a
                    default orbit) listener trajectory with the re-render
                    policy and writes the streamed result as a WAV. The
                    reference's GL-window walkthrough replaced by scripted
                    trajectories (accelerator hosts are headless).
  export          — render at the initial pose, convolve, normalize, save
                    WAV (main.cpp:653-718).
  experimentation — N timed render rounds + IR-peak Monte-Carlo statistics
                    (main.cpp:531-626).
  walkthrough     — export an interactive first-person HTML view of the
                    scene (utils/webview.py): the headless replacement for
                    the reference's live GL window. Record a walk in the
                    browser (T/E keys), then feed the downloaded JSON back
                    into ``main --trajectory`` to auralize it.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="audiorenderingv2",
        description="Differentiable acoustic renderer")
    parser.add_argument("config", help="path to config.json")
    parser.add_argument("mode", nargs="?", default="main",
                        choices=["main", "export", "experimentation",
                                 "walkthrough"])
    parser.add_argument("export_path", nargs="?", default="output.wav")
    parser.add_argument("--rounds", type=int, default=100,
                        help="experimentation rounds (reference: 100)")
    parser.add_argument("--duration", type=float, default=None,
                        help="main mode: seconds of audio to auralize")
    parser.add_argument("--trajectory", default=None,
                        help="main mode: trajectory JSON (times/positions/"
                             "yaws_deg — the walkthrough recorder's export)"
                             " instead of the default orbit")
    parser.add_argument("--embed-audio", default=None,
                        help="walkthrough mode: WAV to embed as a player")
    args = parser.parse_args(argv)

    from . import context as ctx_mod

    if args.mode == "walkthrough":
        # Geometry-only export: load just config + scene — building the
        # renderer would stage device arrays (and require the audio file)
        # for an HTML file that needs neither.
        from pathlib import Path

        from .config import load_config
        from .scene import load_scene
        from .utils.webview import write_walkthrough_html

        cfg = load_config(args.config)
        base = Path(args.config).parent
        scene_path = Path(cfg.scene.scene_file_path)
        if not scene_path.is_absolute():
            scene_path = base / scene_path
        scene = load_scene(scene_path, cfg.pathtracer.materials)
        out = args.export_path
        if out == "output.wav":  # mode-appropriate default
            out = "walkthrough.html"
        write_walkthrough_html(
            scene, out,
            emitter=cfg.scene.initial_emitter_pos,
            receiver=cfg.scene.initial_receiver_pos,
            receiver_yaw_deg=0.0,
            audio_wav_path=args.embed_audio)
        print(f"walkthrough {out}")
        return 0

    ctx = ctx_mod.load_context(args.config)

    if args.mode == "export":
        ctx_mod.export_audio(ctx, args.export_path)
        print(f"exported {args.export_path}")
        return 0

    if args.mode == "experimentation":
        from .experiment import run_experiment

        ctx.renderer.set_receiver(ctx.receiver_pos, ctx.receiver_yaw_deg)
        samples = ctx.audio.mono() if ctx.audio is not None else None
        results = run_experiment(ctx.renderer, samples, rounds=args.rounds)
        print(results.summary())
        return 0

    # mode == "main": scripted walkthrough auralization
    from .streaming import Auralizer, ListenerTrajectory, ReRenderPolicy, TrajectoryPoint
    from .io import wav as wav_io

    if ctx.audio is None:
        print("main mode without an audio file (live mode) needs an input "
              "device; use the streaming.LiveConvolver API instead.",
              file=sys.stderr)
        return 1

    samples = ctx.audio.mono()
    if args.duration is not None:
        samples = samples[: int(args.duration * ctx.sample_rate)]
    duration = len(samples) / ctx.sample_rate

    if args.trajectory is not None:
        # A recorded browser walk (utils/webview.py's T/E recorder) or any
        # JSON with times/positions/yaws_deg.
        import json

        with open(args.trajectory) as f:
            rec = json.load(f)
        traj = ListenerTrajectory.from_arrays(
            rec["times"], rec["positions"], rec["yaws_deg"])
        points = traj.points
    else:
        # Default trajectory: start at the configured receiver, orbit the
        # emitter.
        start = np.asarray(ctx.receiver_pos, np.float32)
        emitter = np.asarray(ctx.config.scene.initial_emitter_pos, np.float32)
        radius_vec = start - emitter
        points = []
        n_keys = 9
        for i in range(n_keys):
            ang = 2.0 * np.pi * i / (n_keys - 1) * 0.5  # half orbit
            c, s = np.cos(ang), np.sin(ang)
            offset = np.array([
                c * radius_vec[0] + s * radius_vec[2],
                radius_vec[1],
                -s * radius_vec[0] + c * radius_vec[2],
            ], np.float32)
            pos = emitter + offset
            yaw = float(np.degrees(np.arctan2(-offset[2], -offset[0])))
            points.append(TrajectoryPoint(duration * i / (n_keys - 1), pos,
                                          yaw))

    policy = ReRenderPolicy(
        distance_threshold=ctx.config.renderer.re_render_distance_threshold,
        angle_threshold=ctx.config.renderer.re_render_angle_threshold)
    aur = Auralizer(ctx.renderer, ListenerTrajectory(points), policy,
                    volume=ctx.volume)
    out = aur.run(samples)
    peak = np.abs(out).max()
    if peak > 0:
        out = out / peak
    wav_io.write_wav(args.export_path, out, ctx.sample_rate)
    print(f"auralized {duration:.1f}s with {aur.renders} IR renders "
          f"-> {args.export_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
