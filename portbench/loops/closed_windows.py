"""Closed loop over a staged layer: one ``reduce_frames`` call a window of
consecutive frames, the next sent when the last has come back, wrapping at
the layer's end (the streaming scenario's ``window_frames``).

Mix parameters: ``window_frames``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench import judge as judging
from portbench.gen import frames as gen_frames


@dataclass
class Layer:
    frames: np.ndarray          # (F, H, W) in host memory, detector dtype
    dark: np.ndarray            # (H, W) float32
    threshold: float
    window: int


def prepare(config, mix, seed: int, device: torch.device) -> Layer:
    """Render the configuration's layer on the device from ``seed`` and
    hold it in host memory, as a staged node-local replica."""
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    frames, dark = gen_frames.layer(config["frames"], config["height"],
                                    config["width"],
                                    config["spots_per_frame"],
                                    config["frame_dtype"], gen, device)
    return Layer(frames, dark, float(config["threshold"]),
                 int(mix.get("window_frames", 1)))


def call(sess, layer: Layer, first: int, due=None) -> None:
    """One request: stage 1 of ``layer.window`` frames from ``first``."""
    stack = layer.frames[first:first + layer.window]
    meta = {"frames": stack.shape[0], "height": stack.shape[1],
            "width": stack.shape[2], "itemsize": stack.itemsize,
            "bytes_in": stack.nbytes + layer.dark.nbytes}
    sess.request("reduce_frames",
                 lambda: sess.program.reduce_frames(
                     stack, layer.dark, layer.threshold, sess.run.timings),
                 items=stack.shape[0], key=(first, stack.shape[0]), due=due,
                 meta=meta)


def warmup(layer: Layer, program) -> None:
    """Two calls at the window's shape, on the layer's last window."""
    first = layer.frames.shape[0] - layer.window
    for _ in range(2):
        program.reduce_frames(layer.frames[first:], layer.dark,
                              layer.threshold)


def window(sess, layer: Layer) -> None:
    n = layer.frames.shape[0] // layer.window
    sess.start()
    i = 0
    while True:
        call(sess, layer, (i % n) * layer.window)
        i += 1
        if sess.over():
            break


def judge(layer: Layer, answers, requests, device):
    return judging.frames(answers, layer.frames, layer.dark, layer.threshold,
                          device)
