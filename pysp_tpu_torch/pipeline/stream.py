"""The several-file driver: host decode, copies, develop and save overlapped.

Counterpart of ``pysp_tpu/pipeline/stream.py``, with the same signatures plus
``device=``, the same order (input order kept) and the same bounds: at most
``decode_workers + prefetch`` decoded frames wait on the host, and at most
``prefetch + 1`` frames are in flight on the device.

The JAX driver gets its overlap from asynchronous dispatch. In PyTorch a copy
from pageable memory and ``.cpu()`` block the calling thread, and everything
on one stream runs in order, so on a CUDA device the driver overlaps the
phases itself:

    decode[i+k] (thread pool, host)  ||  copy in[i+1] (upload stream)
        ||  develop[i] (compute stream)  ||  copy out[i-1] (download stream)
        ||  save[i-2] (``develop_files``' writer pool, host)

- The decode workers run ``load_raw(src, device="cpu")`` (or ``loader``) and
  put the frame's tensors in pinned (page-locked) host memory. They launch no
  device work.
- The driver thread, and only it, launches device work. It copies a decoded
  frame with ``non_blocking=True`` on the upload stream and records an event;
  the compute stream waits on that event and develops; the download stream
  waits on the develop's event and copies the image into a pinned host
  tensor, then records an event that the driver synchronizes only when it
  yields that file.
- Memory that one stream allocates and another reads is handed over with
  ``Tensor.record_stream``, so the caching allocator does not give it to the
  next frame while a stream still reads it. Pinned host blocks go back to
  PyTorch's host allocator only after the copies that read them completed.
- The kernels' first-use build runs on the driver thread before the pool
  starts.

How much of the host work overlaps depends on which of it releases the
interpreter lock: the native codecs and the PNG writer (ctypes calls), the
large NumPy operations and the file reads and writes do; decode loops written
in Python do not.

With ``device="cpu"`` the same loop runs without streams. A decode or save
error propagates and names its file.

With the recorder of ``utils/tracing.py`` on, every span of one file carries
that file's item id: ``stream.decode`` and ``stream.pin`` on a decode worker,
``stream.wait_decode`` (blocked on the file's decode), ``stream.launch``
(copy in, develop and copy out enqueued) and ``stream.wait_card`` (blocked on
its copy out) on the driver thread, and in ``develop_files``
``stream.wait_save`` (the driver blocked on the file's save) and
``stream.save`` on a save worker; the counter ``stream.files`` counts the
files handed on.
"""
from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import torch

from ..core.device import CARD, resolve_device
from ..core.frame import RawFrame
from ..demosaic import develop_route
from ..utils.tracing import count, new_item, span
from .develop import DevelopConfig, develop

__all__ = ["develop_stream", "develop_files"]

_FIELDS = ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat")


def _naming(err: Exception, what: str, src) -> Exception:
    """``err`` again, of its own type where that type takes one message, with
    ``what`` and the file named in front of its message."""
    message = f"{what} {src}: {err}"
    try:
        return type(err)(message)
    except Exception:  # a type whose constructor takes other arguments
        return RuntimeError(message)


def _pinned(frame: RawFrame) -> RawFrame:
    """A host frame with every tensor in page-locked memory (a worker's last
    step); a frame on a device stays as it is."""
    if frame.device.type != "cpu":
        return frame
    return frame.replace(**{k: getattr(frame, k).pin_memory() for k in _FIELDS})


class _CudaLanes:
    """The three CUDA streams of the driver and what crosses between them."""

    def __init__(self, device: torch.device):
        self.device = device
        self.upload = torch.cuda.Stream(device)
        self.compute = torch.cuda.Stream(device)
        self.download = torch.cuda.Stream(device)

    def launch(self, frame: RawFrame, cfg: DevelopConfig):
        """Copy in, develop and copy out one frame; returns the pinned host
        image and the event that marks its copy done."""
        with torch.cuda.stream(self.upload):
            if frame.device.type != "cpu":
                # a loader that loaded onto a device did so on the default stream
                self.upload.wait_stream(torch.cuda.default_stream(self.device))
            moved = frame.replace(**{
                k: getattr(frame, k).to(self.device, non_blocking=True) for k in _FIELDS
            })
            copied = torch.cuda.Event()
            copied.record(self.upload)
        self.compute.wait_event(copied)
        with torch.cuda.stream(self.compute):
            for k in _FIELDS:
                getattr(moved, k).record_stream(self.compute)
            out = develop(moved, cfg)
            developed = torch.cuda.Event()
            developed.record(self.compute)
        self.download.wait_event(developed)
        with torch.cuda.stream(self.download):
            out.record_stream(self.download)
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.download)
        return host, done


def develop_stream(
    sources: Sequence,
    cfg: DevelopConfig = DevelopConfig(),
    decode_workers: int = 4,
    prefetch: int = 2,
    loader: Optional[Callable] = None,
    device=CARD,
):
    """Yield ``(source, developed sRGB (H, W, 3) float32 ndarray)`` pairs in
    input order, with decode, copies and develop overlapped.

    ``loader(src)`` returns a ``RawFrame``, best on the host (the default,
    ``load_raw(src, device="cpu")``); ``prefetch`` bounds the decoded frames
    waiting on the host (one 24 MP frame is about 96 MB) to ``decode_workers +
    prefetch`` and the frames in flight on ``device`` (the card unless the
    caller asks for another) to ``prefetch + 1``. On a CUDA device the yielded
    array is a view of pinned host memory, released when the caller drops it.
    """
    with contextlib.closing(_developed(sources, cfg, decode_workers, prefetch, loader,
                                       device)) as developed:
        for src, image, _ in developed:
            yield src, image


def _developed(sources, cfg, decode_workers, prefetch, loader, device):
    """``develop_stream``'s loop, yielding ``(source, image, item id)``."""
    device = resolve_device(device)
    if loader is None:
        from ..io.raw_loader import load_raw

        def loader(src):
            return load_raw(src, device="cpu")

    sources = list(sources)
    if not sources:
        return
    lanes = None
    if device.type == "cuda":
        lanes = _CudaLanes(device)
        # whether the develop's route launches kernels does not depend on the
        # frame's shape, which no decode has given yet
        if develop_route(cfg.quality, cfg.use_pallas, device, ()).uses_kernels:
            from ..ops.cuda_kernels import load_library

            load_library()

    def decode(src, item):
        with span("stream.decode", item=item):
            frame = loader(src)
        if lanes is None:
            return frame
        with span("stream.pin", item=item):
            return _pinned(frame)

    pool = ThreadPoolExecutor(max_workers=decode_workers, thread_name_prefix="pysp-decode")
    try:
        pending: List[tuple] = []    # (source, decode future, item)
        in_flight: List[tuple] = []  # (source, host image, event or None, item)
        idx = 0

        def fill():
            nonlocal idx
            while idx < len(sources) and len(pending) < decode_workers + prefetch:
                item = new_item()
                pending.append((sources[idx], pool.submit(decode, sources[idx], item), item))
                idx += 1

        fill()
        while pending or in_flight:
            # launch device work for every decoded frame, up to the prefetch bound
            while pending and len(in_flight) <= prefetch:
                src, fut, item = pending.pop(0)
                try:
                    with span("stream.wait_decode", item=item):
                        frame = fut.result()
                except Exception as e:
                    raise _naming(e, "decoding", src) from e
                with span("stream.launch", item=item):
                    if lanes is None:
                        in_flight.append((src, develop(frame.to(device), cfg), None, item))
                    else:
                        in_flight.append((src, *lanes.launch(frame, cfg), item))
                del frame
                fill()
            src, image, done, item = in_flight.pop(0)
            if done is not None:
                with span("stream.wait_card", item=item):
                    done.synchronize()
            count("stream.files")
            yield src, image.numpy(), item
            del image
            fill()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def develop_files(
    paths: Sequence[str],
    out_dir: str,
    cfg: DevelopConfig = DevelopConfig(),
    ext: str = ".png",
    decode_workers: int = 4,
    save_workers: int = 2,
    device=CARD,
) -> List[str]:
    """Develop many raw files into ``out_dir`` (``<stem><ext>``, saved by
    ``save_image``) with decode, copies, develop and save overlapped, on
    ``device`` (the card unless the caller asks for another).

    Returns the written paths (input order kept). At most ``2 *
    save_workers`` images wait for their save."""
    from ..io.image_out import save_image

    os.makedirs(out_dir, exist_ok=True)
    written: List[str] = []
    saves: List[tuple] = []  # (destination, save future, item)

    def save(dst, srgb, item):
        with span("stream.save", item=item):
            save_image(dst, srgb)

    def finish(dst, fut, item):
        try:
            with span("stream.wait_save", item=item):
                fut.result()
        except Exception as e:
            raise _naming(e, "saving", dst) from e

    with ThreadPoolExecutor(max_workers=save_workers, thread_name_prefix="pysp-save") as savers:
        try:
            # develop_stream's loop with its default prefetch and loader
            with contextlib.closing(_developed(paths, cfg, decode_workers, 2, None,
                                               device)) as developed:
                for src, srgb, item in developed:
                    dst = os.path.join(
                        out_dir, os.path.splitext(os.path.basename(str(src)))[0] + ext
                    )
                    while len(saves) >= 2 * save_workers:
                        finish(*saves.pop(0))
                    saves.append((dst, savers.submit(save, dst, srgb, item), item))
                    written.append(dst)
            while saves:
                finish(*saves.pop(0))
        finally:
            for _, fut, _ in saves:
                fut.cancel()
    return written

