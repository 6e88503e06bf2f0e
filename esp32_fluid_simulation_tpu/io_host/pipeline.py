"""The interactive host pipeline: the reference's three-task FreeRTOS
architecture reborn around a jitted device step.

Reference mapping (SURVEY.md §3):
  touch_routine (.ino:63-96)  -> an input thread pushing drags into the
                                 native lossy DragQueue at its own rate;
  loop()        (.ino:249-289)-> the sim thread: drain queue -> impulses ->
                                 jitted step -> dispatch render;
  draw_routine  (.ino:99-191) -> the consumer thread: fetch the rendered
                                 frame (device->host), convert natively, hand
                                 to a sink (file/display).

The two-semaphore 1-slot handshake (.ino:58-59) lives in C++
(``FrameHandshake``); frame N is fetched by the consumer while frame N+1
simulates — JAX async dispatch plays the role of the ESP32's second core,
and the double-buffered DMA becomes device-compute / host-transfer overlap.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np
import jax

from ..config import SimConfig
from ..state import Impulses
from ..models.stable_fluids import init_state
from ..models import make_step, make_step_render
from .native import DragQueue, FrameHandshake, FramePacer, rgb565_to_rgb888


class SimPipeline:
    """Producer/consumer sim+render pipeline with native synchronization.

    frame_sink(rgb888: np.ndarray [H,W,3], step: int) is called on the
    consumer thread for every frame.
    """

    def __init__(self, cfg: SimConfig, frame_sink: Callable,
                 fps: Optional[float] = None, queue_depth: int = 10):
        self.cfg = cfg
        self.frame_sink = frame_sink
        self.fps = fps if fps is not None else 1.0 / cfg.dt
        self.queue = DragQueue(queue_depth)
        self.handshake = FrameHandshake()
        self._frame_slot = None
        self._stop = threading.Event()
        self._step_fn = make_step(cfg, donate=False)
        # one device program per frame (step + render inline): one
        # dispatch per frame
        self._step_render_fn = make_step_render(cfg, donate=False)
        self._frames_done = 0

    # -- input side (touch_routine's role) --------------------------------
    def push_drag(self, i: int, j: int, vi: float, vj: float) -> bool:
        """Non-blocking, lossy (.ino:85). Sim-frame coords."""
        return self.queue.try_push(i, j, vi, vj)

    # -- threads ----------------------------------------------------------
    def _sim_thread(self, n_frames: int):
        state = init_state(self.cfg)
        pacer = FramePacer(self.fps)
        try:
            for _ in range(n_frames):
                if self._stop.is_set():
                    break
                drags = self.queue.drain(self.cfg.max_impulses)
                # queue entries are already sim-frame (i, j, vi, vj)
                imp = (Impulses.from_lists(
                           self.cfg, [(i, j) for i, j, _, _ in drags],
                           [(vi, vj) for _, _, vi, vj in drags])
                       if drags else Impulses.none(self.cfg))
                state, frame = self._step_render_fn(state, imp)
                # 1-slot publish: wait until the consumer took the previous
                # frame; poll the stop flag so a dead consumer can't wedge us
                while not self.handshake.producer_acquire(timeout_ms=200):
                    if self._stop.is_set():
                        return
                self._frame_slot = (frame, None)
                self.handshake.producer_publish()
                pacer.wait()
        finally:
            self._stop.set()
            self.handshake.producer_publish()  # unblock consumer shutdown

    def _consumer_thread(self):
        n = 0
        try:
            while True:
                self.handshake.consumer_acquire()
                if self._frame_slot is None:
                    if self._stop.is_set():
                        break
                    continue
                frame, _ = self._frame_slot
                self._frame_slot = None
                self.handshake.consumer_release()
                host = np.asarray(jax.device_get(frame))  # blocks on fetch
                rgb = rgb565_to_rgb888(host)
                self.frame_sink(rgb, n)
                n += 1
                if self._stop.is_set():
                    break
        except Exception as e:  # surfaced by run(); must not hang the sim
            self._error = e
        finally:
            # a frame_sink exception must not strand the producer in
            # producer_acquire: flag the stop and free the slot
            self._stop.set()
            self.handshake.consumer_release()
            self._frames_done = n

    # -- run --------------------------------------------------------------
    def run(self, n_frames: int) -> int:
        """Run the pipeline for ``n_frames``; returns frames delivered.
        Re-raises the first frame_sink exception, if any."""
        self._error = None
        sim = threading.Thread(target=self._sim_thread, args=(n_frames,),
                               name="sim")
        consumer = threading.Thread(target=self._consumer_thread,
                                    name="draw")
        consumer.start()
        sim.start()
        sim.join()
        self._stop.set()
        self.handshake.producer_publish()
        consumer.join(timeout=10)
        if self._error is not None:
            raise self._error
        return self._frames_done

    def stop(self):
        self._stop.set()
