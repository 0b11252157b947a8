"""Single-slot async host task.

Copy of ``ipu_path_trace_tpu/runtime/async_task.py`` (the reference's
AsyncTask.hpp).  One background thread runs the host's post-processing
of a step (film accumulation, worklist upkeep, checkpoint and save) while
the main thread renders the next one.  Exactly one task may be in
flight: scheduling a second before waiting for the first raises.  A
task's exception is raised again in the thread that waits for it.
"""

from __future__ import annotations

import threading
from typing import Callable


class AsyncTask:
    def __init__(self) -> None:
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def run(self, fn: Callable[[], None]) -> None:
        if self._thread is not None:
            raise RuntimeError("Trying to run a new task before the previous one completed.")
        self._error = None

        def wrapper():
            try:
                fn()
            except BaseException as e:  # raised again in wait_for_completion
                self._error = e

        self._thread = threading.Thread(target=wrapper, name="host_processing")
        self._thread.start()

    def is_running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait_for_completion(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self._error is not None:
                err, self._error = self._error, None
                raise err
