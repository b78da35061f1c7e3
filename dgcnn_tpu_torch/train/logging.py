"""CSV + stdout run logging (port of `dgcnn_tpu/train/logging.py`).

Report lines on stdout (iter, epoch, metrics, t/iter) and a CSV log per
run, with the JAX package's columns: ``iter``, ``epoch``, the metrics,
``lr``, ``val_*`` and ``titer``. TensorBoard scalars are optional
(``torch.utils.tensorboard`` where it is installed). ``--profile_dir``
records the run with `torch.profiler` and writes a Chrome trace there.
"""

from __future__ import annotations

import os
import sys
import time

from dgcnn_tpu_torch.utils.timing import profiler


class CSVData:
    """Append-only CSV log.

    With ``append=True`` an existing file is continued (auto-resume after
    preemption must not wipe the history) and the header is only written
    when the file is new/empty.
    """

    def __init__(self, path: str, append: bool = False):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.path = path
        self._append = append
        self._file = None
        self._keys = None

    def write(self, row: dict):
        if self._file is None:
            existing_header = None
            if self._append and os.path.exists(self.path):
                with open(self.path) as f:
                    first = f.readline().strip()
                existing_header = first.split(",") if first else None
            self._file = open(self.path, "a" if self._append else "w")
            self._keys = existing_header or list(row.keys())
            if existing_header is None:
                self._file.write(",".join(self._keys) + "\n")
        extra = [k for k in row if k not in self._keys]
        if extra:
            # a resumed run gained columns (e.g. --val_file added): extend
            # the header and pad history instead of silently dropping them
            self._extend_header(extra)
        vals = [row.get(k, "") for k in self._keys]
        self._file.write(
            ",".join(f"{v:.6g}" if isinstance(v, float) else str(v) for v in vals)
            + "\n"
        )
        self._file.flush()

    def _extend_header(self, extra: list):
        self._file.close()
        with open(self.path) as f:
            lines = f.read().splitlines()
        self._keys = self._keys + extra
        pad = "," * len(extra)
        # write-then-rename: a crash mid-rewrite must not destroy the
        # run's metrics history (same discipline as checkpoint.save)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(",".join(self._keys) + "\n")
            for line in lines[1:]:
                f.write(line + pad + "\n")
        os.replace(tmp, self.path)
        self._file = open(self.path, "a")

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


class Reporter:
    """stdout report lines + CSV (+ optional TensorBoard scalars).

    TensorBoard uses ``torch.utils.tensorboard`` when it is installed and
    degrades to CSV only otherwise.
    """

    def __init__(
        self,
        log_dir: str,
        name: str = "train",
        tensorboard: bool = False,
        append: bool = False,
        start_iter: int = 0,
    ):
        self.csv = CSVData(os.path.join(log_dir, f"{name}_log.csv"), append=append)
        self._t_last = time.perf_counter()
        # a resumed run's first report must divide by the iterations run
        # THIS session, not by the absolute step count (t/iter would be
        # understated ~start/report_step-fold otherwise)
        self._iter_last = start_iter
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, f"{name}_tb"))
            except Exception as e:  # keep training; CSV still records
                print(f"tensorboard writer unavailable: {e}", file=sys.stderr)

    def report(self, iteration: int, epoch: float, metrics: dict):
        now = time.perf_counter()
        di = max(iteration - self._iter_last, 1)
        t_iter = (now - self._t_last) / di
        self._t_last, self._iter_last = now, iteration
        row = {"iter": iteration, "epoch": round(epoch, 4)}
        row.update({k: float(v) for k, v in metrics.items()})
        row["titer"] = t_iter
        self.csv.write(row)
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), iteration)
            self._tb.add_scalar("titer", t_iter, iteration)
        parts = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
        print(
            f"iter {iteration} epoch {epoch:.2f} {parts} t/iter {t_iter*1e3:.1f} ms",
            flush=True,
        )

    def close(self):
        self.csv.close()
        if self._tb is not None:
            self._tb.close()


def maybe_start_profiler(profile_dir: str):
    """A started `utils.timing.profiler` session, or None without a
    ``profile_dir``."""
    prof = profiler(profile_dir)
    if prof is not None:
        prof.start()
    return prof


def maybe_stop_profiler(prof) -> None:
    """Stop a session of `maybe_start_profiler` and write its Chrome
    trace (``{profile_dir}/trace-{pid}.json``)."""
    if prof is not None:
        prof.stop()
        prof.export_chrome_trace(prof.trace_path)
