"""Progress reporting: per-chain progress snapshots and display frontends.

Mirrors the reference's progress subsystem (``src/progress.rs``): a
``ChainProgress`` snapshot per chain delivered to (1) a user callback, (2) a
terminal renderer, or (3) an HTML (Jupyter) renderer, at a configurable rate.
Exceptions in callbacks are swallowed so they never kill sampling
(``progress.rs:42-45``).  Progress is observed at chunk boundaries
of the device loop rather than per draw.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import traceback
from typing import Callable, Optional, Sequence


@dataclasses.dataclass
class ChainProgress:
    """Snapshot of one chain's progress (reference ``wrapper.rs:47-104``)."""

    chain_index: int
    finished_draws: int
    total_draws: int
    divergences: int
    tuning: bool
    started: bool
    finished: bool
    latest_num_steps: int
    total_num_steps: int
    step_size: float
    runtime_ms: float
    divergent_draws: list

    @property
    def runtime(self) -> float:
        return self.runtime_ms / 1000.0


def estimate_remaining_time(progress: Sequence[ChainProgress]) -> Optional[float]:
    """Crude remaining-time estimate from per-chain rates.

    The chains advance in lockstep on the device, so the estimate is simply
    remaining draws / observed draw rate of the slowest chain.
    """
    rates = []
    remaining = 0
    for p in progress:
        if p.runtime_ms > 0 and p.finished_draws > 0:
            rates.append(p.finished_draws / (p.runtime_ms / 1000.0))
        remaining = max(remaining, p.total_draws - p.finished_draws)
    if not rates:
        return None
    return remaining / min(rates)


class ProgressHandler:
    """Base class; dispatches snapshots at most every ``rate_ms``."""

    def __init__(self, rate_ms: int = 100):
        self.rate_ms = rate_ms
        self._last = 0.0

    def update(self, progress: list[ChainProgress], force: bool = False) -> None:
        now = time.monotonic()
        if not force and (now - self._last) * 1000.0 < self.rate_ms:
            return
        self._last = now
        try:
            self._render(progress)
        except Exception:  # never kill sampling from a progress handler
            traceback.print_exc(file=sys.stderr)

    def _render(self, progress: list[ChainProgress]) -> None:
        raise NotImplementedError

    def finalize(self, progress: list[ChainProgress]) -> None:
        self.update(progress, force=True)


class CallbackHandler(ProgressHandler):
    """Passes the snapshots to a user callback (``progress.rs:414-442``)."""

    def __init__(self, callback: Callable, rate_ms: int = 100):
        super().__init__(rate_ms)
        self._callback = callback

    def _render(self, progress):
        self._callback(progress)


class TerminalHandler(ProgressHandler):
    """Single-line terminal progress summary."""

    def __init__(self, rate_ms: int = 100, stream=None):
        super().__init__(rate_ms)
        self._stream = stream or sys.stderr
        self._start = time.monotonic()

    def _render(self, progress):
        total = sum(p.total_draws for p in progress)
        done = sum(p.finished_draws for p in progress)
        divs = sum(p.divergences for p in progress)
        steps = sum(p.total_num_steps for p in progress)
        elapsed = time.monotonic() - self._start
        rate = steps / elapsed if elapsed > 0 else 0.0
        frac = done / total if total else 0.0
        width = 30
        filled = int(frac * width)
        bar = "#" * filled + "-" * (width - filled)
        tuning = any(p.tuning for p in progress)
        phase = "tune" if tuning else "draw"
        msg = (
            f"\r[{bar}] {done}/{total} draws ({phase}) | "
            f"divergences {divs} | {rate:,.0f} grad/s   "
        )
        self._stream.write(msg)
        self._stream.flush()

    def finalize(self, progress):
        super().finalize(progress)
        self._stream.write("\n")
        self._stream.flush()


def render_template(template: str, progress: Sequence[ChainProgress]) -> str:
    """Minimal renderer for reference-style progress templates.

    Supports ``{{ name }}`` substitution of global values and
    ``{% for chain in chains %} ... {% endfor %}`` blocks with
    ``{{ chain.field }}`` per-chain values -- the subset of the ``upon``
    template language the reference's built-in template uses
    (``progress.rs:96-258``).
    """
    import re

    remaining = estimate_remaining_time(progress)
    global_vars = {
        "total_chains": len(progress),
        "finished_chains": sum(p.finished for p in progress),
        "total_draws": sum(p.total_draws for p in progress),
        "finished_draws": sum(p.finished_draws for p in progress),
        "divergences": sum(p.divergences for p in progress),
        "total_num_steps": sum(p.total_num_steps for p in progress),
        "time_remaining_estimate": (
            f"{remaining:.0f}s" if remaining is not None else "?"
        ),
    }

    def chain_vars(p: ChainProgress):
        return {
            "chain_index": p.chain_index,
            "finished_draws": p.finished_draws,
            "total_draws": p.total_draws,
            "divergences": p.divergences,
            "tuning": p.tuning,
            "started": p.started,
            "finished": p.finished,
            "latest_num_steps": p.latest_num_steps,
            "total_num_steps": p.total_num_steps,
            "step_size": f"{p.step_size:.3g}",
            "divergent_draws": p.divergent_draws,
            # computed presentation fields (the mini-renderer has no
            # conditionals; the reference's upon template colors rows by
            # state, progress.rs:260-412)
            "phase": (
                "finished" if p.finished
                else ("tuning" if p.tuning else "sampling")
            ),
            "row_class": (
                "nutpie-div" if p.divergences > 0
                else ("nutpie-done" if p.finished else "nutpie-ok")
            ),
        }

    def sub(text: str, values: dict) -> str:
        def repl(match):
            key = match.group(1).strip()
            if key.startswith("chain."):
                key = key[len("chain."):]
            return str(values.get(key, match.group(0)))

        return re.sub(r"\{\{([^}]+)\}\}", repl, text)

    loop_re = re.compile(
        r"\{%\s*for\s+chain\s+in\s+chains\s*%\}(.*?)\{%\s*endfor\s*%\}",
        re.DOTALL,
    )

    def expand_loop(match):
        body = match.group(1)
        return "".join(
            sub(body, {**global_vars, **chain_vars(p)}) for p in progress
        )

    out = loop_re.sub(expand_loop, template)
    return sub(out, global_vars)


# Default styled HTML progress (reference ships a styled upon template +
# CSS in-file, sample.py:217-356 / progress.rs:96-258; this mirrors its
# content: global header with remaining time, per-chain rows colored by
# state with progress bars, divergences, step size, gradient counts).
DEFAULT_HTML_STYLE = """
<style>
.nutpie { font-family: system-ui, sans-serif; font-size: 13px; }
.nutpie .hdr { margin-bottom: 6px; color: #333; }
.nutpie .hdr b { font-size: 14px; }
.nutpie table { border-collapse: collapse; }
.nutpie th, .nutpie td { padding: 2px 10px; text-align: right; }
.nutpie th { border-bottom: 1px solid #999; color: #333; }
.nutpie progress { width: 140px; height: 10px; accent-color: #2c7fb8; }
.nutpie tr.nutpie-div td { color: #b30000; }
.nutpie tr.nutpie-done td { color: #1a7a1a; }
</style>
"""

DEFAULT_HTML_TEMPLATE = """
<div class="nutpie">
<div class="hdr"><b>Sampling</b> &mdash; {{ finished_draws }}/{{ total_draws }} draws,
{{ finished_chains }}/{{ total_chains }} chains finished,
{{ divergences }} divergences, {{ total_num_steps }} gradient evaluations,
~{{ time_remaining_estimate }} remaining</div>
<table>
<thead><tr><th>chain</th><th>progress</th><th>draws</th><th>phase</th>
<th>divergences</th><th>step size</th><th>grad evals</th></tr></thead>
<tbody>
{% for chain in chains %}<tr class="{{ chain.row_class }}">
<td>{{ chain.chain_index }}</td>
<td><progress value="{{ chain.finished_draws }}" max="{{ chain.total_draws }}"></progress></td>
<td>{{ chain.finished_draws }}/{{ chain.total_draws }}</td>
<td>{{ chain.phase }}</td>
<td>{{ chain.divergences }}</td>
<td>{{ chain.step_size }}</td>
<td>{{ chain.total_num_steps }}</td>
</tr>
{% endfor %}</tbody></table></div>
"""


class HTMLHandler(ProgressHandler):
    """Jupyter display handler rendering styled HTML per update.

    Without an explicit ``template`` the default styled template above is
    used (reference parity: a styled table is the default, a custom upon
    template is the override)."""

    def __init__(self, rate_ms: int = 100, template: Optional[str] = None,
                 style: Optional[str] = None):
        super().__init__(rate_ms)
        from IPython.display import display

        self._display = display
        self._handle = None
        self._template = template or DEFAULT_HTML_TEMPLATE
        self._style = style if style is not None else DEFAULT_HTML_STYLE

    def _wrap(self, body: str):
        """Wrap the rendered HTML body for display.  Subclasses that do
        not go through IPython (marimo) override this to pass the raw
        string through."""
        from IPython.display import HTML

        return HTML(body)

    def _render(self, progress):
        if self._template:
            html = self._wrap(
                self._style + render_template(self._template, progress)
            )
            if self._handle is None:
                self._handle = self._display(html, display_id=True)
            else:
                self._handle.update(html)
            return
        rows = []
        for p in progress:
            frac = p.finished_draws / max(p.total_draws, 1)
            rows.append(
                f"<tr><td>{p.chain_index}</td>"
                f"<td><progress value='{p.finished_draws}' "
                f"max='{p.total_draws}'></progress></td>"
                f"<td>{p.finished_draws}/{p.total_draws}</td>"
                f"<td>{p.divergences}</td>"
                f"<td>{'tuning' if p.tuning else 'sampling'}</td>"
                f"<td>{p.step_size:.3g}</td>"
                f"<td>{p.total_num_steps}</td></tr>"
            )
        html = self._wrap(
            self._style
            + "<table><thead><tr><th>chain</th><th></th><th>draws</th>"
            "<th>divergences</th><th>phase</th><th>step size</th>"
            "<th>grad evals</th></tr></thead><tbody>"
            + "".join(rows)
            + "</tbody></table>"
        )
        if self._handle is None:
            self._handle = self._display(html, display_id=True)
        else:
            self._handle.update(html)


def in_jupyter() -> bool:
    """Environment detection (reference ``sample.py:429-469``)."""
    try:
        from IPython import get_ipython

        ip = get_ipython()
        if ip is None:
            return False
        return "IPKernelApp" in getattr(ip, "config", {})
    except Exception:
        return False


def in_marimo() -> bool:
    """marimo notebook detection (reference ``sample.py:359-425``)."""
    try:
        import marimo

        return bool(marimo.running_in_notebook())
    except Exception:
        return False


def in_databricks() -> bool:
    """Databricks notebook detection (reference ``sample.py:429-445``:
    presence of the DATABRICKS_RUNTIME_VERSION env)."""
    import os

    return "DATABRICKS_RUNTIME_VERSION" in os.environ


class MarimoHandler(HTMLHandler):
    """Progress via marimo's replaceable output (reference
    ``sample.py:561-582``): renders the same HTML table through
    ``mo.output.replace``.  Does not require IPython (marimo environments
    may lack it): ``_wrap`` passes the raw HTML string through and
    ``_display`` mimics IPython's handle protocol."""

    def __init__(self, rate_ms: int = 100, template: Optional[str] = None,
                 style: Optional[str] = None):
        import marimo as mo

        ProgressHandler.__init__(self, rate_ms)

        class _Handle:
            def update(_self, h):
                body = getattr(h, "data", h)
                mo.output.replace(mo.Html(body))

        def _display(html, display_id=True):
            handle = _Handle()
            handle.update(html)
            return handle

        self._display = _display
        self._handle = None
        self._template = template or DEFAULT_HTML_TEMPLATE
        self._style = style if style is not None else DEFAULT_HTML_STYLE

    def _wrap(self, body: str):
        return body


def make_progress_handlers(
    progress_bar: bool,
    progress_callback: Optional[Callable],
    progress_rate: int,
    progress_template: Optional[str] = None,
    progress_style: Optional[str] = None,
) -> list[ProgressHandler]:
    handlers: list[ProgressHandler] = []
    if progress_callback is not None:
        handlers.append(CallbackHandler(progress_callback, progress_rate))
    if progress_bar:
        # frontend selection mirrors the reference (sample.py:526-584):
        # marimo > jupyter/databricks HTML > terminal; every fallback lands
        # on the terminal bar, and handler errors never kill sampling
        try:
            if in_marimo():
                handlers.append(
                    MarimoHandler(progress_rate, progress_template,
                                  progress_style)
                )
            elif in_jupyter() or in_databricks():
                handlers.append(
                    HTMLHandler(progress_rate, progress_template,
                                progress_style)
                )
            else:
                handlers.append(TerminalHandler(progress_rate))
        except Exception:
            handlers.append(TerminalHandler(progress_rate))
    return handlers
