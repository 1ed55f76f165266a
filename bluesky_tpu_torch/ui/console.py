"""Headless console: command-line editing state, history, autocomplete.

Port of ``bluesky_tpu/ui/console.py``: host code, copied unchanged.

The reference console is a Qt widget (ui/qtgl/console.py:49-184) with the
command-line/history/autocomplete logic interleaved with Qt key events;
here that logic is a plain object driving any frontend (the text client in
``__main__``, tests, or a future GUI), and the IC/BATCH scenario-filename
autocompletion (ui/qtgl/autocomplete.py:20-56) cycles through matches the
same way.
"""
import glob
import os
from typing import Callable, List, Optional


def iglob(pattern):
    """Case-insensitive glob (reference autocomplete.py:11-15)."""
    def either(c):
        return f"[{c.lower()}{c.upper()}]" if c.isalpha() else c
    return sorted(glob.glob("".join(map(either, pattern))))


class Autocomplete:
    """IC/BATCH scenario filename completion, cycling through matches."""

    def __init__(self, scenario_path: str = "scenario"):
        self.scenario_path = scenario_path
        self._previous = ""

    def reset(self):
        self._previous = ""

    def complete(self, cmdline: str):
        """(newcmd, displaytext): completed line + candidates hint
        (reference autocomplete.py:23-56)."""
        parts = cmdline.upper().split()
        if not parts or parts[0] not in ("IC", "BATCH"):
            return cmdline, ""
        g = self.scenario_path
        if not g.endswith(os.sep):
            g += os.sep
        striplen = len(g)
        if len(parts) == 2 and not self._previous:
            g += parts[1].strip()
        elif self._previous:
            g = self._previous
        self._previous = g
        files = iglob(g + "*")
        if not files:
            return cmdline, ""
        if len(files) == 1:
            return f"{parts[0]} {files[0][striplen:]}", ""
        # Common prefix + candidate list
        prefix = os.path.commonprefix(files)
        display = ", ".join(f[striplen:] for f in files[:20])
        return f"{parts[0]} {prefix[striplen:]}", display


class Console:
    """Command-line state machine (reference console.py:49-184).

    ``stack_fn`` receives completed command lines; ``echo_fn`` (optional)
    receives display text (autocomplete candidate lists).
    """

    def __init__(self, stack_fn: Callable[[str], None],
                 echo_fn: Optional[Callable[[str], None]] = None,
                 scenario_path: str = "scenario"):
        self.stack_fn = stack_fn
        self.echo_fn = echo_fn or (lambda _t: None)
        self.command_line = ""
        self.command_history: List[str] = []
        self.history_pos = 0
        self.command_mem = ""
        self.autocomplete = Autocomplete(scenario_path)

    # ------------------------------------------------------------ editing
    def set_cmdline(self, text: str):
        """Replace the command line; any edit invalidates the cached
        autocomplete glob (Tab must match the text now on the line)."""
        self.command_line = text
        self.autocomplete.reset()

    def append_cmdline(self, text: str):
        """Append text (radarclick output); '\\n' submits/clears
        (reference console.py:100-101 + mainwindow radarclick wiring)."""
        if text.endswith("\n"):
            self.command_line = ""
        else:
            self.command_line += text
        self.autocomplete.reset()     # line changed: stale glob invalid

    def stack(self, text: Optional[str] = None):
        """Submit a command line (reference console.py:82-92)."""
        text = self.command_line if text is None else text
        if not text.strip():
            return
        self.command_history.append(text)
        self.stack_fn(text)
        self.command_line = ""
        self.history_pos = 0
        self.autocomplete.reset()

    # ----------------------------------------------------------- keys
    def key_enter(self):
        self.stack()

    def key_up(self):
        """History back (reference console.py:140-146)."""
        if self.history_pos == 0:
            self.command_mem = self.command_line
        if len(self.command_history) >= self.history_pos + 1:
            self.history_pos += 1
            self.command_line = self.command_history[-self.history_pos]
            self.autocomplete.reset()

    def key_down(self):
        """History forward (reference console.py:148-156)."""
        if self.history_pos > 0:
            self.history_pos -= 1
            self.command_line = self.command_mem if self.history_pos == 0 \
                else self.command_history[-self.history_pos]
            self.autocomplete.reset()

    def key_tab(self):
        """Filename autocomplete for IC/BATCH (reference console.py:158+)."""
        if self.command_line:
            newcmd, display = self.autocomplete.complete(self.command_line)
            self.command_line = newcmd
            if display:
                self.echo_fn(display)

    def key_backspace(self):
        self.command_line = self.command_line[:-1]
        self.autocomplete.reset()

    def key_char(self, ch: str):
        self.command_line += ch
        self.autocomplete.reset()
