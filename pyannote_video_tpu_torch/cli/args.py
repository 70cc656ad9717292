"""Minimal docopt-style argument parsing for the two CLIs.

The reference uses ``docopt`` (not available in this image); this module
parses the same grammar shapes — ``command [options] <positionals>`` with
``--opt=value`` / ``--flag`` options — and keeps the reference's usage
strings as the ``--help`` output, so the CLI surface is identical
(`scripts/pyannote-face.py:35-89`, `scripts/pyannote-structure.py:36-53`).
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List, Optional, Sequence


class CliError(SystemExit):
    pass


def parse(usage: str, version: str, argv: Optional[Sequence[str]] = None,
          commands: Sequence[str] = (), positionals: Dict[str, List[str]] = {},
          defaults: Dict[str, Optional[str]] = {}) -> Dict[str, object]:
    """Parse argv against a fixed grammar.

    Parameters
    ----------
    usage : str
        Full usage/help text (printed for -h/--help).
    commands : list of str
        Allowed leading commands.
    positionals : {command: [<name>, ...]}
        Positional argument names per command.
    defaults : {--option: default-or-None}
        Known options; None default means flag (boolean).

    Returns a docopt-like dict: {command: bool, '<name>': value,
    '--option': value}.
    """
    argv = list(sys.argv[1:] if argv is None else argv)

    if any(a in ("-h", "--help") for a in argv):
        print(usage)
        raise SystemExit(0)
    if "--version" in argv:
        print(version)
        raise SystemExit(0)

    result: Dict[str, object] = {c: False for c in commands}
    for opt, default in defaults.items():
        result[opt] = False if default is None else default

    if not argv or argv[0] not in commands:
        print(usage)
        raise CliError(1)
    command = argv.pop(0)
    result[command] = True

    pos_names = list(positionals.get(command, []))
    pos_values: List[str] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("--"):
            if "=" in arg:
                key, value = arg.split("=", 1)
            else:
                key = arg
                # flag, or option whose value is the next token
                if key in defaults and defaults[key] is None:
                    value = True
                elif i + 1 < len(argv):
                    i += 1
                    value = argv[i]
                else:
                    value = True
            if key not in defaults:
                print(usage)
                raise CliError(f"unknown option: {key}")
            result[key] = value
        else:
            pos_values.append(arg)
        i += 1

    if len(pos_values) != len(pos_names):
        print(usage)
        raise CliError(
            f"expected {len(pos_names)} arguments for '{command}' "
            f"({' '.join(pos_names)}), got {len(pos_values)}"
        )
    for name, value in zip(pos_names, pos_values):
        result[name] = value
    return result
