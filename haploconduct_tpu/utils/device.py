"""What the program reports about the card it runs on."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them. A card may be set below its maximum power and then runs slower
    under load, so every measurement is reported beside this line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
