"""EventPrinter: test/debug output helper (reference: util/EventPrinter.java);
a copy of the JAX package's ``util/event_printer.py``."""

from __future__ import annotations

import logging
from typing import List, Optional

log = logging.getLogger("siddhi_tpu_torch.EventPrinter")


def print_events(*args):
    """print_events(events) or print_events(timestamp, in_events, out_events)."""
    if len(args) == 1:
        log.info("%s", args[0])
        print(args[0])
    else:
        ts, in_events, out_events = args
        line = f"Events{{ @timestamp = {ts}, inEvents = {in_events}, RemoveEvents = {out_events} }}"
        log.info("%s", line)
        print(line)
