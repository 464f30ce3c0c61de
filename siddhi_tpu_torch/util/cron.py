"""Cron schedules: the next fire time of a cron expression.

Port of ``CronSchedule`` of the JAX package's ``core/trigger.py`` for
the ``#window.cron`` window and cron triggers (``core/trigger.py``):
Quartz 6/7-field or unix 5-field expressions at second granularity,
without Quartz.
"""

from __future__ import annotations

import calendar
import datetime
from typing import Optional, Set

from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError


def _parse_field(spec: str, lo: int, hi: int, names=None) -> Set[int]:
    out: Set[int] = set()
    for part in spec.split(","):
        part = part.strip()
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part in ("*", "?", ""):
            lo2, hi2 = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            lo2, hi2 = _name_to_int(a, names), _name_to_int(b, names)
        else:
            v = _name_to_int(part, names)
            lo2 = hi2 = v if step == 1 else v
            if step != 1:
                hi2 = hi
        for v in range(lo2, hi2 + 1, step):
            if lo <= v <= hi:
                out.add(v)
    return out


def _name_to_int(s: str, names) -> int:
    s = s.strip()
    if names and s.upper() in names:
        return names[s.upper()]
    return int(s)


_MONTHS = {m.upper(): i + 1 for i, m in enumerate(calendar.month_abbr[1:])}
# cron: 0/7=SUN..6=SAT ; python weekday(): 0=MON..6=SUN
_DOWS = {"SUN": 0, "MON": 1, "TUE": 2, "WED": 3, "THU": 4, "FRI": 5, "SAT": 6}


def _dow_field(spec: str, is_unix: bool) -> Set[int]:
    """Day-of-week field -> 0-based set (0=SUN..6=SAT).  Numeric values
    follow the expression dialect: unix 0/7=SUN..6=SAT, Quartz 1=SUN..7=SAT."""
    s = spec.upper()
    for name, num in _DOWS.items():
        s = s.replace(name, str(num if is_unix else num + 1))
    vals = _parse_field(s, 0, 7)
    if is_unix:
        return {v % 7 for v in vals}
    return {(v - 1) % 7 for v in vals}


class CronSchedule:
    """Parses a cron expression and computes next fire times (second
    granularity).  Accepts unix 5-field (min hour dom mon dow) and Quartz
    6/7-field (sec min hour dom mon dow [year])."""

    def __init__(self, expr: str):
        fields = expr.split()
        is_unix = len(fields) == 5
        if is_unix:
            fields = ["0"] + fields  # unix form: fire at second 0
        if len(fields) == 7:
            fields = fields[:6]  # ignore the year field
        if len(fields) != 6:
            raise SiddhiAppCreationError(f"invalid cron expression '{expr}'")
        sec, mnt, hr, dom, mon, dow = fields
        self.seconds = sorted(_parse_field(sec, 0, 59))
        self.minutes = sorted(_parse_field(mnt, 0, 59))
        self.hours = sorted(_parse_field(hr, 0, 23))
        self.dom = _parse_field(dom, 1, 31)
        self.months = _parse_field(mon, 1, 12, _MONTHS)
        self.dow = _dow_field(dow, is_unix)
        self.dom_any = dom.strip() in ("*", "?")
        self.dow_any = dow.strip() in ("*", "?")

    def _day_matches(self, d: datetime.date) -> bool:
        if d.month not in self.months:
            return False
        dom_ok = d.day in self.dom
        dow_ok = ((d.weekday() + 1) % 7) in self.dow  # python MON=0 -> cron SUN=0
        if self.dom_any and self.dow_any:
            return True
        if self.dom_any:
            return dow_ok
        if self.dow_any:
            return dom_ok
        return dom_ok or dow_ok  # Quartz semantics: either restricted field

    def next_fire(self, after_ms: int) -> Optional[int]:
        t = datetime.datetime.fromtimestamp(
            after_ms / 1000.0, datetime.timezone.utc
        ).replace(microsecond=0, tzinfo=None)
        t += datetime.timedelta(seconds=1)
        day = t.date()
        for _ in range(1500):  # ~4 years of days
            if self._day_matches(day):
                start_h, start_m, start_s = (
                    (t.hour, t.minute, t.second) if day == t.date() else (0, 0, 0)
                )
                for h in self.hours:
                    if h < start_h:
                        continue
                    for m in self.minutes:
                        if h == start_h and m < start_m:
                            continue
                        for s in self.seconds:
                            if h == start_h and m == start_m and s < start_s:
                                continue
                            dt = datetime.datetime(
                                day.year, day.month, day.day, h, m, s,
                                tzinfo=datetime.timezone.utc,
                            )
                            return int(dt.timestamp() * 1000)
            day += datetime.timedelta(days=1)
        return None
