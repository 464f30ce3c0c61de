"""In-memory topic broker: the test-double transport.

Port of the JAX package's ``transport/broker.py``.

Mirrors the reference ``util/transport/InMemoryBroker.java`` (a static
topic -> subscribers map used by InMemorySource/InMemorySink and the
whole transport test corpus).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Callable, Dict, List


class Subscriber:
    """SPI: implement ``on_message`` and ``get_topic`` (reference:
    InMemoryBroker.Subscriber)."""

    def on_message(self, message):
        raise NotImplementedError

    def get_topic(self) -> str:
        raise NotImplementedError


class FunctionSubscriber(Subscriber):
    def __init__(self, topic: str, fn: Callable):
        self._topic = topic
        self._fn = fn

    def on_message(self, message):
        self._fn(message)

    def get_topic(self) -> str:
        return self._topic


class InMemoryBroker:
    """Process-global topic bus (all methods static, like the reference)."""

    _lock = threading.RLock()
    _subscribers: Dict[str, List[Subscriber]] = defaultdict(list)

    @classmethod
    def subscribe(cls, subscriber: Subscriber):
        with cls._lock:
            cls._subscribers[subscriber.get_topic()].append(subscriber)

    @classmethod
    def unsubscribe(cls, subscriber: Subscriber):
        with cls._lock:
            subs = cls._subscribers.get(subscriber.get_topic(), [])
            if subscriber in subs:
                subs.remove(subscriber)

    @classmethod
    def publish(cls, topic: str, message):
        with cls._lock:
            subs = list(cls._subscribers.get(topic, []))
        for s in subs:
            s.on_message(message)

    @classmethod
    def clear(cls):
        """Test helper: drop every subscription."""
        with cls._lock:
            cls._subscribers.clear()
