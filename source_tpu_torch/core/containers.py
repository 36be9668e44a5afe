"""Container classes: LinkedList, Stack, Queue.

Counterpart of source_tpu/core/containers.py (raysect/core/containers.pyx:
49-309). The reference uses these in Cython hot loops; here device code uses
fixed-shape tensors instead, and these serve the host-side builders:
``Stack`` drives the recursion-free BVH fallback (accel/bvh.py
``_build_numpy``), which must survive degenerate inputs deeper than the
interpreter's recursion limit. As in the JAX package, ``Stack`` pushes at
the head of the list and raises ``IndexError`` on an empty pop (Raysect's
pushes at the tail).
"""

from __future__ import annotations

__all__ = ["LinkedList", "Stack", "Queue"]


class _Node:
    __slots__ = ("value", "next")

    def __init__(self, value):
        self.value = value
        self.next = None


class LinkedList:
    """Singly linked list (containers.pyx:49)."""

    def __init__(self, initial_items=None):
        self.first = None
        self.last = None
        self.length = 0
        if initial_items is not None:
            for item in initial_items:
                self.add(item)

    def __len__(self):
        return self.length

    def __iter__(self):
        node = self.first
        while node is not None:
            yield node.value
            node = node.next

    def is_empty(self):
        return self.length == 0

    def add(self, value):
        """Append to the end."""
        node = _Node(value)
        if self.last is None:
            self.first = self.last = node
        else:
            self.last.next = node
            self.last = node
        self.length += 1

    def add_items(self, iterable):
        for v in iterable:
            self.add(v)

    def get_index(self, index):
        if index < 0 or index >= self.length:
            raise IndexError("LinkedList index out of range.")
        node = self.first
        for _ in range(index):
            node = node.next
        return node.value

    def insert(self, value, index):
        if index <= 0:
            node = _Node(value)
            node.next = self.first
            self.first = node
            if self.last is None:
                self.last = node
            self.length += 1
            return
        if index >= self.length:
            self.add(value)
            return
        prev = self.first
        for _ in range(index - 1):
            prev = prev.next
        node = _Node(value)
        node.next = prev.next
        prev.next = node
        self.length += 1

    def remove(self, index):
        if index < 0 or index >= self.length:
            raise IndexError("LinkedList index out of range.")
        if index == 0:
            node = self.first
            self.first = node.next
            if self.first is None:
                self.last = None
        else:
            prev = self.first
            for _ in range(index - 1):
                prev = prev.next
            node = prev.next
            prev.next = node.next
            if node is self.last:
                self.last = prev
        self.length -= 1
        return node.value


class Stack(LinkedList):
    """LIFO stack (containers.pyx:227)."""

    def push(self, value):
        node = _Node(value)
        node.next = self.first
        self.first = node
        if self.last is None:
            self.last = node
        self.length += 1

    def pop(self):
        if self.first is None:
            raise IndexError("pop from an empty stack")
        node = self.first
        self.first = node.next
        if self.first is None:
            self.last = None
        self.length -= 1
        return node.value


class Queue(LinkedList):
    """FIFO queue (containers.pyx:276)."""

    def next_in_queue(self):
        if self.first is None:
            raise IndexError("next_in_queue from an empty queue")
        return self.remove(0)
