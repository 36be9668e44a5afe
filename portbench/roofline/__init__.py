"""Frozen work counts and published peaks."""
