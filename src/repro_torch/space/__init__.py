"""Canonical schedule identity and move generation."""
