"""Necks."""
