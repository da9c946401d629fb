"""Periodic GTO evaluation."""
