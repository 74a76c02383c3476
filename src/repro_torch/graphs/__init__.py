"""Synthetic graph generators."""
