"""Process entry points."""
