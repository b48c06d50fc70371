"""Command-line tools of the port that sit beside the CLI (experiments)."""
