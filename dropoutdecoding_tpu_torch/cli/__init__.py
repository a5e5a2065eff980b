"""Command-line harnesses of the port."""
