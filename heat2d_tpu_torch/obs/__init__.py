"""Run records."""
