"""Step functions and the serving engine."""
