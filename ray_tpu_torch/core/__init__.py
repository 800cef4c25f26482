"""Process-local helpers the port's observability modules share."""
