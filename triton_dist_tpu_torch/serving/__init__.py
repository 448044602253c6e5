"""Serving of the port: the JSON-lines server and its client."""
