"""The serving step of the port (single device)."""
