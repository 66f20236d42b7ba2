"""Plain PyTorch GeoLDM, the yardstick the port is compared with."""
