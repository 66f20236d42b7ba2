"""Traffic drivers, one file each, found by the name a workload gives."""
