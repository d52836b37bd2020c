"""The benchmark's general machinery: cells, data, probes, traces and the comparison."""
