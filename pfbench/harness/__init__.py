"""The benchmark's general machinery: finding a cell's files, the
measured window, spans, the profiler's trace, the result line."""
