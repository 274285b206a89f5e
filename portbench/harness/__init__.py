"""The benchmark's own machinery: finding a cell's files (`cell`), one run
(`core`), reading a profiled stretch (`trace`) and the arithmetic of a
measured window (`yardstick`)."""
