"""One driver per kind of entry the benchmark times; a traffic mix names
its driver."""
