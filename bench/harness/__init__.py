"""The benchmark's general code: loader, traffic, driver, profile reader, check."""
