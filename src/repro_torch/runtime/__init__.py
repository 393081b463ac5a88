"""Runtime layer of the port: host-failure schedules and straggler detection."""
