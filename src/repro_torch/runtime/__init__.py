"""Runtime layer of the port: host-failure schedules, the training restart loop and straggler detection."""
