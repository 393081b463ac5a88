"""Runtime layer of the port: host-failure schedules, the training restart loop, elastic mesh plans and straggler detection."""
