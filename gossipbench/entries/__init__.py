"""One driver a program entry the windows drive (``traffic/<mix>.json``'s
``entry`` names the module): ``prepare(device, config)``, ``stage(ctx, n,
edges)``, ``run(staged, origins, gen_ticks, traffic)``, ``ticks(result,
staged, traffic)``, ``release(staged)``; ``reference(world, graph,
origins, gen_ticks, traffic, config, *, occupancy, lose_seed)``, the
plain reference of one simulation, (outputs, occupancy counts or None);
and ``TRAFFIC_KEYS``, ``CONFIG_KEYS``, the keys of the traffic and
configuration files it reads (any other key is refused)."""
