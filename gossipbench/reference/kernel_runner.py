"""The kernel runner's calls: R periods a launch on stale scalars, a
flight row a period where the traffic records one, the scalars carried
across calls where it carries them."""

from gossipbench.reference import model


def call(s, key, P, traffic, scalars0=None, F=model.torch.float32):
    return model.kernel_runner_call(s, key, P, traffic["rounds"],
                                    traffic["R"], scalars0,
                                    traffic.get("flight_every"), F)
