"""The MATLAB reference's RK4 variant: its fourth stage at x + h k1."""


def step(f, x, u, th, h):
    k1 = f(x, u, th)
    k2 = f(x + 0.5 * h * k1, u, th)
    k3 = f(x + 0.5 * h * k2, u, th)
    k4 = f(x + h * k1, u, th)
    return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
