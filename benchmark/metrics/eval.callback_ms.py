"""eval.callback_ms: Host milliseconds per sweep inside the user's libFM
callback, timed by the window's callback around it; None where the mix
has no callback.
"""


def read(observed):
    spent = observed["callback_s"]
    if not spent:
        return None
    return 1e3 * sum(spent) / len(spent)
