"""BFL remote-API client (counterpart of visualcloze_tpu/models/api.py).

A standalone HTTP client for the Black Forest Labs image-generation API:
validate the request's parameters, submit, poll until ready, fetch, save or
show the image. The constraints are a declarative table (one `_Bound` row a
field); the submit, poll and fetch verbs are module-level helpers that
`ImageRequest` delegates to. `requests` is imported only where a verb runs.
It uses neither torch nor the card.
"""

from __future__ import annotations

import io
import os
import time
from dataclasses import dataclass
from pathlib import Path

API_URL = "https://api.bfl.ml"
API_ENDPOINTS = {
    "flux.1-pro": "flux-pro",
    "flux.1-dev": "flux-dev",
    "flux.1.1-pro": "flux-pro-1.1",
}

_POLL_SECONDS = 0.5


class ApiException(Exception):
    """HTTP-level failure. `detail` carries the server's error payload,
    either a plain string or the API's list-of-{msg} records."""

    def __init__(self, status_code: int, detail: str | list[dict] | None = None):
        msg = detail
        if isinstance(detail, list):
            msg = "; ".join(str(d.get("msg", d)) for d in detail)
        super().__init__(f"HTTP {status_code}: {msg}" if msg else f"HTTP {status_code}")
        self.status_code = status_code
        self.detail = detail


@dataclass(frozen=True)
class _Bound:
    lo: float
    hi: float
    multiple_of: int = 1
    models: tuple[str, ...] = ()  # empty = any model

    def check(self, field: str, value, model: str) -> None:
        if self.models and model not in self.models:
            raise ValueError(f"{field} is only supported by {'/'.join(self.models)}")
        if value % self.multiple_of:
            raise ValueError(f"{field} must be a multiple of {self.multiple_of}, got {value}")
        if not self.lo <= value <= self.hi:
            raise ValueError(f"{field} must be in [{self.lo}, {self.hi}], got {value}")


_CONSTRAINTS: dict[str, _Bound] = {
    "width": _Bound(256, 1440, multiple_of=32),
    "height": _Bound(256, 1440, multiple_of=32),
    "steps": _Bound(1, 50),
    "guidance": _Bound(1.5, 5.0),
    "interval": _Bound(1.0, 4.0, models=("flux.1-pro",)),
    "safety_tolerance": _Bound(0, 6),
}


def validate_request(payload: dict, model: str) -> None:
    """Raise ValueError on the first field of `payload` violating the table."""
    if model not in API_ENDPOINTS:
        raise ValueError(f"Invalid model {model}")
    for field, bound in _CONSTRAINTS.items():
        if payload.get(field) is not None:
            bound.check(field, payload[field], model)


def _http(method: str, url: str, api_key: str | None, **kwargs) -> dict:
    import requests

    resp = getattr(requests, method)(
        url, headers={"accept": "application/json", "x-key": api_key}, **kwargs
    )
    body = resp.json()
    if resp.status_code != 200:
        raise ApiException(resp.status_code, body.get("detail"))
    return body


def submit(model: str, payload: dict, api_key: str | None) -> str:
    """POST the generation request; returns the server-side request id."""
    body = _http("post", f"{API_URL}/v1/{API_ENDPOINTS[model]}", api_key, json=payload)
    return body["id"]


def poll_result(request_id: str, api_key: str | None) -> dict:
    """Poll get_result until the request leaves Pending; returns the result
    record. Any terminal status other than Ready is surfaced as ApiException."""
    while True:
        body = _http("get", f"{API_URL}/v1/get_result", api_key, params={"id": request_id})
        status = body.get("status")
        if status is None:
            raise ApiException(200, body.get("detail"))
        if status == "Ready":
            return body["result"]
        if status != "Pending":
            raise ApiException(200, f"API returned status '{status}'")
        time.sleep(_POLL_SECONDS)


def fetch_bytes(url: str) -> bytes:
    import requests

    resp = requests.get(url)
    if resp.status_code != 200:
        raise ApiException(resp.status_code)
    return resp.content


class ImageRequest:
    """Submit-and-poll wrapper over the helpers above.

    Field names/ranges mirror the reference client: prompt, name (model),
    width/height (multiples of 32, 256..1440), num_steps (<=50),
    prompt_upsampling, seed, guidance (1.5..5), interval (flux.1-pro only,
    1..4), safety_tolerance (0..6), validate, launch, api_key
    (default $BFL_API_KEY)."""

    # wire-field name -> constructor kwarg (num_steps travels as "steps")
    _WIRE_FIELDS = dict(
        prompt="prompt", width="width", height="height", steps="num_steps",
        prompt_upsampling="prompt_upsampling", seed="seed", guidance="guidance",
        interval="interval", safety_tolerance="safety_tolerance",
    )

    def __init__(
        self, prompt: str, name: str = "flux.1.1-pro",
        width: int | None = None, height: int | None = None,
        num_steps: int | None = None, prompt_upsampling: bool | None = None,
        seed: int | None = None, guidance: float | None = None,
        interval: float | None = None, safety_tolerance: int | None = None,
        validate: bool = True, launch: bool = True, api_key: str | None = None,
    ):
        kwargs = locals()
        fields = {wire: kwargs[arg] for wire, arg in self._WIRE_FIELDS.items()}
        if validate:
            validate_request(fields, name)
        self.name = name
        self.request_json = {k: v for k, v in fields.items() if v is not None}
        self.api_key = api_key if api_key is not None else os.environ.get("BFL_API_KEY")
        self.request_id = self.result = self._image_bytes = None
        if launch:
            self.request()

    def request(self) -> None:
        if self.request_id is None:
            self.request_id = submit(self.name, self.request_json, self.api_key)

    def retrieve(self) -> dict:
        self.request()
        if self.result is None:
            self.result = poll_result(self.request_id, self.api_key)
        return self.result

    @property
    def url(self) -> str:
        return self.retrieve()["sample"]

    @property
    def bytes(self) -> bytes:
        if self._image_bytes is None:
            self._image_bytes = fetch_bytes(self.url)
        return self._image_bytes

    @property
    def image(self):
        from PIL import Image

        return Image.open(io.BytesIO(self.bytes))

    def save(self, path: str) -> None:
        out = Path(path)
        suffix = Path(self.url).suffix
        if out.suffix != suffix:
            out = out.with_name(out.name + suffix)
        out.resolve().parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(self.bytes)
